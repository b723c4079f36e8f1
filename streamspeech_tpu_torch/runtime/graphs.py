"""CUDA graphs of the fused serving tick: the counterpart of the JAX engine's
one compiled program per static-argument set (``jax.jit`` / ``aot_jit`` with
static arguments, ``streamspeech_tpu/runtime/session.py``).

The JAX engine runs a policy tick as one program with two ``lax.cond``s
(decode or skip, emit or not). A CUDA graph has no branch, so the port cuts
the tick at the conds into three parts, each its own graph: encode + gates,
decode + rollback, emission (``StreamSpeechEngine.policy_step_batched``).
The host reads a small bundle after each part and replays the next part only
when some stream needs it: at most three reads a tick, the last one the
emission's bundle.

A graph replays fixed addresses, so every tensor a tick reads or writes is a
fixed buffer of a ``Slot``, one a batch size B:
- the device state of the session being served (encoder caches and stream
  position, encoder buffer, MT caches). A session is *bound* to the slot at
  its first fused tick: its state is copied in and its attributes then name
  the slot's tensors; a session bound before it gets clones of them, so it
  stays whole (``Slot.bind``);
- the inputs, one byte buffer a block size that the host fills with one copy
  (``Packed``), in place of ``host_to_device``;
- what one part hands the next (the decode flags and budgets, the kept
  lengths, the new hypotheses), and each part's bundle for the host.

``TickGraphs`` keeps the graphs, keyed by the static arguments of the part
(B, the block's frames, the chunks, the MT and unit buckets, the dtype), and
one graph memory pool that all of them share (they replay in turn, on one
stream). Whether a stream has finished, whole-word rollback, k1, n, max_len
and whether to emit are data in the inputs, so one graph serves all of their
values. ``StreamSpeechEngine.warmup`` captures every part for the engine's
buckets; a part ``warmup`` missed is captured at its first use. A capture
that fails raises.

Capture runs the part once eagerly on a side stream first (lazy
initialisation: cuBLAS, cuDNN, the kernels' build), puts the state back from a
snapshot, and then captures; it also notes how the part moves the host
mirrors of the device positions (an encode adds the block's frames), which a
replay then applies, as it adds each kernel's launches inside the graph to
the kernel's launch count (``launches``, ``bf16_launches``, ``mask_draws``,
``masked_attention.launches_by_batch``): a count is the launches a graph
holds times its replays.

On the CPU there are no graphs: ``run`` calls the part.
"""

from __future__ import annotations

import time
import weakref
from typing import Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from streamspeech_tpu_torch.models.conformer import EncoderStreamState
from streamspeech_tpu_torch.models.layers import KVCache, StreamKVCache

_NP = {torch.int64: np.int64, torch.bool: np.bool_, torch.float32: np.float32}


class Packed:
    """Named tensors laid out in one byte buffer on ``device``, with a twin on
    the host (pinned on a card): ``d`` holds the device views, ``h`` the host
    ones (numpy). ``upload`` and ``download`` move every field in one copy."""

    def __init__(self, fields: Sequence[Tuple[str, Tuple[int, ...], torch.dtype]],
                 device: torch.device):
        self.device = device
        layout, total = [], 0
        for name, shape, dtype in fields:
            nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            layout.append((name, shape, dtype, total, nbytes))
            total += -(-nbytes // 8) * 8
        self.dev = torch.zeros(total, dtype=torch.uint8, device=device)
        self.host = torch.zeros(total, dtype=torch.uint8,
                                pin_memory=device.type == "cuda")
        host = self.host.numpy()
        self.d, self.h = {}, {}
        for name, shape, dtype, off, nbytes in layout:
            self.d[name] = self.dev[off:off + nbytes].view(dtype).view(shape)
            self.h[name] = host[off:off + nbytes].view(_NP[dtype]).reshape(shape)

    def upload(self) -> None:
        self.dev.copy_(self.host, non_blocking=True)

    def download(self) -> Dict[str, np.ndarray]:
        """Every field, read once; the arrays are the host views, valid until
        the next download."""
        self.host.copy_(self.dev, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self.h


# ---------------------------------------------------------------------------
# session state: its tensors, the host mirrors of its positions, clones
# ---------------------------------------------------------------------------

State = Tuple[EncoderStreamState, torch.Tensor, List[StreamKVCache], List[KVCache]]


def state_of(session) -> State:
    return session.enc_state, session.enc_buf, session.mt_self, session.mt_cross


def _set_state(session, state: State) -> None:
    session.enc_state, session.enc_buf, session.mt_self, session.mt_cross = state


def state_tensors(state: State) -> List[torch.Tensor]:
    enc_state, enc_buf, mt_self, mt_cross = state
    out = [*enc_state.sub_ctx, *enc_state.conv_ctx, enc_state.pos_dev, enc_buf]
    for kv in (*enc_state.kv, *mt_cross):
        out += [kv.k, kv.v, kv.pos]
    for kv in mt_self:
        out += [kv.k, kv.v]
    return out


def mirrors(state: State) -> List[int]:
    """The host mirrors of the device positions: the encoder's, then each
    encoder and MT cross cache's."""
    enc_state, _, _, mt_cross = state
    return [enc_state.pos] + [kv.index for kv in (*enc_state.kv, *mt_cross)]


def set_mirrors(state: State, values: Sequence[int]) -> None:
    enc_state, _, _, mt_cross = state
    enc_state.pos = int(values[0])
    for kv, v in zip((*enc_state.kv, *mt_cross), values[1:]):
        kv.index = int(v)


def clone_state(state: State) -> State:
    enc_state, enc_buf, mt_self, mt_cross = state

    def kv(c: KVCache) -> KVCache:
        out = KVCache(c.k.clone(), c.v.clone(), c.index)
        out.pos.copy_(c.pos)
        return out

    enc = EncoderStreamState([t.clone() for t in enc_state.sub_ctx],
                             [t.clone() for t in enc_state.conv_ctx],
                             [kv(c) for c in enc_state.kv], enc_state.pos_dev.clone(),
                             enc_state.pos)
    return (enc, enc_buf.clone(),
            [StreamKVCache(c.k.clone(), c.v.clone(), c.max_len) for c in mt_self],
            [kv(c) for c in mt_cross])


def copy_state(dst: State, src: State) -> None:
    for d, s in zip(state_tensors(dst), state_tensors(src), strict=True):
        d.copy_(s)
    set_mirrors(dst, mirrors(src))


# ---------------------------------------------------------------------------
# launch counts
# ---------------------------------------------------------------------------


def _counters() -> List[Tuple[object, str]]:
    """Every kernel wrapper's launch counter (wrapper, attribute)."""
    from streamspeech_tpu_torch.kernels import attention, ctc, policy

    seen, out = set(), []
    for mod in (attention, ctc, policy):
        for name in sorted(vars(mod)):
            fn = getattr(mod, name)
            for attr in ("launches", "bf16_launches"):
                if callable(fn) and isinstance(getattr(fn, attr, None), int) \
                        and (id(fn), attr) not in seen:
                    seen.add((id(fn), attr))
                    out.append((fn, attr))
    return out


def read_counts() -> Tuple[List[int], int, Dict[int, int]]:
    from streamspeech_tpu_torch.kernels import attention

    return ([getattr(fn, attr) for fn, attr in _counters()], attention.mask_draws,
            dict(attention.masked_attention.launches_by_batch))


def _write_counts(counts) -> None:
    from streamspeech_tpu_torch.kernels import attention

    values, draws, by_batch = counts
    for (fn, attr), v in zip(_counters(), values):
        setattr(fn, attr, v)
    attention.mask_draws = draws
    attention.masked_attention.launches_by_batch = dict(by_batch)


def _diff(after, before):
    values = [a - b for a, b in zip(after[0], before[0])]
    by_batch = {b: n - before[2].get(b, 0) for b, n in after[2].items()}
    return values, after[1] - before[1], {b: n for b, n in by_batch.items() if n}


def _add(counts, held):
    values, draws, by_batch = counts
    merged = dict(by_batch)
    for b, n in held[2].items():
        merged[b] = merged.get(b, 0) + n
    return [v + h for v, h in zip(values, held[0])], draws + held[1], merged


# ---------------------------------------------------------------------------
# slots and graphs
# ---------------------------------------------------------------------------


class Slot:
    """The fixed buffers of the fused tick at batch ``batch``: a session
    state (``engine.session_init``), the inputs and bundles of each block
    size and unit bucket, what the parts hand on, and the starts-word table."""

    INPUTS = ("valid", "enc_len", "n_tokens", "src_len", "tgt_len", "asr_count",
              "st_count", "last_asr", "last_st", "n_units", "active", "finished",
              "tail_ready", "k1", "n", "whole_word", "max_len", "emission")

    def __init__(self, engine, batch: int):
        self.engine, self.batch = engine, batch
        dev = engine.device
        self.state: State = engine.session_init(batch)
        self._owner: Optional[weakref.ref] = None
        m = engine.max_mt_tokens
        self.mid = {"do_decode": torch.zeros(batch, dtype=torch.bool, device=dev),
                    "budget": torch.zeros(batch, dtype=torch.long, device=dev),
                    "enc_len": torch.zeros(batch, dtype=torch.long, device=dev),
                    "keep": torch.zeros(batch, dtype=torch.long, device=dev),
                    "mt_buf": torch.zeros((batch, m), dtype=torch.long, device=dev),
                    "do_emit": torch.zeros(batch, dtype=torch.bool, device=dev)}
        self.starts_word = torch.zeros(engine.model.cfg.mt_decoder.vocab_size,
                                       dtype=torch.bool, device=dev)
        self._starts_word_src = None
        self.decoded = Packed([("vals", (3, batch), torch.long),
                               ("mt_buf", (batch, m), torch.long)], dev)
        self._io: Dict[int, Tuple[Packed, Packed]] = {}
        self._emitted: Dict[int, Packed] = {}

    def io(self, block_frames: int) -> Tuple[Packed, Packed]:
        """(inputs, encode bundle) for blocks of ``block_frames`` fbank frames."""
        if block_frames not in self._io:
            b, dev = self.batch, self.engine.device
            feat = self.engine.model.cfg.encoder.input_feat_per_channel
            s = block_frames // 4
            self._io[block_frames] = (
                Packed([("ints", (len(self.INPUTS), b), torch.long),
                        ("mt_buf", (b, self.engine.max_mt_tokens), torch.long),
                        ("block", (b, block_frames, feat), torch.float32)], dev),
                Packed([("ids", (2, b, s), torch.long),
                        ("vals", (5, b), torch.long)], dev))
        return self._io[block_frames]

    def emitted(self, unit_capacity: int) -> Packed:
        """The emission bundle at ``unit_capacity`` units."""
        if unit_capacity not in self._emitted:
            b, e = self.batch, self.engine
            self._emitted[unit_capacity] = Packed(
                [("vals", (3, b), torch.long),
                 ("units", (b, unit_capacity), torch.long),
                 ("dur", (b, unit_capacity), torch.long),
                 ("tail", (b, e.emit_tail_cap), torch.float32)], e.device)
        return self._emitted[unit_capacity]

    def set_starts_word(self, table) -> None:
        """The whole-word table [V] bool, copied in when the caller's differs."""
        if table is not self._starts_word_src:
            self.starts_word.copy_(torch.as_tensor(np.asarray(table, bool)))
            self._starts_word_src = table

    def bind(self, session) -> None:
        """Make ``session``'s device state this slot's: its tensors are copied
        in and its attributes then name the slot's; a session bound before
        (if alive) takes clones of them first."""
        owner = self._owner() if self._owner is not None else None
        if owner is session:
            return
        if owner is not None:
            _set_state(owner, clone_state(self.state))
        copy_state(self.state, state_of(session))
        _set_state(session, self.state)
        self._owner = weakref.ref(session)


class TickGraphs:
    """The engine's captured parts, keyed by their static arguments, sharing
    one memory pool; and the slots, one a batch size."""

    def __init__(self, engine):
        self.engine = engine
        self.cuda = engine.device.type == "cuda"
        self.slots: Dict[int, Slot] = {}
        self.graphs: Dict[Hashable, Tuple[torch.cuda.CUDAGraph, List[int], tuple]] = {}
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.captured = 0
        self.capture_s = 0.0
        self.replays = 0

    def slot(self, batch: int) -> Slot:
        if batch not in self.slots:
            self.slots[batch] = Slot(self.engine, batch)
        return self.slots[batch]

    def run(self, slot: Slot, key: Hashable, part: Callable[[], None]) -> None:
        """Run ``part`` on ``slot``: on the card, replay its graph (capturing
        it first if no graph has ``key``); on the CPU, call it."""
        if not self.cuda:
            part()
            return
        if key not in self.graphs:
            self.capture(slot, key, part)
        graph, delta, held = self.graphs[key]
        graph.replay()
        self.replays += 1
        set_mirrors(slot.state, [m + d for m, d in zip(mirrors(slot.state), delta)])
        _write_counts(_add(read_counts(), held))

    def capture(self, slot: Slot, key: Hashable, part: Callable[[], None]) -> None:
        """Capture ``part`` as the graph of ``key``; the slot's state is as
        before. On the CPU, nothing."""
        if not self.cuda or key in self.graphs:
            return
        t0 = time.perf_counter()
        dev = self.engine.device
        saved = [t.clone() for t in state_tensors(slot.state)]
        before = mirrors(slot.state)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            part()      # lazy initialisation, outside the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        delta = [a - b for a, b in zip(mirrors(slot.state), before)]
        for t, s in zip(state_tensors(slot.state), saved):
            t.copy_(s)
        counts = read_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            part()
        held = _diff(read_counts(), counts)
        _write_counts(counts)           # capturing launches nothing
        set_mirrors(slot.state, before)
        del saved
        torch.cuda.synchronize(dev)
        self.graphs[key] = (graph, delta, held)
        self.captured += 1
        self.capture_s += time.perf_counter() - t0

    def pool_bytes(self) -> Optional[int]:
        """The bytes the graphs' shared pool holds on the card (None on the
        CPU, or where the allocator's snapshot does not name the pool)."""
        if not self.cuda:
            return None
        pool = tuple(self.pool)
        segs = [s for s in torch.cuda.memory_snapshot()
                if tuple(s.get("segment_pool_id") or ()) == pool]
        return sum(s["total_size"] for s in segs) if segs else None

    def stats(self) -> dict:
        return {"graphs_captured": self.captured, "capture_s": self.capture_s,
                "graph_replays": self.replays, "pool_bytes": self.pool_bytes()}
