"""CUDA graphs of the serving loop: the counterpart of the JAX engine's one
compiled program per static-argument set (``jax.jit`` / ``aot_jit`` with
static arguments, ``streamspeech_tpu/runtime/session.py``).

The JAX engine runs a policy tick as one program with two ``lax.cond``s
(decode or skip, emit or not). The synchronous fused tick cuts it at the
conds into three parts, each its own graph: encode + gates, decode +
rollback, emission (``StreamSpeechEngine.policy_step_batched``). The host
reads a small bundle after each part and replays the next part only when
some stream needs it: at most three reads a tick, the last one the
emission's bundle.

The overlapped loop's tick (``StreamSpeechEngine.policy_step_pipelined``) is
one graph whose conds are conditional (IF) nodes (``cond``): the host reads
nothing between two chunks. The capture is cut into segments at each cond,
each an ordinary capture into the shared pool, and ``csrc/graph_cond.cu``
assembles them into one graph with the IF bodies under conditional nodes,
each set on the card by a one-thread kernel that reads the predicate.
Each chunk in flight has its own pinned host copy of the bundle (``Ring``).

The host MT decode (``StreamSpeechEngine.mt_decode_greedy``) is a graph a
batch size and step count, its inputs filled by one upload, its results read
back in one copy.

A graph replays fixed addresses, so every tensor a tick reads or writes is a
fixed buffer of a ``Slot``, one a batch size B:
- the device state of the session being served (encoder caches and stream
  position, encoder buffer, MT caches). A session is *bound* to the slot at
  its first fused tick or decode: its state is copied in and its attributes
  then name the slot's tensors; a session bound before it gets clones of
  them, so it stays whole (``Slot.bind``);
- the inputs, one byte buffer a block size that the host fills with one copy
  (``Packed``), in place of ``host_to_device``;
- what one part hands the next (the decode flags and budgets, the kept
  lengths, the new hypotheses), each part's bundle for the host, and the
  overlapped loop's device-resident policy counters (``pol``).

``TickGraphs`` keeps the graphs, keyed by the static arguments of the part
(B, the block's frames, the chunks, the MT and unit buckets, the dtype, a
decode's steps), and one graph memory pool that all of them share (they
replay in turn, on one stream). Whether a stream has finished, whole-word
rollback, k1, n, max_len and whether to emit are data in the inputs, so one
graph serves all of their values. ``StreamSpeechEngine.warmup`` captures
every part for the engine's buckets; a part ``warmup`` missed is captured at
its first use. A capture that fails raises.

Capture runs the part once eagerly on a side stream first (lazy
initialisation: cuBLAS, cuDNN, the kernels' build; every cond body runs
then, taken or not), puts the state back from a snapshot, and then captures;
it also notes how the part moves the host mirrors of the device positions
(an encode adds the block's frames), which a replay then applies, as it adds
each kernel's launches inside the graph to the kernel's launch count
(``launches``, ``bf16_launches``, ``mask_draws``,
``masked_attention.launches_by_batch``): a count is the launches a graph
holds times its replays. The launches inside an IF body count only where
the body ran: ``run`` returns them, and the caller adds them
(``count_branches``) once it has read the flags that say which ran.

On the CPU there are no graphs: ``run`` calls the part, and ``cond`` reads
its predicate and calls the body where it holds.
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
        self.layout, total = [], 0
        for name, shape, dtype in fields:
            nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
            self.layout.append((name, shape, dtype, total, nbytes))
            total += -(-nbytes // 8) * 8
        self.dev = torch.zeros(total, dtype=torch.uint8, device=device)
        self.d = {name: self.dev[off:off + nbytes].view(dtype).view(shape)
                  for name, shape, dtype, off, nbytes in self.layout}
        self.host, self.h = self.twin()

    def twin(self) -> Tuple[torch.Tensor, Dict[str, np.ndarray]]:
        """Another host buffer of this layout (pinned on a card) and its
        numpy views."""
        host = torch.zeros(self.dev.numel(), dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        raw = host.numpy()
        return host, {name: raw[off:off + nbytes].view(_NP[dtype]).reshape(shape)
                      for name, shape, dtype, off, nbytes in self.layout}

    def upload(self) -> None:
        self.dev.copy_(self.host, non_blocking=True)

    def download(self) -> Dict[str, np.ndarray]:
        """Every field, read once; the arrays are the host views, valid until
        the next download."""
        self.host.copy_(self.dev, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return self.h


class Ring:
    """Pinned host twins of an input ``Packed`` and an output one, an entry a
    chunk in flight: the next replay overwrites the graph's fixed buffers, so
    each chunk uploads from and downloads into its own entry. An entry goes
    back to the ring once its chunk is fetched; the ring grows to the deepest
    pipeline its caller keeps (``pipe_max_lag`` + 1 entries)."""

    def __init__(self, inp: Packed, out: Packed):
        self.inp, self.out = inp, out
        self.free: List[dict] = []

    def take(self) -> dict:
        if self.free:
            return self.free.pop()
        host_in, h_in = self.inp.twin()
        host_out, h_out = self.out.twin()
        cuda = self.inp.device.type == "cuda"
        return {"host_in": host_in, "in": h_in, "host_out": host_out, "out": h_out,
                "event": torch.cuda.Event() if cuda else None}

    def give(self, entry: dict) -> None:
        self.free.append(entry)


# ---------------------------------------------------------------------------
# the device-side cond
# ---------------------------------------------------------------------------

_captures: List["_Capture"] = []     # the capture in progress, innermost last


def cond(pred: torch.Tensor, body: Callable[[], None]) -> None:
    """JAX's ``lax.cond`` without an else branch: run ``body`` where the 0-d
    bool ``pred`` on the part's device is true. The caller writes the skip
    branch's values before the cond, for the body to overwrite. Inside a
    ``TickGraphs`` capture the body becomes an IF node of the graph (never a
    host read and never both branches selected after); eagerly, on a card or
    the CPU, the host reads ``pred``. A capture that ``TickGraphs`` did not
    start raises: its IF body's launches could not be counted."""
    if _captures:
        _captures[-1].branch(pred, body)
        return
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("cond inside a CUDA-graph capture that TickGraphs did not start")
    if bool(pred):
        body()


# the set-conditional kernel's launches (``csrc/graph_cond.cu``): one an IF
# node a replay of an assembled graph
cond.launches = 0


class _Capture:
    """One part's capture: its graph segments (a segment ends at each cond;
    the cond's body is a segment of its own), the launch counts each IF body
    holds, in order. ``warming``: the eager pass before a capture, where
    every body runs."""

    def __init__(self, pool, stream, warming: bool = False):
        self.pool, self.stream, self.warming = pool, stream, warming
        self.segments: List[Tuple[int, torch.cuda.CUDAGraph, Optional[torch.Tensor]]] = []
        self.branches: List[tuple] = []
        self._open = None

    def __enter__(self) -> "_Capture":
        _captures.append(self)
        if not self.warming:
            self._begin()
        return self

    def __exit__(self, *exc) -> None:
        try:
            if self._open is not None:
                self._end(0, None, exc)
        finally:
            _captures.pop()

    def _begin(self) -> None:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        ctx = torch.cuda.graph(graph, pool=self.pool, stream=self.stream)
        ctx.__enter__()
        self._open = (graph, ctx)

    def _end(self, kind: int, pred: Optional[torch.Tensor], exc=(None, None, None)) -> None:
        graph, ctx = self._open
        self._open = None
        ctx.__exit__(*exc)
        self.segments.append((kind, graph, pred))

    def branch(self, pred: torch.Tensor, body: Callable[[], None]) -> None:
        if self.warming:
            body()
            return
        before = read_counts()
        self._end(0, None)
        self._begin()
        body()
        self._end(1, pred)
        self._begin()
        self.branches.append(_diff(read_counts(), before))
        _write_counts(before)


class _Composed:
    """Captured segments assembled into one graph with IF nodes
    (``csrc/graph_cond.cu``); holds the segments, whose memory the graph
    reads, and its predicates, for the graph's life."""

    def __init__(self, segments, device: torch.device):
        import ctypes

        from streamspeech_tpu_torch.kernels import build

        self.segments, self.device = segments, device
        n = len(segments)
        kinds = (ctypes.c_int * n)(*[k for k, _, _ in segments])
        raw = (ctypes.c_void_p * n)(*[g.raw_cuda_graph() for _, g, _ in segments])
        preds = (ctypes.c_void_p * n)(*[p.data_ptr() if p is not None else 0
                                        for _, _, p in segments])
        self.graph, self.exec = ctypes.c_void_p(), ctypes.c_void_p()
        if_nodes = ctypes.c_int(0)
        vp = ctypes.c_void_p
        compose = build.bind("graph_cond", "graph_cond_compose",
                             (ctypes.c_int, vp, vp, vp, vp, vp, vp))
        err = compose(n, kinds, raw, preds, ctypes.byref(self.graph), ctypes.byref(self.exec),
                      ctypes.byref(if_nodes))
        if err != 0:
            raise RuntimeError(f"assembling a graph with IF nodes failed: CUDA error {err}")
        # the IF nodes the graph holds, each with its setter kernel: a body
        # that captured nothing gets neither
        self.if_nodes = if_nodes.value
        self._launch = ("graph_cond", "graph_cond_launch", (vp, vp))
        self._destroy = build.bind("graph_cond", "graph_cond_destroy", (vp, vp))

    def replay(self) -> None:
        from streamspeech_tpu_torch.kernels import build

        build.launch(self._launch, self.device, self.exec)
        cond.launches += self.if_nodes

    def __del__(self):
        if self.exec:
            self._destroy(self.graph, self.exec)


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
    """The fixed buffers of the serving graphs at batch ``batch``: a session
    state (``engine.session_init``), the inputs and bundles of each block
    size and unit bucket, what the parts hand on, the starts-word table, the
    overlapped loop's policy counters (``pol``) and bundle, and the host
    decode's inputs and results."""

    INPUTS = ("valid", "enc_len", "n_tokens", "src_len", "tgt_len", "asr_count",
              "st_count", "last_asr", "last_st", "n_units", "active", "finished",
              "tail_ready", "k1", "n", "whole_word", "max_len", "emission")
    # the overlapped loop's device-resident counters (JAX's ``pol`` beside
    # its hypothesis buffer, `session.py:586-587`), rows of ``INPUTS``
    POL = ("n_tokens", "src_len", "tgt_len", "asr_count", "st_count", "last_asr",
           "last_st", "n_units")
    # the overlapped bundle's scalars a stream: JAX's flags, then keep, the
    # two counts, count and cur_len (`session.py:610-611`)
    PIPE_VALS = ("do_decode", "do_emit", "ok", "budget_over", "hit_eos", "grew",
                 "keep", "asr_count", "st_count", "count", "cur_len", "no_room")

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
        self.pol = Packed([("ints", (len(self.POL), batch), torch.long),
                           ("mt_buf", (batch, m), torch.long)], dev)
        self.pol_rows = torch.tensor([self.INPUTS.index(n) for n in self.POL], device=dev)
        self.decode_in = Packed([("ints", (3, batch), torch.long),
                                 ("cross_valid", (batch, engine.max_enc_frames), torch.bool)],
                                dev)
        self.decode_out = Packed([("toks", (batch, engine.max_decode_per_call), torch.long),
                                  ("vals", (2, batch), torch.long)], dev)
        self._io: Dict[int, Tuple[Packed, Packed]] = {}
        self._emitted: Dict[int, Packed] = {}
        self._pipe: Dict[int, Tuple[Packed, Ring]] = {}

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

    def pipe(self, block_frames: int) -> Tuple[Packed, Ring]:
        """The overlapped tick's bundle for blocks of ``block_frames`` frames
        (units and durations at the largest unit bucket, whatever the
        graph's), and its ring of host twins beside the inputs'."""
        if block_frames not in self._pipe:
            b, e = self.batch, self.engine
            u, s = e.unit_buckets[-1], block_frames // 4
            out = Packed([("vals", (len(self.PIPE_VALS), b), torch.long),
                          ("ids", (2, b, s), torch.long),
                          ("units", (b, u), torch.long),
                          ("dur", (b, u), torch.long),
                          ("tail", (b, e.emit_tail_cap), torch.float32),
                          ("mt_buf", (b, e.max_mt_tokens), torch.long)], e.device)
            self._pipe[block_frames] = (out, Ring(self.io(block_frames)[0], out))
        return self._pipe[block_frames]

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
    one memory pool and one capture stream; and the slots, one a batch
    size."""

    def __init__(self, engine):
        self.engine = engine
        self.cuda = engine.device.type == "cuda"
        self.slots: Dict[int, Slot] = {}
        # key -> (replay, mirror moves, launches held outside any cond,
        #         launches held by each cond's body)
        self.graphs: Dict[Hashable, Tuple[Callable[[], None], List[int], tuple,
                                          List[tuple]]] = {}
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self.stream = torch.cuda.Stream(engine.device) if self.cuda else None
        self.captured = 0
        self.capture_s = 0.0
        self.replays = 0
        self.replays_by_part: Dict[str, int] = {}     # by the key's first field
        self.if_nodes = 0

    def slot(self, batch: int) -> Slot:
        if batch not in self.slots:
            self.slots[batch] = Slot(self.engine, batch)
        return self.slots[batch]

    def run(self, slot: Slot, key: Hashable, part: Callable[[], None],
            keep: Sequence[torch.Tensor] = ()) -> List[tuple]:
        """Run ``part`` on ``slot``: on the card, replay its graph (capturing
        it first if no graph has ``key``; ``keep``: tensors beside the slot's
        state that the capture puts back); on the CPU, call it. Returns the
        launches each cond body of the graph holds, for ``count_branches``
        (none on the CPU, where a body's launches count as it runs)."""
        if not self.cuda:
            part()
            return []
        if key not in self.graphs:
            self.capture(slot, key, part, keep)
        replay, delta, held, branches = self.graphs[key]
        replay()
        self.replays += 1
        self.replays_by_part[key[0]] = self.replays_by_part.get(key[0], 0) + 1
        set_mirrors(slot.state, [m + d for m, d in zip(mirrors(slot.state), delta)])
        _write_counts(_add(read_counts(), held))
        return branches

    @staticmethod
    def count_branches(branches: List[tuple], taken: Sequence[bool]) -> None:
        """Add the launches of each cond body that ran (``taken``, read from
        the bundle) to the kernels' counts; ``branches`` is empty on the CPU."""
        for held, ran in zip(branches, taken):
            if ran:
                _write_counts(_add(read_counts(), held))

    def capture(self, slot: Slot, key: Hashable, part: Callable[[], None],
                keep: Sequence[torch.Tensor] = ()) -> None:
        """Capture ``part`` as the graph of ``key``; the slot's state and the
        tensors of ``keep`` are as before. On the CPU, nothing."""
        if not self.cuda or key in self.graphs:
            return
        t0 = time.perf_counter()
        dev = self.engine.device
        tensors = state_tensors(slot.state) + list(keep)
        saved = [t.clone() for t in tensors]
        before = mirrors(slot.state)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), _Capture(self.pool, self.stream, warming=True):
            part()      # lazy initialisation, every cond body, outside the capture
        torch.cuda.current_stream(dev).wait_stream(side)
        delta = [a - b for a, b in zip(mirrors(slot.state), before)]
        for t, s in zip(tensors, saved):
            t.copy_(s)
        counts = read_counts()
        with _Capture(self.pool, self.stream) as cap:
            part()
        held = _diff(read_counts(), counts)
        _write_counts(counts)           # capturing launches nothing
        set_mirrors(slot.state, before)
        del saved
        if_nodes = 0
        if len(cap.segments) == 1:
            graph = cap.segments[0][1]
            graph.instantiate()
            replay = graph.replay
        else:
            composed = _Composed(cap.segments, dev)
            replay, if_nodes = composed.replay, composed.if_nodes
        torch.cuda.synchronize(dev)
        self.graphs[key] = (replay, delta, held, cap.branches)
        self.captured += 1
        self.if_nodes += if_nodes
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
                "graph_replays": self.replays,
                "graph_replays_by_part": dict(self.replays_by_part),
                "if_nodes": self.if_nodes, "pool_bytes": self.pool_bytes()}
