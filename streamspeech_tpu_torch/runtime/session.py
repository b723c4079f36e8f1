"""Streaming inference engine: incremental encoder + cached MT decoder + unit
synthesis + windowed vocoding, the synchronous host path of
``streamspeech_tpu/runtime/session.py``.

Per 320 ms segment the session extracts fbank incrementally, encodes one block
against the encoder caches, continues MT greedy decoding from its KV caches
(whole-word truncation prunes them), and on emission re-runs the full-prefix
unit synthesis exactly as the reference does (`agent.py:638-751`). Shapes are
bucketed like the JAX engine's (MT tokens to ``mt_buckets``, unit capacity to
``unit_buckets``), so the unit decoder's causal self-attention always runs at
T = bucket × upsample.

B streams served in lockstep go through ``runtime/batched.py``
(``BatchedStreamingSession``), on this engine's batched programs
(``session_init(batch)``, ``mt_decode_greedy``, ``emit_batched``,
``emit_tail_batched``), which the single stream runs at B = 1.

The fused tick (``policy_step_batched``, ``policy_step`` at B = 1; JAX
`session.py:360-840`) runs a whole policy chunk on the device: encode, the CTC
growth gates, the greedy MT decode, the whole-word rollback, unit synthesis
and the windowed vocode tail, with the host reading one small bundle after
each of its three parts (``runtime/graphs.py``). On a card each part is a
CUDA graph, captured at ``warmup`` (or at its first use) and replayed; on the
CPU the same parts run eagerly. ``StreamingSession.fused_policy`` and
``BatchedStreamingSession.fused_tick`` drive it.

The overlapped tick (``policy_step_pipelined``, JAX :564-626) keeps one
stream's policy counters on the device and runs a whole chunk as one graph
whose two conds are IF nodes, so the host dispatches chunk N + 1 before it
reads chunk N's bundle (``StreamingSession.pipe_*``). The host MT decode
(``mt_decode_greedy``: a finish, a fallback, the host tick, the batched
session's drains) is a graph a batch size and step count on a card.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from streamspeech_tpu_torch.models.layers import (
    KVCache,
    StreamKVCache,
    cast_compute_weights_,
)
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.models.vocoder import SAMPLES_PER_FRAME, CodeGenerator
from streamspeech_tpu_torch.ops.ctc import ctc_collapse, ctc_collapse_device
from streamspeech_tpu_torch.runtime.graphs import Slot, TickGraphs, cond

EOS = 2
PAD = 1
NSPECIAL = 4


def _bucket(n: int, buckets: Tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")


def host_to_device(a, device) -> torch.Tensor:
    """A small host array as an int64 tensor on ``device``; a copy to the card
    goes through pinned memory, so it waits for nothing the card is doing."""
    t = torch.as_tensor(np.asarray(a, np.int64))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class StreamSpeechEngine:
    """Owns the model and vocoder (eval mode, on ``device``) and the serving
    limits shared by every session. Serves on the card unless ``device`` says
    otherwise (``device="cpu"``); raises when asked for CUDA without a card.
    A bf16 model (``StreamSpeechModel(cfg, dtype=torch.bfloat16)``) serves in
    bf16 (buffers as ``session_init`` says); the vocoder stays float32, as in
    ``measure_bf16_drift`` (`benchmarks.py:950-979`). The engine casts the
    model's Dense and convolution weights to bf16 once, here, in place
    (``layers.cast_compute_weights_``): the model computes as before and
    launches no per-call cast of them; it is then for serving only."""

    def __init__(
        self,
        model: StreamSpeechModel,
        vocoder: Optional[CodeGenerator] = None,
        device="cuda",
        max_enc_frames: int = 512,
        max_mt_tokens: int = 128,
        mt_buckets: Tuple[int, ...] = (16, 32, 64, 128),
        unit_buckets: Tuple[int, ...] = (64, 128, 256, 512),
        max_dur_per_unit: int = 4,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("StreamSpeechEngine: no CUDA device is available; "
                               "pass device='cpu' to serve on the CPU")
        self.model = cast_compute_weights_(model.to(self.device).eval())
        self.vocoder = None if vocoder is None else vocoder.to(self.device).eval()
        self.max_enc_frames = max_enc_frames
        self.max_mt_tokens = max_mt_tokens
        self.mt_buckets = mt_buckets
        self.unit_buckets = unit_buckets
        self.max_dur_per_unit = max_dur_per_unit
        # tail emission: vocode the last `window` expanded frames with `ctx`
        # frames of receptive-field context (HiFi-GAN RF ≈ 21 frames)
        self.emit_window_frames = 256
        self.emit_ctx_frames = 64
        self.emit_tail_cap = (self.emit_window_frames
                              - self.emit_ctx_frames) * SAMPLES_PER_FRAME
        # steps of one scan call at most (`session.py:151`)
        self.max_decode_per_call = 16
        # the fused tick's scan length (`session.py:154`): larger budgets take
        # the host path
        self.fused_steps = 8
        self.unit_blank = model.cfg.unit_decoder.vocab_size - 1
        self.graphs = TickGraphs(self)
        self._mt_positions = torch.arange(max_mt_tokens, device=self.device)
        self._enc_positions = torch.arange(max_enc_frames, device=self.device)

    def new_session(self) -> "StreamingSession":
        return StreamingSession(self)

    def session_init(self, batch: int = 1):
        """Fresh per-session device state for ``batch`` streams
        (`session.py:109-130`): encoder stream state (in the model's compute
        dtype), encoder output buffer [batch, max_enc_frames, C], MT self and
        cross KV caches. The MT self caches take one valid length a stream
        (``StreamKVCache``, with room for a scan call's steps past a stream's
        stop). The buffer and the MT caches are float32 whatever the model's
        dtype, as the JAX engine makes them (:118-127): a bf16 encoder's
        frames are widened into the buffer (:96), a bf16 model's keys and
        values into the caches, exactly."""
        c = self.model.cfg
        enc_state = self.model.encoder_stream_init(batch, self.max_enc_frames,
                                                   self.device)
        enc_buf = torch.zeros((batch, self.max_enc_frames, c.encoder.embed_dim),
                              device=self.device)
        dc = c.mt_decoder
        h, dh = dc.attention_heads, dc.embed_dim // dc.attention_heads
        mt_self = [StreamKVCache.create(batch, self.max_mt_tokens, h, dh, self.device,
                                        headroom=self.max_decode_per_call)
                   for _ in range(dc.layers)]
        mt_cross = [KVCache.create(batch, self.max_enc_frames, h, dh, self.device)
                    for _ in range(dc.layers)]
        return enc_state, enc_buf, mt_self, mt_cross

    @torch.no_grad()
    def mt_decode_greedy(self, mt_self, mt_cross, hyps: List[List[int]], budgets,
                         cross_valid: Optional[np.ndarray] = None, session=None):
        """One call of the scanned greedy MT decode for B streams
        (`session.py:1366-1421`, `batched.py:318-360`) of ``session``, whose
        caches ``mt_self`` and ``mt_cross`` must be (anything else raises).
        hyps [B]: each stream's hypothesis, whose length is its self caches'
        valid length (they hold the feeds [EOS] + hyp[:-1]; the newest token
        is unfed); budgets [B] on the host, at most ``max_decode_per_call``;
        ``cross_valid`` [B, max_enc_frames] bool on the host, the encoder
        frames each stream's cross-attention may read (None: the cross
        caches' whole valid length). The room is checked on the host first.

        The decode runs on the slot of the batch size, binding the session to
        it (``graphs.Slot.bind``): on a card the graph of (B, steps, dtype) is
        replayed, its inputs filled by one upload and its results read back
        in one copy; on the CPU the same part runs eagerly. Returns (new
        tokens a stream, hit_eos [B])."""
        lens = np.asarray([len(t) for t in hyps], np.int64)
        budgets = np.asarray(budgets, np.int64)
        steps = int(budgets.max())
        if int(lens.max()) + steps > mt_self[0].capacity:
            raise ValueError(f"KV cache overflow: {int(lens.max())} + {steps} > "
                             f"capacity {mt_self[0].capacity}")
        if session is None or mt_self is not session.mt_self \
                or mt_cross is not session.mt_cross:
            raise ValueError("mt_decode_greedy decodes a session's own caches: pass "
                             "them with session=")
        first = [t[-1] if t else EOS for t in hyps]
        b = len(hyps)
        slot = self.graphs.slot(b)
        slot.bind(session)
        h = slot.decode_in.h
        h["ints"][:] = np.stack([first, lens, budgets])
        if cross_valid is None:
            cross_valid = self.enc_frames_valid(slot.state[3][0].index)[None]
        h["cross_valid"][:] = cross_valid
        slot.decode_in.upload()
        self.graphs.run(slot, ("mt_decode", b, steps, str(self.model.dtype)),
                        lambda: self._decode_part(slot, steps))
        got = slot.decode_out.download()
        toks, (emitted, hit_eos) = got["toks"], got["vals"]
        return [toks[i, :emitted[i]].tolist() for i in range(b)], hit_eos > 0

    def enc_frames_valid(self, n: int) -> np.ndarray:
        """[max_enc_frames] bool: the first ``n`` encoder frames."""
        return np.arange(self.max_enc_frames) < n

    @torch.no_grad()
    def _decode_part(self, slot: Slot, steps: int):
        """The host decode's part: ``steps`` greedy steps from the slot's
        decode inputs (first token, offset, budget [B]; the cross-attention's
        frames [B, T]) into its results (tokens, emitted, hit_eos)."""
        x = slot.decode_in.d
        first, offset, budget = x["ints"].unbind(0)
        _, _, mt_self, mt_cross = slot.state
        toks, emitted, hit_eos = self.model.mt_decode_greedy(
            first, offset, budget, mt_self, mt_cross, steps, x["cross_valid"])
        out = slot.decode_out.d
        out["toks"][:, :steps].copy_(toks)
        out["vals"].copy_(torch.stack([emitted, hit_eos.long()]))

    def _collapsed_units(self, mt_tokens, enc_buf, enc_len, n_tokens, capacity: int):
        """Unit synthesis → CTC collapse on the device → vocoder codes: the
        shared front of the emissions (`session.py:189-207`, :282-294).
        mt_tokens [B, S]; enc_len, n_tokens [B] (tensors on the device).
        Returns (units [B, max(S*up, capacity)] dict ids, count [B], codes
        [B, capacity])."""
        ids = self.model.synthesize_units(mt_tokens, enc_buf, enc_len)[0]
        up = self.model.cfg.unit_decoder.ctc_upsample_rate
        pos_valid = (torch.arange(ids.shape[1], device=self.device)[None]
                     < (n_tokens * up)[:, None])
        is_unit = (ids >= NSPECIAL) & (ids < self.unit_blank)
        ids = torch.where(pos_valid & is_unit, ids,
                          torch.full_like(ids, self.unit_blank))
        units, count = ctc_collapse_device(ids, blank=self.unit_blank)
        codes = torch.where(units == self.unit_blank, torch.zeros_like(units),
                            units - NSPECIAL)
        count = torch.clamp(count, max=capacity)
        if capacity > codes.shape[1]:
            pad = capacity - codes.shape[1]
            codes = torch.nn.functional.pad(codes, (0, pad))
            units = torch.nn.functional.pad(units, (0, pad), value=self.unit_blank)
        return units, count, codes[:, :capacity]

    def _lengths(self, enc_len, n_tokens):
        return (host_to_device(np.atleast_1d(enc_len), self.device),
                host_to_device(np.atleast_1d(n_tokens), self.device))

    @torch.no_grad()
    def emit_batched(self, mt_tokens, enc_buf, enc_len, n_tokens, max_frames: int):
        """Full emission for B streams (`session.py:268-304`): unit synthesis,
        CTC collapse, duration prediction and vocoding of each whole prefix.
        mt_tokens [B, S]; enc_len, n_tokens [B] on the host. Returns (units
        [B, ·], count [B], wav [B, max_frames*320], n_samples [B], dur [B, ·])."""
        capacity = max_frames // self.max_dur_per_unit
        units, count, codes = self._collapsed_units(
            mt_tokens, enc_buf, *self._lengths(enc_len, n_tokens), capacity)
        dur_mask = (torch.arange(capacity, device=self.device)[None]
                    < count[:, None]).long()
        dur = self.vocoder.predict_durations(codes) * dur_mask
        wav, n_samples, dur = self.vocoder(codes, dur, max_frames)
        return units, count, wav, n_samples, dur

    def emit(self, mt_tokens, enc_buf, enc_len: int, n_tokens: int,
             max_frames: int):
        """``emit_batched`` for one stream. Returns (units, count, wav
        [max_frames*320], n_samples, dur)."""
        units, count, wav, n_samples, dur = self.emit_batched(
            mt_tokens, enc_buf, enc_len, n_tokens, max_frames)
        return units[0], count[0], wav[0], n_samples[0], dur[0]

    @torch.no_grad()
    def emit_tail_batched(self, mt_tokens, enc_buf, enc_len, n_tokens, n_prev_units,
                          unit_capacity: int):
        """Tail emission for B streams (`session.py:222-264`, :306-357): vocode
        only a window of ``emit_window_frames`` expanded frames ending at each
        sequence's end (receptive-field context included) and return only the
        new-wav tails [B, emit_tail_cap]. ``ok`` [B] is False where the window
        or tail cap is exceeded; the caller then takes the full emission.
        enc_len, n_tokens and n_prev_units [B] on the host."""
        return self._emit_tail(mt_tokens, enc_buf, *self._lengths(enc_len, n_tokens),
                               host_to_device(np.atleast_1d(n_prev_units), self.device),
                               unit_capacity)

    def _emit_tail(self, mt_tokens, enc_buf, enc_len, n_tokens, n_prev,
                   unit_capacity: int):
        """``emit_tail_batched`` on lengths already on the device [B]: what
        the fused tick's emission part runs."""
        units, count, codes = self._collapsed_units(mt_tokens, enc_buf, enc_len,
                                                    n_tokens, unit_capacity)
        pos = torch.arange(unit_capacity, device=self.device)[None]
        dur = self.vocoder.predict_durations(codes) * (pos < count[:, None]).long()
        total = dur.sum(dim=1)
        need = torch.where(pos >= n_prev[:, None], dur, 0).sum(dim=1)
        start = torch.clamp(total - need - self.emit_ctx_frames, min=0)
        wav_win, n_valid = self.vocoder.vocode_window(codes, dur, start,
                                                      self.emit_window_frames)
        cur_len = need * SAMPLES_PER_FRAME
        # clamped into the window like jax.lax.dynamic_slice's start index
        tail_start = torch.clamp(n_valid * SAMPLES_PER_FRAME - cur_len, 0,
                                 wav_win.shape[-1])
        wav_pad = torch.nn.functional.pad(wav_win, (0, self.emit_tail_cap))
        idx = tail_start[:, None] + torch.arange(self.emit_tail_cap, device=self.device)
        tail = torch.gather(wav_pad, 1, idx)
        ok = ((total - start) <= self.emit_window_frames) & \
            (cur_len <= self.emit_tail_cap)
        return units[:, :unit_capacity], count, dur, tail, cur_len, ok

    def emit_tail(self, mt_tokens, enc_buf, enc_len: int, n_tokens: int,
                  n_prev_units: int, unit_capacity: int):
        """``emit_tail_batched`` for one stream. Returns (units, count, dur,
        tail, cur_len, ok)."""
        out = self.emit_tail_batched(mt_tokens, enc_buf, enc_len, n_tokens,
                                     n_prev_units, unit_capacity)
        return tuple(x[0] for x in out)

    # ------------------------------------------------------------------
    # the fused tick (`session.py:360-840`): encode + gates, decode +
    # rollback, emission; a CUDA graph each on a card (runtime/graphs.py)
    # ------------------------------------------------------------------

    def policy_step_batched(self, session, blocks, valid, enc_len, mt_tokens, src_len,
                            tgt_len, asr_count, st_count, last_asr, last_st, n_units,
                            starts_word, active, finished, tail_ready, chunk: int,
                            conv_chunk: int, whole_word: bool, k1: int, n: int,
                            max_len: int, mt_cap: int, unit_capacity: int,
                            with_emission: bool = True) -> Dict[str, np.ndarray]:
        """One fused policy tick of the B streams of ``session`` (a
        ``StreamingSession`` at B = 1 or a ``BatchedStreamingSession``), the
        counterpart of JAX's ``policy_step_batched`` (`session.py:635-840`)
        and, at B = 1 with nothing finished, of ``policy_step``'s
        ``policy_core`` (:360-527). The host arrays [B] give each stream's
        block valid frames, true encoder length, policy counters, the emitted
        units so far, ``active``, ``finished`` and ``tail_ready`` (a finished
        stream's finish decode starts only once its whole tail is encoded);
        ``mt_tokens`` the hypotheses; blocks [B, block_frames, 80].

        Everything JAX computes on the device stays there: the CTC growth
        recurrences, the gates and budget clamps, ``room``, the decode of at
        most ``fused_steps`` tokens, the rollback to the last word start
        (``starts_word`` [V] bool), ``do_emit`` and the tail window's ``ok``.
        The host reads after each part and runs the next only when a stream
        needs it (JAX's ``lax.cond``s), so the decode and the emission cost
        nothing on a tick that skips them. The session is bound to the slot
        of its batch size first (``graphs.Slot.bind``).

        Returns numpy arrays: ``flags`` [B, 6] (do_decode, do_emit, ok,
        budget_over, hit_eos, grew), ``asr_ids``/``st_ids`` [B, s] of the new
        frames, ``asr_count``, ``st_count``, ``keep``, ``mt_buf`` [B,
        max_mt_tokens], and the emission: ``units``/``dur`` [B, unit_capacity],
        ``count``, ``tail`` [B, emit_tail_cap], ``cur_len`` (JAX's no-emit
        values where no stream emitted). ``hit_eos`` counts only an EOS that
        a step within the budget predicted (``mt_decode_greedy``)."""
        b = len(mt_tokens)
        block_frames = blocks.shape[1]
        slot = self.graphs.slot(b)
        slot.bind(session)
        slot.set_starts_word(starts_word)
        inp, enc_out = slot.io(block_frames)
        m = self.max_mt_tokens
        n_tokens = np.asarray([len(t) for t in mt_tokens], np.int64)
        mt_buf = inp.h["mt_buf"]
        mt_buf.fill(PAD)
        for i, t in enumerate(mt_tokens):
            mt_buf[i, :len(t)] = t
        per_row = dict(valid=valid, enc_len=enc_len, n_tokens=n_tokens, src_len=src_len,
                       tgt_len=tgt_len, asr_count=asr_count, st_count=st_count,
                       last_asr=last_asr, last_st=last_st, n_units=n_units,
                       active=active, finished=finished, tail_ready=tail_ready,
                       k1=k1, n=n, whole_word=int(whole_word), max_len=max_len,
                       emission=int(with_emission))
        ints = inp.h["ints"]
        for row, name in enumerate(Slot.INPUTS):
            ints[row] = np.asarray(per_row[name], np.int64)
        inp.h["block"][...] = blocks
        inp.upload()

        dtype = str(self.model.dtype)
        key = (b, block_frames, chunk, conv_chunk, dtype)
        self.graphs.run(slot, ("encode",) + key,
                        lambda: self._tick_encode(slot, block_frames, chunk, conv_chunk))
        got = enc_out.download()
        asr_count_d, st_count_d, do_decode, budget_over, grew = got["vals"].copy()
        out = {"asr_ids": got["ids"][0].copy(), "st_ids": got["ids"][1].copy(),
               "asr_count": asr_count_d, "st_count": st_count_d,
               "keep": n_tokens.copy(), "mt_buf": mt_buf.copy(),
               "units": np.full((b, unit_capacity), self.unit_blank, np.int64),
               "count": np.zeros(b, np.int64),
               "dur": np.zeros((b, unit_capacity), np.int64),
               "tail": np.zeros((b, self.emit_tail_cap), np.float32),
               "cur_len": np.zeros(b, np.int64)}
        hit_eos = do_emit = np.zeros(b, np.int64)
        ok = np.ones(b, np.int64)
        if do_decode.any():
            self.graphs.run(slot, ("decode",) + key,
                            lambda: self._tick_decode(slot, block_frames))
            got = slot.decoded.download()
            out["keep"], hit_eos, do_emit = got["vals"].copy()
            out["mt_buf"] = got["mt_buf"].copy()
        if do_emit.any():
            emitted = slot.emitted(unit_capacity)
            self.graphs.run(slot, ("emit",) + key + (mt_cap, unit_capacity),
                            lambda: self._tick_emit(slot, block_frames, mt_cap,
                                                    unit_capacity))
            got = emitted.download()
            out["count"], out["cur_len"], ok = got["vals"].copy()
            for name in ("units", "dur", "tail"):
                out[name] = got[name].copy()
        out["flags"] = np.stack([do_decode, do_emit, ok, budget_over, hit_eos, grew],
                                axis=1).astype(bool)
        return out

    def policy_step(self, session, block, src_len: int, tgt_len: int, asr_count: int,
                    st_count: int, last_asr: int, last_st: int, n_units: int,
                    starts_word, chunk: int, conv_chunk: int, whole_word: bool,
                    k1: int, n: int, max_len: int, mt_cap: int,
                    unit_capacity: int) -> Dict[str, np.ndarray]:
        """One stream's fused policy chunk (JAX ``policy_step``,
        `session.py:536-562`): ``policy_step_batched`` at B = 1 over a whole
        block of an unfinished stream. Returns its arrays, each stream's
        axis kept."""
        one = np.ones(1, np.int64)
        return self.policy_step_batched(
            session, block[None], one * block.shape[0], one * session.enc_len,
            [session.mt_tokens], one * src_len, one * tgt_len, one * asr_count,
            one * st_count, one * last_asr, one * last_st, one * n_units, starts_word,
            one, one * 0, one * 0, chunk, conv_chunk, whole_word, k1, n, max_len,
            mt_cap, unit_capacity)

    # ------------------------------------------------------------------
    # the overlapped tick (`session.py:564-626`): one graph a chunk, its
    # conds IF nodes, the policy counters resident on the device
    # ------------------------------------------------------------------

    def pipe_pack(self, session, mt_tokens: List[int], src_len: int, tgt_len: int,
                  asr_count: int, st_count: int, last_asr: int, last_st: int,
                  n_units: int) -> None:
        """(Re)write the device-resident policy counters of ``session``'s slot
        (B = 1) from host values, in one copy (JAX ``pipe_pack``): at the
        overlapped loop's entry and after each host interlude, when the host
        mirror is authoritative."""
        slot = self.graphs.slot(1)
        slot.bind(session)
        h = slot.pol.h
        h["mt_buf"].fill(PAD)
        h["mt_buf"][0, :len(mt_tokens)] = mt_tokens
        h["ints"][:, 0] = [len(mt_tokens), src_len, tgt_len, asr_count, st_count,
                           last_asr, last_st, n_units]
        slot.pol.upload()

    def policy_step_pipelined(self, session, block: np.ndarray, enc_len: int,
                              starts_word, chunk: int, conv_chunk: int, whole_word: bool,
                              k1: int, n: int, max_len: int, mt_cap: int,
                              unit_capacity: int) -> dict:
        """Dispatch one policy chunk of ``session`` (B = 1) against the
        device-resident counters (JAX ``policy_step_pipelined``): the block
        and the host-known inputs (``enc_len``, the dispatched encoder
        frames; k1, n, whole_word, max_len) go up from a ring entry in one
        copy, the chunk's graph replays, and its bundle comes back into the
        same entry, a copy enqueued behind it with an event recorded. Never
        waits for the card. Returns the in-flight record for
        ``pipe_fetch``."""
        block_frames = block.shape[0]
        slot = self.graphs.slot(1)
        slot.bind(session)
        slot.set_starts_word(starts_word)
        inp, _ = slot.io(block_frames)
        out, ring = slot.pipe(block_frames)
        entry = ring.take()
        ints = dict(zip(Slot.INPUTS, entry["in"]["ints"]))
        for name, value in (("valid", block_frames), ("enc_len", enc_len), ("active", 1),
                            ("finished", 0), ("tail_ready", 0), ("k1", k1), ("n", n),
                            ("whole_word", int(whole_word)), ("max_len", max_len),
                            ("emission", 1)):
            ints[name][:] = value
        entry["in"]["block"][0] = block
        inp.dev.copy_(entry["host_in"], non_blocking=True)
        key = ("pipelined", 1, block_frames, chunk, conv_chunk, str(self.model.dtype),
               mt_cap, unit_capacity)
        branches = self.graphs.run(
            slot, key, lambda: self._tick_pipelined(slot, block_frames, chunk, conv_chunk,
                                                    mt_cap, unit_capacity),
            keep=(slot.pol.dev,))
        entry["host_out"].copy_(out.dev, non_blocking=True)
        if entry["event"] is not None:
            entry["event"].record()
        return {"entry": entry, "ring": ring, "branches": branches,
                "unit_capacity": unit_capacity}

    def pipe_fetch(self, rec: dict) -> Tuple[Dict[str, np.ndarray], float]:
        """The bundle of a dispatched chunk (``policy_step_pipelined``):
        waits on its copy's event only, where the copy has not landed yet.
        Adds the launches of the cond bodies its flags say ran. Returns
        (the bundle's arrays of stream 0, the seconds the host waited, 0.0
        where the copy had landed)."""
        entry, ev = rec["entry"], rec["entry"]["event"]
        waited = 0.0
        if ev is not None and not ev.query():
            t0 = time.perf_counter()
            ev.synchronize()
            waited = time.perf_counter() - t0
        got = entry["out"]
        vals = dict(zip(Slot.PIPE_VALS, got["vals"][:, 0].tolist()))
        u = rec["unit_capacity"]
        bundle = {**vals, "asr_ids": got["ids"][0, 0].copy(), "st_ids": got["ids"][1, 0].copy(),
                  "units": got["units"][0, :u].copy(), "dur": got["dur"][0, :u].copy(),
                  "tail": got["tail"][0].copy(), "mt_buf": got["mt_buf"][0].copy()}
        rec["ring"].give(entry)
        TickGraphs.count_branches(rec["branches"], (vals["do_decode"] > 0,
                                                    vals["do_emit"] > 0))
        return bundle, waited

    @torch.no_grad()
    def _tick_pipelined(self, slot: Slot, block_frames: int, chunk: int, conv_chunk: int,
                        mt_cap: int, unit_capacity: int):
        """The overlapped tick (`session.py:564-611`): the fused tick's three
        parts with the counters read from ``pol`` instead of the upload, the
        decode and the emission each under a ``cond`` (their skip values
        written first), then the agent's counter recurrences written back
        into ``pol`` (:598-609), and the bundle in JAX's order (:610-611).
        ``no_room``: the decode lacked the MT caches' room, where the
        synchronous tick would not have applied and the host takes the
        chunk (``StreamingSession.fused_policy``)."""
        inp, enc_out = slot.io(block_frames)
        pol, mid, dec = slot.pol.d, slot.mid, slot.decoded.d
        inp.d["ints"].index_copy_(0, slot.pol_rows, pol["ints"])
        inp.d["mt_buf"].copy_(pol["mt_buf"])
        self._tick_encode(slot, block_frames, chunk, conv_chunk)
        x = self._inputs(slot, block_frames)
        n_tokens = x["n_tokens"]
        # JAX's skip branch (`session.py:453-455`)
        mid["keep"].copy_(n_tokens)
        mid["mt_buf"].copy_(x["mt_buf"])
        mid["do_emit"].zero_()
        dec["vals"].zero_()
        dec["vals"][0].copy_(n_tokens)
        cond(mid["do_decode"].any(), lambda: self._tick_decode(slot, block_frames))
        # JAX's no-emit bundle (:508-513)
        em = slot.emitted(unit_capacity).d
        em["vals"].zero_()
        em["vals"][2].fill_(1)
        em["units"].fill_(self.unit_blank)
        em["dur"].zero_()
        em["tail"].zero_()
        cond(mid["do_emit"].any(), lambda: self._tick_emit(slot, block_frames, mt_cap,
                                                           unit_capacity))
        asr_count, st_count, do_decode, budget_over, grew = enc_out.d["vals"].unbind(0)
        keep, hit_eos, do_emit = dec["vals"].unbind(0)
        count, cur_len, ok = em["vals"].unbind(0)
        ids = enc_out.d["ids"]
        out_valid = -(-x["valid"] // 4)
        last = (out_valid - 1).clamp(min=0)[None, :, None].expand(2, -1, 1)
        last_ids = torch.where(out_valid > 0, ids.gather(2, last)[..., 0],
                               torch.stack([x["last_asr"], x["last_st"]]))
        grown = grew > 0
        n_units = x["n_units"]
        pol["ints"].copy_(torch.stack([
            keep,
            torch.where(grown, torch.maximum(asr_count, x["src_len"]), x["src_len"]),
            torch.where(grown, torch.maximum(st_count, x["tgt_len"]), x["tgt_len"]),
            asr_count, st_count, last_ids[0], last_ids[1],
            torch.where((do_emit > 0) & (ok > 0) & (count > n_units), count, n_units)]))
        pol["mt_buf"].copy_(mid["mt_buf"])
        no_room = n_tokens + self.fused_steps > self.max_mt_tokens
        out = slot.pipe(block_frames)[0].d
        out["vals"].copy_(torch.stack([do_decode, do_emit, ok, budget_over, hit_eos, grew,
                                       keep, asr_count, st_count, count, cur_len,
                                       no_room.long()]))
        out["ids"].copy_(ids)
        out["units"].fill_(self.unit_blank)
        out["units"][:, :unit_capacity].copy_(em["units"])
        out["dur"].zero_()
        out["dur"][:, :unit_capacity].copy_(em["dur"])
        out["tail"].copy_(em["tail"])
        out["mt_buf"].copy_(mid["mt_buf"])

    def _inputs(self, slot: Slot, block_frames: int) -> Dict[str, torch.Tensor]:
        inp = slot.io(block_frames)[0].d
        return {**dict(zip(Slot.INPUTS, inp["ints"].unbind(0))),
                "mt_buf": inp["mt_buf"], "block": inp["block"]}

    @torch.no_grad()
    def _tick_encode(self, slot: Slot, block_frames: int, chunk: int, conv_chunk: int):
        """Encode + gates (`session.py:385-422`, :660-715): encode the block
        against the slot's caches, write it into the encoder buffer and the
        MT cross caches, grow each stream's deduplicated CTC counts over its
        valid frames and decide which streams decode and how far."""
        x = self._inputs(slot, block_frames)
        enc_state, enc_buf, _, mt_cross = slot.state
        valid = x["valid"]
        enc, _, asr_ids, st_ids = self.model.encode_block_with_ctc(
            x["block"], enc_state, chunk, conv_chunk, valid)
        s = enc.shape[1]
        enc_buf.index_copy_(1, enc_state.pos_dev - s + self._enc_positions[:s],
                            enc.to(enc_buf.dtype))
        self.model.mt_fill_cross(enc, mt_cross)
        out_valid = -(-valid // 4)                      # real encoder frames a stream
        valid_f = self._enc_positions[None, :s] < out_valid[:, None]

        def grow(count, last, ids):
            prev = torch.cat([last[:, None], ids[:, :-1]], dim=1)
            fresh = (ids != prev) & (ids != 0) & valid_f
            return count + fresh.sum(dim=1)

        asr_count = grow(x["asr_count"], x["last_asr"], asr_ids)
        st_count = grow(x["st_count"], x["last_st"], st_ids)
        n_tokens, max_len, n, steps = x["n_tokens"], x["max_len"], x["n"], self.fused_steps
        finished = x["finished"] > 0
        grew = (asr_count >= x["src_len"] + n) & (st_count >= x["tgt_len"] + n)
        subword = torch.div(st_count - x["k1"], n, rounding_mode="floor") * n \
            + x["whole_word"]
        # clamped at max_len as the host decode's loop guard clamps it
        budget_stream = torch.minimum(subword - n_tokens, max_len - n_tokens)
        budget_fin = max_len - n_tokens
        budget = torch.where(finished, budget_fin.clamp(0, steps), budget_stream)
        wanted = torch.where(finished, (budget_fin >= 1) & (x["tail_ready"] > 0),
                             grew & (budget_stream >= 1))
        budget_over = ~finished & (budget_stream > steps)
        room = n_tokens + steps <= self.max_mt_tokens
        do_decode = wanted & ~budget_over & room & (x["active"] > 0)
        mid = slot.mid
        mid["do_decode"].copy_(do_decode)
        mid["budget"].copy_(budget)
        mid["enc_len"].copy_(x["enc_len"] + out_valid)
        out = slot.io(block_frames)[1].d
        out["ids"].copy_(torch.stack([asr_ids, st_ids]))
        out["vals"].copy_(torch.stack([asr_count, st_count, do_decode.long(),
                                       budget_over.long(), grew.long()]))

    @torch.no_grad()
    def _tick_decode(self, slot: Slot, block_frames: int):
        """Decode + rollback (`session.py:426-465`, :719-759): at most
        ``fused_steps`` greedy tokens a decoding stream (budget 0 for the
        others), the new tokens written after each hypothesis, the rollback
        to the last word start of a streaming stream (none found: keep 0),
        and ``do_emit``. The MT self caches need no truncation: their valid
        length is the hypothesis the host keeps."""
        x = self._inputs(slot, block_frames)
        _, _, mt_self, mt_cross = slot.state
        mid = slot.mid
        n_tokens, mt_buf, steps = x["n_tokens"], x["mt_buf"], self.fused_steps
        finished = x["finished"] > 0
        do_decode = mid["do_decode"]
        feed = torch.where(n_tokens > 0,
                           mt_buf.gather(1, (n_tokens - 1).clamp(min=0)[:, None])[:, 0],
                           EOS)
        budgets = torch.where(do_decode, mid["budget"].clamp(0, steps), 0)
        cross_valid = self._enc_positions[None] < mid["enc_len"][:, None]
        toks, emitted, hit_eos = self.model.mt_decode_greedy(
            feed, n_tokens, budgets, mt_self, mt_cross, steps, cross_valid)
        pos = self._mt_positions[None]
        n_total = n_tokens + emitted
        new = (pos >= n_tokens[:, None]) & (pos < n_total[:, None])
        rel = (pos - n_tokens[:, None]).clamp(0, steps - 1)
        mt_out = torch.where(new, toks.gather(1, rel), mt_buf)
        # the last word start before n_total, exclusive (`agent.py:542-559`)
        starts = slot.starts_word[mt_out] & (pos < n_total[:, None])
        keep_ww = torch.where(starts, pos, -1).amax(dim=1).clamp(min=0)
        keep = torch.where((x["whole_word"] > 0) & ~finished, keep_ww, n_total)
        keep = torch.where(do_decode, keep, n_tokens)
        # a finished stream emits once, when it has drained (`session.py:761-767`)
        do_emit = do_decode & (keep > n_tokens) & ~finished & (x["emission"] > 0)
        mid["keep"].copy_(keep)
        mid["mt_buf"].copy_(mt_out)
        mid["do_emit"].copy_(do_emit)
        out = slot.decoded.d
        out["vals"].copy_(torch.stack([keep, (hit_eos & do_decode).long(),
                                       do_emit.long()]))
        out["mt_buf"].copy_(mt_out)

    @torch.no_grad()
    def _tick_emit(self, slot: Slot, block_frames: int, mt_cap: int,
                   unit_capacity: int):
        """Emission (`session.py:467-513`, :770-816): unit synthesis of every
        stream's kept prefix in the ``mt_cap`` bucket against its encoder
        length, CTC collapse, durations and the windowed vocode tail."""
        x = self._inputs(slot, block_frames)
        _, enc_buf, _, _ = slot.state
        keep, mt_out = slot.mid["keep"], slot.mid["mt_buf"]
        b = keep.shape[0]
        eos = torch.full((b, 1), EOS, dtype=mt_out.dtype, device=self.device)
        shifted = torch.cat([eos, mt_out], dim=1)[:, :mt_cap]
        padded = torch.where(self._mt_positions[None, :mt_cap] <= keep[:, None],
                             shifted, PAD)
        units, count, dur, tail, cur_len, ok = self._emit_tail(
            padded, enc_buf, slot.mid["enc_len"], keep + 1, x["n_units"], unit_capacity)
        out = slot.emitted(unit_capacity).d
        out["vals"].copy_(torch.stack([count, cur_len, ok.long()]))
        out["units"].copy_(units)
        out["dur"].copy_(dur)
        out["tail"].copy_(tail)

    def warmup(self, chunk: int = 8, conv_chunk: int = 8, batch_sizes=(1,),
               pipelined: bool = False) -> dict:
        """Capture the serving graphs for the given chunking (the variants
        JAX's ``warmup`` compiles, `session.py:878-1028`); a serving-startup
        cost, not a per-chunk one. Whether a stream finished, whole_word, k1,
        n and max_len are inputs of the graphs, so they need no variants.

        At each batch size in ``batch_sizes``: every part of the fused tick
        for every MT bucket, and the host decode at every step count up to
        ``max_decode_per_call``. With ``pipelined``: the overlapped tick of
        one stream for every MT bucket and the host decode at B = 1 (its
        fallbacks and finish decode; JAX's ``pipe_dispatch[mt{cap}]``,
        ``pipe_fallback_decode``), and not the fused tick it never runs
        (JAX's ``sync=not pipelined``, :890-895). The slots' states are left
        as they were. Returns ``graphs.stats()``. On the CPU, nothing is
        captured."""
        block_frames = 4 * math.lcm(max(chunk, 1), max(conv_chunk, 1))
        steps = self.fused_steps
        up = self.model.cfg.unit_decoder.ctc_upsample_rate
        dtype = str(self.model.dtype)
        for b in ((1,) if pipelined else batch_sizes):
            slot = self.graphs.slot(b)
            inp, _ = slot.io(block_frames)
            ints = dict(zip(Slot.INPUTS, inp.h["ints"]))
            for name, value in (("valid", block_frames), ("active", 1), ("n", 1),
                                ("max_len", self.max_mt_tokens - 2), ("emission", 1)):
                ints[name][:] = value
            inp.h["mt_buf"].fill(NSPECIAL)
            key = (b, block_frames, chunk, conv_chunk, dtype)
            for mt_cap in self.mt_buckets:
                fill = max(min(mt_cap - steps - 2, self.max_mt_tokens - steps), 0)
                ints["n_tokens"][:] = fill
                inp.upload()
                u_cap = _bucket(min(mt_cap * up, self.unit_buckets[-1]), self.unit_buckets)
                slot.emitted(u_cap)
                if pipelined:
                    slot.pol.h["ints"].fill(0)
                    slot.pol.h["ints"][Slot.POL.index("n_tokens")] = fill
                    slot.pol.h["mt_buf"].fill(NSPECIAL)
                    slot.pol.upload()
                    slot.pipe(block_frames)
                    self.graphs.capture(
                        slot, ("pipelined",) + key + (mt_cap, u_cap),
                        lambda: self._tick_pipelined(slot, block_frames, chunk, conv_chunk,
                                                     mt_cap, u_cap), keep=(slot.pol.dev,))
                    continue
                self.graphs.capture(slot, ("encode",) + key, lambda: self._tick_encode(
                    slot, block_frames, chunk, conv_chunk))
                self.graphs.capture(slot, ("decode",) + key,
                                    lambda: self._tick_decode(slot, block_frames))
                slot.mid["keep"].fill_(fill + steps)
                self.graphs.capture(slot, ("emit",) + key + (mt_cap, u_cap),
                                    lambda: self._tick_emit(slot, block_frames, mt_cap,
                                                            u_cap))
            h = slot.decode_in.h
            h["ints"][0], h["ints"][1] = NSPECIAL, 0
            h["cross_valid"][:] = self.enc_frames_valid(block_frames // 4)
            for n_steps in range(1, self.max_decode_per_call + 1):
                h["ints"][2] = n_steps
                slot.decode_in.upload()
                self.graphs.capture(slot, ("mt_decode", b, n_steps, dtype),
                                    lambda: self._decode_part(slot, n_steps))
        return self.graphs.stats()


class StreamingSession:
    """Per-utterance state and host-side orchestration (batch 1)."""

    def __init__(self, engine: StreamSpeechEngine):
        self.e = engine
        (self.enc_state, self.enc_buf, self.mt_self,
         self.mt_cross) = engine.session_init()
        self.enc_len = 0
        self.asr_ids: List[int] = []
        self.st_ids: List[int] = []
        # hypothesis, EXCLUDING the leading eos; its length is the tokens fed
        # (the leading eos included) and the MT self caches' valid length
        self.mt_tokens: List[int] = []
        self.pending_feats = np.zeros(
            (0, engine.model.cfg.encoder.input_feat_per_channel), np.float32)
        self.finished_input = False
        # a list to which ``fused_policy`` appends each call's inputs, when set
        # (JAX's ``record``: a benchmark replays them, ``replay_recorded``)
        self.record: Optional[List[Dict]] = None
        # the overlapped loop (`session.py:1053-1067`): while chunks are in
        # flight the fields above are a lagged mirror, advanced as each
        # chunk's bundle is fetched; the device's positions (``enc_state.pos``,
        # the caches' ``index``) advance at dispatch, and
        # ``enc_len_dispatched`` counts the encoder frames dispatched
        self.pipe_state: Optional[str] = None
        self.pipe_inflight: List[Dict] = []
        self.enc_len_dispatched = 0
        self._pipe_src_len = 0
        self._pipe_tgt_len = 0
        self._pipe_n_units = 0
        self.pipe_stats = {"dispatches": 0, "fetches": 0, "waited_fetches": 0,
                           "wait_s": 0.0, "deepest": 0}

    # ------------------------------------------------------------------
    # encoder side
    # ------------------------------------------------------------------

    def push_features(self, feats: np.ndarray, chunk_size: int,
                      conv_chunk_size: int, finished: bool = False) -> int:
        """Feed new (already CMVN'd) fbank frames; encode every complete block
        (4 × lcm(chunk, conv_chunk) frames) and, at finish, the padded tail.
        Returns the number of new encoder frames (`session.py:1073-1100`)."""
        self.pending_feats = np.concatenate([self.pending_feats, feats], axis=0)
        block_enc = math.lcm(max(chunk_size, 1), max(conv_chunk_size, 1))
        block_frames = 4 * block_enc
        new_frames = 0
        while self.pending_feats.shape[0] >= block_frames:
            block = self.pending_feats[:block_frames]
            self.pending_feats = self.pending_feats[block_frames:]
            new_frames += self._run_block(block, chunk_size, conv_chunk_size)
        if finished and not self.finished_input:
            self.finished_input = True
            tail = self.pending_feats
            self.pending_feats = tail[:0]
            if tail.shape[0] > 0:
                pad_to = -(-tail.shape[0] // 4) * 4
                block = np.zeros((pad_to, tail.shape[1]), np.float32)
                block[: tail.shape[0]] = tail
                new_frames += self._run_block(block, chunk_size, conv_chunk_size,
                                              valid_len=tail.shape[0])
        return new_frames

    @torch.no_grad()
    def _run_block(self, block: np.ndarray, chunk: int, conv_chunk: int,
                   valid_len: Optional[int] = None) -> int:
        x = torch.from_numpy(np.ascontiguousarray(block))[None].to(self.e.device)
        enc, self.enc_state, asr_ids, st_ids = self.e.model.encode_block_with_ctc(
            x, self.enc_state, chunk, conv_chunk, valid_len)
        s = enc.shape[1]
        pos = self.enc_state.pos  # the KV append above raised if pos > capacity
        self.enc_buf[:, pos - s:pos] = enc
        self.enc_len += s
        self.enc_len_dispatched = max(self.enc_len_dispatched, self.enc_len)
        self.mt_cross = self.e.model.mt_fill_cross(enc, self.mt_cross)
        self.asr_ids.extend(asr_ids[0].tolist())
        self.st_ids.extend(st_ids[0].tolist())
        return s

    def fused_policy(self, feats: np.ndarray, chunk: int, conv_chunk: int, k1: int,
                     n: int, whole_word: bool, max_len: int, starts_word,
                     src_len: int, tgt_len: int, n_prev_units: int) -> Optional[Dict]:
        """One policy chunk through the engine's fused tick (`session.py:
        1122-1219`). Returns None where it does not apply, and the caller
        then pushes the pending frames through the host path: the input has
        finished, or not exactly one whole block is pending, or the MT or
        encoder caches lack room for it. Else a dict of the decisions
        (``do_decode``, ``do_emit``, ``ok``, ``budget_over``, ``hit_eos``,
        ``grew``), ``keep``, the CTC counts and, when it emitted, ``units``,
        ``dur`` and the new wav ``tail``; the hypothesis follows ``keep``."""
        self.pending_feats = np.concatenate([self.pending_feats, feats], axis=0)
        block_enc = math.lcm(max(chunk, 1), max(conv_chunk, 1))
        block_frames = 4 * block_enc
        steps = self.e.fused_steps
        if (self.finished_input
                or self.pending_feats.shape[0] // block_frames != 1
                or len(self.mt_tokens) + steps > self.e.max_mt_tokens
                or self.enc_state.pos + block_enc > self.e.max_enc_frames):
            return None
        block = self.pending_feats[:block_frames]
        self.pending_feats = self.pending_feats[block_frames:]
        e = self.e
        max_len = min(max_len, e.max_mt_tokens - 2, e.mt_buckets[-1] - 2)
        mt_cap = _bucket(min(len(self.mt_tokens) + steps + 2, e.mt_buckets[-1]),
                         e.mt_buckets)
        u_cap = _bucket(min(mt_cap * e.model.cfg.unit_decoder.ctc_upsample_rate,
                            e.unit_buckets[-1]), e.unit_buckets)
        # the host side of the device growth recurrence
        asr_count = len(ctc_collapse(np.asarray(self.asr_ids), blank=0)[0])
        st_count = len(ctc_collapse(np.asarray(self.st_ids), blank=0)[0])
        args = dict(block=block, src_len=src_len, tgt_len=tgt_len, asr_count=asr_count,
                    st_count=st_count, last_asr=self.asr_ids[-1] if self.asr_ids else -1,
                    last_st=self.st_ids[-1] if self.st_ids else -1,
                    n_units=n_prev_units, starts_word=starts_word, chunk=chunk,
                    conv_chunk=conv_chunk, whole_word=whole_word, k1=k1, n=n,
                    max_len=max_len, mt_cap=mt_cap, unit_capacity=u_cap)
        if self.record is not None:
            self.record.append(dict(args, block=block.copy(), enc_len=self.enc_len,
                                    mt_tokens=list(self.mt_tokens)))
        got = e.policy_step(self, **args)
        flags = got["flags"][0]
        out = dict(zip(("do_decode", "do_emit", "ok", "budget_over", "hit_eos", "grew"),
                       map(bool, flags)))
        out.update(keep=int(got["keep"][0]), asr_count=int(got["asr_count"][0]),
                   st_count=int(got["st_count"][0]), count=int(got["count"][0]))
        self.enc_len += block_enc
        self.asr_ids.extend(got["asr_ids"][0].tolist())
        self.st_ids.extend(got["st_ids"][0].tolist())
        if out["do_decode"]:
            self.mt_tokens = got["mt_buf"][0, :out["keep"]].tolist()
        if out["do_emit"]:
            out["units"] = got["units"][0, :out["count"]].tolist()
            out["dur"] = got["dur"][0, :out["count"]]
            out["tail"] = got["tail"][0, :int(got["cur_len"][0])]
        return out

    def replay_recorded(self, rec: Dict) -> Dict[str, np.ndarray]:
        """Replay one call ``fused_policy`` recorded (``record``) on this
        session: its hypothesis and encoder length as they were then, the
        same inputs. Returns the engine's bundle; the encoder length and
        the hypothesis follow it, as ``fused_policy`` moves them."""
        self.mt_tokens, self.enc_len = list(rec["mt_tokens"]), rec["enc_len"]
        got = self.e.policy_step(self, **{k: v for k, v in rec.items()
                                          if k not in ("mt_tokens", "enc_len")})
        self.enc_len += rec["block"].shape[0] // 4
        if got["flags"][0, 0]:
            self.mt_tokens = got["mt_buf"][0, :int(got["keep"][0])].tolist()
        return got

    # ------------------------------------------------------------------
    # the overlapped loop (`session.py:1228-1352`): dispatch chunk N + 1
    # before fetching chunk N; the fields above are a mirror, lagged
    # ------------------------------------------------------------------

    def pipe_resync(self) -> None:
        """(Re)write the device counters from the host mirror, which is
        authoritative here: at the loop's entry and after a host interlude
        (a fallback, a drain). Nothing may be in flight."""
        if self.pipe_inflight:
            raise RuntimeError("pipe_resync with chunks in flight")
        self.e.pipe_pack(
            self, self.mt_tokens, self._pipe_src_len,
            self._pipe_tgt_len, len(ctc_collapse(np.asarray(self.asr_ids), blank=0)[0]),
            len(ctc_collapse(np.asarray(self.st_ids), blank=0)[0]),
            self.asr_ids[-1] if self.asr_ids else -1,
            self.st_ids[-1] if self.st_ids else -1, self._pipe_n_units)
        self.enc_len_dispatched = self.enc_len
        self.pipe_state = "synced"

    def pipe_set_counters(self, src_len: int, tgt_len: int, n_units: int) -> None:
        """The agent's policy counters (prefix lengths, emitted units), which
        the next resync writes to the device."""
        self._pipe_src_len, self._pipe_tgt_len, self._pipe_n_units = (src_len, tgt_len,
                                                                      n_units)

    def _pipe_max_len(self) -> int:
        return min(self.e.max_mt_tokens - 2, self.e.mt_buckets[-1] - 2)

    def pipe_applicable(self, n_blocks_pending: int, block_enc: int) -> bool:
        """Whether the next chunk can be dispatched: one whole block pending,
        the encoder caches' room at the dispatched position, and the MT
        caches' room at the mirror's hypothesis, the synchronous tick's
        conditions (``fused_policy``). A hypothesis that outgrows the room
        while chunks are in flight is caught on the device (the bundle's
        ``no_room``), and the host takes that chunk as the synchronous path
        would. (JAX asks for room for a hypothesis at ``max_len`` instead,
        which the engine's default sizes never give: its overlapped agent
        then takes the host path for every chunk.)"""
        return (not self.finished_input
                and n_blocks_pending == 1
                and len(self.mt_tokens) + self.e.fused_steps <= self.e.max_mt_tokens
                and self.enc_len_dispatched + block_enc <= self.e.max_enc_frames)

    def pipe_dispatch(self, block: np.ndarray, chunk: int, conv_chunk: int, k1: int,
                      n: int, whole_word: bool, max_len: int, starts_word,
                      decision_ms: float, block_enc: int) -> None:
        """Dispatch one policy chunk against the device counters and enqueue
        the copy of its bundle (``StreamSpeechEngine.policy_step_pipelined``).
        Never waits for the card: no read between two dispatches. The MT
        bucket bounds the hypothesis by the lagged mirror plus ``steps`` for
        each chunk in flight (JAX :1280-1287); a larger bucket than the
        synchronous tick's costs compute and changes no result."""
        e = self.e
        steps = e.fused_steps
        max_len = min(max_len, self._pipe_max_len())
        bound = min(len(self.mt_tokens) + (len(self.pipe_inflight) + 1) * steps, max_len)
        mt_cap = _bucket(min(bound + 2, e.mt_buckets[-1]), e.mt_buckets)
        u_cap = _bucket(min(mt_cap * e.model.cfg.unit_decoder.ctc_upsample_rate,
                            e.unit_buckets[-1]), e.unit_buckets)
        rec = e.policy_step_pipelined(self, block, self.enc_len_dispatched, starts_word,
                                      chunk, conv_chunk, whole_word, k1, n, max_len,
                                      mt_cap, u_cap)
        self.enc_len_dispatched += block_enc
        self.pipe_inflight.append(dict(rec, t=time.perf_counter(), block_enc=block_enc,
                                       decision_ms=decision_ms))
        self.pipe_stats["dispatches"] += 1
        self.pipe_stats["deepest"] = max(self.pipe_stats["deepest"], len(self.pipe_inflight))

    def pipe_fetch_oldest(self, encoder_only: bool = False) -> Dict:
        """Fetch the oldest chunk in flight and fold it into the mirror: its
        encoder frames and CTC ids, and (unless ``encoder_only``: a fallback
        replays the chunk's policy on the host) its hypothesis. Returns the
        decisions as ``fused_policy`` does, with ``decision_ms``,
        ``no_room`` and, where it emitted, the units, durations and tail."""
        rec = self.pipe_inflight.pop(0)
        got, waited = self.e.pipe_fetch(rec)
        self.pipe_stats["fetches"] += 1
        self.pipe_stats["waited_fetches"] += waited > 0
        self.pipe_stats["wait_s"] += waited
        self.enc_len += rec["block_enc"]
        self.asr_ids.extend(got["asr_ids"].tolist())
        self.st_ids.extend(got["st_ids"].tolist())
        out = {name: bool(got[name]) for name in ("do_decode", "do_emit", "ok",
                                                    "budget_over", "hit_eos", "grew",
                                                    "no_room")}
        out.update(keep=got["keep"], asr_count=got["asr_count"],
                   st_count=got["st_count"], count=got["count"],
                   decision_ms=rec["decision_ms"], encoder_only=encoder_only)
        if encoder_only:
            return out
        if out["do_decode"]:
            self.mt_tokens = got["mt_buf"][:out["keep"]].tolist()
        if out["do_emit"]:
            out["units"] = got["units"][:out["count"]].tolist()
            out["dur"] = got["dur"][:out["count"]]
            out["tail"] = got["tail"][:got["cur_len"]]
        return out

    def mirror_cross_valid(self) -> Optional[np.ndarray]:
        """[1, max_enc_frames] bool: the frames a host decode may attend while
        the device encoder is ahead of the mirror (a fallback or a replay
        with chunks in flight): the mirror's ``enc_len``, what the
        synchronous path saw at this chunk. None when they agree."""
        if self.enc_len_dispatched <= self.enc_len:
            return None
        return self.e.enc_frames_valid(self.enc_len)[None]

    def ctc_hypotheses(self):
        """Collapsed (tokens, frame indices) of the ASR and ST CTC heads
        (blank = 0, `agent/ctc_decoder.py:67-89`)."""
        return {"asr": ctc_collapse(np.asarray(self.asr_ids), blank=0),
                "st": ctc_collapse(np.asarray(self.st_ids), blank=0)}

    # ------------------------------------------------------------------
    # MT decoding
    # ------------------------------------------------------------------

    @torch.no_grad()
    def mt_decode(self, max_new_tokens: int, max_len: int = 200) -> List[int]:
        """Greedy continue-from-prefix: up to ``max_new_tokens`` tokens, or to
        EOS when it is negative (`session.py:1366-1421`), in scan calls of at
        most ``max_decode_per_call`` steps, one host read each. At entry and
        exit the caches hold [eos] + tokens[:-1]; the feed that predicted EOS
        is rolled back. Each call replays the engine's decode graph on a card
        (``StreamSpeechEngine.mt_decode_greedy``); while the device encoder is
        ahead of the mirror (the overlapped loop's fallbacks) the
        cross-attention reads the mirror's frames (``mirror_cross_valid``).
        Returns the hypothesis."""
        max_len = min(max_len, self.e.max_mt_tokens - 2, self.e.mt_buckets[-1] - 2)
        budget = max_new_tokens if max_new_tokens >= 0 else max_len
        budget = min(budget, max_len - len(self.mt_tokens))
        cross_valid = self.mirror_cross_valid()
        while budget > 0:
            (toks,), hit_eos = self.e.mt_decode_greedy(
                self.mt_self, self.mt_cross, [self.mt_tokens],
                [min(budget, self.e.max_decode_per_call)], cross_valid, session=self)
            self.mt_tokens.extend(toks)
            budget -= len(toks)
            if hit_eos[0] or not toks:
                break
        return list(self.mt_tokens)

    def mt_truncate(self, keep: int):
        """Whole-word rollback: keep the first ``keep`` hypothesis tokens; the
        caches' valid length follows the hypothesis (`agent.py:554-574`)."""
        self.mt_tokens = self.mt_tokens[:max(0, keep)]

    # ------------------------------------------------------------------
    # unit synthesis + vocoder
    # ------------------------------------------------------------------

    def _padded_tokens(self):
        tokens = [EOS] + self.mt_tokens
        s = _bucket(min(len(tokens), self.e.mt_buckets[-1]), self.e.mt_buckets)
        padded = torch.full((1, s), PAD, dtype=torch.long)
        padded[0, : len(tokens)] = torch.tensor(tokens)
        up = self.e.model.cfg.unit_decoder.ctc_upsample_rate
        u_bucket = _bucket(min(len(tokens) * up, self.e.unit_buckets[-1]),
                           self.e.unit_buckets)
        return padded.to(self.e.device), len(tokens), u_bucket

    @torch.no_grad()
    def synthesize_units(self) -> List[int]:
        """Full-prefix NAR unit generation; returns collapsed unit dict-ids."""
        padded, n, _ = self._padded_tokens()
        ids, _ = self.e.model.synthesize_units(
            padded, self.enc_buf, torch.tensor([self.enc_len], device=self.e.device))
        up = self.e.model.cfg.unit_decoder.ctc_upsample_rate
        units, _ = ctc_collapse(ids[0, : n * up].cpu().numpy(),
                                blank=self.e.unit_blank, pad=PAD)
        return [u for u in units if u not in (0, EOS)]

    def emit(self) -> Tuple[List[int], np.ndarray, np.ndarray]:
        """Full-prefix emission. Returns (unit dict-ids, wav, durations)."""
        if self.e.vocoder is None:
            raise RuntimeError("no vocoder configured")
        padded, n, u_bucket = self._padded_tokens()
        units, count, wav, n_samples, dur = self.e.emit(
            padded, self.enc_buf, self.enc_len, n,
            u_bucket * self.e.max_dur_per_unit)
        count = int(count)
        return (units[:count].tolist(), wav[: int(n_samples)].cpu().numpy(),
                dur[:count].cpu().numpy())

    def emit_tail(self, n_prev_units: int
                  ) -> Tuple[List[int], np.ndarray, np.ndarray]:
        """Emission returning only the NEW wav tail; falls back to ``emit`` when
        the window or tail cap is exceeded (`session.py:1477-1511`). Returns
        (all unit dict-ids, new wav tail, per-unit durations)."""
        if self.e.vocoder is None:
            raise RuntimeError("no vocoder configured")
        padded, n, u_bucket = self._padded_tokens()
        units, count, dur, tail, cur_len, ok = self.e.emit_tail(
            padded, self.enc_buf, self.enc_len, n, n_prev_units, u_bucket)
        if not bool(ok):
            unit_ids, wav, dur_np = self.emit()
            new = len(unit_ids) - n_prev_units
            if new <= 0:
                return unit_ids, wav[:0], dur_np
            cur = int(dur_np[-new:].sum()) * SAMPLES_PER_FRAME
            return unit_ids, wav[len(wav) - cur:], dur_np
        count = int(count)
        return (units[:count].tolist(), tail[: int(cur_len)].cpu().numpy(),
                dur[:count].cpu().numpy())

    @torch.no_grad()
    def vocode(self, unit_codes: List[int]) -> Tuple[np.ndarray, np.ndarray]:
        """unit_codes: raw vocoder codes (0-based). Returns (wav, durations)."""
        if self.e.vocoder is None:
            raise RuntimeError("no vocoder configured")
        u = _bucket(max(len(unit_codes), 1), self.e.unit_buckets)
        codes = torch.zeros((1, u), dtype=torch.long)
        codes[0, : len(unit_codes)] = torch.tensor(unit_codes, dtype=torch.long)
        dur_mask = torch.zeros((1, u), dtype=torch.long)
        dur_mask[0, : len(unit_codes)] = 1
        codes, dur_mask = codes.to(self.e.device), dur_mask.to(self.e.device)
        dur = self.e.vocoder.predict_durations(codes) * dur_mask
        wav, n_samples, dur = self.e.vocoder(codes, dur,
                                             u * self.e.max_dur_per_unit)
        return (wav[0, : int(n_samples[0])].cpu().numpy(),
                dur[0, : len(unit_codes)].cpu().numpy())
