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
``emit_tail_batched``), which the single stream runs at B = 1. The JAX engine's fused single-round-trip programs
(``policy_step``, ``policy_step_pipelined``, ``policy_step_batched``,
``StreamingSession.fused_policy`` and ``pipe_*``) are not ported yet: they
are queued as the next serving item (ROADMAP §A item 6).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

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
        self.unit_blank = model.cfg.unit_decoder.vocab_size - 1

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
                         cross_valid: Optional[torch.Tensor] = None):
        """One call of the scanned greedy MT decode for B streams
        (`session.py:1366-1421`, `batched.py:318-360`). hyps [B]: each
        stream's hypothesis, whose length is its self caches' valid length
        (they hold the feeds [EOS] + hyp[:-1]; the newest token is unfed);
        budgets [B] on the host, at most ``max_decode_per_call``. The room is
        checked on the host; the inputs go up in one copy and the results
        come back in one. Returns (new tokens a stream, hit_eos [B])."""
        lens = np.asarray([len(t) for t in hyps], np.int64)
        budgets = np.asarray(budgets, np.int64)
        steps = int(budgets.max())
        if int(lens.max()) + steps > mt_self[0].capacity:
            raise ValueError(f"KV cache overflow: {int(lens.max())} + {steps} > "
                             f"capacity {mt_self[0].capacity}")
        first = [t[-1] if t else EOS for t in hyps]
        first, offset, budget = host_to_device(np.stack([first, lens, budgets]),
                                               self.device)
        toks, emitted, hit_eos = self.model.mt_decode_greedy(
            first, offset, budget, mt_self, mt_cross, steps, cross_valid)
        read = torch.cat([toks, emitted[:, None], hit_eos[:, None].long()],
                         dim=1).cpu().numpy()
        return ([read[i, : read[i, steps]].tolist() for i in range(len(hyps))],
                read[:, steps + 1] > 0)

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
        or tail cap is exceeded; the caller then takes the full emission."""
        units, count, codes = self._collapsed_units(
            mt_tokens, enc_buf, *self._lengths(enc_len, n_tokens), unit_capacity)
        n_prev = host_to_device(np.atleast_1d(n_prev_units), self.device)
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
        self.mt_cross = self.e.model.mt_fill_cross(enc, self.mt_cross)
        self.asr_ids.extend(asr_ids[0].tolist())
        self.st_ids.extend(st_ids[0].tolist())
        return s

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
        is rolled back. Returns the hypothesis."""
        max_len = min(max_len, self.e.max_mt_tokens - 2, self.e.mt_buckets[-1] - 2)
        budget = max_new_tokens if max_new_tokens >= 0 else max_len
        budget = min(budget, max_len - len(self.mt_tokens))
        while budget > 0:
            (toks,), hit_eos = self.e.mt_decode_greedy(
                self.mt_self, self.mt_cross, [self.mt_tokens],
                [min(budget, self.e.max_decode_per_call)])
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
