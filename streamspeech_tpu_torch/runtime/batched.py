"""B streaming sessions in lockstep, sharing every model call
(``streamspeech_tpu/runtime/batched.py``).

One ``encode_block`` call a tick advances every stream (the batch axis); one
scanned greedy MT decode takes a budget and a decode position a stream (the MT
self caches write each row at its own length, ``models/layers.StreamKVCache``,
and the hypotheses here hold those lengths); the emissions of all streams go
through the NAR unit decoder, the CTC collapse and the vocoder together (``StreamSpeechEngine.emit_tail_batched``). What differs
between streams, the hypothesis lengths and each stream's true encoder length
once it has finished, is held in per-stream lengths and validity masks, so each
stream's outputs equal those of a ``StreamingSession`` that serves it alone.

Lockstep contract: the streams advance on one block clock. At each tick every
unfinished stream must hold a full block of pending fbank frames; a stream that
finishes inside a block contributes its zero-padded tail with its own valid
length (the encoder masks the padding as attention keys and as conv taps,
``conformer.encode_block``), and after that empty blocks whose outputs are
thrown away.

Host reads: one a block (the CTC ids of the new frames), one a decode call
(tokens, emitted, hit_eos of every stream), one an emission. ``fused_tick``
runs a whole tick of every stream through the engine's fused tick
(``StreamSpeechEngine.policy_step_batched``: CUDA graphs on a card), with a
read after each of its parts that runs. JAX's ``_shard_over_mesh`` is not
ported (ROADMAP §A item 10).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from streamspeech_tpu_torch.models.vocoder import SAMPLES_PER_FRAME
from streamspeech_tpu_torch.ops.ctc import ctc_collapse
from streamspeech_tpu_torch.runtime.session import (
    EOS,
    PAD,
    StreamSpeechEngine,
    _bucket,
    host_to_device,
)


class BatchedStreamingSession:
    """B lockstep streaming sessions on one engine. The engine decides the
    device (the card unless it was made with ``device="cpu"``)."""

    def __init__(self, engine: StreamSpeechEngine, batch: int):
        self.e = engine
        self.batch = batch
        (self.enc_state, self.enc_buf, self.mt_self,
         self.mt_cross) = engine.session_init(batch)
        self.enc_len = np.zeros((batch,), np.int64)   # true frames a stream
        self.asr_ids: List[List[int]] = [[] for _ in range(batch)]
        self.st_ids: List[List[int]] = [[] for _ in range(batch)]
        self.mt_tokens: List[List[int]] = [[] for _ in range(batch)]
        self.feat_dim = engine.model.cfg.encoder.input_feat_per_channel
        self.pending = [np.zeros((0, self.feat_dim), np.float32) for _ in range(batch)]
        self.finished_input = np.zeros((batch,), bool)

    # ------------------------------------------------------------------
    # encoder side (lockstep block clock)
    # ------------------------------------------------------------------

    def push_features(self, stream: int, feats: np.ndarray,
                      finished: bool = False) -> None:
        """Buffer new (already CMVN'd) fbank frames of one stream; call
        ``encode_ready_blocks`` once every stream of the tick is fed."""
        if self.finished_input[stream]:
            raise ValueError(f"stream {stream} has already finished")
        self.pending[stream] = np.concatenate([self.pending[stream], feats], axis=0)
        if finished:
            self.finished_input[stream] = True

    def encode_ready_blocks(self, chunk_size: int, conv_chunk_size: int) -> int:
        """Encode lockstep blocks while every unfinished stream has a full
        block buffered (a finished stream gives its valid-masked tail, then
        empty blocks). Returns the number of blocks encoded."""
        block_frames = 4 * math.lcm(max(chunk_size, 1), max(conv_chunk_size, 1))
        ran = 0
        while True:
            have = np.asarray([p.shape[0] for p in self.pending])
            ready = (have >= block_frames) | self.finished_input
            # a tick needs every stream ready and one real frame at least
            if not ready.all() or not (have > 0).any():
                break
            blocks = np.zeros((self.batch, block_frames, self.feat_dim), np.float32)
            valid = np.zeros((self.batch,), np.int64)
            for i in range(self.batch):
                n = min(int(have[i]), block_frames)
                blocks[i, :n] = self.pending[i][:n]
                self.pending[i] = self.pending[i][n:]
                valid[i] = n
            self._run_block(blocks, valid, chunk_size, conv_chunk_size)
            ran += 1
        return ran

    @torch.no_grad()
    def _run_block(self, blocks: np.ndarray, valid: np.ndarray, chunk: int,
                   conv_chunk: int) -> None:
        dev = self.e.device
        x = torch.from_numpy(blocks).to(dev)
        enc, self.enc_state, asr_ids, st_ids = self.e.model.encode_block_with_ctc(
            x, self.enc_state, chunk, conv_chunk, host_to_device(valid, dev))
        s = enc.shape[1]
        pos = self.enc_state.pos  # the encoder's KV append raised if pos > capacity
        self.enc_buf[:, pos - s:pos] = enc
        self.mt_cross = self.e.model.mt_fill_cross(enc, self.mt_cross)
        out_valid = -(-valid // 4)    # real encoder frames a stream
        ids = torch.stack([asr_ids, st_ids]).cpu().numpy()
        for i in range(self.batch):
            n = int(out_valid[i])
            self.asr_ids[i].extend(ids[0, i, :n].tolist())
            self.st_ids[i].extend(ids[1, i, :n].tolist())
            self.enc_len[i] += n

    def fused_tick(self, chunk: int, conv_chunk: int, k1: int, n: int,
                   whole_word: bool, max_len: int, starts_word, src_len, tgt_len,
                   n_prev_units, active, finished,
                   with_emission: bool = True) -> Optional[List[Dict]]:
        """One lockstep policy tick of every stream through the engine's fused
        tick (`batched.py:169-309`). Feed the frames with ``push_features``
        first. Returns None where it does not apply, and the caller then runs
        the host path (``encode_ready_blocks``, ``mt_decode``, ``emit_tail``):
        an active unfinished stream holds other than one whole block, no
        active stream holds a frame, or the MT or encoder caches lack room.
        Else one dict a stream: the decisions, ``keep``, the CTC counts,
        ``prev_tokens``, ``tail_ready`` (its whole tail is encoded by this
        tick) and, where it emitted, ``units``, ``dur`` and ``tail``.

        The bundle is read in one copy a part that runs; JAX's two-fetch
        strategy for large waves (``split_fetch_bytes``, :257-284) paced a
        remote link's round trips and has no counterpart on a local card."""
        e = self.e
        block_enc = math.lcm(max(chunk, 1), max(conv_chunk, 1))
        block_frames = 4 * block_enc
        steps = e.fused_steps
        active = np.asarray(active, bool)
        have = np.asarray([p.shape[0] for p in self.pending])
        unfinished = ~self.finished_input
        if (active & unfinished & ((have // block_frames) != 1)).any():
            return None
        if not (active & (have > 0)).any():
            return None
        lens = np.asarray([len(t) for t in self.mt_tokens], np.int64)
        if (lens[active] + steps).max(initial=0) > e.max_mt_tokens:
            return None
        if self.enc_state.pos + block_enc > e.max_enc_frames:
            return None

        blocks = np.zeros((self.batch, block_frames, self.feat_dim), np.float32)
        valid = np.zeros((self.batch,), np.int64)
        # a finished stream's finish decode starts once its whole tail is
        # encoded: this tick takes its last pending frames
        tail_ready = self.finished_input & (have <= block_frames)
        for i in range(self.batch):
            if not active[i]:
                self.pending[i] = self.pending[i][:0]
                continue
            nfr = min(int(have[i]), block_frames)
            blocks[i, :nfr] = self.pending[i][:nfr]
            self.pending[i] = self.pending[i][nfr:]
            valid[i] = nfr

        max_len = min(max_len, e.max_mt_tokens - 2, e.mt_buckets[-1] - 2)
        mt_cap = _bucket(min(int(lens.max(initial=0)) + steps + 2, e.mt_buckets[-1]),
                         e.mt_buckets)
        u_cap = _bucket(min(mt_cap * e.model.cfg.unit_decoder.ctc_upsample_rate,
                            e.unit_buckets[-1]), e.unit_buckets)
        counts = [[len(ctc_collapse(np.asarray(ids), blank=0)[0]) for ids in heads]
                  for heads in (self.asr_ids, self.st_ids)]
        lasts = [[ids[-1] if ids else -1 for ids in heads]
                 for heads in (self.asr_ids, self.st_ids)]
        got = e.policy_step_batched(
            self, blocks, valid, self.enc_len, self.mt_tokens, src_len, tgt_len,
            counts[0], counts[1], lasts[0], lasts[1], n_prev_units, starts_word,
            active, finished, tail_ready, chunk, conv_chunk, whole_word, k1, n,
            max_len, mt_cap, u_cap, with_emission)

        out: List[Dict] = []
        out_valid = -(-valid // 4)
        names = ("do_decode", "do_emit", "ok", "budget_over", "hit_eos", "grew")
        for i in range(self.batch):
            ov = int(out_valid[i])
            self.asr_ids[i].extend(got["asr_ids"][i, :ov].tolist())
            self.st_ids[i].extend(got["st_ids"][i, :ov].tolist())
            self.enc_len[i] += ov
            r = dict(zip(names, map(bool, got["flags"][i])))
            r.update(keep=int(got["keep"][i]), asr_count=int(got["asr_count"][i]),
                     st_count=int(got["st_count"][i]), count=int(got["count"][i]),
                     prev_tokens=int(lens[i]), tail_ready=bool(tail_ready[i]))
            if r["do_decode"]:
                self.mt_tokens[i] = got["mt_buf"][i, :r["keep"]].tolist()
            if r["do_emit"]:
                r["units"] = got["units"][i, :r["count"]].tolist()
                r["dur"] = got["dur"][i, :r["count"]]
                r["tail"] = got["tail"][i, :int(got["cur_len"][i])]
            out.append(r)
        return out

    def ctc_hypotheses(self, stream: int) -> Dict[str, Tuple[List[int], List[int]]]:
        """Collapsed (tokens, frame indices) of one stream's ASR and ST CTC
        heads (blank = 0)."""
        return {"asr": ctc_collapse(np.asarray(self.asr_ids[stream]), blank=0),
                "st": ctc_collapse(np.asarray(self.st_ids[stream]), blank=0)}

    # ------------------------------------------------------------------
    # MT decoding: budgets and positions a stream, one scan call a round
    # ------------------------------------------------------------------

    @torch.no_grad()
    def mt_decode(self, budgets, max_len: int = 200) -> List[List[int]]:
        """Greedy continue-from-prefix for every stream at once. budgets [B]:
        0 holds a stream, < 0 decodes it to EOS. Each call of the scan runs
        the largest budget's steps, ``max_decode_per_call`` at most; a
        stopped or held stream's steps land past its valid length and are
        overwritten by its next call. Returns the hypotheses."""
        e = self.e
        max_len = min(max_len, e.max_mt_tokens - 2, e.mt_buckets[-1] - 2)
        lens = np.asarray([len(t) for t in self.mt_tokens], np.int64)
        budgets = np.asarray(budgets, np.int64)
        budgets = np.where(budgets < 0, max_len, budgets)
        # EOS is not sticky across calls: as the single session, the next call
        # predicts again against the (perhaps grown) encoder context
        budgets = np.clip(budgets, 0, max_len - lens)
        cross_valid = np.arange(e.max_enc_frames)[None] < np.asarray(self.enc_len)[:, None]
        while (budgets > 0).any():
            new, hit_eos = e.mt_decode_greedy(
                self.mt_self, self.mt_cross, self.mt_tokens,
                np.minimum(budgets, e.max_decode_per_call), cross_valid, session=self)
            for hyp, toks in zip(self.mt_tokens, new):
                hyp.extend(toks)
            emitted = np.asarray([len(t) for t in new], np.int64)
            budgets = np.where(hit_eos | (emitted == 0), 0, budgets - emitted)
        return [list(t) for t in self.mt_tokens]

    def mt_truncate(self, stream: int, keep: int) -> None:
        """Whole-word rollback of ONE stream (`agent.py:554-574`); its caches'
        valid length follows its hypothesis, the other streams' stay."""
        self.mt_tokens[stream] = self.mt_tokens[stream][:max(0, keep)]

    # ------------------------------------------------------------------
    # emission (batched NAR synthesis → CTC collapse → vocoder)
    # ------------------------------------------------------------------

    def _prev_tokens(self):
        """[B, S] decoder input (EOS + hypothesis, PAD after), the token counts
        and the unit bucket of the longest stream."""
        e = self.e
        lens = [len(t) + 1 for t in self.mt_tokens]
        s = _bucket(min(max(lens), e.mt_buckets[-1]), e.mt_buckets)
        prev = np.full((self.batch, s), PAD, np.int64)
        for i, t in enumerate(self.mt_tokens):
            prev[i, 0] = EOS
            prev[i, 1: len(t) + 1] = t
        u_bucket = _bucket(min(max(lens) * e.model.cfg.unit_decoder.ctc_upsample_rate,
                               e.unit_buckets[-1]), e.unit_buckets)
        return host_to_device(prev, e.device), np.asarray(lens, np.int64), u_bucket

    def emit(self) -> List[Tuple[List[int], np.ndarray, np.ndarray]]:
        """One emission for every stream: (unit dict-ids, wav, per-unit
        durations) a stream."""
        if self.e.vocoder is None:
            raise RuntimeError("no vocoder configured")
        prev, lens, u_bucket = self._prev_tokens()
        units, count, wav, n_samples, dur = self.e.emit_batched(
            prev, self.enc_buf, self.enc_len, lens, u_bucket * self.e.max_dur_per_unit)
        units, count, wav, n_samples, dur = (a.cpu().numpy() for a in (
            units, count, wav, n_samples, dur))
        return [(units[i, : count[i]].tolist(), wav[i, : n_samples[i]],
                 dur[i, : count[i]]) for i in range(self.batch)]

    def emit_tail(self, n_prev_units) -> List[Tuple[List[int], np.ndarray, np.ndarray]]:
        """Tail emission for every stream: (all unit dict-ids, NEW wav tail,
        durations) a stream, from the windowed vocoder; a stream whose window
        or tail cap overflows takes the full ``emit`` (`batched.py:410-421`)."""
        if self.e.vocoder is None:
            raise RuntimeError("no vocoder configured")
        prev, lens, u_bucket = self._prev_tokens()
        out = self.e.emit_tail_batched(prev, self.enc_buf, self.enc_len, lens,
                                       n_prev_units, u_bucket)
        units, count, dur, tail, cur_len, ok = (a.cpu().numpy() for a in out)
        full = None
        result = []
        for i in range(self.batch):
            c = int(count[i])
            if not ok[i]:
                if full is None:
                    full = self.emit()
                u, wav, d = full[i]
                new = len(u) - int(n_prev_units[i])
                cur = int(d[-new:].sum()) * SAMPLES_PER_FRAME if new > 0 else 0
                result.append((u, wav[len(wav) - cur:] if cur else wav[:0], d))
                continue
            result.append((units[i, :c].tolist(), tail[i, : cur_len[i]], dur[i, :c]))
        return result
