"""Simultaneous speech-to-speech agent over the port's engine, the host path of
``streamspeech_tpu/agents/streamspeech.py`` (reference
`agent/speech_to_speech.streamspeech.agent.py:422-770`).

READ/WRITE follows the growth of the deduplicated ASR and ST CTC hypotheses;
the allowed MT length is ((tgt_ctc_len − k1)//n)·n; whole-word truncation rolls
the KV caches back; each write carries only the new waveform tail
(dur[−len(new units):].sum() × 320 samples). The agent is not registered in
any registry: the JAX package owns the name "streamspeech_s2st".

With ``use_fused`` it takes the engine's fused tick, as the JAX agent does
whenever its engine has one (`agents/streamspeech.py:126-181`): a streaming
chunk of one whole block runs encode, gates, decode, rollback and emission on
the device (``StreamingSession.fused_policy``), and the host path takes the
chunks it does not apply to, the finish, a budget above the fused scan and an
emission window that overflows. Both paths give the same actions; the host
path, the reference form, is the default.

With ``StreamSpeechAgentConfig.pipelined`` it takes the overlapped loop (JAX
`agents/streamspeech.py:190-363`): each streaming chunk is dispatched to the
device, whose policy counters live there, and the host fetches the chunks'
bundles a few calls later, turning them into queued actions that carry the
source position of their decision (``SpeechSegment.decision_ms``), so the
delays are the synchronous path's. A budget above the fused scan, a tail
window that overflows and a hypothesis without the MT caches' room send the
chunk to the host path and replay the chunks in flight behind it there.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from streamspeech_tpu_torch.agents.base import (
    ReadAction,
    SpeechSegment,
    SpeechToSpeechAgent,
    WriteAction,
)
from streamspeech_tpu_torch.ops.cmvn import GlobalCMVN
from streamspeech_tpu_torch.ops.fbank import OnlineFbank
from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine

SAMPLE_RATE = 16000


@dataclass
class StreamSpeechAgentConfig:
    source_segment_size: int = 320   # ms
    lagging_k1: int = 0
    lagging_k2: int = 0
    stride_n: int = 1
    stride_n2: int = 1
    max_len: int = 200
    whole_word: bool = False         # the reference enables it for >= 640 ms chunks
    dur_prediction: bool = True
    # the overlapped loop: dispatch chunk N + 1 before reading chunk N's
    # bundle (``runtime/session.py`` ``policy_step_pipelined``); the same
    # writes at the same stream positions as the synchronous path, observed
    # a few calls later
    pipelined: bool = False
    pipe_max_lag: int = 8            # chunks in flight before a forced fetch
    pipe_ready_s: float = 0.05       # age at which a chunk's copy has landed

    @property
    def chunk_size(self) -> int:
        """Attention chunk = segment//40 (`agent.py:395`)."""
        return max(self.source_segment_size // 40, 1)

    @property
    def conv_chunk_size(self) -> int:
        """Conv chunk forced to 16 if chunk >= 16 else 8 (`agent.py:404-413`)."""
        return 16 if self.chunk_size >= 16 else 8


def spm_text(dictionary, ids: List[int]) -> str:
    return dictionary.string(ids, spm_to_text=True)


class _StreamSpeechAgentBase:
    """Source side: incremental fbank + gcmvn + block encoding."""

    def __init__(self, engine: StreamSpeechEngine, cfg: StreamSpeechAgentConfig,
                 src_dict, tgt_dict, gcmvn: Optional[GlobalCMVN] = None):
        self.engine = engine
        self.cfg = cfg
        self.src_dict = src_dict
        self.tgt_dict = tgt_dict
        self.gcmvn = gcmvn
        self.fbank = OnlineFbank()

    def reset_stream(self):
        self.fbank.reset()
        self.session = self.engine.new_session()
        self.consumed_samples = 0
        self.src_ctc_prefix_length = 0
        self.tgt_ctc_prefix_length = 0

    def _extract_feats(self, states) -> np.ndarray:
        """New raw samples → incremental fbank → gcmvn."""
        new = states.source[self.consumed_samples:]
        self.consumed_samples = len(states.source)
        feats = (self.fbank.push(np.asarray(new, np.float32)) if len(new)
                 else np.zeros((0, 80), np.float32))
        if self.gcmvn is not None and feats.shape[0]:
            feats = np.asarray(self.gcmvn(feats), np.float32)
        return feats

    def ingest(self, states) -> int:
        """Push new raw samples through fbank → gcmvn → encoder blocks. Returns
        the encoder frames so far."""
        self.session.push_features(self._extract_feats(states), self.cfg.chunk_size,
                                   self.cfg.conv_chunk_size,
                                   finished=states.source_finished)
        return self.session.enc_len


def starts_word_table(engine: StreamSpeechEngine, tgt_dict) -> np.ndarray:
    """[V] bool: which MT tokens start a word ("▁"), the table of the fused
    tick's whole-word rollback (`agents/streamspeech.py:126-135`)."""
    vocab = engine.model.cfg.mt_decoder.vocab_size
    table = np.zeros((vocab,), bool)
    for i in range(min(len(tgt_dict), vocab)):
        table[i] = tgt_dict[i].startswith("▁")
    return table


class StreamSpeechS2STAgent(_StreamSpeechAgentBase, SpeechToSpeechAgent):
    """Flagship simultaneous speech-to-speech agent. ``use_fused`` sends its
    streaming chunks through the engine's fused tick (an engine without a
    vocoder cannot take it); off, every chunk takes the host policy."""

    def __init__(self, engine, cfg, src_dict, tgt_dict, unit_dict, gcmvn=None,
                 use_fused: bool = False):
        _StreamSpeechAgentBase.__init__(self, engine, cfg, src_dict, tgt_dict, gcmvn)
        self.unit_dict = unit_dict
        self.unit_blank = unit_dict.blank()
        self.use_fused = use_fused and engine.vocoder is not None
        self._starts_word = starts_word_table(engine, tgt_dict)
        SpeechToSpeechAgent.__init__(self)

    def reset(self):
        super().reset()
        self.reset_stream()
        self.units: List[int] = []
        self.unfinished_wav: Optional[np.ndarray] = None
        self.asr_text = ""
        self.st_text = ""
        self._action_queue: List[WriteAction] = []
        self._decision_ms: Optional[float] = None

    def _final_write(self):
        self.states.target_finished = True
        content = (self.unfinished_wav.tolist()
                   if self.unfinished_wav is not None else [])
        return WriteAction(SpeechSegment(content=content, sample_rate=SAMPLE_RATE,
                                         finished=True), finished=True)

    def policy(self):
        cfg = self.cfg
        if cfg.pipelined and self.engine.vocoder is not None:
            return self._pipelined_policy()
        finished = self.states.source_finished
        if self.use_fused and not finished:
            feats = self._extract_feats(self.states)
            out = self.session.fused_policy(
                feats, cfg.chunk_size, cfg.conv_chunk_size, cfg.lagging_k1,
                cfg.stride_n, cfg.whole_word, cfg.max_len, self._starts_word,
                self.src_ctc_prefix_length, self.tgt_ctc_prefix_length,
                len(self.units))
            if out is not None:
                return self._fused_action(out)
            # not applicable this chunk: the pending frames go the host way
            self.session.push_features(np.zeros((0, feats.shape[1]), np.float32),
                                       cfg.chunk_size, cfg.conv_chunk_size)
            if self.session.enc_len == 0:
                return ReadAction()
            return self._host_policy(finished)
        if self.ingest(self.states) == 0:
            return self._final_write() if finished else ReadAction()
        return self._host_policy(finished)

    # ------------------------------------------------------------------
    # the overlapped loop (JAX `agents/streamspeech.py:190-363`)
    # ------------------------------------------------------------------

    def _pipelined_policy(self):
        """One call of the overlapped loop: dispatch the pending block, or
        drain and take the host path where the chunk does not apply (the
        finish, not one whole block, no room), then fold the bundles the
        fetch rule lands into queued actions; the oldest queued one, else
        READ."""
        cfg, ses = self.cfg, self.session
        finished = self.states.source_finished
        feats = self._extract_feats(self.states)
        ses.pending_feats = np.concatenate([ses.pending_feats, feats], axis=0)
        block_enc = math.lcm(max(cfg.chunk_size, 1), max(cfg.conv_chunk_size, 1))
        n_blocks = ses.pending_feats.shape[0] // (4 * block_enc)
        empty = np.zeros((0, feats.shape[1]), np.float32)
        if finished:
            self._pipe_drain()
            if self._action_queue:
                return self._action_queue.pop(0)
            ses.push_features(empty, cfg.chunk_size, cfg.conv_chunk_size, finished=True)
            if ses.enc_len == 0:
                return self._final_write()
            return self._host_policy(True)
        if n_blocks == 1 and ses.pipe_applicable(n_blocks, block_enc):
            if ses.pipe_state is None:
                ses.pipe_set_counters(self.src_ctc_prefix_length,
                                      self.tgt_ctc_prefix_length, len(self.units))
                ses.pipe_resync()
            block = ses.pending_feats[:4 * block_enc]
            ses.pending_feats = ses.pending_feats[4 * block_enc:]
            ses.pipe_dispatch(block, cfg.chunk_size, cfg.conv_chunk_size, cfg.lagging_k1,
                              cfg.stride_n, cfg.whole_word, cfg.max_len, self._starts_word,
                              len(self.states.source) / 16.0, block_enc)
        elif n_blocks > 0:
            # not one whole block, or no room: drain, then the host path
            self._pipe_drain()
            ses.push_features(empty, cfg.chunk_size, cfg.conv_chunk_size)
            if ses.enc_len > 0:
                self._host_chunk(len(self.states.source) / 16.0)
        while (out := self._pipe_poll()) is not None:
            self._process_pipe_out(out)
        if self._action_queue:
            return self._action_queue.pop(0)
        return ReadAction()

    def _pipe_poll(self):
        """The oldest chunk's bundle, fetched where more than
        ``pipe_max_lag`` chunks are in flight or it is ``pipe_ready_s`` old;
        else None (JAX's fetch rule, so the actions come in JAX's order)."""
        inflight = self.session.pipe_inflight
        if inflight and (len(inflight) > self.cfg.pipe_max_lag
                         or time.perf_counter() - inflight[0]["t"] >= self.cfg.pipe_ready_s):
            return self.session.pipe_fetch_oldest()
        return None

    def _pipe_drain(self):
        """Every chunk in flight, fetched in order, into actions."""
        while self.session.pipe_inflight:
            self._process_pipe_out(self.session.pipe_fetch_oldest())
        self.session.pipe_state = None

    def _queue(self, action) -> None:
        if isinstance(action, WriteAction):
            self._action_queue.append(action)

    def _host_chunk(self, decision_ms: float) -> None:
        """The host policy of the chunk the mirror has just taken in, its
        write queued with its decision position."""
        self._decision_ms = decision_ms
        self._queue(self._host_policy(False))
        self._decision_ms = None

    def _pipe_replay_rest(self) -> None:
        """The chunks still in flight, replayed through the host policy: an
        earlier fallback made their device decisions stale; their encoder
        frames and CTC ids stand (JAX :336-343)."""
        ses = self.session
        while ses.pipe_inflight:
            self._host_chunk(ses.pipe_fetch_oldest(encoder_only=True)["decision_ms"])
        ses.pipe_state = None

    def _process_pipe_out(self, out, host_emit: bool = False):
        """One fetched bundle into the mirror's counters and a queued action,
        the lagged twin of ``_fused_action`` (JAX :279-313). The fallbacks
        take this chunk on the host and replay the chunks in flight behind
        it: a hypothesis without the caches' room (the synchronous tick
        would not have applied), a budget above the fused scan (the decode
        was skipped), a tail window that overflowed (the emission). With
        ``host_emit`` (after a window fallback, the device's later emissions
        read a stale unit count) the emission is the host's."""
        cfg = self.cfg
        if out["no_room"]:
            self._host_chunk(out["decision_ms"])
            self._pipe_replay_rest()
            return
        hyps = self.session.ctc_hypotheses()
        self.asr_text = spm_text(self.src_dict, hyps["asr"][0])
        self.st_text = spm_text(self.tgt_dict, hyps["st"][0])
        if out["grew"]:
            self.src_ctc_prefix_length = max(out["asr_count"], self.src_ctc_prefix_length)
            self.tgt_ctc_prefix_length = max(out["st_count"], self.tgt_ctc_prefix_length)
        if out["grew"] and out["budget_over"] and not out["do_decode"]:
            subword = ((out["st_count"] - cfg.lagging_k1) // cfg.stride_n) * cfg.stride_n
            if cfg.whole_word:
                subword += 1
            new_subword = subword - len(self.session.mt_tokens)
            # JAX prunes the self caches to the mirror here; the port's need
            # nothing: each decode's offset, the mirror's length, is their valid length
            if new_subword >= 1:
                self._decision_ms = out["decision_ms"]
                self._queue(self._decode_and_emit(False, new_subword))
                self._decision_ms = None
            self._pipe_replay_rest()
            return
        if not out["do_decode"] or not out["do_emit"]:
            return
        if host_emit or not out["ok"]:
            self._queue(self._emit_from_host(out["decision_ms"]))
            if not host_emit:
                self._pipe_emit_rest()
            return
        self._queue(self._write_units(out["units"], np.asarray(out["tail"]),
                                      out["decision_ms"]))

    def _pipe_emit_rest(self) -> None:
        """After a window fallback: the chunks in flight keep their device
        decodes, their emissions taken on the host (JAX :346-363)."""
        ses = self.session
        while ses.pipe_inflight:
            self._process_pipe_out(ses.pipe_fetch_oldest(), host_emit=True)
        ses.pipe_state = None

    def _fused_action(self, out):
        """The action of a fused tick's bundle (`agents/streamspeech.py:
        380-425`): the decisions were made on the device; here the
        bookkeeping, the host continuation where the budget was above the
        fused scan, and the host emission where the tail window overflowed."""
        cfg = self.cfg
        hyps = self.session.ctc_hypotheses()
        self.asr_text = spm_text(self.src_dict, hyps["asr"][0])
        self.st_text = spm_text(self.tgt_dict, hyps["st"][0])
        if out["grew"]:
            self.src_ctc_prefix_length = max(out["asr_count"],
                                             self.src_ctc_prefix_length)
            self.tgt_ctc_prefix_length = max(out["st_count"],
                                             self.tgt_ctc_prefix_length)
        if not out["do_decode"]:
            if out["grew"] and out["budget_over"]:
                # the host decode for this chunk; the device caches are as before
                subword = ((out["st_count"] - cfg.lagging_k1)
                           // cfg.stride_n) * cfg.stride_n
                if cfg.whole_word:
                    subword += 1
                new_subword = subword - len(self.session.mt_tokens)
                if new_subword < 1:
                    return ReadAction()
                return self._decode_and_emit(False, new_subword)
            return ReadAction()
        if not out["do_emit"]:
            # a rollback to nothing, or the same or a shorter prefix: READ
            return ReadAction()
        if not out["ok"]:
            return self._emit_from_host() or ReadAction()
        return self._write_units(out["units"], np.asarray(out["tail"])) or ReadAction()

    def _emit_from_host(self, decision_ms: Optional[float] = None):
        """The host emission of the current prefix (`agents/streamspeech.py:
        365-378`), which takes the full emission where the tail window
        overflows; the write of its new units, or None."""
        units, new_wav, _ = self.session.emit_tail(len(self.units))
        return self._write_units(units, new_wav, decision_ms)

    def _write_units(self, units, new_wav, decision_ms: Optional[float] = None):
        """A streaming write of ``units`` and their new wav (decided at
        ``decision_ms``, None: now), or None where they add no unit."""
        if len(units) == 0 or len(units) <= len(self.units):
            return None
        if self.unfinished_wav is not None and len(self.unfinished_wav) > 0:
            new_wav = np.concatenate([self.unfinished_wav, new_wav])
            self.unfinished_wav = None
        self.units = list(units)
        return WriteAction(SpeechSegment(content=np.asarray(new_wav).tolist(),
                                         sample_rate=SAMPLE_RATE, finished=False,
                                         decision_ms=decision_ms), finished=False)

    def _host_policy(self, finished):
        cfg = self.cfg
        hyps = self.session.ctc_hypotheses()
        asr_tokens, _ = hyps["asr"]
        st_tokens, _ = hyps["st"]
        self.asr_text = spm_text(self.src_dict, asr_tokens)
        self.st_text = spm_text(self.tgt_dict, st_tokens)

        if not finished:
            # READ while the dedup'd CTC hypotheses have not grown by stride_n
            if (len(asr_tokens) < self.src_ctc_prefix_length + cfg.stride_n or
                    len(st_tokens) < self.tgt_ctc_prefix_length + cfg.stride_n):
                return ReadAction()
            self.src_ctc_prefix_length = max(len(asr_tokens),
                                             self.src_ctc_prefix_length)
            self.tgt_ctc_prefix_length = max(len(st_tokens),
                                             self.tgt_ctc_prefix_length)
            subword_tokens = ((len(st_tokens) - cfg.lagging_k1)
                              // cfg.stride_n) * cfg.stride_n
            if cfg.whole_word:
                subword_tokens += 1
            new_subword_tokens = subword_tokens - len(self.session.mt_tokens)
            if new_subword_tokens < 1:
                return ReadAction()
        else:
            new_subword_tokens = -1
        return self._decode_and_emit(finished, new_subword_tokens)

    def _decode_and_emit(self, finished, new_subword_tokens):
        cfg = self.cfg
        prev_tokens = list(self.session.mt_tokens)
        self.session.mt_decode(new_subword_tokens, max_len=cfg.max_len)

        if cfg.whole_word and not finished:
            toks = self.session.mt_tokens
            j = 0
            for j in range(len(toks) - 1, -1, -1):
                if self.tgt_dict[toks[j]].startswith("▁"):
                    break
            self.session.mt_truncate(j)
            if j == 0:
                return ReadAction()

        if self.session.mt_tokens == prev_tokens or (
                not finished and len(self.session.mt_tokens) <= len(prev_tokens)):
            return self._final_write() if finished else ReadAction()

        units, new_wav, _ = self.session.emit_tail(len(self.units))
        if len(units) == 0 or len(units) <= len(self.units):
            return self._final_write() if finished else ReadAction()
        if self.unfinished_wav is not None and len(self.unfinished_wav) > 0:
            new_wav = np.concatenate([self.unfinished_wav, new_wav])
            self.unfinished_wav = None
        self.units = units

        target_finished = finished and new_subword_tokens == -1
        if target_finished:
            self.states.target_finished = True
        return WriteAction(SpeechSegment(content=new_wav.tolist(),
                                         sample_rate=SAMPLE_RATE, finished=finished,
                                         decision_ms=self._decision_ms),
                           finished=target_finished)
