"""Simultaneous speech-to-speech agent over the port's engine, the host path of
``streamspeech_tpu/agents/streamspeech.py`` (reference
`agent/speech_to_speech.streamspeech.agent.py:422-770`).

READ/WRITE follows the growth of the deduplicated ASR and ST CTC hypotheses;
the allowed MT length is ((tgt_ctc_len − k1)//n)·n; whole-word truncation rolls
the KV caches back; each write carries only the new waveform tail
(dur[−len(new units):].sum() × 320 samples). The agent is not registered in
any registry: the JAX package owns the name "streamspeech_s2st".
"""

from __future__ import annotations

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


class StreamSpeechS2STAgent(_StreamSpeechAgentBase, SpeechToSpeechAgent):
    """Flagship simultaneous speech-to-speech agent (synchronous host policy)."""

    def __init__(self, engine, cfg, src_dict, tgt_dict, unit_dict, gcmvn=None):
        _StreamSpeechAgentBase.__init__(self, engine, cfg, src_dict, tgt_dict, gcmvn)
        self.unit_dict = unit_dict
        self.unit_blank = unit_dict.blank()
        SpeechToSpeechAgent.__init__(self)

    def reset(self):
        super().reset()
        self.reset_stream()
        self.units: List[int] = []
        self.unfinished_wav: Optional[np.ndarray] = None
        self.asr_text = ""
        self.st_text = ""

    def _final_write(self):
        self.states.target_finished = True
        content = (self.unfinished_wav.tolist()
                   if self.unfinished_wav is not None else [])
        return WriteAction(SpeechSegment(content=content, sample_rate=SAMPLE_RATE,
                                         finished=True), finished=True)

    def policy(self):
        finished = self.states.source_finished
        if self.ingest(self.states) == 0:
            return self._final_write() if finished else ReadAction()
        return self._host_policy(finished)

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
                                         sample_rate=SAMPLE_RATE, finished=finished),
                           finished=target_finished)
