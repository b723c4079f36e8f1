"""The paper's wait-k baselines over the port's engine
(``streamspeech_tpu/agents/waitk.py``; reference
`agent/speech_to_speech.wait-k-stride-n.agent.py:101,358` and
`agent/speech_to_text.wait-k-stride-n.agent.py`): in place of the CTC-driven
policy, READ until k source chunks have arrived, then WRITE stride_n target
tokens a newly read chunk. The model path (encoder → MT decoder → T2U → units
→ vocoder) is the StreamSpeech agents'; only the READ/WRITE rule differs."""

from __future__ import annotations

from typing import List

from streamspeech_tpu_torch.agents.base import (
    ReadAction,
    SpeechSegment,
    SpeechToSpeechAgent,
    SpeechToTextAgent,
    TextSegment,
    WriteAction,
)
from streamspeech_tpu_torch.agents.streamspeech import (
    SAMPLE_RATE,
    StreamSpeechAgentConfig,
    _StreamSpeechAgentBase,
    spm_text,
    text_diff,
)
from streamspeech_tpu_torch.models.vocoder import SAMPLES_PER_FRAME
from streamspeech_tpu_torch.registry import AGENTS


class _WaitkBase(_StreamSpeechAgentBase):
    def _budget(self):
        """After ingesting this chunk: None for READ, else the MT budget (-1 at
        the finish: decode to EOS; at a finish with no encoder frame the
        caller writes its empty final segment)."""
        finished = self.states.source_finished
        self.ingest(self.states)
        self.chunks_read += 1
        if not finished and self.chunks_read < self.waitk:
            return None
        if self.session.enc_len == 0:
            return -1 if finished else None
        allowed = (self.chunks_read - self.waitk + 1) * self.cfg.stride_n
        budget = -1 if finished else allowed - len(self.session.mt_tokens)
        return None if budget == 0 and not finished else budget


@AGENTS.register("waitk_s2tt")
class WaitkS2TTAgent(_WaitkBase, SpeechToTextAgent):
    """After k chunks, stride_n tokens a newly read chunk (JAX `waitk.py:32`)."""

    def __init__(self, engine, cfg: StreamSpeechAgentConfig, src_dict, tgt_dict,
                 gcmvn=None, waitk: int = 3):
        _StreamSpeechAgentBase.__init__(self, engine, cfg, src_dict, tgt_dict, gcmvn)
        self.waitk = waitk
        SpeechToTextAgent.__init__(self)

    def reset(self):
        super().reset()
        self.reset_stream()
        self.chunks_read = 0
        self.emitted_text = ""

    def policy(self):
        finished = self.states.source_finished
        budget = self._budget()
        if budget is None:
            return ReadAction()
        if self.session.enc_len == 0:       # the source ended with no frame
            self.states.target_finished = True
            return WriteAction(TextSegment(content="", finished=True), finished=True)
        prev = list(self.session.mt_tokens)
        self.session.mt_decode(budget, max_len=self.cfg.max_len)
        if self.session.mt_tokens == prev and not finished:
            return ReadAction()
        full = spm_text(self.tgt_dict, self.session.mt_tokens)
        new = text_diff(full, self.emitted_text)
        self.emitted_text = full
        if not new and not finished:
            return ReadAction()
        if finished:
            self.states.target_finished = True
        return WriteAction(TextSegment(content=new, finished=finished), finished=finished)


@AGENTS.register("waitk_s2st")
class WaitkS2STAgent(_WaitkBase, SpeechToSpeechAgent):
    """The wait-k rule over the S2ST path (JAX `waitk.py:82`): each write
    vocodes the whole prefix and carries the new units' samples."""

    def __init__(self, engine, cfg: StreamSpeechAgentConfig, src_dict, tgt_dict,
                 unit_dict, gcmvn=None, waitk: int = 3):
        _StreamSpeechAgentBase.__init__(self, engine, cfg, src_dict, tgt_dict, gcmvn)
        self.unit_dict = unit_dict
        self.unit_blank = unit_dict.blank()
        self.waitk = waitk
        SpeechToSpeechAgent.__init__(self)

    def reset(self):
        super().reset()
        self.reset_stream()
        self.chunks_read = 0
        self.units: List[int] = []

    def _final(self):
        self.states.target_finished = True
        return WriteAction(SpeechSegment(content=[], sample_rate=SAMPLE_RATE,
                                         finished=True), finished=True)

    def policy(self):
        finished = self.states.source_finished
        budget = self._budget()
        if budget is None:
            return ReadAction()
        if self.session.enc_len == 0:
            return self._final()
        prev = list(self.session.mt_tokens)
        self.session.mt_decode(budget, max_len=self.cfg.max_len)
        if self.session.mt_tokens == prev and not finished:
            return ReadAction()
        units, wav, dur = self.session.emit()
        cur = units[len(self.units):]
        if not cur:
            return self._final() if finished else ReadAction()
        cur_len = int(dur[-len(cur):].sum()) * SAMPLES_PER_FRAME
        new_wav = wav[len(wav) - cur_len:] if cur_len else wav[:0]
        self.units = units
        if finished:
            self.states.target_finished = True
        return WriteAction(SpeechSegment(content=new_wav.tolist(), sample_rate=SAMPLE_RATE,
                                         finished=finished), finished=finished)
