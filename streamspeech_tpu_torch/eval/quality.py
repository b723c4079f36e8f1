"""Quality scorers, registered by name in ``QUALITY_SCORERS``: BLEU, ASR-BLEU
for speech output and WER (``streamspeech_tpu/eval/quality.py``; reference
`SimulEval/simuleval/evaluator/scorers/quality_scorer.py:50-209`).

BLEU is ``eval/bleu.py``'s copy of sacrebleu's corpus BLEU. ASR-BLEU
transcribes each instance's stitched wav with a pluggable ASR backend, a
callable (wav, sample_rate) → text, and scores the transcripts; without one
it reports NaN, as JAX does (the reference downloads wav2vec2 models, and
nothing here may be fetched). ``make_self_asr_fn`` builds a backend from the
port's own streaming ASR agent. WER runs its edit distances through the native
library of ``native/edit_dist.cpp`` (fairseq's libnat equivalent).

The Whisper scorer (JAX ``WhisperASRBLEUScorer``, ``make_whisper_asr_fn``,
`quality.py:91-128`) is not ported: it needs Whisper weights on disk, which
cannot be fetched here, and the transformers package, which the card machine
does not have. Naming ``WHISPER_ASR_BLEU`` raises and says so.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from streamspeech_tpu_torch import native
from streamspeech_tpu_torch.eval.bleu import corpus_bleu
from streamspeech_tpu_torch.registry import QUALITY_SCORERS


@QUALITY_SCORERS.register("BLEU")
class SacreBLEUScorer:
    """Corpus BLEU of the predictions against the references (13a, exp)."""

    def __call__(self, instances: Dict[int, object]) -> float:
        hyps = [str(ins.prediction) for ins in instances.values()]
        refs = [[ins.reference or "" for ins in instances.values()]]
        return corpus_bleu(hyps, refs)


def remove_simuleval_silence(wav):
    """Strip the zero runs SimulEval's stitching puts at delay gaps before
    transcription, the rm_silence ASR-BLEU variant (`asr_bleu_rm_silence/
    utils.py:232-243`) exactly: a zero sample is dropped iff it starts or ends
    a run of >= 10 zeros, where the runs wrap around the ends (``np.roll``, as
    the reference's ``torch.roll``)."""
    w = np.asarray(wav)
    if w.size == 0:
        return w
    z = w == 0
    left = z.copy()
    right = z.copy()
    for i in range(10):
        left &= np.roll(w, -i) == 0
        right &= np.roll(w, i) == 0
    return w[~(z & (left | right))]


@QUALITY_SCORERS.register("ASR_BLEU")
class ASRBLEUScorer:
    """Transcribe the emitted wavs with ``asr_fn``, then corpus BLEU of the
    lowercased transcripts against the lowercased references
    (`quality_scorer.py:128-179`). The stitching's silences are stripped
    first (JAX's default ``remove_silence``), the variant that scores
    simultaneous (discontinuous) speech output. NaN without ``asr_fn``."""

    def __init__(self, asr_fn: Optional[Callable] = None):
        self.asr_fn = asr_fn

    def transcripts(self, instances) -> List[str]:
        out = []
        for ins in instances.values():
            wav = getattr(ins, "stitched", None)
            if wav is None or self.asr_fn is None:
                out.append("")
                continue
            out.append(self.asr_fn(remove_simuleval_silence(wav),
                                   getattr(ins, "target_sample_rate", 16000)))
        return out

    def __call__(self, instances) -> float:
        if self.asr_fn is None:
            return float("nan")
        hyps = [t.lower() for t in self.transcripts(instances)]
        refs = [[(ins.reference or "").lower() for ins in instances.values()]]
        return corpus_bleu(hyps, refs)


@QUALITY_SCORERS.register("WHISPER_ASR_BLEU")
class WhisperASRBLEUScorer:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "WHISPER_ASR_BLEU is not ported: it needs Whisper weights on disk, "
            "which cannot be fetched here, and the transformers package; score "
            "speech output with ASR_BLEU and an asr_fn (make_self_asr_fn)")


def make_self_asr_fn(engine, src_dict, segment_size_ms: int = 640) -> Callable:
    """An ASR backend for ``ASRBLEUScorer`` from the port's own streaming ASR
    agent over ``engine`` (self-transcription, `quality.py:130-162`): the wav
    in ``segment_size_ms`` segments, the text of every write joined by
    spaces."""
    from streamspeech_tpu_torch.agents.base import SpeechSegment
    from streamspeech_tpu_torch.agents.streamspeech import (
        StreamSpeechAgentConfig,
        StreamSpeechASRAgent,
    )

    agent = StreamSpeechASRAgent(
        engine, StreamSpeechAgentConfig(source_segment_size=segment_size_ms), src_dict)

    def asr_fn(wav, sample_rate=16000) -> str:
        agent.reset()
        samples = list(wav)
        seg = int(segment_size_ms * sample_rate / 1000)
        text = []
        for i in range(0, max(len(samples), 1), seg):
            out = agent.pushpop(SpeechSegment(content=samples[i:i + seg],
                                              sample_rate=sample_rate,
                                              finished=i + seg >= len(samples)))
            if not out.is_empty and out.content:
                text.append(out.content)
        return " ".join(text)

    return asr_fn


@QUALITY_SCORERS.register("WER")
class WERScorer:
    """Word error rate in percent: the summed edit distances of the
    predictions' words from the references' over the references' words."""

    def __call__(self, instances) -> float:
        pairs = [((ins.reference or "").split(), str(ins.prediction).split())
                 for ins in instances.values()]
        den = sum(len(r) for r, _ in pairs) or 1
        return 100.0 * sum(batched_edit_distance(pairs)) / den


def edit_distance_plain(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance of two token sequences, one DP row: the plain
    version of ``native/edit_dist.cpp``."""
    dp = list(range(len(b) + 1))
    for i in range(1, len(a) + 1):
        prev = dp[0]
        dp[0] = i
        for j in range(1, len(b) + 1):
            cur = dp[j]
            dp[j] = min(dp[j] + 1, dp[j - 1] + 1, prev + (a[i - 1] != b[j - 1]))
            prev = cur
    return dp[-1]


def batched_edit_distance(pairs: Sequence[Tuple[Sequence, Sequence]]) -> List[int]:
    """Levenshtein distances of (ref tokens, hyp tokens) pairs in one call of
    the native library (built at first use; a failed build raises). Tokens
    are interned to int64 ids first: the distance needs equality alone."""
    lib = native.load("edit_dist")
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.edit_distances.argtypes = [i64p, i64p, i64p, i64p, ctypes.c_int64, i64p]
    lib.edit_distances.restype = None
    vocab: dict = {}
    a_flat, b_flat, a_lens, b_lens = [], [], [], []
    for a, b in pairs:
        a_flat += [vocab.setdefault(t, len(vocab)) for t in a]
        b_flat += [vocab.setdefault(t, len(vocab)) for t in b]
        a_lens.append(len(a))
        b_lens.append(len(b))
    af = np.asarray(a_flat or [0], np.int64)
    bf = np.asarray(b_flat or [0], np.int64)
    al = np.asarray(a_lens, np.int64)
    bl = np.asarray(b_lens, np.int64)
    out = np.zeros(len(pairs), np.int64)
    lib.edit_distances(af.ctypes.data_as(i64p), al.ctypes.data_as(i64p),
                       bf.ctypes.data_as(i64p), bl.ctypes.data_as(i64p),
                       len(pairs), out.ctypes.data_as(i64p))
    return out.tolist()
