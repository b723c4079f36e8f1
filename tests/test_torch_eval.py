"""The port's evaluation harness without a model: ``eval/instance.py``,
``eval/latency.py`` and ``eval/evaluator.py`` against the JAX package's on
seeded synthetic delays, source lengths and speech segments.

Both sides receive the same segments; the wall-clock timestamps (``elapsed``)
are then set to the same seeded values on both, so that the computation-aware
(_CA) twins are compared too. Every score must agree within 1e-9 of itself.
"""

import numpy as np
import pytest

from streamspeech_tpu.agents.base import EmptySegment as JaxEmptySegment
from streamspeech_tpu.agents.base import ReadAction as JaxRead
from streamspeech_tpu.agents.base import SpeechSegment as JaxSpeechSegment
from streamspeech_tpu.agents.base import SpeechToSpeechAgent as JaxS2SAgent
from streamspeech_tpu.agents.base import TextSegment as JaxTextSegment
from streamspeech_tpu.agents.base import WriteAction as JaxWrite
from streamspeech_tpu.eval import instance as jax_instance
from streamspeech_tpu.eval.evaluator import DEFAULT_LATENCY, SPEECH_ONLY
from streamspeech_tpu.eval.evaluator import SentenceLevelEvaluator as JaxEvaluator
from streamspeech_tpu.eval.latency import build_scorers as jax_build_scorers

from streamspeech_tpu_torch.agents.base import EmptySegment, ReadAction, SpeechSegment
from streamspeech_tpu_torch.agents.base import SpeechToSpeechAgent, TextSegment, WriteAction
from streamspeech_tpu_torch.eval import instance as port_instance
from streamspeech_tpu_torch.eval.evaluator import SentenceLevelEvaluator
from streamspeech_tpu_torch.eval.latency import build_scorers
from streamspeech_tpu_torch.registry import LATENCY_SCORERS

ALL_LATENCY = DEFAULT_LATENCY + SPEECH_ONLY
SEG_MS = 320


def _close(a, b):
    if a != a or b != b:       # nan
        return a != a and b != b
    return abs(a - b) <= 1e-9 * max(1.0, abs(a))


def _feed(ins, segments, sample_rate=16000):
    """Send the whole source in 320 ms steps and, after step n, hand the
    instance segments[n] (None: an empty segment)."""
    kinds = []
    for n, seg in enumerate(segments):
        src = ins.send_source(SEG_MS)
        kinds.append((type(src).__name__, src.finished, len(src.content or [])))
        ins.receive_prediction(seg)
    return kinds


def _speech_segments(rng, n_steps, seg_type, empty_type):
    """A seeded write schedule: per step an empty segment or a speech segment
    of 0-9600 samples; the last one finished."""
    out = []
    for n in range(n_steps):
        fin = n == n_steps - 1
        if rng.rand() < 0.5 and not fin:
            out.append(empty_type(finished=False))
        else:
            k = int(rng.randint(0, 9600))
            out.append(seg_type(content=list(rng.uniform(-0.5, 0.5, k)),
                                sample_rate=16000, finished=fin))
    return out


def _text_segments(rng, n_steps, seg_type, empty_type):
    out = []
    for n in range(n_steps):
        fin = n == n_steps - 1
        if rng.rand() < 0.4 and not fin:
            out.append(empty_type(finished=False))
        else:
            words = " ".join(f"▁w{int(i)}" for i in rng.randint(0, 50, rng.randint(1, 4)))
            out.append(seg_type(content=words, finished=fin))
    return out


def _pair(kind, seed, tmp_path):
    """The same instance built in both packages from one seeded schedule."""
    rng = np.random.RandomState(seed)
    n_samples = int(rng.randint(3000, 60000))
    source = list(rng.uniform(-0.3, 0.3, n_samples))
    n_steps = -(-n_samples // (16 * SEG_MS)) + int(rng.randint(0, 3))
    reference = " ".join(["w"] * int(rng.randint(1, 12)))
    made = {}
    for side, mod, seg_t, empty_t, text_t in (
            ("jax", jax_instance, JaxSpeechSegment, JaxEmptySegment, JaxTextSegment),
            ("port", port_instance, SpeechSegment, EmptySegment, TextSegment)):
        r = np.random.RandomState(seed + 1000)
        if kind == "speech":
            ins = mod.SpeechOutputInstance(7, source, reference,
                                           output_dir=str(tmp_path / side))
            segs = _speech_segments(r, n_steps, seg_t, empty_t)
        else:
            ins = mod.TextOutputInstance(7, source, reference)
            segs = _text_segments(r, n_steps, text_t, empty_t)
        kinds = _feed(ins, segs)
        # the same computation-aware timestamps on both sides
        ins.elapsed = [d + 37.5 * (i + 1) for i, d in enumerate(ins.delays)]
        made[side] = (ins, kinds)
    return made


@pytest.mark.parametrize("kind", ["speech", "text"])
@pytest.mark.parametrize("seed", range(6))
def test_instances_and_latency_scores_match_jax(kind, seed, tmp_path):
    made = _pair(kind, seed, tmp_path)
    (jins, jkinds), (pins, pkinds) = made["jax"], made["port"]
    assert pkinds == jkinds
    js, ps = jins.summarize(), pins.summarize()
    assert set(ps) == set(js)
    for key in js:
        if key == "prediction" and kind == "speech":
            continue        # each side's own wav path
        assert ps[key] == js[key], key
    if kind == "speech":
        np.testing.assert_array_equal(pins.stitched, jins.stitched)
        assert pins.silences == jins.silences
        with open(js["prediction"], "rb") as a, open(ps["prediction"], "rb") as b:
            assert a.read() == b.read()
    names = ALL_LATENCY if kind == "speech" else DEFAULT_LATENCY
    jsc, psc = jax_build_scorers(names), build_scorers(names)
    assert set(psc) == set(jsc)
    for name in jsc:
        a, b = jsc[name]({0: jins}), psc[name]({0: pins})
        assert _close(b, a), (name, b, a)


def test_registry_holds_every_default_scorer():
    assert set(ALL_LATENCY) <= set(LATENCY_SCORERS.names())
    with pytest.raises(KeyError):
        LATENCY_SCORERS.get("BLEU")


@pytest.mark.parametrize("seed", [3, 4])
def test_write_wav_matches_jax(seed, tmp_path):
    x = np.random.RandomState(seed).uniform(-1.3, 1.3, 4001).astype(np.float32)
    jax_instance.write_wav(tmp_path / "j.wav", x, 16000)
    port_instance.write_wav(tmp_path / "p.wav", x, 16000)
    assert (tmp_path / "j.wav").read_bytes() == (tmp_path / "p.wav").read_bytes()


def _scripted(base, read_t, write_t, seg_t):
    """A speech-to-speech agent that writes on a fixed schedule: at its n-th
    policy call a segment of schedule[n] samples (0: READ)."""

    class Scripted(base):
        def __init__(self, schedule):
            self.schedule = schedule
            super().__init__()

        def reset(self):
            super().reset()
            self.calls = 0

        def policy(self):
            n = self.calls
            self.calls += 1
            fin = self.states.source_finished
            k = self.schedule[n % len(self.schedule)]
            if k == 0 and not fin:
                return read_t()
            content = list(np.sin(np.arange(k) * 0.01 * (n + 1)) * 0.2)
            if fin:
                self.states.target_finished = True
            return write_t(seg_t(content=content, sample_rate=16000, finished=fin),
                           finished=fin)
    return Scripted


def test_sentence_level_evaluator_matches_jax_and_resumes(tmp_path):
    rng = np.random.RandomState(9)
    sources = [list(rng.uniform(-0.3, 0.3, n)) for n in (9000, 16000, 23000)]
    refs = ["a b c", "a b", "a b c d e"]
    schedule = [0, 0, 4800, 0, 6400, 3200]
    jagent = _scripted(JaxS2SAgent, JaxRead, JaxWrite, JaxSpeechSegment)(schedule)
    pagent = _scripted(SpeechToSpeechAgent, ReadAction, WriteAction, SpeechSegment)(schedule)
    jev = JaxEvaluator(jagent, quality_metrics=[], output_dir=str(tmp_path / "jax"))
    pev = SentenceLevelEvaluator(pagent, quality_metrics=[],
                                 output_dir=str(tmp_path / "port"))
    jsc, psc = jev(sources, refs), pev(sources, refs)
    assert set(psc) == set(jsc)
    for i in jev.instances:
        js, ps = jev.instances[i].summarize(), pev.instances[i].summarize()
        for key in ("delays", "durations", "intervals", "prediction_offset",
                    "prediction_length", "source_length"):
            assert ps[key] == js[key], (i, key)
    for name in jsc:
        if name.endswith("_CA") or name == "RTF":
            continue        # wall clock
        assert _close(psc[name], jsc[name]), name
    log = tmp_path / "port" / "instances.log"
    assert len(log.read_text().splitlines()) == 3
    # resume: the logged indices are skipped, nothing is appended
    again = SentenceLevelEvaluator(pagent, quality_metrics=[],
                                   output_dir=str(tmp_path / "port"))
    again(sources, refs, continue_unfinished=True)
    assert len(log.read_text().splitlines()) == 3
    # and the log alone scores as the run did
    rescored = SentenceLevelEvaluator(pagent, quality_metrics=[],
                                      output_dir=str(tmp_path / "port")).score_only()
    for name in ("AL", "LAAL", "AP", "DAL", "EndOffset", "DiscontinuitySum"):
        assert _close(rescored[name], psc[name]), name


@pytest.mark.parametrize("names", [None, ["BLEU"], ["WER", "ASR_BLEU"]])
def test_quality_scorers_not_ported_raise_by_name(names):
    agent = _scripted(SpeechToSpeechAgent, ReadAction, WriteAction, SpeechSegment)([0])
    with pytest.raises(ValueError, match="ASR_BLEU" if names is None else names[0]):
        SentenceLevelEvaluator(agent, quality_metrics=names)
