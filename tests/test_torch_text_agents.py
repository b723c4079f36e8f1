"""The port's text-output streaming agents and their batched evaluators
against the JAX package's, on ``tests/torch_serving_stack.py``'s doctored tiny
weights (shared through ``weights.load_flax_variables``) and three short
``chip_smoke._babble`` utterances, none a whole number of 320 ms segments.

- ``StreamSpeechS2TTAgent`` (stride 2, lag 1), ``StreamSpeechASRAgent``,
  ``WaitkS2TTAgent`` and ``WaitkS2STAgent`` write the same segments at the
  same delays as JAX's agents (the wait-k S2ST wav within 1e-4, its units
  exactly), each through its sequential ``SentenceLevelEvaluator``.
- ``BatchedS2TTEvaluator`` (host tick and fused tick) and
  ``BatchedASREvaluator`` in waves of 2 give every instance the delays and
  text of the port's sequential agent, and every latency score but the
  wall-clock _CA twins.
- JAX's batched S2TT and ASR host ticks are held to the port's on every
  instance where they agree with JAX's own sequential agents. Where they do
  not, they are at fault: they decide a finished stream from the frames
  before its tail, still pending behind the lockstep clock; the port waits
  for the tail, as the sequential agent does. The ASR departure is pinned:
  it shows on this data.
- ``make_self_asr_fn`` transcribes as JAX's.
"""

import numpy as np
import pytest
from chip_smoke import _babble
from streamspeech_tpu.agents.streamspeech import StreamSpeechAgentConfig as JaxAgentConfig
from streamspeech_tpu.agents.streamspeech import StreamSpeechASRAgent as JaxASRAgent
from streamspeech_tpu.agents.streamspeech import StreamSpeechS2TTAgent as JaxS2TTAgent
from streamspeech_tpu.agents.waitk import WaitkS2STAgent as JaxWaitkS2ST
from streamspeech_tpu.agents.waitk import WaitkS2TTAgent as JaxWaitkS2TT
from streamspeech_tpu.eval import quality as jax_quality
from streamspeech_tpu.eval.batched_evaluator import BatchedASREvaluator as JaxBatchedASR
from streamspeech_tpu.eval.batched_evaluator import BatchedS2TTEvaluator as JaxBatchedS2TT
from streamspeech_tpu.eval.evaluator import SentenceLevelEvaluator as JaxEvaluator
from tests.jax_init import shared_jax_init  # noqa: F401
from tests.torch_serving_stack import build_stack
from tests.torch_threads import one_torch_thread  # noqa: F401

from streamspeech_tpu_torch.agents.streamspeech import (
    StreamSpeechAgentConfig,
    StreamSpeechASRAgent,
    StreamSpeechS2TTAgent,
)
from streamspeech_tpu_torch.agents.waitk import WaitkS2STAgent, WaitkS2TTAgent
from streamspeech_tpu_torch.eval import quality
from streamspeech_tpu_torch.eval.batched_evaluator import (
    BatchedASREvaluator,
    BatchedS2TTEvaluator,
)
from streamspeech_tpu_torch.eval.evaluator import SentenceLevelEvaluator
from streamspeech_tpu_torch.registry import AGENTS

SECONDS = (0.95, 1.65, 0.7)
S2TT_CFG = dict(lagging_k1=1, stride_n=2)


@pytest.fixture(scope="module")
def stack():
    return build_stack()


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.RandomState(3)
    return [list(_babble(rng, s)) for s in SECONDS], ["w1 w2", "w3", "w4 w5 w6"]


def _make(kind, stack):
    """(JAX agent, port agent) of ``kind`` on the shared weights."""
    (jtext, junits), (ptext, punits) = stack["jdicts"], stack["pdicts"]
    je, pe = stack["jax"], stack["port"]
    if kind == "s2tt":
        return (JaxS2TTAgent(je, JaxAgentConfig(**S2TT_CFG), jtext, jtext),
                StreamSpeechS2TTAgent(pe, StreamSpeechAgentConfig(**S2TT_CFG), ptext, ptext))
    if kind == "asr":
        return (JaxASRAgent(je, JaxAgentConfig(), jtext),
                StreamSpeechASRAgent(pe, StreamSpeechAgentConfig(), ptext))
    if kind == "waitk_s2tt":
        return (JaxWaitkS2TT(je, JaxAgentConfig(), jtext, jtext, waitk=2),
                WaitkS2TTAgent(pe, StreamSpeechAgentConfig(), ptext, ptext, waitk=2))
    return (JaxWaitkS2ST(je, JaxAgentConfig(), jtext, jtext, junits, waitk=2),
            WaitkS2STAgent(pe, StreamSpeechAgentConfig(), ptext, ptext, punits, waitk=2))


def _sequential(agent, evaluator_cls, corpus):
    """The instances of ``agent``'s sequential run, with its units a
    speech instance."""
    ev = evaluator_cls(agent, source_segment_size=320, quality_metrics=[])
    units = {}
    for i, (src, ref) in enumerate(zip(*corpus)):
        ins = ev._make_instance(i, src, ref, 16000)
        ev.run_instance(ins)
        ev.instances[i] = ins
        units[i] = list(getattr(agent, "units", []))
    return ev, units


def _text(ins):
    return (list(ins.delays), ins.prediction)


def _same_scores(got, want):
    for name, v in want.items():
        if name.endswith("_CA"):
            continue        # the wall clock
        w = got[name]
        assert (v != v and w != w) or abs(v - w) <= 1e-6 * max(1.0, abs(v)), name


@pytest.mark.parametrize("kind", ["s2tt", "asr", "waitk_s2tt", "waitk_s2st"])
def test_agents_match_jax(stack, corpus, kind):
    jagent, pagent = _make(kind, stack)
    jev, junits = _sequential(jagent, JaxEvaluator, corpus)
    pev, punits = _sequential(pagent, SentenceLevelEvaluator, corpus)
    wrote = 0
    for i, want in jev.instances.items():
        got = pev.instances[i]
        assert list(got.delays) == list(want.delays), (kind, i)
        if kind == "waitk_s2st":
            assert punits[i] == junits[i], i
            np.testing.assert_allclose(got.stitched, want.stitched, atol=1e-4)
            wrote += len(punits[i])
        else:
            assert got.prediction == want.prediction, (kind, i)
            wrote += len(got.prediction.split())
    assert wrote > 0
    _same_scores(pev.scores(), jev.scores())


def test_agents_registered_under_jax_names():
    from streamspeech_tpu.registry import AGENTS as JAX_AGENTS

    for name in ("streamspeech_s2st", "streamspeech_s2tt", "streamspeech_asr",
                 "waitk_s2tt", "waitk_s2st"):
        assert AGENTS.get(name).__name__ == JAX_AGENTS.get(name).__name__


def _batched_port(stack, kind, use_fused, corpus):
    ptext, _ = stack["pdicts"]
    if kind == "s2tt":
        ev = BatchedS2TTEvaluator(stack["port"], StreamSpeechAgentConfig(**S2TT_CFG), ptext,
                                  ptext, batch=2, use_fused=use_fused, quality_metrics=[])
    else:
        ev = BatchedASREvaluator(stack["port"], StreamSpeechAgentConfig(), ptext, ptext,
                                 batch=2, quality_metrics=[])
    return ev, ev(*corpus)


@pytest.fixture(scope="module")
def port_sequential(stack, corpus):
    out = {}
    for kind in ("s2tt", "asr"):
        _, pagent = _make(kind, stack)
        ev, _ = _sequential(pagent, SentenceLevelEvaluator, corpus)
        out[kind] = (ev, ev.scores())
    return out


@pytest.mark.parametrize("kind,use_fused", [("s2tt", True), ("s2tt", False),
                                            ("asr", False)])
def test_batched_equals_sequential(stack, corpus, port_sequential, kind, use_fused):
    ev, scores = _batched_port(stack, kind, use_fused, corpus)
    seq, seq_scores = port_sequential[kind]
    for i, want in seq.instances.items():
        assert _text(ev.instances[i]) == _text(want), (kind, use_fused, i)
    _same_scores(scores, seq_scores)
    if kind == "s2tt":
        assert ev.use_fused == use_fused


def test_jax_batched_text_ticks_depart_only_at_a_pending_tail(stack, corpus):
    """JAX's batched S2TT and ASR host ticks equal the port's wherever they
    equal JAX's sequential agents; ASR departs on this data, at a finish whose
    tail was still pending (the port's equals the sequential agent there)."""
    jtext, _ = stack["jdicts"]
    je = stack["jax"]
    departed = {}
    for kind, jev in [("s2tt", JaxBatchedS2TT(je, JaxAgentConfig(**S2TT_CFG), jtext, jtext,
                                              batch=2, use_fused=False,
                                              quality_metrics=[], output_dir=None)),
                      ("asr", JaxBatchedASR(je, JaxAgentConfig(), jtext, jtext, batch=2,
                                            quality_metrics=[]))]:
        jev(*corpus)
        jseq, _ = _sequential(_make(kind, stack)[0], JaxEvaluator, corpus)
        pev, _ = _batched_port(stack, kind, False, corpus)
        departed[kind] = []
        for i, seq in jseq.instances.items():
            assert _text(pev.instances[i]) == _text(seq), (kind, i)
            if _text(jev.instances[i]) == _text(seq):
                assert _text(jev.instances[i]) == _text(pev.instances[i]), (kind, i)
            else:
                departed[kind].append(i)
                # the departure is the last write, at the source's end
                assert jev.instances[i].delays[-1] == seq.delays[-1] == \
                    seq.source_length, (kind, i)
    assert departed["asr"], "JAX's batched ASR tick no longer departs on this data"


def test_make_self_asr_fn_matches_jax(stack, corpus):
    (jtext, _), (ptext, _) = stack["jdicts"], stack["pdicts"]
    # 320 ms segments: the chunking the other tests compiled JAX's programs for
    port_fn = quality.make_self_asr_fn(stack["port"], ptext, segment_size_ms=320)
    jax_fn = jax_quality.make_self_asr_fn(stack["jax"], jtext, segment_size_ms=320)
    texts = [port_fn(np.asarray(src, np.float32)) for src in corpus[0][:2]]
    assert texts == [jax_fn(np.asarray(src, np.float32)) for src in corpus[0][:2]]
    assert any(texts)
