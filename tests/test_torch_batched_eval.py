"""The port's ``BatchedS2STEvaluator`` against the JAX package's evaluators
and against the port's own sequential ``SentenceLevelEvaluator`` over its S2ST
agent, on the same doctored tiny weights (``tests/torch_serving_stack.py``).

Five sources of 0.5-1.5 s in waves of 3 (two waves; no source a whole number
of 320 ms segments), then ``whole_word`` at 640 ms segments. The port's batched
run must give every instance the delays, the final MT tokens and units of the
sequential evaluators (the port's and JAX's, over their agents' host
policies), the stitched wav within 1e-4, and every latency score but the
wall-clock ones (RTF and the _CA twins) within 1e-6.

JAX's batched host tick (``BatchedS2STEvaluator(use_fused=False)``) is held to
the port's on every instance where it agrees with JAX's own sequential agent.
Where it does not, it is at fault, not the port: it decodes a finished stream
before that stream's tail has been encoded behind the lockstep clock, and it
emits again at a finish that added no token. The port's batched evaluator
keeps the sequential agent's order (ROADMAP §C); such instances are left out
of that one comparison.

Then the resume from ``instances.log``, and a bf16 engine's wave against the
same bf16 engine serving each source alone.
"""

import numpy as np
import pytest
import torch
from streamspeech_tpu.agents.streamspeech import StreamSpeechAgentConfig as JaxAgentConfig
from streamspeech_tpu.agents.streamspeech import StreamSpeechS2STAgent as JaxAgent
from streamspeech_tpu.eval.batched_evaluator import BatchedS2STEvaluator as JaxBatchedEval
from streamspeech_tpu.eval.evaluator import SentenceLevelEvaluator as JaxEvaluator
from tests.torch_serving_stack import build_stack
from tests.torch_threads import one_torch_thread  # noqa: F401

from streamspeech_tpu_torch.agents.streamspeech import (
    StreamSpeechAgentConfig,
    StreamSpeechS2STAgent,
)
from streamspeech_tpu_torch.eval.batched_evaluator import BatchedS2STEvaluator
from streamspeech_tpu_torch.eval.evaluator import SentenceLevelEvaluator

LENGTHS = [11200, 19200, 8000, 24000, 14000]


@pytest.fixture(scope="module")
def stack():
    return build_stack(port_dtype=torch.bfloat16)


def _sources(seed, lengths):
    rng = np.random.RandomState(seed)
    return [list(rng.uniform(-0.3, 0.3, n)) for n in lengths], ["dummy"] * len(lengths)


def _sequential(agent, evaluator_cls, sources, refs):
    """A sequential evaluator over ``agent``, one instance at a time, keeping
    each instance's final MT tokens and units."""
    ev = evaluator_cls(agent, source_segment_size=agent.cfg.source_segment_size,
                       quality_metrics=[])
    final = {}
    for i, (src, ref) in enumerate(zip(sources, refs)):
        ins = ev._make_instance(i, src, ref, 16000)
        ev.run_instance(ins)
        ev.instances[i] = ins
        final[i] = (list(agent.session.mt_tokens), list(agent.units))
    return ev, ev.scores(), final


def _port_sequential(engine, pdicts, agent_cfg, sources, refs):
    text, units = pdicts
    return _sequential(StreamSpeechS2STAgent(engine, agent_cfg, text, text, units),
                       SentenceLevelEvaluator, sources, refs)


def _close(a, b, tol=1e-6):
    if a != a or b != b:
        return a != a and b != b
    return abs(a - b) <= tol * max(1.0, abs(a))


def _differ(got, want, i, atol=1e-4):
    """Why instance i of two runs differs (None: it does not): delays, the
    durations and intervals of its writes, or its stitched wav."""
    g, w = got.instances[i], want.instances[i]
    gs, ws = g.summarize(), w.summarize()
    for key in ("delays", "durations", "intervals", "source_length"):
        if gs[key] != ws[key]:
            return key
    if not (g.finish_prediction and w.finish_prediction):
        return "unfinished"
    if (g.stitched is None) != (w.stitched is None):
        return "wav"
    if w.stitched is not None and (g.stitched.shape != w.stitched.shape or
                                   np.abs(g.stitched - w.stitched).max() > atol):
        return "wav"
    return None


def _same_instances(got, want, atol=1e-4):
    assert set(got.instances) == set(want.instances)
    for i in want.instances:
        assert _differ(got, want, i, atol) is None, i


def _same_scores(got, want):
    assert set(got) == set(want)
    for name in want:
        if name.endswith("_CA") or name == "RTF":
            continue        # the wall clock
        assert _close(got[name], want[name]), (name, got[name], want[name])


def _wrote(ev):
    return sum(len(ins.delays) for ins in ev.instances.values())


@pytest.mark.parametrize("whole_word,segment", [(False, 320), (True, 640)])
def test_batched_evaluator_matches_sequential_and_jax(stack, tmp_path, whole_word,
                                                      segment):
    sources, refs = _sources(5 if not whole_word else 13, LENGTHS)
    jtext, junits = stack["jdicts"]
    ptext, punits = stack["pdicts"]
    jcfg = JaxAgentConfig(source_segment_size=segment, whole_word=whole_word)
    pcfg = StreamSpeechAgentConfig(source_segment_size=segment, whole_word=whole_word)
    pev = BatchedS2STEvaluator(stack["port"], pcfg, ptext, ptext, punits, batch=3,
                               quality_metrics=[], output_dir=str(tmp_path / "port"))
    pscores = pev(sources, refs)

    # the port's sequential evaluator: everything equal
    seq, sscores, final = _port_sequential(stack["port"], stack["pdicts"], pcfg,
                                           sources, refs)
    _same_instances(pev, seq, atol=1e-5)
    _same_scores(pscores, sscores)
    for i, ins in pev.instances.items():
        assert (ins.final_mt_tokens, ins.final_units) == final[i], i
    assert any(d < ins.source_length for ins in pev.instances.values()
               for d in ins.delays), "vacuous: no instance wrote while streaming"

    # JAX's sequential evaluator over its agent's host policy: the reference
    jagent = JaxAgent(stack["jax"], jcfg, jtext, jtext, junits)
    jagent._starts_word = None
    jseq, jsscores, jfinal = _sequential(jagent, JaxEvaluator, sources, refs)
    _same_instances(pev, jseq)
    _same_scores(pscores, jsscores)
    for i, ins in pev.instances.items():
        assert (ins.final_mt_tokens, ins.final_units) == jfinal[i], i

    # JAX's batched host tick, wherever it agrees with its own sequential agent
    jbat = JaxBatchedEval(stack["jax"], jcfg, jtext, jtext, junits, batch=3,
                          use_fused=False, quality_metrics=[],
                          output_dir=str(tmp_path / "jax"))
    jbat(sources, refs)
    agree = [i for i in jbat.instances
             if _differ(jbat, jseq, i) is None
             and jbat.instances[i].final_units == jfinal[i][1]]
    assert agree, "JAX's host tick agreed with its sequential agent nowhere"
    for i in agree:
        assert _differ(pev, jbat, i) is None, i
        assert pev.instances[i].final_units == jbat.instances[i].final_units, i


def test_batched_evaluator_resumes_from_its_log(stack, tmp_path):
    sources, refs = _sources(11, LENGTHS[:4])
    ptext, punits = stack["pdicts"]
    cfg = StreamSpeechAgentConfig()
    first = BatchedS2STEvaluator(stack["port"], cfg, ptext, ptext, punits, batch=3,
                                 quality_metrics=[], output_dir=str(tmp_path))
    first(sources[:2], refs[:2])
    log = tmp_path / "instances.log"
    assert [int(line.split('"index": ')[1].split(",")[0])
            for line in log.read_text().splitlines()] == [0, 1]
    resumed = BatchedS2STEvaluator(stack["port"], cfg, ptext, ptext, punits, batch=3,
                                   quality_metrics=[], output_dir=str(tmp_path))
    resumed(sources, refs, continue_unfinished=True)
    assert sorted(resumed.instances) == [2, 3]      # only what the log lacked
    assert len(log.read_text().splitlines()) == 4
    whole = BatchedS2STEvaluator(stack["port"], cfg, ptext, ptext, punits, batch=3,
                                 quality_metrics=[])
    whole(sources, refs)
    for i in (2, 3):
        assert resumed.instances[i].delays == whole.instances[i].delays


def test_bf16_wave_matches_bf16_singles(stack):
    """A bf16 engine (bf16 compute, float32 vocoder) serves the wave as it
    serves each source alone: delays, MT tokens, units, and the wav."""
    sources, refs = _sources(5, LENGTHS[:3])
    ptext, punits = stack["pdicts"]
    cfg = StreamSpeechAgentConfig()
    engine = stack["port_lp"]
    assert engine.model.dtype == torch.bfloat16
    pev = BatchedS2STEvaluator(engine, cfg, ptext, ptext, punits, batch=3,
                               quality_metrics=[])
    pscores = pev(sources, refs)
    seq, sscores, final = _port_sequential(engine, stack["pdicts"], cfg, sources, refs)
    assert _wrote(seq) > 0
    _same_instances(pev, seq, atol=1e-5)
    _same_scores(pscores, sscores)
    for i, ins in pev.instances.items():
        assert (ins.final_mt_tokens, ins.final_units) == final[i], i


@pytest.mark.parametrize("names,missing", [(None, "ASR_BLEU"), (["WER"], "WER")])
def test_quality_scorer_not_ported_raises_by_name(stack, names, missing):
    ptext, punits = stack["pdicts"]
    with pytest.raises(ValueError, match=missing):
        BatchedS2STEvaluator(stack["port"], StreamSpeechAgentConfig(), ptext, ptext,
                             punits, quality_metrics=names)


def test_evaluator_defaults_to_the_card():
    """Without ``device="cpu"`` the engine, and so the evaluator, takes the
    card, and raises where there is none."""
    from streamspeech_tpu_torch.config import tiny_config
    from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
    from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only refusal cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamSpeechEngine(StreamSpeechModel(tiny_config()))
