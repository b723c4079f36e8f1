"""The fused batched tick: the port's ``BatchedStreamingSession.fused_tick``
(``StreamSpeechEngine.policy_step_batched``; on the CPU its parts run
eagerly) against JAX's (``policy_step_batched``) tick by tick, then the
port's ``BatchedS2STEvaluator(use_fused=True)`` against the port's
sequential evaluator over its S2ST agent and against the JAX package's
``BatchedS2STEvaluator(use_fused=True)``, on one wave of five
sources of staggered lengths (0.5-1.5 s, none a whole number of 320 ms
segments) in waves of 3, and at 640 ms with ``whole_word`` (against the
sequential run alone); the host tick
(``use_fused=False``) against the same sequential run; two sessions that
take the fused tick in turn.

Every instance: the delays, the final units exactly (and the MT tokens
against the sequential run), the stitched wav within 1e-5, every latency
score but the wall-clock ones against the sequential run.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from streamspeech_tpu.agents.streamspeech import StreamSpeechAgentConfig as JaxAgentConfig
from streamspeech_tpu.eval.batched_evaluator import BatchedS2STEvaluator as JaxBatchedEval
from streamspeech_tpu.runtime.batched import BatchedStreamingSession as JaxBatched
from tests.test_torch_batched_eval import (
    LENGTHS,
    _port_sequential,
    _same_instances,
    _same_scores,
    _sources,
)
from tests.jax_init import shared_jax_init  # noqa: F401
from tests.torch_serving_stack import build_stack
from tests.torch_threads import one_torch_thread  # noqa: F401

from streamspeech_tpu_torch.agents.base import stream_utterance
from streamspeech_tpu_torch.agents.streamspeech import (
    StreamSpeechAgentConfig,
    StreamSpeechS2STAgent,
    starts_word_table,
)
from streamspeech_tpu_torch.eval.batched_evaluator import BatchedS2STEvaluator
from streamspeech_tpu_torch.ops.fbank import OnlineFbank
from streamspeech_tpu_torch.runtime.batched import BatchedStreamingSession

BLOCK = 32                      # fbank frames of a lockstep block at 320 ms


@pytest.fixture(scope="module")
def stack():
    return build_stack()


def _count_fused_ticks(monkeypatch):
    ticks = []
    real = BatchedStreamingSession.fused_tick

    def fused_tick(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        ticks.append(out is not None)
        return out

    monkeypatch.setattr(BatchedStreamingSession, "fused_tick", fused_tick)
    return ticks


@pytest.mark.parametrize("whole_word,segment", [(False, 320), (True, 640)])
def test_fused_wave_matches_sequential(stack, monkeypatch, whole_word, segment):
    sources, refs = _sources(5 if not whole_word else 13, LENGTHS)
    ptext, punits = stack["pdicts"]
    pcfg = StreamSpeechAgentConfig(source_segment_size=segment, whole_word=whole_word)
    ticks = _count_fused_ticks(monkeypatch)
    pev = BatchedS2STEvaluator(stack["port"], pcfg, ptext, ptext, punits, batch=3,
                               quality_metrics=[])
    assert pev.use_fused
    pscores = pev(sources, refs)
    assert sum(ticks) >= 4, "vacuous: the fused tick never applied"
    seq, sscores, final = _port_sequential(stack["port"], stack["pdicts"], pcfg,
                                           sources, refs)
    _same_instances(pev, seq, atol=1e-5)
    _same_scores(pscores, sscores)
    for i, ins in pev.instances.items():
        assert (ins.final_mt_tokens, ins.final_units) == final[i], i
    assert any(d < ins.source_length for ins in pev.instances.values()
               for d in ins.delays), "vacuous: no instance wrote while streaming"


def test_fused_wave_matches_jax_fused_evaluator(stack):
    """JAX's fused evaluator, on the instances of the first wave test: its
    host tick's faults at a finish do not show on this wave."""
    sources, refs = _sources(5, LENGTHS)
    jtext, junits = stack["jdicts"]
    ptext, punits = stack["pdicts"]
    pev = BatchedS2STEvaluator(stack["port"], StreamSpeechAgentConfig(), ptext, ptext,
                               punits, batch=3, quality_metrics=[])
    pev(sources, refs)
    jbat = JaxBatchedEval(stack["jax"], JaxAgentConfig(), jtext, jtext, junits, batch=3,
                          use_fused=True, quality_metrics=[])
    assert jbat.use_fused
    jbat(sources, refs)
    _same_instances(pev, jbat, atol=1e-5)
    for i, ins in pev.instances.items():
        assert ins.final_units == jbat.instances[i].final_units, i


def _same_bundle(p, j, where):
    """A stream's bundle of the port's fused tick against JAX's: the
    decisions, ``keep``, the CTC counts exactly; where it emitted, the units
    and durations exactly and the wav tail within 1e-5. ``hit_eos`` may be
    set by JAX where the port's is not (JAX's scan also reports an EOS that a
    step past a stream's stop predicted, ROADMAP §C): the port's implies it."""
    for name in ("do_decode", "do_emit", "ok", "budget_over", "grew", "keep",
                 "asr_count", "st_count", "count", "prev_tokens", "tail_ready"):
        assert p[name] == j[name], (where, name, p[name], j[name])
    assert not p["hit_eos"] or j["hit_eos"], where
    if p["do_emit"]:
        assert p["units"] == list(j["units"]), where
        np.testing.assert_array_equal(np.asarray(p["dur"]), np.asarray(j["dur"]))
        assert np.asarray(p["tail"]).shape == np.asarray(j["tail"]).shape, where
        np.testing.assert_allclose(np.asarray(p["tail"]), np.asarray(j["tail"]),
                                   atol=1e-5, rtol=0, err_msg=str(where))


def test_fused_tick_bundles_match_jax_policy_step_batched(stack):
    """Three streams (fbank frames of 1.2, 0.7 and 0.9 s of noise) in
    lockstep, one block a tick, through both packages' ``fused_tick``:
    staggered ends (one inside a block), the finish tranches."""
    ptext, _ = stack["pdicts"]
    ptable = starts_word_table(stack["port"], ptext)
    jtable = jnp.asarray(ptable)
    rng = np.random.RandomState(5)
    streams = [OnlineFbank().push(rng.uniform(-0.3, 0.3, n).astype(np.float32))
               for n in (19200, 11200, 14000)]
    sessions = {"jax": JaxBatched(stack["jax"], 3),
                "port": BatchedStreamingSession(stack["port"], 3)}
    sent = [0, 0, 0]
    counters = [(0, 0, 0)] * 3
    finished = np.zeros(3, bool)
    ticks = finishes = 0
    while True:
        for i, x in enumerate(streams):
            if not finished[i]:
                piece = x[sent[i]:sent[i] + BLOCK]
                sent[i] += len(piece)
                finished[i] = sent[i] == len(x)
                for s in sessions.values():
                    s.push_features(i, piece, finished=bool(finished[i]))
        src, tgt, units = (np.asarray(v) for v in zip(*counters))
        args = (8, 8, 0, 1, False, 200)
        j = sessions["jax"].fused_tick(*args, jtable, src, tgt, units,
                                       np.ones(3, bool), finished.copy())
        p = sessions["port"].fused_tick(*args, ptable, src, tgt, units,
                                        np.ones(3, bool), finished.copy())
        assert (p is None) == (j is None), ticks
        if p is None:
            break
        for i in range(3):
            _same_bundle(p[i], j[i], (ticks, i))
            r = p[i]
            src_i, tgt_i, units_i = counters[i]
            if r["grew"]:
                src_i, tgt_i = max(r["asr_count"], src_i), max(r["st_count"], tgt_i)
            if r["do_emit"] and r["ok"] and r["count"] > units_i:
                units_i = r["count"]
            counters[i] = (src_i, tgt_i, units_i)
            finishes += bool(finished[i] and r["do_decode"])
        assert sessions["port"].mt_tokens == sessions["jax"].mt_tokens, ticks
        ticks += 1
    assert ticks >= 4 and finishes >= 4, "vacuous: no finish tranche ran"


def test_host_tick_matches_sequential(stack, monkeypatch):
    """``use_fused=False`` keeps the host tick, in the sequential agent's order."""
    sources, refs = _sources(5, LENGTHS)
    ptext, punits = stack["pdicts"]
    cfg = StreamSpeechAgentConfig()
    ticks = _count_fused_ticks(monkeypatch)
    pev = BatchedS2STEvaluator(stack["port"], cfg, ptext, ptext, punits, batch=3,
                               use_fused=False, quality_metrics=[])
    pscores = pev(sources, refs)
    assert not ticks
    seq, sscores, _ = _port_sequential(stack["port"], stack["pdicts"], cfg, sources, refs)
    _same_instances(pev, seq, atol=1e-5)
    _same_scores(pscores, sscores)


def test_sessions_taking_the_fused_tick_in_turn(stack):
    """Two fused agents served turn by turn share the engine's one B = 1 slot:
    each binding hands the other clones of the slot's state, so each
    stream's segments are those of its run alone."""
    ptext, punits = stack["pdicts"]
    cfg = StreamSpeechAgentConfig()
    rng = np.random.RandomState(21)
    samples = [rng.uniform(-0.3, 0.3, n) for n in (17000, 14500)]

    def agent():
        return StreamSpeechS2STAgent(stack["port"], cfg, ptext, ptext, punits,
                                     use_fused=True)

    def final(a):
        return list(a.session.mt_tokens), list(a.units)

    solo = []
    for s in samples:
        a = agent()
        solo.append(([list(seg.content or []) for seg in stream_utterance(a, s)],
                     final(a)))
    agents = [agent(), agent()]
    runs = [stream_utterance(a, s) for a, s in zip(agents, samples)]
    together = [[] for _ in runs]
    live = [0, 1]
    while live:                         # one turn of each stream in turn
        for i in list(live):
            seg = next(runs[i], None)
            if seg is None:
                live.remove(i)
            else:
                together[i].append(list(seg.content or []))
    for i, (segs, want) in enumerate(solo):
        assert final(agents[i]) == want, i
        assert [len(x) for x in together[i]] == [len(x) for x in segs], i
        for got, ref in zip(together[i], segs):
            assert np.allclose(got, ref, atol=1e-5, rtol=0), i
    assert any(units for _, (_, units) in solo), "vacuous: nothing was written"
