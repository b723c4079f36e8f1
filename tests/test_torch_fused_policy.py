"""The fused policy tick of one stream: the port's ``StreamingSession.
fused_policy`` (``StreamSpeechEngine.policy_step``, on the CPU its parts run
eagerly) against JAX's ``fused_policy`` (``policy_step``) on the same
doctored tiny weights (``tests/torch_serving_stack.py``); then the port's
fused agent against its host agent and against the JAX agent, which runs its
fused program, with ``whole_word`` off and on; then the two fallbacks. (The
batched tick's bundles against JAX's ``policy_step_batched``:
``tests/test_torch_fused_batched.py``.)

Bundles chunk by chunk: the decisions, ``keep``, the CTC counts, the units and
durations exactly, the wav tail within 1e-5, the hypotheses after. ``hit_eos``
may be set by JAX where the port's is not: JAX's scan also reports an EOS that
a step past a stream's stop predicted (ROADMAP §C), so the port's is held to
imply JAX's. Agents: every instance's delays, MT tokens and units exactly, its
wav within 1e-5. A dictionary where every third token does not start a word
makes the whole-word rollback cut.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from streamspeech_tpu.agents.streamspeech import StreamSpeechAgentConfig as JaxAgentConfig
from streamspeech_tpu.agents.streamspeech import StreamSpeechS2STAgent as JaxAgent
from streamspeech_tpu.dictionary import Dictionary as JaxDictionary
from streamspeech_tpu.eval.evaluator import SentenceLevelEvaluator as JaxEvaluator
from tests.torch_serving_stack import ENGINE_SIZES, build_stack
from tests.torch_threads import one_torch_thread  # noqa: F401

from streamspeech_tpu_torch.agents.streamspeech import (
    StreamSpeechAgentConfig,
    StreamSpeechS2STAgent,
    starts_word_table,
)
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.eval.evaluator import SentenceLevelEvaluator
from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine

CHUNK = CONV_CHUNK = 8          # blocks of 32 fbank frames
BLOCK = 32
# the random streams' CTC heads grow ~7 tokens a block; the bundle tests and the
# agents share it, and so JAX's compiled programs
K1 = 8
FLAGS = ("do_decode", "do_emit", "ok", "budget_over", "grew")
TAIL_ATOL = 1e-5


@pytest.fixture(scope="module")
def stack():
    out = build_stack()
    vocab = out["port"].model.cfg.mt_decoder.vocab_size
    words = [("▁w" if i % 3 != 2 else "sub") + str(i) for i in range(vocab - 4)]
    jtext, ptext = JaxDictionary(), Dictionary()
    for w in words:
        jtext.add_symbol(w)
        ptext.add_symbol(w)
    out["words"] = (jtext, ptext)
    return out


def _same_bundle(p, j, where):
    for name in FLAGS + ("keep", "asr_count", "st_count", "count"):
        assert p[name] == j[name], (where, name, p[name], j[name])
    assert not p["hit_eos"] or j["hit_eos"], where
    if p["do_emit"]:
        assert p["units"] == list(j["units"]), where
        np.testing.assert_array_equal(np.asarray(p["dur"]), np.asarray(j["dur"]))
        assert np.asarray(p["tail"]).shape == np.asarray(j["tail"]).shape, where
        np.testing.assert_allclose(np.asarray(p["tail"]), np.asarray(j["tail"]),
                                   atol=TAIL_ATOL, rtol=0, err_msg=str(where))


def _advance(counters, out):
    """The agent's counter recurrences after a bundle: prefix lengths on
    growth, emitted units on an in-window emission."""
    src, tgt, units = counters
    if out["grew"]:
        src, tgt = max(out["asr_count"], src), max(out["st_count"], tgt)
    if out["do_emit"] and out["ok"] and out["count"] > units:
        units = out["count"]
    return src, tgt, units


@pytest.mark.parametrize("whole_word", [False, True])
def test_policy_step_bundles_match_jax_policy_step(stack, whole_word):
    """Chunks of one stream through both packages' fused_policy, until the
    MT caches lack room for another (both return None there)."""
    jtext, ptext = stack["words"]
    ptable = starts_word_table(stack["port"], ptext)
    jtable = jnp.asarray(ptable)
    jsess, psess = stack["jax"].new_session(), stack["port"].new_session()
    feats = np.random.RandomState(3).randn(8 * BLOCK, 80).astype(np.float32)
    counters = (0, 0, 0)
    decoded = emitted = 0
    for c in range(8):
        block = feats[c * BLOCK:(c + 1) * BLOCK]
        args = (CHUNK, CONV_CHUNK, K1, 1, whole_word, 200)
        j = jsess.fused_policy(block, *args, jtable, *counters)
        p = psess.fused_policy(block, *args, ptable, *counters)
        assert (p is None) == (j is None), c
        if p is None:
            break
        _same_bundle(p, j, c)
        assert psess.mt_tokens == jsess.mt_tokens, c
        counters = _advance(counters, p)
        decoded += p["do_decode"]
        emitted += p["do_emit"]
    assert c >= 4 and decoded >= 4 and emitted >= 3, "vacuous: the gates stayed shut"


def _serve(agent, evaluator_cls, sources):
    ev = evaluator_cls(agent, source_segment_size=agent.cfg.source_segment_size,
                       quality_metrics=[])
    out = {}
    for i, src in enumerate(sources):
        ins = ev._make_instance(i, src, "ref", 16000)
        ev.run_instance(ins)
        out[i] = (ins.delays, list(agent.session.mt_tokens), list(agent.units),
                  ins.stitched)
    return out


def _same_runs(got, want, atol=TAIL_ATOL):
    for i, (delays, tokens, units, wav) in want.items():
        g = got[i]
        assert (g[0], g[1], g[2]) == (delays, tokens, units), i
        assert (g[3] is None) == (wav is None), i
        if wav is not None:
            assert np.asarray(g[3]).shape == np.asarray(wav).shape, i
            assert np.abs(np.asarray(g[3]) - np.asarray(wav)).max() <= atol, i


def _sources(seed):
    rng = np.random.RandomState(seed)
    return [list(rng.uniform(-0.3, 0.3, n)) for n in (16000, 23456, 12000)]


@pytest.mark.parametrize("whole_word", [False, True])
def test_fused_agent_matches_host_agent_and_jax_fused_agent(stack, whole_word):
    jtext, ptext = stack["words"]
    _, punits = stack["pdicts"]
    _, junits = stack["jdicts"]
    sources = _sources(4)
    cfg = StreamSpeechAgentConfig(whole_word=whole_word, lagging_k1=K1)
    fused = StreamSpeechS2STAgent(stack["port"], cfg, ptext, ptext, punits, use_fused=True)
    ticks = []
    action = fused._fused_action
    fused._fused_action = lambda out: ticks.append(out) or action(out)
    got = _serve(fused, SentenceLevelEvaluator, sources)
    assert sum(t["do_emit"] for t in ticks) >= 3, "vacuous: the fused tick never emitted"
    host = _serve(StreamSpeechS2STAgent(stack["port"], cfg, ptext, ptext, punits),
                  SentenceLevelEvaluator, sources)
    _same_runs(got, host)
    jagent = JaxAgent(stack["jax"], JaxAgentConfig(whole_word=whole_word, lagging_k1=K1),
                      jtext, jtext, junits)
    assert jagent._starts_word is not None          # JAX runs its fused program
    _same_runs(got, _serve(jagent, JaxEvaluator, sources))
    assert any(d < len(sources[i]) / 16 for i, run in got.items() for d in run[0])


def _fresh_engine(stack, **attrs):
    """A port engine on the stack's model and vocoder, its attributes set
    before any tick."""
    port = stack["port"]
    engine = StreamSpeechEngine(port.model, port.vocoder, device="cpu", **ENGINE_SIZES)
    for name, value in attrs.items():
        setattr(engine, name, value)
    return engine


@pytest.mark.parametrize("fallback", ["budget_over", "window"])
def test_fallbacks_fire_and_match_the_host_agent(stack, fallback):
    """``fused_steps`` = 1 sends every budget above one token to the host
    continuation; a 2-frame tail window (1 of context) overflows, and the
    host emission takes over. Either way the actions are those of the host
    agent on the same engine."""
    _, ptext = stack["words"]
    _, punits = stack["pdicts"]
    if fallback == "budget_over":
        engine = _fresh_engine(stack, fused_steps=1)
    else:
        engine = _fresh_engine(stack, emit_window_frames=2, emit_ctx_frames=1,
                               emit_tail_cap=320)
    cfg = StreamSpeechAgentConfig()
    agent = StreamSpeechS2STAgent(engine, cfg, ptext, ptext, punits, use_fused=True)
    fired, in_tick = [], []
    name = "_decode_and_emit" if fallback == "budget_over" else "_emit_from_host"
    host_path, action = getattr(agent, name), agent._fused_action
    # the host path counts only when a fused tick's bundle sent it there
    setattr(agent, name, lambda *a: fired.extend(in_tick) or host_path(*a))
    agent._fused_action = lambda out: in_tick.append(1) or action(out) or in_tick.clear()
    sources = _sources(6)
    got = _serve(agent, SentenceLevelEvaluator, sources)
    assert fired, f"the {fallback} fallback never fired"
    # the host agent on the same engine: a window this short changes the
    # windowed tails that fit it as well (too little context)
    host = _serve(StreamSpeechS2STAgent(engine, cfg, ptext, ptext, punits),
                  SentenceLevelEvaluator, sources)
    _same_runs(got, host)
