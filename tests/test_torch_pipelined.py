"""The overlapped (pipelined) serving loop of one stream: the port's agent with
``StreamSpeechAgentConfig(pipelined=True)`` (``StreamingSession.pipe_*``,
``StreamSpeechEngine.policy_step_pipelined``; on the CPU its graph's parts and
conds run eagerly) against the port's synchronous fused agent, the port's
host agent and JAX's pipelined agent, on ``tests/torch_serving_stack.py``'s
doctored tiny weights; the counterparts of JAX's
``tests/test_pipelined_policy.py``.

Every instance's delays, MT tokens and units exactly, its wav within 1e-5:
``whole_word`` off and on, lags 1, 3 and 8 with the age rule off
(``pipe_ready_s`` = 3600: the deepest pipeline), the budget-over, window
and no-room fallbacks (each asserted to fire). Then: three chunks dispatch
with no host read and their bundles equal the synchronous tick's;
``mirror_cross_valid`` clamps a fallback decode to the mirror's frames; a
recorded utterance replayed on a fresh session gives the same bundles.

JAX's overlapped agent asks for room for a hypothesis at ``max_len`` before
it dispatches, which engines whose largest MT bucket is their cache (these,
and JAX's defaults) never give, so it takes its host path every chunk; the
port's dispatches (``StreamingSession.pipe_applicable``), and the tests
assert that it did. About 47 worker-seconds in the tier-1 run, most of it
JAX's programs compiled once (module fixtures).
"""

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU before the stack builds)
import numpy as np
import pytest
import torch
from streamspeech_tpu.agents.streamspeech import StreamSpeechAgentConfig as JaxAgentConfig
from streamspeech_tpu.agents.streamspeech import StreamSpeechS2STAgent as JaxAgent
from streamspeech_tpu.dictionary import Dictionary as JaxDictionary
from streamspeech_tpu.eval.evaluator import SentenceLevelEvaluator as JaxEvaluator
from tests.jax_init import shared_jax_init  # noqa: F401
from tests.torch_serving_stack import ENGINE_SIZES, build_stack
from tests.torch_threads import one_torch_thread  # noqa: F401

from streamspeech_tpu_torch.agents.streamspeech import (
    StreamSpeechAgentConfig,
    StreamSpeechS2STAgent,
    starts_word_table,
)
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.eval.evaluator import SentenceLevelEvaluator
from streamspeech_tpu_torch.runtime import session as session_module
from streamspeech_tpu_torch.runtime.graphs import Packed
from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine

CHUNK = CONV_CHUNK = 8          # blocks of 32 fbank frames, 8 encoder frames
BLOCK = 32
K1 = 8                          # as tests/test_torch_fused_policy.py: the gates open
WAV_ATOL = 1e-5


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
    out["sources"] = _sources(4)
    return out


@pytest.fixture(scope="module")
def jax_runs(stack):
    """JAX's pipelined agent over the stack's sources, a run a config (its
    programs compiled once, for the module)."""
    runs = {}

    def get(whole_word, lag):
        if (whole_word, lag) not in runs:
            jtext, _ = stack["words"]
            _, junits = stack["jdicts"]
            cfg = JaxAgentConfig(whole_word=whole_word, lagging_k1=K1, pipelined=True,
                                 pipe_max_lag=lag, pipe_ready_s=3600.0)
            runs[whole_word, lag] = _serve(JaxAgent(stack["jax"], cfg, jtext, jtext, junits),
                                           JaxEvaluator, stack["sources"])[0]
        return runs[whole_word, lag]

    return get


def _sources(seed):
    rng = np.random.RandomState(seed)
    return [list(rng.uniform(-0.3, 0.3, n)) for n in (16000, 23456, 12000)]


def _fresh_engine(stack, sizes=(), **attrs):
    """A port engine on the stack's model and vocoder (``sizes`` over the
    stack's), its attributes set before any tick."""
    port = stack["port"]
    engine = StreamSpeechEngine(port.model, port.vocoder, device="cpu",
                                **dict(ENGINE_SIZES, **dict(sizes)))
    for name, value in attrs.items():
        setattr(engine, name, value)
    return engine


def _agent(stack, engine=None, use_fused=False, k1=K1, **cfg):
    _, ptext = stack["words"]
    _, punits = stack["pdicts"]
    return StreamSpeechS2STAgent(engine or stack["port"],
                                 StreamSpeechAgentConfig(lagging_k1=k1, **cfg),
                                 ptext, ptext, punits, use_fused=use_fused)


def _serve(agent, evaluator_cls, sources):
    """Each source through ``agent``: {index: (delays, MT tokens, units,
    stitched wav)}, and the port session's overlapped-loop counts."""
    ev = evaluator_cls(agent, source_segment_size=agent.cfg.source_segment_size,
                       quality_metrics=[])
    out, stats = {}, []
    for i, src in enumerate(sources):
        ins = ev._make_instance(i, src, "ref", 16000)
        ev.run_instance(ins)
        out[i] = (ins.delays, list(agent.session.mt_tokens), list(agent.units),
                  ins.stitched)
        stats.append(dict(getattr(agent.session, "pipe_stats", {})))
    return out, stats


def _same_runs(got, want):
    for i, (delays, tokens, units, wav) in want.items():
        g = got[i]
        assert (g[0], g[1], g[2]) == (delays, tokens, units), i
        assert (g[3] is None) == (wav is None), i
        if wav is not None:
            assert np.asarray(g[3]).shape == np.asarray(wav).shape, i
            assert np.abs(np.asarray(g[3]) - np.asarray(wav)).max() <= WAV_ATOL, i


def _pipelined(stack, lag, engine=None, **cfg):
    """The port's pipelined agent's runs; asserts that it dispatched and
    that chunks were in flight together (the loop was overlapped)."""
    agent = _agent(stack, engine, pipelined=True, pipe_max_lag=lag, pipe_ready_s=3600.0,
                   **cfg)
    got, stats = _serve(agent, SentenceLevelEvaluator, stack["sources"])
    assert sum(s["dispatches"] for s in stats) >= 3, stats
    assert max(s["deepest"] for s in stats) >= min(lag + 1, 2), stats
    assert all(s["dispatches"] == s["fetches"] for s in stats), stats
    return agent, got


@pytest.mark.parametrize("whole_word", [False, True])
def test_pipelined_matches_sync_fused_and_jax_pipelined(stack, jax_runs, whole_word):
    _, got = _pipelined(stack, 8, whole_word=whole_word)
    sync, _ = _serve(_agent(stack, use_fused=True, whole_word=whole_word),
                     SentenceLevelEvaluator, stack["sources"])
    _same_runs(got, sync)
    _same_runs(got, jax_runs(whole_word, 8))
    # writes while the source streams, at decision positions before its end
    assert any(d < len(stack["sources"][i]) / 16 for i, run in got.items() for d in run[0])


@pytest.mark.parametrize("lag", [1, 3])
def test_pipelined_lag_depths(stack, jax_runs, lag):
    """The fetch schedule is a knob of speed alone."""
    _, got = _pipelined(stack, lag)
    sync, _ = _serve(_agent(stack, use_fused=True), SentenceLevelEvaluator, stack["sources"])
    _same_runs(got, sync)
    _same_runs(got, jax_runs(False, lag))


def test_pipelined_matches_host_path(stack):
    _, got = _pipelined(stack, 8)
    host, _ = _serve(_agent(stack), SentenceLevelEvaluator, stack["sources"])
    _same_runs(got, host)


def _fallback_condition(fallback, out):
    if fallback == "no_room":
        return out["no_room"]
    if fallback == "budget_over":
        return (not out["no_room"] and out["grew"] and out["budget_over"]
                and not out["do_decode"])
    return not out["no_room"] and out["do_decode"] and out["do_emit"] and not out["ok"]


@pytest.mark.parametrize("fallback", ["budget_over", "window", "no_room"])
def test_fallbacks_fire_and_match_the_host_agent(stack, fallback):
    """At k1 = 0: ``fused_steps`` = 1 sends every budget above one token to
    the host continuation; a 2-frame tail window (1 of context) overflows;
    MT caches of 16 run out of room for the 8-step scan while chunks are in
    flight. Each time the chunk, and those in flight behind it, take the
    host path, and the actions are the host agent's on the same engine."""
    attrs = {"budget_over": dict(fused_steps=1),
             "window": dict(emit_window_frames=2, emit_ctx_frames=1, emit_tail_cap=320),
             "no_room": dict(sizes=dict(max_mt_tokens=16, mt_buckets=(8, 16)))}[fallback]
    engine = _fresh_engine(stack, **attrs)
    agent = _agent(stack, engine, k1=0, pipelined=True, pipe_max_lag=8, pipe_ready_s=3600.0)
    fired, process = [], agent._process_pipe_out
    agent._process_pipe_out = lambda out, **kw: (
        fired.append(_fallback_condition(fallback, out)), process(out, **kw))
    got, _ = _serve(agent, SentenceLevelEvaluator, stack["sources"])
    assert any(fired), f"the {fallback} fallback never fired"
    host, _ = _serve(_agent(stack, engine, k1=0), SentenceLevelEvaluator, stack["sources"])
    _same_runs(got, host)


def _feats(seed, blocks):
    return np.random.RandomState(seed).randn(blocks * BLOCK, 80).astype(np.float32)


def _dispatch(session, feats, c, table, whole_word=False):
    session.pipe_dispatch(feats[c * BLOCK:(c + 1) * BLOCK], CHUNK, CONV_CHUNK, K1, 1,
                          whole_word, 200, table, 320.0 * (c + 1), BLOCK // 4)


def test_three_dispatches_read_nothing_and_match_the_sync_tick(stack, monkeypatch):
    """Three chunks dispatched with every host read patched to raise
    (``item``, ``cpu``, ``tolist``, ``Packed.download`` and a tensor's
    ``bool``, ``int``, ``float`` and ``index``) are all in flight; fetched,
    each bundle is the synchronous tick's on the same chunk (the counters
    advanced by the agent's recurrences). On the CPU ``cond`` reads its
    predicate, the one read allowed: on a card that read is an IF node's
    setter kernel, and ``chip_smoke.py``'s profiled gate checks that no
    other blocking read falls between two dispatches."""
    _, ptext = stack["words"]
    table = starts_word_table(stack["port"], ptext)
    feats = _feats(5, 3)
    engine = _fresh_engine(stack)
    piped = engine.new_session()
    piped.pipe_set_counters(0, 0, 0)
    piped.pipe_resync()

    def no_read(*_a, **_k):
        raise AssertionError("a host read between two dispatches")

    preds = []                  # the predicate of each cond in progress
    real_cond, real_bool = session_module.cond, torch.Tensor.__bool__

    def cond_reading_its_predicate(pred, body):
        preds.append(pred)
        try:
            real_cond(pred, body)
        finally:
            preds.pop()

    def bool_of_a_predicate(t):
        if preds and t is preds[-1]:
            return real_bool(t)
        no_read()

    with monkeypatch.context() as m:
        for name in ("item", "cpu", "tolist", "__int__", "__float__", "__index__"):
            m.setattr(torch.Tensor, name, no_read)
        m.setattr(torch.Tensor, "__bool__", bool_of_a_predicate)
        m.setattr(Packed, "download", no_read)
        m.setattr(session_module, "cond", cond_reading_its_predicate)
        for c in range(3):
            _dispatch(piped, feats, c, table)
    assert len(piped.pipe_inflight) == 3
    sync = _fresh_engine(stack).new_session()
    counters = (0, 0, 0)
    for c in range(3):
        got = piped.pipe_fetch_oldest()
        want = sync.fused_policy(feats[c * BLOCK:(c + 1) * BLOCK], CHUNK, CONV_CHUNK, K1, 1,
                                 False, 200, table, *counters)
        for name in ("do_decode", "do_emit", "ok", "budget_over", "hit_eos", "grew", "keep",
                     "asr_count", "st_count", "count"):
            assert got[name] == want[name], (c, name)
        if want["do_emit"]:
            assert got["units"] == want["units"], c
            np.testing.assert_array_equal(got["dur"], want["dur"])
            np.testing.assert_allclose(got["tail"], want["tail"], atol=WAV_ATOL, rtol=0)
        assert piped.mt_tokens == sync.mt_tokens, c
        src, tgt, units = counters
        if want["grew"]:
            src, tgt = max(want["asr_count"], src), max(want["st_count"], tgt)
        if want["do_emit"] and want["ok"] and want["count"] > units:
            units = want["count"]
        counters = (src, tgt, units)
    assert piped.asr_ids == sync.asr_ids and piped.st_ids == sync.st_ids
    assert piped.enc_len == sync.enc_len == 3 * BLOCK // 4


def test_mirror_cross_valid_clamps_a_fallback_decode(stack):
    """With two chunks in flight ahead of one taken in, a host decode reads
    the mirror's 8 encoder frames: its tokens are those of a session that
    has encoded only that block, where the unclamped decode reads 24."""
    _, ptext = stack["words"]
    table = starts_word_table(stack["port"], ptext)
    feats = _feats(6, 3)
    engine = _fresh_engine(stack)
    alone = engine.new_session()
    alone.push_features(feats[:BLOCK], CHUNK, CONV_CHUNK)
    want = alone.mt_decode(6)
    ahead = engine.new_session()
    ahead.push_features(feats[:BLOCK], CHUNK, CONV_CHUNK)
    ahead.pipe_set_counters(10 ** 6, 10 ** 6, 0)      # gates shut: no device decode
    ahead.pipe_resync()
    for c in (1, 2):
        _dispatch(ahead, feats, c, table)
    clamp = ahead.mirror_cross_valid()
    assert clamp.shape == (1, engine.max_enc_frames) and int(clamp.sum()) == BLOCK // 4
    assert ahead.enc_state.pos == 3 * BLOCK // 4        # the device is ahead
    assert ahead.mt_decode(6) == want
    free = engine.new_session()
    free.push_features(feats, CHUNK, CONV_CHUNK)
    assert free.mirror_cross_valid() is None
    assert free.mt_decode(6) != want                    # the 24 frames decode otherwise


def test_recorded_calls_replay_to_the_same_bundles(stack):
    """``record`` keeps each ``fused_policy`` call's inputs; replayed on a
    fresh session they give the same bundles (the nosync benchmark's
    replay)."""
    _, ptext = stack["words"]
    table = starts_word_table(stack["port"], ptext)
    feats = _feats(3, 8)
    engine = _fresh_engine(stack)
    bundles, policy_step = [], engine.policy_step
    engine.policy_step = lambda *a, **k: bundles.append(policy_step(*a, **k)) or bundles[-1]
    session = engine.new_session()
    session.record = []
    counters = (0, 0, 0)
    for c in range(8):
        out = session.fused_policy(feats[c * BLOCK:(c + 1) * BLOCK], CHUNK, CONV_CHUNK, K1,
                                   1, True, 200, table, *counters)
        if out is None:                 # the MT caches lack room: the host's chunk
            break
        src, tgt, units = counters
        if out["grew"]:
            src, tgt = max(out["asr_count"], src), max(out["st_count"], tgt)
        if out["do_emit"] and out["ok"] and out["count"] > units:
            units = out["count"]
        counters = (src, tgt, units)
    assert len(session.record) == len(bundles) >= 4
    assert sum(b["flags"][0, 1] for b in bundles) >= 2      # emissions among them
    fresh = engine.new_session()
    for rec, want in zip(session.record, bundles):
        got = fresh.replay_recorded(rec)
        assert got.keys() == want.keys()
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert fresh.mt_tokens == session.mt_tokens and fresh.enc_len == session.enc_len
