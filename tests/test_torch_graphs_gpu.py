"""The fused serving tick's CUDA graphs on a Hopper card, at a small size.

Imports neither jax nor the JAX package, so it runs on a machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_graphs_gpu.py

Elsewhere every test here skips. A tiny model with the unit decoder's
upsampling at 25 (so its causal attention takes the B3 kernel inside the
emission graph) and a narrow vocoder: a part captured at its first use
replays to what the host path computes; a capture leaves the bound
session's state and host mirrors as they were; a fused wave after
``warmup`` equals the host wave instance by instance; ``cond`` in a
captured graph (an IF node) equals its eager body with the predicate true
and false; the overlapped tick's bundles equal the synchronous tick's,
chunk by chunk; the host decode's graph equals the eager decode at B = 1
and B = 8.
"""

import numpy as np
import pytest
import torch

from streamspeech_tpu_torch.agents.base import stream_utterance
from streamspeech_tpu_torch.agents.streamspeech import (
    StreamSpeechAgentConfig,
    StreamSpeechS2STAgent,
)
from streamspeech_tpu_torch.config import tiny_config
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.eval.batched_evaluator import BatchedS2STEvaluator
from streamspeech_tpu_torch.runtime.batched import BatchedStreamingSession
from streamspeech_tpu_torch.kernels import attention
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.models.vocoder import DEFAULT_VOCODER_CFG, CodeGenerator
from streamspeech_tpu_torch.runtime import graphs
from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine
from streamspeech_tpu_torch.weights import doctor_params, random_init_

ATOL = 1e-5


@pytest.fixture(scope="module")
def stack():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = tiny_config(upsample=25)
    model = doctor_params(random_init_(StreamSpeechModel(cfg), 0))
    voc = random_init_(CodeGenerator(dict(DEFAULT_VOCODER_CFG, upsample_initial_channel=32,
                                          num_embeddings=cfg.unit_decoder.vocab_size - 4)), 1)

    def engine():
        return StreamSpeechEngine(model, voc, max_enc_frames=128, max_mt_tokens=32,
                                  mt_buckets=(8, 16, 32), unit_buckets=(128, 256, 512))

    text = Dictionary()
    for i in range(cfg.mt_decoder.vocab_size - 4):
        text.add_symbol("▁w" + str(i))
    units = Dictionary.units(cfg.unit_decoder.vocab_size - 5)
    units.add_blank()
    rng = np.random.RandomState(0)
    sources = [rng.uniform(-0.3, 0.3, n).astype(np.float32) for n in (16000, 23456, 12000)]
    return {"engine": engine, "text": text, "units": units, "sources": sources}


def _agent(stack, engine, use_fused):
    return StreamSpeechS2STAgent(engine, StreamSpeechAgentConfig(), stack["text"],
                                 stack["text"], stack["units"], use_fused=use_fused)


def _serve(agent, samples):
    segs = [np.asarray(seg.content or [], np.float32)
            for seg in stream_utterance(agent, samples)]
    return segs, list(agent.session.mt_tokens), list(agent.units)


@pytest.mark.gpu
def test_parts_captured_at_first_use_replay_the_host_path(stack):
    engine = stack["engine"]()
    fused, host = _agent(stack, engine, True), _agent(stack, engine, False)
    attention.masked_attention.launches = 0
    for samples in stack["sources"]:
        got, want = _serve(fused, samples), _serve(host, samples)
        assert got[1:] == want[1:]
        assert [len(s) for s in got[0]] == [len(s) for s in want[0]]
        for g, w in zip(got[0], want[0]):
            assert np.abs(g - w).max(initial=0.0) <= ATOL
    stats = engine.graphs.stats()
    assert stats["graphs_captured"] >= 3 and stats["graph_replays"] > 0, stats
    assert attention.masked_attention.launches > 0


@pytest.mark.gpu
def test_capture_leaves_the_bound_state_as_it_was(stack):
    engine = stack["engine"]()
    agent = _agent(stack, engine, True)
    run = stream_utterance(agent, stack["sources"][1])
    for _ in range(4):                  # a few fused ticks: the session is bound
        next(run)
    slot = engine.graphs.slots[1]
    before = [t.clone() for t in graphs.state_tensors(slot.state)]
    mirrors = graphs.mirrors(slot.state)
    engine.graphs.capture(slot, ("test", 1), lambda: engine._tick_encode(slot, 32, 8, 8))
    assert graphs.mirrors(slot.state) == mirrors
    for t, b in zip(graphs.state_tensors(slot.state), before):
        assert torch.equal(t, b)


@pytest.mark.gpu
def test_fused_wave_after_warmup_equals_the_host_wave(stack):
    engine = stack["engine"]()
    stats = engine.warmup(8, 8, batch_sizes=(3,))
    assert stats["graphs_captured"] == (2 + len(engine.mt_buckets)
                                        + engine.max_decode_per_call)
    sources = [s.tolist() for s in stack["sources"]]

    def wave(use_fused):
        ev = BatchedS2STEvaluator(engine, StreamSpeechAgentConfig(), stack["text"],
                                  stack["text"], stack["units"], batch=3,
                                  use_fused=use_fused, quality_metrics=[])
        ev(sources, [None] * 3)
        return ev

    host, fused = wave(False), wave(True)
    assert engine.graphs.stats()["graphs_captured"] == stats["graphs_captured"]
    for i, want in host.instances.items():
        got = fused.instances[i]
        assert (got.delays, got.final_mt_tokens, got.final_units) == \
            (want.delays, want.final_mt_tokens, want.final_units), i
        assert (got.stitched is None) == (want.stitched is None), i
        if want.stitched is not None:
            assert got.stitched.shape == want.stitched.shape, i
            assert np.abs(got.stitched - want.stitched).max() <= ATOL, i


@pytest.mark.gpu
def test_cond_in_a_graph_equals_its_eager_body(stack):
    """An IF node: the body runs where the predicate, computed inside the
    graph, holds; the skip value written before it stands elsewhere."""
    engine = stack["engine"]()
    slot = engine.graphs.slot(1)
    x = torch.arange(4.0, device="cuda")
    out = torch.zeros(4, device="cuda")

    def part():
        out.fill_(-1.0)
        graphs.cond(x[0] > 1.5, lambda: out.copy_(torch.exp(x) * 2 + 1))

    for start in (0.0, 3.0, 1.0, 2.0):
        x.copy_(torch.arange(4.0, device="cuda") + start)
        want = torch.exp(x) * 2 + 1 if start > 1.5 else torch.full_like(x, -1.0)
        engine.graphs.run(slot, ("cond test",), part)
        torch.cuda.synchronize()
        assert torch.equal(out, want), start
    assert engine.graphs.stats()["if_nodes"] == 1


@pytest.mark.gpu
def test_pipelined_bundles_equal_the_sync_tick(stack):
    """Four chunks dispatched before any is fetched; each bundle equals the
    synchronous tick's on another engine (the agent's counter recurrences
    applied between its ticks), and B3 counts only where emission ran."""
    piped_engine, sync_engine = stack["engine"](), stack["engine"]()
    piped_engine.warmup(8, 8, pipelined=True)
    sync_engine.warmup(8, 8)            # no capture's eager pass in the counts
    table = np.zeros(piped_engine.model.cfg.mt_decoder.vocab_size, bool)
    feats = np.random.RandomState(3).randn(4 * 32, 80).astype(np.float32)
    piped = piped_engine.new_session()
    piped.pipe_set_counters(0, 0, 0)
    piped.pipe_resync()
    for c in range(4):
        piped.pipe_dispatch(feats[32 * c:32 * (c + 1)], 8, 8, 0, 1, False, 200, table,
                            320.0 * (c + 1), 8)
    assert len(piped.pipe_inflight) == 4
    sync = sync_engine.new_session()
    counters, emitted, b3 = (0, 0, 0), 0, {"piped": 0, "sync": 0}

    def counted(name, fn):
        before = attention.masked_attention.launches
        out = fn()
        b3[name] += attention.masked_attention.launches - before
        return out

    for c in range(4):
        got = counted("piped", piped.pipe_fetch_oldest)
        want = counted("sync", lambda: sync.fused_policy(
            feats[32 * c:32 * (c + 1)], 8, 8, 0, 1, False, 200, table, *counters))
        for name in ("do_decode", "do_emit", "ok", "budget_over", "hit_eos", "grew", "keep",
                     "asr_count", "st_count", "count"):
            assert got[name] == want[name], (c, name)
        if want["do_emit"]:
            emitted += 1
            assert got["units"] == want["units"], c
            assert np.array_equal(got["dur"], want["dur"]), c
            assert np.abs(got["tail"] - want["tail"]).max(initial=0.0) <= ATOL, c
        assert piped.mt_tokens == sync.mt_tokens, c
        src, tgt, units = counters
        if want["grew"]:
            src, tgt = max(want["asr_count"], src), max(want["st_count"], tgt)
        if want["do_emit"] and want["ok"] and want["count"] > units:
            units = want["count"]
        counters = (src, tgt, units)
    assert emitted >= 1, "vacuous: no chunk emitted"
    # B3 inside the emission bodies, counted from the fetched flags: as many
    # as the synchronous tick's emission graphs launched (the same buckets)
    assert b3["piped"] == b3["sync"] > 0, b3


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1, 8])
def test_decode_graph_equals_the_eager_decode(stack, batch):
    engine = stack["engine"]()
    session = BatchedStreamingSession(engine, batch)
    feats = np.random.RandomState(4).randn(64, 80).astype(np.float32)
    for i in range(batch):
        session.push_features(i, feats[:32 + 4 * i], finished=True)
    session.encode_ready_blocks(8, 8)
    hyps = [[4 + i] * i for i in range(batch)]
    budgets = np.asarray([1 + (5 * i) % 9 for i in range(batch)])
    cross_valid = np.arange(engine.max_enc_frames)[None] < \
        np.asarray(session.enc_len)[:, None]
    _, _, mt_self, mt_cross = graphs.clone_state(graphs.state_of(session))
    toks, hit_eos = engine.mt_decode_greedy(session.mt_self, session.mt_cross, hyps, budgets,
                                            cross_valid, session=session)
    dev = torch.device("cuda")
    first = torch.tensor([t[-1] if t else 2 for t in hyps], device=dev)
    offset = torch.tensor([len(t) for t in hyps], device=dev)
    w_toks, w_emitted, w_eos = engine.model.mt_decode_greedy(
        first, offset, torch.as_tensor(budgets, device=dev), mt_self, mt_cross,
        int(budgets.max()), torch.as_tensor(cross_valid, device=dev))
    w_toks, w_emitted = w_toks.cpu().numpy(), w_emitted.cpu().numpy()
    assert toks == [w_toks[i, :w_emitted[i]].tolist() for i in range(batch)]
    assert np.array_equal(hit_eos, w_eos.cpu().numpy())
    assert any(toks), "vacuous: nothing decoded"
