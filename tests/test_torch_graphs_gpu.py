"""The fused serving tick's CUDA graphs on a Hopper card, at a small size.

Imports neither jax nor the JAX package, so it runs on a machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_graphs_gpu.py

Elsewhere every test here skips. A tiny model with the unit decoder's
upsampling at 25 (so its causal attention takes the B3 kernel inside the
emission graph) and a narrow vocoder: a part captured at its first use
replays to what the host path computes; a capture leaves the bound
session's state and host mirrors as they were; a fused wave after
``warmup`` equals the host wave instance by instance.
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
    assert stats["graphs_captured"] == 2 + len(engine.mt_buckets)
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
