"""The port's bf16 model against the JAX package's bf16 model, on the CPU.

``StreamSpeechModel(cfg, dtype=torch.bfloat16)`` and the JAX
``StreamSpeechModel(cfg, dtype=jnp.bfloat16)`` take the same float32 weights
(``weights.load_flax_variables``, unchanged) and the same numpy-seeded inputs:
the offline forward at the kernel routes' shapes (T_enc 256, unit T 600, text
vocabulary 512, as ``tests/test_torch_forward.py``), ``encode_block``, two MT
decoder steps against the engine's caches and ``synthesize_units``. Then one
whole utterance through the port's bf16 agent.

Tolerance, tied to bf16's own drift: XLA may keep fp32 between the ops of a
fusion where torch rounds every op to bf16, so the two bf16 models round at
different places. For each float output, the port's distance from JAX bf16 is
at most 2x the JAX bf16 model's own distance from the JAX fp32 model on the
same inputs; distance is the RMS of the difference. Measured ratios (RMS; max
abs beside): forward unit logits 1.14 (1.25), MT logits 0.94 (0.85), MT
features 0.94 (1.22), ASR and ST logits 0.98 (1.05, 1.23), encoder 0.98
(0.90); ``encode_block`` 0.99; the MT steps and ``synthesize_units`` 0 (equal
to JAX bf16 bit for bit). Discrete outputs: the CTC streaming mask and the teacher-forced MT
argmax tokens agree in at least 99 % of places (measured 100 % and 100 %).
The unit argmax over 24 classes agrees in 98.6 % of places: 17 of 1200
differ, and at each of them JAX bf16's top two logits lie at most one bf16
ulp of the top logit apart (3 exact ties), as JAX bf16's own 14 flips
against JAX fp32 do. It is held where that margin exceeds TIE_ULPS ulps:
100 % agreement there, with at most 5 % of places left out (measured 2.4 %).
About 45 worker-seconds, most of it JAX's compiles.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.models.layers import KVCache as JaxKVCache
from streamspeech_tpu.models.streamspeech import StreamSpeechModel as JaxModel
from streamspeech_tpu.models.streamspeech import ctc_not_blank_probs as jax_nb
from streamspeech_tpu.ops import masks as jmasks
from streamspeech_tpu.train.synthetic import tiny_config as jax_tiny_config

from streamspeech_tpu_torch.config import tiny_config
from streamspeech_tpu_torch.kernels import attention, policy
from streamspeech_tpu_torch.models.layers import KVCache
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.models.streamspeech import ctc_not_blank_probs
from streamspeech_tpu_torch.ops import masks as pmasks
from streamspeech_tpu_torch.weights import load_flax_variables
from tests.jax_init import init_variables, shared_jax_init  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

DRIFT_FACTOR = 2.0
AGREEMENT = 0.99
TIE_ULPS = 2           # a unit argmax within this many bf16 ulps of a tie
TIE_SHARE = 0.05       # places that may be that close
TEXT_VOCAB, UPSAMPLE, FRAMES, MT_LEN = 512, 25, 1024, 24
FLOAT_OUTPUTS = ("unit_logits", "mt_logits", "mt_features", "asr_logits", "st_logits",
                 "encoder_out")




def _rms(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)))


def _f32(x) -> np.ndarray:
    return (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(jnp.asarray(x, jnp.float32)))


def _assert_drift(port16, jax16, jax32, name):
    """The port's RMS distance from JAX bf16 within DRIFT_FACTOR of JAX bf16's
    own from JAX fp32 (which must be above 0: the bf16 model is not fp32)."""
    own = _rms(_f32(jax16), _f32(jax32))
    got = _rms(_f32(port16), _f32(jax16))
    assert own > 0, f"{name}: the JAX bf16 model equals its fp32 one"
    assert got <= DRIFT_FACTOR * own, f"{name}: port {got} > {DRIFT_FACTOR} x JAX's {own}"


@pytest.fixture(scope="module")
def models():
    cfg = jax_tiny_config(vocab_text=TEXT_VOCAB, upsample=UPSAMPLE)
    j32, j16 = JaxModel(cfg), JaxModel(cfg, dtype=jnp.bfloat16)
    variables = init_variables(j32)
    rng = np.random.RandomState(11)
    for layer in variables["batch_stats"]["encoder"].values():   # non-trivial BN stats
        bn = layer["conv_module"]["batch_norm"]
        bn["mean"] = (rng.randn(*bn["mean"].shape) * 0.1).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    p16 = load_flax_variables(StreamSpeechModel(tiny_config(TEXT_VOCAB, upsample=UPSAMPLE),
                                                dtype=torch.bfloat16), variables).eval()
    return {"j32": j32, "j16": j16, "variables": variables, "p16": p16}


@pytest.fixture(scope="module")
def forwards(models):
    """The offline forward (CTC streaming mask, n2=1) of both JAX models and
    of the port's bf16 model, and the port's bf16 kernel-route calls."""
    rng = np.random.RandomState(0)
    src = rng.randn(2, FRAMES, 80).astype(np.float32)
    lens = np.array([FRAMES, 800], np.int32)
    mt = rng.randint(4, TEXT_VOCAB, size=(2, MT_LEN)).astype(np.int32)
    mt[:, 0] = 2
    mt[1, 18:] = 1                               # PAD after 18 tokens
    out = {}
    for name in ("j32", "j16"):
        model = models[name]
        out[name] = jax.jit(lambda v, s, l, t: model.apply(v, s, l, t, n2=1))(
            models["variables"], src, lens, mt)
    routes = {"masked": 0, "bias": 0, "not_blank": 0}
    wrapped = {}

    def counting(module, attr, key):
        real = getattr(module, attr)

        def wrapper(x, *args, **kwargs):
            routes[key] += x.dtype == torch.bfloat16
            return real(x, *args, **kwargs)
        wrapped[module, attr] = real
        setattr(module, attr, wrapper)

    counting(attention, "masked_attention", "masked")
    counting(attention, "bias_attention", "bias")
    counting(policy, "not_blank_probs", "not_blank")
    try:
        with torch.no_grad():
            out["p16"] = models["p16"](torch.from_numpy(src), torch.from_numpy(lens).long(),
                                       torch.from_numpy(mt).long(), n2=1)
    finally:
        for (module, attr), real in wrapped.items():
            setattr(module, attr, real)
    return out, routes


def test_bf16_forward_within_twice_jax_drift(forwards):
    out, routes = forwards
    # the unit decoder's causal and bias routes and both aux heads' not-blank
    # route took bf16 inputs (their plain bf16 versions here)
    assert routes == {"masked": 1, "bias": 1, "not_blank": 2}
    for key in FLOAT_OUTPUTS:
        assert out["p16"][key].dtype == torch.bfloat16, key
        assert tuple(out["p16"][key].shape) == tuple(out["j16"][key].shape), key
        _assert_drift(out["p16"][key], out["j16"][key], out["j32"][key], key)


def test_bf16_forward_discrete_outputs_agree(forwards):
    out, _ = forwards
    jmask = np.asarray(jmasks.streaming_allowed_from_ctc(
        jax_nb(out["j16"]["asr_logits"]), jax_nb(out["j16"]["st_logits"]), MT_LEN, 0, 1, 1, 8))
    pmask = pmasks.streaming_allowed_from_ctc(
        ctc_not_blank_probs(out["p16"]["asr_logits"]),
        ctc_not_blank_probs(out["p16"]["st_logits"]), MT_LEN, 0, 1, 1, 8).numpy()
    assert 0 < pmask.mean() < 1
    assert (pmask == jmask).mean() >= AGREEMENT
    mt_port, mt_jax = (_f32(out[n]["mt_logits"]).argmax(-1) for n in ("p16", "j16"))
    assert (mt_port == mt_jax).mean() >= AGREEMENT
    port, ref = _f32(out["p16"]["unit_logits"]), _f32(out["j16"]["unit_logits"])
    top2 = np.sort(ref, -1)[..., -2:]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[..., 1]))) - 7)   # bf16: 8 bits
    held = top2[..., 1] - top2[..., 0] > TIE_ULPS * ulp
    assert 1 - held.mean() <= TIE_SHARE, f"{1 - held.mean():.3f} of unit argmaxes near a tie"
    assert (port.argmax(-1) == ref.argmax(-1))[held].all()


def test_bf16_encode_block_within_twice_jax_drift(models):
    """Three blocks of 32 fbank frames (chunk 8) through the streaming encoder
    against its caches: the JAX model's state in its dtype, the port's too."""
    feats = np.random.RandomState(4).randn(96, 80).astype(np.float32)
    encs = {}
    for name in ("j32", "j16"):
        model = models[name]
        state = model.apply(models["variables"], 1, 64, method=JaxModel.encoder_stream_init)
        step = jax.jit(lambda v, b, s: model.apply(v, b, s, 8, 8,
                                                   method=JaxModel.encode_block_with_ctc))
        outs = []
        for i in range(3):
            enc, state, _, _ = step(models["variables"], feats[None, 32 * i:32 * (i + 1)],
                                    state)
            outs.append(np.asarray(jnp.asarray(enc, jnp.float32)))
        encs[name] = np.concatenate(outs, axis=1)
    p16 = models["p16"]
    state = p16.encoder_stream_init(1, 64, "cpu")
    outs = []
    with torch.no_grad():
        for i in range(3):
            enc, state, _, _ = p16.encode_block_with_ctc(
                torch.from_numpy(feats[None, 32 * i:32 * (i + 1)]), state, 8, 8)
            assert enc.dtype == torch.bfloat16 and state.kv[0].k.dtype == torch.bfloat16
            outs.append(enc.float().numpy())
    _assert_drift(np.concatenate(outs, axis=1), encs["j16"], encs["j32"], "encode_block")


def _enc(seed=5, frames=40):
    """Encoder frames as a bf16 encoder would write them into the engine's
    float32 buffer."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(1, frames, 32).astype(np.float32))
    return x.bfloat16().float().numpy()


def test_bf16_mt_decoder_steps_within_twice_jax_drift(models):
    """Two greedy-decoder steps (tokens EOS, then 7) against cross caches
    filled from 40 encoder frames; the caches are float32, as both engines
    make them."""
    enc, h, dh, layers = _enc(), 2, 16, 2
    logits = {}
    for name in ("j32", "j16"):
        model, v = models[name], models["variables"]
        cross = model.apply(v, enc, [JaxKVCache.create(1, 64, h, dh) for _ in range(layers)],
                            method=JaxModel.mt_fill_cross)
        caches = [JaxKVCache.create(1, 16, h, dh) for _ in range(layers)]
        steps = []
        for offset, token in enumerate((2, 7)):
            out, _, caches = model.apply(v, jnp.asarray([[token]], jnp.int32), offset, caches,
                                         cross, method=JaxModel.mt_decoder_step)
            steps.append(np.asarray(jnp.asarray(out, jnp.float32)))
        logits[name] = np.concatenate(steps, axis=1)
    p16 = models["p16"]
    cross = p16.mt_fill_cross(torch.from_numpy(enc),
                              [KVCache.create(1, 64, h, dh, "cpu") for _ in range(layers)])
    caches = [KVCache.create(1, 16, h, dh, "cpu") for _ in range(layers)]
    steps = []
    with torch.no_grad():
        for offset, token in enumerate((2, 7)):
            out, _ = p16.mt_decoder.step(torch.tensor([[token]]), offset, caches, cross)
            assert out.dtype == torch.bfloat16
            steps.append(out.float().numpy())
    _assert_drift(np.concatenate(steps, axis=1), logits["j16"], logits["j32"], "mt steps")


def test_bf16_synthesize_units_within_twice_jax_drift(models):
    """The emission path: MT features over a 16-token bucket (PAD after 11)
    against 40 valid frames of a 64-frame buffer, the T2U encoder and the unit
    decoder's serving form (T = 400: the causal route, no bias route)."""
    enc = np.zeros((1, 64, 32), np.float32)
    enc[:, :40] = _enc()
    tokens = np.full((1, 16), 1, np.int32)
    tokens[0, :11] = [2] + list(range(40, 50))
    logits = {}
    for name in ("j32", "j16"):
        model = models[name]
        _, out = model.apply(models["variables"], tokens, enc, 40,
                             method=JaxModel.synthesize_units)
        logits[name] = np.asarray(jnp.asarray(out, jnp.float32))
    with torch.no_grad():
        _, got = models["p16"].synthesize_units(torch.from_numpy(tokens).long(),
                                                torch.from_numpy(enc), torch.tensor([40]))
    assert got.dtype == torch.bfloat16
    _assert_drift(got, logits["j16"], logits["j32"], "synthesize_units")


def test_bf16_utterance_through_the_port_agent():
    """A doctored bf16 tiny model serves a whole utterance on the CPU: the
    agent writes, the units are speech codes, the wav is finite; the vocoder
    stays float32."""
    from streamspeech_tpu_torch.agents.base import stream_utterance
    from streamspeech_tpu_torch.agents.streamspeech import (
        StreamSpeechAgentConfig,
        StreamSpeechS2STAgent,
    )
    from streamspeech_tpu_torch.dictionary import Dictionary
    from streamspeech_tpu_torch.models.vocoder import CodeGenerator
    from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine
    from streamspeech_tpu_torch.weights import doctor_params, random_init_
    from tests.test_vocoder import tiny_cfg as tiny_vocoder_cfg

    cfg = tiny_config()
    model = doctor_params(random_init_(StreamSpeechModel(cfg, dtype=torch.bfloat16), 0))
    voc_cfg = tiny_vocoder_cfg()
    voc_cfg["num_embeddings"] = cfg.unit_decoder.vocab_size - 4
    vocoder = random_init_(CodeGenerator(voc_cfg), 1)
    engine = StreamSpeechEngine(model, vocoder, device="cpu", max_enc_frames=128,
                                max_mt_tokens=32, mt_buckets=(8, 16, 32),
                                unit_buckets=(16, 32, 64))
    text = Dictionary()
    for i in range(cfg.mt_decoder.vocab_size - 4):
        text.add_symbol("▁w" + str(i))
    units = Dictionary.units(cfg.unit_decoder.vocab_size - 5)
    units.add_blank()
    agent = StreamSpeechS2STAgent(engine, StreamSpeechAgentConfig(), text, text, units)
    samples = np.random.RandomState(5).uniform(-0.3, 0.3, 19200)
    wav, writes = [], 0
    for out in stream_utterance(agent, samples):
        if not out.is_empty:
            writes += 1
            wav.extend(out.content)
    assert writes > 0 and len(agent.units) > 0 and len(agent.session.mt_tokens) > 0
    assert {p.dtype for p in engine.vocoder.parameters()} == {torch.float32}
    assert len(wav) > 0 and np.isfinite(wav).all()


def test_engine_cast_of_the_weights_changes_no_output():
    """``cast_compute_weights_`` (the serving engine's one-time cast) stores
    the Dense and convolution weights in bf16 and leaves the norms and the
    embedding tables float32: the offline forward is equal bit for bit."""
    from streamspeech_tpu_torch.models.layers import (
        ChunkCausalConv,
        Dense,
        LayerNorm,
        cast_compute_weights_,
    )
    from streamspeech_tpu_torch.weights import random_init_

    model = random_init_(StreamSpeechModel(tiny_config(), dtype=torch.bfloat16), 3).eval()
    rng = np.random.RandomState(6)
    src = torch.from_numpy(rng.randn(1, 64, 80).astype(np.float32))
    mt = torch.tensor([[2, 9, 10, 11, 12]])
    with torch.no_grad():
        before = model(src, torch.tensor([64]), mt, n2=1)
        cast_compute_weights_(model)
        after = model(src, torch.tensor([64]), mt, n2=1)
    for m in model.modules():
        if isinstance(m, (Dense, ChunkCausalConv)):
            assert m.weight.dtype == torch.bfloat16
        elif isinstance(m, LayerNorm):
            assert m.weight.dtype == torch.float32
    assert model.mt_decoder.embed_tokens.dtype == torch.float32
    assert before.keys() == after.keys()
    for key in before:
        assert torch.equal(before[key], after[key]), key
