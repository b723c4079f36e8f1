"""The port's offline (teacher-forced) StreamSpeech forward against the JAX
package's ``__call__``, fp32 on the CPU, on shared weights (moved by
``weights.load_flax_variables``) and the same numpy-seeded inputs: the whole
model under each mask mode, its modules (masks, offline convolutions, encoder,
the kernel routes of the attention layers), ``entry.py`` and the engine's
device. Tolerance 2e-4, the repo's parity standard
(tests/test_reference_parity.py). The JAX package runs its XLA path (its
Pallas gates are closed on the CPU); the port runs its kernel routes, which
take the plain versions on CPU tensors, and counts them."""

import inspect
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.config import EncoderConfig as JaxEncoderConfig
from streamspeech_tpu.models import conformer as jconf
from streamspeech_tpu.models import layers as jl
from streamspeech_tpu.models.streamspeech import StreamSpeechModel as JaxModel
from streamspeech_tpu.models.streamspeech import ctc_not_blank_probs as jax_nb
from streamspeech_tpu.ops import masks as jmasks
from streamspeech_tpu.ops.pos_encoding import rel_pos_encoding
from streamspeech_tpu.train.synthetic import tiny_config as jax_tiny_config

from streamspeech_tpu_torch import entry as port_entry
from streamspeech_tpu_torch.config import EncoderConfig, tiny_config
from streamspeech_tpu_torch.kernels import attention, policy
from streamspeech_tpu_torch.models import conformer as pconf
from streamspeech_tpu_torch.models import layers as pl_
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.models.streamspeech import ctc_not_blank_probs
from streamspeech_tpu_torch.ops import masks as pmasks
from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine
from streamspeech_tpu_torch.weights import load_flax_variables, random_init_
from tests.jax_init import init_variables, shared_jax_init  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-4
D, H = 32, 2
# T_enc = 256 (1024 fbank frames): the rel-pos route; S = 24 x 25 = 600: the
# unit decoder's causal and bias routes; text vocabulary 512: the not-blank route
TEXT_VOCAB, UPSAMPLE, FRAMES, MT_LEN = 512, 25, 1024, 24
MODES = {
    "ctc": dict(n2=1),
    "waitk": dict(mt_mask_mode="waitk", k1=2, n1=3, k2=1, n2=2),
    "offline": dict(streaming=False, chunk_size=None, conv_chunk_size=None),
}
# kernel routes one tiny forward takes: 2 encoder layers, 1 unit-decoder layer
ROUTES = {
    "ctc": {"relpos": 2, "bias": 1, "masked": 1, "not_blank": 2},
    "waitk": {"relpos": 2, "bias": 1, "masked": 1, "not_blank": 0},
    "offline": {"relpos": 2, "bias": 0, "masked": 1, "not_blank": 0},
}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_vars(v):
    return jax.tree.map(np.asarray, v)


def _close(got, want, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), atol=atol, err_msg=msg)


@pytest.fixture
def route_counts(monkeypatch):
    """Count the calls of the port's four kernel wrappers (on the CPU they
    compute their plain versions), so a parity test cannot pass vacuously."""
    counts = {"relpos": 0, "bias": 0, "masked": 0, "not_blank": 0}

    def counted(module, attr, key):
        real = getattr(module, attr)

        def wrapper(*args, **kwargs):
            counts[key] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(module, attr, wrapper)

    counted(attention, "relpos_attention", "relpos")
    counted(attention, "bias_attention", "bias")
    counted(attention, "masked_attention", "masked")
    counted(policy, "not_blank_probs", "not_blank")
    return counts


@pytest.fixture(scope="module")
def models():
    jmodel = JaxModel(jax_tiny_config(vocab_text=TEXT_VOCAB, upsample=UPSAMPLE))
    variables = init_variables(jmodel)
    rng = np.random.RandomState(11)
    for layer in variables["batch_stats"]["encoder"].values():   # non-trivial BN stats
        bn = layer["conv_module"]["batch_norm"]
        bn["mean"] = (rng.randn(*bn["mean"].shape) * 0.1).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 1.5, bn["var"].shape).astype(np.float32)
    pmodel = load_flax_variables(
        StreamSpeechModel(tiny_config(vocab_text=TEXT_VOCAB, upsample=UPSAMPLE)),
        variables).eval()
    return jmodel, variables, pmodel


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    src = rng.randn(2, FRAMES, 80).astype(np.float32)
    lens = np.array([FRAMES, 800], np.int32)
    mt = rng.randint(4, TEXT_VOCAB, size=(2, MT_LEN)).astype(np.int32)
    mt[:, 0] = 2
    mt[1, 18:] = 1                               # PAD after 18 tokens
    return src, lens, mt


@pytest.mark.parametrize("mode", sorted(MODES))
def test_forward_matches_jax(models, route_counts, mode):
    jmodel, variables, pmodel = models
    src, lens, mt = _inputs()
    want = jax.jit(partial(jmodel.apply, **MODES[mode]))(
        variables, jnp.asarray(src), jnp.asarray(lens), jnp.asarray(mt))
    with torch.no_grad():
        got = pmodel(_t(src), _t(lens).long(), _t(mt).long(), **MODES[mode])
    assert route_counts == ROUTES[mode]
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == tuple(want[key].shape), key
        _close(got[key], want[key], msg=key)


def test_ctc_streaming_mask_matches_jax(models):
    """The forward's CTC-derived MT cross mask, from the same aux-head logits,
    equals JAX's and restricts something (the test is not trivially all-True)."""
    _, _, pmodel = models
    src, lens, mt = _inputs()
    with torch.no_grad():
        out = pmodel(_t(src), _t(lens).long(), _t(mt).long(), n2=1)
    asr, st = out["asr_logits"].numpy(), out["st_logits"].numpy()
    jmask = jmasks.streaming_allowed_from_ctc(jax_nb(jnp.asarray(asr)),
                                              jax_nb(jnp.asarray(st)), MT_LEN, 0, 1, 1, 8)
    pmask = pmasks.streaming_allowed_from_ctc(ctc_not_blank_probs(_t(asr)),
                                              ctc_not_blank_probs(_t(st)), MT_LEN, 0,
                                              1, 1, 8)
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))
    assert 0 < pmask.float().mean() < 1


def test_training_options_raise(models):
    """Dropout in training mode needs an explicit generator (the counterpart
    of flax's dropout rng), checked before anything runs; the mask mode is
    checked too."""
    _, _, pmodel = models
    src, lens, mt = (_t(a).long() if a.dtype != np.float32 else _t(a)
                     for a in _inputs())
    for kw in (dict(deterministic=False), dict(deterministic=False,
                                               use_running_stats=False)):
        with pytest.raises(ValueError, match="torch.Generator"):
            pmodel(src, lens, mt, **kw)
        with pytest.raises(ValueError, match="torch.Generator"):
            pmodel.encode(src, lens, 8, 8, **kw)
    with pytest.raises(ValueError):
        pmodel(src, lens, mt, mt_mask_mode="fixed")


def test_encode_matches_jax(models):
    jmodel, variables, pmodel = models
    src, lens, _ = _inputs(1)
    jenc, jlen = jax.jit(partial(jmodel.apply, chunk_size=4, conv_chunk_size=8,
                                 method=JaxModel.encode))(
        variables, jnp.asarray(src[:, :400]), jnp.asarray(lens // 3))
    with torch.no_grad():
        penc, plen = pmodel.encode(_t(src[:, :400]), _t(lens // 3).long(), 4, 8)
    _close(penc, jenc)
    np.testing.assert_array_equal(plen.numpy(), np.asarray(jlen))


def test_serving_form_of_the_unit_decoder_is_unchanged(models):
    """``synthesize_units`` keeps the serving positions (pe[2] on every row),
    which the training form (pe[2 + b] on row b) differs from at B=2."""
    _, _, pmodel = models
    rng = np.random.RandomState(3)
    enc = _t(rng.randn(2, 5, D).astype(np.float32))
    dec = pmodel.unit_decoder
    with torch.no_grad():
        serving, _ = dec(enc, serving_positions=True)
        row0, _ = dec(enc[:1])
        row1, _ = dec(enc[1:])
        training, _ = dec(enc)
    _close(serving[0], row0[0], atol=0)
    _close(serving[1], row1[0], atol=0)
    assert not torch.allclose(training[1], row1[0])


@pytest.mark.parametrize("args", [(10, 37, 0, 1, 1), (600, 24, 0, 1, 25), (9, 5, 2, 3, 3),
                                  (6, 8, 1, -1, 1), (6, 8, 0, 2, 0), (40, 3, 5, 2, 25)])
def test_waitk_allowed_matches_jax(args):
    np.testing.assert_array_equal(pmasks.waitk_allowed(*args).numpy(),
                                  np.asarray(jmasks.waitk_allowed(*args)))


@pytest.mark.parametrize("seed,chunk,wait,step", [(0, 8, 0, 1), (1, None, 2, 3),
                                                  (2, 4, 1, 2), (3, 8, 0, 1)])
def test_streaming_allowed_from_ctc_matches_jax(seed, chunk, wait, step):
    rng = np.random.RandomState(seed)
    asr = rng.uniform(0, 1, (3, 40)).astype(np.float32)
    st = rng.uniform(0, 1, (3, 40)).astype(np.float32)
    asr[:, ::7] = 0.5                                   # round half to even
    asr[1] = 0.2                                        # never a token: last column
    st[2, :] = 1.0                                      # whole-number cumsum ties
    want = jmasks.streaming_allowed_from_ctc(jnp.asarray(asr), jnp.asarray(st), 12,
                                             wait, step, step, chunk)
    got = pmasks.streaming_allowed_from_ctc(_t(asr), _t(st), 12, wait, step, step, chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _tiny_encoder_cfgs(layers=2):
    kw = dict(embed_dim=D, conv_channels=64, ffn_embed_dim=64, layers=layers,
              attention_heads=H, depthwise_conv_kernel_size=7)
    return JaxEncoderConfig(**kw), EncoderConfig(**kw)


@pytest.mark.parametrize("chunk", [8, None])
def test_convolution_module_offline(chunk):
    rng = np.random.RandomState(4)
    jmod = jl.ConvolutionModule(D, 7)
    jvars = _np_vars(jmod.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, D)), 8))
    jvars["batch_stats"]["batch_norm"]["mean"] = rng.randn(D).astype(np.float32) * .1
    jvars["batch_stats"]["batch_norm"]["var"] = rng.uniform(.5, 1.5, D).astype(np.float32)
    pmod = load_flax_variables(pl_.ConvolutionModule(D, 7), jvars)
    x = rng.randn(2, 37, D).astype(np.float32)
    with torch.no_grad():
        _close(pmod(_t(x), chunk), jmod.apply(jvars, jnp.asarray(x), chunk))


@pytest.mark.parametrize("conv_chunk", [8, None])
def test_conv1d_subsampler_offline(conv_chunk):
    rng = np.random.RandomState(5)
    jcfg, pcfg = _tiny_encoder_cfgs()
    jmod = jconf.Conv1dSubsampler(jcfg)
    jvars = jmod.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 80)), 8)
    pmod = load_flax_variables(pconf.Conv1dSubsampler(pcfg), _np_vars(jvars))
    x = rng.randn(2, 61, 80).astype(np.float32)
    with torch.no_grad():
        _close(pmod(_t(x), conv_chunk), jmod.apply(jvars, jnp.asarray(x), conv_chunk))
    lengths = np.array([61, 60, 7, 1])
    np.testing.assert_array_equal(
        pconf.Conv1dSubsampler.out_length(_t(lengths)).numpy(),
        np.asarray(jconf.Conv1dSubsampler.out_length(jnp.asarray(lengths))))


@pytest.mark.parametrize("t,chunk", [(256, 8), (256, None), (96, 8)])
def test_relpos_attention_offline_route(route_counts, t, chunk):
    """No-cache rel-pos self-attention: at T=256 the kernel route (its plain
    version on the CPU), at T=96 the gather path; both equal JAX."""
    rng = np.random.RandomState(t)
    jmod = jl.RelPosMultiHeadAttention(D, H)
    jvars = jmod.init(jax.random.PRNGKey(2), jnp.zeros((1, 4, D)), jnp.zeros((7, D)))
    pmod = load_flax_variables(pl_.RelPosMultiHeadAttention(D, H), _np_vars(jvars))
    x = rng.randn(2, t, D).astype(np.float32)
    pos_emb = rel_pos_encoding(t, D)
    allowed = None if chunk is None else np.asarray(jmasks.chunk_allowed(t, chunk))
    key_valid = np.arange(t)[None, :] < np.array([[t], [t - 50]])
    want, _ = jmod.apply(jvars, jnp.asarray(x), jnp.asarray(pos_emb),
                         None if allowed is None else jnp.asarray(allowed),
                         jnp.asarray(key_valid))
    with torch.no_grad():
        got, _ = pmod(_t(x), _t(pos_emb), None if allowed is None else _t(allowed),
                      key_valid=_t(key_valid))
    assert route_counts["relpos"] == (1 if t == 256 else 0)
    _close(got, want)


@pytest.mark.parametrize("s", [600, 300])
def test_mha_bias_route(route_counts, s):
    """Cross-attention under the unit decoder's wait-k mask: the bias-kernel
    route at S >= 512 (its plain version on the CPU), the plain path below."""
    rng = np.random.RandomState(s)
    jmod = jl.MultiHeadAttention(D, H)
    jvars = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, D)))
    pmod = load_flax_variables(pl_.MultiHeadAttention(D, H), _np_vars(jvars))
    x = rng.randn(2, s, D).astype(np.float32)
    enc = rng.randn(2, 24, D).astype(np.float32)
    allowed = np.asarray(jmasks.waitk_allowed(s, 24, 0, 1, 25))
    enc_valid = np.arange(24)[None, :] < np.array([[24], [18]])
    want, _ = jmod.apply(jvars, jnp.asarray(x), jnp.asarray(enc), jnp.asarray(allowed),
                         jnp.asarray(enc_valid))
    with torch.no_grad():
        got, _ = pmod(_t(x), _t(enc), _t(allowed), _t(enc_valid))
    assert route_counts["bias"] == (1 if s >= 512 else 0)
    _close(got, want)


def test_encoder_offline_matches_jax(route_counts):
    rng = np.random.RandomState(6)
    jcfg, pcfg = _tiny_encoder_cfgs(layers=1)
    jmod = jconf.ChunkConformerEncoder(jcfg)
    src = rng.randn(2, 1024, 80).astype(np.float32)
    lens = np.array([1024, 700])
    jvars = jax.jit(lambda k: jmod.init(k, jnp.zeros((1, 64, 80)), jnp.array([64]), 8, 8))(
        jax.random.PRNGKey(5))
    pmod = load_flax_variables(pconf.ChunkConformerEncoder(pcfg), _np_vars(jvars))
    want, wlen = jax.jit(lambda v, x, n: jmod.apply(v, x, n, 8, 8))(
        jvars, jnp.asarray(src), jnp.asarray(lens))
    with torch.no_grad():
        got, glen = pmod(_t(src), _t(lens), 8, 8)
    assert route_counts["relpos"] == 1
    _close(got, want)
    np.testing.assert_array_equal(glen.numpy(), np.asarray(wlen))


def test_ctc_not_blank_probs_routes_on_the_gate(route_counts):
    rng = np.random.RandomState(8)
    for t, v in ((64, 512), (63, 512), (64, 511)):
        logits = rng.randn(2, t, v).astype(np.float32) * 3
        _close(ctc_not_blank_probs(_t(logits)), jax_nb(jnp.asarray(logits)), atol=1e-6)
    assert route_counts["not_blank"] == 1


def test_entry_runs_the_forward():
    cfg = tiny_config(vocab_text=TEXT_VOCAB, upsample=UPSAMPLE)
    fn, args = port_entry.entry("cpu", cfg=cfg)
    model, src, lens, mt = args
    units = fn(*args)
    assert tuple(units.shape) == (1, 16 * UPSAMPLE, cfg.unit_decoder.vocab_size)
    assert torch.isfinite(units).all() and not units.requires_grad
    with torch.no_grad():
        want = model(src, lens, mt, chunk_size=8, conv_chunk_size=8, n2=1)
    torch.testing.assert_close(units, want["unit_logits"], rtol=0, atol=0)
    assert inspect.signature(port_entry.entry).parameters["device"].default == "cuda"


def test_engine_serves_on_the_card_by_default(monkeypatch):
    model = random_init_(StreamSpeechModel(tiny_config()), 0)
    assert inspect.signature(StreamSpeechEngine).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamSpeechEngine(model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_entry.entry()
    assert StreamSpeechEngine(model, device="cpu").device == torch.device("cpu")
