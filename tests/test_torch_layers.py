"""Module parity of the port's serving-path building blocks against the JAX
package, fp32 on the CPU, same numpy-seeded inputs, weights moved by
``streamspeech_tpu_torch.weights``. Tolerance 2e-4, the repo's parity standard
(tests/test_reference_parity.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.config import EncoderConfig as JaxEncoderConfig
from streamspeech_tpu.models import conformer as jconf
from streamspeech_tpu.models import layers as jl
from streamspeech_tpu.ops import masks as jmasks
from streamspeech_tpu.ops import pallas_attention as jpa
from streamspeech_tpu.ops.cmvn import GlobalCMVN as JaxGlobalCMVN
from streamspeech_tpu.ops.conv1d import conv1d as jax_conv1d
from streamspeech_tpu.ops.conv1d import conv_transpose1d as jax_conv_transpose1d
from streamspeech_tpu.ops.ctc import ctc_collapse as jax_ctc_collapse
from streamspeech_tpu.ops.ctc import ctc_collapse_device as jax_ctc_collapse_device
from streamspeech_tpu.ops.fbank import OnlineFbank as JaxOnlineFbank
from streamspeech_tpu.ops.fbank import logmelfbank as jax_logmelfbank
from streamspeech_tpu.ops.pos_encoding import rel_pos_encoding

from streamspeech_tpu_torch.config import EncoderConfig
from streamspeech_tpu_torch.kernels import attention as port_attention
from streamspeech_tpu_torch.models import conformer as pconf
from streamspeech_tpu_torch.models import layers as pl_
from streamspeech_tpu_torch.ops import conv1d as pconv
from streamspeech_tpu_torch.ops import ctc as pctc
from streamspeech_tpu_torch.ops import fbank as pfbank
from streamspeech_tpu_torch.ops import masks as pmasks
from streamspeech_tpu_torch.ops.cmvn import GlobalCMVN
from streamspeech_tpu_torch.weights import load_flax_variables
from tests.torch_threads import one_torch_thread  # noqa: F401

ATOL = 2e-4
D, H = 32, 2


def _np_vars(v):
    return jax.tree.map(np.asarray, v)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), atol=atol)


@pytest.fixture(scope="module")
def mha():
    rng = np.random.RandomState(0)
    jmod = jl.MultiHeadAttention(D, H)
    jvars = jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, D)))
    pmod = load_flax_variables(pl_.MultiHeadAttention(D, H), _np_vars(jvars))
    return jmod, jvars, pmod, rng


def test_mha_cached_self_attention_with_truncate(mha):
    jmod, jvars, pmod, rng = mha
    jcache = jl.KVCache.create(1, 16, H, D // H)
    pcache = pl_.KVCache.create(1, 16, H, D // H, "cpu")
    for step, s in enumerate([3, 2, "truncate", 1, 4]):
        if s == "truncate":
            jcache = jcache.truncate(jnp.int32(4))
            pcache.truncate(4)
            assert pcache.index == int(jcache.index) == 4
            continue
        x = rng.randn(1, s, D).astype(np.float32)
        jout, jcache = jmod.apply(jvars, jnp.asarray(x), None, None, None, jcache)
        with torch.no_grad():
            pout, pcache = pmod(_t(x), cache=pcache)
        _close(pout, jout)
        assert pcache.index == int(jcache.index)


def test_kv_cache_raises_where_jax_would_clamp():
    cache = pl_.KVCache.create(1, 4, H, D // H, "cpu")
    cache.append(torch.zeros(1, 3, H, D // H), torch.zeros(1, 3, H, D // H))
    with pytest.raises(ValueError):
        cache.append(torch.zeros(1, 2, H, D // H), torch.zeros(1, 2, H, D // H))


def test_mha_cached_cross_attention(mha):
    jmod, jvars, pmod, rng = mha
    jcache = jl.KVCache.create(1, 16, H, D // H)
    pcache = pl_.KVCache.create(1, 16, H, D // H, "cpu")
    for n in (6, 4):   # the encoder grows by blocks
        enc = rng.randn(1, n, D).astype(np.float32)
        jcache = jmod.apply(jvars, jnp.asarray(enc), jcache,
                            method=jl.MultiHeadAttention.fill_cross_cache)
        with torch.no_grad():
            pmod.fill_cross_cache(_t(enc), pcache)
        x = rng.randn(1, 2, D).astype(np.float32)
        jout, _ = jmod.apply(jvars, jnp.asarray(x), None, None, None, jcache,
                             cache_is_cross=True)
        with torch.no_grad():
            pout, _ = pmod(_t(x), cache=pcache, cache_is_cross=True)
        _close(pout, jout)


def test_mha_causal_kernel_route_t300(mha, monkeypatch):
    """No-cache causal self-attention at T=300: the port pads to 384 and takes
    the masked-attention kernel's route (its plain version on the CPU); JAX is
    forced onto its Pallas route in interpret mode (tests/test_forced_pallas.py)
    and also run on its XLA path."""
    jmod, jvars, pmod, rng = mha
    x = rng.randn(2, 300, D).astype(np.float32)
    key_valid = np.arange(300)[None, :] < np.array([[300], [250]])
    jxla, _ = jmod.apply(jvars, jnp.asarray(x), None, None, jnp.asarray(key_valid),
                         causal=True)
    monkeypatch.setattr(jl, "_masked_pallas_ok", lambda t, dh: True)
    monkeypatch.setattr(jpa._relpos_bwd, "interpret", True)
    jker, _ = jmod.apply(jvars, jnp.asarray(x), None, None, jnp.asarray(key_valid),
                         causal=True)
    calls = []
    real = port_attention.masked_attention
    monkeypatch.setattr(port_attention, "masked_attention",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    with torch.no_grad():
        pout, _ = pmod(_t(x), key_valid=_t(key_valid), causal=True)
    assert calls == [(2, H, 384, D // H)], "kernel route not taken"
    _close(pout, jker)
    _close(pout, jxla)


def test_relpos_attention_cached_q_offset():
    rng = np.random.RandomState(1)
    jmod = jl.RelPosMultiHeadAttention(D, H)
    jvars = jmod.init(jax.random.PRNGKey(2), jnp.zeros((1, 4, D)),
                      jnp.zeros((7, D)))
    pmod = load_flax_variables(pl_.RelPosMultiHeadAttention(D, H), _np_vars(jvars))
    max_frames, s, chunk = 16, 4, 4
    table = rel_pos_encoding(max_frames + s, D)
    jcache = jl.KVCache.create(1, max_frames, H, D // H)
    pcache = pl_.KVCache.create(1, max_frames, H, D // H, "cpu")
    for pos in (0, 4, 8):
        start = max_frames - pos
        pos_emb = table[start:start + s + max_frames]
        q_abs = pos + np.arange(s)[:, None]
        allowed = np.arange(max_frames)[None, :] < (q_abs // chunk + 1) * chunk
        x = rng.randn(1, s, D).astype(np.float32)
        jout, jcache = jmod.apply(jvars, jnp.asarray(x), jnp.asarray(pos_emb),
                                  jnp.asarray(allowed), None, jcache, q_offset=pos)
        with torch.no_grad():
            pout, pcache = pmod(_t(x), _t(pos_emb), _t(allowed), pcache, pos)
        _close(pout, jout)


def test_convolution_module_step():
    rng = np.random.RandomState(3)
    jmod = jl.ConvolutionModule(D, 7)
    jvars = _np_vars(jmod.init(jax.random.PRNGKey(3), jnp.zeros((1, 8, D)), 8))
    jvars["batch_stats"]["batch_norm"]["mean"] = rng.randn(D).astype(np.float32) * .1
    jvars["batch_stats"]["batch_norm"]["var"] = rng.uniform(.5, 1.5, D).astype(np.float32)
    pmod = load_flax_variables(pl_.ConvolutionModule(D, 7), jvars)
    jctx = jnp.zeros((1, 3, D))
    pctx = torch.zeros(1, 3, D)
    for _ in range(3):
        x = rng.randn(1, 8, D).astype(np.float32)
        jy, jctx = jmod.apply(jvars, jnp.asarray(x), jctx, 8,
                              method=jl.ConvolutionModule.step)
        with torch.no_grad():
            py, pctx = pmod.step(_t(x), pctx, 8)
        _close(py, jy)
        _close(pctx, jctx)


@pytest.mark.parametrize("depthwise,stride,chunk", [(False, 2, 8), (False, 1, None),
                                                   (True, 1, 4), (True, 1, None)])
def test_chunk_causal_conv1d_offline(depthwise, stride, chunk):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 24, 6).astype(np.float32)
    w = rng.randn(5, 6).astype(np.float32) if depthwise else \
        rng.randn(5, 6, 4).astype(np.float32)
    b = rng.randn(w.shape[-1]).astype(np.float32)
    want = jl.chunk_causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                  stride, chunk, depthwise)
    pw = w.T[:, None, :] if depthwise else w.transpose(2, 1, 0)
    got = pl_.chunk_causal_conv1d(_t(x), _t(pw), _t(b), stride, chunk, depthwise)
    _close(got, want, atol=1e-4)


def _tiny_encoder_cfgs():
    kw = dict(embed_dim=D, conv_channels=64, ffn_embed_dim=64, layers=2,
              attention_heads=H, depthwise_conv_kernel_size=7)
    return JaxEncoderConfig(**kw), EncoderConfig(**kw)


def test_conv1d_subsampler_step_with_tail():
    rng = np.random.RandomState(4)
    jcfg, pcfg = _tiny_encoder_cfgs()
    jmod = jconf.Conv1dSubsampler(jcfg)
    jvars = jmod.init(jax.random.PRNGKey(4), jnp.zeros((1, 32, 80)), 8)
    pmod = load_flax_variables(pconf.Conv1dSubsampler(pcfg), _np_vars(jvars))
    jctx = (jnp.zeros((1, 2, 80)), jnp.zeros((1, 2, 32)))
    pctx = [torch.zeros(1, 2, 80), torch.zeros(1, 2, 32)]
    for n, valid in ((32, None), (32, None), (12, 10)):
        x = rng.randn(1, n, 80).astype(np.float32)
        if valid is not None:
            x[:, valid:] = 0.0
        jy, jctx = jmod.apply(jvars, jnp.asarray(x), jctx, 8,
                              None if valid is None else jnp.int32(valid),
                              method=jconf.Conv1dSubsampler.step)
        with torch.no_grad():
            py, pctx = pmod.step(_t(x), pctx, 8, valid)
        _close(py, jy)


@pytest.mark.parametrize("stride,padding,transpose", [(1, 3, False), (2, 1, False),
                                                      (4, 2, True), (5, 3, True)])
def test_conv1d_layouts(stride, padding, transpose):
    """The bridge's layout rule: JAX [K, Cin, Cout] → torch [Cout, Cin, K], and
    transpose-conv → [Cin, Cout, K] with no flip."""
    rng = np.random.RandomState(stride)
    x = rng.randn(2, 13, 6).astype(np.float32)
    w = rng.randn(8, 6, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    if transpose:
        want = jax_conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    stride=stride, padding=padding)
        got = pconv.conv_transpose1d(_t(x), _t(w.transpose(1, 2, 0)), _t(b),
                                     stride=stride, padding=padding)
    else:
        want = jax_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          stride=stride, padding=padding)
        got = pconv.conv1d(_t(x), _t(w.transpose(2, 1, 0)), _t(b), stride=stride,
                           padding=padding)
    _close(got, want, atol=1e-4)


def test_masks_match():
    lengths = np.array([5, 9, 0])
    np.testing.assert_array_equal(
        pmasks.lengths_to_mask(_t(lengths), 9).numpy(),
        np.asarray(jmasks.lengths_to_mask(jnp.asarray(lengths), 9)))
    np.testing.assert_array_equal(pmasks.causal_allowed(7).numpy(),
                                  np.asarray(jmasks.causal_allowed(7)))
    np.testing.assert_array_equal(pmasks.chunk_allowed(13, 4).numpy(),
                                  np.asarray(jmasks.chunk_allowed(13, 4)))
    allowed = np.asarray(jmasks.chunk_allowed(6, 2))
    kv = np.arange(6)[None, :] < np.array([[6], [3]])
    np.testing.assert_array_equal(
        pmasks.mask_to_bias(_t(allowed), _t(kv)).numpy(),
        np.asarray(jl.mask_to_bias(jnp.asarray(allowed), jnp.asarray(kv))))


def test_fbank_and_online_fbank():
    rng = np.random.RandomState(5)
    wav = (0.3 * np.sin(2 * np.pi * 440 * np.arange(16000) / 16000)
           + 0.05 * rng.randn(16000)).astype(np.float32)
    # log-mel values are O(10); fp32 FFTs of two libraries agree to ~1e-5 relative
    np.testing.assert_allclose(pfbank.logmelfbank(wav),
                               np.asarray(jax_logmelfbank(jnp.asarray(wav))),
                               rtol=1e-4, atol=ATOL)
    jon, pon = JaxOnlineFbank(), pfbank.OnlineFbank()
    jf, pf = [], []
    for n in (3000, 5120, 100, 7000, 780):
        piece, wav = wav[:n], wav[n:]
        jf.append(jon.push(piece))
        pf.append(pon.push(piece))
        assert pf[-1].shape == jf[-1].shape
    np.testing.assert_allclose(np.concatenate(pf), np.concatenate(jf), rtol=1e-4,
                               atol=ATOL)


def test_global_cmvn():
    rng = np.random.RandomState(6)
    mean, std = rng.randn(80), rng.uniform(0.5, 2, 80)
    x = rng.randn(7, 80).astype(np.float32)
    np.testing.assert_allclose(GlobalCMVN(mean, std)(x),
                               JaxGlobalCMVN(mean, std)(x), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ctc_collapse_host_and_device(seed):
    rng = np.random.RandomState(seed)
    ids = rng.choice([0, 0, 0, 3, 3, 5, 7, 1], size=40).astype(np.int64)
    assert pctc.ctc_collapse(ids, blank=0) == jax_ctc_collapse(ids, blank=0)
    assert pctc.ctc_collapse(ids, blank=0, pad=1) == jax_ctc_collapse(ids, blank=0,
                                                                     pad=1)
    ptoks, pcount = pctc.ctc_collapse_device(_t(ids), blank=0)
    jtoks, jcount = jax_ctc_collapse_device(jnp.asarray(ids, jnp.int32), blank=0)
    assert int(pcount) == int(jcount)
    np.testing.assert_array_equal(ptoks.numpy(), np.asarray(jtoks))
