"""The offline forward's kernels (rel-pos attention, bias attention, the CTC
not-blank posterior): each plain version against the JAX TPU kernel (Pallas
interpret mode) and its XLA reference on the same numpy-seeded inputs, the
wrappers' input checks, and each route's gate against the JAX gate on a TPU.
The CUDA kernels themselves are held against the plain versions on the card by
tests/test_torch_kernels_gpu.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.models import layers as jax_layers
from streamspeech_tpu.models.streamspeech import ctc_not_blank_probs
from streamspeech_tpu.ops import pallas_attention as jpa
from streamspeech_tpu.ops import pallas_policy as jpp

from streamspeech_tpu_torch.kernels import attention, policy
from streamspeech_tpu_torch.models import layers as port_layers
from streamspeech_tpu_torch.ops.masks import NEG_INF
from tests.torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5     # fp32 both sides; the sums run in a different order
NB_ATOL = 1e-6  # the not-blank posterior (values in [0, 1])


def _t(x):
    return torch.from_numpy(np.array(x))


def _relpos_inputs(b, h, t, d, seed, n_valid, chunk, bias_heads):
    rng = np.random.RandomState(seed)
    qu, qv, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(4))
    p = rng.randn(h, 2 * t - 1, d).astype(np.float32)
    i, j = np.arange(t)[:, None], np.arange(t)[None, :]
    allowed = (j < np.minimum((i // chunk + 1) * chunk, t))[None, None] & \
        (np.arange(t)[None, None, None, :] < np.asarray(n_valid)[:, None, None, None])
    bias = np.repeat(np.where(allowed, 0.0, NEG_INF).astype(np.float32),
                     bias_heads, axis=1)
    return qu, qv, k, v, p, bias


@pytest.mark.parametrize("t,d,bias_heads", [(128, 16, 1), (256, 16, 2), (128, 8, 2)])
def test_relpos_plain_version_matches_jax_kernel(t, d, bias_heads):
    args = _relpos_inputs(2, 2, t, d, seed=t + d, n_valid=[t, t - 37], chunk=8,
                          bias_heads=bias_heads)
    scale = d ** -0.5
    ref_kernel = np.asarray(jpa.relpos_attention(*args, scale=scale, block_q=64,
                                                 interpret=True))
    ref_xla = np.asarray(jpa.relpos_attention_reference(*args, scale))
    got = attention.relpos_attention(*(_t(a) for a in args), scale).numpy()
    np.testing.assert_allclose(got, ref_kernel, atol=ATOL)
    np.testing.assert_allclose(got, ref_xla, atol=ATOL)


def _bias_inputs(b, h, tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k, v = (rng.randn(b, h, tk, d).astype(np.float32) for _ in range(2))
    allowed = np.arange(tk)[None, None, :] < np.minimum(
        np.arange(tq)[None, :, None] // 25 + 1, tk)
    allowed = allowed & (np.arange(tk)[None, None, :]
                         < np.array([tk, tk - 5])[:b, None, None])
    return q, k, v, np.where(allowed, 0.0, NEG_INF).astype(np.float32)


@pytest.mark.parametrize("tq,tk,d", [(600, 24, 16), (128, 128, 8), (200, 7, 24)])
def test_bias_plain_version_matches_jax_kernel(tq, tk, d):
    q, k, v, bias = _bias_inputs(2, 2, tq, tk, d, seed=tq + tk)
    scale = d ** -0.5
    ref_kernel = np.asarray(jpa.bias_attention(q, k, v, bias, scale=scale,
                                               interpret=True))
    ref_xla = np.asarray(jpa.bias_attention_reference(q, k, v, bias, scale))
    got = attention.bias_attention(*(_t(a) for a in (q, k, v, bias)), scale).numpy()
    np.testing.assert_allclose(got, ref_kernel, atol=ATOL)
    np.testing.assert_allclose(got, ref_xla, atol=ATOL)


@pytest.mark.parametrize("shape,blank", [((2, 100, 600), 0), ((3, 64, 512), 7),
                                         ((1, 9, 130), 129)])
def test_not_blank_plain_version_matches_jax_kernel(shape, blank):
    logits = (np.random.RandomState(shape[1]).randn(*shape) * 4).astype(np.float32)
    ref_kernel = np.asarray(jpp.not_blank_probs_pallas(jnp.asarray(logits), blank,
                                                       interpret=True))
    ref_xla = np.asarray(ctc_not_blank_probs(jnp.asarray(logits), blank))
    got = policy.not_blank_probs(_t(logits), blank).numpy()
    np.testing.assert_allclose(got, ref_kernel, atol=NB_ATOL)
    np.testing.assert_allclose(got, ref_xla, atol=NB_ATOL)


def test_not_blank_gives_no_gradient():
    logits = torch.randn(1, 70, 512, requires_grad=True)
    assert not policy.not_blank_probs(logits).requires_grad


def test_wrappers_reject_what_the_kernels_cannot_take():
    q = torch.zeros(1, 2, 128, 16)
    p = torch.zeros(2, 255, 16)
    bias = torch.zeros(1, 1, 128, 128)
    attention._check_relpos(q, q, q, q, p, bias)
    with pytest.raises(ValueError):                                   # short table
        attention._check_relpos(q, q, q, q, p[:, :254], bias)
    with pytest.raises(ValueError):                                   # bias heads
        attention._check_relpos(q, q, q, q, p, torch.zeros(1, 3, 128, 128))
    with pytest.raises(ValueError):                                   # T % 64
        attention._check_relpos(*(x[:, :, :100] for x in (q, q, q, q)), p[:, :199],
                                bias[..., :100, :100])
    with pytest.raises(ValueError):                                   # head dim
        odd = torch.zeros(1, 2, 128, 12)
        attention._check_relpos(odd, odd, odd, odd, torch.zeros(2, 255, 12), bias)
    k = torch.zeros(1, 2, 24, 16)
    attention._check_bias(q, k, k, torch.zeros(1, 128, 24))
    with pytest.raises(ValueError):                                   # bias shape
        attention._check_bias(q, k, k, torch.zeros(1, 1, 128, 24))
    with pytest.raises(ValueError):                                   # dtype
        attention._check_bias(q, k.double(), k, torch.zeros(1, 128, 24))
    with pytest.raises(ValueError):                                   # head dim
        wide = torch.zeros(1, 2, 24, 264)
        attention._check_bias(torch.zeros(1, 2, 128, 264), wide, wide,
                              torch.zeros(1, 128, 24))


@pytest.mark.parametrize("d", [8, 24, 136, 144, 256])
def test_wrappers_take_every_head_dim_the_gates_admit(d):
    q = torch.zeros(1, 2, 64, d)
    attention._check_relpos(q, q, q, q, torch.zeros(2, 127, d), torch.zeros(1, 1, 64, 64))
    k = torch.zeros(1, 2, 5, d)
    attention._check_bias(q, k, k, torch.zeros(1, 64, 5))


@pytest.fixture
def tpu_backend(monkeypatch):
    """The JAX gates as they read on a TPU."""
    monkeypatch.setattr(jax_layers.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jpp.jax, "default_backend", lambda: "tpu")
    for var in ("STREAMSPEECH_DISABLE_PALLAS", "STREAMSPEECH_DISABLE_PALLAS_CROSS",
                "STREAMSPEECH_DISABLE_PALLAS_NOTBLANK"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("t,d", [(128, 64), (255, 64), (256, 64), (256, 12), (384, 16),
                                 (300, 64), (512, 256), (1024, 8)])
def test_relpos_gate_matches_the_tpu_gate(tpu_backend, t, d):
    assert port_layers._relpos_kernel_ok(t, d) == jax_layers._pallas_ok(t, d)


@pytest.mark.parametrize("s,d", [(511, 64), (512, 64), (600, 64), (600, 12), (1200, 8),
                                 (24, 64)])
def test_bias_gate_matches_the_tpu_gate(tpu_backend, s, d):
    assert port_layers._bias_kernel_ok(s, d) == jax_layers._bias_pallas_ok(s, d)


@pytest.mark.parametrize("t,v", [(63, 6000), (64, 6000), (256, 511), (256, 512),
                                 (16, 32), (1024, 6000)])
def test_not_blank_gate_matches_the_tpu_gate(tpu_backend, t, v):
    assert policy.nb_kernel_ok(t, v) == jpp.nb_pallas_ok(t, v)
