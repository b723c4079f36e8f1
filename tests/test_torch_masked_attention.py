"""The causal masked-attention kernel's plain version against the JAX TPU kernel
(Pallas interpret mode) and its XLA reference, and the wrapper's input checks.
The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

from streamspeech_tpu.ops.pallas_attention import (
    masked_attention as jax_masked_attention,
    masked_attention_reference as jax_masked_attention_reference,
)

from streamspeech_tpu_torch.kernels import attention
from streamspeech_tpu_torch.ops.masks import NEG_INF
from tests.torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-5  # fp32 both sides; the sums run in a different order


def _inputs(b, h, t, d, seed, n_valid):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    valid = np.arange(t)[None, :] < np.asarray(n_valid)[:, None]
    kvb = np.where(valid, 0.0, NEG_INF).astype(np.float32)[:, None, :]
    return q, k, v, kvb


@pytest.mark.parametrize("t", [128, 256])
def test_plain_version_matches_jax_kernel(t):
    q, k, v, kvb = _inputs(2, 2, t, 16, seed=t, n_valid=[t - 37, t])
    scale = 16 ** -0.5
    ref_kernel = np.asarray(jax_masked_attention(q, k, v, kvb, scale=scale,
                                                 block_q=32, interpret=True))
    ref_xla = np.asarray(jax_masked_attention_reference(q, k, v, kvb, scale))
    got = attention.masked_attention(*(torch.from_numpy(a) for a in (q, k, v, kvb)),
                                     scale).numpy()
    np.testing.assert_allclose(got, ref_kernel, atol=ATOL)
    np.testing.assert_allclose(got, ref_xla, atol=ATOL)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    q = torch.zeros(1, 2, 128, 16)
    kvb = torch.zeros(1, 1, 128)
    with pytest.raises(ValueError):
        attention._check(q, q, q, torch.zeros(1, 128))              # bias shape
    with pytest.raises(ValueError):
        attention._check(q, q, q.double(), kvb)                    # dtype
    with pytest.raises(ValueError):
        attention._check(q[:, :, :100], q[:, :, :100], q[:, :, :100],
                         kvb[:, :, :100])                          # T % 64
    with pytest.raises(ValueError):
        attention._check(q.transpose(2, 3).contiguous().transpose(2, 3), q, q, kvb)
    for d in (12, 264):                                            # head dim
        odd = torch.zeros(1, 2, 128, d)
        with pytest.raises(ValueError):
            attention._check(odd, odd, odd, kvb)


@pytest.mark.parametrize("d", [8, 24, 64, 128, 256])
def test_wrapper_takes_every_head_dim_the_gate_admits(d):
    q = torch.zeros(1, 2, 128, d)
    attention._check(q, q, q, torch.zeros(1, 1, 128))


@pytest.mark.parametrize("t,d", [(255, 64), (256, 64), (300, 24), (400, 12),
                                 (3200, 64), (512, 128), (256, 8)])
def test_route_gate_matches_the_tpu_gate(monkeypatch, t, d):
    """The port's causal route takes the kernel exactly where the JAX package
    on a TPU takes its Pallas kernel."""
    from streamspeech_tpu.models import layers as jax_layers

    from streamspeech_tpu_torch.models import layers as port_layers

    monkeypatch.setattr(jax_layers.jax, "default_backend", lambda: "tpu")
    monkeypatch.delenv("STREAMSPEECH_DISABLE_PALLAS", raising=False)
    monkeypatch.delenv("STREAMSPEECH_DISABLE_PALLAS_MASKED", raising=False)
    assert port_layers._masked_kernel_ok(t, d) == jax_layers._masked_pallas_ok(t, d)
