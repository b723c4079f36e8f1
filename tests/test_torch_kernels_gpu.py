"""The CUDA kernels against their plain PyTorch versions, on a Hopper card.

Imports neither jax nor the JAX package, so it runs on a machine with the card:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Elsewhere every test here skips.
"""

import numpy as np
import pytest
import torch

from streamspeech_tpu_torch.kernels import attention
from streamspeech_tpu_torch.ops.masks import NEG_INF

ATOL = 1e-5  # fp32 both sides; the sums run in a different order


def _inputs(b, h, t, d, seed, n_valid):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    valid = np.arange(t)[None, :] < np.asarray(n_valid)[:, None]
    kvb = np.where(valid, 0.0, NEG_INF).astype(np.float32)[:, None, :]
    return q, k, v, kvb


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("t_pad,n_valid", [(512, 400), (896, 800), (1664, 1600),
                                           (3200, 3200)])
def test_cuda_kernel_matches_plain_version(hopper, t_pad, n_valid):
    q, k, v, kvb = (torch.from_numpy(a).to(hopper)
                    for a in _inputs(1, 8, t_pad, 64, seed=t_pad,
                                      n_valid=[n_valid]))
    before = attention.masked_attention.launches
    got = attention.masked_attention(q, k, v, kvb, 0.125)
    torch.cuda.synchronize()
    assert attention.masked_attention.launches == before + 1
    want = attention.masked_attention_reference(q, k, v, kvb, 0.125)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [16, 32])
def test_cuda_kernel_small_heads(hopper, d):
    q, k, v, kvb = (torch.from_numpy(a).to(hopper)
                    for a in _inputs(2, 2, 256, d, seed=d, n_valid=[200, 256]))
    got = attention.masked_attention(q, k, v, kvb, d ** -0.5)
    want = attention.masked_attention_reference(q, k, v, kvb, d ** -0.5)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [8, 24, 40, 128, 256])
def test_cuda_kernel_other_head_dims(hopper, d):
    q, k, v, kvb = (torch.from_numpy(a).to(hopper)
                    for a in _inputs(1, 2, 320, d, seed=d, n_valid=[300]))
    got = attention.masked_attention(q, k, v, kvb, d ** -0.5)
    want = attention.masked_attention_reference(q, k, v, kvb, d ** -0.5)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.gpu
def test_causal_route_launches_the_kernel_at_an_odd_head_dim(hopper):
    """T=300 and head dim 24 pass the TPU gate, so the card runs the kernel."""
    from streamspeech_tpu_torch.models.layers import MultiHeadAttention

    torch.manual_seed(0)
    mha = MultiHeadAttention(48, 2).to(hopper)
    x = torch.randn(1, 300, 48, device=hopper)
    before = attention.masked_attention.launches
    got, _ = mha(x, causal=True)
    assert attention.masked_attention.launches == before + 1
    want, _ = mha.cpu()(x.cpu(), causal=True)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_cuda_wrapper_raises_instead_of_falling_back(hopper):
    q = torch.zeros(1, 2, 100, 64, device=hopper)   # T not a multiple of 64
    kvb = torch.zeros(1, 1, 100, device=hopper)
    with pytest.raises(ValueError):
        attention.masked_attention(q, q, q, kvb, 0.125)
    wide = torch.zeros(1, 2, 128, 264, device=hopper)  # head dim past 256
    with pytest.raises(ValueError):
        attention.masked_attention(wide, wide, wide, kvb[..., :0].new_zeros(1, 1, 128),
                                   264 ** -0.5)
