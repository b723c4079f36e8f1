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


def _relpos_inputs(b, h, t, d, seed, n_valid, chunk, bias_heads=1):
    rng = np.random.RandomState(seed)
    qu, qv, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(4))
    p = rng.randn(h, 2 * t - 1, d).astype(np.float32)
    i, j = np.arange(t)[:, None], np.arange(t)[None, :]
    allowed = (j < np.minimum((i // chunk + 1) * chunk, t))[None, None] & \
        (np.arange(t)[None, None, None, :] < np.asarray(n_valid)[:, None, None, None])
    bias = np.where(allowed, 0.0, NEG_INF).astype(np.float32)
    bias = np.repeat(bias, bias_heads, axis=1)
    return qu, qv, k, v, p, bias


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,d,bias_heads", [(1, 256, 64, 1), (8, 256, 64, 1),
                                              (1, 512, 64, 4), (2, 128, 24, 1),
                                              (1, 128, 136, 1), (1, 128, 144, 4),
                                              (1, 64, 256, 1), (1, 64, 8, 1)])
def test_relpos_kernel_matches_plain_version(hopper, b, t, d, bias_heads):
    args = [torch.from_numpy(a).to(hopper) for a in _relpos_inputs(
        b, 4, t, d, seed=t + d, n_valid=[t - 40] + [t] * (b - 1), chunk=8,
        bias_heads=bias_heads)]
    before = attention.relpos_attention.launches
    got = attention.relpos_attention(*args, d ** -0.5)
    torch.cuda.synchronize()
    assert attention.relpos_attention.launches == before + 1
    want = attention.relpos_attention_reference(*args, d ** -0.5)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def _bias_inputs(b, h, tq, tk, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k, v = (rng.randn(b, h, tk, d).astype(np.float32) for _ in range(2))
    # the unit decoder's wait-k mask (n2 = 1, upsample 25) and key validity
    allowed = np.arange(tk)[None, None, :] < np.minimum(
        np.arange(tq)[None, :, None] // 25 + 1, tk)
    allowed = allowed & (np.arange(tk)[None, None, :]
                         < np.array([tk] + [tk - 5] * (b - 1))[:, None, None])
    return q, k, v, np.where(allowed, 0.0, NEG_INF).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("b,tq,tk,d", [(1, 600, 24, 64), (8, 1200, 48, 64),
                                       (2, 70, 130, 16), (1, 100, 3, 256),
                                       (1, 64, 64, 8)])
def test_bias_kernel_matches_plain_version(hopper, b, tq, tk, d):
    args = [torch.from_numpy(a).to(hopper)
            for a in _bias_inputs(b, 8, tq, tk, d, seed=tq + tk)]
    before = attention.bias_attention.launches
    got = attention.bias_attention(*args, d ** -0.5)
    torch.cuda.synchronize()
    assert attention.bias_attention.launches == before + 1
    want = attention.bias_attention_reference(*args, d ** -0.5)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("b,t,v,blank", [(1, 256, 6000, 0), (8, 256, 6000, 0),
                                         (3, 7, 130, 5), (1, 1, 512, 0)])
def test_not_blank_kernel_matches_plain_version(hopper, b, t, v, blank):
    from streamspeech_tpu_torch.kernels import policy

    logits = torch.from_numpy(np.random.RandomState(t).randn(b, t, v).astype(
        np.float32) * 4).to(hopper)
    before = policy.not_blank_probs.launches
    got = policy.not_blank_probs(logits, blank)
    torch.cuda.synchronize()
    assert policy.not_blank_probs.launches == before + 1
    want = policy.not_blank_probs_reference(logits, blank)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_new_wrappers_raise_instead_of_falling_back(hopper):
    from streamspeech_tpu_torch.kernels import policy

    q = torch.zeros(1, 2, 100, 64, device=hopper)      # T not a multiple of 64
    p = torch.zeros(2, 199, 64, device=hopper)
    bias = torch.zeros(1, 1, 100, 100, device=hopper)
    with pytest.raises(ValueError):
        attention.relpos_attention(q, q, q, q, p, bias, 0.125)
    wide = torch.zeros(1, 2, 64, 264, device=hopper)   # head dim past 256
    with pytest.raises(ValueError):
        attention.bias_attention(wide, wide, wide, torch.zeros(1, 64, 64, device=hopper),
                                 264 ** -0.5)
    with pytest.raises(ValueError):                    # not float32
        policy.not_blank_probs(torch.zeros(1, 64, 512, device=hopper,
                                           dtype=torch.float64))


@pytest.mark.gpu
def test_offline_forward_on_the_card_matches_the_cpu(hopper):
    """The tiny model's offline forward takes all four kernels on the card
    (T_enc 256, S 600) and agrees with its CPU run (plain versions)."""
    from streamspeech_tpu_torch.config import tiny_config
    from streamspeech_tpu_torch.kernels import policy
    from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
    from streamspeech_tpu_torch.weights import random_init_

    model = random_init_(StreamSpeechModel(tiny_config(vocab_text=512, upsample=25)),
                         0).eval()
    rng = np.random.RandomState(0)
    src = torch.from_numpy(rng.randn(2, 1024, 80).astype(np.float32))
    lens = torch.tensor([1024, 800])
    mt = torch.from_numpy(rng.randint(4, 512, size=(2, 24)))
    mt[:, 0], mt[1, 18:] = 2, 1
    with torch.no_grad():
        want = model(src, lens, mt, n2=1)
        counts = [f.launches for f in (attention.relpos_attention,
                                       attention.bias_attention,
                                       attention.masked_attention,
                                       policy.not_blank_probs)]
        got = model.to(hopper)(src.to(hopper), lens.to(hopper), mt.to(hopper), n2=1)
    after = [f.launches for f in (attention.relpos_attention, attention.bias_attention,
                                  attention.masked_attention, policy.not_blank_probs)]
    assert [a - c for a, c in zip(after, counts)] == [2, 1, 1, 2]
    for key, ref in want.items():
        torch.testing.assert_close(got[key].cpu(), ref, atol=1e-4, rtol=0, msg=key)
