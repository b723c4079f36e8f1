"""The arithmetic of the tensor-core attention backwards (B4, B6), on the CPU.

``csrc/attention_bwd.cuh`` runs its five products through TF32 ``mma.sync``
with each operand split as hi = tf32(x), lo = x - hi (which the tensor core
reads truncated to tf32) and three products lo·hi + hi·lo + hi·hi (3xTF32).
The card cannot run here, so this file emulates that arithmetic in torch
(``cvt.rna.tf32.f32`` and the truncation included) and holds it against the
plain backwards: 3xTF32 within 1e-5·max|ref|, 1xTF32 outside the kernels'
1e-4, which is why the kernels take three products.
"""

import numpy as np
import pytest
import torch

from streamspeech_tpu_torch.kernels import attention
from streamspeech_tpu_torch.ops.masks import NEG_INF
from tests.torch_threads import one_torch_thread  # noqa: F401


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: round float32 to 10 mantissa bits, to nearest,
    ties away from zero (add half of the dropped 13 bits to the magnitude,
    clear them; a carry runs into the exponent)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 handed over as a .tf32 operand:
    the top 19 bits, the low 13 cleared (toward zero)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _from_bits(*words):
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32)).view(torch.float32)


@pytest.mark.parametrize("word,want", [
    (0x3F801000, 0x3F802000),   # 1 + 2^-11, a tie: away from zero
    (0xBF801000, 0xBF802000),   # its negative: away from zero too
    (0x3F800FFF, 0x3F800000),   # just under the tie: down
    (0xBF800FFF, 0xBF800000),
    (0x3F803000, 0x3F804000),   # a tie above an odd last bit: away, not to even
    (0x3FFFF000, 0x40000000),   # 2 - 2^-12, a tie: the carry reaches the exponent
    (0xC07FF800, 0xC0800000),   # -(4 - 2^-11): rounds up in magnitude to -4
    (0x00000000, 0x00000000),
    (0x3F802000, 0x3F802000),   # already tf32
])
def test_tf32_rounding_on_chosen_bit_patterns(word, want):
    got = tf32(_from_bits(word)).view(torch.int32)
    assert got.item() == int(np.array([want], np.uint32).view(np.int32)[0])


def test_truncation_clears_the_low_13_bits_toward_zero():
    got = tf32_truncated(_from_bits(0x3F801FFF, 0xBF801FFF, 0x3F802000)).view(torch.int32)
    assert got.tolist() == np.array([0x3F800000, 0xBF800000, 0x3F802000],
                                    np.uint32).view(np.int32).tolist()


def test_tf32_rounding_equals_rounding_in_float64():
    x = np.random.RandomState(0).randn(4096).astype(np.float32)
    mag = np.abs(x.astype(np.float64))
    step = 2.0 ** (np.floor(np.log2(mag)) - 10)       # the tf32 spacing at |x|
    want = np.sign(x) * np.floor(mag / step + 0.5) * step
    assert np.array_equal(tf32(torch.from_numpy(x)).numpy().astype(np.float64), want)


def _mm1(a, b):
    return tf32(a) @ tf32(b)


def _mm3(a, b):
    """a @ b as the kernels form it: three TF32 products into fp32 sums."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_truncated(a - ah), tf32_truncated(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulated_backward(mm, q, k, v, bias, g, scale, keep, rate):
    """The kernels' backward with products ``mm``: p from the forward's row
    statistics (max, 1/sum), dp = (g Vᵀ)·kf, delta = rowsum(p·dp),
    ds = p·(dp - delta)·scale, dq = ds K, dK = dsᵀ q, dV = (p·kf)ᵀ g."""
    exact = torch.einsum("bhsd,bhtd->bhst", q, k) * scale + bias
    mx = exact.max(-1, keepdim=True).values
    il = 1.0 / torch.exp(exact - mx).sum(-1, keepdim=True)
    p = torch.exp(mm(q, k.transpose(-1, -2)) * scale + bias - mx) * il
    kf = torch.ones_like(p) if keep is None else keep.float() / (1.0 - rate)
    dp = mm(g, v.transpose(-1, -2)) * kf
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) * scale
    return (mm(ds, k), mm(ds.transpose(-1, -2), q), mm((p * kf).transpose(-1, -2), g))


def _worst(got, want):
    return max(float((a - w).abs().max() / w.abs().max()) for a, w in zip(got, want))


def _causal_case(rate):
    b, h, t, d = 2, 2, 128, 32
    rng = np.random.RandomState(1)
    q, k, v, g = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32))
                  for _ in range(4))
    kvb = torch.where(torch.arange(t) < t - 9, 0.0, NEG_INF).float().view(1, 1, t)
    kvb = kvb.expand(b, 1, t).contiguous()
    i = torch.arange(t)
    bias = (kvb[:, :, None, :] + torch.where(i[:, None] >= i[None, :], 0.0, NEG_INF))
    keep = attention.dropout_keep_reference(7, b, h, t, t, rate) if rate else None
    want = attention.masked_attention_backward_reference(q, k, v, kvb, g, d ** -0.5,
                                                         keep, rate)
    return (q, k, v, bias, g, d ** -0.5, keep, rate), want


def _bias_case(rate):
    b, h, tq, tk, d = 2, 2, 130, 30, 24
    rng = np.random.RandomState(2)
    q, g = (torch.from_numpy(rng.randn(b, h, tq, d).astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.randn(b, h, tk, d).astype(np.float32)) for _ in range(2))
    allowed = (torch.arange(tk)[None, :] < (torch.arange(tq)[:, None] // 5 + 1))
    bias = torch.where(allowed, 0.0, NEG_INF).float()[None].expand(b, tq, tk).contiguous()
    keep = attention.dropout_keep_reference(8, b, h, tq, tk, rate) if rate else None
    want = attention.bias_attention_backward_reference(q, k, v, bias, g, d ** -0.5, keep,
                                                       rate)
    return (q, k, v, bias[:, None], g, d ** -0.5, keep, rate), want


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("case", [_causal_case, _bias_case])
def test_three_tf32_products_meet_the_kernels_tolerance(case, rate):
    args, want = case(rate)
    assert _worst(_emulated_backward(_mm3, *args), want) <= 1e-5


@pytest.mark.parametrize("case", [_causal_case, _bias_case])
def test_one_tf32_product_misses_it(case):
    args, want = case(0.1)
    assert _worst(_emulated_backward(_mm1, *args), want) > 1e-4
