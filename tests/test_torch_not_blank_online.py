"""The CTC not-blank posterior kernel's arithmetic (B7, ``csrc/not_blank.cu``),
emulated on the CPU and held against the JAX package.

The kernel reads rows t and t - 1 of the logits once, in one pass: a row's
columns go to WPR warps, lane l of warp slice s taking the units (float4 where
V % 4 == 0, else single floats) 32 s + l + k·32 WPR, kUnroll = 4 of them a
round. Each lane keeps an online max and sum of exponentials of both rows and
the dot of their exponentials, rescaled by exp(old max - new max) when a max
rises; the lanes merge by a butterfly of shuffles (xor 16, 8, 4, 2, 1, as lane
0 sees it), the warps of a row in order. This file repeats that order in
float32 torch (the fused multiply-add through float64) and holds it, within
1e-6, against ``not_blank_probs_pallas`` (interpret mode, built once for the
file) and the port's plain version, at the launcher's WPR and at others.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.ops.pallas_policy import not_blank_probs_pallas

from streamspeech_tpu_torch.kernels import policy
from tests.torch_threads import one_torch_thread  # noqa: F401

ATOL = 1e-6  # posteriors in [0, 1], fp32 on both sides, another summation order
SHAPES = [(2, 64, 512), (1, 65, 513), (3, 70, 6001)]
UNROLL, WARPS, WARPS_AN_SM = 4, 8, 8  # not_blank.cu's kUnroll, kWarps, kWarpsAnSm
SMS = 132  # an H100's, which the launcher reads from the device


def _logits(b, t, v):
    return np.random.RandomState(b * t + v).randn(b, t, v).astype(np.float32) * 4


@pytest.fixture(scope="module")
def jax_out():
    """not_blank_probs_pallas (interpret mode) at every shape and blank."""
    out = {}
    for b, t, v in SHAPES:
        for blank in (0, v - 1):
            got = not_blank_probs_pallas(jnp.asarray(_logits(b, t, v)), blank, interpret=True)
            out[b, t, v, blank] = torch.from_numpy(np.array(got))
    return out


def warps_a_row(rows: int, n: int, sms: int = SMS) -> int:
    """not_blank.cu's ``warps_a_row`` on a card of ``sms`` SMs."""
    wpr = 1
    while wpr < WARPS and rows * wpr < WARPS_AN_SM * sms and n >= 2 * UNROLL * 32 * 2 * wpr:
        wpr *= 2
    return wpr


def _rescale(m, m_new):
    return torch.where(m == m_new, torch.ones_like(m), torch.exp(m - m_new))


def _merge(a, b):
    mc, mp = torch.maximum(a[0], b[0]), torch.maximum(a[2], b[2])
    ca, cb, pa, pb = _rescale(a[0], mc), _rescale(b[0], mc), _rescale(a[2], mp), \
        _rescale(b[2], mp)
    return (mc, a[1] * ca + b[1] * cb, mp, a[3] * pa + b[3] * pb,
            a[4] * (ca * pa) + b[4] * (cb * pb))


def _fold(o, xc, xp):
    """not_blank.cu's ``fold`` of one round's columns [..., N] into o."""
    mc = torch.maximum(o[0], xc.max(-1).values)
    mp = torch.maximum(o[2], xp.max(-1).values)
    ac, ap = _rescale(o[0], mc), _rescale(o[2], mp)
    sc, sp, dot = o[1] * ac, o[3] * ap, o[4] * (ac * ap)
    for i in range(xc.shape[-1]):
        ec, ep = torch.exp(xc[..., i] - mc), torch.exp(xp[..., i] - mp)
        sc, sp = sc + ec, sp + ep
        dot = (dot.double() + ec.double() * ep.double()).float()  # fmaf
    return mc, sc, mp, sp, dot


def emulate(x: torch.Tensor, blank: int, wpr: int) -> torch.Tensor:
    b, t, v = x.shape
    rows, width = b * t, 4 if v % 4 == 0 else 1
    n, stride = v // width, 32 * wpr
    rounds = -(-n // (UNROLL * stride))
    idx = torch.arange(rows)
    first = idx % t > 0
    cur = x.reshape(rows, n, width)
    prev = cur[torch.where(first, idx - 1, idx)]       # t = 0 reads its own row

    def lanes(rowdata):  # [rows, n, W] -> [rows, wpr, 32, rounds, UNROLL * W]
        pad = torch.full((rows, rounds * UNROLL * stride - n, width), -torch.inf)
        y = torch.cat([rowdata, pad], 1).reshape(rows, rounds, UNROLL, wpr, 32, width)
        return y.permute(0, 3, 4, 1, 2, 5).reshape(rows, wpr, 32, rounds, UNROLL * width)

    xc, xp = lanes(cur), lanes(prev)
    unit0 = (torch.arange(rounds)[:, None, None] * UNROLL * stride
             + 32 * torch.arange(wpr)[:, None] + torch.arange(32))  # [rounds, wpr, 32]
    ninf, zero = torch.full((rows, wpr, 32), -torch.inf), torch.zeros(rows, wpr, 32)
    o = (ninf, zero, ninf, zero, zero)
    for k in range(rounds):
        folded = _fold(o, xc[..., k, :], xp[..., k, :])
        live = unit0[k] < n                             # the lane's loop runs this round
        o = tuple(torch.where(live, f, a) for f, a in zip(folded, o))
    for off in (16, 8, 4, 2, 1):
        o = _merge(o, tuple(a[..., torch.arange(32) ^ off] for a in o))
    row = tuple(a[:, 0, 0] for a in o)
    for s in range(1, wpr):
        row = _merge(row, tuple(a[:, s, 0] for a in o))
    mc, sc, mp, sp, dot = row
    xr = x.reshape(rows, v)
    blank_p = torch.exp(xr[:, blank] - mc) / sc
    prev_blank = torch.exp(xr[torch.where(first, idx - 1, idx), blank] - mp) / sp
    repeat = torch.where(first, dot / (sc * sp) - blank_p * prev_blank, torch.zeros(rows))
    return (1.0 - (repeat + blank_p)).reshape(b, t)


@pytest.mark.parametrize("wpr", ["launcher", 1, 2, 8])
@pytest.mark.parametrize("last_blank", [False, True])
@pytest.mark.parametrize("b,t,v", SHAPES)
def test_one_pass_order_matches_jax_and_plain(jax_out, b, t, v, last_blank, wpr):
    blank = v - 1 if last_blank else 0
    x = torch.from_numpy(_logits(b, t, v))
    if wpr == "launcher":
        wpr = warps_a_row(b * t, v // 4 if v % 4 == 0 else v)
    got = emulate(x, blank, wpr)
    torch.testing.assert_close(got, jax_out[b, t, v, blank], atol=ATOL, rtol=0)
    torch.testing.assert_close(got, policy.not_blank_probs_reference(x, blank), atol=ATOL,
                               rtol=0)


def test_launcher_rule_at_the_main_path_shapes():
    """One warp a row at the train step's [8, 256, 6000], four at the
    forward's [1, 256, 6000] on 132 SMs, two on a card of 64; V = 512 rows
    keep one warp."""
    assert warps_a_row(8 * 256, 1500) == 1
    assert warps_a_row(256, 1500) == 4
    assert warps_a_row(256, 1500, sms=64) == 2
    assert warps_a_row(128, 128) == 1
