"""The arithmetic of the bf16 attention forwards' wgmma form (B3-bf16, B5-bf16), on the CPU.

``csrc/attention_bf16.cuh`` runs the forwards at D <= 64 (and, for the bias
form, TK <= 128: every path's shape) on Hopper's ``wgmma``: a block of one
warpgroup on 64 query rows. s = q Kᵀ is a product of bf16 operands with fp32
sums; x = s scale + bias in fp32, the causal mask added on the diagonal key
tile only, then x log2(e) rounded once (``__fmul_rn`` in the training form). The
causal form walks key tiles of 64 with an online softmax (a running max m in
log2 units, p = 2^(x log2(e) - m), the fp32 sum and accumulator rescaled by
2^(m_old - m_new)); the bias form takes every key in one tile, so its softmax
has one pass. Each probability times its keep factor is rounded to bf16 once
and multiplies V (fp32 sums); the output is the accumulator times 1 / Σ p,
the undropped sum. The training form writes each row's (m, 1 / Σ p), from
which the backward recomputes p = 2^(x log2(e) - m) / Σ p (its ``prob``).

The card cannot run here, so this file emulates that arithmetic in torch, in
the kernel's order, and holds it against JAX's ``masked_attention`` and
``bias_attention`` on bf16 inputs (their Pallas kernels in interpret mode,
built once for the file, rate 0: JAX's in-kernel dropout has no interpret-mode
lowering) and against the plain bf16 forms (rate 0 and 0.1, under
``dropout_keep_reference``'s mask), each output element within
``chip_smoke._bf16_bound``: 2^-7 Σ_j p_j kf_j |v_j| + 1e-5, p the plain
version's fp32 probabilities (each probability rounded to bf16 once on each
side, at most 2^-8 of it). Covered: a wholly masked row of the padded bias
route, the written statistics through the backward's ``prob`` expression.
About 10 worker-seconds, most of it JAX's interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.ops import pallas_attention as pa

from streamspeech_tpu_torch.kernels import attention
from streamspeech_tpu_torch.ops.masks import NEG_INF
from tests.torch_threads import one_torch_thread  # noqa: F401

TILE = 64                  # query rows a block; the causal form's key tile
BIAS_KEYS = 128            # the bias form's one key tile
LOG2E = 1.4426950408889634
ROUNDING = 2.0 ** -8       # chip_smoke.BF16_ROUNDING
KERNEL_ATOL = 1e-5         # chip_smoke.KERNEL_ATOL
# the written statistics against the plain fp32 softmax, relative: x log2(e)
# rounded once (2^-24 of |x log2(e)| <= 2^7 here: 2^-17 in the exponent) and
# the fp32 sums' order
STATS_RTOL = 2.0 ** -16
RATE = 0.1

MASKED_CASES = [(128, 8), (192, 24), (256, 64)]                        # (T, D)
# (TQ, TK, D): one 64-key half; the path's 48 keys padded to the tile; TK %
# 4 == 0 past 64 keys; TK % 4 != 0 (4-byte bias copies)
BIAS_CASES = [(70, 24, 16), (130, 128, 64), (100, 100, 32), (64, 65, 8)]
CASES = [("masked",) + c for c in MASKED_CASES] + [("bias",) + c for c in BIAS_CASES]
PATH_VALID_KEYS = 48


def _bf16(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()


def _inputs(case):
    """bf16 q, k, v [2, 2, ...] and the family's fp32 bias: causal with the last
    quarter of row 0's keys invalid; bias the wait-k cross mask (query i sees
    the first i // 3 + 1 keys, the last row's 5 keys invalid) and, at TK = 128,
    the path's layout: PATH_VALID_KEYS keys, then zero K and V under a NEG_INF
    bias, row 1's query 3 wholly masked (its softmax spreads over all 128)."""
    family, *shape = case
    if family == "masked":
        t, d = shape
        rng = np.random.RandomState(t + d)
        q, k, v = (_bf16(rng, 2, 2, t, d) for _ in range(3))
        n_valid = np.array([t - t // 4, t])
        kvb = np.where(np.arange(t)[None] < n_valid[:, None], 0.0, NEG_INF)[:, None, :]
        return q, k, v, torch.from_numpy(kvb.astype(np.float32))
    tq, tk, d = shape
    rng = np.random.RandomState(tq + tk + d)
    valid = PATH_VALID_KEYS if tk == BIAS_KEYS else tk
    q, k, v = _bf16(rng, 2, 2, tq, d), _bf16(rng, 2, 2, valid, d), _bf16(rng, 2, 2, valid, d)
    i, j = np.arange(tq)[:, None], np.arange(valid)[None]
    allowed = (j < np.minimum(i // 3 + 1, valid))[None] & \
        (np.arange(valid) < np.array([valid, valid - 5])[:, None])[:, None, :]
    bias = np.where(allowed, 0.0, NEG_INF)
    if valid < tk:
        k, v = (torch.nn.functional.pad(x, (0, 0, 0, tk - valid)) for x in (k, v))
        bias = np.pad(bias, ((0, 0), (0, 0), (0, tk - valid)), constant_values=NEG_INF)
        bias[1, 3] = NEG_INF
    return q, k, v, torch.from_numpy(bias.astype(np.float32))


def _logits(family, q, k, bias, scale, rows, keys):
    """x = s scale + bias in fp32 for query rows ``rows`` and key tile ``keys``
    (causal: NEG_INF added above the diagonal, as on the diagonal tile)."""
    s = q.float()[..., rows, :] @ k.float()[..., keys, :].transpose(-1, -2)
    if family == "masked":
        x = s * scale + bias[:, :, None, keys]
        r = torch.arange(rows.start, rows.stop)[:, None]
        c = torch.arange(keys.start, keys.stop)[None]
        return torch.where(c > r, x + NEG_INF, x)
    return s * scale + bias[:, None, rows, keys]


def emulate(family, q, k, v, bias, scale, keep=None, rate=0.0):
    """(out, stats) as the wgmma form forms them: out [B, H, TQ, D] fp32,
    stats [B, H, TQ, 2] (the max in log2 units, 1 / Σ p)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    assert d <= 64 and (family == "masked" or tk <= BIAS_KEYS)
    out = torch.empty(b, h, tq, d)
    stats = torch.empty(b, h, tq, 2)
    inv_keep = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    for q0 in range(0, tq, TILE):
        rows = slice(q0, min(q0 + TILE, tq))
        n = rows.stop - rows.start
        m = torch.full((b, h, n, 1), -float("inf"))
        l = torch.zeros(b, h, n, 1)
        acc = torch.zeros(b, h, n, d)
        tiles = [slice(k0, k0 + TILE) for k0 in range(0, q0 + TILE, TILE)] \
            if family == "masked" else [slice(0, tk)]
        for keys in tiles:
            x2 = _logits(family, q, k, bias, scale, rows, keys) * LOG2E   # fp32, one rounding
            m_new = torch.maximum(m, x2.amax(-1, keepdim=True))
            m_use = torch.where(m_new == -float("inf"), torch.zeros_like(m_new), m_new)
            alpha = torch.exp2(m - m_use)
            m = m_new
            p = torch.exp2(x2 - m_use)
            l = l * alpha + p.sum(-1, keepdim=True)
            if keep is not None:
                p = torch.where(keep[..., rows, keys], p * inv_keep, torch.zeros_like(p))
            acc = acc * alpha + p.bfloat16().float() @ v.float()[..., keys, :]
        inv = 1.0 / l
        out[..., rows, :] = acc * inv
        stats[..., rows, :] = torch.cat([m, inv], -1)
    return out, stats


def _bound(family, q, k, v, bias, scale, keep=None, rate=0.0):
    ref = getattr(attention, f"{family}_attention_reference")
    return 2 * ROUNDING * ref(q, k, v.float().abs(), bias, scale, keep, rate) + KERNEL_ATOL


def _share(got, want, bound):
    return float(((got - torch.as_tensor(want)).abs() / bound).max())


@pytest.fixture(scope="module")
def jax_out():
    """JAX's kernels (interpret mode, rate 0) at every case, bf16 operands."""
    out = {}
    for case in CASES:
        q, k, v, bias = _inputs(case)
        args = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)]
        fn = pa.masked_attention if case[0] == "masked" else pa.bias_attention
        out[case] = torch.from_numpy(np.array(fn(*args, jnp.asarray(bias.numpy()),
                                                   q.shape[-1] ** -0.5, interpret=True)))
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_forward_matches_jax_and_the_plain_version(jax_out, case):
    """At rate 0 the emulated kernel is within the card's bound of JAX's
    kernel and of the plain bf16 form; it rounds before normalising, so it is
    not the plain form to fp32 rounding."""
    q, k, v, bias = _inputs(case)
    scale = q.shape[-1] ** -0.5
    got, _ = emulate(case[0], q, k, v, bias, scale)
    bound = _bound(case[0], q, k, v, bias, scale)
    plain = getattr(attention, f"{case[0]}_attention_reference")(q, k, v, bias, scale)
    for want in (jax_out[case], plain):
        assert _share(got, want, bound) <= 1.0
    assert float((got - plain).abs().max()) > 1e-6


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_training_form_with_dropout_matches_the_plain_version(case):
    """At rate 0.1 under ``dropout_keep_reference``'s mask (each p times its
    keep factor before the bf16 rounding, the sum undropped), within the
    card's bound of the plain bf16 form."""
    q, k, v, bias = _inputs(case)
    scale = q.shape[-1] ** -0.5
    b, h, tq, _ = q.shape
    keep = attention.dropout_keep_reference(torch.tensor([23]), b, h, tq, k.shape[2], RATE)
    got, _ = emulate(case[0], q, k, v, bias, scale, keep, RATE)
    want = getattr(attention, f"{case[0]}_attention_reference")(q, k, v, bias, scale, keep,
                                                                RATE)
    assert _share(got, want, _bound(case[0], q, k, v, bias, scale, keep, RATE)) <= 1.0


def test_wholly_masked_row_of_the_padded_route_spreads_over_every_key():
    """The bias route's keys padded to the 128 tile: a row that masks every
    key has logits all at NEG_INF, which the one-pass softmax spreads evenly
    over all 128 keys (the padding's zero V included), as JAX's does."""
    case = ("bias", 130, BIAS_KEYS, 64)
    q, k, v, bias = _inputs(case)
    assert bool((bias[1, 3] == NEG_INF).all())
    got, stats = emulate("bias", q, k, v, bias, 0.125)
    torch.testing.assert_close(got[1, :, 3], v.float()[1].mean(1), atol=KERNEL_ATOL, rtol=0)
    assert torch.isfinite(stats).all()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_written_statistics_reproduce_the_softmax_through_prob(case):
    """p = 2^(x log2(e) - m) (1 / Σ), the backward's ``prob`` on the forward's
    (m, 1 / Σ), is the plain fp32 softmax of x to fp32 rounding (STATS_RTOL),
    a wholly masked row's uniform spread included."""
    q, k, v, bias = _inputs(case)
    scale = q.shape[-1] ** -0.5
    _, stats = emulate(case[0], q, k, v, bias, scale)
    tq, tk = q.shape[2], k.shape[2]
    x = _logits(case[0], q, k, bias, scale, slice(0, tq), slice(0, tk))
    prob = torch.exp2(x * LOG2E - stats[..., :1]) * stats[..., 1:]
    want = torch.softmax(x, dim=-1)
    assert float(((prob - want).abs() - STATS_RTOL * want).max()) <= 1e-9
