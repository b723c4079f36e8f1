"""The arithmetic of the bf16 attention backwards (B4-bf16, B6-bf16), on the CPU.

``csrc/attention_bwd_bf16.cuh`` forms every product on the tensor cores
(``wgmma``) in bf16 with fp32 accumulators. q, K and V are exact in bf16; an
fp32 operand x (g, ds, p kf) is split into hi = bf16(x) and lo = bf16(x - hi)
(round to nearest even) and enters as two products (dV three: lo hi, hi lo,
hi hi). A split product's chain goes into a zeroed sum, the small terms
first, over one tile's contraction (D for dp; a key tile's 64 keys for dq in
the two-pass form, all keys in the one-kernel form; a query tile's 64
queries for dK and dV), and the running fp32 sum over tiles adds it. delta =
Σ_j p dp kf is formed from the fp32 probabilities. B6's one-kernel form adds
each block's dK and dV (its query tiles rank, rank + C, ..) over the C blocks
of a head in rank order.

The card cannot run here, so this file emulates that arithmetic in torch
(each chain one k16 step at a time, in the kernel's order) and holds it
against JAX's ``_masked_bwd`` and ``_bias_bwd_rule`` on bf16 inputs (their
Pallas kernels in interpret mode, built once for the file, rate 0: JAX's
in-kernel dropout has no interpret-mode lowering) and against the plain bf16
backward (rate 0 and 0.1, under ``dropout_keep_reference``'s mask), at the
card's bound (``chip_smoke.py``): each gradient within one bf16 ulp plus 2^-12
of its terms, delta within 2^-16 of its terms. g rounded to bf16 whole, which
the split replaces, misses delta's bound. The probabilities are the plain fp32
softmax, which the kernel reproduces from the forward's row statistics to
fp32 rounding. About 15 worker-seconds, most of it JAX's interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.ops import pallas_attention as pa

from streamspeech_tpu_torch.kernels import attention
from streamspeech_tpu_torch.ops.masks import NEG_INF
from tests.torch_threads import one_torch_thread  # noqa: F401

TILE = 64           # the kernels' query and key tiles
FUSED_KEYS = 128    # B6's one-kernel form: TK <= 128 and D <= 64
FUSED_MAX_D = 64
SMS, MAX_CLUSTER = 132, 4
GRAD_TERMS = 2.0 ** -12   # chip_smoke.BF16_GRAD_TERMS
DELTA_TERMS = 2.0 ** -16  # chip_smoke.BF16_DELTA_TERMS
RATE = 0.1

MASKED_CASES = [(128, 8), (128, 24), (256, 64), (128, 136)]              # (T, D)
BIAS_CASES = [(70, 24, 24), (200, 48, 64), (100, 130, 8), (64, 128, 136)]  # (TQ, TK, D)
CASES = [("masked",) + c for c in MASKED_CASES] + [("bias",) + c for c in BIAS_CASES]


def _bf16(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()


def _inputs(family, tq, tk, d):
    """bf16 q, k, v, the family's bias and an fp32 g, [2, 2, ...]: causal (tq
    == tk) with the last quarter of row 0's keys invalid; bias the wait-k cross
    mask (query i sees the first i // 3 + 1 keys, the last row's 5 keys
    invalid, row 1's query 3 wholly masked)."""
    rng = np.random.RandomState(tq + tk + d)
    q, k, v = _bf16(rng, 2, 2, tq, d), _bf16(rng, 2, 2, tk, d), _bf16(rng, 2, 2, tk, d)
    g = torch.from_numpy(rng.randn(2, 2, tq, d).astype(np.float32))
    if family == "masked":
        n_valid = np.array([tk - tk // 4, tk])
        bias = np.where(np.arange(tk)[None] < n_valid[:, None], 0.0, NEG_INF)[:, None, :]
    else:
        i, j = np.arange(tq)[:, None], np.arange(tk)[None]
        allowed = (j < np.minimum(i // 3 + 1, tk))[None] & \
            (np.arange(tk) < np.array([tk, tk - 5])[:, None])[:, None, :]
        allowed[1, 3] = False
        bias = np.where(allowed, 0.0, NEG_INF)
    return q, k, v, torch.from_numpy(bias.astype(np.float32)), g


def _case_inputs(case):
    family, *shape = case
    if family == "masked":
        t, d = shape
        return _inputs("masked", t, t, d)
    return _inputs("bias", *shape)


def _split(x):
    """(hi, lo): hi = bf16(x), lo = bf16(x - hi), round to nearest even."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def _chain(pairs):
    """Σ over the products a @ b of ``pairs``, in order, each one k16 step of
    its contraction at a time, into one fp32 sum from zero: a split product's
    wgmma chain."""
    acc = None
    for a, b in pairs:
        for k0 in range(0, a.shape[-1], 16):
            t = a[..., k0:k0 + 16] @ b[..., k0:k0 + 16, :]
            acc = t if acc is None else acc + t
    return acc


def _tiles(n):
    return [slice(t0, min(t0 + TILE, n)) for t0 in range(0, n, TILE)]


def cluster_blocks(b, h, tq):
    """The one-kernel form's blocks a (b, h) (``attn_bwd_bf16::cluster_blocks``)."""
    heads, nq, c = b * h, -(-tq // TILE), MAX_CLUSTER
    while c > 1 and (heads * c > SMS or c > nq):
        c //= 2
    return c


def emulate(family, q, k, v, bias, g, scale, keep=None, rate=0.0, g_whole=False, fused=None):
    """(dq, dK, dV, delta) as the card's kernels form them: bf16 gradients,
    fp32 delta. ``g_whole``: g rounded to bf16 whole, its lo part dropped.
    ``fused``: B6's one-kernel form or the two passes (default: the form the
    library launches at this shape)."""
    probs = (attention._masked_probs if family == "masked" else attention._bias_probs)(
        q, k, bias, scale)
    kf = torch.ones_like(probs) if keep is None else keep.float() / (1.0 - rate)
    qf, kf32, vf = q.float(), k.float(), v.float()
    g_hi, g_lo = _split(g)
    if g_whole:
        g_lo = torch.zeros_like(g_lo)
    vt = vf.transpose(-1, -2)
    dp = _chain([(g_lo, vt), (g_hi, vt)]) * kf          # the small terms first
    delta = (probs * dp).sum(-1)
    ds = probs * (dp - delta[..., None]) * scale
    pk = probs * kf
    ds_hi, ds_lo = _split(ds)
    pk_hi, pk_lo = _split(pk)
    tq, tk, d = q.shape[2], k.shape[2], q.shape[3]
    if fused is None:
        fused = family == "bias" and tk <= FUSED_KEYS and d <= FUSED_MAX_D

    def key_block(qt):
        """One query tile's dK and dV terms: (dsᵀ q, (p kf)ᵀ g), each a chain."""
        dst_lo, dst_hi = (x[..., qt, :].transpose(-1, -2) for x in (ds_lo, ds_hi))
        pkt_lo, pkt_hi = (x[..., qt, :].transpose(-1, -2) for x in (pk_lo, pk_hi))
        return (_chain([(dst_lo, qf[..., qt, :]), (dst_hi, qf[..., qt, :])]),
                _chain([(pkt_lo, g_hi[..., qt, :]), (pkt_hi, g_lo[..., qt, :]),
                        (pkt_hi, g_hi[..., qt, :])]))

    if fused:
        dq = _chain([(ds_lo, kf32), (ds_hi, kf32)])
        c = cluster_blocks(q.shape[0], q.shape[1], tq)
        parts = []
        for rank in range(c):
            dk_r = dv_r = torch.zeros_like(kf32)
            for qt in _tiles(tq)[rank::c]:
                a, b_ = key_block(qt)
                dk_r, dv_r = dk_r + a, dv_r + b_
            parts.append((dk_r, dv_r))
        dk, dv = parts[0]
        for a, b_ in parts[1:]:                            # rank order
            dk, dv = dk + a, dv + b_
    else:
        dq = torch.zeros_like(qf)
        for kt in _tiles(tk):
            dq = dq + _chain([(ds_lo[..., kt], kf32[..., kt, :]),
                              (ds_hi[..., kt], kf32[..., kt, :])])
        dk = dv = torch.zeros_like(kf32)
        for qt in _tiles(tq):
            a, b_ = key_block(qt)
            dk, dv = dk + a, dv + b_
    return dq.bfloat16(), dk.bfloat16(), dv.bfloat16(), delta


def _terms(family, q, k, v, bias, g, scale, keep=None, rate=0.0):
    """chip_smoke's terms: of dq and dK ds with dp's own terms, p (|g||v|ᵀ kf
    + Σ p |g||v|ᵀ kf) scale, times |K| or |q|; of dV p kf |g|; and delta's
    (Σ p dp kf, Σ p kf Σ_d |g_d v_jd|)."""
    probs = (attention._masked_probs if family == "masked" else attention._bias_probs)(
        q, k, bias, scale)
    kf = torch.ones_like(probs) if keep is None else keep.float() / (1.0 - rate)
    dp_terms = torch.einsum("bhsd,bhtd->bhst", g.abs(), v.float().abs()) * kf
    absum = (probs * dp_terms).sum(-1)
    delta = (probs * torch.einsum("bhsd,bhtd->bhst", g, v.float()) * kf).sum(-1)
    ds = probs * (dp_terms + absum[..., None]) * scale
    return (torch.einsum("bhst,bhtd->bhsd", ds, k.float().abs()),
            torch.einsum("bhst,bhsd->bhtd", ds, q.float().abs()),
            torch.einsum("bhst,bhsd->bhtd", probs * kf, g.abs())), (delta, absum)


def _ulp(x):
    m, e = torch.frexp(x.float())
    return torch.where(x != 0, torch.ldexp(torch.ones_like(m), e - 8), torch.zeros_like(m))


def _shares(got, want, terms):
    """Each gradient's largest share of its bound: one bf16 ulp (of the larger
    side) plus GRAD_TERMS of its terms."""
    out = {}
    for name, a, w, t in zip(("dq", "dk", "dv"), got, want, terms):
        w = torch.as_tensor(w).float()
        bound = torch.maximum(_ulp(a), _ulp(w)) + GRAD_TERMS * t + 1e-30
        out[name] = float(((a.float() - w).abs() / bound).max())
    return out


@pytest.fixture(scope="module")
def jax_grads():
    """``jax.vjp`` of the two trainable functions at every case (interpret
    mode, rate 0): bf16 dq, dK, dV as float32 tensors."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pa._relpos_bwd, "interpret", True)
        for case in CASES:
            q, k, v, bias, g = _case_inputs(case)
            d = q.shape[-1]
            if case[0] == "masked":
                fn = lambda q_, k_, v_: pa.masked_attention_trainable(  # noqa: E731
                    q_, k_, v_, jnp.asarray(bias.numpy()), None, d ** -0.5, True, 128, 0.0)
            else:
                fn = lambda q_, k_, v_: pa.bias_attention_trainable(  # noqa: E731
                    q_, k_, v_, jnp.asarray(bias.numpy()), None, d ** -0.5, 128, 0.0)
            _, vjp = jax.vjp(fn, *(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                                   for x in (q, k, v)))
            out[case] = [torch.from_numpy(np.array(x.astype(jnp.float32)))
                         for x in vjp(jnp.asarray(g.numpy()))]
    return out


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_kernel_matches_jax_and_the_plain_backward(jax_grads, case):
    """At rate 0 the emulated kernel is within the card's bound of JAX's
    backward kernel and of the plain bf16 backward."""
    q, k, v, bias, g = _case_inputs(case)
    scale = q.shape[-1] ** -0.5
    got = emulate(case[0], q, k, v, bias, g, scale)
    terms, _ = _terms(case[0], q, k, v, bias, g, scale)
    ref_bwd = getattr(attention, f"{case[0]}_attention_backward_reference")
    for want in (jax_grads[case], ref_bwd(q, k, v, bias, g, scale)):
        shares = _shares(got[:3], want, terms)
        assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulated_kernel_with_dropout_matches_the_plain_backward(case):
    """At rate 0.1, under ``dropout_keep_reference``'s mask, within the card's
    bound of the plain bf16 backward."""
    q, k, v, bias, g = _case_inputs(case)
    scale = q.shape[-1] ** -0.5
    b, h, tq, _ = q.shape
    keep = attention.dropout_keep_reference(torch.tensor([31]), b, h, tq, k.shape[2], RATE)
    got = emulate(case[0], q, k, v, bias, g, scale, keep, RATE)
    terms, _ = _terms(case[0], q, k, v, bias, g, scale, keep, RATE)
    want = getattr(attention, f"{case[0]}_attention_backward_reference")(
        q, k, v, bias, g, scale, keep, RATE)
    shares = _shares(got[:3], want, terms)
    assert max(shares.values()) <= 1.0, shares


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("case", [CASES[2], CASES[5]], ids=lambda c: "-".join(map(str, c)))
def test_emulated_delta_within_its_bound_where_rowsum_misses(case, rate):
    """delta as the kernel forms it, within DELTA_TERMS of its terms of
    Σ p dp kf; with V offset by 4 (as trained values are) rowsum(g out), out
    from the bf16-rounded probabilities, misses by more than 10 times that.
    With g rounded to bf16 whole, the kernel's delta would miss too."""
    q, k, v, bias, g = _case_inputs(case)
    v = (v.float() + 4.0).bfloat16()
    scale = q.shape[-1] ** -0.5
    b, h, tq, _ = q.shape
    seed = torch.tensor([17])
    keep = attention.dropout_keep_reference(seed, b, h, tq, k.shape[2], rate) \
        if rate > 0 else None
    _, (true, absum) = _terms(case[0], q, k, v, bias, g, scale, keep, rate)
    tol = DELTA_TERMS * absum + 1e-6
    delta = emulate(case[0], q, k, v, bias, g, scale, keep, rate)[3]
    assert float(((delta - true).abs() / tol).max()) <= 1.0
    out, _ = getattr(attention, f"{case[0]}_attention_forward")(
        q, k, v, bias, scale, rate, seed if rate > 0 else None, True)
    assert float((((g * out).sum(-1) - true).abs() / tol).max()) > 10.0
    whole = emulate(case[0], q, k, v, bias, g, scale, keep, rate, g_whole=True)[3]
    assert float(((whole - true).abs() / tol).max()) > 1.0


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_g_rounded_whole_misses_the_bound(case):
    """The split is what holds the kernel to its bound: with g rounded to bf16
    whole (its lo part dropped) delta or a gradient misses it."""
    q, k, v, bias, g = _case_inputs(case)
    scale = q.shape[-1] ** -0.5
    terms, (true, absum) = _terms(case[0], q, k, v, bias, g, scale)
    got = emulate(case[0], q, k, v, bias, g, scale, g_whole=True)
    want = getattr(attention, f"{case[0]}_attention_backward_reference")(
        q, k, v, bias, g, scale)
    delta_share = float(((got[3] - true).abs() / (DELTA_TERMS * absum + 1e-6)).max())
    assert max(delta_share, *_shares(got[:3], want, terms).values()) > 1.0


def test_one_kernel_form_spreads_query_tiles_over_a_cluster():
    """The one-kernel form at a shape whose cluster has several blocks (2 x 2
    heads, 200 queries: 4 tiles over C = 4 blocks, each block's dK, dV partial
    added in rank order) and the two-pass form (dq over key tiles, dK and dV
    over query tiles in order) form the same gradients to within one bf16 ulp
    of each other: only the order of the fp32 sums differs."""
    q, k, v, bias, g = _inputs("bias", 200, 48, 64)
    assert cluster_blocks(2, 2, 200) == 4
    one = emulate("bias", q, k, v, bias, g, 0.125, fused=True)
    two = emulate("bias", q, k, v, bias, g, 0.125, fused=False)
    for a, b in zip(one[:3], two[:3]):
        assert float(((a.float() - b.float()).abs() / torch.maximum(_ulp(a), _ulp(b)).clamp(
            min=1e-30)).max()) <= 1.0
    assert torch.equal(one[3], two[3])
