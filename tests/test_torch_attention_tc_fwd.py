"""The arithmetic of the tensor-core causal forward (B3) and rel-pos backward
(B2), emulated on the CPU and held against the JAX package.

``csrc/masked_attention.cu`` runs the online (flash) softmax over 64-query
tiles and key tiles with both products, s = q Kᵀ and o += p V, in 3xTF32;
``csrc/relpos_attention_bwd.cu`` makes one pass over the scores per 32-query
tile: the shear as the band product W = q_v Pwᵀ over the tile pair's 2·32
table rows, the un-shear by scattering ds into a band tile Z, dq_v = Z Pw, the
dP window Zᵀ q_v added into a rolling window, and partials that a second
kernel adds in a fixed order. The card cannot run here, so this file repeats
that arithmetic in torch, ``cvt.rna.tf32.f32`` and the truncation included
(``tests/test_torch_attention_tc.py``), and holds it:

- against the JAX package's ``masked_attention`` (Pallas, interpret mode) and
  the VJP of ``relpos_attention_trainable`` (interpret mode), dropout 0,
  within 2e-4·max(1, |ref|), the JAX side built once for the file;
- against the port's plain versions within 1e-5·max|ref|, at rate 0 and at
  rate 0.2 under the ``dropout_keep_reference`` mask;
- and shows that one TF32 product a step misses 1e-4·max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.ops import pallas_attention as pa

from streamspeech_tpu_torch.kernels import attention
from streamspeech_tpu_torch.ops.masks import NEG_INF
from tests.test_torch_attention_tc import _mm1, _mm3
from tests.torch_threads import one_torch_thread  # noqa: F401

JAX_RTOL = 2e-4     # emulated kernel vs Pallas interpret mode, of max(1, |ref|)
PLAIN_RTOL = 1e-5   # emulated 3xTF32 kernel vs the plain fp32 version, of max|ref|
TF32_MISS = 1e-4    # what one TF32 product a step is off by at least
BQ = 64             # B3's query tile (and its key tile at these head dims)
BT = 32             # B2's tile at these head dims
SCALE = 0.25


def _causal_inputs(b=2, h=2, t=256, d=32, valid=(200, 256)):
    rng = np.random.RandomState(11)
    q, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(3))
    kvb = np.where(np.arange(t)[None] < np.asarray(valid)[:, None], 0.0, NEG_INF)
    return q, k, v, kvb.astype(np.float32)[:, None, :]


def _relpos_inputs(b=2, h=2, t=128, d=16, chunk=8, valid=(128, 100)):
    rng = np.random.RandomState(12)
    qu, qv, k, v, g = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(5))
    p = rng.randn(h, 2 * t - 1, d).astype(np.float32)
    i, j = np.arange(t)[:, None], np.arange(t)[None, :]
    allowed = (j < np.minimum((i // chunk + 1) * chunk, t))[None, None] & \
        (np.arange(t)[None, None, None, :] < np.asarray(valid)[:, None, None, None])
    return qu, qv, k, v, p, np.where(allowed, 0.0, NEG_INF).astype(np.float32), g


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX functions on the file's inputs, once: the causal forward and
    the rel-pos VJP (dP cut to the port's 2T-1 table rows)."""
    q, k, v, kvb = _causal_inputs()
    causal = np.asarray(pa.masked_attention(*(jnp.asarray(x) for x in (q, k, v, kvb)),
                                            scale=SCALE, causal=True, interpret=True))
    qu, qv, k2, v2, p, bias, g = _relpos_inputs()
    t = qu.shape[2]
    w_pad = -(-(t + BT - 1) // 128) * 128
    p_pad = np.pad(p, ((0, 0), (0, (t - BT) + w_pad - p.shape[1]), (0, 0)))
    old = pa._relpos_bwd.interpret
    pa._relpos_bwd.interpret = True
    try:
        f = lambda *a: pa.relpos_attention_trainable(  # noqa: E731
            *a, jnp.asarray(bias), None, SCALE, BT, 0.0)
        _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (qu, qv, k2, v2, p_pad)))
        grads = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    finally:
        pa._relpos_bwd.interpret = old
    grads[4] = grads[4][:, :2 * t - 1]
    return {"causal": causal, "relpos_grads": grads}


def _keep(b, h, t, rate, seed):
    return attention.dropout_keep_reference(seed, b, h, t, t, rate) if rate else None


def _kf(keep, rate):
    return keep.float() / (1.0 - rate) if keep is not None else None


# ---------------------------------------------------------------------------
# B3: the tiled online softmax with per-tile rescale, 3xTF32 products
# ---------------------------------------------------------------------------


def emulated_causal_forward(q, k, v, kvb, scale, keep=None, rate=0.0, mm=_mm3, bk=BQ):
    """``masked_attention.cu``'s arithmetic: per 64-query tile, key tiles up
    to the diagonal; s = q Kᵀ, x = s·scale + kvb, -1e9 above the diagonal; the
    running max and sum rescaled by exp(m_old - m_new) each tile; the sum takes
    p, the accumulation p·kf; out = acc / sum. Returns (out, max, 1/sum)."""
    b, h, t, d = q.shape
    kf = _kf(keep, rate)
    out = torch.empty_like(q)
    mx, il = torch.empty(b, h, t), torch.empty(b, h, t)
    for q0 in range(0, t, BQ):
        rows = torch.arange(q0, q0 + BQ)
        m = torch.full((b, h, BQ), -float("inf"))
        l = torch.zeros(b, h, BQ)
        acc = torch.zeros(b, h, BQ, d)
        for k0 in range(0, q0 + BQ, bk):
            cols = torch.arange(k0, k0 + bk)
            s = mm(q[:, :, q0:q0 + BQ], k[:, :, k0:k0 + bk].transpose(-1, -2))
            x = s * scale + kvb[:, :, None, k0:k0 + bk]
            x = x + torch.where(cols[None, :] > rows[:, None], NEG_INF, 0.0)
            m_new = torch.maximum(m, x.max(-1).values)
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            m = m_new
            pk = p if kf is None else p * kf[:, :, q0:q0 + BQ, k0:k0 + bk]
            acc = acc * alpha[..., None] + mm(pk, v[:, :, k0:k0 + bk])
        out[:, :, q0:q0 + BQ] = acc / l[..., None]
        mx[:, :, q0:q0 + BQ], il[:, :, q0:q0 + BQ] = m, 1.0 / l
    return out, mx, il


def _worst(got, want):
    return float((got - want).abs().max() / want.abs().max())


def test_causal_forward_matches_jax(jax_refs):
    q, k, v, kvb = (torch.from_numpy(x) for x in _causal_inputs())
    got, _, _ = emulated_causal_forward(q, k, v, kvb, SCALE)
    want = jax_refs["causal"]
    err = np.abs(got.numpy() - want)
    assert (err <= JAX_RTOL * np.maximum(1.0, np.abs(want))).all(), err.max()


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_causal_forward_matches_plain_version(rate):
    q, k, v, kvb = (torch.from_numpy(x) for x in _causal_inputs())
    keep = _keep(2, 2, 256, rate, 5)
    got, mx, il = emulated_causal_forward(q, k, v, kvb, SCALE, keep, rate)
    want = attention.masked_attention_reference(q, k, v, kvb, SCALE, keep, rate)
    assert _worst(got, want) <= PLAIN_RTOL
    # the row statistics the backward reads: those of the exact scores
    i = torch.arange(256)
    s = torch.einsum("bhsd,bhtd->bhst", q.double(), k.double()) * SCALE \
        + kvb.double()[:, :, None, :] + torch.where(i[:, None] >= i[None, :], 0.0, NEG_INF)
    want_mx = s.max(-1).values
    want_il = 1.0 / torch.exp(s - want_mx[..., None]).sum(-1)
    assert _worst(mx.double(), want_mx) <= PLAIN_RTOL
    assert _worst(il.double(), want_il) <= PLAIN_RTOL


def test_causal_forward_in_smaller_key_tiles():
    """The 32- and 16-key tiles of the wide head dims rescale more often and
    agree with the 64-key tile."""
    q, k, v, kvb = (torch.from_numpy(x) for x in _causal_inputs())
    want = attention.masked_attention_reference(q, k, v, kvb, SCALE)
    for bk in (32, 16):
        assert _worst(emulated_causal_forward(q, k, v, kvb, SCALE, bk=bk)[0], want) \
            <= PLAIN_RTOL


def test_causal_forward_one_tf32_product_misses():
    q, k, v, kvb = (torch.from_numpy(x) for x in _causal_inputs())
    want = attention.masked_attention_reference(q, k, v, kvb, SCALE)
    assert _worst(emulated_causal_forward(q, k, v, kvb, SCALE, mm=_mm1)[0], want) > TF32_MISS


# ---------------------------------------------------------------------------
# B2: one pass over the scores, the shear by band products, ordered partials
# ---------------------------------------------------------------------------


def emulated_relpos_backward(qu, qv, k, v, p, bias, g, scale, keep=None, rate=0.0, mm=_mm3):
    """``relpos_attention_bwd.cu``'s arithmetic: (dq_u, dq_v, dK, dV, dP)."""
    b, h, t, d = qu.shape
    r = p.shape[1]
    kf = _kf(keep, rate)
    out = attention.relpos_attention_reference(qu, qv, k, v, p, bias, scale, keep, rate)
    delta = (g * out).sum(-1)
    # the forward's row statistics
    s_all = (torch.einsum("bhsd,bhtd->bhst", qu, k)
             + torch.gather(torch.einsum("bhsd,hrd->bhsr", qv, p), -1,
                            attention._relpos_rows(t, qu.device)[None, None]
                            .expand(b, h, t, t))) * scale + bias
    mx = s_all.max(-1).values
    il = 1.0 / torch.exp(s_all - mx[..., None]).sum(-1)
    nt = t // BT
    a = torch.arange(BT)[:, None]
    band = (BT - 1) - a + torch.arange(BT)[None, :]            # W's column of (a, c)
    dqu, dqv = torch.zeros_like(qu), torch.zeros_like(qv)
    part_k = torch.zeros(nt, b, h, t, d)
    part_v = torch.zeros(nt, b, h, t, d)
    windows = torch.zeros(b, h, nt, t + BT, d)                 # rows from T - BT - q0
    for qt in range(nt):
        q0 = qt * BT
        rq = slice(q0, q0 + BT)
        for kt in range(nt):
            k0 = kt * BT
            rk = slice(k0, k0 + BT)
            u0 = t - q0 - BT + k0
            pw = torch.zeros(h, 2 * BT, d)
            have = min(2 * BT, r - u0)
            pw[:, :have] = p[:, u0:u0 + have]
            pw = pw[None].expand(b, h, 2 * BT, d)
            s = mm(qu[:, :, rq], k[:, :, rk].transpose(-1, -2))
            dp = mm(g[:, :, rq], v[:, :, rk].transpose(-1, -2))
            w = mm(qv[:, :, rq], pw.transpose(-1, -2))                    # [BT, 2 BT]
            bd = torch.gather(w, -1, band[None, None].expand(b, h, BT, BT))
            x = (s + bd) * scale + bias[:, :, rq, rk]
            pr = torch.exp(x - mx[:, :, rq, None]) * il[:, :, rq, None]
            f = 1.0 if kf is None else kf[:, :, rq, rk]
            ds = pr * (dp * f - delta[:, :, rq, None]) * scale
            z = torch.zeros(b, h, BT, 2 * BT).scatter(
                -1, band[None, None].expand(b, h, BT, BT), ds)
            dqu[:, :, rq] += mm(ds, k[:, :, rk])
            dqv[:, :, rq] += mm(z, pw)
            part_k[qt, :, :, rk] = mm(ds.transpose(-1, -2), qu[:, :, rq])
            part_v[qt, :, :, rk] = mm((pr * f).transpose(-1, -2), g[:, :, rq])
            windows[:, :, qt, k0:k0 + 2 * BT] += mm(z.transpose(-1, -2), qv[:, :, rq])
    dk, dv = part_k[0].clone(), part_v[0].clone()
    for qt in range(1, nt):
        dk += part_k[qt]
        dv += part_v[qt]
    dpt = torch.zeros(h, r, d)
    for u in range(r):
        acc = torch.zeros(h, d)
        for bb in range(b):
            for qt in range(nt):
                row = u - (t - BT - qt * BT)
                if 0 <= row < t + BT:
                    acc += windows[bb, :, qt, row]
        dpt[:, u] = acc
    return dqu, dqv, dk, dv, dpt


def _relpos_case(rate, mm=_mm3):
    qu, qv, k, v, p, bias, g = (torch.from_numpy(x) for x in _relpos_inputs())
    keep = _keep(2, 2, 128, rate, 6)
    got = emulated_relpos_backward(qu, qv, k, v, p, bias, g, SCALE, keep, rate, mm)
    want = attention.relpos_attention_backward_reference(qu, qv, k, v, p, bias, g, SCALE,
                                                         keep, rate)
    return got, want


def test_relpos_backward_matches_jax(jax_refs):
    got, _ = _relpos_case(0.0)
    for name, a, want in zip(("dq_u", "dq_v", "dk", "dv", "dp"), got,
                             jax_refs["relpos_grads"]):
        err = np.abs(a.numpy() - want)
        assert (err <= JAX_RTOL * np.maximum(1.0, np.abs(want))).all(), (name, err.max())


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_relpos_backward_matches_plain_version(rate):
    got, want = _relpos_case(rate)
    for name, a, w in zip(("dq_u", "dq_v", "dk", "dv", "dp"), got, want):
        assert _worst(a, w) <= PLAIN_RTOL, name


def test_relpos_backward_one_tf32_product_misses():
    got, want = _relpos_case(0.2, mm=_mm1)
    assert max(_worst(a, w) for a, w in zip(got, want)) > TF32_MISS
