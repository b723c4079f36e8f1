"""The arithmetic of the tensor-core rel-pos forward (B1) and bias forward
(B5), emulated on the CPU and held against the JAX package.

``csrc/relpos_attention.cu`` runs a block of row groups of 16 queries by key
slices of KS = 16 keys: each warp's online softmax takes s = q_u Kᵀ over its
slice of every key tile and the rel-pos term from a band product q_v Pwᵀ over
the slice's 16 + KS table rows, read back on its diagonal; at the end the key
slices merge their (acc, max, sum). ``csrc/bias_attention.cu`` runs key tiles
of TK rounded up to 8 (64, or 32 at the widest head dims, at most), keys past
TK at -inf. Both split every operand by ``split`` (hi = tf32(x), lo = x - hi
read truncated; B1 splits q_u and q_v once a block, which gives the values a
split at every k-step gives) and form each product in 3xTF32. The card cannot
run here, so this file repeats that arithmetic in torch and holds it:

- against the JAX package's ``relpos_attention`` and ``bias_attention``
  (Pallas, interpret mode), dropout 0, within 2e-4·max(1, |ref|), the JAX
  side built once for the file;
- against the port's plain versions within 1e-5·max|ref|, at rate 0 and at
  rate 0.2 under the ``dropout_keep_reference`` mask, the row statistics (max
  and 1 / sum) included;
- and shows that one TF32 product a step misses 1e-4·max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.ops import pallas_attention as pa

from streamspeech_tpu_torch.kernels import attention
from streamspeech_tpu_torch.ops.masks import NEG_INF
from tests.test_torch_attention_tc import _mm1, _mm3, tf32, tf32_truncated
from tests.torch_threads import one_torch_thread  # noqa: F401

JAX_RTOL = 2e-4     # emulated kernel vs Pallas interpret mode, of max(1, |ref|)
PLAIN_RTOL = 1e-5   # emulated 3xTF32 kernel vs the plain fp32 version, of max|ref|
TF32_MISS = 1e-4    # what one TF32 product a step is off by at least
KS = 16             # B1's keys a warp a key tile
SCALE = 0.25
RELPOS_CASES = {"t128_d64": (2, 2, 128, 64), "t64_d8": (1, 3, 64, 8)}   # (B, H, T, D)
BIAS_TKS = (3, 30, 65)                                                  # TQ 70, D 64


def _relpos_inputs(b, h, t, d, bias_heads=1, chunk=8):
    rng = np.random.RandomState(t + d)
    qu, qv, k, v = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(4))
    p = rng.randn(h, 2 * t - 1, d).astype(np.float32)
    valid = np.array([t - 40] + [t] * (b - 1))
    i, j = np.arange(t)[:, None], np.arange(t)[None, :]
    allowed = (j < np.minimum((i // chunk + 1) * chunk, t))[None, None] & \
        (np.arange(t)[None, None, None, :] < valid[:, None, None, None])
    bias = np.where(allowed, 0.0, NEG_INF).astype(np.float32)
    return qu, qv, k, v, p, np.repeat(bias, bias_heads, axis=1)


def _bias_inputs(tk, b=2, h=2, tq=70, d=64):
    rng = np.random.RandomState(tk + d)
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k, v = (rng.randn(b, h, tk, d).astype(np.float32) for _ in range(2))
    # the unit decoder's wait-k mask (upsample 25) and key validity, the
    # second row's keys all masked when TK <= 5
    allowed = np.arange(tk)[None, None, :] < np.minimum(np.arange(tq)[None, :, None] // 25 + 1,
                                                         tk)
    allowed = allowed & (np.arange(tk)[None, None, :] < np.array([tk, tk - 5])[:, None, None])
    return q, k, v, np.where(allowed, 0.0, NEG_INF).astype(np.float32)


def _torch(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.fixture(scope="module")
def jax_refs():
    """The JAX functions on the file's inputs, once."""
    refs = {}
    for name, (b, h, t, d) in RELPOS_CASES.items():
        args = (jnp.asarray(x) for x in _relpos_inputs(b, h, t, d))
        refs[name] = np.asarray(pa.relpos_attention(*args, scale=SCALE, interpret=True))
    for tk in BIAS_TKS:
        args = (jnp.asarray(x) for x in _bias_inputs(tk))
        refs[tk] = np.asarray(pa.bias_attention(*args, scale=SCALE, interpret=True))
    return refs


def _kf(keep, rate):
    return keep.float() / (1.0 - rate) if keep is not None else None


def _worst(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _stats(scores):
    """Row max and 1 / sum of float64 scores rounded to float32 as the
    kernels hold them (a wholly masked row's -1e9 + s is -1e9 there), the
    max and sum then in float64."""
    scores = scores.float().double()
    mx = scores.max(-1).values
    return mx, 1.0 / torch.exp(scores - mx[..., None]).sum(-1)


# ---------------------------------------------------------------------------
# B1: key slices, per-warp band products read on their diagonal, the merge
# ---------------------------------------------------------------------------


def emulated_relpos_forward(qu, qv, k, v, p, bias, scale, keep=None, rate=0.0, kw=8,
                            mm=_mm3):
    """``relpos_attention.cu``'s arithmetic with KW key slices of KS keys
    (key tiles of KS·KW): returns (out, max, 1/sum)."""
    b, h, t, d = qu.shape
    g, bk = t // 16, KS * kw
    assert t % bk == 0
    kf = _kf(keep, rate)
    # the table with a zero row past it, as the window's zero-filled rows
    p_pad = torch.cat([p, p.new_zeros(h, 2 * t + 16 - p.shape[1], d)], 1)
    qug, qvg = qu.view(b, h, g, 16, d), qv.view(b, h, g, 16, d)
    a = torch.arange(16)
    diag = ((15 - a)[:, None] + torch.arange(KS)[None, :]).expand(b, h, g, 16, KS)
    m = torch.full((kw, b, h, g, 16), -float("inf"), dtype=qu.dtype)
    l = torch.zeros(kw, b, h, g, 16, dtype=qu.dtype)
    acc = torch.zeros(kw, b, h, g, 16, d, dtype=qu.dtype)
    for k0 in range(0, t, bk):
        for w in range(kw):
            c0 = k0 + KS * w
            s = mm(qug, k[:, :, None, c0:c0 + KS].transpose(-1, -2))         # [.., 16, KS]
            # the warp's window: table rows T-1 - (16 r + 15) + c0 .. + KS + 16
            rows = (t - 16 - 16 * torch.arange(g) + c0)[:, None] + torch.arange(KS + 16)
            band = mm(qvg, p_pad[:, rows][None].transpose(-1, -2))           # [.., 16, KS+16]
            bd = torch.gather(band, -1, diag)                                # column 15 - a' + c'
            x = (s + bd) * scale + bias[..., c0:c0 + KS].reshape(b, -1, g, 16, KS)
            m_new = torch.maximum(m[w], x.max(-1).values)
            alpha = torch.exp(m[w] - m_new)
            pr = torch.exp(x - m_new[..., None])
            l[w] = l[w] * alpha + pr.sum(-1)
            m[w] = m_new
            if kf is not None:
                pr = pr * kf[..., c0:c0 + KS].reshape(b, h, g, 16, KS)
            acc[w] = acc[w] * alpha[..., None] + mm(pr, v[:, :, None, c0:c0 + KS])
    # slice 0 takes the others in order, each rescaled to the overall max
    mx = m.max(0).values
    f = torch.exp(m[0] - mx)
    lt, at = l[0] * f, acc[0] * f[..., None]
    for w in range(1, kw):
        f = torch.exp(m[w] - mx)
        lt = lt + l[w] * f
        at = at + acc[w] * f[..., None]
    inv = 1.0 / lt
    return ((at * inv[..., None]).reshape(b, h, t, d), mx.reshape(b, h, t),
            inv.reshape(b, h, t))


def _relpos_scores(qu, qv, k, p, bias, scale):
    b, h, t, _ = qu.shape
    rows = attention._relpos_rows(t, qu.device)[None, None].expand(b, h, t, t)
    return (torch.einsum("bhsd,bhtd->bhst", qu.double(), k.double())
            + torch.gather(torch.einsum("bhsd,hrd->bhsr", qv.double(), p.double()), -1, rows)
            ) * scale + bias.double()


def test_band_diagonal_is_the_shear():
    """The band product read at column 15 - a' + c' is the rel-pos term
    q_v[i] . p[T-1-i+j] (float64: nothing but the summation order differs)."""
    b, h, t, d = 1, 2, 64, 8
    qu, qv, k, v, p, bias = (x.double() for x in _torch(*_relpos_inputs(b, h, t, d)))
    zero, no_bias = torch.zeros_like(qu), torch.zeros_like(bias)
    exact = lambda x, y: x @ y  # noqa: E731
    want = torch.gather(torch.einsum("bhsd,hrd->bhsr", qv, p), -1,
                        attention._relpos_rows(t, qu.device)[None, None].expand(b, h, t, t))
    # with q_u = 0, scale 1 and no bias the row max is the largest rel-pos term
    _, mx, _ = emulated_relpos_forward(zero, qv, k, v, p, no_bias, 1.0, kw=2, mm=exact)
    torch.testing.assert_close(mx, want.max(-1).values, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("name", sorted(RELPOS_CASES))
def test_relpos_forward_matches_jax(jax_refs, name):
    args = _torch(*_relpos_inputs(*RELPOS_CASES[name]))
    got, _, _ = emulated_relpos_forward(*args, SCALE, kw=4)
    want = jax_refs[name]
    err = np.abs(got.numpy() - want)
    assert (err <= JAX_RTOL * np.maximum(1.0, np.abs(want))).all(), err.max()


@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("kw", [8, 4, 1])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_relpos_forward_matches_plain_version(rate, kw, d):
    """Each cut's key tiles (128, 64 and 16 keys) and merge, bias per head."""
    b, h, t = 2, 2, 128
    qu, qv, k, v, p, bias = _torch(*_relpos_inputs(b, h, t, d, bias_heads=h))
    keep = attention.dropout_keep_reference(9, b, h, t, t, rate) if rate else None
    got, mx, il = emulated_relpos_forward(qu, qv, k, v, p, bias, SCALE, keep, rate, kw)
    want = attention.relpos_attention_reference(qu, qv, k, v, p, bias, SCALE, keep, rate)
    assert _worst(got, want) <= PLAIN_RTOL
    want_mx, want_il = _stats(_relpos_scores(qu, qv, k, p, bias, SCALE))
    assert _worst(mx.double(), want_mx) <= PLAIN_RTOL
    assert _worst(il.double(), want_il) <= PLAIN_RTOL


def test_relpos_forward_one_tf32_product_misses():
    qu, qv, k, v, p, bias = _torch(*_relpos_inputs(2, 2, 128, 64))
    want = attention.relpos_attention_reference(qu, qv, k, v, p, bias, SCALE)
    got, _, _ = emulated_relpos_forward(qu, qv, k, v, p, bias, SCALE, mm=_mm1)
    assert _worst(got, want) > TF32_MISS


# ---------------------------------------------------------------------------
# B5: key tiles of TK rounded up to 8, the ragged edge at -inf
# ---------------------------------------------------------------------------


def emulated_bias_forward(q, k, v, bias, scale, keep=None, rate=0.0, bk_max=64,
                          mm=_mm3):
    """``bias_attention.cu``'s arithmetic: key tiles of min(64, TK rounded up
    to 8) keys, within a tile only the 8-key slabs that hold a key, keys past
    TK at -inf (their K and V rows zeros). Returns (out, max, 1/sum)."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    bk = min(bk_max, -(-tk // 8) * 8)
    kf = _kf(keep, rate)
    m = torch.full((b, h, tq), -float("inf"))
    l = torch.zeros(b, h, tq)
    acc = torch.zeros(b, h, tq, d)
    for k0 in range(0, tk, bk):
        width = 8 * min(bk // 8, -(-(tk - k0) // 8))
        n = min(width, tk - k0)
        kt, vt = torch.zeros(b, h, width, d), torch.zeros(b, h, width, d)
        kt[:, :, :n], vt[:, :, :n] = k[:, :, k0:k0 + n], v[:, :, k0:k0 + n]
        bt = torch.zeros(b, tq, width)
        bt[..., :n] = bias[..., k0:k0 + n]
        s = mm(q, kt.transpose(-1, -2))
        x = torch.where(torch.arange(width) < n, s * scale + bt[:, None], -float("inf"))
        m_new = torch.maximum(m, x.max(-1).values)
        alpha = torch.exp(m - m_new)
        pr = torch.exp(x - m_new[..., None])
        l = l * alpha + pr.sum(-1)
        m = m_new
        if kf is not None:
            ft = torch.zeros(b, h, tq, width)
            ft[..., :n] = kf[..., k0:k0 + n]
            pr = pr * ft
        acc = acc * alpha[..., None] + mm(pr, vt)
    inv = 1.0 / l
    return acc * inv[..., None], m, inv


@pytest.mark.parametrize("tk", BIAS_TKS)
def test_bias_forward_matches_jax(jax_refs, tk):
    got, _, _ = emulated_bias_forward(*_torch(*_bias_inputs(tk)), SCALE)
    want = jax_refs[tk]
    err = np.abs(got.numpy() - want)
    assert (err <= JAX_RTOL * np.maximum(1.0, np.abs(want))).all(), err.max()


@pytest.mark.parametrize("bk_max", [64, 32])
@pytest.mark.parametrize("d", [8, 64])
@pytest.mark.parametrize("tk", BIAS_TKS)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_bias_forward_matches_plain_version(rate, tk, d, bk_max):
    """One partial tile (3 keys in one slab, 30 in four), and a whole 64-key
    tile followed by a one-key tile (65); at the widest head dims' 32-key
    tiles, 30 in one and 65 in three; a row whose keys are all masked."""
    q, k, v, bias = _torch(*_bias_inputs(tk, d=d))
    b, h, tq, _ = q.shape
    keep = attention.dropout_keep_reference(10, b, h, tq, tk, rate) if rate else None
    got, mx, il = emulated_bias_forward(q, k, v, bias, SCALE, keep, rate, bk_max)
    want = attention.bias_attention_reference(q, k, v, bias, SCALE, keep, rate)
    assert _worst(got, want) <= PLAIN_RTOL
    scores = torch.einsum("bhsd,bhtd->bhst", q.double(), k.double()) * SCALE \
        + bias.double()[:, None]
    want_mx, want_il = _stats(scores)
    assert _worst(mx.double(), want_mx) <= PLAIN_RTOL
    assert _worst(il.double(), want_il) <= PLAIN_RTOL


def test_bias_forward_one_tf32_product_misses():
    q, k, v, bias = _torch(*_bias_inputs(65))
    want = attention.bias_attention_reference(q, k, v, bias, SCALE)
    got, _, _ = emulated_bias_forward(q, k, v, bias, SCALE, mm=_mm1)
    assert _worst(got, want) > TF32_MISS


def test_split_is_exact_and_close():
    """hi = tf32(x), hi + lo is x exactly, |lo| <= 2^-11 |x|, and the
    truncated lo the tensor core reads is within 2^-10 |lo| of lo: the bounds
    tc_mma.cuh's split relies on."""
    x = torch.from_numpy(np.random.RandomState(3).randn(4096).astype(np.float32))
    hi = tf32(x)
    lo = x - hi
    assert torch.equal(hi + lo, x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.abs() <= 2.0 ** -11 * x.abs()).all()
    assert ((lo - tf32_truncated(lo)).abs() <= 2.0 ** -10 * lo.abs()).all()
