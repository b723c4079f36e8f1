"""The differentiable attention wrappers of the port on the CPU (their plain
forward and plain backward versions) and the dropout mask's plain version.

- Against the JAX package's ``relpos_attention_trainable``,
  ``masked_attention_trainable`` and ``bias_attention_trainable`` (Pallas
  forward and backward in interpret mode, as ``tests/test_pallas_attention.py``
  runs them), dropout 0, on the same numpy-seeded inputs: outputs and every
  gradient, dP included, within 2e-4·max(1, |ref|).
- The plain backward against ``torch.autograd`` through the plain forward, at
  rate 0 and at rate 0.2 with the ``dropout_keep_reference`` mask fed to both:
  within 1e-5·max(1, |ref|) (fp32, the same products in another order).
- ``dropout_keep_reference``: Philox-4x32-10 known answers, determinism in the
  seed, independence of tiling (blocks of other shapes hold the same bits where
  they overlap), keep share.
- ``kernels.build``: a library is stale when any file under ``csrc/`` is newer.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.ops import pallas_attention as pa

from streamspeech_tpu_torch.kernels import attention, build
from streamspeech_tpu_torch.ops.masks import NEG_INF
from tests.torch_threads import one_torch_thread  # noqa: F401

JAX_RTOL = 2e-4       # port (plain fp32) vs Pallas interpret mode
AUTOGRAD_RTOL = 1e-5  # plain backward vs autograd through the plain forward


@pytest.fixture
def interpret():
    old = pa._relpos_bwd.interpret
    pa._relpos_bwd.interpret = True
    yield
    pa._relpos_bwd.interpret = old


def _close(got, want, rtol, name):
    want = np.asarray(want)
    err = np.abs(got.detach().numpy() - want)
    assert (err <= rtol * np.maximum(1.0, np.abs(want))).all(), \
        f"{name}: max err {err.max()}"


def _t(x):
    return torch.from_numpy(np.asarray(x)).requires_grad_()


def _masked_inputs(seed, b=2, h=3, t=96, d=16, valid=(60, 96)):
    rng = np.random.RandomState(seed)
    q, k, v, g = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(4))
    kvb = np.where(np.arange(t)[None] < np.asarray(valid)[:, None], 0.0, NEG_INF)
    return q, k, v, kvb.astype(np.float32)[:, None, :], g


def _bias_inputs(seed, b=2, h=3, tq=64, tk=48, d=16):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(b, h, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, tk, d).astype(np.float32) for _ in range(2))
    # a wait-k mask, the last row with 7 padded keys
    allowed = np.arange(tk)[None, None, :] < np.minimum(
        np.arange(tq)[None, :, None] // 2 + 1, tk)
    allowed = allowed & (np.arange(tk)[None, None, :]
                         < np.array([tk] * (b - 1) + [tk - 7])[:, None, None])
    return q, k, v, np.where(allowed, 0.0, NEG_INF).astype(np.float32), g


def _relpos_inputs(seed, b=2, h=2, t=64, d=16, chunk=8, valid=(64, 50)):
    rng = np.random.RandomState(seed)
    qu, qv, k, v, g = (rng.randn(b, h, t, d).astype(np.float32) for _ in range(5))
    p = rng.randn(h, 2 * t - 1, d).astype(np.float32)
    i, j = np.arange(t)[:, None], np.arange(t)[None, :]
    # chunk mask and key validity: the frames past `valid` are wholly masked rows
    allowed = (j < np.minimum((i // chunk + 1) * chunk, t))[None, None] & \
        (np.arange(t)[None, None, None, :] < np.asarray(valid)[:, None, None, None])
    return qu, qv, k, v, p, np.where(allowed, 0.0, NEG_INF).astype(np.float32), g


# ---------------------------------------------------------------------------
# (a) against the JAX trainable functions, dropout 0
# ---------------------------------------------------------------------------


def test_masked_attention_matches_jax_trainable(interpret):
    q, k, v, kvb, g = _masked_inputs(1)
    f = lambda *a: pa.masked_attention_trainable(  # noqa: E731
        *a, jnp.asarray(kvb), None, 0.25, True, 32, 0.0)
    want, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    xs = [_t(x) for x in (q, k, v)]
    out = attention.masked_attention(*xs, torch.from_numpy(kvb), 0.25)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(g))
    _close(out, want, JAX_RTOL, "out")
    for name, got, ref in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(g))):
        _close(got, ref, JAX_RTOL, name)


def test_bias_attention_matches_jax_trainable(interpret):
    q, k, v, bias, g = _bias_inputs(2)
    f = lambda *a: pa.bias_attention_trainable(  # noqa: E731
        *a, jnp.asarray(bias), None, 0.25, 32, 0.0)
    want, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    xs = [_t(x) for x in (q, k, v)]
    out = attention.bias_attention(*xs, torch.from_numpy(bias), 0.25)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(g))
    _close(out, want, JAX_RTOL, "out")
    for name, got, ref in zip(("dq", "dk", "dv"), grads, vjp(jnp.asarray(g))):
        _close(got, ref, JAX_RTOL, name)


def test_relpos_attention_matches_jax_trainable(interpret):
    """dP too: the JAX table is padded to the TPU's lane-aligned window; its
    gradient's first 2T-1 rows are the port's dP and the padding rows get 0."""
    qu, qv, k, v, p, bias, g = _relpos_inputs(3)
    t, bq = qu.shape[2], 32
    w_pad = -(-(t + bq - 1) // 128) * 128
    p_pad = np.pad(p, ((0, 0), (0, (t - bq) + w_pad - p.shape[1]), (0, 0)))
    f = lambda *a: pa.relpos_attention_trainable(  # noqa: E731
        *a, jnp.asarray(bias), None, 0.25, bq, 0.0)
    want, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (qu, qv, k, v, p_pad)))
    refs = list(vjp(jnp.asarray(g)))
    assert not np.asarray(refs[4][:, 2 * t - 1:]).any()
    refs[4] = refs[4][:, :2 * t - 1]
    xs = [_t(x) for x in (qu, qv, k, v, p)]
    out = attention.relpos_attention(*xs, torch.from_numpy(bias), 0.25)
    grads = torch.autograd.grad(out, xs, torch.from_numpy(g))
    _close(out, want, JAX_RTOL, "out")
    for name, got, ref in zip(("dq_u", "dq_v", "dk", "dv", "dp"), grads, refs):
        _close(got, ref, JAX_RTOL, name)


# ---------------------------------------------------------------------------
# (b) the plain backward against autograd through the plain forward
# ---------------------------------------------------------------------------

FAMILIES = {
    "masked": (attention.masked_attention, attention.masked_attention_reference,
               attention.masked_attention_backward_reference, _masked_inputs, 3),
    "bias": (attention.bias_attention, attention.bias_attention_reference,
             attention.bias_attention_backward_reference, _bias_inputs, 3),
    "relpos": (attention.relpos_attention, attention.relpos_attention_reference,
               attention.relpos_attention_backward_reference, _relpos_inputs, 5),
}


@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_plain_backward_matches_autograd(family, rate):
    """``*_backward_reference`` states the backward step by step; autograd
    through ``*_reference`` under the same keep mask must give the same, and
    the differentiable wrapper (seed → mask) the same again."""
    fn, ref, ref_bwd, make, n_diff = FAMILIES[family]
    *arrays, g = make(7)
    diff = [torch.from_numpy(a) for a in arrays[:n_diff]]
    const = torch.from_numpy(arrays[n_diff])
    g = torch.from_numpy(g)
    b, h, tq = diff[0].shape[:3]
    tk = diff[-2].shape[2] if family != "relpos" else tq
    seed = torch.tensor([4321]) if rate > 0 else None
    keep = attention.dropout_keep_reference(seed, b, h, tq, tk, rate) if rate > 0 else None
    xs = [x.clone().requires_grad_() for x in diff]
    out = ref(*xs, const, 0.25, keep, rate)
    want = torch.autograd.grad(out, xs, g)
    got = ref_bwd(*diff, const, g, 0.25, keep, rate)
    ys = [x.clone().requires_grad_() for x in diff]
    wrapped = fn(*ys, const, 0.25, rate, seed)
    through = torch.autograd.grad(wrapped, ys, g)
    torch.testing.assert_close(wrapped, out, rtol=0, atol=0)
    for i, (a, w, t) in enumerate(zip(got, want, through)):
        _close(a, w.numpy(), AUTOGRAD_RTOL, f"{family} grad {i}")
        torch.testing.assert_close(t, a, rtol=0, atol=0)
    if rate > 0:                                   # dropped entries really are dropped
        assert not torch.equal(out, ref(*diff, const, 0.25))
        assert const.requires_grad is False and wrapped.grad_fn is not None


def test_wholly_masked_rows_are_uniform_not_nan():
    """The masks are the finite NEG_INF: a wholly masked row is a softmax of
    equal numbers, in the forward and in every gradient."""
    q, k, v, bias, g = (torch.from_numpy(a) for a in _bias_inputs(5, b=1))
    bias[0, 3] = NEG_INF
    out = attention.bias_attention_reference(q, k, v, bias, 0.25)
    torch.testing.assert_close(out[0, :, 3], v[0].mean(dim=1))
    grads = attention.bias_attention_backward_reference(q, k, v, bias, g, 0.25)
    assert all(bool(torch.isfinite(x).all()) for x in grads)


# ---------------------------------------------------------------------------
# (c) the dropout mask's plain version
# ---------------------------------------------------------------------------

# Random123's known answers for Philox-4x32-10: (counter, key) → output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("counter,key,want", PHILOX_KAT)
def test_philox_known_answers(counter, key, want):
    got = attention.philox4x32_10([torch.tensor([c]) for c in counter], key)
    assert tuple(int(x) for x in got) == want


def test_dropout_keep_reference_reads_the_generator_as_documented():
    """Element (b, h, row, col) reads word col % 4 of
    Philox(key = (seed low, seed high), counter = (b, h, row, col // 4)):
    keep = (word >> 8)·2⁻²⁴ >= rate."""
    seed = (5 << 32) | 77
    keep = attention.dropout_keep_reference(seed, 2, 3, 5, 11, 0.3)
    for b, h, row, col in [(0, 0, 0, 0), (1, 2, 4, 10), (1, 0, 3, 6), (0, 1, 2, 9)]:
        words = attention.philox4x32_10(
            [torch.tensor([c]) for c in (b, h, row, col // 4)], (77, 5))
        u = np.float32(int(words[col % 4]) >> 8) * np.float32(2.0 ** -24)
        assert bool(keep[b, h, row, col]) == bool(u >= np.float32(0.3))


def test_dropout_keep_reference_seed_tiling_and_share():
    a = attention.dropout_keep_reference(11, 2, 2, 70, 50, 0.2)
    assert a.dtype == torch.bool and tuple(a.shape) == (2, 2, 70, 50)
    assert torch.equal(a, attention.dropout_keep_reference(torch.tensor([11]), 2, 2, 70,
                                                           50, 0.2))
    assert not torch.equal(a, attention.dropout_keep_reference(12, 2, 2, 70, 50, 0.2))
    # independent of tiling: a block of any other shape holds the same bits
    # where the two overlap (each element reads its own counter)
    for b, h, tq, tk in [(2, 2, 70, 64), (1, 2, 33, 29), (2, 1, 128, 7), (3, 4, 5, 200)]:
        block = attention.dropout_keep_reference(11, b, h, tq, tk, 0.2)
        nb, nh, nq, nk = min(b, 2), min(h, 2), min(tq, 70), min(tk, 50)
        assert torch.equal(block[:nb, :nh, :nq, :nk], a[:nb, :nh, :nq, :nk])
    big = attention.dropout_keep_reference(3, 2, 4, 128, 128, 0.1)
    sigma = (0.1 * 0.9 / big.numel()) ** 0.5
    assert abs(float(big.float().mean()) - 0.9) < 3 * sigma
    assert bool(attention.dropout_keep_reference(3, 1, 1, 8, 8, 0.0).all())


def test_draw_seed_follows_the_generator():
    a, b, c = (attention.draw_seed(torch.Generator().manual_seed(s), "cpu")
               for s in (0, 0, 1))
    assert a.dtype == torch.int64 and tuple(a.shape) == (1,) and 0 <= int(a) < 2 ** 31 - 1
    assert int(a) == int(b) != int(c)
    with pytest.raises(ValueError, match="Generator"):
        attention.draw_seed(None, "cpu")
    with pytest.raises(ValueError, match="rate"):
        attention.masked_attention(torch.zeros(1, 1, 64, 8), torch.zeros(1, 1, 64, 8),
                                   torch.zeros(1, 1, 64, 8), torch.zeros(1, 1, 64), 0.3, 1.0,
                                   a)


def test_counters_count_launches_only_and_mask_draws_apart():
    """A wrapper's count moves where it launches its kernel, so on the CPU (the
    plain versions) none moves; attention calls that draw the mask are counted
    as ``mask_draws``, never as launches of ``dropout_keep``'s own kernel."""
    def counts():
        return ([f.launches for f in (attention.masked_attention,
                                      attention.masked_attention_backward,
                                      attention.dropout_keep)], attention.mask_draws)
    before = counts()
    q, k, v = (torch.randn(1, 2, 64, 8, generator=torch.Generator().manual_seed(s))
               .requires_grad_() for s in (0, 1, 2))
    seed = torch.tensor([5])
    out = attention.masked_attention(q, k, v, torch.zeros(1, 1, 64), 0.35, 0.2, seed)
    out.sum().backward()
    attention.dropout_keep(seed, 1, 2, 64, 64, 0.2)
    assert q.grad is not None and counts() == before
    try:                                          # what a launch on the card adds
        attention._count(attention.masked_attention, 0.0)
        assert attention.mask_draws == before[1]
        attention._count(attention.masked_attention_backward, 0.2)
        assert attention.mask_draws == before[1] + 1
        assert attention.dropout_keep.launches == before[0][2]
    finally:
        attention.masked_attention.launches, attention.masked_attention_backward.launches \
            = before[0][:2]
        attention.mask_draws = before[1]


# ---------------------------------------------------------------------------
# The build: shared headers make a library stale
# ---------------------------------------------------------------------------


def test_library_is_stale_when_any_csrc_file_is_newer(tmp_path, monkeypatch):
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    for name in ("a.cu", "b.cu", "shared.cuh"):
        (csrc / name).write_text("// source")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", out)
    assert build.kernel_names() == ["a", "b"]
    assert build._stale("a")                                  # no library yet
    lib = build.library_path("a")
    lib.write_text("")
    now = lib.stat().st_mtime
    for f in csrc.iterdir():
        os.utime(f, (now - 10, now - 10))
    assert not build._stale("a")
    os.utime(csrc / "shared.cuh", (now + 10, now + 10))       # the header alone moves
    assert build._stale("a")
    os.utime(csrc / "shared.cuh", (now - 10, now - 10))
    os.utime(csrc / "b.cu", (now + 10, now + 10))             # any file under csrc/
    assert build._stale("a")


def test_every_source_includes_only_headers_that_exist():
    """``nvcc -I csrc`` resolves each quoted include from ``csrc/``."""
    import re

    headers = {p.name for p in build.CSRC.glob("*.cuh")}
    assert {"dropout.cuh", "attention_bwd.cuh"} <= headers
    for src in list(build.CSRC.glob("*.cu")) + list(build.CSRC.glob("*.cuh")):
        for inc in re.findall(r'#include "([^"]+)"', src.read_text()):
            assert inc in headers, f"{src.name} includes {inc}"
