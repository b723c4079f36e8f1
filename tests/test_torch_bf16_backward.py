"""The plain bf16 backwards of B4 and B6 against the JAX backward kernels, and
the plain bf16 training forwards of B3 and B5.

A bf16 train step on the kernel route hands ``masked_attention_trainable`` and
``bias_attention_trainable`` bf16 q, k and v; their backward kernels
(``_masked_bwd``, ``_bias_bwd_rule``) take an fp32 g and cast dq, dK and dV
back to bf16. Here ``jax.vjp`` of the two functions runs their Pallas kernels
in interpret mode (``_relpos_bwd.interpret`` set, as
``tests/test_torch_train_kernels.py`` sets it; built once for the file) at rate
0, and the port's backward wrappers, given CPU tensors, compute their plain
versions, which the card's kernels are held to in ``chip_smoke.py`` and
``tests/test_torch_kernels_gpu.py``.

Tolerance: one bf16 ulp of each gradient element (of the larger of the two
values), plus 2^-16 of the magnitudes of its terms for the fp32 sums. Both
sides form every product in fp32 from the widened operands and round once at
the end, so they differ where fp32 sums in another order (JAX adds dK and dV
over query blocks of 128) fall on two sides of a bf16 rounding boundary, or
where a sum cancels far below its terms (an fp32 sum of n terms errs by up to
n 2^-24 of them; T <= 256 here). Measured: 2 ulps at most, at such cancelled
elements; the largest share of the bound any element reached is 0.99 (one ulp
apart where two roundings straddle; ``-s`` prints each tensor's share).

The training forward: with dropout the plain bf16 form rounds p·kf to bf16,
the keep factor first (`pallas_attention.py:413-418`), under the same mask as
the fp32 form (``dropout_keep_reference``). About 15 worker-seconds, most of
it the JAX kernels' interpret mode.
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

MASKED_CASES = [(64, 16), (128, 24), (256, 64)]                # (T, D)
BIAS_CASES = [(70, 24, 16), (128, 48, 64), (100, 30, 24)]      # (TQ, TK, D)


def _bf16(rng, *shape):
    """bf16 values (as float32 numpy) from a seeded normal draw."""
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16().float().numpy()


def _masked_inputs(t, d):
    """bf16 q, k, v, the ragged key bias [2, 1, T] and an fp32 g."""
    rng = np.random.RandomState(t + d)
    q, k, v = (_bf16(rng, 2, 2, t, d) for _ in range(3))
    n_valid = np.array([t - t // 4, t])
    kvb = np.where(np.arange(t)[None] < n_valid[:, None], 0.0, NEG_INF)
    g = rng.randn(2, 2, t, d).astype(np.float32)
    return q, k, v, kvb.astype(np.float32)[:, None, :], g


def _bias_inputs(tq, tk, d):
    """bf16 q, k, v, the unit decoder's wait-k cross mask (a query sees the
    first i // 3 + 1 keys; the last row's 5 keys invalid; row 1's query 3
    wholly masked, as a padded query row is) and an fp32 g."""
    rng = np.random.RandomState(tq + tk + d)
    q, k, v = _bf16(rng, 2, 2, tq, d), _bf16(rng, 2, 2, tk, d), _bf16(rng, 2, 2, tk, d)
    i, j = np.arange(tq)[:, None], np.arange(tk)[None]
    allowed = (j < np.minimum(i // 3 + 1, tk))[None] & \
        (np.arange(tk) < np.array([tk, tk - 5])[:, None])[:, None, :]
    allowed[1, 3] = False
    g = rng.randn(2, 2, tq, d).astype(np.float32)
    return q, k, v, np.where(allowed, 0.0, NEG_INF).astype(np.float32), g


def _to_torch(q, k, v, bias, g):
    return [torch.from_numpy(a).bfloat16() for a in (q, k, v)] + \
        [torch.from_numpy(bias), torch.from_numpy(g)]


@pytest.fixture(scope="module")
def jax_grads():
    """``jax.vjp`` of the two trainable functions at every case (interpret
    mode, rate 0): bf16 dq, dK, dV as float32 numpy."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pa._relpos_bwd, "interpret", True)
        for t, d in MASKED_CASES:
            q, k, v, kvb, g = _masked_inputs(t, d)
            fn = lambda q, k, v: pa.masked_attention_trainable(  # noqa: E731
                q, k, v, jnp.asarray(kvb), None, d ** -0.5, True, 128, 0.0)
            _, vjp = jax.vjp(fn, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
            out["masked", t, d] = [np.asarray(x.astype(jnp.float32))
                                   for x in vjp(jnp.asarray(g))]
        for tq, tk, d in BIAS_CASES:
            q, k, v, bias, g = _bias_inputs(tq, tk, d)
            fn = lambda q, k, v: pa.bias_attention_trainable(  # noqa: E731
                q, k, v, jnp.asarray(bias), None, d ** -0.5, 128, 0.0)
            _, vjp = jax.vjp(fn, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
            out["bias", tq, tk, d] = [np.asarray(x.astype(jnp.float32))
                                      for x in vjp(jnp.asarray(g))]
    return out


def _terms(family, q, k, v, bias, g, scale):
    """The magnitudes of each gradient element's terms: of dq and dK |ds|
    with delta's own magnitude, p (|dp| + Σ p |dp|) scale, times |K| or |q|;
    of dV p |g|."""
    probs = (attention._masked_probs if family == "masked" else attention._bias_probs)(
        q, k, bias, scale)
    dp = torch.einsum("bhsd,bhtd->bhst", g, v.float()).abs()
    ds = probs * (dp + (probs * dp).sum(-1, keepdim=True)) * scale
    return (torch.einsum("bhst,bhtd->bhsd", ds, k.float().abs()),
            torch.einsum("bhst,bhsd->bhtd", ds, q.float().abs()),
            torch.einsum("bhst,bhsd->bhtd", probs, g.abs()))


def _within_one_ulp(got, want, terms, name):
    """|got - want| within one bf16 ulp of the larger magnitude plus 2^-16 of
    the terms, elementwise."""
    got = got.float().numpy()
    mag = np.maximum(np.abs(got), np.abs(want))
    _, exp = np.frexp(mag)
    bound = np.where(mag > 0, np.ldexp(1.0, exp - 8), 0.0) + 2.0 ** -16 * terms.numpy()
    share = np.abs(got - want) / np.maximum(bound, 1e-38)
    print(f"{name}: largest share of the bound {share.max():.3g}")
    assert (np.abs(got - want) <= bound).all(), f"{name}: {share.max()} of the bound"


@pytest.mark.parametrize("t,d", MASKED_CASES)
def test_plain_bf16_causal_backward_matches_jax_kernel(jax_grads, t, d):
    q, k, v, kvb, g = _to_torch(*_masked_inputs(t, d))
    grads = attention.masked_attention_backward(q, k, v, kvb, g, None, None, None, d ** -0.5)
    assert all(x.dtype == torch.bfloat16 for x in grads)
    terms = _terms("masked", q, k, v, kvb, g, d ** -0.5)
    for name, got, want, t_ in zip(("dq", "dk", "dv"), grads, jax_grads["masked", t, d], terms):
        _within_one_ulp(got, want, t_, f"masked T={t} D={d} {name}")


@pytest.mark.parametrize("tq,tk,d", BIAS_CASES)
def test_plain_bf16_bias_backward_matches_jax_kernel(jax_grads, tq, tk, d):
    q, k, v, bias, g = _to_torch(*_bias_inputs(tq, tk, d))
    grads = attention.bias_attention_backward(q, k, v, bias, g, None, None, None, d ** -0.5)
    assert all(x.dtype == torch.bfloat16 for x in grads)
    terms = _terms("bias", q, k, v, bias, g, d ** -0.5)
    for name, got, want, t_ in zip(("dq", "dk", "dv"), grads, jax_grads["bias", tq, tk, d],
                                   terms):
        _within_one_ulp(got, want, t_, f"bias TQ={tq} TK={tk} D={d} {name}")


def test_bf16_autograd_returns_bf16_gradients_equal_to_the_backward():
    """Through autograd (``masked_attention`` on leaves that need a gradient)
    the bf16 inputs get bf16 gradients, equal to the backward wrapper's for
    the same seed and rate."""
    q, k, v, kvb, g = _to_torch(*_masked_inputs(64, 16))
    seed = torch.tensor([7])
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = attention.masked_attention(*leaves, kvb, 0.25, 0.1, seed)
    out.backward(g)
    want = attention.masked_attention_backward(q, k, v, kvb, g, out, None, seed, 0.25, 0.1)
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.bfloat16
        assert torch.equal(leaf.grad, w)


@pytest.mark.parametrize("family", ["masked", "bias"])
def test_plain_bf16_training_forward_draws_the_fp32_forms_mask(family):
    """With dropout the plain bf16 forward multiplies each probability by its
    keep factor and then rounds it to bf16: with v the identity its nonzero
    elements are those of the fp32 form's output under the same seed, and it
    equals bf16(p·kf) as the fp32 probabilities give it."""
    t, rate = 64, 0.1
    if family == "masked":
        q, k, _, bias, _ = _to_torch(*_masked_inputs(t, 16))
    else:
        q, k, _, bias, _ = _to_torch(*_bias_inputs(t, t, 16))
    q, k = (torch.cat([x, x, x, x], dim=-1) for x in (q, k))    # D = T = 64
    eye = torch.eye(t).expand(2, 2, t, t).contiguous()
    seed = torch.tensor([11])
    fwd = getattr(attention, f"{family}_attention_forward")
    out16, stats = fwd(q, k, eye.bfloat16(), bias, 0.125, rate, seed, True)
    out32, _ = fwd(q.float(), k.float(), eye, bias, 0.125, rate, seed, True)
    assert stats is None                         # the CPU forms keep no statistics
    keep = attention.dropout_keep_reference(seed, 2, 2, t, t, rate)
    assert 0.8 < float(keep.float().mean()) < 0.99
    assert torch.equal(out16 != 0, out32 != 0)
    probs = (attention._masked_probs if family == "masked" else attention._bias_probs)(
        q, k, bias, 0.125)
    want = torch.where(keep, probs * (1.0 / (1.0 - rate)), 0.0).bfloat16().float()
    assert torch.equal(out16, want)


def test_bf16_wrappers_raise_on_dtypes_without_an_instance():
    """float16, q/k/v of mixed dtypes and a bf16 g (the output, and so g, is
    float32) raise on every device, before any plain version runs."""
    q, k, v, kvb, g = _to_torch(*_masked_inputs(64, 16))
    bias = torch.zeros(2, 64, 64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attention.masked_attention(q.half(), k.half(), v.half(), kvb, 0.25)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attention.bias_attention_forward(q, k.float(), v, bias, 0.25)
    with pytest.raises(ValueError, match="g must be float32"):
        attention.masked_attention_backward(q, k, v, kvb, g.bfloat16(), None, None, None,
                                            0.25)
    with pytest.raises(ValueError, match="g must be float32"):
        attention.bias_attention_backward(q, k, v, bias, g.bfloat16(), None, None, None, 0.25)
