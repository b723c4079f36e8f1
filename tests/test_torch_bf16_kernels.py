"""The plain bf16 forms of B3, B5 and B7 against the JAX kernels on bf16 inputs.

A bf16 model hands the causal (``masked_attention``) and bias
(``bias_attention``) attention kernels bf16 q, k and v, and the not-blank
kernel (``not_blank_probs_pallas``) bf16 logits. The JAX kernels run here in
interpret mode (built once for the file); the port's wrappers, given CPU
tensors, compute their plain versions, which the card's kernels are held to in
``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py``.

Tolerances: attention 2e-3 (one bf16 rounding flip of a probability; both
sides form fp32 scores from the same bf16 products and normalise before the
cast, so a flip needs an fp32 difference across a bf16 rounding boundary;
measured: 1.4e-4 at T = 128, D = 24, where one probability flipped, at most
2.4e-7 elsewhere); the not-blank posterior 1e-6, as the fp32 form (posteriors
in [0, 1], fp32 on both sides after an exact widening; measured 6.0e-8).
About 11 worker-seconds, most of it the JAX kernels' interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.ops.pallas_attention import bias_attention as jax_bias_attention
from streamspeech_tpu.ops.pallas_attention import masked_attention as jax_masked_attention
from streamspeech_tpu.ops.pallas_policy import not_blank_probs_pallas

from streamspeech_tpu_torch.kernels import attention, policy
from streamspeech_tpu_torch.ops.masks import NEG_INF
from tests.torch_threads import one_torch_thread  # noqa: F401

ATTN_ATOL = 2e-3
NB_ATOL = 1e-6
MASKED_CASES = [(64, 16), (128, 24), (256, 64)]              # (T, D)
BIAS_CASES = [(70, 24, 16), (128, 48, 64), (100, 30, 24)]    # (TQ, TK, D)
NB_CASES = [(2, 64, 512, 0), (1, 65, 513, 512), (2, 70, 6001, 3)]  # (B, T, V, blank)




def _bf16(rng, *shape):
    """bf16 values (as float32 numpy) from a seeded normal draw."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).bfloat16()
    return x.float().numpy()


def _masked_inputs(t, d):
    rng = np.random.RandomState(t + d)
    q, k, v = (_bf16(rng, 2, 2, t, d) for _ in range(3))
    n_valid = np.array([t - t // 4, t])               # ragged key validity
    kvb = np.where(np.arange(t)[None] < n_valid[:, None], 0.0, NEG_INF)
    return q, k, v, kvb.astype(np.float32)[:, None, :]


def _bias_inputs(tq, tk, d):
    """q/k/v and the unit decoder's wait-k cross mask (a query sees the first
    i // 3 + 1 keys) with the last row's 5 keys invalid."""
    rng = np.random.RandomState(tq + tk + d)
    q, k, v = _bf16(rng, 2, 2, tq, d), _bf16(rng, 2, 2, tk, d), _bf16(rng, 2, 2, tk, d)
    i, j = np.arange(tq)[:, None], np.arange(tk)[None]
    allowed = (j < np.minimum(i // 3 + 1, tk))[None] & \
        (np.arange(tk) < np.array([tk, tk - 5])[:, None])[:, None, :]
    return q, k, v, np.where(allowed, 0.0, NEG_INF).astype(np.float32)


def _to_jax(*arrays, n_bf16):
    return [jnp.asarray(a, jnp.bfloat16) if i < n_bf16 else jnp.asarray(a)
            for i, a in enumerate(arrays)]


def _to_torch(*arrays, n_bf16):
    return [torch.from_numpy(a).bfloat16() if i < n_bf16 else torch.from_numpy(a)
            for i, a in enumerate(arrays)]


@pytest.fixture(scope="module")
def jax_out():
    """The JAX kernels (interpret mode) at every case, bf16 operands."""
    out = {}
    for t, d in MASKED_CASES:
        args = _to_jax(*_masked_inputs(t, d), n_bf16=3)
        out["masked", t, d] = np.asarray(jax_masked_attention(*args, d ** -0.5,
                                                              interpret=True))
    for tq, tk, d in BIAS_CASES:
        args = _to_jax(*_bias_inputs(tq, tk, d), n_bf16=3)
        out["bias", tq, tk, d] = np.asarray(jax_bias_attention(*args, d ** -0.5,
                                                               interpret=True))
    for b, t, v, blank in NB_CASES:
        logits = _bf16(np.random.RandomState(v + t), b, t, v) * 4
        out["nb", b, t, v, blank] = np.asarray(not_blank_probs_pallas(
            jnp.asarray(logits, jnp.bfloat16), blank, interpret=True))
    return out


@pytest.mark.parametrize("t,d", MASKED_CASES)
def test_plain_bf16_causal_attention_matches_jax_kernel(jax_out, t, d):
    q, k, v, kvb = _to_torch(*_masked_inputs(t, d), n_bf16=3)
    with torch.no_grad():
        got = attention.masked_attention(q, k, v, kvb, d ** -0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_out["masked", t, d], atol=ATTN_ATOL, rtol=0)


@pytest.mark.parametrize("tq,tk,d", BIAS_CASES)
def test_plain_bf16_bias_attention_matches_jax_kernel(jax_out, tq, tk, d):
    q, k, v, bias = _to_torch(*_bias_inputs(tq, tk, d), n_bf16=3)
    with torch.no_grad():
        got = attention.bias_attention(q, k, v, bias, d ** -0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_out["bias", tq, tk, d], atol=ATTN_ATOL,
                               rtol=0)


def test_plain_bf16_form_rounds_the_probabilities():
    """Not the fp32 form on widened inputs: the probabilities are rounded to
    bf16 before P·V (``probs.astype(v.dtype)``), which moves the output."""
    q, k, v, kvb = _to_torch(*_masked_inputs(128, 24), n_bf16=3)
    bf16 = attention.masked_attention_reference(q, k, v, kvb, 24 ** -0.5)
    fp32 = attention.masked_attention_reference(q.float(), k.float(), v.float(), kvb,
                                                24 ** -0.5)
    assert 0 < float((bf16 - fp32).abs().max()) <= 2.0 ** -8 * float(v.float().abs().max())


@pytest.mark.parametrize("b,t,v,blank", NB_CASES)
def test_plain_not_blank_on_bf16_logits_matches_jax_kernel(jax_out, b, t, v, blank):
    logits = torch.from_numpy(_bf16(np.random.RandomState(v + t), b, t, v) * 4).bfloat16()
    got = policy.not_blank_probs(logits, blank)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_out["nb", b, t, v, blank], atol=NB_ATOL,
                               rtol=0)


def test_bf16_wrappers_raise_where_no_bf16_form_exists():
    """The bf16 forms now train (a gradient, dropout and row statistics run);
    what has no form raises, on the CPU as on the card: float16, q/k/v of
    mixed dtypes, and a bf16 g (the output, and so g, is float32)."""
    q, k, v, kvb = _to_torch(*_masked_inputs(64, 16), n_bf16=3)
    bias = torch.zeros(2, 64, 64)
    leaf = q.clone().requires_grad_()
    out = attention.masked_attention(leaf, k, v, kvb, 0.25, 0.1, torch.tensor([3]))
    out.sum().backward()
    assert leaf.grad.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attention.masked_attention(q.half(), k.half(), v.half(), kvb, 0.25)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        attention.bias_attention(q, k.float(), v, bias, 0.25)
    g = torch.zeros_like(q)
    with pytest.raises(ValueError, match="g must be float32"):
        attention.masked_attention_backward(q, k, v, kvb, g, g, None, None, 0.25)
    with pytest.raises(ValueError, match="g must be float32"):
        attention.bias_attention_backward(q, k, v, bias, g, g, None, None, 0.25)
    with torch.no_grad():     # without a gradient the inference form runs
        assert attention.masked_attention(leaf, k, v, kvb, 0.25).dtype == torch.float32
