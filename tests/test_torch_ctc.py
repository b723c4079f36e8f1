"""The port's CTC loss half (``ops/ctc.py``) and its DP kernels' plain versions
(``kernels/ctc.py``) against the JAX package on the same numpy-seeded inputs:
per-row NLL and its gradient against the Pallas kernels in interpret mode and
against the scan form; the plain alpha and the plain beta/occupancy gradient
against the Pallas kernels and the ``ctc_nll_pallas`` custom_vjp; the fused
pair and the zero_infinity sums. Tolerances are ``tests/test_ctc_pallas.py``'s
(values rtol/atol 2e-5, gradients rtol 2e-4 / atol 2e-5) unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.ops import ctc as jctc
from streamspeech_tpu.ops import pallas_ctc as jpc

from streamspeech_tpu_torch.kernels import ctc as kctc
from streamspeech_tpu_torch.ops import ctc as pctc
from tests.torch_threads import one_torch_thread  # noqa: F401

VAL = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=2e-4, atol=2e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def random_case(seed, b=3, t=20, v=7, n=6, blank=6):
    """`tests/test_ctc_pallas.py:15-21`."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, t, v).astype(np.float32) * 2.0
    logit_lengths = rng.randint(t // 2, t + 1, size=(b,)).astype(np.int32)
    labels = rng.randint(0, v - 1, size=(b, n)).astype(np.int32)
    label_lengths = rng.randint(1, n + 1, size=(b,)).astype(np.int32)
    return logits, logit_lengths, labels, label_lengths, blank


def _repeated_case():
    logits = np.random.RandomState(5).randn(2, 12, 5).astype(np.float32)
    return (logits, np.array([12, 9], np.int32),
            np.array([[2, 2, 2], [1, 3, 1]], np.int32), np.array([3, 3], np.int32), 4)


def _empty_case():
    logits = np.random.RandomState(5).randn(2, 12, 5).astype(np.float32)
    return (logits, np.array([12, 9], np.int32),
            np.array([[2, 2, 2], [1, 3, 1]], np.int32), np.array([0, 2], np.int32), 4)


def _impossible_case():
    logits = np.random.RandomState(3).randn(2, 4, 5).astype(np.float32)
    return (logits, np.array([4, 4], np.int32), np.array([[1, 1, 1, 1], [1, 2, 0, 0]],
                                                         np.int32),
            np.array([4, 2], np.int32), 4)


CASES = {
    "default": lambda: random_case(0),
    "b8": lambda: random_case(1, b=8, t=40, v=11, n=9, blank=10),
    "long_t": lambda: random_case(2, b=2, t=130, v=5, n=3, blank=4),
    "blank0": lambda: random_case(3, b=9, t=16, v=6, n=4, blank=0),
    "repeated": _repeated_case,
    "empty": _empty_case,
    "impossible": _impossible_case,
}


def _port_nll(fn, case, requires_grad=False):
    logits, ll, labels, ln, blank = case
    x = _t(logits).requires_grad_(requires_grad)
    return x, fn(x, _t(ll).long(), _t(labels).long(), _t(ln).long(), blank)


def _zi_sum(nll):
    return jnp.sum(jnp.where(jnp.isfinite(nll) & (nll < 1e29), nll, 0.0))


@pytest.fixture(scope="module")
def jax_cases():
    """Per case, one jit of the JAX side both NLL tests read: the Pallas
    kernel's per-row NLL (interpret mode), the scan form's, and the value and
    gradient of the zero_infinity sum through the Pallas custom_vjp."""
    out = {}
    for name, make in CASES.items():
        case = make()
        args = [jnp.asarray(a) for a in case[:-1]]

        def run(lg, args=args, blank=case[-1]):
            def loss(x):
                nll = jpc.ctc_neg_log_likelihood_pallas(x, *args[1:], blank, interpret=True)
                return _zi_sum(nll), nll
            (value, nll), grad = jax.value_and_grad(loss, has_aux=True)(lg)
            return nll, jctc.ctc_neg_log_likelihood(lg, *args[1:], blank_id=blank), value, grad

        out[name] = [np.asarray(x) for x in jax.jit(run)(args[0])]
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_nll_matches_jax(jax_cases, name):
    case = CASES[name]()
    want_kernel, want_scan = jax_cases[name][:2]
    for fn in (kctc.ctc_neg_log_likelihood_kernel, pctc.ctc_neg_log_likelihood):
        with torch.no_grad():
            _, got = _port_nll(fn, case)
        np.testing.assert_allclose(got.numpy(), want_kernel, **VAL, err_msg=fn.__name__)
        np.testing.assert_allclose(got.numpy(), want_scan, **VAL, err_msg=fn.__name__)


@pytest.mark.parametrize("name", sorted(CASES))
def test_nll_gradient_matches_jax(jax_cases, name):
    """d sum(zero_infinity(nll)) / d logits through the port's autograd.Function
    (plain alpha forward, plain beta backward) and through the scan form,
    against JAX's Pallas custom_vjp in interpret mode."""
    case = CASES[name]()
    want_v, want_g = jax_cases[name][2:]
    for fn in (kctc.ctc_neg_log_likelihood_kernel, pctc.ctc_neg_log_likelihood):
        x, nll = _port_nll(fn, case, requires_grad=True)
        total = pctc._zero_infinity_sum(nll)
        total.backward()
        np.testing.assert_allclose(float(total.detach()), float(want_v), rtol=1e-5)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), **GRAD,
                                   err_msg=fn.__name__)


def test_impossible_alignment_gives_exactly_zero_grad():
    case = _impossible_case()
    x, nll = _port_nll(kctc.ctc_neg_log_likelihood_kernel, case, requires_grad=True)
    assert float(nll[0].detach()) > 1e29 and float(nll[1].detach()) < 1e29
    nll[0].backward()
    assert not x.grad.any()


def _dp_inputs(seed, b=3, t=24, v=9, n=7, blank=8):
    """JAX's unpadded DP inputs and the port's, from one case (T a multiple of
    the interpret-mode block of 8)."""
    logits, ll, labels, ln, blank = random_case(seed, b=b, t=t, v=v, n=n, blank=blank)
    ln[0] = 0                                          # one empty label row
    jparts = jpc._ext_and_masks(jnp.asarray(logits), jnp.asarray(ll),
                                jnp.asarray(labels), jnp.asarray(ln), blank)
    pparts = kctc.ext_and_masks(_t(logits), _t(ll).long(), _t(labels).long(),
                                _t(ln).long(), blank)
    return jparts, pparts


def test_ext_and_masks_match_jax():
    jparts, pparts = _dp_inputs(4)
    for key in ("lp_ext", "initmask", "endmask", "skipmask", "validmask"):
        np.testing.assert_allclose(pparts[key].numpy(), np.asarray(jparts[key]),
                                   rtol=0, atol=1e-6, err_msg=key)


def _jax_aux(jparts):
    b, t, s = jparts["lp_ext"].shape
    return {"initmask": jparts["initmask"], "endmask": jparts["endmask"],
            "skipmask": jparts["skipmask"],
            "validmask": jnp.broadcast_to(jparts["validmask"][:, :, None], (b, t, s))}


def test_plain_alpha_matches_the_pallas_alpha_kernel():
    jparts, pparts = _dp_inputs(6)
    want = np.asarray(jpc._run_alpha(jparts["lp_ext"], _jax_aux(jparts), 8, True))
    got = kctc.ctc_alpha(pparts["lp_ext"], pparts["initmask"], pparts["skipmask"],
                         pparts["validmask"])
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


def test_plain_beta_occupancy_matches_the_pallas_custom_vjp():
    """The port's plain beta recursion gives the gradient that JAX's
    ``ctc_nll_pallas`` custom_vjp gives in interpret mode, for an upstream
    cotangent of ones; -exp(min(α+β-logZ, 0)) is 0 on padded frames."""
    jparts, pparts = _dp_inputs(8)
    want = np.asarray(jax.grad(lambda lp: jnp.sum(jpc.ctc_nll_pallas(
        lp, _jax_aux(jparts), 8, True)))(jparts["lp_ext"]))
    alpha = kctc.ctc_alpha_reference(pparts["lp_ext"], pparts["initmask"],
                                     pparts["skipmask"], pparts["validmask"])
    _, logz = kctc.nll_from_alpha(alpha, pparts["endmask"])
    zbias = torch.where(logz > kctc.NNEG / 2, -logz, torch.full_like(logz, kctc.NNEG))
    got = kctc.ctc_beta_grad(pparts["lp_ext"], pparts["endmask"], pparts["skipmask"],
                             zbias, pparts["validmask"], alpha)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-6)
    padded = pparts["validmask"] == 0
    assert padded.any() and not got[padded].any()
    occupancy = -got.sum(-1)                 # every valid frame is in one state
    valid = pparts["validmask"] > 0
    np.testing.assert_allclose(occupancy[valid].numpy(), 1.0, atol=1e-5)


def _pair_heads(seed_a, seed_b):
    a = random_case(seed_a, b=3, t=20, v=9, n=7, blank=0)
    b = random_case(seed_b, b=3, t=20, v=5, n=3, blank=0)
    b[3][1] = 0                                        # an empty label row
    return a, b


def test_loss_sum_pair_matches_jax():
    """Heads of different N (S 15 and 7, padded to 15 in the port's merge):
    the fused pair's sums and gradients against JAX's pair and against its
    Pallas multi-head kernel in interpret mode."""
    a, b = _pair_heads(21, 22)

    def jax_heads(lg_a, lg_b):
        return [(lg_a, *map(jnp.asarray, a[1:4])), (lg_b, *map(jnp.asarray, b[1:4]))]

    def jloss_pair(lg_a, lg_b):
        sa, sb = jctc.ctc_loss_sum_pair(*jax_heads(lg_a, lg_b)[0],
                                        *jax_heads(lg_a, lg_b)[1], blank_id=0)
        return sa + 2.0 * sb, (sa, sb)

    def jloss_multi(lg_a, lg_b):
        na, nb = jpc.ctc_neg_log_likelihood_pallas_multi(jax_heads(lg_a, lg_b), 0,
                                                         interpret=True)
        return _zi_sum(na) + 2.0 * _zi_sum(nb)

    lg = (jnp.asarray(a[0]), jnp.asarray(b[0]))
    (_, (want_a, want_b)), want_g = jax.jit(jax.value_and_grad(jloss_pair, argnums=(0, 1),
                                                               has_aux=True))(*lg)
    multi_g = jax.jit(jax.grad(jloss_multi, argnums=(0, 1)))(*lg)
    xa, xb = _t(a[0]).requires_grad_(), _t(b[0]).requires_grad_()
    got_a, got_b = pctc.ctc_loss_sum_pair(
        xa, _t(a[1]).long(), _t(a[2]).long(), _t(a[3]).long(),
        xb, _t(b[1]).long(), _t(b[2]).long(), _t(b[3]).long(), blank_id=0)
    (got_a + 2.0 * got_b).backward()
    np.testing.assert_allclose(float(got_a), float(want_a), rtol=1e-5)
    np.testing.assert_allclose(float(got_b), float(want_b), rtol=1e-5)
    for got, want, multi in ((xa.grad, want_g[0], multi_g[0]),
                             (xb.grad, want_g[1], multi_g[1])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD)
        np.testing.assert_allclose(got.numpy(), np.asarray(multi), **GRAD)


def test_loss_sum_applies_zero_infinity():
    case = _impossible_case()
    want = jctc.ctc_loss_sum(*map(jnp.asarray, case[:-1]), blank_id=case[-1])
    got = pctc.ctc_loss_sum(*(_t(a).long() if a.dtype == np.int32 else _t(a)
                              for a in case[:-1]), blank_id=case[-1])
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert 0 < float(got) < 1e29


def test_gather_extended_logprobs_matches_jax():
    logits, _, labels, _, blank = random_case(12, b=2, t=9, v=13, n=5, blank=3)
    want = jctc.gather_extended_logprobs_from_logits(jnp.asarray(logits),
                                                     jnp.asarray(labels), blank)
    got = pctc.gather_extended_logprobs_from_logits(_t(logits), _t(labels).long(), blank)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_kernel_wrappers_check_their_inputs():
    lp = torch.zeros(2, 5, 7)
    mask, valid = torch.zeros(2, 7), torch.ones(2, 5)
    kctc._check(lp, (("initmask", mask, (2, 7)), ("validmask", valid, (2, 5))))
    with pytest.raises(ValueError):                                  # mask shape
        kctc._check(lp, (("initmask", mask[:1], (2, 7)),))
    with pytest.raises(ValueError):                                  # dtype
        kctc._check(lp, (("validmask", valid.double(), (2, 5)),))
    with pytest.raises(ValueError):                                  # contiguity
        kctc._check(lp, (("initmask", torch.zeros(7, 2).T, (2, 7)),))
    with pytest.raises(ValueError):                                  # S too large
        kctc._check(torch.zeros(1, 2, kctc.MAX_STATES + 1), ())
    with pytest.raises(ValueError):                                  # T = 0
        kctc._check(torch.zeros(1, 0, 3), ())
