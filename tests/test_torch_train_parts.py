"""The parts of the port's train step against the JAX package on the same
numpy-seeded inputs: the LR schedules, the optimizer against
``make_optimizer``'s optax chain (clipping, Adam, decoupled weight decay,
``MultiSteps``, the overflow guard), BatchNorm's batch statistics against flax
``nn.BatchNorm``, the multitask criterion, ``synthetic_batch``, SpecAugment's
apply and draws, R-Drop's KL, dropout, and the attention wrappers' gradients
under autograd. Each tolerance is stated where it is used."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from streamspeech_tpu.config import OptimizationConfig as JaxOptimizationConfig
from streamspeech_tpu.train import criterion as jcrit
from streamspeech_tpu.train import lr as jlr
from streamspeech_tpu.train import synthetic as jsyn
from streamspeech_tpu.train.trainer import make_optimizer as jax_make_optimizer

from streamspeech_tpu_torch import config as pconfig
from streamspeech_tpu_torch.config import OptimizationConfig
from streamspeech_tpu_torch.kernels import attention
from streamspeech_tpu_torch.models.layers import BatchNorm, dropout
from streamspeech_tpu_torch.ops.specaugment import specaugment_apply, specaugment_draws
from streamspeech_tpu_torch.train import criterion as pcrit
from streamspeech_tpu_torch.train import lr as plr
from streamspeech_tpu_torch.train import synthetic as psyn
from streamspeech_tpu_torch.train import trainer as ptrain
from tests.torch_threads import one_torch_thread  # noqa: F401


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# LR schedule and optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lr,warmup,init", [(1e-3, 10, 1e-7), (5e-4, 4000, 1e-7),
                                            (2e-3, 1, 0.0)])
def test_inverse_sqrt_matches_jax(lr, warmup, init):
    """Steps 0...30 (warmup, the turn and the decay), float32 as JAX computes."""
    want = jlr.inverse_sqrt(lr, warmup, init)
    got = plr.inverse_sqrt(lr, warmup, init)
    for step in range(31):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))), rtol=1e-7,
                                   err_msg=str(step))
    assert plr.fixed(lr)(7) == float(jlr.fixed(lr)(7))


def _grad_sequence(seed, calls=6, bad_call=3):
    """Gradients for two parameters over ``calls`` calls; call ``bad_call``
    carries an inf (the overflow guard's case)."""
    rng = np.random.RandomState(seed)
    seq = [[rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
           for _ in range(calls)]
    seq[bad_call][0][1, 2] = np.inf
    return seq


@pytest.mark.parametrize("update_freq", [1, 2])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("clip_norm", [0.5, 100.0])
def test_optimizer_matches_optax(clip_norm, weight_decay, update_freq):
    """6 calls of the same gradients through the port's optimizer and through
    ``make_optimizer``'s chain, each call behind the train step's overflow
    guard (non-finite grads zeroed, the update still run). Clip 0.5 is active
    (grad norms ~4), 100 is not. Params within 1e-6."""
    kw = dict(lr=1e-2, warmup_updates=3, clip_norm=clip_norm,
              weight_decay=weight_decay, update_freq=update_freq)
    tx = jax_make_optimizer(JaxOptimizationConfig(**kw))
    rng = np.random.RandomState(1)
    init = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    jparams = [jnp.asarray(p) for p in init]
    jstate = tx.init(jparams)
    popt = ptrain.make_optimizer(OptimizationConfig(**kw))
    pparams = [_t(p) for p in init]
    pstate = popt.init(pparams)
    moved = 0
    for grads in _grad_sequence(2):
        jg = [jnp.asarray(g) for g in grads]
        finite = jnp.isfinite(optax.global_norm(jg))
        jg = [jnp.where(finite, g, jnp.zeros_like(g)) for g in jg]
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)

        pg, _, pfinite = ptrain.guard_nonfinite([_t(g) for g in grads])
        assert bool(pfinite) == bool(finite)
        pupdates, pstate = popt.update(pg, pstate, pparams)
        if pupdates is not None:
            pparams = [p + u for p, u in zip(pparams, pupdates)]
            moved += 1
        for got, want in zip(pparams, jparams):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert moved == 6 // update_freq
    assert pstate.count == 6 // update_freq


@pytest.mark.parametrize("scale", [2.0, 1.0, 0.5])
def test_clip_is_optax_not_torch(scale):
    """optax scales by max_norm / norm where norm >= max_norm, with no +1e-6:
    at a global norm of 2e-3 that term is a 5e-4 relative difference, which
    ``clip_grad_norm_`` shows and the port does not (rtol 1e-6)."""
    rng = np.random.RandomState(0)
    grads = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in grads))
    grads = [g / norm * 2e-3 for g in grads]
    max_norm = 2e-3 / scale
    want, _ = optax.clip_by_global_norm(max_norm).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = ptrain.clip_by_global_norm([_t(g) for g in grads], max_norm)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=0)
    clipped = [_t(g) for g in grads]
    torch.nn.utils.clip_grad_norm_(clipped, max_norm)
    if scale > 1:
        rel = float((clipped[0] - got[0]).abs().max() / got[0].abs().max())
        assert rel > 1e-4


# ---------------------------------------------------------------------------
# BatchNorm
# ---------------------------------------------------------------------------


def test_batchnorm_batch_statistics_match_flax():
    """Train-mode BatchNorm over every B×T position (padded frames included,
    here all-zero rows), biased variance, running stats 0.9·ra + 0.1·batch;
    output and running stats within 1e-5."""
    rng = np.random.RandomState(0)
    c = 6
    x = (rng.randn(3, 11, c) * 2 + 0.5).astype(np.float32)
    x[1, 7:] = 0.0
    x[2, 4:] = 0.0
    mean0 = rng.randn(c).astype(np.float32) * 0.1
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, c).astype(np.float32), rng.randn(c).astype(np.float32)
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    want, mutated = bn.apply(variables, jnp.asarray(x), use_running_average=False,
                             mutable=["batch_stats"])
    mod = BatchNorm(c)
    with torch.no_grad():
        mod.weight.copy_(_t(scale))
        mod.bias.copy_(_t(bias))
        mod.running_mean.copy_(_t(mean0))
        mod.running_var.copy_(_t(var0))
    got = mod(_t(x), use_running_stats=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(mod.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]), atol=1e-5)
    np.testing.assert_allclose(mod.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]), atol=1e-5)
    # eval mode reads the running buffers and writes nothing
    before = mod.running_var.clone()
    want_eval = bn.apply({"params": variables["params"],
                          "batch_stats": mutated["batch_stats"]}, jnp.asarray(x),
                         use_running_average=True)
    np.testing.assert_allclose(mod(_t(x)).detach().numpy(), np.asarray(want_eval),
                               atol=1e-5)
    assert torch.equal(before, mod.running_var)


# ---------------------------------------------------------------------------
# Criterion and synthetic batches
# ---------------------------------------------------------------------------


def _criterion_inputs(seed=0, b=3, s=5, up=4, t=16, vt=11, vu=9):
    rng = np.random.RandomState(seed)
    mt_valid = np.ones((b, s), bool)
    mt_valid[1, 3:] = False
    mt_targets = rng.randint(4, vt, size=(b, s)).astype(np.int32)
    mt_targets[1, 3:] = 1
    out = {"unit_logits": rng.randn(b, s * up, vu).astype(np.float32) * 2,
           "mt_logits": rng.randn(b, s, vt).astype(np.float32) * 2,
           "asr_logits": rng.randn(b, t, vt).astype(np.float32) * 2,
           "st_logits": rng.randn(b, t, vt).astype(np.float32) * 2,
           "mt_valid": mt_valid,
           "encoder_lengths": np.array([16, 12, 9], np.int32)}
    batch = {"target_units": rng.randint(4, vu - 1, size=(b, 7)).astype(np.int32),
             "target_unit_lengths": np.array([7, 5, 6], np.int32),
             "mt_targets": mt_targets,
             "src_text": rng.randint(4, vt, size=(b, 4)).astype(np.int32),
             "src_text_lengths": np.array([4, 2, 0], np.int32),
             "tgt_text": rng.randint(4, vt, size=(b, 6)).astype(np.int32),
             "tgt_text_lengths": np.array([6, 3, 5], np.int32)}
    return out, batch


def _port_tensors(d):
    return {k: (_t(v).long() if v.dtype in (np.int32, np.int64) else _t(v))
            for k, v in d.items()}


@pytest.mark.parametrize("weights", [
    dict(), dict(unit_ctc=0.0), dict(unit_surrogate=True),
    dict(source_unigram=0.0, ctc_target_unigram=0.0, label_smoothing=0.0),
])
def test_streamspeech_loss_matches_jax(weights):
    """Every component of the criterion on the same ``out`` dict, rtol 1e-5."""
    out, batch = _criterion_inputs()
    unit_blank = out["unit_logits"].shape[-1] - 1
    want = jcrit.streamspeech_loss({k: jnp.asarray(v) for k, v in out.items()},
                                   {k: jnp.asarray(v) for k, v in batch.items()},
                                   unit_blank, jcrit.CriterionWeights(**weights))
    got = pcrit.streamspeech_loss(_port_tensors(out), _port_tensors(batch), unit_blank,
                                  pcrit.CriterionWeights(**weights))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5,
                                   err_msg=key)
    assert float(got["loss"]) > 0


def test_label_smoothing_is_fairseqs():
    """eps_i = eps / (V - 1): not ``F.cross_entropy(label_smoothing=eps)``
    (eps / V)."""
    out, batch = _criterion_inputs(1)
    logits, targets = _t(out["mt_logits"]), _t(batch["mt_targets"]).long()
    valid = targets != 1
    got = pcrit.label_smoothed_nll(logits, targets, valid, 0.1)
    want = jcrit.label_smoothed_nll(jnp.asarray(out["mt_logits"]),
                                    jnp.asarray(batch["mt_targets"]),
                                    jnp.asarray(batch["mt_targets"] != 1), 0.1)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-6)
    torch_ls = torch.nn.functional.cross_entropy(
        logits[valid], targets[valid], label_smoothing=0.1, reduction="sum")
    assert abs(float(torch_ls) - float(got["loss"])) > 1e-3


@pytest.mark.parametrize("name,kw", [("tiny_config", dict(batch=4)),
                                     ("full_config", dict(batch=2, frames=1024, mt_len=48,
                                                          units_len=256, text_len=32))])
def test_synthetic_batch_matches_jax(name, kw):
    cfg = getattr(pconfig, name)()
    got = psyn.synthetic_batch(cfg, **kw)
    want = jsyn.synthetic_batch(getattr(jsyn, name)(), **kw)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    tensors = psyn.batch_to_tensors(got, device="cpu")
    assert tensors["n2"] == 2 and tensors["src_tokens"].dtype == torch.float32
    assert tensors["target_units"].dtype == torch.int64


# ---------------------------------------------------------------------------
# SpecAugment, R-Drop, dropout
# ---------------------------------------------------------------------------


def _specaugment_numpy(x, draws):
    """The JAX semantics (`specaugment.py:33-50`) row by row in numpy, on given
    draws: each frequency mask [f0, f0 + f), then each time mask [t0, t0 + t),
    filled with 0.0."""
    x = x.copy()
    for b in range(x.shape[0]):
        for f0, f in zip(draws["f0"][b], draws["f"][b]):
            x[b, :, f0:f0 + f] = 0.0
        for t0, t in zip(draws["t0"][b], draws["t"][b]):
            x[b, t0:t0 + t, :] = 0.0
    return x


def test_specaugment_apply_matches_the_jax_semantics():
    rng = np.random.RandomState(0)
    x = rng.randn(3, 40, 20).astype(np.float32)
    draws = {"f": np.array([[5, 0], [3, 20], [1, 2]]),
             "f0": np.array([[2, 7], [17, 0], [19, 0]]),
             "t": np.array([[10], [0], [39]]),
             "t0": np.array([[35], [3], [1]])}
    got = specaugment_apply(_t(x), {k: _t(v) for k, v in draws.items()})
    np.testing.assert_array_equal(got.numpy(), _specaugment_numpy(x, draws))


def test_specaugment_draws_stay_within_the_jax_bounds():
    """`specaugment.py:36-46`: f in [0, F], f0 in [0, max(f_dim - f, 1)),
    t in [0, max(min(T, int(len·p)), 1)], t0 in [0, max(len - t, 1))."""
    lengths = torch.tensor([40, 7, 1, 0, 300])
    f_dim, big_f, big_t, p = 80, 27, 100, 0.5
    seen_t = set()
    for seed in range(40):
        d = specaugment_draws(torch.Generator().manual_seed(seed), lengths, f_dim,
                              freq_mask_n=2, freq_mask_f=big_f, time_mask_n=1,
                              time_mask_t=big_t, time_mask_p=p)
        assert d["f"].shape == (5, 2) and d["t"].shape == (5, 1)
        assert ((d["f"] >= 0) & (d["f"] <= big_f)).all()
        assert ((d["f0"] >= 0) & (d["f0"] < torch.clamp(f_dim - d["f"], min=1))).all()
        max_t = torch.clamp(torch.clamp((lengths * p).long(), max=big_t), min=1)
        assert ((d["t"] >= 0) & (d["t"] <= max_t[:, None])).all()
        assert ((d["t0"] >= 0) & (d["t0"] < torch.clamp(lengths[:, None] - d["t"],
                                                          min=1))).all()
        seen_t.update(d["t"][4].tolist())
    assert max(seen_t) > 50                      # the 300-frame row reaches long masks
    a = specaugment_draws(torch.Generator().manual_seed(3), lengths, f_dim)
    b = specaugment_draws(torch.Generator().manual_seed(3), lengths, f_dim)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_rdrop_kl_matches_the_jax_formula():
    """`trainer.py:122-126` on the same logits, PAD targets excluded."""
    rng = np.random.RandomState(4)
    l1, l2 = (rng.randn(2, 5, 9).astype(np.float32) for _ in range(2))
    tgt = rng.randint(2, 9, size=(2, 5)).astype(np.int32)
    tgt[1, 3:] = 1
    p = jax.nn.log_softmax(jnp.asarray(l1), -1)
    q = jax.nn.log_softmax(jnp.asarray(l2), -1)
    want = 0.5 * jnp.sum((jnp.exp(p) * (p - q) + jnp.exp(q) * (q - p))
                         * (jnp.asarray(tgt) != 1)[..., None])
    got = ptrain.rdrop_kl(_t(l1), _t(l2), _t(tgt).long())
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(ptrain.rdrop_kl(_t(l1), _t(l1), _t(tgt).long())) == 0.0


def test_dropout_has_flax_semantics():
    """Keep with probability 1 - p from the generator, scale by 1 / (1 - p);
    identity when deterministic or at rate 0; a generator is required."""
    x = torch.ones(200, 100)
    y = dropout(x, 0.25, False, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.75) < 0.01
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.75))
    assert torch.equal(dropout(x, 0.25, False, torch.Generator().manual_seed(0)), y)
    assert not torch.equal(dropout(x, 0.25, False, torch.Generator().manual_seed(1)), y)
    assert dropout(x, 0.25, True, None) is x and dropout(x, 0.0, False, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.25, False, None)


# ---------------------------------------------------------------------------
# The attention kernel wrappers under autograd
# ---------------------------------------------------------------------------


def test_attention_wrappers_raise_under_autograd():
    """The attention wrappers are differentiable: where autograd needs a
    gradient through one it arrives (it used to raise) and equals the plain
    version's, on the CPU as on the card; under ``no_grad`` or without such
    inputs a wrapper computes as before and records no graph."""
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(1, 2, 64, 8).astype(np.float32)).requires_grad_()
    g = torch.from_numpy(rng.randn(1, 2, 64, 8).astype(np.float32))
    kvb = torch.zeros(1, 1, 64)
    bias = torch.zeros(1, 64, 64)
    p = torch.from_numpy(rng.randn(2, 127, 8).astype(np.float32))
    calls = {
        "masked_attention": (
            lambda x: attention.masked_attention(x, x, x, kvb, 0.3),
            lambda x: attention.masked_attention_reference(x, x, x, kvb, 0.3)),
        "bias_attention": (
            lambda x: attention.bias_attention(x, x, x, bias, 0.3),
            lambda x: attention.bias_attention_reference(x, x, x, bias, 0.3)),
        "relpos_attention": (
            lambda x: attention.relpos_attention(x, x, x, x, p, bias[:, None], 0.3),
            lambda x: attention.relpos_attention_reference(x, x, x, x, p, bias[:, None],
                                                           0.3)),
    }
    for name, (call, plain) in calls.items():
        out = call(q)
        assert out.grad_fn is not None, name
        (got,) = torch.autograd.grad(out, q, g)
        (want,) = torch.autograd.grad(plain(q), q, g)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=name)
        with torch.no_grad():
            quiet = call(q)
        assert quiet.grad_fn is None and call(q.detach()).grad_fn is None
        torch.testing.assert_close(quiet, out.detach(), rtol=0, atol=0)
