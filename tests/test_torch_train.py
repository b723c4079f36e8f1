"""The port's train step against the JAX package's ``make_train_step`` on the
CPU: ``tiny_config()`` with every dropout at 0 (the two RNG streams cannot
match), ``synthetic_batch(batch=4)``, chunk 4, conv chunk 8, the JAX weights
carried across by ``weights.load_flax_variables``. Then the kernel routes one
train step takes, dropout, R-Drop and SpecAugment in the step.

Tolerances: metrics rtol 1e-4 (fp32, another summation order); step-1
gradients per tensor within 1e-4·max|g| + 1e-7; params after k updates within
2·Σ lr (Adam turns near-zero gradients into ±lr steps, so a tighter bound
would test noise); BatchNorm running stats within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.config import OptimizationConfig as JaxOptimizationConfig
from streamspeech_tpu.models.streamspeech import StreamSpeechModel as JaxModel
from streamspeech_tpu.models.streamspeech import init_params
from streamspeech_tpu.train.criterion import streamspeech_loss as jax_loss
from streamspeech_tpu.train.synthetic import synthetic_batch as jax_batch
from streamspeech_tpu.train.synthetic import tiny_config as jax_tiny_config
from streamspeech_tpu.train.trainer import TrainState as JaxTrainState
from streamspeech_tpu.train.trainer import make_optimizer as jax_make_optimizer
from streamspeech_tpu.train.trainer import make_train_step as jax_make_train_step

from streamspeech_tpu_torch.config import OptimizationConfig, tiny_config
from streamspeech_tpu_torch.kernels import attention, policy
from streamspeech_tpu_torch.kernels import ctc as kctc
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.train import trainer as ptrain
from streamspeech_tpu_torch.train.synthetic import batch_to_tensors, synthetic_batch
from streamspeech_tpu_torch.weights import load_flax_variables, random_init_
from tests.torch_threads import one_torch_thread  # noqa: F401

CHUNK, CONV_CHUNK = 4, 8
OPT = dict(warmup_updates=10, lr=1e-3, clip_norm=1.0)
METRIC_RTOL = 1e-4


def _no_dropout(cfg):
    cfg.encoder.dropout = cfg.mt_decoder.dropout = cfg.unit_decoder.dropout = 0.0
    return cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_setup():
    jcfg = _no_dropout(jax_tiny_config())
    jmodel = JaxModel(jcfg)
    variables = _np(jax.jit(lambda k: init_params(jmodel, k))(jax.random.PRNGKey(0)))
    return jcfg, jmodel, variables, jax_batch(jcfg, batch=4)


@pytest.fixture(scope="module")
def jax_steps(jax_setup):
    """The JAX optimizer and jitted train step per ``update_freq``, made once
    for the file: each new step would compile again."""
    jcfg, jmodel, _, _ = jax_setup
    steps = {}

    def get(update_freq):
        if update_freq not in steps:
            jtx = jax_make_optimizer(JaxOptimizationConfig(update_freq=update_freq, **OPT))
            steps[update_freq] = jtx, jax_make_train_step(
                jmodel, jtx, unit_blank=jcfg.unit_decoder.vocab_size - 1)
        return steps[update_freq]
    return get


def _port_model(variables):
    """A port model holding a flax ``{"params", "batch_stats"}`` tree (weights,
    gradients or running stats), through the weights bridge."""
    return load_flax_variables(StreamSpeechModel(_no_dropout(tiny_config())), variables)


def _close_metrics(got, want):
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=METRIC_RTOL,
                                   atol=1e-6, err_msg=key)


def _run_both(jax_setup, jax_steps, update_freq, calls):
    jcfg, jmodel, variables, jbatch = jax_setup
    unit_blank = jcfg.unit_decoder.vocab_size - 1
    jtx, jstep = jax_steps(update_freq)
    jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), jtx)
    pmodel = _port_model(variables)
    ptx = ptrain.make_optimizer(OptimizationConfig(update_freq=update_freq, **OPT))
    pstep = ptrain.make_train_step(pmodel, ptx, unit_blank=unit_blank)
    pstate = ptrain.TrainState.create(pmodel, ptx)
    pbatch = batch_to_tensors(synthetic_batch(tiny_config(), batch=4), device="cpu")
    history = []
    for i in range(calls):
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(i), chunk_size=CHUNK,
                           conv_chunk_size=CONV_CHUNK)
        pstate, pm = pstep(pstate, pbatch, None, CHUNK, CONV_CHUNK)
        history.append((_np(jm), pm, _np(jstate.batch_stats),
                        {n: b.clone() for n, b in pstate.batch_stats.items()}))
    return jstate, pstate, pmodel, history


def _lr_sum(updates):
    sched = ptrain.inverse_sqrt(OPT["lr"], OPT["warmup_updates"])
    return sum(sched(k) for k in range(updates))


@pytest.mark.parametrize("update_freq,calls", [(1, 3), (2, 4)])
def test_train_steps_match_jax(jax_setup, jax_steps, update_freq, calls):
    """Loss components, ``grad_norm`` and ``overflow`` of every call within
    rtol 1e-4, BatchNorm stats after every call within 1e-5, and the params
    after the last call within 2·Σ lr of the updates made. With update_freq 2
    the params move on calls 2 and 4 only, while the step counts every call."""
    jstate, pstate, pmodel, history = _run_both(jax_setup, jax_steps, update_freq, calls)
    for jm, pm, jstats, pstats in history:
        assert sorted(pm) == sorted(jm)
        _close_metrics(pm, jm)
        assert not bool(pm["overflow"])
        want_stats = dict(_port_model({"params": _np(jstate.params),
                                    "batch_stats": jstats}).named_buffers())
        for name, buf in pstats.items():
            np.testing.assert_allclose(buf.numpy(), want_stats[name].numpy(), rtol=0,
                                       atol=1e-5, err_msg=name)
    assert pstate.step == int(jstate.step) == calls
    assert pstate.opt_state.count == calls // update_freq
    want = dict(_port_model({"params": _np(jstate.params),
                          "batch_stats": _np(jstate.batch_stats)}).named_parameters())
    atol = 2 * _lr_sum(calls // update_freq)
    for name, p in pstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name].detach().numpy(),
                                   rtol=0, atol=atol, err_msg=name)


def test_batch_stats_of_a_port_step_load_back_beside_jaxs(jax_setup, jax_steps):
    """The running stats one port train step writes equal JAX's
    ``mutated["batch_stats"]`` carried across the weights bridge, every
    BatchNorm of the encoder, within 1e-5, and differ from the initial ones."""
    jstate, pstate, _, _ = _run_both(jax_setup, jax_steps, 1, 1)
    _, _, variables, _ = jax_setup
    bridged = _port_model({"params": _np(jstate.params),
                        "batch_stats": _np(jstate.batch_stats)})
    before = dict(_port_model(variables).named_buffers())
    names = [n for n, _ in bridged.named_buffers()
             if n.endswith(("running_mean", "running_var"))]
    assert len(names) == 2 * 2 and sorted(names) == sorted(pstate.batch_stats)
    buffers = dict(bridged.named_buffers())
    for name in names:
        np.testing.assert_allclose(pstate.batch_stats[name].numpy(),
                                   buffers[name].numpy(), rtol=0, atol=1e-5, err_msg=name)
        assert not torch.allclose(pstate.batch_stats[name], before[name])


def test_step_one_gradients_match_jax(jax_setup):
    """Per-tensor gradients of the first step: jax.grad of the JAX step's loss
    (`trainer.py:114-130`) against the guarded ``.grad`` the port's step
    leaves, within 1e-4·max|g| + 1e-7."""
    jcfg, jmodel, variables, jbatch = jax_setup
    unit_blank = jcfg.unit_decoder.vocab_size - 1

    def loss(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jbatch["src_tokens"], jbatch["src_lengths"], jbatch["prev_output_tokens_mt"],
            chunk_size=CHUNK, conv_chunk_size=CONV_CHUNK, k1=0, n1=1, k2=0,
            n2=jbatch["n2"], streaming=True, deterministic=False,
            use_running_stats=False, rngs={"dropout": jax.random.PRNGKey(0)},
            mutable=["batch_stats"])
        m = jax_loss(out, jbatch, unit_blank)
        return m["loss"] / m["sample_size"].astype(jnp.float32)

    jgrads = _np(jax.jit(jax.grad(loss))(jax.tree.map(jnp.asarray, variables["params"])))
    want = dict(_port_model({"params": jgrads,
                          "batch_stats": variables["batch_stats"]}).named_parameters())
    pmodel = _port_model(variables)
    ptx = ptrain.make_optimizer(OptimizationConfig(update_freq=1, **OPT))
    pstep = ptrain.make_train_step(pmodel, ptx, unit_blank=unit_blank)
    pstate = ptrain.TrainState.create(pmodel, ptx)
    pstep(pstate, batch_to_tensors(synthetic_batch(tiny_config(), batch=4), device="cpu"),
          None, CHUNK, CONV_CHUNK)
    nonzero = 0
    for name, p in pmodel.named_parameters():
        g, w = p.grad.numpy(), want[name].detach().numpy()
        tol = 1e-4 * float(np.abs(w).max()) + 1e-7
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
        nonzero += bool(np.abs(w).max() > 0)
    assert nonzero > 0.9 * len(want)


# ---------------------------------------------------------------------------
# Kernel routes of one train step
# ---------------------------------------------------------------------------


@pytest.fixture
def route_counts(monkeypatch):
    """Count the calls of the port's kernel wrappers (on the CPU they compute
    their plain versions)."""
    counts = dict.fromkeys(("relpos", "bias", "masked", "not_blank", "ctc_alpha",
                            "ctc_beta"), 0)

    def counted(module, attr, key):
        real = getattr(module, attr)

        def wrapper(*args, **kwargs):
            counts[key] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(module, attr, wrapper)

    counted(attention, "relpos_attention", "relpos")
    counted(attention, "bias_attention", "bias")
    counted(attention, "masked_attention", "masked")
    counted(policy, "not_blank_probs", "not_blank")
    counted(kctc, "ctc_alpha", "ctc_alpha")
    counted(kctc, "ctc_beta_grad", "ctc_beta")
    return counts


def test_train_step_routes(route_counts):
    """At ``tiny_config(vocab_text=512, upsample=25)`` with 1024 frames (T_enc
    256, unit T 600, text vocabulary 512: every kernel gate open), one train
    step takes the CTC alpha and beta routes twice each (the unit head and
    the fused ASR + ST pair), the not-blank route twice, and no attention
    kernel; an eval forward takes the attention routes as before."""
    cfg = tiny_config(vocab_text=512, upsample=25)
    model = random_init_(StreamSpeechModel(cfg), 0)
    batch = batch_to_tensors(synthetic_batch(cfg, batch=2, frames=1024, mt_len=24,
                                             units_len=120, text_len=16), device="cpu")
    tx = ptrain.make_optimizer(OptimizationConfig(update_freq=1, **OPT))
    step = ptrain.make_train_step(model, tx, unit_blank=cfg.unit_decoder.vocab_size - 1)
    state = ptrain.TrainState.create(model, tx)
    state, metrics = step(state, batch, torch.Generator().manual_seed(0), 8, 8)
    assert all(bool(torch.isfinite(v.float())) for v in metrics.values())
    assert route_counts == {"relpos": 0, "bias": 0, "masked": 0, "not_blank": 2,
                            "ctc_alpha": 2, "ctc_beta": 2}
    with torch.no_grad():
        model(batch["src_tokens"], batch["src_lengths"], batch["prev_output_tokens_mt"],
              n2=1)
    assert route_counts == {"relpos": 2, "bias": 1, "masked": 1, "not_blank": 4,
                            "ctc_alpha": 2, "ctc_beta": 2}


# ---------------------------------------------------------------------------
# Dropout, R-Drop and SpecAugment in the step
# ---------------------------------------------------------------------------


def _dropout_setup(dropout=0.1, **step_kw):
    cfg = tiny_config()
    cfg.encoder.dropout = cfg.mt_decoder.dropout = cfg.unit_decoder.dropout = dropout
    model = random_init_(StreamSpeechModel(cfg), 3)
    tx = ptrain.make_optimizer(OptimizationConfig(update_freq=1, **OPT))
    step = ptrain.make_train_step(model, tx, unit_blank=cfg.unit_decoder.vocab_size - 1,
                                  **step_kw)
    return model, tx, step, batch_to_tensors(synthetic_batch(cfg, batch=2), device="cpu")


def _one_step_loss(seed, **step_kw):
    model, tx, step, batch = _dropout_setup(**step_kw)
    _, metrics = step(ptrain.TrainState.create(model, tx), batch,
                      torch.Generator().manual_seed(seed), CHUNK, CONV_CHUNK)
    return metrics


def test_dropout_follows_the_generator():
    """With dropout 0.1 the same generator seed gives the same loss, another
    seed another loss; without a generator the step raises."""
    a, b, c = (float(_one_step_loss(s)["loss"]) for s in (0, 0, 1))
    assert a == b and a != c
    model, tx, step, batch = _dropout_setup()
    with pytest.raises(ValueError, match="torch.Generator"):
        step(ptrain.TrainState.create(model, tx), batch, None, CHUNK, CONV_CHUNK)


def test_deterministic_forward_ignores_the_dropout_config():
    cfg0, cfg1 = tiny_config(), tiny_config()
    for c in (cfg0.encoder, cfg0.mt_decoder, cfg0.unit_decoder):
        c.dropout = 0.0
    for c in (cfg1.encoder, cfg1.mt_decoder, cfg1.unit_decoder):
        c.dropout = 0.3
    m0 = random_init_(StreamSpeechModel(cfg0), 5)
    m1 = StreamSpeechModel(cfg1)
    m1.load_state_dict(m0.state_dict())
    b = batch_to_tensors(synthetic_batch(cfg0, batch=2), device="cpu")
    args = (b["src_tokens"], b["src_lengths"], b["prev_output_tokens_mt"])
    with torch.no_grad():
        o0, o1 = (m(*args, chunk_size=CHUNK, conv_chunk_size=CONV_CHUNK, n2=2)
                  for m in (m0, m1))
    for key in o0:
        assert torch.equal(o0[key], o1[key]), key


def test_rdrop_keeps_the_first_passs_batch_stats():
    """R-Drop adds the symmetric KL of a second dropout pass to the loss and
    keeps the BatchNorm statistics of the first pass only: they equal those a
    single forward with the same generator writes."""
    model, tx, step, batch = _dropout_setup(rdrop_alpha=0.5)
    ref = StreamSpeechModel(model.cfg)
    ref.load_state_dict(model.state_dict())
    state, metrics = step(ptrain.TrainState.create(model, tx), batch,
                          torch.Generator().manual_seed(7), CHUNK, CONV_CHUNK)
    ref(batch["src_tokens"], batch["src_lengths"], batch["prev_output_tokens_mt"],
        chunk_size=CHUNK, conv_chunk_size=CONV_CHUNK, n2=batch["n2"],
        deterministic=False, use_running_stats=False,
        generator=torch.Generator().manual_seed(7))
    ref_stats = dict(ref.named_buffers())
    for name, buf in state.batch_stats.items():
        assert torch.equal(buf, ref_stats[name]), name
    assert float(metrics["rdrop_kl"]) > 0
    np.testing.assert_allclose(
        float(metrics["loss"]),
        float(metrics["unit_ctc_loss"] + 8 * metrics["mt_loss"] + 4 * metrics["asr_ctc_loss"]
              + 4 * metrics["st_ctc_loss"] + 0.5 * metrics["rdrop_kl"]), rtol=1e-5)


def test_specaugment_in_the_step():
    """SpecAugment draws from the step's generator: a finite step, and the
    same seed gives the same loss."""
    spec = {"freq_mask_N": 1, "freq_mask_F": 10, "time_mask_N": 1, "time_mask_T": 20,
            "time_mask_p": 1.0}
    a, b = (_one_step_loss(4, specaugment_cfg=spec) for _ in range(2))
    plain = _one_step_loss(4)
    assert np.isfinite(float(a["loss_mean"])) and float(a["loss"]) == float(b["loss"])
    assert float(a["loss"]) != float(plain["loss"])


def test_overflow_step_zeroes_grads_and_still_updates():
    """A non-finite loss: ``overflow`` is set, the guarded grads are 0 and the
    optimizer still runs (`trainer.py:146-152`): with zero moments the params
    stay, the count moves on."""
    model, tx, step, batch = _dropout_setup(dropout=0.0)
    batch = dict(batch, src_tokens=batch["src_tokens"].clone())
    batch["src_tokens"][0, 0, 0] = float("nan")
    state = ptrain.TrainState.create(model, tx)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    state, metrics = step(state, batch, None, CHUNK, CONV_CHUNK)
    assert bool(metrics["overflow"]) and not np.isfinite(float(metrics["grad_norm"]))
    assert state.opt_state.count == 1 and state.step == 1
    for name, p in state.params.items():
        assert not p.grad.any(), name
        assert torch.equal(p.detach(), before[name]), name
