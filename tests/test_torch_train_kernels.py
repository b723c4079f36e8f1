"""The kernel train route of the port on the CPU: ``make_train_step(...,
kernel_attention=True)``, the counterpart of ``STREAMSPEECH_PALLAS_TRAIN=1``.

- The routes: with the switch on, training enters the three attention kernel
  wrappers (counted) at ``tiny_config(vocab_text=512, upsample=25)``, 1024
  frames; with it off it does not, and the random stream is the default
  route's. The gates equal the JAX package's.
- The route as a whole: one train step with the switch on and every dropout 0
  against the JAX train step under ``STREAMSPEECH_PALLAS_TRAIN=1`` with its
  three attention gates forced and its kernels in interpret mode
  (monkeypatched as ``tests/test_forced_pallas.py`` does; the JAX package is
  unchanged): ``tiny_config()``, batch 2, 64 frames (T_enc 16), MT 8 (unit T
  32), chunk 4, conv chunk 8, the smallest shapes that file uses, with the
  port's own gates forced open to match. Loss components within rtol 1e-4,
  per-tensor gradients within 5e-4 (that file's tolerance).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.config import OptimizationConfig as JaxOptimizationConfig
from streamspeech_tpu.models import layers as jlayers
from streamspeech_tpu.models.streamspeech import StreamSpeechModel as JaxModel
from streamspeech_tpu.ops import pallas_attention as pa
from streamspeech_tpu.train.synthetic import synthetic_batch as jax_batch
from streamspeech_tpu.train.synthetic import tiny_config as jax_tiny_config
from streamspeech_tpu.train.trainer import TrainState as JaxTrainState
from streamspeech_tpu.train.trainer import make_optimizer as jax_make_optimizer
from streamspeech_tpu.train.trainer import make_train_step as jax_make_train_step

from streamspeech_tpu_torch.config import OptimizationConfig, tiny_config
from streamspeech_tpu_torch.kernels import attention
from streamspeech_tpu_torch.models import layers as players
from streamspeech_tpu_torch.models.layers import (
    MultiHeadAttention,
    RelPosMultiHeadAttention,
    set_kernel_train,
)
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.train import trainer as ptrain
from streamspeech_tpu_torch.train.synthetic import batch_to_tensors, synthetic_batch
from streamspeech_tpu_torch.weights import load_flax_variables, random_init_
from tests.jax_init import init_variables, shared_jax_init  # noqa: F401
from tests.torch_threads import one_torch_thread  # noqa: F401

OPT = dict(warmup_updates=10, lr=1e-3, clip_norm=1.0)
CHUNK, CONV_CHUNK = 4, 8
FAMILIES = ("relpos", "masked", "bias")


@pytest.fixture
def entries(monkeypatch):
    """Count the entries of the three differentiable wrappers and of their
    backward wrappers (on the CPU they compute their plain versions)."""
    counts = {}

    def counted(name):
        real = getattr(attention, name)
        counts[name] = 0

        def wrapper(*args, **kwargs):
            counts[name] += 1
            return real(*args, **kwargs)
        monkeypatch.setattr(attention, name, wrapper)

    for family in FAMILIES:
        counted(f"{family}_attention")
        counted(f"{family}_attention_backward")
    return counts


def _step(model, cfg, kernel_attention, **kw):
    tx = ptrain.make_optimizer(OptimizationConfig(update_freq=1, **OPT))
    step = ptrain.make_train_step(model, tx, unit_blank=cfg.unit_decoder.vocab_size - 1,
                                  kernel_attention=kernel_attention, **kw)
    return step, ptrain.TrainState.create(model, tx)


# ---------------------------------------------------------------------------
# The routes and the switch
# ---------------------------------------------------------------------------


def test_kernel_route_is_entered_with_the_switch_on_and_not_with_it_off(entries):
    """T_enc 256, unit T 600, dropout 0.1: with the switch on one step enters
    the rel-pos wrapper twice (2 encoder layers), the causal and the bias
    wrapper once each (1 unit-decoder layer), and as many backwards; off, none."""
    cfg = tiny_config(vocab_text=512, upsample=25)
    batch = batch_to_tensors(synthetic_batch(cfg, batch=2, frames=1024, mt_len=24,
                                             units_len=120, text_len=16), device="cpu")
    losses = {}
    for on in (True, False):
        before = dict(entries)
        model = random_init_(StreamSpeechModel(cfg), 0)
        step, state = _step(model, cfg, on)
        _, metrics = step(state, batch, torch.Generator().manual_seed(0), 8, 8)
        assert all(bool(torch.isfinite(v.float())) for v in metrics.values())
        got = {k: entries[k] - before[k] for k in entries}
        want = {"relpos_attention": 2, "masked_attention": 1, "bias_attention": 1}
        want.update({f"{k}_backward": v for k, v in list(want.items())})
        assert got == (want if on else dict.fromkeys(want, 0)), (on, got)
        losses[on] = float(metrics["loss"])
        assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
                   for p in model.parameters())
    assert losses[True] != losses[False]           # another dropout stream


def test_switch_sets_every_attention_module_and_defaults_off():
    cfg = tiny_config()
    model = StreamSpeechModel(cfg)
    mods = [m for m in model.modules()
            if isinstance(m, (MultiHeadAttention, RelPosMultiHeadAttention))]
    assert len(mods) > 4 and not any(m.kernel_train for m in mods)
    _step(model, cfg, True)
    assert all(m.kernel_train for m in mods)
    _step(model, cfg, False)                       # off again: the default step
    assert not any(m.kernel_train for m in mods)
    assert set_kernel_train(model, True) is model and all(m.kernel_train for m in mods)


def test_default_route_is_unmoved_by_the_switchs_code():
    """With the switch off the step draws what it drew before the switch
    existed: the same generator seed gives the same loss on two fresh models,
    and the kernel route draws one seed per attention call on top (so its
    stream differs), only when the rate is above 0."""
    cfg = tiny_config()
    cfg.encoder.dropout = cfg.mt_decoder.dropout = cfg.unit_decoder.dropout = 0.1
    batch = batch_to_tensors(synthetic_batch(cfg, batch=2), device="cpu")
    out = []
    for on in (False, False):
        step, state = _step(random_init_(StreamSpeechModel(cfg), 3), cfg, on)
        out.append(float(step(state, batch, torch.Generator().manual_seed(5), CHUNK,
                              CONV_CHUNK)[1]["loss"]))
    assert out[0] == out[1]
    gen = torch.Generator().manual_seed(5)
    state_before = gen.get_state()
    assert players._rate_and_seed(0.1, True, gen, "cpu") == (0.0, None)
    assert players._rate_and_seed(0.0, False, gen, "cpu") == (0.0, None)
    assert torch.equal(gen.get_state(), state_before)
    rate, seed = players._rate_and_seed(0.1, False, gen, "cpu")
    assert rate == 0.1 and seed.dtype == torch.int64
    assert not torch.equal(gen.get_state(), state_before)


@pytest.mark.parametrize("t,dh", [(256, 64), (255, 64), (384, 24), (300, 64), (1200, 64),
                                  (512, 12), (128, 64)])
def test_gates_equal_the_jax_gates(monkeypatch, t, dh):
    """The port's three gates against ``_pallas_ok``, ``_masked_pallas_ok`` and
    ``_bias_pallas_ok`` with the JAX backend test answered "tpu"."""
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for var in ("STREAMSPEECH_DISABLE_PALLAS", "STREAMSPEECH_DISABLE_PALLAS_MASKED",
                "STREAMSPEECH_DISABLE_PALLAS_CROSS"):
        monkeypatch.delenv(var, raising=False)
    assert players._relpos_kernel_ok(t, dh) == jlayers._pallas_ok(t, dh)
    assert players._masked_kernel_ok(t, dh) == jlayers._masked_pallas_ok(t, dh)
    assert players._bias_kernel_ok(t, dh) == jlayers._bias_pallas_ok(t, dh)


def test_kernel_route_attention_dropout_follows_the_seed(entries):
    """Attention dropout inside the wrappers: the same generator gives the same
    step, another another; eval (deterministic) ignores rate and switch."""
    torch.manual_seed(0)
    mha = MultiHeadAttention(32, 4, dropout=0.3)
    set_kernel_train(mha, True)
    x = torch.randn(2, 256, 32)
    outs = [mha(x, causal=True, deterministic=False,
                generator=torch.Generator().manual_seed(s))[0] for s in (1, 1, 2)]
    assert entries["masked_attention"] == 3
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    plain = MultiHeadAttention(32, 4, dropout=0.3)
    plain.load_state_dict(mha.state_dict())
    with torch.no_grad():
        torch.testing.assert_close(mha(x, causal=True)[0], plain(x, causal=True)[0])
    with pytest.raises(ValueError, match="Generator"):
        mha(x, causal=True, deterministic=False)


# ---------------------------------------------------------------------------
# The route as a whole against JAX under STREAMSPEECH_PALLAS_TRAIN=1
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def jax_forced_gates(monkeypatch):
    """JAX side: the three attention gates forced open, the Pallas kernels in
    interpret mode, the trainable functions counted."""
    hits = dict.fromkeys(FAMILIES, 0)

    def counted(name, fn):
        def wrapper(*a, **kw):
            hits[name] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setenv("STREAMSPEECH_PALLAS_TRAIN", "1")
    monkeypatch.setattr(jlayers, "_pallas_ok", lambda t, dh: True)
    monkeypatch.setattr(jlayers, "_masked_pallas_ok", lambda t, dh: True)
    monkeypatch.setattr(jlayers, "_bias_pallas_ok", lambda s, dh: True)
    monkeypatch.setattr(pa._relpos_bwd, "interpret", True)
    for family in FAMILIES:
        name = f"{family}_attention_trainable"
        monkeypatch.setattr(pa, name, counted(family, getattr(pa, name)))
    yield hits


def _no_dropout(cfg):
    cfg.encoder.dropout = cfg.mt_decoder.dropout = cfg.unit_decoder.dropout = 0.0
    return cfg


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_kernel_train_step_matches_jax_pallas_train(monkeypatch, entries):
    """The JAX step runs with ``update_freq=2``: its ``optax.MultiSteps``
    state holds the first micro-step's gradient as it is (the running mean of
    one gradient), so the step's metrics and its gradient come from one JAX
    program instead of the step and a separate ``jax.grad``."""
    jcfg = _no_dropout(jax_tiny_config())
    jmodel = JaxModel(jcfg)
    variables = init_variables(jmodel)
    jbatch = jax_batch(jcfg, batch=2, frames=64, mt_len=8)
    unit_blank = jcfg.unit_decoder.vocab_size - 1

    with jax_forced_gates(monkeypatch) as hits:
        jtx = jax_make_optimizer(JaxOptimizationConfig(**dict(OPT, update_freq=2)))
        jstep = jax_make_train_step(jmodel, jtx, unit_blank=unit_blank)
        jstate = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), jtx)
        jstate, jmetrics = jstep(jstate, jbatch, jax.random.PRNGKey(0), chunk_size=CHUNK,
                                 conv_chunk_size=CONV_CHUNK)
        jmetrics = _np(jmetrics)
        jgrads = _np(jstate.opt_state.acc_grads)
    assert all(hits[f] > 0 for f in FAMILIES), hits

    pcfg = _no_dropout(tiny_config())
    pmodel = load_flax_variables(StreamSpeechModel(pcfg), variables)
    for gate in ("_relpos_kernel_ok", "_masked_kernel_ok", "_bias_kernel_ok"):
        monkeypatch.setattr(players, gate, lambda t, dh: True)
    step, state = _step(pmodel, pcfg, True)
    _, pm = step(state, batch_to_tensors(synthetic_batch(pcfg, batch=2, frames=64,
                                                         mt_len=8), device="cpu"),
                 None, CHUNK, CONV_CHUNK)
    # 2 encoder layers; the MT decoder's and the unit decoder's causal
    # self-attention and both cross-attentions (per-query masks) take their
    # kernel wrappers once the gates are open, forward and backward
    assert entries["relpos_attention"] == entries["relpos_attention_backward"] == 2
    assert entries["masked_attention"] == entries["masked_attention_backward"] >= 2
    assert entries["bias_attention"] == entries["bias_attention_backward"] >= 2
    assert sorted(pm) == sorted(jmetrics)
    for key, want in jmetrics.items():
        np.testing.assert_allclose(float(pm[key]), float(want), rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    want = dict(load_flax_variables(
        StreamSpeechModel(pcfg),
        {"params": jgrads, "batch_stats": variables["batch_stats"]}).named_parameters())
    nonzero = 0
    for name, p in pmodel.named_parameters():
        w = want[name].detach().numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=5e-4, err_msg=name)
        nonzero += bool(np.abs(w).max() > 0)
    assert nonzero > 0.9 * len(want)
