"""The port's bf16 train step against the JAX package's, on the CPU.

``make_train_step`` on ``StreamSpeechModel(tiny_config(), dtype=torch.bfloat16)``
and the JAX step's loss (``streamspeech_loss`` over ``model.apply(...,
deterministic=False, use_running_stats=False)``, as ``make_train_step``'s
``loss_fn``) differentiated by ``jax.value_and_grad`` on the JAX bf16 model,
from the same float32 weights (``weights.load_flax_variables``) and batch,
every dropout 0 (the two random streams cannot match): ``tiny_config()``,
batch 2, 64 frames, MT 8, chunk 4, conv chunk 8. Two routes:
- the default route (plain attention) against the JAX default route;
- the kernel route (``kernel_attention=True``, the three attention gates
  forced open as ``tests/test_torch_train_kernels.py`` does) against the JAX
  step under ``STREAMSPEECH_PALLAS_TRAIN=1`` with its gates forced and its
  Pallas kernels in interpret mode: bf16 q/k/v into the causal and bias
  kernels and their backwards, rel-pos in fp32.

Tolerance, tied to bf16's own drift: JAX bf16 against JAX fp32 on the same
batch, on the default route, where every op runs at the model's dtype (on the
kernel route both packages keep the attention in fp32, so JAX's own drift
there, 0.45 of the default route's, leaves out what the rest of the model
rounds). XLA on the CPU keeps fp32 between the ops of a fusion where torch
rounds each op to bf16, so the two bf16 steps round at different places; each
attention module alone, on either route, gives JAX bf16's gradients bit for
bit.
- The whole gradient (every parameter's, as one vector): the port's L2
  distance from JAX bf16 on its route within 2x that drift. Measured: default
  route 0.98, kernel route 1.08 (2.41 of the kernel route's own drift).
- Each gradient tensor within 4x its own drift. Measured worst: 2.17
  (default, ``synthesizer_encoder.layers_0.self_attn_layer_norm.weight``) and
  2.89 (kernels, ``unit_decoder.layers_0.final_layer_norm.bias``); median 1.01
  and 1.11; 2 and 7 of 180 tensors past 2x. The issue's 2x per tensor does not
  hold at bf16 next to ReLU units: a unit whose preactivation lies within bf16
  rounding of 0 lands on one side in one bf16 step and on the other in the
  other, and moves every gradient upstream of it (at batch 4, unit 55 of
  ``unit_decoder.layers_0.ffn.fc1``, at 3.7e-4 of the layer's largest
  |preactivation|, was 87 % of that tensor's distance, 3.3x).
- Each loss component within 2^-8 of its JAX bf16 value (one bf16 rounding
  of it: the components are fp32 sums over bf16 logits whose own drift is as
  small as 1e-4 of them, so a scalar's ratio to it is noise: measured
  0.19-3.3).
Then: the fp32 step is bit for bit the step before bf16 dropout rounded its
scale (the earlier ``dropout`` restored for comparison), on both routes with
dropout on; a bf16 step with ``update_freq=2`` moves the parameters on its
second call only. About 100 worker-seconds, most of it three JAX jits.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.models import layers as jlayers
from streamspeech_tpu.models.streamspeech import StreamSpeechModel as JaxModel
from streamspeech_tpu.models.streamspeech import init_params
from streamspeech_tpu.ops import pallas_attention as pa
from streamspeech_tpu.train.criterion import streamspeech_loss as jax_loss
from streamspeech_tpu.train.synthetic import synthetic_batch as jax_batch
from streamspeech_tpu.train.synthetic import tiny_config as jax_tiny_config

from streamspeech_tpu_torch.config import OptimizationConfig, tiny_config
from streamspeech_tpu_torch.models import conformer as pconformer
from streamspeech_tpu_torch.models import layers as players
from streamspeech_tpu_torch.models import streamspeech as pstreamspeech
from streamspeech_tpu_torch.models import transformer as ptransformer
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.train import trainer as ptrain
from streamspeech_tpu_torch.train.synthetic import batch_to_tensors, synthetic_batch
from streamspeech_tpu_torch.weights import load_flax_variables, random_init_
from tests.torch_threads import one_torch_thread  # noqa: F401

OPT = dict(warmup_updates=10, lr=1e-3, clip_norm=1.0)
CHUNK, CONV_CHUNK = 4, 8
BATCH = dict(batch=2, frames=64, mt_len=8)
WHOLE_DRIFT = 2.0        # the whole gradient: of JAX bf16's own distance
TENSOR_DRIFT = 4.0       # each gradient tensor
LOSS_RTOL = 2.0 ** -8    # each loss component
LOSS_KEYS = ("loss", "unit_ctc_loss", "mt_loss", "mt_nll_loss", "asr_ctc_loss",
             "st_ctc_loss")
GATES = ("_relpos_kernel_ok", "_masked_kernel_ok", "_bias_kernel_ok")


def _no_dropout(cfg):
    cfg.encoder.dropout = cfg.mt_decoder.dropout = cfg.unit_decoder.dropout = 0.0
    return cfg


@contextlib.contextmanager
def _jax_kernel_route():
    """The JAX step's attention on its Pallas kernels: STREAMSPEECH_PALLAS_TRAIN
    set, the three gates forced open, interpret mode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STREAMSPEECH_PALLAS_TRAIN", "1")
        mp.setattr(jlayers, "_pallas_ok", lambda t, dh: True)
        mp.setattr(jlayers, "_masked_pallas_ok", lambda t, dh: True)
        mp.setattr(jlayers, "_bias_pallas_ok", lambda s, dh: True)
        mp.setattr(pa._relpos_bwd, "interpret", True)
        yield


@pytest.fixture(scope="module")
def jax_runs():
    """Per route and dtype: (loss components, gradients as a port model's
    ``named_parameters``) of the JAX step's loss; fp32 on the default route."""
    jcfg = _no_dropout(jax_tiny_config())
    variables = jax.tree.map(np.asarray, jax.jit(lambda k: init_params(JaxModel(jcfg), k))(
        jax.random.PRNGKey(0)))
    jb = jax_batch(jcfg, **BATCH)
    unit_blank = jcfg.unit_decoder.vocab_size - 1
    runs = {}
    # the fp32 step is the same on both routes (to 2e-5 of the gradient's norm)
    for route, name, dtype in (("default", "fp32", jnp.float32),
                               ("default", "bf16", jnp.bfloat16),
                               ("kernels", "bf16", jnp.bfloat16)):
        model = JaxModel(jcfg, dtype=dtype)

        def loss(params, model=model):
            out, _ = model.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                jb["src_tokens"], jb["src_lengths"], jb["prev_output_tokens_mt"],
                chunk_size=CHUNK, conv_chunk_size=CONV_CHUNK, k1=0, n1=1, k2=0,
                n2=jb["n2"], streaming=True, deterministic=False,
                use_running_stats=False, rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            m = jax_loss(out, jb, unit_blank)
            return m["loss"] / m["sample_size"].astype(jnp.float32), m

        with _jax_kernel_route() if route == "kernels" else contextlib.nullcontext():
            (_, metrics), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
                jax.tree.map(jnp.asarray, variables["params"]))
        grads = jax.tree.map(lambda g: np.asarray(g, np.float32), grads)
        as_port = load_flax_variables(
            StreamSpeechModel(_no_dropout(tiny_config())),
            {"params": grads, "batch_stats": variables["batch_stats"]})
        runs[route, name] = ({k: float(metrics[k]) for k in LOSS_KEYS},
                             {n: p.detach().double()
                              for n, p in as_port.named_parameters()})
    return variables, runs


def _port_step(variables, dtype, kernel_attention, monkeypatch):
    cfg = _no_dropout(tiny_config())
    model = load_flax_variables(StreamSpeechModel(cfg, dtype=dtype), variables)
    if kernel_attention:
        for gate in GATES:
            monkeypatch.setattr(players, gate, lambda t, dh: True)
    tx = ptrain.make_optimizer(OptimizationConfig(update_freq=1, **OPT))
    step = ptrain.make_train_step(model, tx, unit_blank=cfg.unit_decoder.vocab_size - 1,
                                  kernel_attention=kernel_attention)
    _, metrics = step(ptrain.TrainState.create(model, tx),
                      batch_to_tensors(synthetic_batch(cfg, **BATCH), device="cpu"), None,
                      CHUNK, CONV_CHUNK)
    return ({k: float(metrics[k]) for k in LOSS_KEYS},
            {n: p.grad.detach().double() for n, p in model.named_parameters()})


def _l2(a, b):
    return float(torch.sqrt(sum(((a[n] - b[n]) ** 2).sum() for n in a)))


@pytest.mark.parametrize("route", ["default", "kernels"])
def test_bf16_train_step_matches_jax_bf16_within_its_drift(jax_runs, route, monkeypatch):
    variables, runs = jax_runs
    (m32, g32), (m16, g16) = runs["default", "fp32"], runs[route, "bf16"]
    own = runs["default", "bf16"][1], g32                          # bf16's own drift
    pm, pg = _port_step(variables, torch.bfloat16, route == "kernels", monkeypatch)
    whole = _l2(pg, g16) / _l2(*own)
    ratios = {n: float((pg[n] - g16[n]).norm() / max(float((own[0][n] - own[1][n]).norm()),
                                                     1e-30))
              for n in pg}
    worst = max(ratios, key=ratios.get)
    print(f"{route}: whole gradient {whole:.3g} (to this route's own drift "
          f"{_l2(pg, g16) / _l2(g16, g32):.3g}); worst tensor {worst} {ratios[worst]:.3g}; "
          f"median {np.median(list(ratios.values())):.3g}; over 2x "
          f"{sum(r > 2 for r in ratios.values())} of {len(ratios)}; losses " +
          ", ".join(f"{k} {abs(pm[k] - m16[k]) / max(abs(m16[k] - m32[k]), 1e-30):.3g}"
                    for k in LOSS_KEYS))
    assert whole <= WHOLE_DRIFT
    assert ratios[worst] <= TENSOR_DRIFT, worst
    assert all(torch.isfinite(g).all() for g in pg.values())
    for k in LOSS_KEYS:
        assert abs(pm[k] - m16[k]) <= LOSS_RTOL * abs(m16[k]), k
    # the bf16 step is not the fp32 one: it moved by bf16's drift
    assert _l2(pg, g32) > 0.1 * _l2(g16, g32)


def _previous_dropout(x, rate, deterministic, generator):
    """``layers.dropout`` as it was before bf16 rounded its scale."""
    if deterministic or rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))


@pytest.mark.parametrize("kernel_attention", [False, True])
def test_fp32_step_is_unchanged_bit_for_bit(monkeypatch, kernel_attention):
    """An fp32 step with every dropout on takes the same numbers as with the
    earlier ``dropout``: the fp32 scale 1 - rate is the float32 one either
    way, and the attention wrappers' bf16 casts are no-ops on fp32."""
    cfg = tiny_config()
    batch = batch_to_tensors(synthetic_batch(cfg, **BATCH), device="cpu")

    def run():
        model = random_init_(StreamSpeechModel(cfg), 0)
        if kernel_attention:
            for gate in GATES:
                monkeypatch.setattr(players, gate, lambda t, dh: True)
        tx = ptrain.make_optimizer(OptimizationConfig(update_freq=1, **OPT))
        step = ptrain.make_train_step(model, tx, unit_blank=cfg.unit_decoder.vocab_size - 1,
                                      kernel_attention=kernel_attention)
        _, metrics = step(ptrain.TrainState.create(model, tx), batch,
                          torch.Generator().manual_seed(3), CHUNK, CONV_CHUNK)
        return metrics, [p.detach().clone() for p in model.parameters()]

    now = run()
    for module in (players, pconformer, ptransformer, pstreamspeech):
        if getattr(module, "dropout", None) is players.dropout:
            monkeypatch.setattr(module, "dropout", _previous_dropout)
    monkeypatch.setattr(players, "dropout", _previous_dropout)
    before = run()
    assert all(torch.equal(now[0][k], before[0][k]) for k in now[0])
    assert all(torch.equal(a, b) for a, b in zip(now[1], before[1]))


def test_bf16_step_accumulates_with_update_freq_two():
    """MultiSteps on a bf16 model: finite metrics, the float32 parameters move
    on the second call only."""
    cfg = tiny_config()
    model = random_init_(StreamSpeechModel(cfg, dtype=torch.bfloat16), 0)
    tx = ptrain.make_optimizer(OptimizationConfig(update_freq=2, **OPT))
    step = ptrain.make_train_step(model, tx, unit_blank=cfg.unit_decoder.vocab_size - 1)
    state = ptrain.TrainState.create(model, tx)
    batch = batch_to_tensors(synthetic_batch(cfg, **BATCH), device="cpu")
    gen = torch.Generator().manual_seed(0)
    start = [p.detach().clone() for p in model.parameters()]
    state, m1 = step(state, batch, gen, CHUNK, CONV_CHUNK)
    after_one = [p.detach().clone() for p in model.parameters()]
    state, m2 = step(state, batch, gen, CHUNK, CONV_CHUNK)
    assert all(torch.isfinite(v).all() for m in (m1, m2) for v in m.values())
    assert all(torch.equal(a, b) for a, b in zip(start, after_one))
    assert any(not torch.equal(a, p) for a, p in zip(after_one, model.parameters()))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert state.step == 2 and state.opt_state.count == 1


def test_bf16_dropout_scales_as_flax():
    """flax's ``inputs / keep_prob`` meets a bf16 array with the Python float
    as bf16 (0.8984375 for 0.9): the kept elements equal JAX's, bit for bit."""
    x = torch.from_numpy(np.random.RandomState(0).randn(4096).astype(np.float32)).bfloat16()
    got = players.dropout(x, 0.1, False, torch.Generator().manual_seed(0))
    kept = got != 0
    want = np.asarray((jnp.asarray(x.float().numpy(), jnp.bfloat16) / 0.9).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy()[kept.numpy()], want[kept.numpy()])
