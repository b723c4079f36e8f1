"""K steps a call and per-layer recomputation in the port's train step, on the
CPU (no JAX).

- ``make_train_step_scan``: K stacked batches through one call equal K calls
  of ``make_train_step`` whose step i draws from a generator seeded with
  ``fold_in_seed(seed0, i)``, bit for bit, with dropout 0.1 (so the
  generators matter), the metrics stacked ``[K]``; ``fold_in_seed`` gives
  distinct seeds.
- ``remat`` (``cfg.encoder.remat``, ``cfg.unit_decoder.remat``): a
  kernel-route step at attention dropout 0.1 (every dropout 0.1, the three
  attention gates forced open), and a default-route step, equal the step
  without it, bit for bit:
  metrics, gradients, parameters, BatchNorm statistics and the generator's
  state after the step. ``torch.utils.checkpoint`` alone, which restores the
  global generators only, draws new masks in the recompute and gives other
  gradients.
"""

import copy

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from streamspeech_tpu_torch.config import OptimizationConfig, tiny_config
from streamspeech_tpu_torch.models import conformer as pconformer
from streamspeech_tpu_torch.models import layers as players
from streamspeech_tpu_torch.models import transformer as ptransformer
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.train import trainer as ptrain
from streamspeech_tpu_torch.train.synthetic import batch_to_tensors, synthetic_batch
from streamspeech_tpu_torch.weights import random_init_
from tests.torch_threads import one_torch_thread  # noqa: F401

CHUNK, CONV_CHUNK = 4, 8
GATES = ("_relpos_kernel_ok", "_masked_kernel_ok", "_bias_kernel_ok")


def _setup(remat=False, dropout=0.1, update_freq=1, kernel_attention=False, scan=False):
    cfg = tiny_config()
    for c in (cfg.encoder, cfg.mt_decoder, cfg.unit_decoder):
        c.dropout = dropout
    cfg.encoder.remat = cfg.unit_decoder.remat = remat
    model = random_init_(StreamSpeechModel(cfg), 4)
    tx = ptrain.make_optimizer(OptimizationConfig(update_freq=update_freq,
                                                  warmup_updates=10))
    make = ptrain.make_train_step_scan if scan else ptrain.make_train_step
    step = make(model, tx, unit_blank=cfg.unit_decoder.vocab_size - 1,
                kernel_attention=kernel_attention)
    return model, ptrain.TrainState.create(model, tx), step, cfg


def _snapshot(model, metrics, gen):
    return ({k: v.clone() for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: p.detach().clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()},
            gen.get_state())


def _equal(a, b):
    for x, y in zip(a[:4], b[:4]):
        assert sorted(x) == sorted(y)
        for key in x:
            assert torch.equal(x[key], y[key]), key
    assert torch.equal(a[4], b[4])


def test_scan_equals_single_steps_with_folded_seeds():
    batches = [synthetic_batch(tiny_config(), batch=2, seed=s) for s in (1, 2, 3)]
    model, state, step, _ = _setup(update_freq=2)
    singles = []
    for i, b in enumerate(batches):
        state, m = step(state, batch_to_tensors(b, device="cpu"),
                        torch.Generator().manual_seed(ptrain.fold_in_seed(11, i)),
                        CHUNK, CONV_CHUNK)
        singles.append(m)
    want = {n: p.detach().clone() for n, p in model.named_parameters()}
    model_k, state_k, step_k, _ = _setup(update_freq=2, scan=True)
    stacked = batch_to_tensors({k: np.stack([b[k] for b in batches])
                                for k in batches[0] if k != "n2"}, device="cpu")
    stacked["n2"] = [int(b["n2"]) for b in batches]
    state_k, ms = step_k(state_k, stacked, 11, CHUNK, CONV_CHUNK)
    assert state_k.step == state.step == 3 and state_k.opt_state.count == 1
    assert state_k.opt_state.mini_step == state.opt_state.mini_step == 1
    for key in singles[0]:
        assert ms[key].shape == (3,)
        assert torch.equal(ms[key], torch.stack([m[key] for m in singles])), key
    for n, p in model_k.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    seeds = {ptrain.fold_in_seed(s, i) for s in range(4) for i in range(4)}
    assert len(seeds) == 16 and all(0 <= x < 2 ** 63 for x in seeds)


def _step_once(monkeypatch, remat, kernel_attention):
    for gate in GATES:
        monkeypatch.setattr(players, gate, lambda t, dh: True)
    model, state, step, cfg = _setup(remat=remat, kernel_attention=kernel_attention)
    gen = torch.Generator().manual_seed(3)
    _, metrics = step(state, batch_to_tensors(synthetic_batch(cfg, batch=2), device="cpu"),
                      gen, CHUNK, CONV_CHUNK)
    return _snapshot(model, metrics, gen)


@pytest.mark.parametrize("kernel_attention", [True, False], ids=["kernels", "default"])
def test_remat_step_equals_the_plain_step_bit_for_bit(monkeypatch, kernel_attention):
    plain = _step_once(monkeypatch, False, kernel_attention)
    _equal(_step_once(monkeypatch, True, kernel_attention), plain)
    # the trap: checkpoint alone re-draws the explicit generator's masks
    def naive(layer, generator, *args, **kwargs):
        return checkpoint(lambda *a: layer(*a, generator=generator, **kwargs), *args,
                          use_reentrant=False)
    for module in (pconformer, ptransformer):
        monkeypatch.setattr(module, "remat", naive)
    naive_run = _step_once(monkeypatch, True, kernel_attention)
    assert torch.equal(naive_run[0]["loss"], plain[0]["loss"])
    assert any(not torch.equal(naive_run[1][n], plain[1][n]) for n in plain[1])


def test_remat_is_a_no_op_without_grad():
    model, _, _, cfg = _setup(remat=True)
    plain_cfg = copy.deepcopy(cfg)
    plain_cfg.encoder.remat = plain_cfg.unit_decoder.remat = False
    ref = StreamSpeechModel(plain_cfg)
    ref.load_state_dict(model.state_dict())
    b = batch_to_tensors(synthetic_batch(cfg, batch=2), device="cpu")
    args = (b["src_tokens"], b["src_lengths"], b["prev_output_tokens_mt"])
    with torch.no_grad():
        got = model(*args, chunk_size=CHUNK, conv_chunk_size=CONV_CHUNK, n2=2)
        want = ref(*args, chunk_size=CHUNK, conv_chunk_size=CONV_CHUNK, n2=2)
    for key in want:
        assert torch.equal(got[key], want[key]), key
