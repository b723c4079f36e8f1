"""The port's native checkpoints (``train/checkpoint.py``) against the JAX
package's, on the CPU.

- Rotation: the same sequences of (step, metric) saves (ties, a NaN and an
  inf, ``maximize``, ``keep_last`` below the count, saves without a metric)
  leave the same names in the save directory after every save, and
  ``best_checkpoint``, ``latest_checkpoint`` and ``would_enter_best`` answer
  alike. The JAX side saves a small stand-in state with orbax; the port saves
  a ``TrainState`` of a small model.
- Round trip: save then load (``restore_state`` into a fresh state) restores
  every tensor, ``count``, ``mini_step`` and ``step`` exactly, the MultiSteps
  accumulator with it; the payload's leaves are CPU tensors under the flax
  names, read with ``torch.load(weights_only=True)``.
- ``average_checkpoints`` (and its CLI) and ``load_pretrained_component`` (a
  native checkpoint and a fairseq ``.pt``) give JAX's trees on the same
  weights.
"""

import types

import jax
import numpy as np
import pytest
import torch

from streamspeech_tpu.train import checkpoint as jckpt

from streamspeech_tpu_torch.cli import average_checkpoints as port_avg_cli
from streamspeech_tpu_torch.config import OptimizationConfig, tiny_config
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.train import checkpoint as pckpt
from streamspeech_tpu_torch.train.synthetic import batch_to_tensors, synthetic_batch
from streamspeech_tpu_torch.train.trainer import TrainState, make_optimizer, make_train_step
from streamspeech_tpu_torch.weights import flax_variables, random_init_
from tests.torch_threads import one_torch_thread  # noqa: F401

NAN, INF = float("nan"), float("inf")
# (saves as (step, metric or None), keep_last, keep_best, maximize)
SEQUENCES = {
    "ties_and_nonfinite": ([(1, 0.9), (2, 0.5), (3, 0.5), (4, NAN), (5, 0.7), (6, INF),
                            (7, 0.4), (8, 0.4)], 3, 2, False),
    "maximize": ([(1, 10.0), (2, 30.0), (3, 20.0), (4, 30.0), (5, 5.0), (6, None)],
                 10, 2, True),
    "keep_last_below_count": ([(2, None), (4, 1.5e-07), (6, None), (8, 0.12349999),
                               (10, 0.12342), (12, None)], 2, 1, False),
    "one_best": ([(1, 3.0), (2, 2.0), (3, 2.0), (4, 2.5)], 1, 1, False),
}
PROBES = (0.3, 0.5, 0.45, 1e-9, 100.0, 25.0, NAN)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(3, 2)


def _names(d):
    return sorted(p.name for p in d.iterdir() if p.name != "config.json")


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_rotation_leaves_jaxs_names(tmp_path, name):
    saves, keep_last, keep_best, maximize = SEQUENCES[name]
    model = _Tiny()
    state = TrainState.create(model, make_optimizer(OptimizationConfig(update_freq=1)))
    jstate = types.SimpleNamespace(params={"w": np.zeros(2, np.float32)}, batch_stats={},
                                   opt_state={"c": np.zeros((), np.int32)},
                                   step=np.zeros((), np.int32))
    jdir, pdir = tmp_path / "jax", tmp_path / "port"
    for step, metric in saves:
        kw = dict(config={"a": 1}, keep_last=keep_last, keep_best=keep_best,
                  val_metric=metric, maximize=maximize)
        jckpt.save_checkpoint(str(jdir), step, jstate, **kw)
        pckpt.save_checkpoint(str(pdir), step, state, **kw)
        assert _names(pdir) == _names(jdir), (step, metric)
        for probe in PROBES:
            assert pckpt.would_enter_best(str(pdir), probe, keep_best, maximize) == \
                jckpt.would_enter_best(str(jdir), probe, keep_best, maximize), probe
    assert any(n.startswith("checkpoint.best_") for n in _names(pdir))
    for fn in ("best_checkpoint", "latest_checkpoint"):
        kw = {"maximize": maximize} if fn == "best_checkpoint" else {}
        got, want = getattr(pckpt, fn)(str(pdir), **kw), getattr(jckpt, fn)(str(jdir), **kw)
        assert got.rsplit("/", 1)[-1] == want.rsplit("/", 1)[-1]
    assert pckpt.best_checkpoint(str(tmp_path / "none")) is None
    assert pckpt.latest_checkpoint(str(tmp_path / "none")) is None
    # a best checkpoint is a hard-link tree of its checkpoint_<step>
    best = pckpt.best_checkpoint(str(pdir), maximize=maximize)
    assert (tmp_path / best / pckpt.STATE_FILE).stat().st_nlink >= 1
    assert not any("nan" in n or "inf" in n for n in _names(pdir))


def _trained_state(seed, steps=1):
    """A tiny StreamSpeech model's state after ``steps`` update_freq-2 calls:
    non-zero moments after two, a non-zero accumulator and mini_step 1 after
    an odd count."""
    cfg = tiny_config()
    for c in (cfg.encoder, cfg.mt_decoder, cfg.unit_decoder):
        c.dropout = 0.0
    model = random_init_(StreamSpeechModel(cfg), seed)
    tx = make_optimizer(OptimizationConfig(update_freq=2, warmup_updates=10))
    state = TrainState.create(model, tx)
    step = make_train_step(model, tx, unit_blank=cfg.unit_decoder.vocab_size - 1)
    batch = batch_to_tensors(synthetic_batch(cfg, batch=2), device="cpu")
    for _ in range(steps):
        state, _ = step(state, batch, None, 4, 8)
    return model, tx, state


def test_save_then_load_restores_everything_exactly(tmp_path):
    model, tx, state = _trained_state(0, steps=3)
    assert state.opt_state.mini_step == 1 and state.opt_state.count == 1
    path = pckpt.save_checkpoint(str(tmp_path), state.step, state)
    payload = torch.load(f"{path}/{pckpt.STATE_FILE}", weights_only=True)
    assert sorted(payload) == ["batch_stats", "opt_state", "params", "step"]
    assert sorted(payload["opt_state"]) == ["acc_grads", "count", "mini_step", "mu", "nu"]
    assert payload["params"]["encoder"]["layers_0"]["ffn1"]["w_1"]["kernel"].shape == \
        model.encoder.layers_0.ffn1.w_1.weight.T.shape
    fresh_model = random_init_(StreamSpeechModel(model.cfg), 9)
    fresh = TrainState.create(fresh_model, tx)
    pckpt.restore_state(fresh, pckpt.load_checkpoint(path))
    assert (fresh.step, fresh.opt_state.count, fresh.opt_state.mini_step) == \
        (state.step, state.opt_state.count, state.opt_state.mini_step) == (3, 1, 1)
    for name, p in state.params.items():
        assert torch.equal(fresh.params[name], p), name
    for name, b in state.batch_stats.items():
        assert torch.equal(fresh.batch_stats[name], b), name
    for what in ("mu", "nu", "acc_grads"):
        for a, b in zip(getattr(fresh.opt_state, what), getattr(state.opt_state, what)):
            assert torch.equal(a, b), what
    assert any(bool(a.any()) for a in state.opt_state.acc_grads)
    assert any(bool(m.any()) for m in state.opt_state.mu)


def _both_checkpoints(tmp_path, seeds):
    """The same weights as the port's checkpoints and as JAX's (orbax, a
    stand-in state holding the flax trees); returns the trees, the dirs."""
    trees = []
    for i, seed in enumerate(seeds):
        model, tx, state = _trained_state(seed, steps=0)
        trees.append(flax_variables(model))
        pckpt.save_checkpoint(str(tmp_path / "port"), i, state)
        jckpt.save_checkpoint(str(tmp_path / "jax"), i, types.SimpleNamespace(
            params=trees[-1]["params"], batch_stats=trees[-1]["batch_stats"],
            opt_state={"count": np.zeros((), np.int32)}, step=np.asarray(i, np.int32)))
    return trees, tmp_path / "port", tmp_path / "jax"


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_average_checkpoints_matches_jax(tmp_path):
    _, pdir, jdir = _both_checkpoints(tmp_path, (1, 2, 3))
    names = [f"checkpoint_{i}" for i in range(3)]
    got = pckpt.average_checkpoints([str(pdir / n) for n in names])
    want = jckpt.average_checkpoints([str(jdir / n) for n in names])
    g, w = _leaves(got["params"]), _leaves(want["params"])
    assert sorted(g) == sorted(w)
    for key in w:
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert int(got["step"]) == int(np.asarray(want["step"])) == 0
    first = pckpt.load_checkpoint(str(pdir / names[0]))
    for key, x in _leaves(first["batch_stats"]).items():
        np.testing.assert_array_equal(_leaves(got["batch_stats"])[key], x)
    # the CLI over the save dir's last 3
    port_avg_cli.main(["--inputs", str(pdir), "--num-last", "3",
                       "--output", str(tmp_path / "avg")])
    out = _leaves(pckpt.load_checkpoint(str(tmp_path / "avg"))["params"])
    for key in w:
        np.testing.assert_array_equal(out[key], w[key], err_msg=key)
    with pytest.raises(KeyError):
        pckpt._map_leaves(lambda *x: x[0], {"a": 1}, {"b": 1})


def test_load_pretrained_component_matches_jax(tmp_path):
    trees, pdir, jdir = _both_checkpoints(tmp_path, (5, 6))
    fresh = trees[1]
    fairseq = tmp_path / "donor.pt"
    sd = pckpt.export_fairseq_streamspeech(trees[0]["params"], trees[0]["batch_stats"])
    torch.save({"model": {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                "cfg": {}}, fairseq)
    for component in ("encoder", "unit_decoder"):
        for src_p, src_j in ((pdir / "checkpoint_0", jdir / "checkpoint_0"),
                             (fairseq, fairseq)):
            got = pckpt.load_pretrained_component(fresh, str(src_p), component)
            want = jckpt.load_pretrained_component(fresh, str(src_j), component)
            g, w = _leaves(got), _leaves(want)
            assert sorted(g) == sorted(w), component
            for key in w:
                np.testing.assert_array_equal(g[key], w[key], err_msg=key)
            donor = _leaves(trees[0]["params"][component])
            assert all(np.array_equal(v, _leaves(got["params"][component])[k])
                       for k, v in donor.items())
    with pytest.raises(KeyError):
        pckpt.load_pretrained_component(fresh, str(pdir / "checkpoint_0"), "nope")
    bad = {**fresh, "params": {**fresh["params"], "encoder": {"x": np.zeros(1)}}}
    with pytest.raises(ValueError, match="structure mismatch"):
        pckpt.load_pretrained_component(bad, str(pdir / "checkpoint_0"), "encoder")
    with pytest.raises(ValueError):
        jckpt.load_pretrained_component(bad, str(jdir / "checkpoint_0"), "encoder")
