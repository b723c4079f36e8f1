"""The port's training CLI (``streamspeech_tpu_torch.cli.train``) against the
JAX package's (``streamspeech_tpu.cli.train``) on a toy dataset on disk.

The test writes the toy task (``data/toy_task.py``: 16 train utterances as
fbank ``.npy``, 8 dev wavs, each of 3 words of 0.1 s) and runs both CLIs at
``--tiny-dims --encoder-layers 2 --dropout 0 --update-freq 2 --max-update 4
--max-sentences 9``: two train batches of 8 and one dev batch of 8, all of
one shape (the batcher closes a batch before the row that fills
``--max-sentences``), so JAX compiles one step and the port's
``--steps-per-call 2`` runs blocks; validation and saves at updates 2 and 4,
every update logged. JAX's CLI
runs once for the file in a subprocess without the suite's ``XLA_FLAGS`` (its
8 virtual devices would give the CLI a data=8 mesh), as
``toy_task.run_learnability_golden`` runs it. Its ``init_params`` is wrapped
in that process to write the weights it returns to a file on their way, so
the test reads JAX's initial weights as the CLI drew them and draws them no
second time. (JAX's CLI compiles its step twice: the state it shards before
the first call carries ``PartitionSpec(None, None)`` where the step's output
carries ``PartitionSpec()``, and the second call sees new shardings.) The
port's CLI starts from those weights: the test writes them, through the
weight bridge, as the port's ``checkpoint_0``, from which the CLI resumes. It
runs twice, ``--steps-per-call 1`` in a fresh interpreter (which imports
nothing of JAX) and ``--steps-per-call 2`` in this process, both while JAX's
CLI runs.

- every update's loss and each validation loss within 2e-4·max(1, |ref|) of
  JAX's (``train.log``, as both CLIs write it);
- the final checkpoint's parameters, batch statistics, Adam moments and the
  MultiSteps accumulator within 1e-4·max(1, max|ref|) of JAX's orbax
  checkpoint (read with JAX's ``load_checkpoint``); ``count``, ``mini_step``
  and ``step`` equal;
- ``--steps-per-call 2`` gives the ``--steps-per-call 1`` run's log and
  checkpoints bit for bit;
- a second run resumes at update 4 from the port's own checkpoint;
- ``cli.simuleval --agent s2tt --checkpoint`` runs on a checkpoint the CLI
  wrote;
- no card and no ``--cpu``, ``--tp 2`` and ``--fsdp`` raise.
"""

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from streamspeech_tpu.cli import train as jax_cli
from streamspeech_tpu.config import OptimizationConfig as JaxOptimizationConfig
from streamspeech_tpu.config import to_dict as jax_to_dict
from streamspeech_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from streamspeech_tpu.train.trainer import TrainState as JaxTrainState
from streamspeech_tpu.train.trainer import make_optimizer as jax_make_optimizer

from streamspeech_tpu_torch.cli import simuleval as port_simuleval
from streamspeech_tpu_torch.cli import train as port_cli
from streamspeech_tpu_torch.config import OptimizationConfig, to_dict
from streamspeech_tpu_torch.data.toy_task import generate_toy_dataset
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.train import checkpoint as pckpt
from streamspeech_tpu_torch.train.trainer import TrainState, make_optimizer
from streamspeech_tpu_torch.weights import load_flax_variables, named_from_flax
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 2e-4     # of max(1, |ref|), each logged loss
STATE_RTOL = 1e-4    # of max(1, max|ref|), each state tensor

_ALONE = r"""
import runpy, sys
sys.argv = ["train"] + sys.argv[1:]
runpy.run_module("streamspeech_tpu_torch.cli.train", run_name="__main__")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "streamspeech_tpu"))
print("FOREIGN", bad)
"""

# JAX's CLI, its init_params wrapped to write the initial weights to argv[1]
_JAX_CLI = r"""
import os, pickle, sys
import jax, numpy as np
from streamspeech_tpu.cli import train
init_params = train.init_params


def write_on_the_way(model, rng):
    variables = init_params(model, rng)
    with open(sys.argv[1] + ".tmp", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, variables), f)
    os.replace(sys.argv[1] + ".tmp", sys.argv[1])
    return variables


train.init_params = write_on_the_way
train.main(sys.argv[2:])
"""


def _wait_for(path, proc, timeout=600):
    """The pickle at ``path`` once ``proc`` has written it."""
    deadline = time.monotonic() + timeout
    while not path.exists():
        if proc.poll() is not None:
            raise AssertionError(proc.stdout.read()[-4000:])
        assert time.monotonic() < deadline, f"no {path} after {timeout} s"
        time.sleep(0.2)
    return pickle.loads(path.read_bytes())


def _argv(task, save_dir, *extra):
    return ["--data", task["data"], "--config-yaml", task["config_yaml"],
            "--multitask-config-yaml", task["multitask_config_yaml"],
            "--target-code-size", str(task["n_units"]), "--tiny-dims",
            "--encoder-layers", "2",
            "--ctc-upsample-rate", "8", "--dropout", "0", "--update-freq", "2",
            "--max-update", "4", "--max-sentences", "9", "--max-tokens", "0",
            "--lr", "2e-3", "--warmup-updates", "3", "--seed", "1",
            "--log-interval", "1", "--validate-interval-updates", "2",
            "--save-interval-updates", "2", "--save-dir", str(save_dir), "--cpu",
            *extra]


def _log(save_dir):
    """(train lines without the wall-clock ``ups``, valid lines) of a train.log."""
    train, valid = [], []
    for line in (Path(save_dir) / "train.log").read_text().splitlines():
        d = json.loads(line)
        if d["tag"] == "train" and "loss" in d:
            train.append({k: v for k, v in d.items() if k != "ups"})
        elif d["tag"] == "valid":
            valid.append(d)
    return train, valid


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    task = generate_toy_dataset(str(root / "data"), n_train=16, n_dev=8, seed=3,
                                samples_per_word=1600, words_per_utterance=(3, 3))
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    init_file = root / "jax_init.pkl"
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", _JAX_CLI, str(init_file), *_argv(task, root / "jax")],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        jargs = jax_cli.add_args(argparse.ArgumentParser()).parse_args(
            _argv(task, root / "jax"))
        jcfg = jax_cli.build_model_config(jargs, jax_cli.load_task(jargs)[0])
        # JAX's initial weights, as its CLI draws them, as the port's checkpoint_0
        variables = _wait_for(init_file, jax_proc)
        pargs = port_cli.add_args(argparse.ArgumentParser()).parse_args(
            _argv(task, root / "port1"))
        pcfg = port_cli.build_model_config(pargs, port_cli.load_task(pargs)[0])
        assert to_dict(pcfg) == jax_to_dict(jcfg)
        model = load_flax_variables(StreamSpeechModel(pcfg), variables)
        tx = make_optimizer(OptimizationConfig(update_freq=2))
        for name in ("port1", "port2"):
            pckpt.save_checkpoint(str(root / name), 0, TrainState.create(model, tx),
                                  config=to_dict(pcfg))
        alone = subprocess.Popen(
            [sys.executable, "-c", _ALONE, *_argv(task, root / "port1")], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        blocks = []
        real_scan = port_cli.make_train_step_scan

        def counted_scan(*a, **kw):
            step_k = real_scan(*a, **kw)

            def run(state, batches, *rest):
                blocks.append(len(batches["n2"]))
                return step_k(state, batches, *rest)
            return run

        port_cli.make_train_step_scan = counted_scan
        try:
            port_cli.main(_argv(task, root / "port2", "--steps-per-call", "2"))
        finally:
            port_cli.make_train_step_scan = real_scan
        alone_out, _ = alone.communicate(timeout=600)
        jax_out, _ = jax_proc.communicate(timeout=900)
    finally:
        jax_proc.kill()
    assert jax_proc.returncode == 0, jax_out[-4000:]
    assert alone.returncode == 0, alone_out[-4000:]
    return {"root": root, "task": task, "variables": variables, "jcfg": jcfg,
            "alone_out": alone_out, "blocks": blocks}


def test_cli_runs_alone_without_jax(runs):
    assert "FOREIGN []" in runs["alone_out"]


def test_every_update_loss_matches_jax(runs):
    (ptrain, pvalid), (jtrain, jvalid) = _log(runs["root"] / "port1"), \
        _log(runs["root"] / "jax")
    assert [d["step"] for d in ptrain] == [d["step"] for d in jtrain] == [1, 2, 3, 4]
    assert [d["step"] for d in pvalid] == [d["step"] for d in jvalid] == [2, 4]
    for got, want in zip(ptrain, jtrain):
        for key in ("loss", "unit_ctc", "grad_norm", "overflow"):
            assert abs(got[key] - want[key]) <= LOSS_RTOL * max(1.0, abs(want[key])), \
                (got["step"], key, got[key], want[key])
    for got, want in zip(pvalid, jvalid):
        assert abs(got["valid_loss"] - want["valid_loss"]) <= \
            LOSS_RTOL * max(1.0, abs(want["valid_loss"])), (got, want)


def _close_tree(got, want, what):
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[name], np.float64)
        assert g.shape == w.shape, (what, name)
        tol = STATE_RTOL * max(1.0, float(np.abs(w).max()) if w.size else 0.0)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=f"{what} {name}")


def test_final_state_matches_jax(runs):
    jtx = jax_make_optimizer(JaxOptimizationConfig(
        lr=2e-3, warmup_updates=3, clip_norm=1.0, update_freq=2, max_tokens=0,
        max_update=4))
    variables = runs["variables"]
    target = JaxTrainState.create(jax.tree.map(jnp.asarray, variables), jtx)
    want = jax_load_checkpoint(str(runs["root"] / "jax" / "checkpoint_4"), target=target)
    got = pckpt.load_checkpoint(str(runs["root"] / "port1" / "checkpoint_4"))
    adam = want["opt_state"].inner_opt_state[1]
    pairs = {"params": (got["params"], want["params"]),
             "batch_stats": (got["batch_stats"], want["batch_stats"]),
             "mu": (got["opt_state"]["mu"], adam.mu),
             "nu": (got["opt_state"]["nu"], adam.nu),
             "acc_grads": (got["opt_state"]["acc_grads"], want["opt_state"].acc_grads)}
    for what, (g, w) in pairs.items():
        coll = "batch_stats" if what == "batch_stats" else "params"
        _close_tree(named_from_flax(g, coll), named_from_flax(
            jax.tree.map(np.asarray, w), coll), what)
    assert int(got["opt_state"]["count"]) == int(adam.count) == 2
    assert int(got["opt_state"]["mini_step"]) == int(want["opt_state"].mini_step) == 0
    assert int(got["step"]) == int(want["step"]) == 4
    # the params moved away from the initial weights
    first = named_from_flax(variables["params"])
    moved = named_from_flax(got["params"])
    assert max(float(np.abs(moved[n] - first[n]).max()) for n in first) > 1e-3


def test_steps_per_call_2_gives_steps_per_call_1_bit_for_bit(runs):
    assert runs["blocks"] == [2, 2]                # both epochs ran as one block
    one, two = runs["root"] / "port1", runs["root"] / "port2"
    assert _log(one) == _log(two)
    assert sorted(p.name for p in one.iterdir()) == sorted(p.name for p in two.iterdir())
    for step in (2, 4):
        a = pckpt.load_checkpoint(str(one / f"checkpoint_{step}"))
        b = pckpt.load_checkpoint(str(two / f"checkpoint_{step}"))
        flat_a, flat_b = dict(_flat(a)), dict(_flat(b))
        assert sorted(flat_a) == sorted(flat_b)
        for key, x in flat_a.items():
            assert torch.equal(x, flat_b[key]), (step, key)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_second_run_resumes_at_update_4(runs, tmp_path):
    save = tmp_path / "resume"
    shutil.copytree(runs["root"] / "port2", save)
    argv = _argv(runs["task"], save)
    argv[argv.index("--max-update") + 1] = "6"
    state = port_cli.main(argv)
    lines = [json.loads(x) for x in (save / "train.log").read_text().splitlines()]
    resumed = [d for d in lines if d.get("event") == "resumed"]
    assert resumed and resumed[-1]["from"].endswith("checkpoint_4")
    after = lines[lines.index(resumed[-1]):]
    assert [d["step"] for d in after if d["tag"] == "train" and "loss" in d] == [5, 6]
    assert state.step == 6 and state.opt_state.count == 3
    assert (save / "checkpoint_6" / pckpt.STATE_FILE).exists()


def test_simuleval_s2tt_runs_on_a_checkpoint_the_cli_wrote(runs, tmp_path):
    task = runs["task"]
    n_wavs = len(Path(task["dev_wavs"]).read_text().split())
    scores = port_simuleval.main(
        ["--source", task["dev_wavs"], "--target", task["dev_text"], "--agent", "s2tt",
         "--checkpoint", str(runs["root"] / "port1" / "checkpoint_4"),
         "--src-dict", task["text_dict"], "--tgt-dict", task["text_dict"],
         "--target-code-size", str(task["n_units"]), "--batch", "4",
         "--output", str(tmp_path / "eval"), "--cpu"])
    lines = [json.loads(x) for x in
             (tmp_path / "eval" / "instances.log").read_text().splitlines()]
    assert sorted(int(d["index"]) for d in lines) == list(range(n_wavs)) and n_wavs == 8
    assert "BLEU" in scores


def test_unported_or_unavailable_paths_raise(runs, monkeypatch, tmp_path):
    argv = _argv(runs["task"], tmp_path / "x")
    with pytest.raises(NotImplementedError, match="ROADMAP §A item 10"):
        port_cli.main(argv + ["--tp", "2"])
    with pytest.raises(NotImplementedError, match="ROADMAP §A item 10"):
        port_cli.main(argv + ["--fsdp"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--cpu"):
        port_cli.main([a for a in argv if a != "--cpu"])
