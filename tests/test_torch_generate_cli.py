"""The port's offline generation CLI (``streamspeech_tpu_torch.cli.generate``)
against the JAX package's, run in process on the CPU on the same files:

- a doctored ``tiny_config`` model (weights from ``tests/jax_init.py``'s
  tiny JAX init) exported by JAX's ``export_fairseq_streamspeech`` to a
  fairseq ``.pt``; two native checkpoints of the port (``save_payload``; the
  second member from the port's seeded init) with the ``config.json`` beside
  them, which JAX's CLI reads through its ``load_checkpoint`` pointed at the
  port's files; a CodeHiFiGAN ``.pt`` and its config; a ``word count``
  dictionary; two ``chip_smoke._babble`` wavs in a wav list;
- at ``--beam 1``, ``--beam 3``, ``--batch-size 2`` and a two-checkpoint
  ensemble (``--checkpoint a,b --beam 2``): the ``A-``/``D-``/``U-`` lines
  and ``units.txt`` equal to the JAX CLI's; the wavs all pad to 96 fbank
  frames, so that JAX compiles one encode program a run (a batched row padded
  further than alone may decode differently, in JAX too:
  ``tests/test_torch_generation.py``), and the batched lines equal the
  single run's;
- ``--vocoder`` writes each utterance's units through the port's vocoder
  (16-bit wavs within 2 LSB);
- members of different structure raise; without ``--cpu`` and without a card
  the CLI raises;
- ``python -m streamspeech_tpu_torch.cli.generate`` in a fresh interpreter
  prints the same lines and imports nothing of JAX.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from chip_smoke import _babble
from tests.jax_init import init_variables, shared_jax_init  # noqa: F401
from tests.test_vocoder import tiny_cfg as tiny_vocoder_cfg
from tests.torch_threads import one_torch_thread  # noqa: F401

from streamspeech_tpu.cli import generate as jax_cli
from streamspeech_tpu.models.streamspeech import StreamSpeechModel as JaxModel
from streamspeech_tpu.train import checkpoint as jax_ckpt
from streamspeech_tpu.train.synthetic import tiny_config as jax_tiny_config

from streamspeech_tpu_torch.cli import generate as port_cli
from streamspeech_tpu_torch.config import tiny_config
from streamspeech_tpu_torch.data.dataset import load_audio_or_features
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.eval.instance import write_wav
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.models.vocoder import CodeGenerator
from streamspeech_tpu_torch.train import checkpoint as port_ckpt
from streamspeech_tpu_torch.weights import (
    doctor_params,
    flax_variables,
    load_flax_variables,
    random_init_,
)

REPO = Path(__file__).resolve().parents[1]
SECONDS = (0.85, 0.95)     # 83 and 93 fbank frames, both padded to 96: one encode shape
WAV_LSB = 2 / 32768
RUNS = {"beam1": ["--beam", "1", "--max-len", "16", "--output", "{out}"],
        "beam3": ["--beam", "3", "--max-len", "16", "--output", "{out}"],
        "batch2": ["--beam", "1", "--batch-size", "2", "--max-len", "16", "--output", "{out}"],
        "ensemble": ["--beam", "2", "--max-len", "16", "--output", "{out}"]}


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("generate")
    cfg = tiny_config()
    model = doctor_params(load_flax_variables(StreamSpeechModel(cfg),
                                              init_variables(JaxModel(jax_tiny_config()), 0)))
    tree = flax_variables(model)
    torch.save({"model": port_ckpt.tensor_tree(jax_ckpt.export_fairseq_streamspeech(
        tree["params"], tree["batch_stats"])), "cfg": {}}, root / "model.pt")
    other = flax_variables(doctor_params(random_init_(StreamSpeechModel(cfg), 3)))
    for name, t in (("a", tree), ("b", other)):
        port_ckpt.save_payload(str(root / "ck" / name), port_ckpt.tensor_tree(t))
    (root / "ck" / "config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    code_size = cfg.unit_decoder.vocab_size - 5
    voc_cfg = dict(tiny_vocoder_cfg(), num_embeddings=code_size)
    torch.save({"generator": port_ckpt.tensor_tree(port_ckpt.export_hifigan_vocoder(
        flax_variables(random_init_(CodeGenerator(voc_cfg), 1)), voc_cfg))},
        root / "vocoder.pt")
    (root / "vocoder.json").write_text(json.dumps(voc_cfg))
    text = Dictionary()
    for i in range(cfg.mt_decoder.vocab_size - 4):
        text.add_symbol("▁w" + str(i), i + 1)
    text.save(str(root / "dict.txt"))
    rng = np.random.RandomState(5)
    for i, s in enumerate(SECONDS):
        write_wav(root / f"utt{i}.wav", _babble(rng, s), 16000)
    (root / "wav_list.txt").write_text("".join(f"utt{i}.wav\n" for i in range(len(SECONDS))))
    return root


def _argv(root, name, side):
    model = (["--checkpoint", f"{root}/ck/a,{root}/ck/b"] if name == "ensemble"
             else ["--fairseq-checkpoint", f"{root}/model.pt"])
    rest = [a.format(root=root, out=root / f"{side}_{name}") for a in RUNS[name]]
    return model + rest + ["--manifest", str(root / "wav_list.txt"), "--src-dict",
                           str(root / "dict.txt"), "--tgt-dict", str(root / "dict.txt"),
                           "--cpu"]


def _port_checkpoint(path, target=None):
    """JAX's ``load_checkpoint`` reading the port's native checkpoint."""
    return _numpy(port_ckpt.load_checkpoint(path))


@pytest.fixture(scope="module")
def run(files):
    """run(side, name) → (printed lines, output dir), each run once a module."""
    done = {}

    def go(side, name):
        if (side, name) not in done:
            printed = io.StringIO()
            with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(printed):
                if side == "jax":
                    mp.setattr(jax_ckpt, "load_checkpoint", _port_checkpoint)
                    jax_cli.main(_argv(files, name, side))
                else:
                    port_cli.main(_argv(files, name, side))
            done[side, name] = (printed.getvalue().splitlines(), files / f"{side}_{name}")
        return done[side, name]

    return go


@pytest.mark.parametrize("name", list(RUNS))
def test_cli_lines_match_jax(run, name):
    (got, got_dir), (want, want_dir) = run("port", name), run("jax", name)
    assert len(got) == 3 * len(SECONDS)
    assert [line[:2] for line in got] == ["A-", "D-", "U-"] * len(SECONDS)
    assert any(line.startswith("D-") and line.split("\t")[1] for line in got), \
        "vacuous: no MT text"
    assert got == want
    assert (got_dir / "units.txt").read_text() == (want_dir / "units.txt").read_text()


def test_batched_lines_equal_single(run):
    single, _ = run("port", "beam1")
    batched, _ = run("port", "batch2")
    assert batched == single


def test_vocoder_writes_the_units_wavs(files, run, tmp_path):
    """``--vocoder``: a ``<id>_pred.wav`` an utterance with units, the port's
    vocoder on the ``U-`` line's units (JAX's vocoder against the port's:
    ``tests/test_torch_vocoder.py``)."""
    argv = _argv(files, "beam1", "port")
    argv[argv.index("--output") + 1] = str(tmp_path)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        port_cli.main(argv + ["--vocoder", f"{files}/vocoder.pt", "--vocoder-cfg",
                              f"{files}/vocoder.json"])
    assert printed.getvalue().splitlines() == run("port", "beam1")[0]
    voc_vars, voc_cfg = port_ckpt.import_hifigan_vocoder(f"{files}/vocoder.pt",
                                                         f"{files}/vocoder.json")
    vocoder = load_flax_variables(CodeGenerator(voc_cfg), voc_vars).eval()
    units = {line.split("\t")[0][2:]: [int(u) for u in line.split("\t")[1].split()]
             for line in printed.getvalue().splitlines() if line.startswith("U-")}
    assert any(units.values()), "vacuous: no units"
    for utt, codes in units.items():
        path = tmp_path / f"{utt}_pred.wav"
        assert path.exists() == bool(codes)
        if codes:
            with torch.no_grad():
                wav, n, _ = vocoder(torch.tensor([codes]), max_frames=4 * len(codes))
            np.testing.assert_allclose(load_audio_or_features(str(path)),
                                       wav[0, :int(n[0])].numpy(), atol=WAV_LSB)


def test_mismatched_members_and_no_card_raise(files, tmp_path):
    wide = tiny_config(vocab_text=40)
    port_ckpt.save_payload(str(tmp_path / "ck" / "c"), port_ckpt.tensor_tree(flax_variables(
        random_init_(StreamSpeechModel(wide), 1))))
    argv = _argv(files, "ensemble", "port")
    at = argv.index("--checkpoint") + 1
    argv[at] = f"{files}/ck/a,{tmp_path}/ck/c"
    with pytest.raises(ValueError, match=r"flax \(.*\) vs torch"):
        port_cli.main(argv)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it without --cpu")
    with pytest.raises(RuntimeError, match="--cpu"):
        port_cli.main([a for a in _argv(files, "beam3", "port") if a != "--cpu"])


_ALONE = r"""
import runpy, sys
sys.argv = ["generate"] + sys.argv[1:]
runpy.run_module("streamspeech_tpu_torch.cli.generate", run_name="__main__")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "streamspeech_tpu"))
print("FOREIGN", bad)
"""


def test_cli_module_runs_alone(files, run, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    argv = [a if not a.endswith("port_beam3") else str(tmp_path / "alone")
            for a in _argv(files, "beam3", "port")]
    proc = subprocess.run([sys.executable, "-c", _ALONE, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FOREIGN []" in proc.stdout
    lines = [line for line in proc.stdout.splitlines() if line[:2] in ("A-", "D-", "U-")]
    assert lines == run("port", "beam3")[0]
