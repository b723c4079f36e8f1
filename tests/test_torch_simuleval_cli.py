"""The port's streaming evaluation CLI (``streamspeech_tpu_torch.cli.simuleval``)
against the JAX package's, run in process on the CPU on the same files:

- a doctored ``tiny_config`` model (the port's seeded weights, in the flax
  layout) exported by JAX's ``export_fairseq_streamspeech`` to a fairseq
  ``.pt``, read back by both CLIs with ``--fairseq-checkpoint ... --cpu``
  (each infers the config from the shapes); a CodeHiFiGAN ``.pt``
  (weight-normed) and its config, built here from a seeded port vocoder by
  the port's ``export_hifigan_vocoder``; a ``word count`` dictionary; three
  ``chip_smoke._babble`` wavs;
- ``s2st`` (with the vocoder), ``s2tt`` and ``asr``, each at ``--batch 1`` and
  ``--batch 2``: ``instances.log`` equal to the JAX CLI's at ``--batch 1`` in
  prediction (for speech, the written wav within 2 LSB of 16 bits), delays,
  source_length and reference, and ``scores.tsv`` equal in every column but
  the _CA twins, which read the wall clock (``elapsed``); RTF reads the
  delays and the output intervals here, not the clock, and is compared. The
  JAX CLI at ``--batch 2`` (``s2tt``, ``asr``) is held to the port's on every
  instance where it equals its own ``--batch 1`` run: JAX's batched ticks
  decide a finished stream before its tail is encoded, which the port's do
  not (``tests/test_torch_text_agents.py``). JAX's batched S2ST, fused B = 2
  programs whose compiles would cost this file half a minute, is held to the
  port's in ``tests/test_torch_batched_eval.py`` and
  ``tests/test_torch_fused_batched.py``;
- ``--score-only`` re-scores a run's log to the run's numbers, as JAX's does;
- ``--standalone`` served on 127.0.0.1 and evaluated with ``--remote-eval``
  equals the local run;
- the ``--slurm`` script equals JAX's but for the module name;
- the fairseq import, config inference and export, and the vocoder import,
  equal JAX's on the same files;
- an ensemble ``--checkpoint a,b`` raises (the streaming engine serves one
  model; ensembles decode offline in ``cli.generate``), ``WHISPER_ASR_BLEU``
  raises and names what is missing; without ``--cpu`` and without a card the
  CLI raises (the ``t2t-*`` agents: ``tests/test_torch_text_mt.py``);
- ``python -m streamspeech_tpu_torch.cli.simuleval`` in a fresh interpreter
  writes the same log and imports nothing of JAX.

Both CLIs' engines take ``tests/torch_serving_stack.py``'s small serving
sizes (``ENGINE_SIZES``: 32 MT tokens, units to 64), set through each CLI
module's engine name, and JAX's CLI, which builds a new engine and compiles
its programs again on every call, gets one engine per vocoder setting (the
same checkpoint, so the same weights): the file's time stays small. The
fresh-interpreter run takes the defaults.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from chip_smoke import _babble
from streamspeech_tpu.cli import simuleval as jax_cli
from streamspeech_tpu.train import checkpoint as jax_ckpt
from tests.test_vocoder import tiny_cfg as tiny_vocoder_cfg
from tests.torch_serving_stack import ENGINE_SIZES
from tests.torch_threads import one_torch_thread  # noqa: F401

from streamspeech_tpu_torch.cli import simuleval as port_cli
from streamspeech_tpu_torch.config import tiny_config
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.eval import service
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
SECONDS = (0.95, 1.65, 0.7)
RUNS = [("s2st", 1), ("s2st", 2), ("s2tt", 1), ("s2tt", 2), ("asr", 1), ("asr", 2)]
WAV_LSB = 2 / 32768          # a 16-bit wav sample, twice


def _save_pt(path, payload_key, sd):
    torch.save({payload_key: {k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in sd.items()}, **({"cfg": {}} if payload_key ==
                                                          "model" else {})}, path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    cfg = tiny_config()
    tree = flax_variables(doctor_params(random_init_(StreamSpeechModel(cfg), 0)))
    _save_pt(root / "model.pt", "model",
             jax_ckpt.export_fairseq_streamspeech(tree["params"], tree["batch_stats"]))
    code_size = cfg.unit_decoder.vocab_size - 5          # 4 specials + blank
    voc_cfg = dict(tiny_vocoder_cfg(), num_embeddings=code_size)
    vocoder = random_init_(CodeGenerator(voc_cfg), 1)
    _save_pt(root / "vocoder.pt", "generator",
             port_ckpt.export_hifigan_vocoder(flax_variables(vocoder), voc_cfg))
    (root / "vocoder.json").write_text(json.dumps(voc_cfg))
    text = Dictionary()
    for i in range(cfg.mt_decoder.vocab_size - 4):
        text.add_symbol("▁w" + str(i), i + 1)
    text.save(str(root / "dict.txt"))
    rng = np.random.RandomState(5)
    wavs = []
    for i, s in enumerate(SECONDS):
        wavs.append(root / f"utt{i}.wav")
        write_wav(wavs[-1], _babble(rng, s), 16000)
    (root / "wav_list.txt").write_text("".join(f"{w.name}\n" for w in wavs))
    (root / "target.txt").write_text("w1 w2 w3\nw4\nw5 w6\n")
    return root, tree, code_size


def _argv(root, agent, batch, out):
    argv = ["--source", str(root / "wav_list.txt"), "--target", str(root / "target.txt"),
            "--fairseq-checkpoint", str(root / "model.pt"), "--agent", agent,
            "--batch", str(batch), "--src-dict", str(root / "dict.txt"),
            "--output", str(out), "--cpu"]
    if agent == "s2st":
        argv += ["--vocoder", str(root / "vocoder.pt"), "--vocoder-cfg",
                 str(root / "vocoder.json")]
    return argv


_PORT_ENGINE = port_cli.StreamSpeechEngine


def _port_small(model, vocoder=None, device="cuda"):
    return _PORT_ENGINE(model, vocoder, device=device, **ENGINE_SIZES)


@pytest.fixture(scope="module")
def run(files):
    """run(side, agent, batch) → the output directory of that CLI run, each
    run once a module; JAX's engine built once per vocoder setting."""
    root = files[0]
    engines, done = {}, {}
    jax_engine = jax_cli.StreamSpeechEngine

    def jax_cached(model, variables, vocoder=None, voc_vars=None):
        key = vocoder is None
        if key not in engines:
            engines[key] = jax_engine(model, variables, vocoder, voc_vars, **ENGINE_SIZES)
        return engines[key]

    def go(side, agent, batch):
        key = (side, agent, batch)
        if key not in done:
            out = root / f"{side}_{agent}_{batch}"
            argv = _argv(root, agent, batch, out) + ["--target-code-size", str(files[2])]
            with pytest.MonkeyPatch.context() as mp:
                if side == "jax":
                    mp.setattr(jax_cli, "StreamSpeechEngine", jax_cached)
                    jax_cli.main(argv)
                else:
                    mp.setattr(port_cli, "StreamSpeechEngine", _port_small)
                    port_cli.main(argv)
            done[key] = out
        return done[key]

    return go


def _log(out):
    return [json.loads(line) for line in (Path(out) / "instances.log").read_text().splitlines()]


def _scores(out):
    head, vals = (Path(out) / "scores.tsv").read_text().splitlines()
    return dict(zip(head.split("\t"), vals.split("\t")))


def _wav(path):
    from streamspeech_tpu_torch.data.dataset import load_audio_or_features

    return load_audio_or_features(path)


def _same_logs(got, want, speech):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for key in ("index", "delays", "source_length", "reference"):
            assert g[key] == w[key], (key, g["index"])
        if speech:
            assert g["durations"] == w["durations"] and g["intervals"] == w["intervals"]
            if w["prediction"] is not None and Path(w["prediction"]).exists():
                np.testing.assert_allclose(_wav(g["prediction"]), _wav(w["prediction"]),
                                           atol=WAV_LSB)
        else:
            assert g["prediction"] == w["prediction"], g["index"]


def _same_scores(got, want):
    assert list(got) == list(want)
    for name in want:
        if not name.endswith("_CA"):
            assert got[name] == want[name], name


def _agree(got, want, speech) -> bool:
    try:
        _same_logs([got], [want], speech)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("agent,batch", RUNS)
def test_cli_matches_jax(run, agent, batch):
    got, want = run("port", agent, batch), run("jax", agent, 1)
    speech = agent == "s2st"
    _same_logs(_log(got), _log(want), speech)
    _same_scores(_scores(got), _scores(want))
    assert ("ASR_BLEU" if speech else "BLEU") in _scores(got)
    assert sum(len(line["delays"]) for line in _log(got)) > 0, f"{agent} wrote nothing"
    if batch > 1 and not speech:
        jax_batched = _log(run("jax", agent, batch))
        for g, w, seq in zip(_log(got), jax_batched, _log(want)):
            if _agree(w, seq, speech):
                _same_logs([g], [w], speech)
        if all(_agree(w, seq, speech) for w, seq in zip(jax_batched, _log(want))):
            _same_scores(_scores(got), _scores(run("jax", agent, batch)))


def test_score_only_rescores(run, capsys):
    out = run("port", "s2tt", 1)
    want = _scores(out)
    capsys.readouterr()
    rescored = port_cli.main(["--source", "-", "--target", "-", "--score-only",
                              "--output", str(out), "--quality-metrics", "BLEU", "WER"])
    printed = dict(line.split("\t") for line in capsys.readouterr().out.splitlines())
    for name in want:
        assert f"{rescored[name]:.3f}" == want[name] == printed[name], name
    assert "WER" in rescored and rescored["WER"] >= 0
    jax_cli.main(["--source", "-", "--target", "-", "--score-only", "--output",
                  str(run("jax", "s2tt", 1)), "--quality-metrics", "BLEU", "WER"])
    jax_printed = dict(line.split("\t") for line in capsys.readouterr().out.splitlines())
    assert {k: v for k, v in printed.items() if not k.endswith("_CA")} == \
        {k: v for k, v in jax_printed.items() if not k.endswith("_CA")}


def test_standalone_and_remote_eval_equal_the_local_run(files, run, monkeypatch):
    root = files[0]
    started = []

    class Recorded(service.AgentService):
        def start(self, background=True):
            started.append(self)
            return super().start(background)

    monkeypatch.setattr(service, "AgentService", Recorded)
    monkeypatch.setattr(port_cli, "StreamSpeechEngine", _port_small)
    argv = _argv(root, "s2st", 1, root / "served")
    server = threading.Thread(target=port_cli.main, daemon=True, args=(
        argv + ["--standalone", "--remote-port", "0"],))
    server.start()
    deadline = time.time() + 120
    while not (started and started[0].httpd) and time.time() < deadline:
        time.sleep(0.05)
    assert started and started[0].httpd, "the agent service did not start"
    port = started[0].httpd.server_address[1]
    started[0].host = "127.0.0.1"
    try:
        port_cli.main(_argv(root, "s2st", 1, root / "remote") + [
            "--remote-eval", "--remote-address", f"http://127.0.0.1:{port}"])
    finally:
        started[0].stop()
        server.join(timeout=30)
    _same_logs(_log(root / "remote"), _log(run("port", "s2st", 1)), speech=True)
    _same_scores(_scores(root / "remote"), _scores(run("port", "s2st", 1)))


def test_slurm_script_matches_jax(files, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("PATH", str(tmp_path))           # no sbatch to submit to
    root = files[0]
    scripts = []
    for side, cli in (("jax", jax_cli), ("port", port_cli)):
        out = tmp_path / side
        cli.main(_argv(root, "s2tt", 2, out) + ["--slurm", "--slurm-time", "1:00:00",
                                                  "--slurm-partition=gpu"])
        scripts.append((out / "script.sh").read_text().replace(str(out), "OUT"))
    assert "sbatch not found" in capsys.readouterr().out
    assert "-m streamspeech_tpu_torch.cli.simuleval" in scripts[1]
    assert scripts[1].replace("streamspeech_tpu_torch.cli", "streamspeech_tpu.cli") == \
        scripts[0]
    assert "--slurm" not in scripts[1] and "#SBATCH --time=1:00:00" in scripts[1]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _same_tree(got, want):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k


def test_checkpoint_import_export_match_jax(files):
    root, tree, _ = files
    got = port_ckpt.import_fairseq_streamspeech(str(root / "model.pt"))
    want = jax_ckpt.import_fairseq_streamspeech(str(root / "model.pt"))
    _same_tree(got[0], want[0])
    _same_tree(got[1], want[1])
    _same_tree(got[0], tree["params"])
    assert dataclasses.asdict(port_ckpt.infer_config_from_params(got[0], got[1])) == \
        dataclasses.asdict(jax_ckpt.infer_config_from_params(want[0], want[1]))
    port_sd = port_ckpt.export_fairseq_streamspeech(tree["params"], tree["batch_stats"])
    jax_sd = jax_ckpt.export_fairseq_streamspeech(tree["params"], tree["batch_stats"])
    _same_tree(port_sd, jax_sd)
    # the port's own model → flax tree → fairseq: the same state dict
    cfg = port_ckpt.infer_config_from_params(got[0], got[1])
    model = load_flax_variables(StreamSpeechModel(cfg), {"params": got[0],
                                                         "batch_stats": got[1]})
    mine = flax_variables(model)
    _same_tree(port_ckpt.export_fairseq_streamspeech(mine["params"], mine["batch_stats"]),
               jax_sd)

    vgot, vcfg = port_ckpt.import_hifigan_vocoder(str(root / "vocoder.pt"),
                                                  str(root / "vocoder.json"))
    vwant, jcfg = jax_ckpt.import_hifigan_vocoder(str(root / "vocoder.pt"),
                                                  str(root / "vocoder.json"))
    assert vcfg == jcfg
    _same_tree(vgot, vwant)
    vocoder = random_init_(CodeGenerator(vcfg), 1)
    for k, v in _flat(flax_variables(vocoder)):
        np.testing.assert_allclose(dict(_flat(vgot))[k], v, rtol=1e-6, atol=1e-7)


def test_unported_paths_raise(files, tmp_path):
    root = files[0]
    argv = _argv(root, "s2st", 1, tmp_path / "x")
    # an ensemble (comma-separated native checkpoints) decodes offline only
    params, stats, _ = port_ckpt.import_fairseq_streamspeech(str(root / "model.pt"))
    port_ckpt.save_payload(str(tmp_path / "ck" / "a"),
                           port_ckpt.tensor_tree({"params": params, "batch_stats": stats}))
    (tmp_path / "ck" / "config.json").write_text(json.dumps(dataclasses.asdict(
        port_ckpt.infer_config_from_params(params, stats))))
    ckpt = [a if a != "--fairseq-checkpoint" else "--checkpoint" for a in argv]
    at = ckpt.index("--checkpoint") + 1
    ckpt[at] = f"{tmp_path}/ck/a,{tmp_path}/ck/a"       # an ensemble of two
    with pytest.raises(ValueError, match="offline with cli.generate"):
        port_cli.main(ckpt)
    with pytest.raises(NotImplementedError, match="WHISPER_ASR_BLEU"):
        port_cli.main(argv + ["--quality-metrics", "WHISPER_ASR_BLEU"])
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLI runs on it without --cpu")
    with pytest.raises(RuntimeError, match="--cpu"):
        port_cli.main([a for a in argv if a != "--cpu"])


_ALONE = r"""
import runpy, sys
sys.argv = ["simuleval"] + sys.argv[1:]
runpy.run_module("streamspeech_tpu_torch.cli.simuleval", run_name="__main__")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "streamspeech_tpu"))
print("FOREIGN", bad)
"""


def test_cli_module_runs_alone(files, run, tmp_path):
    root = files[0]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _ALONE,
                           *_argv(root, "asr", 1, tmp_path / "alone")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FOREIGN []" in proc.stdout
    _same_logs(_log(tmp_path / "alone"), _log(run("port", "asr", 1)), speech=False)
