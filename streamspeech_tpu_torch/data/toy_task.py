"""Deterministic toy S2ST task for end-to-end learnability goldens (the
port of ``streamspeech_tpu/data/toy_task.py``).

The reference's de-facto golden test is the example run on real fr-en data
(the reference README: train the simul model → evaluate with SIMULEVAL →
ASR-BLEU 15.448 / AL 1724.9). Without released data or checkpoints, this
module constructs a task with the same
*shape* — 16 kHz waveforms in, unit sequences + text out — deterministic
enough that a few hundred CPU train steps of the real model (real criterion
incl. streaming masks, real `cli.train`) must learn it, and evaluates the
trained checkpoint the same way the reference golden does: STREAMING, through
`cli.simuleval` / the streaming evaluator harness (the simul-trained model is
in-distribution only under its streaming masks — offline full-context decode
of a simul checkpoint is the one regime the reference never scores):

- K "words": word w is a tone at a word-specific frequency (mel-spread) with
  a word-specific temporal envelope, plus noise;
- a word maps to one text token ("▁w3") and a fixed 6-unit subsequence;
- an utterance is 2-4 words; text targets are the word tokens (shared by the
  MT decoder, ASR head, and ST head), unit targets the concatenated
  subsequences.

`generate_toy_dataset` writes the REAL on-disk task layout (manifest tsvs,
multitask target tsvs, dict files, config yamls — the same files
`fairseq/fairseq/tasks/speech_to_speech.py:212-290` parses) plus the
wav-list/reference files `cli.simuleval` consumes, so the golden exercises
the same loaders/CLIs a user runs on real data.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

N_FEAT = 80
SAMPLE_RATE = 16000
# mel-spread tone frequencies, one per word (roughly equal mel spacing)
WORD_FREQS = [300.0, 620.0, 1050.0, 1600.0, 2400.0, 3600.0]

# tiny CodeHiFiGAN config for the unit-emission leg of the golden: the
# product of upsample_rates must stay 320 samples per unit frame (the
# engine's emission-window math assumes it); everything else is shrunk.
# Weights are RANDOM — the golden scores the UNIT sequences the S2ST agent
# emits, not the audio.
TOY_VOCODER_CFG: Dict = {
    "upsample_rates": [16, 20],
    "upsample_kernel_sizes": [32, 40],
    "upsample_initial_channel": 16,
    "resblock_kernel_sizes": [3],
    "resblock_dilation_sizes": [[1, 3]],
    "num_embeddings": 45,  # 40 raw codes + 4 specials + blank
    "embedding_dim": 16,
    "model_in_dim": 16,
    "dur_predictor_params": {
        "encoder_embed_dim": 16,
        "var_pred_hidden_dim": 16,
        "var_pred_kernel_size": 3,
        "var_pred_dropout": 0.5,
    },
}


def word_wav(w: int, samples: int, rng: np.random.RandomState) -> np.ndarray:
    """[samples] float waveform for word w (+ fresh noise)."""
    t = np.arange(samples, dtype=np.float32) / SAMPLE_RATE
    # word-specific temporal envelope (same idea as the reference's fbank
    # patterns, but applied to a tone so OnlineFbank sees it)
    env = 0.55 + 0.45 * np.sin(
        2 * np.pi * (w + 1) * np.arange(samples, dtype=np.float32) / samples)
    f = WORD_FREQS[w % len(WORD_FREQS)]
    x = 0.35 * env * np.sin(2 * np.pi * f * t)
    x += 0.08 * np.sin(2 * np.pi * 2 * f * t)
    x += rng.randn(samples).astype(np.float32) * 0.004
    return x.astype(np.float32)


def word_units(w: int, n_units: int, units_per_word: int = 6) -> List[int]:
    """Fixed raw unit codes (0..n_units-1) for word w."""
    return [(5 * w + 3 * j + 1) % n_units for j in range(units_per_word)]


def make_utterance(words: List[int], samples_per_word: int, n_units: int,
                   rng: np.random.RandomState
                   ) -> Tuple[np.ndarray, List[int], List[str]]:
    wav = np.concatenate(
        [word_wav(w, samples_per_word, rng) for w in words], axis=0)
    units: List[int] = []
    for w in words:
        units.extend(word_units(w, n_units))
    text = [f"w{w}" for w in words]
    return wav, units, text


def _write_wav(path: Path, wav: np.ndarray) -> None:
    import wave

    pcm = np.clip(wav * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(SAMPLE_RATE)
        f.writeframes(pcm.tobytes())


def _fbank_frames(wav: np.ndarray) -> np.ndarray:
    """Offline fbank via the ONLINE extractor (host torch on the CPU)."""
    from streamspeech_tpu_torch.ops.fbank import OnlineFbank

    fb = OnlineFbank()
    return fb.push(wav)


def generate_toy_dataset(out_dir: str, n_train: int = 300, n_dev: int = 24,
                         n_words: int = 6, samples_per_word: int = 6400,
                         n_units: int = 40, seed: int = 0,
                         words_per_utterance: Tuple[int, int] = (2, 4)
                         ) -> Dict[str, str]:
    """Write the task to `out_dir`; returns paths of the key files.

    Train split manifests reference precomputed fbank .npy (what the fr-en
    recipe trains on); the dev split references the wavs themselves plus a
    `dev_wavs.txt` / `dev_text.txt` pair for `cli.simuleval`. An utterance
    has between ``words_per_utterance`` words (inclusive; the JAX package's
    2 to 4 by default, the same draws).
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / "feats").mkdir(exist_ok=True)
    (out / "wavs").mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)

    # text dictionary shared by all three text tasks (spm-piece symbols, so
    # the agents' spm_to_text detokenization yields "w3 w1 ...")
    from streamspeech_tpu_torch.dictionary import Dictionary

    tdict = Dictionary()
    for w in range(n_words):
        tdict.add_symbol(f"▁w{w}")
    for task in ("target_unigram", "source_unigram", "ctc_target_unigram"):
        (out / task).mkdir(exist_ok=True)
        tdict.save(str(out / task / "dict.txt"))

    splits = {"train": n_train, "dev": n_dev}
    refs: Dict[str, List[Tuple[str, List[int], List[str]]]] = {}
    dev_wavs: List[str] = []
    dev_text: List[str] = []
    for split, n in splits.items():
        rows = ["id\tsrc_audio\tsrc_n_frames\ttgt_audio\ttgt_n_frames"]
        task_rows = {t: ["id\ttgt_text"] for t in
                     ("target_unigram", "source_unigram",
                      "ctc_target_unigram")}
        refs[split] = []
        for i in range(n):
            n_w = rng.randint(words_per_utterance[0], words_per_utterance[1] + 1)
            words = [int(rng.randint(0, n_words)) for _ in range(n_w)]
            wav, units, text = make_utterance(words, samples_per_word,
                                              n_units, rng)
            utt = f"{split}_{i}"
            _write_wav(out / "wavs" / f"{utt}.wav", wav)
            if split == "train":
                feats = _fbank_frames(wav)
                np.save(out / "feats" / f"{utt}.npy", feats)
                src_ref, n_frames = f"feats/{utt}.npy", feats.shape[0]
            else:
                from streamspeech_tpu_torch.ops.fbank import num_frames

                src_ref = f"wavs/{utt}.wav"
                n_frames = num_frames(len(wav), SAMPLE_RATE)
                dev_wavs.append(str(out / "wavs" / f"{utt}.wav"))
                dev_text.append(" ".join(text))
            rows.append(f"{utt}\t{src_ref}\t{n_frames}\t"
                        f"{' '.join(map(str, units))}\t{len(units)}")
            pieces = " ".join("▁" + t for t in text)
            for t in task_rows:
                task_rows[t].append(f"{utt}\t{pieces}")
            refs[split].append((utt, units, text))
        (out / f"{split}.tsv").write_text("\n".join(rows) + "\n")
        for t, tr in task_rows.items():
            (out / t / f"{split}.tsv").write_text("\n".join(tr) + "\n")

    (out / "dev_wavs.txt").write_text("\n".join(dev_wavs) + "\n")
    (out / "dev_text.txt").write_text("\n".join(dev_text) + "\n")
    (out / "config_toy.yaml").write_text(
        "input_feat_per_channel: 80\ninput_channels: 1\n")
    (out / "config_mtl_toy.yaml").write_text("\n".join(
        f"""{name}:
  decoder_type: {"transformer" if name == "target_unigram" else "ctc"}
  dict: {out / name / "dict.txt"}
  data: {out / name}
  loss_weight: {8.0 if name == "target_unigram" else 4.0}"""
        for name in ("target_unigram", "source_unigram",
                     "ctc_target_unigram")) + "\n")
    return {"data": str(out), "config_yaml": "config_toy.yaml",
            "multitask_config_yaml": "config_mtl_toy.yaml",
            "n_units": n_units, "text_dict": str(out / "target_unigram" /
                                                 "dict.txt"),
            "dev_wavs": str(out / "dev_wavs.txt"),
            "dev_text": str(out / "dev_text.txt")}


# ---------------------------------------------------------------------------
# streaming evaluation legs (the golden's scoring path)
# ---------------------------------------------------------------------------


def _check_device(device: str) -> None:
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu'")


def eval_units_streaming(checkpoint: str, data_dir: str, batch: int = 6,
                         device: str = "cuda") -> List[List[int]]:
    """Decode the dev set's UNIT sequences with the streaming S2ST agent
    through the batched evaluator, with a tiny random-weight vocoder: the
    golden scores the units the agent emits, not the audio. ``device`` is
    "cuda" (the default; it raises without a card) or "cpu". Returns raw
    unit codes per utterance, corpus order."""
    _check_device(device)
    from streamspeech_tpu_torch.agents.streamspeech import StreamSpeechAgentConfig
    from streamspeech_tpu_torch.cli.generate import load_model
    from streamspeech_tpu_torch.data.dataset import load_audio_or_features
    from streamspeech_tpu_torch.dictionary import Dictionary
    from streamspeech_tpu_torch.eval.batched_evaluator import BatchedS2STEvaluator
    from streamspeech_tpu_torch.models.vocoder import CodeGenerator
    from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine
    from streamspeech_tpu_torch.weights import random_init_

    class _Args:
        fairseq_checkpoint = None

    _Args.checkpoint = checkpoint
    model, cfg = load_model(_Args)
    voc = random_init_(CodeGenerator(dict(TOY_VOCODER_CFG,
                                          num_embeddings=cfg.unit_decoder.vocab_size)), 0)

    data = Path(data_dir)
    srcs = []
    for line in (data / "dev_wavs.txt").read_text().splitlines():
        if line.strip():
            srcs.append(list(np.asarray(
                load_audio_or_features(line.strip(), data), np.float32)))
    refs = [""] * len(srcs)

    tdict = Dictionary.load(str(data / "target_unigram" / "dict.txt"))
    unit_dict = Dictionary.units(
        cfg.unit_decoder.vocab_size - 5)  # raw codes (minus specials+blank)
    unit_dict.add_blank()
    engine = StreamSpeechEngine(model, voc, device=device, mt_buckets=(16, 32),
                                unit_buckets=(64, 128))
    agent_cfg = StreamSpeechAgentConfig(source_segment_size=320)
    ev = BatchedS2STEvaluator(engine, agent_cfg, tdict, tdict, unit_dict,
                              batch=min(batch, len(srcs)), quality_metrics=[])
    ev(srcs, refs)
    out = []
    for i in range(len(srcs)):
        units = list(getattr(ev.instances[i], "final_units", []))
        out.append([int(u) - 4 for u in units if 4 <= int(u)
                    < cfg.unit_decoder.vocab_size - 1])
    return out


def read_dev_refs(data_dir: str) -> List[Tuple[str, List[int], List[str]]]:
    """(utt_id, raw unit codes, text words) for the dev split, from disk."""
    data = Path(data_dir)
    text = {}
    with open(data / "target_unigram" / "dev.tsv") as f:
        f.readline()
        for line in f:
            utt, t = line.rstrip("\n").split("\t")
            text[utt] = [p.lstrip("▁") for p in t.split()]
    refs = []
    with open(data / "dev.tsv") as f:
        header = f.readline().rstrip("\n").split("\t")
        col = {n: i for i, n in enumerate(header)}
        for line in f:
            row = line.rstrip("\n").split("\t")
            utt = row[col["id"]]
            refs.append((utt, [int(u) for u in row[col["tgt_audio"]].split()],
                         text[utt]))
    return refs


def score_outputs(hyp_units: List[List[int]], hyp_text: List[List[str]],
                  refs: List[Tuple[str, List[int], List[str]]]
                  ) -> Dict[str, float]:
    """Unit edit-distance rate + text token accuracy vs the toy references."""

    def edit(a, b):
        m, n = len(a), len(b)
        dp = list(range(n + 1))
        for i in range(1, m + 1):
            prev, dp[0] = dp[0], i
            for j in range(1, n + 1):
                cur = dp[j]
                dp[j] = min(dp[j] + 1, dp[j - 1] + 1,
                            prev + (a[i - 1] != b[j - 1]))
                prev = cur
        return dp[n]

    tot_ed = tot_units = 0
    tot_tok = ok_tok = 0
    for (hu, ht, (_, ru, rt)) in zip(hyp_units, hyp_text, refs):
        tot_ed += edit(hu, ru)
        tot_units += len(ru)
        tot_tok += len(rt)
        ok_tok += sum(1 for a, b in zip(ht, rt) if a == b)
    return {"unit_edit_rate": tot_ed / max(tot_units, 1),
            "text_token_acc": ok_tok / max(tot_tok, 1)}


def run_learnability_golden(workdir: str, max_update: int = 300,
                            n_train: int = 300, n_dev: int = 24,
                            lr: float = 2e-3, seed: int = 0,
                            upsample: int = 8, dropout: float = 0.0,
                            verbose: bool = False,
                            device: str = "cuda") -> Dict[str, Dict]:
    """End-to-end learnability golden: generate the toy task, train the
    StreamSpeech model (scaled-down dims, the real criterion with its
    streaming masks) through the port's ``cli.train``, then evaluate the
    untrained (step-0) and the trained checkpoints STREAMING, as the
    reference golden does:

    - text through the port's ``cli.simuleval --agent s2tt``;
    - units through the streaming S2ST agent via the batched evaluator
      (``eval_units_streaming``, run as its own subprocess).

    Every stage is its own subprocess. device="cuda" (the default; it raises
    without a card) runs every stage on the card and turns the kernel train
    route on (``STREAMSPEECH_PALLAS_TRAIN=1``), the twin of the JAX golden's
    device="tpu"; device="cpu" passes ``--cpu`` to every stage. Returns {"untrained": scores, "trained": scores}
    with unit_edit_rate / text_token_acc (+ the CLI's AL and BLEU).
    """
    import os
    import subprocess
    import sys

    _check_device(device)
    wd = Path(workdir)
    task = generate_toy_dataset(str(wd / "data"), n_train=n_train,
                                n_dev=n_dev, seed=seed)
    repo = Path(__file__).resolve().parents[2]

    def run(mod, *argv):
        dev_flags = ["--cpu"] if device == "cpu" else []
        cmd = [sys.executable, "-m", mod, *dev_flags, *map(str, argv)]
        env = dict(os.environ)
        if device == "cuda":
            env["STREAMSPEECH_PALLAS_TRAIN"] = "1"
        r = subprocess.run(cmd, cwd=str(repo), capture_output=True, text=True,
                           timeout=7200, env=env)
        if verbose:
            sys.stderr.write(r.stderr[-2000:])
        if r.returncode != 0:
            raise RuntimeError(
                f"{mod} failed rc={r.returncode}\n{r.stderr[-4000:]}")
        return r.stdout

    common = ["--data", task["data"], "--config-yaml", task["config_yaml"],
              "--multitask-config-yaml", task["multitask_config_yaml"],
              "--target-code-size", task["n_units"], "--tiny-dims",
              "--ctc-upsample-rate", upsample, "--max-tokens", 1536,
              "--dropout", dropout,
              "--lr", lr, "--warmup-updates", 30, "--seed", seed + 1,
              "--log-interval", 10, "--validate-interval-updates", 10 ** 9,
              "--save-interval-updates", 10 ** 9]
    run("streamspeech_tpu_torch.cli.train", *common, "--max-update", 0,
        "--save-dir", wd / "ck0")
    run("streamspeech_tpu_torch.cli.train", *common, "--max-update", max_update,
        "--save-dir", wd / "ckN")

    refs = read_dev_refs(task["data"])

    def decode(ckpt_dir, tag):
        ckpts = sorted(Path(ckpt_dir).glob("checkpoint_*"),
                       key=lambda p: int(p.name.split("_")[-1]))
        ckpt = str(ckpts[-1])
        # --- text leg: the simuleval CLI, streaming s2tt agent ---
        out_dir = wd / f"eval_{tag}"
        stdout = run("streamspeech_tpu_torch.cli.simuleval",
                     "--agent", "s2tt", "--source", task["dev_wavs"],
                     "--target", task["dev_text"], "--checkpoint", ckpt,
                     "--src-dict", task["text_dict"],
                     "--tgt-dict", task["text_dict"],
                     "--target-code-size", task["n_units"],
                     "--batch", 6, "--output", out_dir)
        scores = {}
        for line in stdout.splitlines():
            parts = line.split("\t")
            if len(parts) == 2:
                try:
                    scores[parts[0]] = float(parts[1])
                except ValueError:
                    pass
        hyp_text: List[List[str]] = [[] for _ in refs]
        with open(Path(out_dir) / "instances.log") as f:
            for line in f:
                d = json.loads(line)
                hyp_text[int(d["index"])] = str(d.get("prediction",
                                                      "")).split()
        # --- unit leg: streaming S2ST agent, own subprocess ---
        stdout_u = run("streamspeech_tpu_torch.data.toy_task", "eval-units",
                       "--checkpoint", ckpt, "--data", task["data"])
        hyp_units = json.loads(stdout_u.splitlines()[-1])
        res = score_outputs(hyp_units, hyp_text, refs)
        for k in ("AL", "BLEU"):
            if k in scores:
                res[k] = scores[k]
        return res

    return {"untrained": decode(wd / "ck0", "ck0"),
            "trained": decode(wd / "ckN", "ckN")}


def _main():
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("command", choices=["eval-units"])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data", required=True)
    ap.add_argument("--batch", type=int, default=6)
    ap.add_argument("--cpu", action="store_true", default=False,
                    help="decode on the CPU (default: the card)")
    args = ap.parse_args()
    if not args.cpu:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("eval-units: no CUDA device is available; pass --cpu")
    units = eval_units_streaming(args.checkpoint, args.data, batch=args.batch,
                                 device="cpu" if args.cpu else "cuda")
    print(json.dumps(units))


if __name__ == "__main__":
    _main()
