"""Streaming evaluation CLI, the port of ``streamspeech_tpu/cli/simuleval.py``
(the `simuleval` equivalent, `SimulEval/simuleval/cli.py:34-98`): a wav list
and a target file → an agent → quality and latency scores, ``instances.log``,
``scores.tsv`` and the emitted wavs under ``--output``.

    python -m streamspeech_tpu_torch.cli.simuleval \\
        --source wav_list.txt --target target.txt \\
        --fairseq-checkpoint streamspeech.simultaneous.fr-en.pt --agent s2st \\
        --source-segment-size 320 --output res/ \\
        --vocoder g_00500000 --vocoder-cfg config.json \\
        --src-dict spm_unigram_fr.txt --tgt-dict spm_unigram_en.txt

Agents ``s2st`` (the fused tick where the engine has a vocoder), ``s2tt`` and
``asr``; ``--batch N`` evaluates N instances at a time through the batched
evaluators. The model runs on the card; ``--cpu`` runs it on the CPU, and
without a card and without ``--cpu`` the CLI raises. ``--checkpoint`` takes a
native checkpoint of the port's ``cli.train``.

The text-to-text agents ``t2t-waitk`` (``TextMTModel``), ``t2t-hmt`` and
``t2t-hmt-beam`` (``HMTModel``) read ``--source`` and ``--target`` as text,
one sentence a line, one source token a read:

    python -m streamspeech_tpu_torch.cli.simuleval --source src.txt \\
        --target tgt.txt --agent t2t-hmt --checkpoint ck/checkpoint_100 --output res/

Their dictionaries come from ``--src-dict`` / ``--tgt-dict`` or are built from
the text; ``--checkpoint`` is a native checkpoint of the text model with the
``config.json`` beside it. Without a checkpoint the weights are
``weights.random_init_`` at seed 0, which JAX's ``PRNGKey(0)`` init does not
reproduce: those outputs differ from the JAX CLI's.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from streamspeech_tpu_torch.agents.base import ReadAction, SpeechToTextAgent
from streamspeech_tpu_torch.agents.streamspeech import (
    StreamSpeechAgentConfig,
    StreamSpeechASRAgent,
    StreamSpeechS2STAgent,
    StreamSpeechS2TTAgent,
)
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.eval.evaluator import SentenceLevelEvaluator
from streamspeech_tpu_torch.ops.cmvn import GlobalCMVN
from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--source", type=str, required=True, help="newline-separated wav paths")
    p.add_argument("--target", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="a native checkpoint directory of cli.train (t2t-*: of the text "
                        "model, config.json beside it; without one the t2t-* weights are "
                        "weights.random_init_ at seed 0, which JAX's PRNGKey(0) init does "
                        "not reproduce, so those outputs differ from the JAX CLI's)")
    p.add_argument("--fairseq-checkpoint", type=str, default=None)
    p.add_argument("--agent", choices=["s2st", "s2tt", "asr", "t2t-waitk", "t2t-hmt",
                                       "t2t-hmt-beam"], default="s2st")
    p.add_argument("--waitk", type=int, default=3, help="k for the t2t-waitk agent")
    p.add_argument("--source-segment-size", type=int, default=320)
    p.add_argument("--src-dict", type=str, default=None)
    p.add_argument("--tgt-dict", type=str, default=None)
    p.add_argument("--target-code-size", type=int, default=1000)
    p.add_argument("--gcmvn", type=str, default=None)
    p.add_argument("--vocoder", type=str, default=None)
    p.add_argument("--vocoder-cfg", type=str, default=None)
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--lagging-k1", type=int, default=0)
    p.add_argument("--stride-n", type=int, default=1)
    p.add_argument("--continue-unfinished", action="store_true", default=False)
    p.add_argument("--batch", type=int, default=1,
                   help="evaluate N instances at a time through one lockstep batched "
                        "session (the instances' results are those of --batch 1)")
    p.add_argument("--score-only", action="store_true", default=False,
                   help="re-score a previous run from output/instances.log")
    p.add_argument("--latency-metrics", nargs="*", default=None)
    p.add_argument("--quality-metrics", nargs="*", default=None)
    p.add_argument("--standalone", action="store_true", default=False,
                   help="serve the agent over HTTP (PUT /input, GET /output, "
                        "POST /reset) instead of evaluating")
    p.add_argument("--remote-eval", action="store_true", default=False,
                   help="evaluate a REMOTE agent (no local model); pair with "
                        "--remote-address of a --standalone server")
    p.add_argument("--remote-address", type=str, default="http://127.0.0.1:7861")
    p.add_argument("--remote-port", type=int, default=7861)
    p.add_argument("--slurm", action="store_true", default=False,
                   help="submit this evaluation as a slurm job instead of running it "
                        "(writes output/script.sh, runs sbatch)")
    p.add_argument("--slurm-partition", type=str, default="learnaccel",
                   help="slurm partition (`simuleval/options.py` default)")
    p.add_argument("--slurm-time", type=str, default="2:00:00")
    p.add_argument("--slurm-job-name", type=str, default="simuleval")
    p.add_argument("--cpu", action="store_true", default=False,
                   help="run the model on the CPU (default: the card)")
    return p


def _print_scores(scores) -> None:
    for k, v in scores.items():
        print(f"{k}\t{v:.3f}" if v == v else f"{k}\tnan")


def _device(args) -> str:
    if args.cpu:
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("simuleval: no CUDA device is available; pass --cpu to run "
                           "the model on the CPU")
    return "cuda"


def load_corpus(args):
    """The sources (waveforms as float lists; a YouTube URL is resolved to a
    cached wav under ``--output``) and the reference lines."""
    from streamspeech_tpu_torch.data.dataset import load_audio_or_features
    from streamspeech_tpu_torch.data.youtube import is_youtube_url, resolve_youtube_source

    src_root = Path(args.source).parent
    sources = []
    for line in Path(args.source).read_text().splitlines():
        ref = line.strip()
        if not ref:
            continue
        if is_youtube_url(ref):
            # the youtube-to-{text,speech} dataloaders (`s2t_dataloader.py:114`)
            ref = resolve_youtube_source(ref, cache_dir=args.output or ".")
        sources.append(list(np.asarray(load_audio_or_features(ref, src_root), np.float32)))
    return sources, list(Path(args.target).read_text().splitlines())


def _score_only(args):
    class _Null(SpeechToTextAgent):
        def policy(self):
            return ReadAction()

    ev = SentenceLevelEvaluator(_Null(), output_dir=args.output,
                                latency_metrics=args.latency_metrics,
                                quality_metrics=args.quality_metrics or [])
    return ev.score_only()


def build_engine(args) -> StreamSpeechEngine:
    """The model of ``--checkpoint`` or ``--fairseq-checkpoint`` and the
    ``--vocoder`` behind an engine on the card (``--cpu``: the CPU)."""
    from streamspeech_tpu_torch.cli.generate import load_model

    device = _device(args)
    model, _ = load_model(args)
    if isinstance(model, list):
        raise ValueError("the streaming engine serves one model: decode an ensemble "
                         "(comma-separated --checkpoint paths) offline with cli.generate")
    vocoder = None
    if args.vocoder:
        from streamspeech_tpu_torch.models.vocoder import CodeGenerator
        from streamspeech_tpu_torch.train.checkpoint import import_hifigan_vocoder
        from streamspeech_tpu_torch.weights import load_flax_vocoder

        if not args.vocoder_cfg:
            raise SystemExit("--vocoder needs --vocoder-cfg")
        voc_vars, voc_cfg = import_hifigan_vocoder(args.vocoder, args.vocoder_cfg)
        vocoder = load_flax_vocoder(CodeGenerator(voc_cfg), voc_vars)
    return StreamSpeechEngine(model, vocoder, device=device)


def main(argv=None):
    """Run the CLI; returns the scores it printed (None for ``--slurm`` and
    ``--standalone``)."""
    args = build_parser().parse_args(argv)
    if args.slurm:
        submit_slurm_job(args, argv)
        return None
    if args.score_only:
        scores = _score_only(args)
        _print_scores(scores)
        return scores
    if args.agent.startswith("t2t-"):
        scores = _run_t2t(args)
        _print_scores(scores)
        return scores
    if args.remote_eval:
        # an agent served elsewhere (--standalone): no local model
        from streamspeech_tpu_torch.eval.service import RemoteAgent

        agent = RemoteAgent(args.remote_address,
                            target_type="speech" if args.agent == "s2st" else "text")
        sources, references = load_corpus(args)
        ev = SentenceLevelEvaluator(
            agent, source_segment_size=args.source_segment_size,
            latency_metrics=args.latency_metrics, quality_metrics=args.quality_metrics,
            output_dir=args.output)
        scores = ev(sources, references, continue_unfinished=args.continue_unfinished)
        _print_scores(scores)
        return scores

    engine = build_engine(args)
    src_dict = Dictionary.load(args.src_dict) if args.src_dict else Dictionary()
    tgt_dict = Dictionary.load(args.tgt_dict) if args.tgt_dict else src_dict
    unit_dict = Dictionary.units(args.target_code_size)
    unit_dict.add_blank()
    gcmvn = GlobalCMVN.from_npz(args.gcmvn) if args.gcmvn else None
    agent_cfg = StreamSpeechAgentConfig(
        source_segment_size=args.source_segment_size, lagging_k1=args.lagging_k1,
        stride_n=args.stride_n, whole_word=args.source_segment_size >= 640)
    if args.agent == "s2st":
        agent = StreamSpeechS2STAgent(engine, agent_cfg, src_dict, tgt_dict, unit_dict,
                                      gcmvn, use_fused=True)
    elif args.agent == "s2tt":
        agent = StreamSpeechS2TTAgent(engine, agent_cfg, src_dict, tgt_dict, gcmvn)
    else:
        agent = StreamSpeechASRAgent(engine, agent_cfg, src_dict, gcmvn)

    if args.standalone:
        # agent-as-a-service (simuleval --standalone) for a --remote-eval
        # client; serves until the process is stopped
        from streamspeech_tpu_torch.eval.service import AgentService

        print(f"serving {args.agent} agent on port {args.remote_port}", flush=True)
        AgentService(agent, port=args.remote_port).start(background=False)
        return None

    sources, references = load_corpus(args)
    if args.batch > 1:
        from streamspeech_tpu_torch.eval.batched_evaluator import (
            BatchedASREvaluator,
            BatchedS2STEvaluator,
            BatchedS2TTEvaluator,
        )

        kw = dict(batch=args.batch, latency_metrics=args.latency_metrics,
                  quality_metrics=args.quality_metrics, output_dir=args.output)
        if args.agent == "s2st":
            ev = BatchedS2STEvaluator(engine, agent_cfg, src_dict, tgt_dict, unit_dict,
                                      gcmvn, **kw)
        elif args.agent == "s2tt":
            ev = BatchedS2TTEvaluator(engine, agent_cfg, src_dict, tgt_dict, gcmvn, **kw)
        else:
            ev = BatchedASREvaluator(engine, agent_cfg, src_dict, src_dict, gcmvn, **kw)
    else:
        ev = SentenceLevelEvaluator(
            agent, source_segment_size=args.source_segment_size,
            latency_metrics=args.latency_metrics, quality_metrics=args.quality_metrics,
            output_dir=args.output)
    scores = ev(sources, references, continue_unfinished=args.continue_unfinished)
    _print_scores(scores)
    return scores


def _text_dict(path: Optional[str], lines) -> Dictionary:
    """``path``'s dictionary, or one built from the words of ``lines``."""
    if path:
        return Dictionary.load(path)
    d = Dictionary()
    for line in lines:
        for w in line.split():
            d.add_symbol(w)
    return d


def _run_t2t(args):
    """Text-to-text simultaneous evaluation (`cli/simuleval.py:295-378`; the
    reference's t2t dataloader + TextToTextInstance path, `SimulEval/
    simuleval/data/dataloader/t2t_dataloader.py` + `evaluator/instance.py:426`):
    source and target are text files, one token is sent per read, AL/AP are
    measured in tokens. Returns the scores."""
    import json

    from streamspeech_tpu_torch.config import DecoderConfig
    from streamspeech_tpu_torch.weights import load_flax_variables, random_init_

    device = _device(args)
    sources = [line for line in Path(args.source).read_text().splitlines() if line.strip()]
    references = list(Path(args.target).read_text().splitlines())
    src_dict = _text_dict(args.src_dict, sources)
    tgt_dict = _text_dict(args.tgt_dict, references)

    restored = cfg_raw = None
    if args.checkpoint:
        from streamspeech_tpu_torch.train.checkpoint import load_checkpoint

        restored = load_checkpoint(args.checkpoint)
        cfg_path = Path(args.checkpoint).parent / "config.json"
        cfg_raw = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
    cfg_raw = cfg_raw or {}
    dec = DecoderConfig(vocab_size=len(tgt_dict))
    for k, v in cfg_raw.get("decoder", {}).items():
        if hasattr(dec, k):
            setattr(dec, k, v)
    enc_layers = cfg_raw.get("encoder_layers", 6)

    if args.agent in ("t2t-hmt", "t2t-hmt-beam"):
        from streamspeech_tpu_torch.models.hmt import HMTAgent, HMTModel, HMTSimBeamAgent

        model = HMTModel(len(src_dict), dec, encoder_layers=enc_layers,
                         first_read=cfg_raw.get("first_read", 3),
                         cands_per_token=cfg_raw.get("cands_per_token", 4))
    else:
        from streamspeech_tpu_torch.models.text_mt import TextMTModel, WaitkTextAgent

        model = TextMTModel(len(src_dict), dec, encoder_layers=enc_layers)
    if restored is not None:
        load_flax_variables(model, {"params": restored["params"]})
    else:
        random_init_(model, 0)
    if args.agent == "t2t-hmt-beam":
        agent = HMTSimBeamAgent(model, src_dict, tgt_dict, beam_size=5, device=device)
    elif args.agent == "t2t-hmt":
        agent = HMTAgent(model, src_dict, tgt_dict, device=device)
    else:
        agent = WaitkTextAgent(model, src_dict, tgt_dict, waitk=args.waitk, device=device)

    ev = SentenceLevelEvaluator(
        agent, source_segment_size=args.source_segment_size,
        latency_metrics=args.latency_metrics, quality_metrics=args.quality_metrics,
        output_dir=args.output)
    return ev(sources, references, continue_unfinished=args.continue_unfinished)


def submit_slurm_job(args, argv=None) -> str:
    """Write and submit an sbatch script that re-invokes this CLI without
    ``--slurm`` (`SimulEval/simuleval/utils/slurm.py:31-121`: the slurm flags
    stripped, ``--output`` pinned to the absolute results directory, the
    script at ``output/script.sh``, then ``sbatch``). Returns the script's
    path; a missing ``sbatch`` is reported, not raised, so the script can be
    written on one machine and submitted on another."""
    out = os.path.abspath(args.output or "simuleval_results")
    os.makedirs(out, exist_ok=True)
    cli = argv if argv is not None else sys.argv[1:]
    kept, skip = [], False
    for tok in cli:
        if skip:
            skip = False
            continue
        if tok == "--slurm":
            continue
        if tok.startswith("--slurm-"):
            skip = "=" not in tok
            continue
        kept.append(tok if tok.startswith("--") or str(tok).isdigit() else f'"{tok}"')
    command = f"{sys.executable} -m streamspeech_tpu_torch.cli.simuleval " + " ".join(kept)
    if "--output" in command:
        command = re.sub(r"--output\s+\S+", f'--output "{out}"', command)
    else:
        command += f' --output "{out}"'
    command = command.replace(" --", " \\\n\t--")
    script = f"""#!/bin/bash
#SBATCH --time={args.slurm_time}
#SBATCH --partition={args.slurm_partition}
#SBATCH --nodes=1
#SBATCH --ntasks-per-node=1
#SBATCH --output="{out}/slurm-%j.log"
#SBATCH --job-name="{args.slurm_job_name}"

cd {out}

{command}
"""
    script_file = os.path.join(out, "script.sh")
    with open(script_file, "w") as f:
        f.write(script)
    try:
        proc = subprocess.run(["sbatch", script_file], capture_output=True)
        print(f"sbatch stdout: {proc.stdout.decode().strip()}")
        if proc.stderr:
            print(f"sbatch stderr: {proc.stderr.decode().strip()}")
    except FileNotFoundError:
        print(f"sbatch not found; job script written to {script_file}")
    return script_file


if __name__ == "__main__":
    main()
