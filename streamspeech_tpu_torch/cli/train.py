"""Training CLI, the port of ``streamspeech_tpu/cli/train.py`` (the
fairseq-train equivalent, `fairseq_cli/train.py:44-300`): the same flags, the
same YAML data configs, the same bookkeeping, and native checkpoints
(``train/checkpoint.py``) in the JAX package's directory layout.

Synthetic smoke run:
  python -m streamspeech_tpu_torch.cli.train --synthetic --max-update 20 \\
      --save-dir /tmp/ckpt --log-interval 5 --cpu

Real data, on the card:
  python -m streamspeech_tpu_torch.cli.train --data /path/fbank2unit \\
      --config-yaml config_gcmvn.yaml --multitask-config-yaml config_mtl.yaml \\
      --target-code-size 1000 --max-tokens 22000 --update-freq 2

The model trains on the card; ``--cpu`` trains on the CPU, and without a card
and without ``--cpu`` the CLI raises. ``STREAMSPEECH_PALLAS_TRAIN=1`` (the
JAX package's switch) takes the attention kernel routes
(``make_train_step(..., kernel_attention=True)``). ``--tp > 1`` and ``--fsdp``
raise (ROADMAP §A item 10). The JAX CLI's persistent XLA compile cache has no
counterpart: the port compiles nothing per process but its CUDA kernels,
which ``kernels/build.py`` keeps built under ``build/``.
"""

from __future__ import annotations

import argparse
import os
import random
import time
from pathlib import Path

import numpy as np
import torch

from streamspeech_tpu_torch.config import (
    MultitaskConfig,
    OptimizationConfig,
    S2SDataConfig,
    StreamSpeechConfig,
    tiny_config,
    to_dict,
)
from streamspeech_tpu_torch.data.dataset import SpeechToSpeechDataset
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    restore_state,
    save_checkpoint,
    would_enter_best,
)
from streamspeech_tpu_torch.train.criterion import CriterionWeights, streamspeech_loss
from streamspeech_tpu_torch.train.synthetic import batch_to_tensors, synthetic_batch
from streamspeech_tpu_torch.train.trainer import (
    TrainState,
    make_optimizer,
    make_train_step,
    make_train_step_scan,
)
from streamspeech_tpu_torch.utils.metrics import JsonProgress, metrics
from streamspeech_tpu_torch.weights import random_init_


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--data", type=str, default=None)
    p.add_argument("--config-yaml", type=str, default="config_gcmvn.yaml")
    p.add_argument("--multitask-config-yaml", type=str, default=None)
    p.add_argument("--train-subset", type=str, default="train")
    p.add_argument("--valid-subset", type=str, default="dev")
    p.add_argument("--target-code-size", type=int, default=1000)
    p.add_argument("--max-tokens", type=int, default=22000)
    p.add_argument("--max-sentences", type=int, default=0)
    p.add_argument("--update-freq", type=int, default=2)
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="run K optimizer steps a call over K stacked same-shape "
                        "batches (make_train_step_scan; multichunk chunk sizes are "
                        "drawn per block, a generator per step)")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--warmup-updates", type=int, default=10000)
    p.add_argument("--warmup-init-lr", type=float, default=1e-7)
    p.add_argument("--clip-norm", type=float, default=1.0)
    p.add_argument("--max-update", type=int, default=100000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--save-dir", type=str, default="checkpoints")
    p.add_argument("--save-interval-updates", type=int, default=1000)
    p.add_argument("--keep-last", type=int, default=10)
    p.add_argument("--keep-best-checkpoints", type=int, default=0,
                   help="also keep the N best checkpoints by validation loss "
                        "as checkpoint.best_<metric>_<step> (fairseq "
                        "checkpoint_utils.py:83-104; the reference recipe "
                        "trains with --keep-best-checkpoints 10)")
    p.add_argument("--maximize-best-checkpoint-metric", action="store_true",
                   default=False)
    p.add_argument("--log-interval", type=int, default=100)
    p.add_argument("--validate-interval-updates", type=int, default=1000)
    p.add_argument("--max-valid-batches", type=int, default=50,
                   help="cap on scored validation batches (0 = score all)")
    p.add_argument("--tensorboard-logdir", type=str, default=None,
                   help="mirror train/valid stats as tensorboard scalars")
    # streaming-mask training (train.simul-s2st.sh)
    p.add_argument("--k1", type=int, default=0)
    p.add_argument("--n1", type=int, default=1)
    p.add_argument("--k2", type=int, default=0)
    p.add_argument("--n2", type=int, default=-1)
    p.add_argument("--chunk-size", type=int, default=8)
    p.add_argument("--multichunk", action="store_true", default=False)
    p.add_argument("--ctc-upsample-rate", type=int, default=25)
    p.add_argument("--n-frames-per-step", type=int, default=1,
                   help="stacked units: the decoder emits N raw-vocab unit "
                        "frames per position; the dataset additionally packs "
                        "prev_output_tokens_unit for AR consumers (fairseq "
                        "--n-frames-per-step, speech_to_speech_dataset.py:88;"
                        " the StreamSpeech recipe uses 1)")
    p.add_argument("--encoder-layers", type=int, default=12)
    p.add_argument("--dropout", type=float, default=None,
                   help="override model dropout everywhere (fairseq "
                        "--dropout; default: the architecture's 0.1)")
    p.add_argument("--remat", action="store_true", default=False,
                   help="recompute the conformer and unit-decoder layers in the "
                        "backward pass instead of storing their activations "
                        "(same numbers, less memory)")
    # parallelism
    p.add_argument("--tp", type=int, default=1, help="model-parallel size")
    p.add_argument("--fsdp", action="store_true", default=False)
    # smoke testing
    p.add_argument("--synthetic", action="store_true", default=False,
                   help="train on synthetic data with a tiny model")
    p.add_argument("--tiny-dims", action="store_true", default=False,
                   help="real data path with scaled-down model dims "
                        "(learnability goldens; vocab sizes still come from the "
                        "task dictionaries)")
    p.add_argument("--cpu", action="store_true", default=False,
                   help="train on the CPU (default: the card)")
    return p


def build_model_config(args, dicts) -> StreamSpeechConfig:
    if args.synthetic:
        return tiny_config()
    if args.tiny_dims:
        cfg = tiny_config()
        cfg.encoder.layers = min(args.encoder_layers, cfg.encoder.layers + 2)
    else:
        cfg = StreamSpeechConfig.simul_s2st()
        cfg.encoder.layers = args.encoder_layers
    if args.dropout is not None:
        cfg.encoder.dropout = args.dropout
        cfg.mt_decoder.dropout = args.dropout
        cfg.unit_decoder.dropout = args.dropout
    if args.remat:
        cfg.encoder.remat = True
        cfg.unit_decoder.remat = True
    cfg.unit_decoder.ctc_upsample_rate = args.ctc_upsample_rate
    cfg.unit_decoder.n_frames_per_step = args.n_frames_per_step
    cfg.unit_decoder.vocab_size = len(dicts["units"])
    cfg.mt_decoder.vocab_size = len(dicts["target_unigram"])
    cfg.source_unigram_vocab = len(dicts["source_unigram"])
    cfg.ctc_target_unigram_vocab = len(dicts["ctc_target_unigram"])
    return cfg


def load_task(args):
    """Dictionaries + datasets from the data dir (reference task setup,
    `fairseq/fairseq/tasks/speech_to_speech.py:212-290`)."""
    data = Path(args.data)
    unit_dict = Dictionary.units(args.target_code_size)
    unit_dict.add_blank()
    dicts = {"units": unit_dict}
    mt_cfg = MultitaskConfig.load(str(data / args.multitask_config_yaml)) \
        if args.multitask_config_yaml else MultitaskConfig()
    data_cfg = S2SDataConfig.load(str(data / args.config_yaml))
    for name, task in mt_cfg.tasks.items():
        dicts[name] = Dictionary.load(task.dict_path)

    def make_split(split):
        manifest = data / f"{split}.tsv"
        if not manifest.exists():
            return None
        targets = {}
        for name, task in mt_cfg.tasks.items():
            t_path = Path(task.data) / f"{split}.tsv"
            if not t_path.exists():
                t_path = data / name / f"{split}.tsv"
            if t_path.exists():
                targets[name] = SpeechToSpeechDataset.load_multitask_targets(
                    str(t_path), dicts[name])
        return SpeechToSpeechDataset(str(manifest), unit_dict, data_cfg,
                                     targets, split=split,
                                     n_frames_per_step=args.n_frames_per_step)

    return dicts, make_split(args.train_subset), make_split(args.valid_subset)


def _device(args) -> torch.device:
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("train: no CUDA device is available; pass --cpu to train "
                           "on the CPU")
    return torch.device("cuda")


def _fetch(m) -> dict:
    """Every metric of a step (0-dim) or a block ([K]) in one host read."""
    keys = list(m)
    flat = torch.stack([m[k].to(torch.float32) for k in keys]).cpu().numpy()
    return dict(zip(keys, flat))


def main(argv=None):
    args = add_args(argparse.ArgumentParser()).parse_args(argv)
    if args.tp > 1 or args.fsdp:
        raise NotImplementedError("--tp > 1 and --fsdp: model and parameter sharding "
                                  "are not ported yet (ROADMAP §A item 10)")
    device = _device(args)
    rng = random.Random(args.seed)
    np.random.seed(args.seed)
    # a second run in one process (a resume) starts from empty meters, as a
    # new process does
    metrics.reset_scope("default")

    if args.synthetic:
        dicts = None
        model_cfg = tiny_config()
        train_ds = valid_ds = None
    else:
        dicts, train_ds, valid_ds = load_task(args)
        model_cfg = build_model_config(args, dicts)

    model = random_init_(StreamSpeechModel(model_cfg), args.seed).to(device)
    n_params = sum(p.numel() for p in model.parameters())

    opt = OptimizationConfig(
        lr=args.lr, warmup_updates=args.warmup_updates,
        warmup_init_lr=args.warmup_init_lr, clip_norm=args.clip_norm,
        update_freq=args.update_freq, max_tokens=args.max_tokens,
        max_update=args.max_update)
    tx = make_optimizer(opt)
    weights = CriterionWeights()
    specaugment_cfg = None
    if not args.synthetic and args.multitask_config_yaml:
        mt_cfg = MultitaskConfig.load(
            str(Path(args.data) / args.multitask_config_yaml))
        kw = {}
        for name, t in mt_cfg.tasks.items():
            if name in ("target_unigram", "source_unigram",
                        "ctc_target_unigram"):
                kw[name] = t.loss_weight
        if kw:
            weights = CriterionWeights(**kw)
        data_cfg = S2SDataConfig.load(str(Path(args.data) / args.config_yaml))
        if "specaugment" in data_cfg.get_transforms(args.train_subset):
            specaugment_cfg = data_cfg.specaugment
    unit_blank = model_cfg.unit_decoder.vocab_size - 1
    kernel_attention = bool(os.environ.get("STREAMSPEECH_PALLAS_TRAIN"))
    step_kw = dict(unit_blank=unit_blank, weights=weights,
                   specaugment_cfg=specaugment_cfg, kernel_attention=kernel_attention)
    step_fn = make_train_step(model, tx, **step_kw)
    step_fn_k = (make_train_step_scan(model, tx, **step_kw)
                 if args.steps_per_call > 1 else None)

    syn_batch = 4
    state = TrainState.create(model, tx)
    if args.save_dir:
        Path(args.save_dir).mkdir(parents=True, exist_ok=True)
    progress = JsonProgress(log_file=str(Path(args.save_dir) / "train.log")
                            if args.save_dir else None,
                            tensorboard_logdir=args.tensorboard_logdir)
    progress.log({"event": "init", "params": n_params, "devices": 1,
                  "device": str(device), "kernel_attention": kernel_attention},
                  tag="setup", step=0)

    # resume
    ckpt = latest_checkpoint(args.save_dir)
    if ckpt:
        restore_state(state, load_checkpoint(ckpt))
        progress.log({"event": "resumed", "from": ckpt}, tag="setup")

    def eval_loss(batch):
        with torch.no_grad():
            out = model(batch["src_tokens"], batch["src_lengths"],
                        batch["prev_output_tokens_mt"], chunk_size=8,
                        conv_chunk_size=8, n2=batch["n2"])
            m = streamspeech_loss(out, batch, unit_blank, weights)
            return m["loss"] / m["sample_size"].to(torch.float32)

    def validate(state):
        if args.synthetic:
            batches = [synthetic_batch(model_cfg, batch=syn_batch, frames=64, seed=999)]
        elif valid_ds is not None:
            all_idx = valid_ds.batches(args.max_tokens, args.max_sentences)
            cap = args.max_valid_batches
            if cap and len(all_idx) > cap:
                progress.log({"event": "valid_truncated", "scored": cap,
                              "total": len(all_idx)}, tag="setup")
                all_idx = all_idx[:cap]
            batches = [{k: v for k, v in valid_ds.collate(idx).items() if k != "id"}
                       for idx in all_idx]
        else:
            return None
        losses = torch.stack([eval_loss(batch_to_tensors(dict(b, n2=np.int32(1)),
                                                         device=device))
                              for b in batches]).cpu().numpy() if batches else []
        return float(np.mean(losses)) if len(losses) else None

    def batch_iterator(epoch):
        if args.synthetic:
            for i in range(10000):
                yield synthetic_batch(model_cfg, batch=syn_batch, frames=64,
                                      seed=epoch * 10000 + i)
        else:
            for idx in train_ds.batches(args.max_tokens, args.max_sentences,
                                        shuffle_seed=args.seed + epoch):
                b = train_ds.collate(idx)
                b.pop("id", None)
                yield b

    num_updates = int(state.step)
    epoch = 0
    t_last = time.perf_counter()

    def draw_chunks():
        # multichunk randomization (`speech_to_speech_ctc_asr_st_criterion.py:149-168`)
        if args.multichunk:
            chunk = rng.choice([8, 16, 24, 32, 99999])
            conv_chunk = rng.choice([8, 16])
            chunk = min(chunk, conv_chunk) if chunk < 999 else chunk
        else:
            chunk, conv_chunk = args.chunk_size, min(args.chunk_size, 16)
        return int(chunk), int(conv_chunk)

    def prep(batch):
        n2 = args.n2 if args.n2 >= 0 else rng.randint(
            1, 1 + int(batch["prev_output_tokens_mt"].shape[1]))
        return dict(batch, n2=np.int32(n2))

    def account(m):
        """Per-update bookkeeping over an already-fetched host metric dict."""
        nonlocal num_updates, t_last
        num_updates += 1
        sample_size = float(m["sample_size"])
        metrics.log_scalar("loss", float(m["loss_mean"]))
        metrics.log_scalar("unit_ctc", float(m["unit_ctc_loss"]) / sample_size)
        metrics.log_scalar("grad_norm", float(m["grad_norm"]))
        metrics.log_scalar("overflow", float(m["overflow"]))
        if num_updates % args.log_interval == 0:
            stats = metrics.get_smoothed_values("default")
            dt = time.perf_counter() - t_last
            stats["ups"] = args.log_interval / dt if dt > 0 else 0.0
            t_last = time.perf_counter()
            progress.log(stats, tag="train", step=num_updates)
            metrics.reset_scope("default")
        if num_updates % args.validate_interval_updates == 0:
            val = validate(state)
            if val is not None:
                progress.log({"valid_loss": val}, tag="valid", step=num_updates)
                if args.save_dir and args.keep_best_checkpoints > 0 and (
                        num_updates % args.save_interval_updates == 0
                        or would_enter_best(
                            args.save_dir, val, args.keep_best_checkpoints,
                            args.maximize_best_checkpoint_metric)):
                    # the metric-bearing save at the validation point; a
                    # metric that cannot enter the best set at a validation
                    # that is not a save interval is not written at all
                    save_checkpoint(
                        args.save_dir, num_updates, state,
                        config=to_dict(model_cfg), keep_last=args.keep_last,
                        keep_best=args.keep_best_checkpoints, val_metric=val,
                        maximize=args.maximize_best_checkpoint_metric)
                    return
        if args.save_dir and num_updates % args.save_interval_updates == 0:
            save_checkpoint(args.save_dir, num_updates, state,
                            config=to_dict(model_cfg), keep_last=args.keep_last)

    def generator(seed):
        return torch.Generator(device=device).manual_seed(seed)

    def run_single(b):
        nonlocal state
        chunk, conv_chunk = draw_chunks()
        state, m = step_fn(state, batch_to_tensors(b, device=device),
                           generator(args.seed * 100003 + num_updates), chunk, conv_chunk)
        account(_fetch(m))

    def run_block(group):
        nonlocal state
        stacked = batch_to_tensors({k: np.stack([g[k] for g in group])
                                    for k in group[0] if k != "n2"}, device=device)
        stacked["n2"] = [int(g["n2"]) for g in group]
        chunk, conv_chunk = draw_chunks()
        state, ms = step_fn_k(state, stacked, args.seed * 100003 + num_updates,
                              chunk, conv_chunk)
        ms = _fetch(ms)  # one host read for the whole block's metrics
        for i in range(len(group)):
            account({k: v[i] for k, v in ms.items()})

    # steps-per-call > 1: group K consecutive same-shape batches and run each
    # group as one block; stragglers (end of epoch, max_update boundary, odd
    # bucket shapes) run as single steps
    pending = {}

    def flush_pending():
        for group in pending.values():
            for b in group:
                if num_updates < args.max_update:
                    run_single(b)
        pending.clear()

    while num_updates < args.max_update:
        epoch += 1
        for batch in batch_iterator(epoch):
            if num_updates >= args.max_update:
                break
            if step_fn_k is None:
                run_single(prep(batch))
                continue
            b = prep(batch)
            sig = tuple(sorted(
                (k, getattr(v, "shape", ())) for k, v in b.items()))
            pending.setdefault(sig, []).append(b)
            if len(pending[sig]) == args.steps_per_call:
                group = pending.pop(sig)
                if num_updates + len(group) <= args.max_update:
                    run_block(group)
                else:
                    for bb in group:
                        if num_updates < args.max_update:
                            run_single(bb)
        flush_pending()
    if args.save_dir:
        save_checkpoint(args.save_dir, num_updates, state,
                        config=to_dict(model_cfg), keep_last=args.keep_last)
    progress.log({"event": "done"}, tag="train", step=num_updates)
    return state


if __name__ == "__main__":
    main()
