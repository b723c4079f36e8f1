"""Where the time of the port's serving loop goes, on one CUDA card.

    python3 tools/profile_torch_serving.py [--out chiprun_out/profile_serving.txt]
                                           [--dtype float32|bfloat16] [--batched]
                                           [--paths host fused fused host]

Builds the ``chip_smoke.py`` serving setup (``full_config``, seeded random
weights doctored so the policy writes, full-width vocoder), runs a 3 s warm-up
utterance, then one 10 s utterance twice:

1. with the host clock around each ``push_features``, ``mt_decode`` and
   ``emit_tail`` call of the session, each fenced by device syncs;
2. under ``torch.profiler`` (CPU + CUDA activities): device time, the
   ``cudaLaunchKernel`` count and the masked-attention kernel's share.

``--batched`` does the same for ``chip_smoke.py``'s batched wave (its eight
utterances through ``BatchedS2STEvaluator(batch=8)``, after a warm-up wave):
the host clock around the lockstep session's ``encode_ready_blocks``,
``mt_decode`` and ``emit_tail``, the rest being the evaluator's own host work
(fbank, policy), then the profiled wave.

``--paths`` runs the serving path named by each entry in turn in one process
(``host``: the host policy and tick; ``fused``: the fused tick, its CUDA
graphs captured once by ``engine.warmup`` first, whose seconds and graph
numbers are printed), so that the two compare on one card: ``host fused
fused host``. The fused path's split adds its fused ticks (``fused_policy``,
``fused_tick``).

Prints one JSON line per run and the card's ``nvidia-smi`` name and power
limit; the profiler's tables go to ``--out`` (one file a run). TF32 off;
``--dtype bfloat16`` serves the model at that compute dtype (the vocoder
stays fp32), its causal attention the bf16 form. ``launches`` counts the
CUDA API's launches by call (``cudaLaunchKernel``, ``cudaGraphLaunch``, ...;
a graph replay is one).
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from streamspeech_tpu_torch.config import full_config  # noqa: E402
from streamspeech_tpu_torch.kernels.attention import masked_attention  # noqa: E402
from streamspeech_tpu_torch.models.vocoder import DEFAULT_VOCODER_CFG  # noqa: E402

PARTS = ("push_features", "mt_decode", "emit_tail", "fused_policy")
BATCHED_PARTS = ("encode_ready_blocks", "mt_decode", "emit_tail", "fused_tick")


def _timed(name, fn, split):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        split[name] = split.get(name, 0.0) + time.perf_counter() - t0
        split[name + "_calls"] = split.get(name + "_calls", 0) + 1
        return out
    return run


def _timed_sessions(engine, split):
    """Wrap the engine's ``new_session`` so every session times ``PARTS``."""
    new_session = engine.new_session

    def make():
        session = new_session()
        for name in PARTS:
            setattr(session, name, _timed(name, getattr(session, name), split))
        return session

    engine.new_session = make
    return new_session


def _device_ms(events) -> float:
    """Device time of the kernels alone: an op's row repeats its kernels' time."""
    from torch.autograd import DeviceType

    return sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3


def _launches(events) -> dict:
    """The CUDA API's launches by call, a graph replay one."""
    return {e.key: e.count for e in events
            if e.key.startswith("cu") and "Launch" in e.key}


def _write_tables(events, path):
    out = Path(path)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(
        events.table(sort_by="self_device_time_total", row_limit=30,
                     max_name_column_width=70) + "\n"
        + events.table(sort_by="self_cpu_time_total", row_limit=20,
                       max_name_column_width=70))


def profile_batched(agent, out, use_fused, tag):
    """The batched wave of ``chip_smoke.py`` with the lockstep session's parts
    timed, then profiled."""
    from torch.profiler import ProfilerActivity, profile

    from streamspeech_tpu_torch.eval import batched_evaluator

    rng = np.random.RandomState(cs.SEED)
    sources = [cs._babble(rng, seconds).tolist() for seconds in cs.BATCHED_SECONDS]
    session_cls = batched_evaluator.BatchedStreamingSession
    split = {}

    class TimedSession(session_cls):
        pass

    for name in BATCHED_PARTS:
        setattr(TimedSession, name, _timed(name, getattr(session_cls, name), split))

    def wave():
        ev = batched_evaluator.BatchedS2STEvaluator(
            agent.engine, agent.cfg, agent.src_dict, agent.tgt_dict, agent.unit_dict,
            batch=len(sources), use_fused=use_fused, quality_metrics=[])
        t0 = time.perf_counter()
        ev(sources, [None] * len(sources))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wave()                                                   # warm-up
    batched_evaluator.BatchedStreamingSession = TimedSession
    try:
        masked_attention.launches_by_batch = {}
        wall = wave()
    finally:
        batched_evaluator.BatchedStreamingSession = session_cls
    parts = sum(split.get(n, 0.0) for n in BATCHED_PARTS)
    audio = sum(cs.BATCHED_SECONDS)
    print(json.dumps({"run": "batched_split", "path": tag, "streams": len(sources),
                      "seconds_audio": audio, "wall_s": wall,
                      "audio_s_per_wall_s": audio / wall, "split_s": split,
                      "rest_s": wall - parts,
                      "masked_attention_launches_by_batch":
                          masked_attention.launches_by_batch}), flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_wall = wave()
    events = prof.key_averages()
    device_ms = _device_ms(events)
    launches = _launches(events)
    print(json.dumps({"run": "batched_profiled", "path": tag, "wall_s": profiled_wall,
                      "device_self_ms": device_ms,
                      "device_busy_share": device_ms / 1e3 / profiled_wall,
                      "device_busy_share_of_unprofiled_wall": device_ms / 1e3 / wall,
                      "launches": launches, "launches_total": sum(launches.values()),
                      "masked_attention_device_ms": sum(
                          e.self_device_time_total for e in events
                          if "causal_attention_kernel" in e.key) / 1e3}), flush=True)
    _write_tables(events, out)


def profile_single(agent, samples, out, counter, kernel, tag):
    """The 10 s utterance with the session's parts timed, then profiled."""
    from torch.profiler import ProfilerActivity, profile

    split = {}
    new_session = _timed_sessions(agent.engine, split)
    setattr(masked_attention, counter, 0)
    try:
        stats, *_ = cs._run_utterance(agent, samples)
    finally:
        agent.engine.new_session = new_session
    unprofiled_wall = stats["wall_s"]
    parts = sum(split.get(n, 0.0) for n in PARTS)
    print(json.dumps({"run": "split", "path": tag, "dtype": str(agent.engine.model.dtype),
                      "utterance": stats, "split_s": split,
                      "rest_s": stats["wall_s"] - parts,
                      "masked_attention_launches": getattr(masked_attention, counter)}),
          flush=True)
    setattr(masked_attention, counter, 0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        stats, *_ = cs._run_utterance(agent, samples)
    events = prof.key_averages()
    device_ms = _device_ms(events)
    launches = _launches(events)
    kernel_ms = sum(e.self_device_time_total for e in events if kernel in e.key) / 1e3
    print(json.dumps({"run": "profiled", "path": tag, "utterance": stats,
                      "device_self_ms": device_ms,
                      "device_busy_share": device_ms / 1e3 / stats["wall_s"],
                      "device_busy_share_of_unprofiled_wall":
                          device_ms / 1e3 / unprofiled_wall,
                      "launches": launches, "launches_total": sum(launches.values()),
                      "cudaLaunchKernel_calls": launches.get("cudaLaunchKernel", 0),
                      "masked_attention_device_ms": kernel_ms,
                      "masked_attention_launches": getattr(masked_attention, counter)}),
          flush=True)
    _write_tables(events, out)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile_serving.txt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    ap.add_argument("--batched", action="store_true",
                    help="profile chip_smoke.py's batched wave of 8 (float32)")
    ap.add_argument("--paths", nargs="+", choices=("host", "fused"), default=["host"],
                    help="the serving paths to run, in turn")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serving: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()

    bf16 = args.dtype == "bfloat16"
    counter = "bf16_launches" if bf16 else "launches"
    kernel = "attention_bf16_kernel" if bf16 else "causal_attention_kernel"
    agent = cs._build_agent(full_config(), DEFAULT_VOCODER_CFG, "cuda", args.seed,
                            getattr(torch, args.dtype))
    if "fused" in args.paths:
        t0 = time.perf_counter()
        batch = len(cs.BATCHED_SECONDS) if args.batched else 1
        stats = agent.engine.warmup(agent.cfg.chunk_size, agent.cfg.conv_chunk_size,
                                    batch_sizes=(batch,))
        print(json.dumps({"run": "warmup", "batch": batch,
                          "seconds": time.perf_counter() - t0, **stats}), flush=True)
    rng = np.random.RandomState(args.seed)
    warm_audio = cs._babble(rng, 3.0)
    samples = cs._babble(rng, 10.0)
    stem = Path(args.out)
    for n, path in enumerate(args.paths):
        out = stem.with_name(f"{stem.stem}_{n}_{path}{stem.suffix}")
        agent.use_fused = path == "fused"
        if args.batched:
            profile_batched(agent, out, path == "fused", path)
            continue
        cs._run_utterance(agent, warm_audio)                   # warm-up
        profile_single(agent, samples, out, counter, kernel, path)
    print(json.dumps({"run": "graphs", **agent.engine.graphs.stats()}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
