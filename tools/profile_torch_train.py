"""Where the time of the port's train step goes, on one CUDA card.

    python3 tools/profile_torch_train.py [--route default|kernels|both]
                                         [--dtype float32 bfloat16]
                                         [--out chiprun_out/profile_train.txt]

Builds the ``chip_smoke.py`` train setup (``full_config``, fp32, dropout 0.1,
seeded random weights, ``measure_train_step``'s batch: B=8, 1024 fbank frames,
MT 48, 256 target units, 32 text tokens; chunk 8, conv chunk 8, Adam with
warmup 10000, lr 1e-3, clip 10) on the default route (plain attention) or the
kernel route (``make_train_step(..., kernel_attention=True)``: the attention
kernels forward and backward, dropout inside them) and, after 2 warm-up steps:

1. the host clock around 5 steps, each ended by a device sync;
2. 3 steps under ``torch.profiler`` (CPU + CUDA activities): the device time
   of all kernels per step, the device-busy share of the host-clock step, the
   launches per step, the top device operations, the device time of each of
   the port's kernels, and the share of the CTC alpha and beta kernels (B8, B9).

``--route both`` profiles default, kernels, kernels, default in turns in one
process, so that the two routes are compared on one card. ``--dtype`` lists
the model's compute dtypes, each profiled on every route asked for
(``bfloat16``: ``StreamSpeechModel(cfg, dtype=torch.bfloat16)``, fp32
parameters and Adam; its kernel route runs the bf16 forms of B3-B6). Prints one
JSON line per run and the card's ``nvidia-smi`` name and power limit; the
profiler's tables go to ``--out`` (one file, a section per run). TF32 off.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from streamspeech_tpu_torch.config import OptimizationConfig, full_config  # noqa: E402
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel  # noqa: E402
from streamspeech_tpu_torch.train.synthetic import (  # noqa: E402
    batch_to_tensors,
    synthetic_batch,
)
from streamspeech_tpu_torch.train.trainer import (  # noqa: E402
    TrainState,
    make_optimizer,
    make_train_step,
)
from streamspeech_tpu_torch.weights import random_init_  # noqa: E402

# the port's kernels by the substrings that name them in the profiler's rows
KERNELS = {
    "ctc_alpha_kernel": ("ctc_alpha_kernel",),
    "ctc_beta_grad_kernel": ("ctc_beta_grad_kernel",),
    "not_blank_kernel": ("not_blank_kernel",),
    "relpos_attention_kernel": ("relpos_attention_kernel",),
    "causal_attention_kernel": ("causal_attention_kernel",),
    "bias_attention_kernel": ("bias_attention_kernel",),
    # B2: the fused pass over the scores, then the ordered partial sums
    "relpos_bwd_kernel": ("relpos_bwd_kernel",),
    "relpos_reduce_kernel": ("relpos_reduce_kernel",),
    "causal_dq_kernel": ("attn_bwd::dq_kernel", "CausalBias"),
    "causal_dkv_kernel": ("attn_bwd::dkv_kernel", "CausalBias"),
    "bias_dq_kernel": ("attn_bwd::dq_kernel", "FullBias"),
    # the fused B6 pass (dq, delta and partial dK/dV) at TK <= 64, or its dK/dV pass
    "bias_dkv_kernel": ("attn_bwd::dkv_kernel", "FullBias"),
    "bias_reduce_kernel": ("attn_bwd::reduce_kernel",),
    "rowdot_kernel": ("rowdot_kernel",),
    # the bf16 forms: B3/B5 (wgmma at D <= 64, the bias form at TK <= 128;
    # mma.sync elsewhere), B4/B6 (B6 at TK <= 128 one kernel, past that the two
    # passes)
    "bf16_fwd_kernel": ("bf16attn::fwd_kernel",),
    "attention_bf16_kernel": ("attention_bf16_kernel",),
    "causal_dq_bf16_kernel": ("attn_bwd_bf16::dq_kernel", "CausalBias"),
    "causal_dkv_bf16_kernel": ("attn_bwd_bf16::dkv_kernel", "CausalBias"),
    "bias_bwd_bf16_kernel": ("attn_bwd_bf16::fused_kernel",),
    "bias_dq_bf16_kernel": ("attn_bwd_bf16::dq_kernel", "FullBias"),
    "bias_dkv_bf16_kernel": ("attn_bwd_bf16::dkv_kernel", "FullBias"),
}
PROFILED_STEPS = 3


def profile_route(kernel_attention: bool, seed: int, dtype=torch.float32) -> str:
    """Profile one route at one compute dtype; print its JSON line and return
    the profiler's table."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = full_config()
    model = random_init_(StreamSpeechModel(cfg, dtype=dtype), seed).cuda()
    tx = make_optimizer(OptimizationConfig(update_freq=1, warmup_updates=10000, lr=1e-3,
                                           clip_norm=10.0))
    step = make_train_step(model, tx, unit_blank=cfg.unit_decoder.vocab_size - 1,
                           kernel_attention=kernel_attention)
    state = TrainState.create(model, tx)
    batch = batch_to_tensors(synthetic_batch(cfg, batch=8, frames=1024, mt_len=48,
                                             units_len=256, text_len=32), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        state, _ = step(state, batch, gen, 8, 8)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch, gen, 8, 8)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_STEPS):
            state, _ = step(state, batch, gen, 8, 8)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # device time of the kernels alone: an op's row repeats its kernels' time
    kernel_rows = [e for e in events if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernel_rows) / 1e3 / PROFILED_STEPS
    wall_ms = statistics.median(walls) * 1e3
    port_ms = {name: sum(e.self_device_time_total for e in kernel_rows
                         if all(part in e.key for part in parts)) / 1e3 / PROFILED_STEPS
               for name, parts in KERNELS.items()}
    route = "kernels" if kernel_attention else "default"
    print(json.dumps({
        "route": route, "dtype": str(dtype), "batch": 8, "frames": 1024, "mt_len": 48,
        "units_len": 256,
        "text_len": 32,
        "wall_ms_median": wall_ms, "wall_ms_all": [w * 1e3 for w in walls],
        "device_ms_per_step": device_ms, "device_busy_share": device_ms / wall_ms,
        "kernel_launches_per_step": sum(e.count for e in kernel_rows) / PROFILED_STEPS,
        "port_kernels_device_ms": port_ms,
        "attention_kernels_device_ms": sum(v for k, v in port_ms.items()
                                           if "ctc" not in k and "not_blank" not in k),
        "ctc_kernels_share": (port_ms["ctc_alpha_kernel"]
                              + port_ms["ctc_beta_grad_kernel"]) / device_ms,
        "top_kernels_ms": [
            [e.key[:60], e.self_device_time_total / 1e3 / PROFILED_STEPS,
             e.count / PROFILED_STEPS]
            for e in sorted(kernel_rows, key=lambda e: -e.self_device_time_total)[:12]],
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }), flush=True)
    return (f"== {route} route, {dtype}: {PROFILED_STEPS} train steps, B=8, MT 48 ==\n"
            + events.table(sort_by="self_device_time_total", row_limit=40,
                           max_name_column_width=70) + "\n")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile_train.txt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--route", choices=("default", "kernels", "both"), default="default")
    ap.add_argument("--dtype", nargs="+", choices=("float32", "bfloat16"),
                    default=["float32"])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    routes = {"default": [False], "kernels": [True],
              "both": [False, True, True, False]}[args.route]
    tables = []
    for name in args.dtype:
        for kernel_attention in routes:
            tables.append(profile_route(kernel_attention, args.seed, getattr(torch, name)))
            torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(tables))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
