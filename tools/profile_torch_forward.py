"""Where the time of the port's offline forward goes, on one CUDA card.

    python3 tools/profile_torch_forward.py [--out chiprun_out/profile_forward.txt]
                                           [--dtype float32|bfloat16]

Builds the ``chip_smoke.py`` forward setup (``full_config``, seeded random
weights, doctored) and, for each of ``measure_forward``'s shape (B=1, 1024
fbank frames, MT 24) and the train-step shape (B=8, MT 48), after 3 warm-up
forwards:

1. the host clock around 10 forwards, each ended by a device sync;
2. 5 forwards under ``torch.profiler`` (CPU + CUDA activities): the device
   time of all kernels, the device-busy share of the host-clock time, the
   launch count, and each of the port's four CUDA kernels' device time.

Prints one JSON line per shape and the card's ``nvidia-smi`` name and power
limit; the profiler's tables go to ``--out``. TF32 off; ``--dtype bfloat16``
builds the model with that compute dtype (its bf16 kernel forms run).
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

from streamspeech_tpu_torch.config import full_config  # noqa: E402
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel  # noqa: E402
from streamspeech_tpu_torch.weights import doctor_params, random_init_  # noqa: E402

KERNELS = ("relpos_attention_kernel", "bias_attention_kernel",
           "causal_attention_kernel", "bf16attn::fwd_kernel", "attention_bf16_kernel",
           "not_blank_kernel")
FORWARD_KW = dict(chunk_size=8, conv_chunk_size=8, k1=0, n1=1, k2=0, n2=1)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile_forward.txt")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_forward: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dtype = getattr(torch, args.dtype)
    model = doctor_params(random_init_(StreamSpeechModel(full_config(), dtype=dtype),
                                       args.seed)).eval().cuda()
    tables = []
    for batch, mt_len in ((1, 24), (8, 48)):
        gen = torch.Generator().manual_seed(args.seed)
        inputs = (torch.randn(batch, 1024, 80, generator=gen).cuda(),
                  torch.full((batch,), 1024, device="cuda"),
                  torch.full((batch, mt_len), 4, device="cuda"))
        with torch.no_grad():
            for _ in range(3):
                model(*inputs, **FORWARD_KW)
            walls = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model(*inputs, **FORWARD_KW)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    model(*inputs, **FORWARD_KW)
                torch.cuda.synchronize()
        events = prof.key_averages()
        # device time of the kernels alone: an op's row repeats its kernels' time
        device_ms = sum(e.self_device_time_total for e in events
                        if e.device_type == DeviceType.CUDA) / 1e3 / 5
        kernel_rows = [e for e in events if e.device_type == DeviceType.CUDA]
        wall_ms = statistics.median(walls) * 1e3
        print(json.dumps({
            "dtype": args.dtype, "batch": batch, "frames": 1024, "mt_len": mt_len,
            "wall_ms_median": wall_ms, "wall_ms_all": [w * 1e3 for w in walls],
            "device_ms_per_forward": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "kernel_launches_per_forward": sum(e.count for e in kernel_rows) / 5,
            "port_kernels_device_ms": {
                k: sum(e.self_device_time_total for e in kernel_rows if k in e.key)
                / 1e3 / 5 for k in KERNELS},
            "top_kernels_ms": [
                [e.key[:60], e.self_device_time_total / 1e3 / 5, e.count / 5]
                for e in sorted(kernel_rows, key=lambda e: -e.self_device_time_total)[:8]],
        }), flush=True)
        tables.append(f"== B={batch}, MT {mt_len}: 5 forwards ==\n"
                      + events.table(sort_by="self_device_time_total", row_limit=25,
                                     max_name_column_width=70))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(tables))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
