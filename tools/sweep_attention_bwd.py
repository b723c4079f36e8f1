"""Time B6, the bias attention backward, at other query-tile groupings on one CUDA card.

    python3 tools/sweep_attention_bwd.py [--blocks-per-sm 2 4 8]

B6's fused pass splits the query tiles of each (b, h) into G groups so that
the grid has about ``ATTN_BWD_BLOCKS_PER_SM`` blocks an SM
(``csrc/attention_bwd.cuh``, 2 as built). For each value asked, the tool
builds ``csrc/bias_attention_bwd.cu`` with ``-DATTN_BWD_BLOCKS_PER_SM=<n>``
into ``build/attention_bwd_variants/bps<n>/`` (2: the port's own build) and,
in a process of its own (``tools/sweeps.py``), calls ``bias_attention_backward`` on that library at
the kernel train route's shape, [8, 8, 1200 x 48, 64] under the unit
decoder's wait-k mask (``chip_smoke._bias_train_inputs``), at dropout 0 and
0.1. One JSON line per value and rate: G, the scratch bytes, device ms by
CUDA-graph replay as in ``chip_smoke.py``, and each gradient's error over
max|ref| against the plain backward in float64. Then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

import sweeps

import chip_smoke as C  # noqa: E402  (sweeps puts the checkout on sys.path)
from streamspeech_tpu_torch.kernels import attention as A  # noqa: E402
from streamspeech_tpu_torch.kernels import build  # noqa: E402

B, TQ, TK, RATE = 8, 1200, 48, 0.1


def build_variants(values) -> dict:
    """{"bps<n>": its library directory}, the builds started together; 2 is the
    port's own build, and each variant takes the port's forward library."""
    variants = {f"bps{n}": (["bias_attention_bwd"], [f"-DATTN_BWD_BLOCKS_PER_SM={n}"])
                for n in values if n != 2}
    dirs = {"bps2": build.BUILD_DIR} if 2 in values else {}
    return {**dirs, **sweeps.build_variants(
        sweeps.ROOT / "build" / "attention_bwd_variants", variants,
        base=["bias_attention", "bias_attention_bwd"])}


def time_variant(name: str, lib_dir: Path) -> None:
    sweeps.use_libraries(lib_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(C.SEED + 5)
    q, k, v, g, bias = C._bias_train_inputs(
        B, TQ, TK, lambda *s: torch.randn(*s, generator=gen).cuda())
    groups, shape = A.bias_backward_scratch(B, 8, TQ, TK, 64)
    seed = torch.tensor([C.SEED + 20 + TQ], dtype=torch.int64, device=q.device)
    for rate in (0.0, RATE):
        sd = seed if rate > 0 else None
        out, stats = A.bias_attention_forward(q, k, v, bias, 0.125, rate, sd, True)

        def run():
            return A.bias_attention_backward(q, k, v, bias, g, out, stats, sd, 0.125, rate)

        keep = A.dropout_keep_reference(sd, B, 8, TQ, TK, rate) if rate > 0 else None
        want = A.bias_attention_backward_reference(
            *(x.double() for x in (q, k, v, bias, g)), 0.125, keep, rate)
        errs = {n: float((a.double() - w).abs().max() / w.abs().max())
                for n, a, w in zip(("dq", "dk", "dv"), run(), want)}
        print(json.dumps({"blocks_per_sm": int(name[len("bps"):]), "groups": groups,
                          "scratch_bytes": 4 * int(torch.Size(shape).numel()), "rate": rate,
                          "ms": C._device_ms(run, calls=5, reps=10),
                          "rel_err_vs_float64": errs}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--blocks-per-sm", type=int, nargs="+", default=[2, 4, 8])
    parser.add_argument("--time", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time is not None:
        time_variant(args.time[0], Path(args.time[1]))
        return
    if not torch.cuda.is_available():
        raise SystemExit("sweep_attention_bwd: needs a CUDA device")
    ok = sweeps.time_each(__file__, build_variants(args.blocks_per_sm))
    print(sweeps.card_line(), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
