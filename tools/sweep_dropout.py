"""Time the dropout draw inside B1-B6, its writer B10, and B7 on one CUDA card.

    python3 tools/sweep_dropout.py [--lib DIR ...] [--variant NAME=DEFINES ...]
                                   [--kernels relpos masked bias dropout not_blank]

Each library directory is timed in a process of its own, twice, in the order
A B ... B A (``tools/sweeps.py``): this tree's build (``build/torch_kernels``,
the chosen kernels' sources built first), every ``--lib DIR`` (libraries built
elsewhere with the same C interface, for example the parent commit's
``build/torch_kernels``, timed under the directory's name) and every
``--variant NAME=DEFINES``, which builds this tree's sources of the chosen
kernels with the extra nvcc defines (space-separated, e.g.
``wpr1=-DNOT_BLANK_WPR=1``, B7 on one warp a row at every shape, or
``nocopy=-DATTN_DROPOUT_COPY_MAX_D=0``, no kernel with a copy of its score
stage for dropout) into ``build/sweep_dropout/NAME/``; the builds start
together.

At the kernel train route's shapes of ``chip_smoke.py``, on its inputs: B1 and
B2 at [8, 4, 256, 64], B3 and B4 at [8, 8, 1280, 64] (1200 valid), B5 and B6
at [8, 8, 1200 x 48, 64], each at dropout 0 and 0.1: device ms by CUDA-graph
replay as in ``chip_smoke.py`` (the two rates in turn, three rounds, the
median), the error against the plain version under the plain mask (over
max|ref|), and at 0.1 ``dropout_gap_ms``, the time at 0.1 less the time at 0;
beside it ``step_like_ms``, the device ms a call as the host-bound train step
runs it (eager calls, each after a 64 MiB fill and a 1024 x 1024 product, the
port's kernel rows of ``torch.profiler``, ``step_like_ms``). The writer of the mask at [8, 8, 1280, 1280], rate 0.1, against
``dropout_keep_reference`` (differing elements); B7 at [1, 256, 6000] and
[8, 256, 6000] against its plain version. One JSON line per library, kernel
and shape; then per library the gaps weighted by launches a kernel-route step
(12 B1, 12 B2, 2 each of B3-B6), registers and local-memory bytes of each
D = 64 instance (``cuobjdump -res-usage``) and the writer kernel's SASS
opcodes, whole and per draw of its main loop (``writer_sass``); last the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import shlex
import statistics
import sys
from pathlib import Path

import torch

import sweeps

import chip_smoke as C  # noqa: E402  (sweeps puts the checkout on sys.path)
from streamspeech_tpu_torch.kernels import attention as A  # noqa: E402
from streamspeech_tpu_torch.kernels import build  # noqa: E402
from streamspeech_tpu_torch.kernels import policy  # noqa: E402

SOURCES = {"relpos": ["relpos_attention", "relpos_attention_bwd"],
           "masked": ["masked_attention", "masked_attention_bwd"],
           "bias": ["bias_attention", "bias_attention_bwd"],
           "dropout": ["dropout"], "not_blank": ["not_blank"]}
# launches a kernel-route train step (forward; the backward as many)
STEP_LAUNCHES = {"relpos": 12, "masked": 2, "bias": 2}
VARIANT_DIR = sweeps.ROOT / "build" / "sweep_dropout"
RATE = C.ATTN_DROPOUT
ROUNDS = 3  # rounds of the two rates in turn, a kernel
# SASS opcodes that are not integer arithmetic: control, memory, uniform datapath
NOT_INT32 = ("BRA", "BSSY", "BSYNC", "EXIT", "NOP", "RET", "CALL", "WARPSYNC", "ST", "LD",
             "S2R", "S2UR", "U", "R2UR", "SHFL", "BAR", "MUFU", "F", "I2F", "HMMA")


def resources(lib_dir: Path, kernels) -> dict:
    """{source: {kernel instance at D = 64: [registers, local bytes]}}."""
    out = {}
    for src in (s for k in kernels for s in SOURCES[k]):
        lib = lib_dir / f"lib{src}.so"
        if not lib.exists():
            continue
        rows = {}
        for m in re.finditer(r"Function ([\w$]+):\s*REG:(\d+)\s+STACK:(\d+)\s+SHARED:\d+\s+"
                             r"LOCAL:(\d+)", sweeps.cuobjdump("-res-usage", str(lib))):
            name, regs, stack, local = m[1], int(m[2]), int(m[3]), int(m[4])
            key = C._instance_key(name)
            if src in ("dropout", "not_blank") or "ILi64E" in name:
                rows[key] = [regs, max(stack, local)]
        out[src] = rows
    return out


def writer_sass(lib: Path) -> dict:
    """The mask writer's SASS (``cuobjdump -sass`` of ``lib``): opcode counts of
    the whole kernel and, per draw (16 IMAD.WIDE.U32 a Philox draw, as
    dropout.cuh writes it), of its main loop: of the backward branches whose
    bodies hold a draw, the one with the fewest instructions a draw (the
    32-bit stores' path, not the bytes'); ``int32_per_draw`` counts those
    that are integer arithmetic. What this build issues, beside the least work
    a draw needs (``chip_smoke.DRAW_FMA_OPS``, ``DRAW_ALU_OPS``)."""
    body = sweeps.cuobjdump("-sass", str(lib)).split("Function : ", 1)[-1]
    lines = [(int(m[1], 16), m[2], m[3]) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", body)]
    best = None
    for addr, op, rest in lines:
        target = re.search(r"0x([0-9a-f]+)", rest) if op == "BRA" else None
        if target and int(target[1], 16) < addr:
            loop = collections.Counter(o for a, o, _ in lines if int(target[1], 16) <= a <= addr)
            if loop["IMAD.WIDE.U32"] >= 16 and (best is None or sum(loop.values()) / loop[
                    "IMAD.WIDE.U32"] < sum(best.values()) / best["IMAD.WIDE.U32"]):
                best = loop
    if best is None:
        raise AssertionError(f"no Philox draw loop in the SASS of {lib}")
    draws = best["IMAD.WIDE.U32"] / 16
    per_draw = {op: n / draws for op, n in best.most_common()}
    return {"whole_kernel": dict(collections.Counter(op for _, op, _ in lines).most_common()),
            "draws_in_main_loop": draws, "per_draw": per_draw,
            "int32_per_draw": sum(n for op, n in per_draw.items()
                                  if not op.startswith(NOT_INT32))}


def _attention_inputs(family, randn, dev):
    """(diff, const, g, keep shape) of chip_smoke.py's main train shape."""
    from streamspeech_tpu_torch.ops.masks import NEG_INF

    if family == "relpos":
        b, t, valid = C.RELPOS_TRAIN_SHAPES[0]
        qu, qv, k, v, g = (randn(b, 4, t, 64) for _ in range(5))
        p = randn(4, 2 * t - 1, 64)
        n_valid = torch.tensor([t] * (b - 1) + [valid], device=dev)
        i, j = torch.arange(t, device=dev)[:, None], torch.arange(t, device=dev)[None]
        allowed = (j < ((i // 8 + 1) * 8).clamp(max=t))[None, None] & \
            (torch.arange(t, device=dev) < n_valid[:, None])[:, None, None, :]
        bias = torch.where(allowed, 0.0, NEG_INF).float().contiguous()
        return (qu, qv, k, v, p), (bias,), g, (b, 4, t, t)
    if family == "masked":
        b, t_pad, t = C.MASKED_TRAIN_SHAPES[0]
        q, k, v, g = (randn(b, 8, t_pad, 64) for _ in range(4))
        kvb = torch.where(torch.arange(t_pad) < t, 0.0, NEG_INF)
        kvb = kvb.to(torch.float32).view(1, 1, t_pad).expand(b, 1, t_pad).contiguous().to(dev)
        return (q, k, v), (kvb,), g, (b, 8, t_pad, t_pad)
    b, tq, tk = C.BIAS_TRAIN_SHAPES[0]
    q, k, v, g, bias = C._bias_train_inputs(b, tq, tk, randn)
    return (q, k, v), (bias,), g, (b, 8, tq, tk)


def step_like_ms(fn, reps: int = 20) -> float:
    """Device ms of one call of ``fn`` as a launch of the host-bound train step
    sees it: each call eager, after a 64 MiB fill (more than the L2 holds) and
    a cuBLAS product in between, so that its data and code come in cold; the
    rows of ``torch.profiler`` that are the port's kernels (not ``at::native``
    or cuBLAS), summed and divided by the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    a = torch.ones(1024, 1024, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.fill_(1)
            a @ a
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not any(k in e.key for k in ("at::native", "gemm", "Memset", "Memcpy"))]
    return sum(e.self_device_time_total for e in mine) / 1e3 / reps


def time_library(name: str, lib_dir: Path, kernels) -> None:
    sweeps.use_libraries(lib_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(C.SEED + 5)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def emit(**row):
        print(json.dumps({"library": name, **row}), flush=True)

    gaps = {}
    for family in ("relpos", "masked", "bias"):
        if family not in kernels:
            continue
        fwd = getattr(A, f"{family}_attention_forward")
        bwd = getattr(A, f"{family}_attention_backward")
        ref = getattr(A, f"{family}_attention_reference")
        ref_bwd = getattr(A, f"{family}_attention_backward_reference")
        diff, const, g, keep_shape = _attention_inputs(family, randn, dev)
        seed = torch.tensor([C.SEED + 20 + keep_shape[2]], dtype=torch.int64, device=dev)
        args, errs = {}, {}
        for rate in (0.0, RATE):
            sd = seed if rate > 0 else None
            keep = A.dropout_keep_reference(sd, *keep_shape, rate) if rate > 0 else None
            out, stats = fwd(*diff, *const, 0.125, rate, sd, True)
            grads = bwd(*diff, *const, g, out, stats, sd, 0.125, rate)
            want = ref(*diff, *const, 0.125, keep, rate)
            want_grads = ref_bwd(*diff, *const, g, 0.125, keep, rate)
            errs["forward", rate] = C._rel_err(out, want)[1]
            errs["backward", rate] = max(C._rel_err(a, w)[1] for a, w in zip(grads, want_grads))
            args[rate] = (sd, out, stats)
            del want, want_grads, keep, grads

        def call(part, rate):
            sd, out, stats = args[rate]
            if part == "forward":
                return lambda: fwd(*diff, *const, 0.125, rate, sd, True)
            return lambda: bwd(*diff, *const, g, out, stats, sd, 0.125, rate)

        # the two rates in turn, ROUNDS times: the gap is a difference of two
        # close times, so each is a median over rounds
        times, cold = collections.defaultdict(list), collections.defaultdict(list)
        for _ in range(ROUNDS):
            for part in ("forward", "backward"):
                for rate in (0.0, RATE):
                    times[part, rate].append(C._device_ms(call(part, rate), calls=5, reps=20))
                    cold[part, rate].append(step_like_ms(call(part, rate)))
        for part in ("forward", "backward"):
            kernel = f"{family}_attention" + ("_bwd" if part == "backward" else "")
            for rate in (0.0, RATE):
                row = {"kernel": kernel, "shape": list(keep_shape), "rate": rate,
                       "ms": statistics.median(times[part, rate]),
                       "ms_by_round": times[part, rate],
                       "step_like_ms": statistics.median(cold[part, rate]),
                       "max_rel_err": errs[part, rate]}
                if rate > 0:
                    row["dropout_gap_ms"] = row["ms"] - statistics.median(times[part, 0.0])
                    row["step_like_gap_ms"] = row["step_like_ms"] - statistics.median(
                        cold[part, 0.0])
                    gaps[kernel] = row["dropout_gap_ms"]
                emit(**row)
    if gaps:
        emit(summary="dropout_gap_ms_a_kernel_route_step", gaps=gaps,
             step_weighted_sum=sum(gap * STEP_LAUNCHES[k.split("_")[0]]
                                   for k, gap in gaps.items()))

    if "dropout" in kernels:
        shape = (8, 8, 1280, 1280)
        seed = torch.tensor([C.SEED + 11], dtype=torch.int64, device=dev)
        got = A.dropout_keep(seed, *shape, RATE)
        differing = int((got != A.dropout_keep_reference(seed, *shape, RATE)).sum())
        del got
        out = torch.empty(shape, dtype=torch.uint8, device=dev)
        emit(kernel="dropout_keep", shape=list(shape), rate=RATE, differing=differing,
             ms=C._device_ms(lambda: A.dropout_keep(seed, *shape, RATE), calls=5, reps=20),
             kernel_alone_ms=C._device_ms(lambda: build.launch(
                 A._KEEP, dev, seed.data_ptr(), out.data_ptr(), *shape, RATE), calls=5, reps=20))
    if "not_blank" in kernels:
        for b, t, vocab in C.NOT_BLANK_SHAPES:
            logits = randn(b, t, vocab) * 4
            err = float((policy.not_blank_probs(logits) -
                         policy.not_blank_probs_reference(logits)).abs().max())
            emit(kernel="not_blank_probs", shape=[b, t, vocab], max_abs_err=err,
                 ms=C._device_ms(lambda: policy.not_blank_probs(logits), calls=20, reps=20))
    emit(resources=resources(lib_dir, kernels))
    if "dropout" in kernels and (lib_dir / "libdropout.so").exists():
        emit(writer_sass=writer_sass(lib_dir / "libdropout.so"))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--lib", type=Path, nargs="*", default=[],
                        help="directories of libraries built elsewhere")
    parser.add_argument("--variant", nargs="*", default=[],
                        help="NAME=DEFINES: this tree's sources built with extra defines")
    parser.add_argument("--kernels", nargs="*", default=list(SOURCES), choices=list(SOURCES))
    parser.add_argument("--time", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time is not None:
        time_library(args.time[0], Path(args.time[1]), args.kernels)
        return
    if not torch.cuda.is_available():
        raise SystemExit("sweep_dropout: needs a CUDA device")
    sources = [src for k in args.kernels for src in SOURCES[k]]
    variants = {}
    for spec in args.variant:
        name, _, defines = spec.partition("=")
        if not name or not defines:
            raise SystemExit(f"sweep_dropout: variant {spec!r} is not NAME=DEFINES")
        variants[name] = (sources, shlex.split(defines))
    build.build(sources)
    libs = {str(d): d.resolve() for d in args.lib}
    libs["this tree"] = build.BUILD_DIR
    libs.update(sweeps.build_variants(VARIANT_DIR, variants))
    ok = sweeps.time_each(__file__, libs, ["--kernels", *args.kernels], twice=True)
    print(sweeps.card_line(), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
