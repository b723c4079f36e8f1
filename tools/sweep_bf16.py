"""Time the bf16 forms of B3, B5 and B7 at other cuts, or the bf16 backwards
B4 and B6, on one CUDA card.

    python3 tools/sweep_bf16.py [--not-blank rule 1 2 4 8] [--lib DIR ...]
    python3 tools/sweep_bf16.py --bwd [--lib DIR ...] [--variant NAME=DEFINES ...]

The forward mode times this tree's build of the bf16 attention forwards as
``this`` and each ``--lib DIR`` (a directory holding
``libmasked_attention_bf16.so`` and ``libbias_attention_bf16.so`` built
elsewhere with the same C interface: an earlier version, for example a parent
checkout's ``build/torch_kernels``) under its path. A not-blank variant
``<WPR>`` builds ``csrc/not_blank.cu`` with ``-DNOT_BLANK_WPR=<WPR>`` (warps a
row at every shape; ``rule`` is the port's own build, whose launcher picks the
warps from the rows and the SM count) into ``build/bf16_variants/<name>/``;
the builds start together (``tools/sweeps.py``).

Each library is timed in a process of its own, twice (A B .. B A), at the
shapes of ``chip_smoke.py``, all bf16: B3-bf16 [1,8,T_pad,64] at the serving
buckets and the forward's 640, B5-bf16 at [1,8,600x128,64] and
[8,8,1200x128,64] (24 and 48 valid keys padded to the 128 tile, as the bias
route hands them over), the inference form; the training forms (dropout, row
statistics) at the train shapes, B3-bf16 [8,8,1280,64] and B5-bf16
[8,8,1200x128,64], at rate 0 and 0.1; not-blank [1|8,256,6000]. One JSON line
per library, shape, form and rate: the call's device ms by CUDA-graph replay
as in ``chip_smoke.py``, each CUDA kernel of the call by ``torch.profiler``
over graph replays (device ms a call and launches a call, by kernel name),
the eager host µs a call (the wrapper's checks, the ctypes call and, in the
wgmma form, the tensor maps: the host clock over 200 calls enqueued back to
back, the least of five runs), the error against the plain bf16 version as a
share of ``chip_smoke.py``'s bound, one bf16 ``F.scaled_dot_product_attention``
call under the same mask (and ``dropout_p``) and the bound at the bf16 peak. Then
one line per library with ``cuobjdump -sass``'s count of ``HGMMA``
instructions in each forward library, and the card's name and power limit.

``--bwd`` times the bf16 backwards instead, this tree's build as ``this``,
each ``--variant NAME=DEFINES`` (the two backward sources built with those
nvcc defines into ``build/bf16_variants/NAME/``) and each ``--lib DIR`` (a
directory holding an earlier build of ``libmasked_attention_bwd_bf16.so``,
``libbias_attention_bwd_bf16.so`` and the bf16 forwards; the C interface of
either generation is read from the library's symbols) under its path, each
in a process of its own,
A B .. B A: B4-bf16 at [8,8,1280,64] (1200 valid keys) and B6-bf16 at
[8,8,1200x128,64] (48 valid keys padded to 128) at rate 0 and 0.1, and B6 at
[8,8,1200x64,64] (the same keys padded to 64, one key tile). One JSON line per
library, shape and rate: the call's device ms by CUDA-graph replay, each CUDA
kernel of the call by ``torch.profiler`` over graph replays (device ms a call
and launches a call, by kernel name), and the gradients' largest share of
``chip_smoke.py``'s bound against the plain bf16 backward. Then one line per
library with ``cuobjdump -sass``'s count of ``HGMMA`` instructions in each
backward library, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shlex
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

import sweeps

import chip_smoke as C  # noqa: E402  (sweeps puts the checkout on sys.path)
from streamspeech_tpu_torch.kernels import attention as A  # noqa: E402
from streamspeech_tpu_torch.kernels import policy  # noqa: E402
from streamspeech_tpu_torch.ops.masks import NEG_INF  # noqa: E402

VARIANT_DIR = sweeps.ROOT / "build" / "bf16_variants"
ATTENTION = ("masked_attention_bf16", "bias_attention_bf16")
HOST_CALLS = 200


def build_variants(not_blank) -> dict:
    """{name: its library directory}, the nvcc runs started together."""
    dirs, builds = {"this": sweeps.build.BUILD_DIR}, {}
    for wpr in not_blank:
        if wpr == "rule":
            dirs["wpr_rule"] = sweeps.build.BUILD_DIR
        else:
            builds[f"wpr{wpr}"] = (["not_blank"], [f"-DNOT_BLANK_WPR={wpr}"])
    return {**dirs, **sweeps.build_variants(VARIANT_DIR, builds,
                                            base=[*ATTENTION, "not_blank"])}


def _bf16(gen, *shape):
    return torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)


def host_us(fn, batches=5) -> float:
    """The host's µs a call: HOST_CALLS calls enqueued back to back (the device
    keeps up or the queue absorbs them), after a warm-up; the least of
    ``batches`` such runs (the host's cores are shared, so its clock
    spreads)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / HOST_CALLS * 1e6


def _causal_case(gen, dev, b, t_pad, t):
    """bf16 q, k, v [b, 8, t_pad, 64], the key bias (t valid keys), the causal
    mask for SDPA and the bound."""
    q, k, v = (_bf16(gen, b, 8, t_pad, 64) for _ in range(3))
    kvb = torch.where(torch.arange(t_pad, device=dev) < t, 0.0, NEG_INF).float()
    kvb = kvb.view(1, 1, t_pad).expand(b, 1, t_pad).contiguous()
    i = torch.arange(t_pad, device=dev)
    mask = (kvb[:, :, None, :] + torch.where(i[:, None] >= i[None, :], 0.0,
                                             NEG_INF).float()).bfloat16()
    pairs = b * 8 * t_pad * (t_pad + 1) / 2 * 64
    bound = C._bound_bf16(4 * pairs, C._nbytes(q, k, v, kvb) + 4 * q.numel())
    return (q, k, v, kvb), mask, bound, {"b": b, "t_pad": t_pad, "t": t}


def _bias_case(gen, dev, b, tq, tk):
    """bf16 q [b, 8, tq, 64], K and V of tk keys padded to the 128 tile, the
    wait-k bias (NEG_INF past the valid keys), its SDPA mask and the bound."""
    q, k, v = _bf16(gen, b, 8, tq, 64), _bf16(gen, b, 8, tk, 64), _bf16(gen, b, 8, tk, 64)
    iq, jk = torch.arange(tq, device=dev)[:, None], torch.arange(tk, device=dev)
    n_valid = torch.tensor([tk] * (b - 1) + [tk - 5], device=dev)
    allowed = (jk[None] < (iq // 25 + 1).clamp(max=tk))[None] & \
        (jk[None, None, :] < n_valid[:, None, None])
    k, v, bias = C._pad_keys(k, v, torch.where(allowed, 0.0, NEG_INF).float())
    bound = C._bound_bf16(4 * b * 8 * tq * k.shape[2] * 64,
                          C._nbytes(q, k, v, bias) + 4 * q.numel())
    return (q, k, v, bias), bias[:, None].bfloat16(), bound, \
        {"b": b, "tq": tq, "tk": k.shape[2], "tk_valid": tk}


def time_forward(name, family, args, mask, bound, shape, rate=None) -> None:
    """One JSON line: the inference form (rate None) or the training form at
    ``rate`` of one family at one shape."""
    fwd = getattr(A, f"{family}_attention_forward")
    ref = getattr(A, f"{family}_attention_reference")
    q, k, v, bias = args
    b, h, tq, _ = q.shape
    seed = torch.tensor([C.SEED + 40 + tq], dtype=torch.int64, device=q.device)
    if rate is None:
        def call():
            return fwd(q, k, v, bias, 0.125)
        keep, p = None, 0.0
    else:
        def call():
            return fwd(q, k, v, bias, 0.125, rate, seed if rate > 0 else None, True)
        keep = A.dropout_keep_reference(seed, b, h, tq, k.shape[2], rate) if rate > 0 else None
        p = rate
    got = call()[0]
    want = ref(q, k, v, bias, 0.125, keep, p)
    share = C._bound_share(got, want, 2 * C.BF16_ROUNDING * ref(q, k, v.float().abs(), bias,
                                                                 0.125, keep, p) + C.KERNEL_ATOL)
    del got, want, keep
    print(json.dumps({
        "library": name, "kernel": f"{family}_attention_bf16",
        "form": "inference" if rate is None else "training", "rate": p, **shape,
        "bound_share": share, "ms": C._device_ms(call, calls=10, reps=10),
        "kernels_ms_launches": C._kernel_ms(call), "host_us": host_us(call),
        "library_ms": C._device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, dropout_p=p, scale=0.125), calls=10, reps=10),
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}), flush=True)


def time_library(name: str, lib_dir: Path) -> None:
    sweeps.use_libraries(lib_dir)
    gen = torch.Generator().manual_seed(C.SEED + 7)
    dev = torch.device("cuda", 0)
    if not name.startswith("wpr"):
        for t_pad, t in C.MASKED_SHAPES:
            time_forward(name, "masked", *_causal_case(gen, dev, 1, t_pad, t))
        for b, tq, tk in C.BIAS_SHAPES:
            time_forward(name, "bias", *_bias_case(gen, dev, b, tq, tk))
        b, t_pad, t = C.MASKED_TRAIN_SHAPES[0]
        case = _causal_case(gen, dev, b, t_pad, t)
        for rate in (0.0, C.ATTN_DROPOUT):
            time_forward(name, "masked", *case, rate=rate)
        b, tq, tk = C.BIAS_TRAIN_SHAPES[0]
        case = _bias_case(gen, dev, b, tq, tk)
        for rate in (0.0, C.ATTN_DROPOUT):
            time_forward(name, "bias", *case, rate=rate)
        del case
    else:
        for b, t, vocab in C.NOT_BLANK_SHAPES:
            logits = _bf16(gen, b, t, vocab) * 4
            err = float((policy.not_blank_probs(logits)
                         - policy.not_blank_probs_reference(logits)).abs().max())
            print(json.dumps({
                "library": name, "kernel": "not_blank_probs_bf16", "b": b, "t": t, "v": vocab,
                "max_abs_err": err,
                "ms": C._device_ms(lambda: policy.not_blank_probs(logits))}), flush=True)


BACKWARD = ("masked_attention_bwd_bf16", "bias_attention_bwd_bf16")
# (family, B, TQ, TK valid, TK the kernel sees)
BWD_SHAPES = [("masked", 8, 1280, 1200, 1280), ("bias", 8, 1200, 48, 128),
              ("bias", 8, 1200, 48, 64)]


def _earlier_backward(lib_dir: Path, family: str):
    """The backward entry point of a library built with the earlier C
    interface (query-tile groups and an fp32 partials scratch, exported with a
    ``*_groups`` symbol), as a function of the wrapper's arguments; None for
    this tree's interface."""
    lib = ctypes.CDLL(str(lib_dir / f"lib{family}_attention_bwd_bf16.so"))
    if not hasattr(lib, f"{family}_attention_bwd_bf16_groups"):
        return None
    fn = getattr(lib, f"{family}_attention_bwd_bf16")
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_float] * 2 + \
        [ctypes.c_void_p]
    groups_fn = getattr(lib, f"{family}_attention_bwd_bf16_groups")
    groups_fn.argtypes = [ctypes.c_int] * 5

    def call(q, k, v, bias, g, stats, seed, scale, rate):
        b, h, tq, d = q.shape
        tk = k.shape[2]
        groups = groups_fn(b, h, tq, tk, d)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = g.new_empty((b, h, tq))
        part = g.new_empty((2, groups, b, h, tk, d)) if groups > 1 else None
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), g.data_ptr(),
                 stats.data_ptr(), seed.data_ptr() if rate > 0 else None, delta.data_ptr(),
                 None if part is None else part.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, h, tq, tk, d, groups, scale, rate,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{family} backward: CUDA error {err}")
        return dq, dk, dv, delta
    return call


def time_backward(name: str, lib_dir: Path) -> None:
    sweeps.use_libraries(lib_dir)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(C.SEED + 15)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    for family, b, tq, tk_valid, tk in BWD_SHAPES:
        earlier = _earlier_backward(lib_dir, family)
        if family == "masked":
            q, k, v = (randn(b, 8, tq, 64).bfloat16() for _ in range(3))
            g = randn(b, 8, tq, 64)
            bias = torch.where(torch.arange(tq, device=dev) < tk_valid, 0.0, NEG_INF).float()
            bias = bias.view(1, 1, tq).expand(b, 1, tq).contiguous()
        else:
            q, k, v, g, bias = C._bias_train_inputs(b, tq, tk_valid, randn)
            pad = tk - tk_valid
            k, v = F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad))
            bias = F.pad(bias, (0, pad), value=NEG_INF).contiguous()
            q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        fwd = getattr(A, f"{family}_attention_forward")
        for rate in (0.0, C.ATTN_DROPOUT):
            seed = torch.tensor([C.SEED + 40 + tq], dtype=torch.int64, device=dev)
            _, stats = fwd(q, k, v, bias, 0.125, rate, seed, True)
            if earlier is None:
                def call():
                    return A.backward_bf16(family, q, k, v, bias, g, stats, seed, 0.125, rate)
            else:
                def call():
                    return earlier(q, k, v, bias, g, stats, seed, 0.125, rate)
            got = call()
            keep = A.dropout_keep_reference(seed, b, 8, tq, tk, rate) if rate > 0 else None
            want = getattr(A, f"{family}_attention_backward_reference")(
                q, k, v, bias, g, 0.125, keep, rate)
            terms, _ = C._bf16_backward_terms(family, A, q, k, v, bias, g, 0.125, keep, rate)
            shares = {}
            for grad, a, w, t in zip(("dq", "dk", "dv"), got, want, terms):
                bound = torch.maximum(C._bf16_ulp(a), C._bf16_ulp(w)) + \
                    C.BF16_GRAD_TERMS * t + 1e-30
                shares[grad] = C._bound_share(a.float(), w.float(), bound)
            del want, terms
            print(json.dumps({
                "library": name, "kernel": f"{family}_attention_bwd_bf16", "b": b, "h": 8,
                "tq": tq, "tk": tk, "tk_valid": tk_valid, "d": 64, "rate": rate,
                "interface": "earlier" if earlier is not None else "this tree",
                "bound_share_by_grad": shares,
                "ms": C._device_ms(call, calls=5, reps=10),
                "kernels_ms_launches": C._kernel_ms(call)}), flush=True)


def hgmma_counts(libs: dict, sources) -> None:
    """``cuobjdump -sass``'s count of HGMMA instructions in each of
    ``sources``' libraries in each directory."""
    for name, lib_dir in libs.items():
        counts = {src: sweeps.cuobjdump("-sass", str(Path(lib_dir) / f"lib{src}.so"))
                  .count("HGMMA") for src in sources}
        print(json.dumps({"library": name, "hgmma_instructions": counts}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--not-blank", nargs="*", default=["rule", "1", "2", "4", "8"])
    parser.add_argument("--lib", type=Path, nargs="*", default=[],
                        help="directories that hold both bf16 attention libraries")
    parser.add_argument("--bwd", action="store_true",
                        help="time the bf16 backwards B4 and B6 instead")
    parser.add_argument("--variant", nargs="*", default=[],
                        help="--bwd: NAME=DEFINES, the backward sources built with them")
    parser.add_argument("--time", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time is not None:
        (time_backward if args.bwd else time_library)(args.time[0], Path(args.time[1]))
        return
    if not torch.cuda.is_available():
        raise SystemExit("sweep_bf16: needs a CUDA device")
    if args.bwd:
        variants = {}
        for spec in args.variant:
            name, sep, defines = spec.partition("=")
            if not sep:
                raise SystemExit(f"sweep_bf16: variant {spec!r} is not NAME=DEFINES")
            variants[name] = (BACKWARD, shlex.split(defines))
        libs = {"this": sweeps.build.BUILD_DIR}
        libs.update(sweeps.build_variants(VARIANT_DIR, variants, base=[*BACKWARD, *ATTENTION]))
        libs.update({str(d): d.resolve() for d in args.lib})
        ok = sweeps.time_each(__file__, libs, args=["--bwd"], twice=True, timeout=600)
        hgmma_counts(libs, BACKWARD)
    else:
        libs = build_variants(args.not_blank)
        libs.update({str(d): d.resolve() for d in args.lib})
        ok = sweeps.time_each(__file__, libs, twice=True, timeout=600)
        hgmma_counts({n: d for n, d in libs.items() if not n.startswith("wpr")}, ATTENTION)
    print(sweeps.card_line(), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
