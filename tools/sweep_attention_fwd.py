"""Time B1 and B5, the rel-pos and bias attention forwards, at other tile cuts on one CUDA card.

    python3 tools/sweep_attention_fwd.py [--relpos rule 1x8k16 4x4k16 ...] [--bias 16 32 64]
                                         [--lib DIR ...]

A rel-pos variant ``<RW>x<KW>k<KS>`` builds ``csrc/relpos_attention.cu``
with that one cut at every shape (``-DRELPOS_FWD_CUT_RW=<RW>
-DRELPOS_FWD_CUT_KW=<KW> -DRELPOS_FWD_KS=<KS>``: blocks of RW row groups of
16 queries by KW key slices of KS keys a tile, shrunk as the launcher shrinks
a cut whose tiles do not fit); ``rule`` is the port's own build, whose
launcher picks its small or large cut from B·H·T. A bias variant ``<BQ>``
builds ``csrc/bias_attention.cu`` with ``-DBIAS_FWD_BQ=<BQ>`` (16, 32 or 64;
``64`` is the port's own build). Each goes into
``build/attention_fwd_variants/<source>_<variant>/``; the builds start together
(``tools/sweeps.py``). ``--lib DIR`` adds a directory holding
``librelpos_attention.so`` and ``libbias_attention.so`` built elsewhere with
the same C interface (for example the parent commit's ``build/torch_kernels``),
timed under its name.

Each library is timed in a process of its own at the shapes of
``chip_smoke.py``: rel-pos [1,4,256,64] and [1,4,512,64] at dropout 0 and
[8,4,256,64] at 0.1 under the encoder's chunk-8 mask; bias [1,8,600x24,64] at
0 and [8,8,1200x48,64] at 0.1 under the unit decoder's wait-k masks. One JSON
line per library and shape: device ms by CUDA-graph replay as in
``chip_smoke.py``, and the error against the plain version under the same
mask (absolute, and over max|ref|). Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import torch

import sweeps

import chip_smoke as C  # noqa: E402  (sweeps puts the checkout on sys.path)
from streamspeech_tpu_torch.kernels import attention as A  # noqa: E402
from streamspeech_tpu_torch.kernels import build  # noqa: E402
from streamspeech_tpu_torch.ops.masks import NEG_INF  # noqa: E402

RELPOS_SHAPES = [(1, 256, 0.0), (8, 256, 0.1), (1, 512, 0.0)]      # (B, T, rate); H 4, D 64
BIAS_SHAPES = [(1, 600, 24, 1, 0.0), (8, 1200, 48, 2, 0.1)]       # (B, TQ, TK, n2, rate); H 8
VARIANT_DIR = sweeps.ROOT / "build" / "attention_fwd_variants"


def build_variants(relpos, bias) -> dict:
    """{name: its library directory}, the nvcc runs started together."""
    build.build(["relpos_attention", "bias_attention"])
    dirs, variants = {}, {}
    for source, names in (("relpos_attention", relpos), ("bias_attention", bias)):
        for var in names:
            name = f"{source}_{var}"
            if var in ("rule", "64"):
                dirs[name] = build.BUILD_DIR
                continue
            if source == "relpos_attention":
                m = re.match(r"^(\d+)x(\d+)k(\d+)$", var)
                if m is None:
                    raise SystemExit(f"sweep_attention_fwd: {var!r} is not <RW>x<KW>k<KS>")
                defines = [f"-DRELPOS_FWD_CUT_RW={m[1]}", f"-DRELPOS_FWD_CUT_KW={m[2]}",
                           f"-DRELPOS_FWD_KS={m[3]}"]
            else:
                if not re.match(r"^\d+$", var):
                    raise SystemExit(f"sweep_attention_fwd: {var!r} is not <BQ>")
                defines = [f"-DBIAS_FWD_BQ={var}"]
            variants[name] = ([source], defines)
    return {**dirs, **sweeps.build_variants(VARIANT_DIR, variants)}


def _errors(got, want):
    err = float((got - want).abs().max())
    return {"max_abs_err": err, "max_rel_err": err / float(want.abs().max())}


def time_library(name: str, lib_dir: Path) -> None:
    sweeps.use_libraries(lib_dir)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(C.SEED)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    which = name.split("_")[0] if name.startswith(("relpos_", "bias_")) else None
    if which in (None, "relpos"):
        for b, t, rate in RELPOS_SHAPES:
            qu, qv, k, v = (randn(b, 4, t, 64) for _ in range(4))
            p = randn(4, 2 * t - 1, 64)
            n_valid = torch.tensor([t] * (b - 1) + [t - 56], device=dev)
            i, j = torch.arange(t, device=dev)[:, None], torch.arange(t, device=dev)[None]
            allowed = (j < ((i // 8 + 1) * 8).clamp(max=t))[None, None] & \
                (torch.arange(t, device=dev) < n_valid[:, None])[:, None, None, :]
            bias = torch.where(allowed, 0.0, NEG_INF).float().contiguous()
            sd = torch.tensor([C.SEED + 20 + t], dtype=torch.int64, device=dev)
            sd = sd if rate > 0 else None
            keep = A.dropout_keep_reference(sd, b, 4, t, t, rate) if rate > 0 else None
            args = (qu, qv, k, v, p, bias, 0.125, rate, sd, rate > 0)
            got, _ = A.relpos_attention_forward(*args)
            want = A.relpos_attention_reference(qu, qv, k, v, p, bias, 0.125, keep, rate)
            print(json.dumps({"library": name, "kernel": "relpos_attention", "b": b, "h": 4,
                              "t": t, "d": 64, "rate": rate, **_errors(got, want),
                              "ms": C._device_ms(lambda: A.relpos_attention_forward(*args),
                                                 calls=10, reps=10)}), flush=True)
    if which in (None, "bias"):
        for b, tq, tk, n2, rate in BIAS_SHAPES:
            q, k, v = randn(b, 8, tq, 64), randn(b, 8, tk, 64), randn(b, 8, tk, 64)
            iq, jk = torch.arange(tq, device=dev)[:, None], torch.arange(tk, device=dev)
            n_valid = torch.tensor([tk] * (b - 1) + [tk - 5], device=dev)
            allowed = (jk[None] < ((iq // 25 + 1) * n2).clamp(max=tk))[None] & \
                (jk[None, None, :] < n_valid[:, None, None])
            bias = torch.where(allowed, 0.0, NEG_INF).float().contiguous()
            sd = torch.tensor([C.SEED + 20 + tq], dtype=torch.int64, device=dev)
            sd = sd if rate > 0 else None
            keep = A.dropout_keep_reference(sd, b, 8, tq, tk, rate) if rate > 0 else None
            args = (q, k, v, bias, 0.125, rate, sd, rate > 0)
            got, _ = A.bias_attention_forward(*args)
            want = A.bias_attention_reference(q, k, v, bias, 0.125, keep, rate)
            print(json.dumps({"library": name, "kernel": "bias_attention", "b": b, "h": 8,
                              "tq": tq, "tk": tk, "d": 64, "rate": rate,
                              **_errors(got, want),
                              "ms": C._device_ms(lambda: A.bias_attention_forward(*args),
                                                 calls=10, reps=10)}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--relpos", nargs="*",
                        default=["rule", "1x8k16", "4x4k16", "2x4k16", "4x2k32"])
    parser.add_argument("--bias", nargs="*", default=["16", "32", "64"])
    parser.add_argument("--lib", type=Path, nargs="*", default=[],
                        help="directories that hold both libraries, built elsewhere")
    parser.add_argument("--time", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time is not None:
        time_library(args.time[0], Path(args.time[1]))
        return
    if not torch.cuda.is_available():
        raise SystemExit("sweep_attention_fwd: needs a CUDA device")
    libs = {str(d): d.resolve() for d in args.lib}
    libs.update(build_variants(args.relpos, args.bias))
    ok = sweeps.time_each(__file__, libs, timeout=300)
    print(sweeps.card_line(), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
