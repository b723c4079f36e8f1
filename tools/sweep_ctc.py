"""Time B8 and B9, the CTC alpha and beta kernels, at other cuts of the state axis on one CUDA card.

    python3 tools/sweep_ctc.py [--variants 4x1r8d8 2x4r8d8 ...] [--lib DIR ...]

A variant ``<L>x<NW>r<R>k<K>`` builds ``csrc/ctc.cu`` with
``-DCTC_LANE_STATES=L -DCTC_WARPS=NW -DCTC_RING=R -DCTC_BATCH=K`` (states a
lane, warps a block, slots of the boundary ring, frames handed over at once
and unrolled, K - 1 of them fetched ahead) into
``build/ctc_variants/<variant>/``; the builds start together
(``tools/sweeps.py``). ``--lib DIR``
adds a library already built with the same C interface (for example the
parent commit's ``build/torch_kernels``), timed under its directory's name.
Each library is timed in a process of its own at the three ``CTC_SHAPES`` of
``chip_smoke.py`` (the train step's unit CTC [8, 1200, 513], its fused ASR + ST
pair [16, 256, 65] and [1, 1200, 513]), on the inputs ``chip_smoke.py`` makes
(seeded logits, the last row with 1/8 of its frames padded and 5 labels
fewer): device ms of ``ctc_alpha`` and ``ctc_beta_grad`` by CUDA-graph replay
as in ``chip_smoke.py``, the cut (where the library reports one) and the
largest error against the plain versions (alpha scaled by max(1, |ref|), the
gradient absolute). One JSON line per library and shape, then the card's
name and power limit.
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
from streamspeech_tpu_torch.kernels import ctc  # noqa: E402

DEFAULT_VARIANTS = ["1x4r4k8", "1x4r4k4", "1x2r4k4", "1x4r8k8", "1x4r4k16", "2x2r4k8",
                    "4x1r4k8"]
VARIANT = re.compile(r"^(\d+)x(\d+)r(\d+)k(\d+)$")


def build_variants(names) -> dict:
    """{name: its library directory}, the nvcc runs started together."""
    variants = {}
    for name in names:
        m = VARIANT.match(name)
        if m is None:
            raise SystemExit(f"sweep_ctc: variant {name!r} is not <L>x<NW>r<R>k<K>")
        lane, warps, ring, batch = m.groups()
        variants[name] = (["ctc"], [f"-DCTC_LANE_STATES={lane}", f"-DCTC_WARPS={warps}",
                                    f"-DCTC_RING={ring}", f"-DCTC_BATCH={batch}"])
    return sweeps.build_variants(sweeps.ROOT / "build" / "ctc_variants", variants)


def _plan(s: int):
    """The library's cut of S states, or None for a library without the entry point."""
    try:
        return ctc.cluster_plan(s)
    except AttributeError:
        return None


def time_library(name: str, lib_dir: Path) -> None:
    sweeps.use_libraries(lib_dir)
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(C.SEED)
    for b, t, vocab, n, blank in C.CTC_SHAPES:
        logits = (torch.randn(b, t, vocab, generator=gen) * 2).to(dev)
        labels = torch.randint(4, blank if blank > 0 else vocab, (b, n),
                               generator=gen).to(dev)
        lengths = torch.tensor([t] * (b - 1) + [t - t // 8], device=dev)
        lab_len = torch.tensor([n] * (b - 1) + [n - 5], device=dev)
        parts = {k: v.contiguous() for k, v in
                 ctc.ext_and_masks(logits, lengths, labels, lab_len, blank).items()}
        lp, init, end, skip, valid = (parts[k] for k in ("lp_ext", "initmask", "endmask",
                                                           "skipmask", "validmask"))
        alpha = ctc.ctc_alpha(lp, init, skip, valid)
        want = ctc.ctc_alpha_reference(lp, init, skip, valid)
        _, logz = ctc.nll_from_alpha(want, end)
        zbias = torch.where(logz > ctc.NNEG / 2, -logz, torch.full_like(logz, ctc.NNEG))
        grad = ctc.ctc_beta_grad(lp, end, skip, zbias, valid, want)
        want_grad = ctc.ctc_beta_grad_reference(lp, end, skip, zbias, valid, want)
        torch.cuda.synchronize()
        print(json.dumps({
            "library": name, "b": b, "t": t, "s": lp.shape[2],
            "plan": _plan(lp.shape[2]),
            "alpha_ms": C._device_ms(lambda: ctc.ctc_alpha(lp, init, skip, valid),
                                     calls=5, reps=10),
            "beta_ms": C._device_ms(lambda: ctc.ctc_beta_grad(lp, end, skip, zbias, valid,
                                                              want), calls=5, reps=10),
            "alpha_max_scaled_err": C._scaled_err(alpha, want)[1],
            "grad_max_abs_err": float((grad - want_grad).abs().max())}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="*", default=DEFAULT_VARIANTS)
    parser.add_argument("--lib", type=Path, nargs="*", default=[],
                        help="directories that hold a libctc.so built elsewhere")
    parser.add_argument("--time", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time is not None:
        time_library(args.time[0], Path(args.time[1]))
        return
    if not torch.cuda.is_available():
        raise SystemExit("sweep_ctc: needs a CUDA device")
    libs = {str(d): d.resolve() for d in args.lib}
    libs.update(build_variants(args.variants))
    # a library that hangs is cut after 120 s and reported, the others still run
    ok = sweeps.time_each(__file__, libs, timeout=120)
    print(sweeps.card_line(), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
