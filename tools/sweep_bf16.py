"""Time the bf16 forms of B3, B5 and B7 at other cuts on one CUDA card.

    python3 tools/sweep_bf16.py [--not-blank rule 1 2 4 8] [--lib DIR ...]

The port's own build of the bf16 attention forms is timed as ``bq64``.
``--lib DIR`` adds a directory holding ``libmasked_attention_bf16.so`` and
``libbias_attention_bf16.so`` built elsewhere with the same C interface (an
earlier version or a trial cut of the kernels), timed under its name. A
not-blank variant ``<WPR>`` builds ``csrc/not_blank.cu`` with
``-DNOT_BLANK_WPR=<WPR>`` (warps a row at every shape; ``rule`` is the port's
own build, whose launcher picks the warps from the rows and the SM count)
into ``build/bf16_variants/<name>/``; the builds start together
(``tools/sweeps.py``).

Each library is timed in a process of its own, twice (A B .. B A), at the
shapes of ``chip_smoke.py``: causal [1,8,T_pad,64] at the serving buckets and
the forward's 640, bias [1,8,600x24,64] and [8,8,1200x48,64], not-blank
[1|8,256,6000], all bf16. One JSON line per library and shape: device ms by
CUDA-graph replay as in ``chip_smoke.py``, the error against the plain bf16
version, and beside it one bf16 ``F.scaled_dot_product_attention`` call under
the same mask (attention). Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
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


def build_variants(not_blank) -> dict:
    """{name: its library directory}, the nvcc runs started together."""
    dirs, variants = {"bq64": sweeps.build.BUILD_DIR}, {}
    for wpr in not_blank:
        if wpr == "rule":
            dirs["wpr_rule"] = sweeps.build.BUILD_DIR
        else:
            variants[f"wpr{wpr}"] = (["not_blank"], [f"-DNOT_BLANK_WPR={wpr}"])
    return {**dirs, **sweeps.build_variants(VARIANT_DIR, variants,
                                            base=[*ATTENTION, "not_blank"])}


def _bf16(gen, *shape):
    return torch.randn(*shape, generator=gen).to("cuda", torch.bfloat16)


def time_library(name: str, lib_dir: Path) -> None:
    sweeps.use_libraries(lib_dir)
    gen = torch.Generator().manual_seed(C.SEED + 7)
    dev = torch.device("cuda", 0)
    if not name.startswith("wpr"):
        for t_pad, t in C.MASKED_SHAPES:
            q, k, v = (_bf16(gen, 1, 8, t_pad, 64) for _ in range(3))
            kvb = torch.where(torch.arange(t_pad, device=dev) < t, 0.0, NEG_INF).float()
            kvb = kvb.view(1, 1, t_pad)
            i = torch.arange(t_pad, device=dev)
            mask = (kvb[:, :, None, :] + torch.where(i[:, None] >= i[None, :], 0.0,
                                                     NEG_INF).float()).bfloat16()
            got = A.masked_attention(q, k, v, kvb, 0.125)
            want = A.masked_attention_reference(q, k, v, kvb, 0.125)
            bound = C._bf16_bound(A.masked_attention_reference, q, k, v, kvb)
            print(json.dumps({
                "library": name, "kernel": "masked_attention_bf16", "t_pad": t_pad, "t": t,
                "max_abs_err": float((got - want).abs().max()),
                "bound_share": C._bound_share(got, want, bound),
                "ms": C._device_ms(lambda: A.masked_attention(q, k, v, kvb, 0.125)),
                "library_ms": C._device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=0.125))}), flush=True)
        for b, tq, tk in C.BIAS_SHAPES:
            q, k, v = _bf16(gen, b, 8, tq, 64), _bf16(gen, b, 8, tk, 64), _bf16(gen, b, 8, tk, 64)
            iq, jk = torch.arange(tq, device=dev)[:, None], torch.arange(tk, device=dev)
            n_valid = torch.tensor([tk] * (b - 1) + [tk - 5], device=dev)
            allowed = (jk[None] < (iq // 25 + 1).clamp(max=tk))[None] & \
                (jk[None, None, :] < n_valid[:, None, None])
            bias = torch.where(allowed, 0.0, NEG_INF).float().contiguous()
            mask = bias[:, None].bfloat16()
            got = A.bias_attention(q, k, v, bias, 0.125)
            want = A.bias_attention_reference(q, k, v, bias, 0.125)
            bound = C._bf16_bound(A.bias_attention_reference, q, k, v, bias)
            print(json.dumps({
                "library": name, "kernel": "bias_attention_bf16", "b": b, "tq": tq, "tk": tk,
                "max_abs_err": float((got - want).abs().max()),
                "bound_share": C._bound_share(got, want, bound),
                "ms": C._device_ms(lambda: A.bias_attention(q, k, v, bias, 0.125)),
                "library_ms": C._device_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, scale=0.125))}), flush=True)
    if not name.startswith("bq"):
        for b, t, vocab in C.NOT_BLANK_SHAPES:
            logits = _bf16(gen, b, t, vocab) * 4
            err = float((policy.not_blank_probs(logits)
                         - policy.not_blank_probs_reference(logits)).abs().max())
            print(json.dumps({
                "library": name, "kernel": "not_blank_probs_bf16", "b": b, "t": t, "v": vocab,
                "max_abs_err": err,
                "ms": C._device_ms(lambda: policy.not_blank_probs(logits))}), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--not-blank", nargs="*", default=["rule", "1", "2", "4", "8"])
    parser.add_argument("--lib", type=Path, nargs="*", default=[],
                        help="directories that hold both bf16 attention libraries")
    parser.add_argument("--time", nargs=2, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.time is not None:
        time_library(args.time[0], Path(args.time[1]))
        return
    if not torch.cuda.is_available():
        raise SystemExit("sweep_bf16: needs a CUDA device")
    libs = {f"bq_{d.name}": d.resolve() for d in args.lib}
    libs.update(build_variants(args.not_blank))
    ok = sweeps.time_each(__file__, libs, twice=True, timeout=300)
    print(sweeps.card_line(), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
