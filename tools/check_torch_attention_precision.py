"""How far the attention backward kernels' fp32 gradients lie from float64 ones,
beside the plain fp32 version's, on inputs where the softmax backward cancels.

    python3 tools/check_torch_attention_precision.py

ds = p·(dp - delta) subtracts two numbers that are close when the values v_j
hardly differ from key to key (a unit decoder whose 25 queries per text token
share one source row). The two-pass kernels (causal; bias past one key tile)
take delta = Σ_d g·out, the fused bias kernel, the plain version and autograd
take delta = Σ_j dp_j·p_j; all round in fp32, differently. For
the causal and the bias family at [2, 8, 640 (x 48), 64], with
v_j = v̄ + spread·noise for spread 1 (random values), 0.1 and 0.01, this prints
per family and spread the largest per-tensor error max|g - g64| / max|g64| of
the kernel, of the plain fp32 backward and of fp32 autograd through the plain
forward, against the plain backward run in float64, and the kernel's and the
plain backward's error per tensor (dq, dK, dV). One JSON line, then the
card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from streamspeech_tpu_torch.kernels import attention as A  # noqa: E402
from streamspeech_tpu_torch.ops.masks import NEG_INF  # noqa: E402


def rel_errs(got, want):
    return [float((g.double() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for g, w in zip(got, want)]


def rel_err(got, want):
    return max(rel_errs(got, want))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("check_torch_attention_precision: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    b, h, t, tk, d = 2, 8, 640, 48, 64
    rows = []
    for spread in (1.0, 0.1, 0.01):
        q, g = randn(b, h, t, d), randn(b, h, t, d)
        cases = {}
        k = randn(b, h, t, d)
        v = (randn(b, h, 1, d) + spread * randn(b, h, t, d)).contiguous()
        kvb = torch.where(torch.arange(t) < 600, 0.0, NEG_INF).float()
        kvb = kvb.view(1, 1, t).expand(b, 1, t).contiguous().to(dev)
        cases["masked"] = ((q, k, v), kvb)
        k2 = randn(b, h, tk, d)
        v2 = (randn(b, h, 1, d) + spread * randn(b, h, tk, d)).contiguous()
        allowed = torch.arange(tk)[None, :] < (torch.arange(t)[:, None] // 25 + 1) * 2
        bias = torch.where(allowed, 0.0, NEG_INF).float()[None].expand(b, t, tk)
        cases["bias"] = ((q, k2, v2), bias.contiguous().to(dev))
        for family, (diff, const) in cases.items():
            fwd = getattr(A, f"{family}_attention_forward")
            bwd = getattr(A, f"{family}_attention_backward")
            ref = getattr(A, f"{family}_attention_reference")
            ref_bwd = getattr(A, f"{family}_attention_backward_reference")
            truth = ref_bwd(*(x.double() for x in diff), const.double(), g.double(), 0.125)
            out, stats = fwd(*diff, const, 0.125, 0.0, None, True)
            kernel = bwd(*diff, const, g, out, stats, None, 0.125)
            plain = ref_bwd(*diff, const, g, 0.125)
            xs = [x.detach().requires_grad_() for x in diff]
            auto = torch.autograd.grad(ref(*xs, const, 0.125), xs, g)
            rows.append({"family": family, "value_spread": spread,
                         "kernel_vs_float64": rel_err(kernel, truth),
                         "plain_vs_float64": rel_err(plain, truth),
                         "autograd_vs_float64": rel_err(auto, truth),
                         "kernel_vs_plain": rel_err(kernel, [p.double() for p in plain]),
                         "kernel_vs_float64_by_grad": dict(zip(("dq", "dk", "dv"),
                                                               rel_errs(kernel, truth))),
                         "plain_vs_float64_by_grad": dict(zip(("dq", "dk", "dv"),
                                                              rel_errs(plain, truth)))})
    print(json.dumps({"rows": rows}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
