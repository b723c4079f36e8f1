"""Where the kernel train route's card gradients leave the CPU's, and why.

    python3 tools/check_torch_train_precision.py [steps] [witness] [replay]

On ``chip_smoke.py``'s ``train_kernels_reference`` step (``full_config``
widths, a 2-layer encoder, dropout 0, B=2), three parts, all by default, one
JSON line each, then the card's name and power limit:

- ``steps``: the step on the card against the CPU's on the kernel route, on the
  default route, and with one attention family alone on the kernel route (the
  others on their plain route): whose kernels the difference comes through.
- ``witness``: the unit decoder's causal attention alone exchanged for its
  plain version run in float64, on the card and on the CPU, and its forward or
  its backward alone exchanged (float64, plain fp32): whether the kernels or
  the CPU's plain version stand further from the exact attention, and whether
  through the forward or the backward.
- ``replay``: the causal backward kernel on the very tensors the card step
  hands it (both unit-decoder layers): the kernel's gradients, the plain fp32
  backward's, and the kernel's own when given the output or the row statistics
  of a float64 forward, each against the plain backward in float64.

For each pair of steps: the gradient tensors further than 1e-3·max|g_ref| +
1e-7 apart, with their distance over max|g_ref| and the two rows furthest off
(a ReLU unit that switched at one position shows as one row of its layer's
weight and one element of its bias), how many are past 3e-4, the worst tensor,
the distance of grad_norm, and the verdict of ``chip_smoke.py``'s row rule
(the ReLU ties' rows it leaves out, the worst distance that remains). Needs a
CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from streamspeech_tpu_torch.kernels import attention as A  # noqa: E402


def distances(got, want):
    """max|got - want| less chip_smoke's 1e-7 floor (a gradient that is zero in
    exact arithmetic, as a key projection's bias, is all rounding), over
    max|want|."""
    return {n: max(float((got[n] - w).abs().max()) - 1e-7, 0.0)
            / max(float(w.abs().max()), 1e-30) for n, w in want.items()}


def _rows(got, want):
    """The two rows (first axis) of a tensor furthest off, with their distance
    over max|want|: a ReLU unit that switched at one position shows as one row
    of its layer's weight and one element of its bias."""
    d = (got - want).abs().reshape(want.shape[0], -1).max(dim=1).values
    top = torch.topk(d, min(2, d.numel()))
    scale = max(float(want.abs().max()), 1e-30)
    return {"rows": top.indices.tolist(), "distance": [float(x) / scale for x in top.values]}


def summary(got, want):
    """The pair's distances, and the verdict of ``chip_smoke.py``'s row rule
    (``_grad_check`` with the ReLU ties of the ``want`` step): the rows it
    leaves out, the tensors still past their tolerance, the worst remaining
    distance."""
    (m, g, _, _, _), (ref_m, ref_g, _, _, ties) = got, want
    d = distances(g, ref_g)
    worst = max(d, key=d.get)
    errs, left_out = chip_smoke._grad_check(g, ref_g, ties)
    held = {n: e / max(float(ref_g[n].abs().max()), 1e-30) for n, (e, _) in errs.items()}
    worst_held = max(held, key=held.get)
    return {"past_1e-3": {n: {"distance": e, "furthest": _rows(g[n], ref_g[n])}
                          for n, e in sorted(d.items()) if e > 1e-3},
            "past_3e-4": sum(e > 3e-4 for e in d.values()), "tensors": len(d),
            "worst": [worst, d[worst]],
            "grad_norm_rel": abs(m["grad_norm"] - ref_m["grad_norm"]) / ref_m["grad_norm"],
            "row_rule": {"ties": sum(len(u) for u in ties.values()),
                         "rows_left_out": left_out,
                         "units_left_out": len({(r["tensor"].rsplit(".", 1)[0], r["row"])
                                                for r in left_out}),
                         "past_tolerance": [n for n, (e, tol) in errs.items() if e > tol],
                         "worst_remaining": [worst_held, held[worst_held]]}}


def _rel(got, want):
    return [float((a.double() - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            for a, w in zip(got, want)]


def causal_calls_against_float64():
    """The card step's causal backward calls, replayed on their own inputs."""
    calls = []
    real = A.masked_attention_backward

    def recording(*args):
        calls.append(args)
        return real(*args)
    A.masked_attention_backward = recording
    try:
        chip_smoke._reference_step("cuda", kernel_attention=True)
    finally:
        A.masked_attention_backward = real
    rows = []
    for q, k, v, kvb, g, out, stats, seed, scale, rate in calls:
        q64, k64, v64, kvb64, g64 = (x.double() for x in (q, k, v, kvb, g))
        truth = A.masked_attention_backward_reference(q64, k64, v64, kvb64, g64, scale)
        out64 = A.masked_attention_reference(q64, k64, v64, kvb64, scale)
        t = q.shape[2]
        i = torch.arange(t, device=q.device)
        s64 = torch.einsum("bhsd,bhtd->bhst", q64, k64) * scale + kvb64[:, :, None, :] \
            + torch.where(i[:, None] >= i[None, :], 0.0, A.NEG_INF).double()
        mx = s64.max(-1).values
        stats64 = torch.stack([mx, 1.0 / torch.exp(s64 - mx[..., None]).sum(-1)], -1)
        valid = int((kvb[0, 0] == 0).sum())
        vv = v.detach()[:, :, :valid]
        spread = float(vv.std(dim=2).mean() / vv.abs().mean())
        rows.append({
            "shape": list(q.shape), "valid_keys": valid, "value_std_over_keys_rel": spread,
            "names": ["dq", "dk", "dv"],
            "kernel": _rel(real(q, k, v, kvb, g, out, stats, seed, scale, rate), truth),
            "plain_fp32": _rel(A.masked_attention_backward_reference(q, k, v, kvb, g, scale),
                               truth),
            "kernel_given_float64_out": _rel(
                real(q, k, v, kvb, g, out64.float().contiguous(), stats, seed, scale, rate),
                truth),
            "kernel_given_float64_stats": _rel(
                real(q, k, v, kvb, g, out, stats64.float().contiguous(), seed, scale, rate),
                truth),
            "forward_kernel_out": _rel([out], [out64])[0],
            "forward_plain_fp32_out": _rel(
                [A.masked_attention_reference(q, k, v, kvb, scale)], [out64])[0]})
    return rows


def _f64(fn, *tensors_then_rest, n):
    """``fn`` on the first ``n`` arguments cast to float64, results cast back."""
    args = [x.double() if i < n else x for i, x in enumerate(tensors_then_rest)]
    out = fn(*args)
    if isinstance(out, tuple):
        return tuple(o.float().contiguous() for o in out)
    return out.float().contiguous()


def causal_witness():
    """The step with the unit decoder's causal attention alone exchanged: its
    forward and backward computed in float64 by the plain versions (on the card
    and on the CPU), its forward alone plain fp32, its backward alone plain
    fp32 (on the card). Each pair's distance says whose causal attention, the
    kernels' or the CPU's plain version, stands further from the exact one."""
    real_fwd, real_bwd = A.masked_attention_forward, A.masked_attention_backward

    def exact_fwd(q, k, v, kvb, scale, rate=0.0, seed=None, want_stats=False):
        _, stats = real_fwd(q, k, v, kvb, scale, rate, seed, want_stats)
        return _f64(A.masked_attention_reference, q, k, v, kvb, scale, n=4), stats

    def exact_bwd(q, k, v, kvb, g, out, stats, seed, scale, rate=0.0):
        return _f64(A.masked_attention_backward_reference, q, k, v, kvb, g, scale, n=5)

    def plain_fwd(q, k, v, kvb, scale, rate=0.0, seed=None, want_stats=False):
        _, stats = real_fwd(q, k, v, kvb, scale, rate, seed, want_stats)
        return A.masked_attention_reference(q, k, v, kvb, scale), stats

    def plain_bwd(q, k, v, kvb, g, out, stats, seed, scale, rate=0.0):
        return A.masked_attention_backward_reference(q, k, v, kvb, g, scale)

    def step(device, fwd=real_fwd, bwd=real_bwd):
        A.masked_attention_forward, A.masked_attention_backward = fwd, bwd
        try:
            return chip_smoke._reference_step(device, kernel_attention=True)
        finally:
            A.masked_attention_forward, A.masked_attention_backward = real_fwd, real_bwd

    card, cpu = step("cuda"), step("cpu")
    exact_card, exact_cpu = step("cuda", exact_fwd, exact_bwd), step("cpu", exact_fwd,
                                                                     exact_bwd)
    return {"card_kernels_vs_card_exact_causal": summary(card, exact_card),
            "cpu_plain_vs_cpu_exact_causal": summary(cpu, exact_cpu),
            "card_exact_causal_vs_cpu_exact_causal": summary(exact_card, exact_cpu),
            "card_plain_forward_kernel_backward_vs_card_exact": summary(
                step("cuda", fwd=plain_fwd), exact_card),
            "card_kernel_forward_plain_backward_vs_card_exact": summary(
                step("cuda", bwd=plain_bwd), exact_card),
            "card_exact_forward_kernel_backward_vs_card_exact": summary(
                step("cuda", fwd=exact_fwd), exact_card),
            "card_kernel_forward_exact_backward_vs_card_exact": summary(
                step("cuda", bwd=exact_bwd), exact_card)}


# which modules stay on the kernel route when a family runs alone
FAMILIES = {"relpos": lambda name: name.startswith("encoder."),
            "causal": lambda name: name.startswith("unit_decoder.")
            and name.endswith("self_attn"),
            "bias": lambda name: name.startswith("unit_decoder.")
            and name.endswith("encoder_attn")}


def steps():
    card = chip_smoke._reference_step("cuda", kernel_attention=True)
    cpu = chip_smoke._reference_step("cpu", kernel_attention=True)
    out = {"card_vs_cpu": summary(card, cpu),
           "default_route_card_vs_cpu": summary(chip_smoke._reference_step("cuda"),
                                                chip_smoke._reference_step("cpu"))}
    real_setup = chip_smoke._train_setup
    for family, keeps in FAMILIES.items():
        def setup(*args, keeps=keeps, **kw):
            model, step, state = real_setup(*args, **kw)
            for name, module in model.named_modules():
                if hasattr(module, "kernel_train"):
                    module.kernel_train = keeps(name)
            return model, step, state
        chip_smoke._train_setup = setup
        try:
            out[f"card_{family}_alone_vs_cpu"] = summary(
                chip_smoke._reference_step("cuda", kernel_attention=True), cpu)
        finally:
            chip_smoke._train_setup = real_setup
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("check_torch_train_precision: needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parts = {"steps": steps, "witness": causal_witness,
             "replay": causal_calls_against_float64}
    for name in sys.argv[1:] or list(parts):
        print(json.dumps({name: parts[name]()}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
