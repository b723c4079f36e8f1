"""CTC alpha/beta dynamic program: the CUDA kernels' wrappers, their plain
versions, and the loss's ``torch.autograd.Function``
(``streamspeech_tpu/ops/pallas_ctc.py``).

- ``ctc_alpha``: the alpha recursion over T, every alpha written; replaces the
  TPU kernel ``_run_alpha`` (`pallas_ctc.py:108`, body ``_alpha_kernel`` :66);
  ``csrc/ctc.cu`` ``ctc_alpha_f32``.
- ``ctc_beta_grad``: the beta recursion over reversed T with the occupancy
  gradient d nll / d lp_ext = -exp(min(alpha + beta - logZ, 0)) fused in;
  replaces ``_run_beta_grad`` (`pallas_ctc.py:127`, body ``_beta_kernel`` :83);
  ``csrc/ctc.cu`` ``ctc_beta_grad_f32``.

For CPU tensors each wrapper computes its ``*_reference``; for CUDA tensors it
launches its kernel or raises. There is no fallback. Each counts its launches.
On the card each call is one launch of a thread-block cluster per batch row,
the row's states cut into slices over the cluster's blocks (``cluster_plan``
gives the cut; ``csrc/ctc.cu`` says how the slices hand their boundary states
over).

Everything is expressed through additive fp32 masks (0 or ``NNEG``), as in
the TPU kernels: ``skipmask``/``initmask``/``endmask`` [B, S] and
``validmask`` [B, T] (1.0 real frame, 0.0 padding: the state holds). Unlike
the TPU, nothing is padded to tiles: the kernels take any B, T and S up to
``MAX_STATES``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from streamspeech_tpu_torch.kernels import build
from streamspeech_tpu_torch.ops.ctc import (
    NNEG,
    gather_extended_logprobs_from_logits,
    lse3,
)

MAX_STATES = 4096  # `csrc/ctc.cu` kMaxStates: at most 16 blocks a cluster

_P, _I = ctypes.c_void_p, ctypes.c_int
_ALPHA = ("ctc", "ctc_alpha_f32", (_P,) * 5 + (_I,) * 3 + (_P,))
_BETA = ("ctc", "ctc_beta_grad_f32", (_P,) * 7 + (_I,) * 3 + (_P,))
_PLAN_KEYS = ("cluster_size", "states_per_block", "states_per_lane", "warps_per_block",
              "ring_slots", "frames_ahead", "frames_per_handover")


def _shift_right(a: torch.Tensor, k: int) -> torch.Tensor:
    """out[:, s] = a[:, s-k], NNEG fill (`pallas_ctc.py:46-50`)."""
    if k >= a.shape[1]:
        return torch.full_like(a, NNEG)
    return F.pad(a[:, :a.shape[1] - k], (k, 0), value=NNEG)


def _shift_left(a: torch.Tensor, k: int) -> torch.Tensor:
    """out[:, s] = a[:, s+k], NNEG fill at the top (`pallas_ctc.py:53-57`)."""
    if k >= a.shape[1]:
        return torch.full_like(a, NNEG)
    return F.pad(a[:, k:], (0, k), value=NNEG)


def ctc_alpha_reference(lp_ext: torch.Tensor, initmask: torch.Tensor,
                        skipmask: torch.Tensor, validmask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``_alpha_kernel`` (`pallas_ctc.py:66-80`):
    lp_ext [B, T, S] → alpha [B, T, S]; frame 0 takes ``initmask + lp_0``,
    a padded frame holds the previous alpha."""
    a = initmask + lp_ext[:, 0]
    out = [a]
    for t in range(1, lp_ext.shape[1]):
        new = lse3(a, _shift_right(a, 1), _shift_right(a, 2) + skipmask) + lp_ext[:, t]
        a = torch.where(validmask[:, t, None] > 0, new, a)
        out.append(a)
    return torch.stack(out, dim=1)


def ctc_beta_grad_reference(lp_ext: torch.Tensor, endmask: torch.Tensor,
                            skipmask: torch.Tensor, zbias: torch.Tensor,
                            validmask: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``_beta_kernel`` (`pallas_ctc.py:83-105`): the
    occupancy gradient d nll / d lp_ext [B, T, S], ``-exp(min(alpha + beta +
    zbias, 0))`` on valid frames and 0 on padded ones; zbias [B] is -logZ
    (NNEG for an impossible alignment, whose gradient is then exactly 0)."""
    beta = endmask
    out = [None] * lp_ext.shape[1]
    for t in range(lp_ext.shape[1] - 1, -1, -1):
        v = validmask[:, t, None] > 0
        gamma = torch.exp(torch.clamp(alpha[:, t] + beta + zbias[:, None], max=0.0))
        out[t] = torch.where(v, -gamma, torch.zeros_like(gamma))
        q = beta + lp_ext[:, t]
        new = lse3(q, _shift_left(q, 1), _shift_left(q + skipmask, 2))
        beta = torch.where(v, new, beta)
    return torch.stack(out, dim=1)


def _check(lp_ext, masks: Sequence[Tuple[str, torch.Tensor, tuple]]):
    if lp_ext.dim() != 3:
        raise ValueError(f"lp_ext must be [B, T, S], got {tuple(lp_ext.shape)}")
    b, t, s = lp_ext.shape
    if t < 1 or not 1 <= s <= MAX_STATES:
        raise ValueError(f"lp_ext [B, T, S] needs T >= 1 and 1 <= S <= {MAX_STATES}, "
                         f"got {tuple(lp_ext.shape)}")
    for name, x, shape in (("lp_ext", lp_ext, (b, t, s)),) + tuple(masks):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.device != lp_ext.device:
            raise ValueError(f"{name} is on {x.device}, lp_ext on {lp_ext.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ctc_alpha(lp_ext: torch.Tensor, initmask: torch.Tensor, skipmask: torch.Tensor,
              validmask: torch.Tensor) -> torch.Tensor:
    """All alphas [B, T, S] float32 of lp_ext [B, T, S], masks [B, S] and
    validmask [B, T], contiguous float32, S <= 4096."""
    if not build.on_card(lp_ext, "ctc_alpha"):
        return ctc_alpha_reference(lp_ext, initmask, skipmask, validmask)
    b, t, s = lp_ext.shape
    _check(lp_ext, (("initmask", initmask, (b, s)), ("skipmask", skipmask, (b, s)),
                    ("validmask", validmask, (b, t))))
    alpha = torch.empty_like(lp_ext)
    build.launch(_ALPHA, lp_ext.device, lp_ext.data_ptr(), initmask.data_ptr(),
                 skipmask.data_ptr(), validmask.data_ptr(), alpha.data_ptr(), b, t, s)
    ctc_alpha.launches += 1
    return alpha


def ctc_beta_grad(lp_ext: torch.Tensor, endmask: torch.Tensor, skipmask: torch.Tensor,
                  zbias: torch.Tensor, validmask: torch.Tensor,
                  alpha: torch.Tensor) -> torch.Tensor:
    """d nll / d lp_ext [B, T, S] float32 from the forward's alpha [B, T, S],
    masks [B, S], zbias [B] and validmask [B, T], contiguous float32."""
    if not build.on_card(lp_ext, "ctc_beta_grad"):
        return ctc_beta_grad_reference(lp_ext, endmask, skipmask, zbias, validmask, alpha)
    b, t, s = lp_ext.shape
    _check(lp_ext, (("endmask", endmask, (b, s)), ("skipmask", skipmask, (b, s)),
                    ("zbias", zbias, (b,)), ("validmask", validmask, (b, t)),
                    ("alpha", alpha, (b, t, s))))
    grad = torch.empty_like(lp_ext)
    build.launch(_BETA, lp_ext.device, lp_ext.data_ptr(), endmask.data_ptr(),
                 skipmask.data_ptr(), zbias.data_ptr(), validmask.data_ptr(),
                 alpha.data_ptr(), grad.data_ptr(), b, t, s)
    ctc_beta_grad.launches += 1
    return grad


ctc_alpha.launches = 0
ctc_beta_grad.launches = 0


def cluster_plan(s: int) -> Dict[str, int]:
    """How the kernels cut S states on the card (asks the built library):
    the cluster's size (blocks a batch row), states a block, states a lane,
    warps a block, the boundary ring's slots, the frames fetched ahead and the
    frames handed over at once."""
    if not 1 <= s <= MAX_STATES:
        raise ValueError(f"S must be in [1, {MAX_STATES}], got {s}")
    fn = build.bind("ctc", "ctc_cluster_plan", (_I, _P))
    out = (ctypes.c_int * len(_PLAN_KEYS))()
    if fn(s, ctypes.cast(out, ctypes.c_void_p)) != 0:
        raise RuntimeError(f"ctc_cluster_plan failed for S={s}")
    return dict(zip(_PLAN_KEYS, out))


def nll_from_alpha(alpha: torch.Tensor, endmask: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(-logZ, logZ) per row from the last frame's alpha (`pallas_ctc.py:150-155`)."""
    last = alpha[:, -1, :] + endmask
    m = torch.max(last, dim=-1).values
    logz = m + torch.log(torch.sum(torch.exp(last - m[:, None]), dim=-1))
    logz = torch.where(m <= NNEG / 2, torch.full_like(logz, NNEG), logz)
    return -logz, logz


class CTCNll(torch.autograd.Function):
    """Per-row CTC nll from extended-state log-probs, differentiable in lp_ext
    only: the counterpart of ``ctc_nll_pallas`` and its ``custom_vjp``
    (`pallas_ctc.py:158-188`). The forward launches ``ctc_alpha``, the backward
    ``ctc_beta_grad``; lp_ext, the masks, alpha and logZ are saved."""

    @staticmethod
    def forward(ctx, lp_ext, initmask, endmask, skipmask, validmask):
        alpha = ctc_alpha(lp_ext, initmask, skipmask, validmask)
        nll, logz = nll_from_alpha(alpha, endmask)
        ctx.save_for_backward(lp_ext, endmask, skipmask, validmask, alpha, logz)
        return nll

    @staticmethod
    def backward(ctx, ct):
        lp_ext, endmask, skipmask, validmask, alpha, logz = ctx.saved_tensors
        zbias = torch.where(logz > NNEG / 2, -logz, torch.full_like(logz, NNEG))
        ndlp = ctc_beta_grad(lp_ext, endmask, skipmask, zbias.contiguous(), validmask,
                             alpha)
        return ndlp * ct[:, None, None], None, None, None, None


def ext_and_masks(logits: torch.Tensor, logit_lengths: torch.Tensor,
                  labels: torch.Tensor, label_lengths: torch.Tensor,
                  blank_id: int) -> Dict[str, torch.Tensor]:
    """One head's DP inputs (`pallas_ctc.py:204-234`): lp_ext [B, T, S] and the
    additive fp32 masks [B, S], with the frame validity [B, T]."""
    b, t, _ = logits.shape
    n = labels.shape[1]
    s = 2 * n + 1
    dev = logits.device
    lbl_prev = torch.cat([torch.full_like(labels[:, :1], -1), labels[:, :-1]], dim=1)
    skip = torch.zeros((b, s), dtype=torch.bool, device=dev)
    skip[:, 1::2] = labels != lbl_prev
    lp_ext = gather_extended_logprobs_from_logits(logits, labels, blank_id)
    has_label = (label_lengths > 0)[:, None]
    sidx = torch.arange(s, device=dev)[None, :]
    end = 2 * label_lengths[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    nneg = torch.full((), NNEG, dtype=torch.float32, device=dev)
    initmask = torch.where((sidx == 0) | ((sidx == 1) & has_label), zero, nneg)
    endmask = torch.where((sidx == end) | ((sidx == end - 1) & has_label), zero, nneg)
    skipmask = torch.where(skip, zero, nneg)
    validmask = (torch.arange(t, device=dev)[None, :]
                 < logit_lengths[:, None]).to(torch.float32)
    return {"lp_ext": lp_ext, "initmask": initmask, "endmask": endmask,
            "skipmask": skipmask, "validmask": validmask}


def _run(parts: Dict[str, torch.Tensor]) -> torch.Tensor:
    return CTCNll.apply(parts["lp_ext"].contiguous(), parts["initmask"].contiguous(),
                        parts["endmask"].contiguous(), parts["skipmask"].contiguous(),
                        parts["validmask"].contiguous())


def ctc_neg_log_likelihood_kernel(logits: torch.Tensor, logit_lengths: torch.Tensor,
                                  labels: torch.Tensor, label_lengths: torch.Tensor,
                                  blank_id: int) -> torch.Tensor:
    """Per-row CTC -log p(labels | logits) [B] through the alpha/beta kernels
    (`pallas_ctc.py:275-288`): logits [B, T, V], labels [B, N] (padded past
    each row's label length with any valid id)."""
    return _run(ext_and_masks(logits, logit_lengths, labels, label_lengths, blank_id))


def ctc_neg_log_likelihood_kernel_multi(heads, blank_id: int) -> List[torch.Tensor]:
    """One alpha and one beta launch over several heads that share the frame
    axis (`pallas_ctc.py:291-333`): each head's lp_ext and masks are padded to
    the common S with NNEG and concatenated on the batch axis. heads: sequence
    of (logits [B, T, Vh], logit_lengths, labels [B, Nh], label_lengths).
    Returns the per-row nll of each head."""
    parts = [ext_and_masks(lo, ll, la, ln, blank_id) for (lo, ll, la, ln) in heads]
    t = parts[0]["lp_ext"].shape[1]
    if any(p["lp_ext"].shape[1] != t for p in parts[1:]):
        raise ValueError("multi-head CTC requires a shared frame axis")
    s_common = max(p["lp_ext"].shape[2] for p in parts)

    def pad_s(a):
        return F.pad(a, (0, s_common - a.shape[-1]), value=NNEG)

    merged = {key: torch.cat([pad_s(p[key]) for p in parts], dim=0)
              for key in ("lp_ext", "initmask", "endmask", "skipmask")}
    merged["validmask"] = torch.cat([p["validmask"] for p in parts], dim=0)
    return list(torch.split(_run(merged), [p["lp_ext"].shape[0] for p in parts]))
