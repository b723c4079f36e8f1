"""CTC not-blank posterior: the CUDA kernel's wrapper and its plain version.

``not_blank_probs`` replaces the TPU kernel ``not_blank_probs_pallas``
(`streamspeech_tpu/ops/pallas_policy.py:99`, body ``_nb_kernel`` :69). For a
CPU tensor it computes ``not_blank_probs_reference``; for a CUDA tensor it
launches ``csrc/not_blank.cu`` or raises. There is no fallback. Logits are
float32 or bfloat16 (a bf16 model's CTC heads), widened to fp32 inside the
kernel as the TPU kernel widens them (:76); the launches of each form are
counted apart (``launches``, ``bf16_launches``).
"""

from __future__ import annotations

import ctypes

import torch

from streamspeech_tpu_torch.kernels import build

NB_KERNEL_MIN_T = 64    # the TPU gate (`pallas_policy.py:53-66`): t >= 64, v >= 512
NB_KERNEL_MIN_V = 512
_ARGS = (ctypes.c_void_p,) * 2 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
_NOT_BLANK = {torch.float32: ("not_blank", "not_blank_probs_f32", _ARGS),
              torch.bfloat16: ("not_blank", "not_blank_probs_bf16", _ARGS)}


def nb_kernel_ok(t: int, v: int) -> bool:
    """The TPU route's shape gate, ``nb_pallas_ok`` less its backend test."""
    return t >= NB_KERNEL_MIN_T and v >= NB_KERNEL_MIN_V


def not_blank_probs_reference(logits: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """Plain PyTorch version (`streamspeech.py:41-67` ``ctc_not_blank_probs``):
    logits [B, T, V] → P(a new token at frame t) [B, T] float32,
    1 - p_t[blank] - (p_t · p_{t-1} - p_t[blank] p_{t-1}[blank]), p_{-1} = 0."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    blank_p = probs[:, :, blank]
    dot = torch.einsum("btv,btv->bt", probs[:, 1:], probs[:, :-1])
    dot = torch.nn.functional.pad(dot, (1, 0))
    prev_blank = torch.nn.functional.pad(blank_p[:, :-1], (1, 0))
    return 1.0 - ((dot - blank_p * prev_blank) + blank_p)


def not_blank_probs(logits: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """logits [B, T, V] float32 or bfloat16, contiguous → [B, T] float32, no
    gradient."""
    logits = logits.detach()
    if not build.on_card(logits, "not_blank_probs"):
        return not_blank_probs_reference(logits, blank)
    if logits.dim() != 3 or logits.dtype not in _NOT_BLANK or not logits.is_contiguous():
        raise ValueError("logits must be a contiguous float32 or bfloat16 [B, T, V] "
                         f"tensor, got {logits.dtype} {tuple(logits.shape)}")
    b, t, v = logits.shape
    if not 0 <= blank < v:
        raise ValueError(f"blank {blank} outside the vocabulary of {v}")
    out = torch.empty((b, t), dtype=torch.float32, device=logits.device)
    build.launch(_NOT_BLANK[logits.dtype], logits.device, logits.data_ptr(), out.data_ptr(),
                 b, t, v, int(blank))
    if logits.dtype == torch.bfloat16:
        not_blank_probs.bf16_launches += 1
    else:
        not_blank_probs.launches += 1
    return out


not_blank_probs.launches = not_blank_probs.bf16_launches = 0
