"""Attention masks: boolean ``allowed`` (True = may attend) and their additive
bias form. NEG_INF is a large negative number, not -inf, so a fully masked row
stays finite (`streamspeech_tpu/models/layers.py:37`)."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e9


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """[B] lengths → [B, max_len] bool, True where the position is valid."""
    r = torch.arange(max_len, device=lengths.device)
    return r[None, :] < lengths[:, None]


def causal_allowed(t: int, device=None) -> torch.Tensor:
    """[t, t] bool; query i may attend keys j <= i."""
    i = torch.arange(t, device=device)
    return i[None, :] <= i[:, None]


def chunk_allowed(t: int, chunk_size: int, device=None) -> torch.Tensor:
    """[t, t] bool; frame i attends every frame of its own and earlier chunks
    (`researches/chunk_unity/models/s2t_conformer.py:195-213`)."""
    chunk_size = max(int(chunk_size), 1)
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    idx = torch.clamp((i // chunk_size + 1) * chunk_size, 1, t)
    return j < idx


def mask_to_bias(allowed: Optional[torch.Tensor],
                 key_valid: Optional[torch.Tensor] = None
                 ) -> Optional[torch.Tensor]:
    """allowed: bool [S, T], [B, S, T] or [B, 1, S, T]; key_valid: [B, T] or [T]
    bool. Returns an additive float32 bias broadcastable to [B, H, S, T], or None
    (`streamspeech_tpu/models/layers.py:171-189`)."""
    bias = None
    if allowed is not None:
        a = allowed
        if a.dim() == 2:
            a = a[None, None]
        elif a.dim() == 3:
            a = a[:, None]
        bias = torch.where(a, 0.0, NEG_INF).to(torch.float32)
    if key_valid is not None:
        kv = key_valid if key_valid.dim() == 2 else key_valid[None]
        b2 = torch.where(kv[:, None, None, :], 0.0, NEG_INF).to(torch.float32)
        bias = b2 if bias is None else bias + b2
    return bias
