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


def waitk_allowed(tgt_len: int, src_len: int, src_wait: int, src_step: int,
                  tgt_step: int, device=None) -> torch.Tensor:
    """[tgt_len, src_len] bool wait-k cross-attention mask
    (`streamspeech_tpu/ops/masks.py:43-61`): target i may read sources
    j < clamp((i // tgt_step + 1) * src_step + src_wait, 1, src_len). A negative
    ``src_step`` (or a non-positive ``tgt_step``) allows everything."""
    if src_step < 0 or tgt_step <= 0:
        return torch.ones((tgt_len, src_len), dtype=torch.bool, device=device)
    i = torch.arange(tgt_len, device=device)[:, None]
    j = torch.arange(src_len, device=device)[None, :]
    idx = torch.clamp((i // tgt_step + 1) * src_step + src_wait, 1, src_len)
    return j < idx


def streaming_allowed_from_ctc(asr_not_blank: torch.Tensor,
                               st_not_blank: torch.Tensor, tgt_len: int,
                               src_wait: int, src_step: int, tgt_step: int,
                               chunk_size: Optional[int]) -> torch.Tensor:
    """[B, tgt_len, src_len] bool training mask from the aux-CTC not-blank
    posteriors [B, src_len] (`streamspeech_tpu/ops/masks.py:64-103`, reference
    `streamspeech_model.py:398-415`): target i reads up to the first frame where
    the ST cumsum reaches (i // tgt_step + 1) * src_step + src_wait and the
    rounded ASR posterior is 1 (first-max argmax, last column forced to 1),
    rounded up to the encoder chunk. ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    src_len = st_not_blank.shape[1]
    dev = st_not_blank.device
    i = torch.arange(tgt_len, device=dev)[None, :, None]
    idx = torch.clamp((i // tgt_step + 1) * src_step + src_wait, 1, src_len)
    cum = torch.cumsum(st_not_blank, dim=-1)[:, None, :]          # [B, 1, src]
    tmp2 = (cum >= idx).to(torch.int32) * torch.round(asr_not_blank)[:, None, :].to(
        torch.int32)
    tmp2[:, :, -1] = 1
    # torch.argmax returns the first maximal index, as jnp.argmax does
    idx2 = torch.clamp(torch.argmax(tmp2, dim=-1)[..., None], 1, src_len)
    if chunk_size is not None:
        idx2 = torch.clamp((idx2 // chunk_size + 1) * chunk_size, 1, src_len)
    j = torch.arange(src_len, device=dev)[None, None, :]
    return j < idx2


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
