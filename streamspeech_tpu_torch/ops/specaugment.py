"""SpecAugment, the train-time feature transform (``streamspeech_tpu/ops/
specaugment.py``; fairseq's `feature_transforms/specaugment.py` with the
config_gcmvn.yaml values: one frequency mask of up to F=27 bins, one time mask
of up to T=100 frames, p=1.0, no warp, fill 0.0).

The random draws (``specaugment_draws``, from an explicit ``torch.Generator``)
are split from the masking (``specaugment_apply``), so the apply can be held
against the JAX semantics on the same draws. The draws keep JAX's bounds,
``maximum(..., 1)`` guards included (`specaugment.py:36-46`); the random
stream itself cannot match JAX's.
"""

from __future__ import annotations

from typing import Dict

import torch


def _randint(generator: torch.Generator, high: torch.Tensor) -> torch.Tensor:
    """Uniform integers in [0, high) per element of ``high`` (>= 1)."""
    u = torch.rand(high.shape, generator=generator, device=high.device)
    return torch.minimum((u * high).long(), high - 1)   # u * high may round up to high


def specaugment_draws(generator: torch.Generator, lengths: torch.Tensor, f_dim: int,
                      freq_mask_n: int = 1, freq_mask_f: int = 27,
                      time_mask_n: int = 1, time_mask_t: int = 100,
                      time_mask_p: float = 1.0) -> Dict[str, torch.Tensor]:
    """Mask widths and starts for a batch with valid ``lengths`` [B], drawn on
    the generator's device: ``f``, ``f0`` [B, freq_mask_n] with f in
    [0, freq_mask_f] and f0 in [0, max(f_dim - f, 1)); ``t``, ``t0``
    [B, time_mask_n] with t in [0, max(min(time_mask_t, int(length·p)), 1)]
    and t0 in [0, max(length - t, 1))."""
    b = lengths.shape[0]
    dev = lengths.device
    lengths = lengths.long()
    f = _randint(generator, torch.full((b, freq_mask_n), freq_mask_f + 1, device=dev))
    f0 = _randint(generator, torch.clamp(f_dim - f, min=1))
    max_t = torch.clamp((lengths.float() * time_mask_p).long(), max=time_mask_t)
    t_high = torch.clamp(max_t, min=1)[:, None].expand(b, time_mask_n) + 1
    t = _randint(generator, t_high)
    t0 = _randint(generator, torch.clamp(lengths[:, None] - t, min=1))
    return {"f": f, "f0": f0, "t": t, "t0": t0}


def specaugment_apply(x: torch.Tensor, draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """x [B, T, F] with the drawn frequency masks, then time masks, set to 0.0."""
    freq = torch.arange(x.shape[2], device=x.device)[None, None, :]
    f0, f = draws["f0"][:, :, None], draws["f"][:, :, None]
    fmask = ((freq >= f0) & (freq < f0 + f)).any(dim=1)              # [B, F]
    time = torch.arange(x.shape[1], device=x.device)[None, None, :]
    t0, t = draws["t0"][:, :, None], draws["t"][:, :, None]
    tmask = ((time >= t0) & (time < t0 + t)).any(dim=1)              # [B, T]
    x = torch.where(fmask[:, None, :], torch.zeros_like(x), x)
    return torch.where(tmask[:, :, None], torch.zeros_like(x), x)
