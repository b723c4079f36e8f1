"""Greedy-CTC path collapse, on the host and on the device
(`streamspeech_tpu/ops/ctc.py:222-259`)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def ctc_collapse(ids, blank: int, pad: Optional[int] = None
                 ) -> Tuple[List[int], List[int]]:
    """Returns (tokens, frame_indices): repeats removed keeping the FIRST frame
    of a run (`agent/ctc_decoder.py:67-89`), then blanks (and pad) removed."""
    tokens: List[int] = []
    index: List[int] = []
    prev = None
    for t, i in enumerate(np.asarray(ids).tolist()):
        if i != prev:
            prev = i
            if i != blank and (pad is None or i != pad):
                tokens.append(i)
                index.append(t)
    return tokens, index


def ctc_collapse_device(ids: torch.Tensor, blank: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape collapse on the tensor's own device: ids [..., T] →
    (tokens [..., T] left-packed with trailing ``blank`` fill, count [...])."""
    t = ids.shape[-1]
    prev = torch.cat([torch.full_like(ids[..., :1], -1), ids[..., :-1]], dim=-1)
    keep = (ids != prev) & (ids != blank)
    pos = torch.arange(t, device=ids.device)
    order = torch.where(keep, pos, t + pos)
    packed = torch.gather(ids, -1, torch.argsort(order, dim=-1))
    count = keep.sum(dim=-1)
    packed = torch.where(pos < count[..., None], packed,
                         torch.full_like(packed, blank))
    return packed, count
