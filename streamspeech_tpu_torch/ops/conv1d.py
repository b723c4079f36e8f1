"""1-D convolutions on batch-first ``[B, T, C]`` tensors with PyTorch weight
layouts, the counterparts of ``streamspeech_tpu/ops/conv1d.py``.

The JAX functions take ``[K, Cin, Cout]`` kernels; the weight bridge
(``weights.py``) permutes them to ``[Cout, Cin, K]`` for ``conv1d`` and to
``[Cin, Cout, K]`` for ``conv_transpose1d``. The transpose needs no kernel
flip: JAX's version flips internally, which is exactly what torch's
``conv_transpose1d`` already computes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv1d(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1,
           dilation: int = 1, padding: int = 0) -> torch.Tensor:
    """x [B, T, Cin], w [Cout, Cin, K] → [B, T', Cout]."""
    y = F.conv1d(x.transpose(1, 2), w, b, stride=stride, padding=padding,
                 dilation=dilation)
    return y.transpose(1, 2)


def conv_transpose1d(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1,
                     padding: int = 0) -> torch.Tensor:
    """x [B, T, Cin], w [Cin, Cout, K] → [B, (T-1)*stride - 2*padding + K, Cout]."""
    y = F.conv_transpose1d(x.transpose(1, 2), w, b, stride=stride,
                           padding=padding)
    return y.transpose(1, 2)
