"""Sinusoidal position tables (numpy), the same tables as
``streamspeech_tpu/ops/pos_encoding.py``:

- fairseq SinusoidalPositionalEmbedding
  (`fairseq/fairseq/modules/sinusoidal_positional_embedding.py`);
- espnet RelPositionalEncoding (`fairseq/fairseq/modules/positional_encoding.py:66-130`).
"""

from __future__ import annotations

import math

import numpy as np


def sinusoidal_embedding(num_positions: int, dim: int,
                         padding_idx: int = 1) -> np.ndarray:
    """[num_positions + padding_idx + 1, dim]; position ids are offset by
    padding_idx + 1 and the padding row is zero."""
    half = dim // 2
    emb = math.log(10000.0) / (half - 1)
    freqs = np.exp(np.arange(half, dtype=np.float32) * -emb)
    n = num_positions + padding_idx + 1
    pos = np.arange(n, dtype=np.float32)[:, None] * freqs[None, :]
    table = np.concatenate([np.sin(pos), np.cos(pos)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((n, 1), np.float32)], axis=1)
    table[padding_idx, :] = 0.0
    return table.astype(np.float32)


def rel_pos_encoding(max_len: int, dim: int) -> np.ndarray:
    """[2*max_len - 1, dim] over relative positions r = max_len-1 ... -(max_len-1):
    row u holds r = (max_len - 1) - u, pe[2k] = sin(r·div_k), pe[2k+1] = cos(|r|·div_k)."""
    div = np.exp(np.arange(0, dim, 2, dtype=np.float32)
                 * -(math.log(10000.0) / dim))
    r = (max_len - 1) - np.arange(2 * max_len - 1, dtype=np.float32)
    pe = np.zeros((2 * max_len - 1, dim), dtype=np.float32)
    pe[:, 0::2] = np.sin(r[:, None] * div[None, :])
    pe[:, 1::2] = np.cos(np.abs(r)[:, None] * div[None, :])
    return pe
