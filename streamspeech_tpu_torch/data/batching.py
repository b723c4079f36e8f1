"""Token-bucket batching over the native C++ batcher (the port of
``streamspeech_tpu/data/batching.py``).

Equivalent of fairseq's `batch_by_size` (`fairseq/fairseq/data/data_utils_fast.pyx`):
``native/batcher.cpp`` is built by ``native.py`` into ``build/native/`` at
first use and called through ctypes. A failed build raises; there is no
silent fallback. ``_batch_by_size_py`` is the plain version the tests hold the
library against.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from streamspeech_tpu_torch import native

_P64 = ctypes.POINTER(ctypes.c_int64)


def _library() -> ctypes.CDLL:
    lib = native.load("batcher")
    lib.batch_by_size.restype = ctypes.c_int64
    lib.batch_by_size.argtypes = [_P64, _P64, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64, _P64]
    return lib


def batch_by_size(
    indices: np.ndarray,
    num_tokens: np.ndarray,
    max_tokens: int = 0,
    max_sentences: int = 0,
    bsz_mult: int = 8,
) -> List[np.ndarray]:
    """indices: ordering to pack (e.g. length-sorted); num_tokens: per-INDEX token
    counts (indexed by the values in `indices`). Returns a list of index arrays."""
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    num_tokens = np.ascontiguousarray(num_tokens, dtype=np.int64)
    n = len(indices)
    if n == 0:
        return []
    offsets = np.zeros(n + 1, dtype=np.int64)
    nb = _library().batch_by_size(
        indices.ctypes.data_as(_P64), num_tokens.ctypes.data_as(_P64), n, max_tokens,
        max_sentences, max(bsz_mult, 1), offsets.ctypes.data_as(_P64))
    return [indices[offsets[i]:offsets[i + 1]] for i in range(nb)]


def _batch_by_size_py(indices, num_tokens, max_tokens, max_sentences, bsz_mult):
    batches = []
    start = 0
    batch_max = 0
    i = 0
    while i < len(indices):
        tok = int(num_tokens[indices[i]])
        new_max = max(batch_max, tok)
        count = i - start + 1
        full = ((max_sentences > 0 and count == max_sentences) or
                (max_tokens > 0 and count * new_max > max_tokens))
        if full and count > 0:
            size = i - start
            mod = size % bsz_mult
            if size > bsz_mult and mod != 0:
                size -= mod
            if size == 0:
                size = max(i - start, 1)
            batches.append(indices[start:start + size])
            start += size
            batch_max = int(max(num_tokens[indices[start:i + 1]])) if start <= i \
                else 0
        else:
            batch_max = new_max
        i += 1
    if start < len(indices):
        batches.append(indices[start:])
    return batches
