"""Corpus BLEU-4 of token-id sequences through the native n-gram counter
(``native/bleu.cpp``, fairseq's libbleu equivalent), the train-time scorer of
``streamspeech_tpu/eval/bleu_native.py``. Reported scores come from
``eval/bleu.py`` on detokenized text, as the reference splits
``fairseq.libbleu`` and sacrebleu.

The library is built from ``native/bleu.cpp`` into ``build/native/`` at first
use (``native.py``); a failed build raises. ``add_plain`` is the same count
in Python, the plain version the tests hold the library against."""

from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Sequence

import numpy as np

from streamspeech_tpu_torch import native

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)


def _library():
    lib = native.load("bleu")
    lib.bleu_add_sentence.argtypes = [_I32P, ctypes.c_int64, _I32P, ctypes.c_int64, _I64P]
    lib.bleu_add_sentence.restype = None
    return lib


class BleuScorer:
    """counts: [match_n, total_n for n = 1..4, ref_len, hyp_len], summed over
    the sentences added."""

    def __init__(self):
        self.counts = np.zeros(10, dtype=np.int64)
        self._lib = _library()

    def add(self, ref: Sequence[int], hyp: Sequence[int]) -> None:
        ref = np.ascontiguousarray(ref, dtype=np.int32)
        hyp = np.ascontiguousarray(hyp, dtype=np.int32)
        self._lib.bleu_add_sentence(ref.ctypes.data_as(_I32P), len(ref),
                                    hyp.ctypes.data_as(_I32P), len(hyp),
                                    self.counts.ctypes.data_as(_I64P))

    def add_plain(self, ref: Sequence[int], hyp: Sequence[int]) -> None:
        """``add`` in Python: clipped n-gram matches and totals, n = 1..4."""
        ref, hyp = [int(x) for x in ref], [int(x) for x in hyp]
        for n in range(1, 5):
            rg = Counter(tuple(ref[i:i + n]) for i in range(len(ref) - n + 1))
            hg = Counter(tuple(hyp[i:i + n]) for i in range(len(hyp) - n + 1))
            self.counts[2 * (n - 1)] += sum(min(c, rg[g]) for g, c in hg.items())
            self.counts[2 * (n - 1) + 1] += max(len(hyp) - n + 1, 0)
        self.counts[8] += len(ref)
        self.counts[9] += len(hyp)

    def score(self) -> float:
        """100 · BP · geometric mean of the four precisions; 0 where an order
        has no match or no n-gram."""
        log_p = 0.0
        for n in range(4):
            match, total = self.counts[2 * n], self.counts[2 * n + 1]
            if match == 0 or total == 0:
                return 0.0
            log_p += math.log(match / total)
        ref_len, hyp_len = self.counts[8], self.counts[9]
        bp = min(0.0, 1.0 - ref_len / hyp_len) if hyp_len > 0 else -math.inf
        return 100.0 * math.exp(log_p / 4.0 + bp)
