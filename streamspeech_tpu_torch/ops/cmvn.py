"""Global CMVN (`fairseq/fairseq/data/audio/feature_transforms/global_cmvn.py`):
subtract the stored mean and divide by the stored std. Host-side numpy, applied
per segment before the features go to the card."""

from __future__ import annotations

import numpy as np


class GlobalCMVN:
    def __init__(self, mean: np.ndarray, std: np.ndarray):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    @classmethod
    def from_npz(cls, path: str) -> "GlobalCMVN":
        """The statistics of a ``gcmvn.npz`` (keys ``mean`` and ``std``,
        `ops/cmvn.py:24`)."""
        stats = np.load(path)
        return cls(stats["mean"], stats["std"])

    def __call__(self, x) -> np.ndarray:
        return (np.asarray(x) - self.mean) / self.std
