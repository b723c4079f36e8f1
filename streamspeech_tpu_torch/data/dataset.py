"""Audio references of a manifest or a wav list (``streamspeech_tpu/data/
dataset.py:32-56``, ``load_audio_or_features``). The rest of that module, the
speech-to-speech dataset and its collation, is not ported yet (ROADMAP §A
item 5)."""

from __future__ import annotations

import io
import wave
from pathlib import Path
from typing import Optional

import numpy as np


def load_audio_or_features(ref: str, root: Optional[Path] = None) -> np.ndarray:
    """A reference → a waveform (float32 in [-1, 1)) or a [T, 80] feature
    array: ``path.wav`` (16-bit PCM through ``wave``), ``path.npy``, or
    ``archive.zip:offset:size`` (fairseq's zip packing of .npy blobs). A
    relative path is taken under ``root``."""
    if ":" in ref and not Path(ref).exists():
        parts = ref.rsplit(":", 2)
        if len(parts) == 3 and parts[1].isdigit() and parts[2].isdigit():
            zip_path, offset, size = Path(parts[0]), int(parts[1]), int(parts[2])
            if root is not None and not zip_path.is_absolute():
                zip_path = root / zip_path
            with open(zip_path, "rb") as f:
                f.seek(offset)
                data = f.read(size)
            return np.load(io.BytesIO(data), allow_pickle=False)
    p = Path(ref)
    if root is not None and not p.is_absolute():
        p = root / p
    if p.suffix == ".npy":
        return np.load(p, allow_pickle=False)
    if p.suffix == ".wav":
        with wave.open(str(p), "rb") as f:
            pcm = np.frombuffer(f.readframes(f.getnframes()), dtype="<i2")
        return pcm.astype(np.float32) / 32768.0
    raise ValueError(f"unsupported audio reference: {ref}")
