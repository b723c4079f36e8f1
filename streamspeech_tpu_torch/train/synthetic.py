"""Synthetic batches (``streamspeech_tpu/train/synthetic.py`` ``synthetic_batch``):
the same numpy draws from the same ``RandomState`` seed, so both packages see
identical batches. ``tiny_config`` and ``full_config`` live in ``config.py``."""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from streamspeech_tpu_torch.config import StreamSpeechConfig


def synthetic_batch(cfg: StreamSpeechConfig, batch: int = 4, frames: int = 64,
                    mt_len: int = 8, units_len: int = 12, text_len: int = 6,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    vt = cfg.mt_decoder.vocab_size
    vu = cfg.unit_decoder.vocab_size
    mt_prev = rng.randint(4, vt, size=(batch, mt_len)).astype(np.int32)
    mt_prev[:, 0] = 2  # eos-prefixed prev tokens (fairseq convention)
    mt_tgt = np.roll(mt_prev, -1, axis=1)
    mt_tgt[:, -1] = 2
    return {
        "src_tokens":
            rng.randn(batch, frames, cfg.encoder.input_feat_per_channel)
            .astype(np.float32),
        "src_lengths":
            rng.randint(frames // 2, frames + 1, size=(batch,)).astype(np.int32),
        "prev_output_tokens_mt": mt_prev,
        "mt_targets": mt_tgt,
        "target_units":
            rng.randint(4, vu - 1, size=(batch, units_len)).astype(np.int32),
        "target_unit_lengths": np.full((batch,), units_len, dtype=np.int32),
        "src_text":
            rng.randint(4, vt, size=(batch, text_len)).astype(np.int32),
        "src_text_lengths": np.full((batch,), text_len, dtype=np.int32),
        "tgt_text":
            rng.randint(4, vt, size=(batch, text_len)).astype(np.int32),
        "tgt_text_lengths": np.full((batch,), text_len, dtype=np.int32),
        "n2": np.int32(2),
    }


def batch_to_tensors(batch: Dict[str, np.ndarray], *, device
                     ) -> Dict[str, Union[torch.Tensor, int]]:
    """A numpy batch on ``device`` (required: a caller names the card or the
    CPU): float arrays as float32, integer arrays as int64, the scalar ``n2``
    as a Python int."""
    out: Dict[str, Union[torch.Tensor, int]] = {}
    for key, val in batch.items():
        arr = np.asarray(val)
        if arr.ndim == 0:
            out[key] = int(arr)
        elif np.issubdtype(arr.dtype, np.floating):
            out[key] = torch.from_numpy(arr.astype(np.float32)).to(device)
        else:
            out[key] = torch.from_numpy(arr.astype(np.int64)).to(device)
    return out
