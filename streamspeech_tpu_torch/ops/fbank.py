"""Kaldi-compliant 80-dim log-mel filterbank on the host (PyTorch on the CPU).

Same pipeline as ``streamspeech_tpu/ops/fbank.py`` (and torchaudio's
``compliance.kaldi.fbank`` defaults as fairseq uses them,
`fairseq/examples/speech_to_text/data_utils.py:73-98`): samples scaled by 2**15,
25 ms povey window / 10 ms shift, snip_edges, DC removal, pre-emphasis 0.97,
512-point power spectrum without the Nyquist bin, kaldi mel banks (20 Hz to
Nyquist), floor at float32 epsilon, natural log. Features are made per 320 ms
segment on the host, so they never touch the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1.1920928955078125e-07  # std::numeric_limits<float>::epsilon()


def _mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def kaldi_mel_banks(num_bins: int, window_padded: int, sample_rate: int,
                    low_freq: float = 20.0) -> np.ndarray:
    """[num_bins, window_padded // 2] triangular filters (kaldi layout)."""
    high_freq = 0.5 * sample_rate
    num_fft_bins = window_padded // 2
    mel = _mel_scale(sample_rate / window_padded * np.arange(num_fft_bins))
    mel_low, mel_high = _mel_scale(low_freq), _mel_scale(high_freq)
    delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.zeros((num_bins, num_fft_bins), np.float32)
    for m in range(num_bins):
        left = mel_low + m * delta
        center, right = left + delta, left + 2 * delta
        up = (mel - left) / (center - left)
        down = (right - mel) / (right - center)
        bins[m] = np.clip(np.minimum(up, down), 0.0, None)
    return bins


def povey_window(n: int) -> np.ndarray:
    a = 2.0 * math.pi / (n - 1)
    return np.power(0.5 - 0.5 * np.cos(a * np.arange(n)), 0.85).astype(np.float32)


def num_frames(num_samples: int, sample_rate: int = 16000) -> int:
    win, shift = sample_rate * 25 // 1000, sample_rate * 10 // 1000
    return 0 if num_samples < win else 1 + (num_samples - win) // shift


def logmelfbank(waveform, sample_rate: int = 16000, num_bins: int = 80,
                preemph: float = 0.97) -> np.ndarray:
    """waveform [num_samples] float in [-1, 1] → [num_frames, num_bins] float32."""
    win, shift = sample_rate * 25 // 1000, sample_rate * 10 // 1000
    padded = 1 << (win - 1).bit_length()
    x = torch.as_tensor(np.asarray(waveform, np.float32)) * 32768.0
    n = num_frames(x.shape[0], sample_rate)
    if n <= 0:
        return np.zeros((0, num_bins), np.float32)
    frames = x.unfold(0, win, shift)[:n]                    # [n, win]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=-1)
    frames = (frames - preemph * prev) * torch.from_numpy(povey_window(win))
    frames = torch.nn.functional.pad(frames, (0, padded - win))
    spec = torch.fft.rfft(frames, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, : padded // 2]
    banks = torch.from_numpy(kaldi_mel_banks(num_bins, padded, sample_rate))
    mel = power @ banks.T
    return torch.log(torch.clamp(mel, min=_EPS)).numpy()


class OnlineFbank:
    """Incremental fbank: push raw samples, get the new frames back. Snip-edges
    framing is a pure function of the sample position, so keeping the
    (window - shift) overlap makes incremental extraction exact."""

    def __init__(self, sample_rate: int = 16000, num_bins: int = 80):
        self.sample_rate = sample_rate
        self.num_bins = num_bins
        self.win = sample_rate * 25 // 1000
        self.shift = sample_rate * 10 // 1000
        self.residual = np.zeros((0,), np.float32)

    def reset(self):
        self.residual = np.zeros((0,), np.float32)

    def push(self, samples: np.ndarray) -> np.ndarray:
        buf = np.concatenate([self.residual, np.asarray(samples, np.float32)])
        n = num_frames(len(buf), self.sample_rate)
        if n <= 0:
            self.residual = buf
            return np.zeros((0, self.num_bins), np.float32)
        used = n * self.shift
        feats = logmelfbank(buf[: used + self.win - self.shift],
                            self.sample_rate, self.num_bins)
        self.residual = buf[used:]
        return feats
