"""Unit HiFi-GAN vocoder with duration prediction (CodeHiFiGAN), the counterpart
of ``streamspeech_tpu/models/vocoder.py``.

References: HiFi-GAN generator and ResBlock v1
(`fairseq/fairseq/models/text_to_speech/hifigan.py:20-179`), CodeGenerator
(`agent/tts/codehifigan.py:9-95`), VariancePredictor
(`fairseq/fairseq/models/text_to_speech/fastspeech2.py:117-151`).

Parameters keep the JAX package's flat names (``conv_pre_w``, ``ups_0_b``, ...)
in PyTorch layouts: conv weights [Cout, Cin, K], transpose-conv weights
[Cin, Cout, K]. The generator runs channel-first internally; its public input
and output stay batch-first.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from streamspeech_tpu_torch.ops.conv1d import conv1d

LRELU_SLOPE = 0.1
SAMPLES_PER_FRAME = 320

# fairseq mHuBERT-layer11 km1000 CodeHiFiGAN config
DEFAULT_VOCODER_CFG: Dict[str, Any] = {
    "upsample_rates": [5, 4, 4, 2, 2],
    "upsample_kernel_sizes": [11, 8, 8, 4, 4],
    "upsample_initial_channel": 512,
    "resblock_kernel_sizes": [3, 7, 11],
    "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
    "num_embeddings": 1000,
    "embedding_dim": 128,
    "model_in_dim": 128,
    "dur_predictor_params": {
        "encoder_embed_dim": 128,
        "var_pred_hidden_dim": 128,
        "var_pred_kernel_size": 3,
        "var_pred_dropout": 0.5,
    },
}


def _add_conv(mod: nn.Module, name: str, k: int, cin: int, cout: int,
              transpose: bool = False):
    shape = (cin, cout, k) if transpose else (cout, cin, k)
    mod.register_parameter(f"{name}_w", nn.Parameter(torch.zeros(shape)))
    mod.register_parameter(f"{name}_b", nn.Parameter(torch.zeros(cout)))


class ResBlock(nn.Module):
    """HiFi-GAN ResBlock v1 over channel-first x [B, C, T]."""

    def __init__(self, channels: int, kernel_size: int, dilations=(1, 3, 5)):
        super().__init__()
        self.kernel_size, self.dilations = kernel_size, tuple(dilations)
        for i in range(len(self.dilations)):
            _add_conv(self, f"convs1_{i}", kernel_size, channels, channels)
            _add_conv(self, f"convs2_{i}", kernel_size, channels, channels)

    def forward(self, x):
        k = self.kernel_size
        for i, d in enumerate(self.dilations):
            xt = F.leaky_relu(x, LRELU_SLOPE)
            xt = F.conv1d(xt, getattr(self, f"convs1_{i}_w"),
                          getattr(self, f"convs1_{i}_b"), dilation=d,
                          padding=(k * d - d) // 2)
            xt = F.leaky_relu(xt, LRELU_SLOPE)
            xt = F.conv1d(xt, getattr(self, f"convs2_{i}_w"),
                          getattr(self, f"convs2_{i}_b"), padding=(k - 1) // 2)
            x = xt + x
        return x


class HiFiGANGenerator(nn.Module):
    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        ch = cfg["upsample_initial_channel"]
        _add_conv(self, "conv_pre", 7, cfg["model_in_dim"], ch)
        self.n_kernels = len(cfg["resblock_kernel_sizes"])
        for i, (u, k) in enumerate(zip(cfg["upsample_rates"],
                                       cfg["upsample_kernel_sizes"])):
            cin, cout = ch // (2 ** i), ch // (2 ** (i + 1))
            _add_conv(self, f"ups_{i}", k, cin, cout, transpose=True)
            for j, (rk, rd) in enumerate(zip(cfg["resblock_kernel_sizes"],
                                             cfg["resblock_dilation_sizes"])):
                self.add_module(f"resblocks_{i * self.n_kernels + j}",
                                ResBlock(cout, rk, rd))
        _add_conv(self, "conv_post", 7, ch // (2 ** len(cfg["upsample_rates"])), 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, model_in_dim] → wav [B, T * prod(upsample_rates)]."""
        c = self.cfg
        x = F.conv1d(x.transpose(1, 2), self.conv_pre_w, self.conv_pre_b, padding=3)
        for i, (u, k) in enumerate(zip(c["upsample_rates"],
                                       c["upsample_kernel_sizes"])):
            x = F.leaky_relu(x, LRELU_SLOPE)
            x = F.conv_transpose1d(x, getattr(self, f"ups_{i}_w"),
                                   getattr(self, f"ups_{i}_b"), stride=u,
                                   padding=(k - u) // 2)
            xs = None
            for j in range(self.n_kernels):
                r = getattr(self, f"resblocks_{i * self.n_kernels + j}")(x)
                xs = r if xs is None else xs + r
            x = xs / self.n_kernels
        x = F.leaky_relu(x)  # default slope 0.01, as the reference
        x = F.conv1d(x, self.conv_post_w, self.conv_post_b, padding=3)
        return torch.tanh(x)[:, 0]


class VariancePredictor(nn.Module):
    """conv k3 ReLU → LN → conv (padding 1) ReLU → LN → linear, eval mode."""

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        h, k = cfg["var_pred_hidden_dim"], cfg["var_pred_kernel_size"]
        self.kernel_size = k
        _add_conv(self, "conv1", k, cfg["encoder_embed_dim"], h)
        self.ln1 = nn.LayerNorm(h)
        _add_conv(self, "conv2", k, h, h)
        self.ln2 = nn.LayerNorm(h)
        self.proj = nn.Linear(h, 1)

    def forward(self, x):
        k = self.kernel_size
        x = self.ln1(F.relu(conv1d(x, self.conv1_w, self.conv1_b,
                                   padding=(k - 1) // 2)))
        # the reference pads conv2 by 1 whatever k is (`fastspeech2.py:138`)
        x = self.ln2(F.relu(conv1d(x, self.conv2_w, self.conv2_b, padding=1)))
        return self.proj(x)[..., 0]


def expand_by_durations(x: torch.Tensor, dur: torch.Tensor, max_frames: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape repeat_interleave: x [B, T, C], dur [B, T] → (expanded
    [B, max_frames, C], n_frames [B]) (`vocoder.py:133`)."""
    start = torch.zeros(dur.shape[0], dtype=dur.dtype, device=dur.device)
    out, _ = expand_window_by_durations(x, dur, start, max_frames)
    return out, dur.sum(dim=1)


def expand_window_by_durations(x: torch.Tensor, dur: torch.Tensor,
                               start_frame: torch.Tensor, window_frames: int
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frames [start, start + window) of the duration expansion: x [B, T, C],
    dur [B, T], start_frame [B] → (window [B, W, C], n_valid [B]) where n_valid
    counts the window frames before the sequence end (`vocoder.py:149`)."""
    csum = torch.cumsum(dur, dim=1)
    total = csum[:, -1]
    frames = start_frame[:, None] + torch.arange(window_frames, device=x.device)[None]
    idx = (frames[:, :, None] >= csum[:, None, :]).sum(dim=-1)
    idx = torch.clamp(idx, max=x.shape[1] - 1)
    out = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
    valid = frames < total[:, None]
    return out * valid[..., None].to(x.dtype), torch.clamp(total - start_frame, min=0)


class CodeGenerator(nn.Module):
    """Unit-code vocoder = embedding + duration predictor + HiFi-GAN."""

    def __init__(self, cfg: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.dict = nn.Embedding(cfg["num_embeddings"], cfg["embedding_dim"])
        self.dur_predictor = VariancePredictor(cfg["dur_predictor_params"])
        self.generator = HiFiGANGenerator(cfg)

    def predict_durations(self, code: torch.Tensor) -> torch.Tensor:
        """code [B, T] → int durations [B, T]: max(round(exp(log_dur) - 1), 1)."""
        log_dur = self.dur_predictor(self.dict(code))
        return torch.clamp(torch.round(torch.exp(log_dur) - 1.0), min=1.0).long()

    def vocode_window(self, code: torch.Tensor, dur: torch.Tensor,
                      start_frame: torch.Tensor, window_frames: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Vocode expanded frames [start, start + window) only. Returns
        (wav [B, window*320], n_valid_frames [B])."""
        win, n_valid = expand_window_by_durations(self.dict(code), dur,
                                                  start_frame, window_frames)
        return self.generator(win), n_valid

    def forward(self, code: torch.Tensor, dur: Optional[torch.Tensor] = None,
                max_frames: Optional[int] = None):
        """code [B, T] vocoder-local unit ids. Durations are predicted when not
        given. Returns (wav [B, max_frames*320], n_samples [B], dur [B, T])."""
        if dur is None:
            dur = self.predict_durations(code)
        if max_frames is None:
            max_frames = int(code.shape[1])
        x, n_frames = expand_by_durations(self.dict(code), dur, max_frames)
        upsample = int(np.prod(self.cfg["upsample_rates"]))
        return self.generator(x), n_frames * upsample, dur
