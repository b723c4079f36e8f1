"""Causal masked self-attention: the CUDA kernel's wrapper and its plain version.

``masked_attention`` replaces the TPU kernel ``masked_attention``
(`streamspeech_tpu/ops/pallas_attention.py:425`, body ``_causal_kernel`` :399).
For a CPU tensor it computes ``masked_attention_reference``; for a CUDA tensor
it launches ``csrc/masked_attention.cu`` or raises. There is no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from streamspeech_tpu_torch.kernels import build
from streamspeech_tpu_torch.ops.masks import NEG_INF

MAX_HEAD_DIM = 256  # head dims: multiples of 8 up to this (csrc/masked_attention.cu)
TILE = 64  # query/key tile of the kernel; T must be a multiple of it


def masked_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, kv_bias: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """Plain PyTorch version (`pallas_attention.py:570-583`): q/k/v [B, H, T, D],
    kv_bias [B, 1, T] additive → [B, H, T, D] float32."""
    t = q.shape[2]
    scores = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
    scores = scores + kv_bias[:, :, None, :]
    i = torch.arange(t, device=q.device)
    causal = torch.where(i[:, None] >= i[None, :], 0.0, NEG_INF)
    probs = torch.softmax(scores + causal.to(torch.float32), dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, v)


def _check(q, k, v, kv_bias):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q/k/v must share one [B, H, T, D] shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, _, t, d = q.shape
    if tuple(kv_bias.shape) != (b, 1, t):
        raise ValueError(f"kv_bias must be [B, 1, T] = {(b, 1, t)}, "
                         f"got {tuple(kv_bias.shape)}")
    for name, x in (("q", q), ("k", k), ("v", v), ("kv_bias", kv_bias)):
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if t % TILE != 0:
        raise ValueError(f"T={t} must be a multiple of {TILE}")
    if d % 8 != 0 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is not a multiple of 8 in [8, {MAX_HEAD_DIM}]")


@functools.lru_cache(maxsize=None)
def _library():
    fn = build.load("masked_attention").masked_attention_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _check_device(index: int):
    cap = torch.cuda.get_device_capability(index)
    if cap != (9, 0):
        raise RuntimeError("masked_attention is built for sm_90a (Hopper); device "
                           f"capability is {cap}")


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_bias: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal attention with a key-validity bias. q/k/v [B, H, T, D] float32,
    T a multiple of 64, D a multiple of 8 up to 256; kv_bias [B, 1, T] float32 (0 valid,
    NEG_INF masked). Returns [B, H, T, D] float32. Every row must have one
    allowed key, which key 0 gives on the serving path."""
    if q.device.type == "cpu":
        return masked_attention_reference(q, k, v, kv_bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"masked_attention takes CPU or CUDA tensors, got {q.device}")
    _check(q, k, v, kv_bias)
    _check_device(q.device.index if q.device.index is not None
                  else torch.cuda.current_device())
    fn = _library()
    out = torch.empty_like(q)
    b, h, t, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_bias.data_ptr(),
                 out.data_ptr(), b, h, t, d, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"masked_attention kernel launch failed: CUDA error {err}")
    masked_attention.launches += 1
    return out


masked_attention.launches = 0
