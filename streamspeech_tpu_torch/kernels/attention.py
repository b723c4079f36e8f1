"""Attention kernels: the CUDA kernels' wrappers and their plain versions.

- ``masked_attention``: causal self-attention with a key bias; replaces the TPU
  kernel ``masked_attention`` (`streamspeech_tpu/ops/pallas_attention.py:425`,
  body ``_causal_kernel`` :399); ``csrc/masked_attention.cu``.
- ``bias_attention``: attention under an arbitrary [B, TQ, TK] additive bias;
  replaces ``bias_attention`` (`pallas_attention.py:625`, ``_bias_kernel``
  :602); ``csrc/bias_attention.cu``.
- ``relpos_attention``: Transformer-XL rel-pos self-attention; replaces
  ``relpos_attention`` (`pallas_attention.py:95`, ``_kernel`` :53);
  ``csrc/relpos_attention.cu``.

For CPU tensors each wrapper computes its ``*_reference``; for CUDA tensors it
launches its kernel or raises. There is no fallback. Each counts its launches.
The kernels are forward-only (their backwards, B2/B4/B6, are not ported yet):
on either device a wrapper raises when autograd would need a gradient through
it, instead of returning a result with no ``grad_fn``.
"""

from __future__ import annotations

import ctypes

import torch

from streamspeech_tpu_torch.kernels import build
from streamspeech_tpu_torch.ops.masks import NEG_INF

MAX_HEAD_DIM = 256  # head dims: multiples of 8 up to this (every csrc/*attention.cu)
TILE = 64  # query/key tile of the causal and rel-pos kernels; T must be a multiple

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (source, C entry point, argument types) of each kernel; the stream comes last
_MASKED = ("masked_attention", "masked_attention_f32", (_P,) * 5 + (_I,) * 4 + (_F, _P))
_BIAS = ("bias_attention", "bias_attention_f32", (_P,) * 5 + (_I,) * 5 + (_F, _P))
_RELPOS = ("relpos_attention", "relpos_attention_f32", (_P,) * 7 + (_I,) * 6 + (_F, _P))


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


def bias_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version (`pallas_attention.py:818-825`): q [B, H, TQ, D],
    k/v [B, H, TK, D], bias [B, TQ, TK] additive → [B, H, TQ, D] float32."""
    scores = torch.einsum("bhsd,bhtd->bhst", q, k) * scale + bias[:, None]
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(scores, dim=-1), v)


def relpos_attention_reference(q_u: torch.Tensor, q_v: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, p: torch.Tensor, bias: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """Plain PyTorch version (`pallas_attention.py:355-369`): q_u/q_v/k/v
    [B, H, T, D]; p [H, R >= 2T-1, D], row u ↔ relative position T-1-u; bias
    [B, 1|H, T, T] additive → [B, H, T, D] float32. bd[i, j] = q_v[i] · p[T-1-i+j]."""
    b, h, t, _ = q_u.shape
    ac = torch.einsum("bhsd,bhtd->bhst", q_u, k)
    bd_full = torch.einsum("bhsd,hrd->bhsr", q_v, p)
    i = torch.arange(t, device=q_u.device)[:, None]
    j = torch.arange(t, device=q_u.device)[None, :]
    u = ((t - 1) - (i - j))[None, None].expand(b, h, t, t)
    bd = torch.gather(bd_full, -1, u)
    probs = torch.softmax((ac + bd) * scale + bias, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, v)


def _forward_only(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise where autograd would have to differentiate through ``kernel``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} is forward-only: its backward kernel is a later slice of the "
            "port. Call it under torch.no_grad(), or train with deterministic=False, "
            "which takes the plain attention route")


def _check_inputs(named, device):
    for name, x in named:
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, q on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_head_dim(d: int):
    if d % 8 != 0 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is not a multiple of 8 in [8, {MAX_HEAD_DIM}]")


def _check(q, k, v, kv_bias):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q/k/v must share one [B, H, T, D] shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, _, t, d = q.shape
    if tuple(kv_bias.shape) != (b, 1, t):
        raise ValueError(f"kv_bias must be [B, 1, T] = {(b, 1, t)}, "
                         f"got {tuple(kv_bias.shape)}")
    _check_inputs((("q", q), ("k", k), ("v", v), ("kv_bias", kv_bias)), q.device)
    if t % TILE != 0:
        raise ValueError(f"T={t} must be a multiple of {TILE}")
    _check_head_dim(d)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_bias: torch.Tensor, scale: float) -> torch.Tensor:
    """Causal attention with a key-validity bias. q/k/v [B, H, T, D] float32,
    T a multiple of 64, D a multiple of 8 up to 256; kv_bias [B, 1, T] float32 (0 valid,
    NEG_INF masked). Returns [B, H, T, D] float32. Every row must have one
    allowed key, which key 0 gives on the serving path."""
    _forward_only("masked_attention", q, k, v, kv_bias)
    if not build.on_card(q, "masked_attention"):
        return masked_attention_reference(q, k, v, kv_bias, scale)
    _check(q, k, v, kv_bias)
    out = torch.empty_like(q)
    b, h, t, d = q.shape
    build.launch(_MASKED, q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), kv_bias.data_ptr(), out.data_ptr(), b, h, t, d,
                 float(scale))
    masked_attention.launches += 1
    return out


def _check_bias(q, k, v, bias):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q [B, H, TQ, D] and k/v [B, H, TK, D] do not agree: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, _, tq, d = q.shape
    if tuple(bias.shape) != (b, tq, k.shape[2]):
        raise ValueError(f"bias must be [B, TQ, TK] = {(b, tq, k.shape[2])}, "
                         f"got {tuple(bias.shape)}")
    _check_inputs((("q", q), ("k", k), ("v", v), ("bias", bias)), q.device)
    _check_head_dim(d)


def bias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor, scale: float) -> torch.Tensor:
    """Attention under an additive bias that carries the whole mask. q
    [B, H, TQ, D], k/v [B, H, TK, D], bias [B, TQ, TK], float32, any TQ and TK,
    D a multiple of 8 up to 256. Returns [B, H, TQ, D] float32."""
    _forward_only("bias_attention", q, k, v, bias)
    if not build.on_card(q, "bias_attention"):
        return bias_attention_reference(q, k, v, bias, scale)
    _check_bias(q, k, v, bias)
    out = torch.empty_like(q)
    b, h, tq, d = q.shape
    build.launch(_BIAS, q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bias.data_ptr(), out.data_ptr(), b, h, tq, k.shape[2],
                 d, float(scale))
    bias_attention.launches += 1
    return out


def _check_relpos(q_u, q_v, k, v, p, bias):
    if not (q_u.shape == q_v.shape == k.shape == v.shape) or q_u.dim() != 4:
        raise ValueError("q_u/q_v/k/v must share one [B, H, T, D] shape, got "
                         f"{[tuple(x.shape) for x in (q_u, q_v, k, v)]}")
    b, h, t, d = q_u.shape
    if p.dim() != 3 or p.shape[0] != h or p.shape[2] != d or p.shape[1] < 2 * t - 1:
        raise ValueError(f"p must be [H, R >= 2T-1, D] = [{h}, >={2 * t - 1}, {d}], "
                         f"got {tuple(p.shape)}")
    if bias.dim() != 4 or bias.shape[0] != b or bias.shape[1] not in (1, h) or \
            tuple(bias.shape[2:]) != (t, t):
        raise ValueError(f"bias must be [B, 1|H, T, T] with B={b}, H={h}, T={t}, "
                         f"got {tuple(bias.shape)}")
    _check_inputs((("q_u", q_u), ("q_v", q_v), ("k", k), ("v", v), ("p", p),
                   ("bias", bias)), q_u.device)
    if t % TILE != 0:
        raise ValueError(f"T={t} must be a multiple of {TILE}")
    _check_head_dim(d)


def relpos_attention(q_u: torch.Tensor, q_v: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, p: torch.Tensor, bias: torch.Tensor,
                     scale: float) -> torch.Tensor:
    """Rel-pos self-attention softmax(((q_u Kᵀ) + shear(q_v Pᵀ))·scale + bias)·V.
    q_u/q_v/k/v [B, H, T, D] float32, T a multiple of 64, D a multiple of 8 up
    to 256; p [H, R >= 2T-1, D]; bias [B, 1|H, T, T]. Returns [B, H, T, D]."""
    _forward_only("relpos_attention", q_u, q_v, k, v, p, bias)
    if not build.on_card(q_u, "relpos_attention"):
        return relpos_attention_reference(q_u, q_v, k, v, p, bias, scale)
    _check_relpos(q_u, q_v, k, v, p, bias)
    out = torch.empty_like(q_u)
    b, h, t, d = q_u.shape
    build.launch(_RELPOS, q_u.device, q_u.data_ptr(), q_v.data_ptr(),
                 k.data_ptr(), v.data_ptr(), p.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), b, h, t, d, p.shape[1], bias.shape[1], float(scale))
    relpos_attention.launches += 1
    return out


masked_attention.launches = 0
bias_attention.launches = 0
relpos_attention.launches = 0
