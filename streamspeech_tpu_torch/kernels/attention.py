"""Attention kernels: the CUDA kernels' wrappers and their plain versions.

- ``masked_attention``: causal self-attention with a key bias; replaces the TPU
  kernels ``masked_attention`` (`streamspeech_tpu/ops/pallas_attention.py:425`,
  body ``_causal_kernel`` :399) and ``_masked_bwd`` (:508);
  ``csrc/masked_attention.cu``, ``csrc/masked_attention_bwd.cu``; bf16 q/k/v
  ``csrc/masked_attention_bf16.cu``, ``csrc/masked_attention_bwd_bf16.cu``.
- ``bias_attention``: attention under an arbitrary [B, TQ, TK] additive bias;
  replaces ``bias_attention`` (`pallas_attention.py:625`, ``_bias_kernel``
  :602) and ``_bias_bwd_rule`` (:712); ``csrc/bias_attention.cu``,
  ``csrc/bias_attention_bwd.cu``; bf16 q/k/v ``csrc/bias_attention_bf16.cu``,
  ``csrc/bias_attention_bwd_bf16.cu``.
- ``relpos_attention``: Transformer-XL rel-pos self-attention; replaces
  ``relpos_attention`` (`pallas_attention.py:95`, ``_kernel`` :53) and
  ``_relpos_bwd`` (:243); ``csrc/relpos_attention.cu``,
  ``csrc/relpos_attention_bwd.cu``.
- ``dropout_keep``: the keep mask the six kernels draw inside their tile loops
  (``_dropout_keep``, `pallas_attention.py:36`); ``csrc/dropout.cuh``, written
  out by ``csrc/dropout.cu``.

The three attention functions are differentiable (the counterparts of the
``*_trainable`` functions): the forward saves q, k, v, the bias, the output,
each row's softmax statistics and the seed, never a [B, H, TQ, TK] tensor, and
the backward recomputes the probabilities and regenerates the dropout mask.
The bias and the seed get no gradient.

``masked_attention`` and ``bias_attention`` also take bfloat16 q, k and v (a
bf16 model's unit decoder), as the TPU kernels take their inputs' dtype: fp32
scores and softmax, the probabilities (times the keep factor) rounded to bf16
for the P·V product, summed in fp32, an fp32 output (``attention_bf16.cuh`` on
the card, ``wgmma`` fed by TMA up to D = 64, ``mma.sync`` above,
``bf16_forward_form``: an inference form, and a training form that draws the
dropout mask and writes the row statistics). Their backward takes the bf16 q, k and v and
an fp32 g, as the TPU backward kernels do (`pallas_attention.py:515`, :720):
every product in fp32 on widened operands, the probabilities recomputed in
fp32 and not rounded, and dq, dK and dV cast to bf16 at the end (:538,
:745; ``attention_bwd_bf16.cuh`` on the card). The bias stays fp32.
``relpos_attention`` is fp32 only: the JAX route casts its inputs to fp32
(`models/layers.py:472-476`).

For CPU tensors each wrapper computes its plain version (``*_reference``,
``*_backward_reference``, ``dropout_keep_reference``); for CUDA tensors it
launches its kernel or raises. There is no fallback. Each counts its launches:
``f.launches`` for a forward (``f.bf16_launches`` for the bf16 forms),
``f_backward.launches`` once per backward call (``f_backward.bf16_launches``
for the bf16 form; a call launches one or two CUDA kernels),
``dropout_keep.launches`` for the
kernel that writes the mask out alone. ``mask_draws`` counts the forward
launches and backward calls that drew the mask inside their own kernels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple, Union

import torch
from torch.autograd.function import once_differentiable

from streamspeech_tpu_torch.kernels import build
from streamspeech_tpu_torch.ops.masks import NEG_INF

MAX_HEAD_DIM = 256  # head dims: multiples of 8 up to this (every csrc/*attention*.cu)
TILE = 64  # query/key tile of the causal and rel-pos kernels; T must be a multiple

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (source, C entry point, argument types) of each kernel; the stream comes last
_MASKED = ("masked_attention", "masked_attention_f32", (_P,) * 7 + (_I,) * 4 + (_F, _F, _P))
_BIAS = ("bias_attention", "bias_attention_f32", (_P,) * 7 + (_I,) * 5 + (_F, _F, _P))
_RELPOS = ("relpos_attention", "relpos_attention_f32",
           (_P,) * 9 + (_I,) * 6 + (_F, _F, _P))
_MASKED_BWD = ("masked_attention_bwd", "masked_attention_bwd_f32",
               (_P,) * 12 + (_I,) * 4 + (_F, _F, _P))
_BIAS_BWD = ("bias_attention_bwd", "bias_attention_bwd_f32",
             (_P,) * 13 + (_I,) * 6 + (_F, _F, _P))
_BIAS_BWD_GROUPS = ("bias_attention_bwd", "bias_attention_bwd_groups", (_I,) * 5)
_RELPOS_BWD = ("relpos_attention_bwd", "relpos_attention_bwd_f32",
               (_P,) * 16 + (_I,) * 6 + (_F, _F, _P))
_RELPOS_BWD_SCRATCH = ("relpos_attention_bwd", "relpos_attention_bwd_scratch", (_I,) * 4)
_KEEP = ("dropout", "dropout_keep_u8", (_P, _P) + (_I,) * 4 + (_F, _P))
_MASKED_BF16 = ("masked_attention_bf16", "masked_attention_bf16",
                (_P,) * 5 + (_I,) * 4 + (_F, _P))
_BIAS_BF16 = ("bias_attention_bf16", "bias_attention_bf16", (_P,) * 5 + (_I,) * 5 + (_F, _P))
# the bf16 forwards' training form: the fp32 forwards' arguments
_MASKED_BF16_TRAIN = ("masked_attention_bf16", "masked_attention_bf16_train", _MASKED[2])
_BIAS_BF16_TRAIN = ("bias_attention_bf16", "bias_attention_bf16_train", _BIAS[2])
# the bf16 backwards: q, k, v, bias, g, stats, seed, delta, gsplit, keep, dq,
# dk, dv, B, H, TQ, TK, D, scale, rate; and the CUDA kernels a call launches at
# a shape
_BWD_BF16_ARGS = (_P,) * 13 + (_I,) * 5 + (_F, _F, _P)
_MASKED_BWD_BF16 = ("masked_attention_bwd_bf16", "masked_attention_bwd_bf16", _BWD_BF16_ARGS)
_BIAS_BWD_BF16 = ("bias_attention_bwd_bf16", "bias_attention_bwd_bf16", _BWD_BF16_ARGS)
_MASKED_BWD_BF16_KERNELS = ("masked_attention_bwd_bf16", "masked_attention_bwd_bf16_kernels",
                            (_I,) * 5)
# the bf16 forwards' form at a shape (TK, D): 1 the wgmma form, 0 the mma.sync one
_MASKED_BF16_WGMMA = ("masked_attention_bf16", "masked_attention_bf16_wgmma", (_I,) * 2)
_BIAS_BF16_WGMMA = ("bias_attention_bf16", "bias_attention_bf16_wgmma", (_I,) * 2)
_BIAS_BWD_BF16_KERNELS = ("bias_attention_bwd_bf16", "bias_attention_bwd_bf16_kernels",
                          (_I,) * 5)
_QKV_DTYPES = (torch.float32, torch.bfloat16)

Seed = Union[int, torch.Tensor]


# ---------------------------------------------------------------------------
# The dropout mask
# ---------------------------------------------------------------------------

_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_M32 = 0xFFFFFFFF


def _mulhilo32(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(high, low) 32 bits of m·x for a 32-bit constant and int64 x < 2³²; the
    product is split at x's 16-bit limbs so that nothing passes 2⁶³."""
    lo_part, hi_part = m * (x & 0xFFFF), m * (x >> 16)
    low = (lo_part + ((hi_part & 0xFFFF) << 16)) & _M32
    high = (hi_part + (lo_part >> 16)) >> 16
    return high, low


def philox4x32_10(counter, key):
    """Philox-4x32-10 on int64 tensors holding 32-bit words: ``counter`` four
    tensors (broadcastable), ``key`` two ints or tensors → four tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W0) & _M32, (k1 + _PHILOX_W1) & _M32
    return c0, c1, c2, c3


def draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """One attention call's dropout seed: a one-element int64 tensor on
    ``device``, drawn there from ``generator`` in [0, 2³¹ - 1) without a host
    synchronisation (the counterpart of `layers.py:316-318`)."""
    if generator is None:
        raise ValueError("attention dropout needs a torch.Generator")
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator, device=device,
                         dtype=torch.int64)


def dropout_keep_reference(seed: Seed, b: int, h: int, tq: int, tk: int, rate: float,
                           device=None) -> torch.Tensor:
    """The plain version of ``csrc/dropout.cuh``, bit for bit: bool
    [b, h, tq, tk], True = keep.
    bits = Philox-4x32-10(key = seed, counter = (b, h, query row, key col // 4)),
    u = (bits[col % 4] >> 8)·2⁻²⁴, keep = u >= rate in float32. An element's
    bit depends on its own (b, h, row, col) alone, not on the shape asked for."""
    if isinstance(seed, torch.Tensor):
        device = seed.device if device is None else device
        seed = seed.to(device=device, dtype=torch.int64).reshape(())
        key = (seed & _M32, (seed >> 32) & _M32)
    else:
        key = (int(seed) & _M32, (int(seed) >> 32) & _M32)
    def ar(n):
        return torch.arange(n, device=device, dtype=torch.int64)

    groups = -(-tk // 4)                                          # of 4 key columns
    counter = (ar(b)[:, None, None, None].expand(b, h, tq, groups),
               ar(h)[None, :, None, None], ar(tq)[None, None, :, None],
               ar(groups)[None, None, None, :])
    bits = torch.stack(philox4x32_10(counter, key), dim=-1)       # [b, h, tq, g, 4]
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    keep = u >= torch.full((), rate, dtype=torch.float32, device=device)
    return keep.reshape(b, h, tq, groups * 4)[..., :tk]


def dropout_keep(seed: torch.Tensor, b: int, h: int, tq: int, tk: int,
                 rate: float) -> torch.Tensor:
    """The mask the attention kernels draw, written out: bool [b, h, tq, tk].
    ``seed`` is a one-element int64 tensor; on the card ``csrc/dropout.cu``
    stores what the kernels' own device functions give."""
    if not build.on_card(seed, "dropout_keep"):
        return dropout_keep_reference(seed, b, h, tq, tk, rate)
    _check_seed(seed, seed.device, rate)
    out = torch.empty((b, h, tq, tk), dtype=torch.uint8, device=seed.device)
    build.launch(_KEEP, seed.device, seed.data_ptr(), out.data_ptr(), b, h, tq, tk,
                 float(rate))
    dropout_keep.launches += 1
    return out.view(torch.bool)  # the kernel stores 0 or 1: valid bools, no copy


def _keep_or_none(seed, b, h, tq, tk, rate):
    return None if rate == 0.0 else dropout_keep_reference(seed, b, h, tq, tk, rate)


def _drop(probs: torch.Tensor, keep: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """Dropout after the softmax (`pallas_attention.py:84-87`)."""
    if keep is None:
        return probs
    return torch.where(keep, probs * (1.0 / (1.0 - rate)), torch.zeros_like(probs))


# ---------------------------------------------------------------------------
# Plain versions: forwards
# ---------------------------------------------------------------------------


def _pv(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """P·V as the kernels form it: the probabilities rounded to v's dtype
    (`pallas_attention.py:418` ``probs.astype(v.dtype)``), the products summed
    in fp32, an fp32 result. For fp32 v the plain product."""
    return torch.einsum("bhst,bhtd->bhsd", probs.to(v.dtype).float(), v.float())


def _masked_probs(q, k, kv_bias, scale):
    t = q.shape[2]
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    scores = scores + kv_bias[:, :, None, :]
    i = torch.arange(t, device=q.device)
    causal = torch.where(i[:, None] >= i[None, :], 0.0, NEG_INF)
    return torch.softmax(scores + causal.to(torch.float32), dim=-1)


def masked_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, kv_bias: torch.Tensor,
                               scale: float, keep: Optional[torch.Tensor] = None,
                               rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version (`pallas_attention.py:570-583`): q/k/v [B, H, T, D]
    float32 or bfloat16, kv_bias [B, 1, T] additive float32 → [B, H, T, D]
    float32. Scores and softmax in fp32 from the widened operands, the
    probabilities normalised, then rounded to v's dtype for P·V (``_pv``), as
    the TPU kernel's body (:399-423). ``keep`` [B, H, T, T] bool drops
    probabilities after the softmax at ``rate``."""
    return _pv(_drop(_masked_probs(q, k, kv_bias, scale), keep, rate), v)


def _bias_probs(q, k, bias, scale):
    scores = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale + bias[:, None]
    return torch.softmax(scores, dim=-1)


def bias_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             bias: torch.Tensor, scale: float,
                             keep: Optional[torch.Tensor] = None,
                             rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version (`pallas_attention.py:818-825`): q [B, H, TQ, D],
    k/v [B, H, TK, D] (float32 or bfloat16, as ``masked_attention_reference``),
    bias [B, TQ, TK] additive float32 → [B, H, TQ, D] float32; ``keep``
    [B, H, TQ, TK] as in ``masked_attention_reference``."""
    return _pv(_drop(_bias_probs(q, k, bias, scale), keep, rate), v)


def _relpos_rows(t: int, device) -> torch.Tensor:
    """[T, T] table row of (i, j): u = T-1 - (i - j)."""
    i = torch.arange(t, device=device)[:, None]
    j = torch.arange(t, device=device)[None, :]
    return (t - 1) - (i - j)


def _relpos_probs(q_u, q_v, k, p, bias, scale):
    b, h, t, _ = q_u.shape
    ac = torch.einsum("bhsd,bhtd->bhst", q_u, k)
    bd_full = torch.einsum("bhsd,hrd->bhsr", q_v, p)
    u = _relpos_rows(t, q_u.device)[None, None].expand(b, h, t, t)
    bd = torch.gather(bd_full, -1, u)
    return torch.softmax((ac + bd) * scale + bias, dim=-1)


def relpos_attention_reference(q_u: torch.Tensor, q_v: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, p: torch.Tensor, bias: torch.Tensor,
                               scale: float, keep: Optional[torch.Tensor] = None,
                               rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version (`pallas_attention.py:355-369`): q_u/q_v/k/v
    [B, H, T, D]; p [H, R >= 2T-1, D], row u ↔ relative position T-1-u; bias
    [B, 1|H, T, T] additive → [B, H, T, D] float32. bd[i, j] = q_v[i] · p[T-1-i+j].
    ``keep`` [B, H, T, T] as in ``masked_attention_reference``."""
    probs = _drop(_relpos_probs(q_u, q_v, k, p, bias, scale), keep, rate)
    return torch.einsum("bhst,bhtd->bhsd", probs, v)


# ---------------------------------------------------------------------------
# Plain versions: backwards (`pallas_attention.py:146-148`, :152-177)
# ---------------------------------------------------------------------------


def _softmax_backward(probs, v, g, scale, keep, rate):
    """(the probabilities dV sees, d loss / d scores): with the keep factor
    kf = keep / (1 - rate), dp = (g vᵀ)·kf and
    ds = probs·(dp - rowsum(dp·probs))·scale. A bf16 v is widened: the
    product of fp32 g and bf16 v is fp32 (`pallas_attention.py:474`)."""
    dprobs = torch.einsum("bhsd,bhtd->bhst", g, v.float())
    probs_for_dv = probs
    if keep is not None:
        kf = keep.to(torch.float32) * (1.0 / (1.0 - rate))
        dprobs, probs_for_dv = dprobs * kf, probs * kf
    delta = torch.sum(dprobs * probs, dim=-1, keepdim=True)
    return probs_for_dv, probs * (dprobs - delta) * scale


def _qkv_grads(ds, probs_for_dv, q, k, g):
    """(dq, dK, dV) in q's dtype: fp32 products on widened operands, cast
    last (`pallas_attention.py:538`, :745)."""
    return (torch.einsum("bhst,bhtd->bhsd", ds, k.float()).to(q.dtype),
            torch.einsum("bhst,bhsd->bhtd", ds, q.float()).to(q.dtype),
            torch.einsum("bhst,bhsd->bhtd", probs_for_dv, g).to(q.dtype))


def masked_attention_backward_reference(q, k, v, kv_bias, g, scale, keep=None,
                                        rate=0.0):
    """(dq, dK, dV) of ``masked_attention_reference`` for g = d loss / d out
    (fp32), step by step: recompute the probabilities in fp32, then dp, ds and
    the three products; for bf16 q/k/v (`pallas_attention.py:508-538`) the
    probabilities are not rounded and the gradients are cast to bf16 at the
    end. ``kv_bias`` is a constant."""
    pdv, ds = _softmax_backward(_masked_probs(q, k, kv_bias, scale), v, g, scale, keep,
                                rate)
    return _qkv_grads(ds, pdv, q, k, g)


def bias_attention_backward_reference(q, k, v, bias, g, scale, keep=None, rate=0.0):
    """(dq, dK, dV) of ``bias_attention_reference``, fp32 or bf16 q/k/v as
    ``masked_attention_backward_reference``; ``bias`` is a constant."""
    pdv, ds = _softmax_backward(_bias_probs(q, k, bias, scale), v, g, scale, keep, rate)
    return _qkv_grads(ds, pdv, q, k, g)


def relpos_attention_backward_reference(q_u, q_v, k, v, p, bias, g, scale, keep=None,
                                        rate=0.0):
    """(dq_u, dq_v, dK, dV, dP) of ``relpos_attention_reference``:
    dq_v[i] = Σ_j ds[i, j]·p[T-1-i+j] (a gather of table rows) and
    dP[h, u] = Σ_b Σ_{T-1-i+j = u} ds[b, h, i, j]·q_v[b, h, i] (an ``index_add_``
    over the table rows; rows past 2T-2 get 0). ``bias`` is a constant."""
    h, t = q_u.shape[1], q_u.shape[2]
    pdv, ds = _softmax_backward(_relpos_probs(q_u, q_v, k, p, bias, scale), v, g, scale,
                                keep, rate)
    dq_u, dk, dv = _qkv_grads(ds, pdv, q_u, k, g)
    u = _relpos_rows(t, q_u.device)
    dq_v = torch.einsum("bhst,hstd->bhsd", ds, p[:, u])
    contrib = torch.einsum("bhst,bhsd->hstd", ds, q_v)
    dp = torch.zeros_like(p).index_add_(1, u.reshape(-1), contrib.reshape(h, t * t, -1))
    return dq_u, dq_v, dk, dv, dp


# ---------------------------------------------------------------------------
# Checks
# ---------------------------------------------------------------------------


def _check_inputs(named, device, dtype=torch.float32):
    for name, x in named:
        if x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, q on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_head_dim(d: int):
    if d % 8 != 0 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} is not a multiple of 8 in [8, {MAX_HEAD_DIM}]")


def _check_rate(rate: float):
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} is not in [0, 1)")


def _check_seed(seed, device, rate: float):
    _check_rate(rate)
    if rate == 0.0:
        return
    if not isinstance(seed, torch.Tensor) or seed.numel() != 1 or \
            seed.dtype != torch.int64 or seed.device != device:
        raise ValueError("dropout needs a one-element int64 seed tensor on "
                         f"{device} (draw_seed), got {seed!r}")


def _check(q, k, v, kv_bias):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(f"q/k/v must share one [B, H, T, D] shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, _, t, d = q.shape
    if tuple(kv_bias.shape) != (b, 1, t):
        raise ValueError(f"kv_bias must be [B, 1, T] = {(b, 1, t)}, "
                         f"got {tuple(kv_bias.shape)}")
    _check_qkv(q, k, v)
    _check_inputs((("kv_bias", kv_bias),), q.device)
    if t % TILE != 0:
        raise ValueError(f"T={t} must be a multiple of {TILE}")
    _check_head_dim(d)


def _check_bias(q, k, v, bias):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"q [B, H, TQ, D] and k/v [B, H, TK, D] do not agree: "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    b, _, tq, d = q.shape
    if tuple(bias.shape) != (b, tq, k.shape[2]):
        raise ValueError(f"bias must be [B, TQ, TK] = {(b, tq, k.shape[2])}, "
                         f"got {tuple(bias.shape)}")
    _check_qkv(q, k, v)
    _check_inputs((("bias", bias),), q.device)
    _check_head_dim(d)


def _check_qkv(q, k, v):
    """q, k and v share one dtype the kernels take (float32 or bfloat16)."""
    if q.dtype not in _QKV_DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    _check_inputs((("q", q), ("k", k), ("v", v)), q.device, q.dtype)


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


def _check_backward(g, out, stats, like):
    """The backward kernels' own inputs: g and out float32 and shaped like q,
    the forward's row statistics [B, H, TQ, 2]."""
    if stats is None:
        raise ValueError("the backward kernel needs the forward's row statistics")
    if g.shape != like.shape or out.shape != like.shape or \
            tuple(stats.shape) != (*like.shape[:3], 2):
        raise ValueError(f"g/out must be {tuple(like.shape)} and stats "
                         f"{(*like.shape[:3], 2)}, got {tuple(g.shape)} "
                         f"{tuple(out.shape)} {tuple(stats.shape)}")
    _check_inputs((("g", g), ("out", out), ("stats", stats)), like.device)


def _check_qkv_dtype(q, k, v):
    """On every device: q, k and v share one dtype that has an instance."""
    if q.dtype not in _QKV_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must share float32 or bfloat16, got {q.dtype} "
                         f"{k.dtype} {v.dtype}")


def _check_g(g):
    """d loss / d out is float32 on every device: the output is float32."""
    if g.dtype != torch.float32:
        raise ValueError(f"g must be float32 (the output's dtype), got {g.dtype}")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


mask_draws = 0  # attention launches (backward: calls) that drew the dropout mask


def _count(fn, rate: float, bf16: bool = False):
    global mask_draws
    if bf16:
        fn.bf16_launches += 1
    else:
        fn.launches += 1
    if rate > 0.0:
        mask_draws += 1


def _count_batch(b: int):
    """``masked_attention.launches_by_batch``: its launches (both dtypes) by
    the batch of the call, B streams served together showing as B."""
    masked_attention.launches_by_batch[b] = masked_attention.launches_by_batch.get(b, 0) + 1


# ---------------------------------------------------------------------------
# Causal masked attention
# ---------------------------------------------------------------------------


def masked_attention_forward(q, k, v, kv_bias, scale, rate=0.0, seed=None,
                             want_stats=False):
    """``masked_attention`` outside autograd: (out, stats), stats [B, H, T, 2]
    (each row's max and 1 / sum, what the backward kernel reads; the bf16 form
    keeps the max in log2 units, as its kernels compute) on the card when
    asked for, else None. bf16 q/k/v with dropout or statistics take the bf16
    form's training instance."""
    _check_rate(rate)
    _check_qkv_dtype(q, k, v)
    b, h, t, d = q.shape
    if not build.on_card(q, "masked_attention"):
        return masked_attention_reference(
            q, k, v, kv_bias, scale, _keep_or_none(seed, b, h, t, t, rate), rate), None
    _check(q, k, v, kv_bias)
    bf16 = q.dtype == torch.bfloat16
    out = q.new_empty(q.shape, dtype=torch.float32)
    if bf16 and rate == 0.0 and not want_stats:
        build.launch(_MASKED_BF16, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     kv_bias.data_ptr(), out.data_ptr(), b, h, t, d, float(scale))
        masked_attention.bf16_launches += 1
        _count_batch(b)
        return out, None
    _check_seed(seed, q.device, rate)
    stats = out.new_empty((b, h, t, 2)) if want_stats else None
    build.launch(_MASKED_BF16_TRAIN if bf16 else _MASKED, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(), kv_bias.data_ptr(), out.data_ptr(),
                 _ptr(seed) if rate > 0 else None, _ptr(stats), b, h, t, d, float(scale),
                 float(rate))
    _count(masked_attention, rate, bf16)
    _count_batch(b)
    return out, stats


def masked_attention_backward(q, k, v, kv_bias, g, out, stats, seed, scale: float,
                              rate: float = 0.0):
    """(dq, dK, dV) of ``masked_attention`` for g = d loss / d out (float32),
    in q's dtype. On the card ``csrc/masked_attention_bwd.cu`` (fp32; ``out``
    and the forward's ``stats`` required) or ``csrc/masked_attention_bwd_bf16.cu``
    (bf16 q/k/v; ``stats`` from the bf16 training form; delta is formed from
    the fp32 probabilities, so ``out`` is only checked); on the CPU
    ``masked_attention_backward_reference``."""
    _check_qkv_dtype(q, k, v)
    _check_g(g)
    b, h, t, d = q.shape
    if not build.on_card(q, "masked_attention_backward"):
        return masked_attention_backward_reference(
            q, k, v, kv_bias, g, scale, _keep_or_none(seed, b, h, t, t, rate), rate)
    _check(q, k, v, kv_bias)
    _check_backward(g, out, stats, q)
    _check_seed(seed, q.device, rate)
    if q.dtype == torch.bfloat16:
        return backward_bf16("masked", q, k, v, kv_bias, g, stats, seed, scale, rate)[:3]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = q.new_empty((b, h, t))
    build.launch(_MASKED_BWD, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 kv_bias.data_ptr(), g.data_ptr(), out.data_ptr(), stats.data_ptr(),
                 _ptr(seed) if rate > 0 else None, delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), b, h, t, d, float(scale), float(rate))
    _count(masked_attention_backward, rate)
    return dq, dk, dv


def backward_bf16(family: str, q, k, v, bias, g, stats, seed, scale: float,
                  rate: float = 0.0):
    """The bf16 backward of B4 (``family`` "masked", bias the [B, 1, T] key
    bias) or B6 ("bias") on the card: (dq, dK, dV, delta), delta = Σ_j p dp
    from the fp32 probabilities ([B, H, TQ] fp32, returned for checks). Two
    CUDA kernels (a dQ pass that also splits g into a [2, B, H, TQ, D] bf16
    scratch and, with dropout, writes the keep words it draws to a [B, H, TQ,
    TK / 32] scratch; then a dK/dV pass that reads both) or, for B6 at TK <=
    128 and D <= 64, one; the count comes from the built library. Inputs as
    the backward wrappers, which call this after their checks."""
    spec, kernels_spec, fn = {
        "masked": (_MASKED_BWD_BF16, _MASKED_BWD_BF16_KERNELS, masked_attention_backward),
        "bias": (_BIAS_BWD_BF16, _BIAS_BWD_BF16_KERNELS, bias_attention_backward)}[family]
    b, h, tq, d = q.shape
    tk = k.shape[2]
    kernels = bf16_backward_kernels(kernels_spec, b, h, tq, tk, d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = g.new_empty((b, h, tq))
    gsplit = q.new_empty((2, b, h, tq, d)) if kernels == 2 else None
    keep = g.new_empty((b, h, tq, 2 * -(-tk // TILE)), dtype=torch.int32) \
        if kernels == 2 and rate > 0 else None
    build.launch(spec, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 bias.data_ptr(), g.data_ptr(), stats.data_ptr(),
                 _ptr(seed) if rate > 0 else None, delta.data_ptr(), _ptr(gsplit), _ptr(keep),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, tq, tk, d,
                 float(scale), float(rate))
    _count(fn, rate, bf16=True)
    return dq, dk, dv, delta


@functools.lru_cache(maxsize=None)
def bf16_backward_kernels(kernels_spec, b: int, h: int, tq: int, tk: int, d: int) -> int:
    """The CUDA kernels a bf16 backward call launches (``_MASKED_BWD_BF16_KERNELS``
    or ``_BIAS_BWD_BF16_KERNELS``) at this shape: 1 or 2; the library owns the
    choice. Raises where the head dim has no instance."""
    kernels = build.bind(*kernels_spec)(b, h, tq, tk, d)
    if kernels < 1:
        raise ValueError(f"no bf16 backward instance at B={b}, H={h}, TQ={tq}, TK={tk}, "
                         f"D={d}")
    return kernels


@functools.lru_cache(maxsize=None)
def bf16_forward_form(family: str, tk: int, d: int) -> str:
    """The form of the bf16 forward of B3 (``family`` "masked") or B5 ("bias")
    a call at this shape launches, one CUDA kernel either way: "wgmma"
    (``fwd_kernel``, D <= 64 and for B5 TK <= 128) or "mma.sync"
    (``attention_bf16_kernel``); the library owns the choice. Raises where the
    head dim has no instance."""
    spec = {"masked": _MASKED_BF16_WGMMA, "bias": _BIAS_BF16_WGMMA}[family]
    form = build.bind(*spec)(tk, d)
    if form < 0:
        raise ValueError(f"no bf16 forward instance at TK={tk}, D={d}")
    return "wgmma" if form else "mma.sync"


class _MaskedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_bias, seed, scale, rate, differentiate):
        out, stats = masked_attention_forward(q, k, v, kv_bias, scale, rate, seed,
                                              differentiate)
        if differentiate:
            ctx.save_for_backward(q, k, v, kv_bias, out, stats, seed)
            ctx.scale, ctx.rate = scale, rate
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, kv_bias, out, stats, seed = ctx.saved_tensors
        grads = masked_attention_backward(q, k, v, kv_bias, g.contiguous(), out, stats,
                                          seed, ctx.scale, ctx.rate)
        return (*grads, None, None, None, None, None)


def _differentiate(*tensors: torch.Tensor) -> bool:
    """Whether autograd needs this call's backward."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_bias: torch.Tensor, scale: float, dropout_rate: float = 0.0,
                     seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal attention with a key-validity bias. q/k/v [B, H, T, D] float32
    or bfloat16 (gradients in that dtype), T a multiple of 64, D a multiple
    of 8 up to 256; kv_bias [B, 1, T] float32 (0 valid, NEG_INF masked).
    Returns [B, H, T, D] float32. Every row must have one
    allowed key, which key 0 gives on the serving and training paths.
    ``dropout_rate`` > 0 drops attention probabilities inside the kernel, the
    mask drawn from ``seed`` (``draw_seed``). Differentiable in q, k and v."""
    return _MaskedAttention.apply(q, k, v, kv_bias, seed, scale, float(dropout_rate),
                                  _differentiate(q, k, v))


# ---------------------------------------------------------------------------
# Attention under an arbitrary bias
# ---------------------------------------------------------------------------


def bias_attention_forward(q, k, v, bias, scale, rate=0.0, seed=None, want_stats=False):
    """``bias_attention`` outside autograd: (out, stats) as
    ``masked_attention_forward``."""
    _check_rate(rate)
    _check_qkv_dtype(q, k, v)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if not build.on_card(q, "bias_attention"):
        return bias_attention_reference(
            q, k, v, bias, scale, _keep_or_none(seed, b, h, tq, tk, rate), rate), None
    _check_bias(q, k, v, bias)
    bf16 = q.dtype == torch.bfloat16
    out = q.new_empty(q.shape, dtype=torch.float32)
    if bf16 and rate == 0.0 and not want_stats:
        build.launch(_BIAS_BF16, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     bias.data_ptr(), out.data_ptr(), b, h, tq, tk, d, float(scale))
        bias_attention.bf16_launches += 1
        return out, None
    _check_seed(seed, q.device, rate)
    stats = out.new_empty((b, h, tq, 2)) if want_stats else None
    build.launch(_BIAS_BF16_TRAIN if bf16 else _BIAS, q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 _ptr(seed) if rate > 0 else None, _ptr(stats), b, h, tq, tk, d,
                 float(scale), float(rate))
    _count(bias_attention, rate, bf16)
    return out, stats


def bias_attention_backward(q, k, v, bias, g, out, stats, seed, scale: float,
                            rate: float = 0.0):
    """(dq, dK, dV) of ``bias_attention`` in q's dtype:
    ``csrc/bias_attention_bwd.cu`` (fp32) or ``csrc/bias_attention_bwd_bf16.cu``
    (bf16) on the card, ``bias_attention_backward_reference`` on the CPU."""
    _check_qkv_dtype(q, k, v)
    _check_g(g)
    b, h, tq, d = q.shape
    tk = k.shape[2]
    if not build.on_card(q, "bias_attention_backward"):
        return bias_attention_backward_reference(
            q, k, v, bias, g, scale, _keep_or_none(seed, b, h, tq, tk, rate), rate)
    _check_bias(q, k, v, bias)
    _check_backward(g, out, stats, q)
    _check_seed(seed, q.device, rate)
    if q.dtype == torch.bfloat16:
        return backward_bf16("bias", q, k, v, bias, g, stats, seed, scale, rate)[:3]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    groups, shape = bias_backward_scratch(b, h, tq, tk, d)
    scratch = q.new_empty(shape)
    build.launch(_BIAS_BWD, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 bias.data_ptr(), g.data_ptr(), out.data_ptr(), stats.data_ptr(),
                 _ptr(seed) if rate > 0 else None, None if groups else scratch.data_ptr(),
                 scratch.data_ptr() if groups else None, dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), b, h, tq, tk, d, groups, float(scale), float(rate))
    _count(bias_attention_backward, rate)
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def bias_backward_scratch(b: int, h: int, tq: int, tk: int, d: int
                          ) -> Tuple[int, Tuple[int, ...]]:
    """(G, shape) of ``csrc/bias_attention_bwd.cu`` at this shape: its
    query-tile groups G and the shape of the fp32 scratch that
    ``bias_attention_backward`` allocates for it. G = 0 is the two-pass form,
    whose scratch is delta [B, H, TQ]; G > 0 the fused pass, whose scratch is
    the groups' dK/dV partials [2, G, B, H, TK, D]. G comes from the built
    library, which owns the tile sizes."""
    groups = build.bind(*_BIAS_BWD_GROUPS)(b, h, tq, tk, d)
    return groups, ((2, groups, b, h, tk, d) if groups else (b, h, tq))


class _BiasAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, rate, differentiate):
        out, stats = bias_attention_forward(q, k, v, bias, scale, rate, seed,
                                            differentiate)
        if differentiate:
            ctx.save_for_backward(q, k, v, bias, out, stats, seed)
            ctx.scale, ctx.rate = scale, rate
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v, bias, out, stats, seed = ctx.saved_tensors
        grads = bias_attention_backward(q, k, v, bias, g.contiguous(), out, stats, seed,
                                        ctx.scale, ctx.rate)
        return (*grads, None, None, None, None, None)


def bias_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   bias: torch.Tensor, scale: float, dropout_rate: float = 0.0,
                   seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention under an additive bias that carries the whole mask. q
    [B, H, TQ, D], k/v [B, H, TK, D] float32 or bfloat16 (as
    ``masked_attention``), bias [B, TQ, TK] float32, any TQ and TK, D a
    multiple of 8 up to 256. Returns [B, H, TQ, D] float32. Dropout and
    gradients as ``masked_attention``; the bias is a constant."""
    return _BiasAttention.apply(q, k, v, bias, seed, scale, float(dropout_rate),
                                _differentiate(q, k, v))


# ---------------------------------------------------------------------------
# Rel-pos attention
# ---------------------------------------------------------------------------


def relpos_attention_forward(q_u, q_v, k, v, p, bias, scale, rate=0.0, seed=None,
                             want_stats=False):
    """``relpos_attention`` outside autograd: (out, stats) as
    ``masked_attention_forward``."""
    _check_rate(rate)
    b, h, t, d = q_u.shape
    if not build.on_card(q_u, "relpos_attention"):
        return relpos_attention_reference(
            q_u, q_v, k, v, p, bias, scale, _keep_or_none(seed, b, h, t, t, rate),
            rate), None
    _check_relpos(q_u, q_v, k, v, p, bias)
    _check_seed(seed, q_u.device, rate)
    out = torch.empty_like(q_u)
    stats = q_u.new_empty((b, h, t, 2)) if want_stats else None
    build.launch(_RELPOS, q_u.device, q_u.data_ptr(), q_v.data_ptr(),
                 k.data_ptr(), v.data_ptr(), p.data_ptr(), bias.data_ptr(),
                 out.data_ptr(), _ptr(seed) if rate > 0 else None, _ptr(stats), b, h, t,
                 d, p.shape[1], bias.shape[1], float(scale), float(rate))
    _count(relpos_attention, rate)
    return out, stats


def relpos_attention_backward(q_u, q_v, k, v, p, bias, g, out, stats, seed,
                              scale: float, rate: float = 0.0):
    """(dq_u, dq_v, dK, dV, dP) of ``relpos_attention``: on the card
    ``csrc/relpos_attention_bwd.cu`` (one fused pass over the scores that
    writes dq_u, dq_v and per-query-tile dK/dV/dP partials into a scratch of
    ``relpos_backward_scratch`` floats, then an ordered reduction; one call
    here, counted once); on the CPU ``relpos_attention_backward_reference``."""
    b, h, t, d = q_u.shape
    if not build.on_card(q_u, "relpos_attention_backward"):
        return relpos_attention_backward_reference(
            q_u, q_v, k, v, p, bias, g, scale, _keep_or_none(seed, b, h, t, t, rate),
            rate)
    _check_relpos(q_u, q_v, k, v, p, bias)
    _check_backward(g, out, stats, q_u)
    _check_seed(seed, q_u.device, rate)
    dqu, dqv, dk, dv, dp = (torch.empty_like(x) for x in (q_u, q_v, k, v, p))
    part = q_u.new_empty(relpos_backward_scratch(b, h, t, d))
    build.launch(_RELPOS_BWD, q_u.device, q_u.data_ptr(), q_v.data_ptr(), k.data_ptr(),
                 v.data_ptr(), p.data_ptr(), bias.data_ptr(), g.data_ptr(), out.data_ptr(),
                 stats.data_ptr(), _ptr(seed) if rate > 0 else None, part.data_ptr(),
                 dqu.data_ptr(), dqv.data_ptr(), dk.data_ptr(), dv.data_ptr(), dp.data_ptr(),
                 b, h, t, d, p.shape[1], bias.shape[1], float(scale), float(rate))
    _count(relpos_attention_backward, rate)
    return dqu, dqv, dk, dv, dp


@functools.lru_cache(maxsize=None)
def relpos_backward_scratch(b: int, h: int, t: int, d: int) -> int:
    """The floats of fp32 scratch ``csrc/relpos_attention_bwd.cu`` takes at
    this shape: its per-query-tile dK and dV partials and dP windows. The
    count comes from the built library, which owns the tile size."""
    n = build.bind(*_RELPOS_BWD_SCRATCH)(b, h, t, d)
    if n < 0:
        raise ValueError(f"rel-pos backward scratch at B={b}, H={h}, T={t}, D={d} "
                         "is past 2^31 - 1 floats or the head dim is not taken")
    return n


class _RelposAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_u, q_v, k, v, p, bias, seed, scale, rate, differentiate):
        out, stats = relpos_attention_forward(q_u, q_v, k, v, p, bias, scale, rate, seed,
                                              differentiate)
        if differentiate:
            ctx.save_for_backward(q_u, q_v, k, v, p, bias, out, stats, seed)
            ctx.scale, ctx.rate = scale, rate
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q_u, q_v, k, v, p, bias, out, stats, seed = ctx.saved_tensors
        grads = relpos_attention_backward(q_u, q_v, k, v, p, bias, g.contiguous(), out,
                                          stats, seed, ctx.scale, ctx.rate)
        return (*grads, None, None, None, None, None)


def relpos_attention(q_u: torch.Tensor, q_v: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, p: torch.Tensor, bias: torch.Tensor,
                     scale: float, dropout_rate: float = 0.0,
                     seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rel-pos self-attention softmax(((q_u Kᵀ) + shear(q_v Pᵀ))·scale + bias)·V.
    q_u/q_v/k/v [B, H, T, D] float32, T a multiple of 64, D a multiple of 8 up
    to 256; p [H, R >= 2T-1, D]; bias [B, 1|H, T, T]. Returns [B, H, T, D].
    Dropout as ``masked_attention``; differentiable in q_u, q_v, k, v and p."""
    return _RelposAttention.apply(q_u, q_v, k, v, p, bias, seed, scale,
                                  float(dropout_rate), _differentiate(q_u, q_v, k, v, p))


for _fn in (masked_attention, bias_attention, relpos_attention, masked_attention_backward,
            bias_attention_backward, relpos_attention_backward, dropout_keep):
    _fn.launches = 0
for _fn in (masked_attention, bias_attention, masked_attention_backward,
            bias_attention_backward):
    _fn.bf16_launches = 0
masked_attention.launches_by_batch = {}
