"""Building blocks of the serving path, the offline forward and the train step:
attention with KV caches and the kernel routes, FFN, chunk-causal convolutions,
dropout and BatchNorm (the counterparts of ``streamspeech_tpu/models/layers.py``).

Batch-first ``[B, T, C]``. Attention takes boolean ``allowed`` masks (True = may
attend) and turns them into an additive NEG_INF bias. Module and parameter names
mirror the flax tree so ``weights.py`` can carry JAX weights across by name.

Unlike the JAX package, KV caches are updated in place: serving never reuses a
cache's old state, so the port writes new keys into the preallocated buffers
instead of copying them. A ``KVCache``'s write position lives on the device,
with a host mirror for the room check (the MT self caches, ``StreamKVCache``,
take one a row from their owner).

Training options follow flax: ``deterministic=False`` turns dropout on (its
keep masks drawn from an explicit ``torch.Generator``, the counterpart of
``rngs={"dropout": ...}``) and sends attention down the plain route, unless the
attention module's ``kernel_train`` is set (``set_kernel_train``, the
counterpart of ``STREAMSPEECH_PALLAS_TRAIN=1``): then training takes the
kernel routes too, forward and backward, with the attention-probability
dropout drawn inside the kernels from one seed per call. BatchNorm's
``use_running_stats=False`` normalises with the batch statistics and updates
the running ones.

Compute dtype follows flax's ``dtype`` argument (parameters stay float32, as
flax's ``param_dtype``): ``Dense`` casts its input, weight and bias to the
module's dtype; ``LayerNorm`` and ``BatchNorm`` compute their statistics and
the normalisation in fp32 from the widened input and round once at the output
(`flax/linen/normalization.py` ``_compute_stats``, ``_normalize``); attention
scores and the softmax are fp32, the probabilities cast to v's dtype; the
chunk-causal convolution casts its weight and follows type promotion for its
input, as ``jnp`` does. A float32 module computes exactly as before.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from streamspeech_tpu_torch.kernels import attention as attention_kernels
from streamspeech_tpu_torch.ops.masks import NEG_INF, causal_allowed, mask_to_bias

MASKED_KERNEL_MIN_T = 256  # the TPU gate's worth-it floor (`layers.py:56-72`)
BIAS_KERNEL_MIN_S = 512    # `layers.py:75-91`
RELPOS_KERNEL_MIN_T = 256  # `layers.py:42-53`, with T % 128 == 0


def _cast(p: Optional[torch.Tensor], dtype: torch.dtype) -> Optional[torch.Tensor]:
    return None if p is None else p.to(dtype)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias cast to ``dtype``
    (`flax/linen/linear.py` ``promote_dtype``), the product in ``dtype``;
    float32 parameters."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        _cast(self.bias, self.dtype))


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(epsilon=1e-5, dtype=...)``: statistics and the
    normalisation in fp32 from the widened input, float32 scale and bias, one
    rounding to ``dtype`` at the output. (CUDA's ``layer_norm`` takes no bf16
    input beside float32 scale and bias, so the input is widened first.)"""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__(dim)
        self.dtype = dtype

    def forward(self, x):
        return super().forward(x.float()).to(self.dtype)


def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate, drawn
    as ``bernoulli(1 - rate)`` from ``generator`` (on x's device), and divide
    the kept ones by 1 - rate taken in x's dtype (flax's ``inputs /
    keep_prob``: a Python float meets a bf16 array as bf16, 0.8984375 for
    0.9), rounded to x's dtype. Identity when ``deterministic`` or rate 0."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with deterministic=False needs a torch.Generator")
    if rate == 1.0:
        return torch.zeros_like(x)
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    keep_prob = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    return torch.where(keep.bool(), x / keep_prob, torch.zeros_like(x))


def remat(layer: nn.Module, generator: Optional[torch.Generator], *args, **kwargs):
    """``layer(*args, generator=..., **kwargs)`` recomputed in the backward
    pass instead of keeping its activations (``torch.utils.checkpoint``,
    non-reentrant): the counterpart of flax's ``nn.remat`` per layer
    (`conformer.py:221-231`, `transformer.py:628`).

    The recompute draws the masks of the first pass: ``preserve_rng_state``
    restores only the global generators, so the recompute runs on a copy of
    ``generator`` as it was before the first pass. It also writes back the
    layer's BatchNorm buffers as they were, so batch statistics update once."""
    from torch.utils.checkpoint import checkpoint

    if not torch.is_grad_enabled():
        return layer(*args, generator=generator, **kwargs)
    start = None if generator is None else generator.get_state()
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return layer(*a, generator=generator, **kwargs)
        gen = None
        if generator is not None:
            gen = torch.Generator(device=generator.device)
            gen.set_state(start)
        kept = [b.clone() for b in layer.buffers()]
        try:    # the recompute may stop early, once it has what backward needs
            return layer(*a, generator=gen, **kwargs)
        finally:
            with torch.no_grad():
                for b, k in zip(layer.buffers(), kept):
                    b.copy_(k)

    return checkpoint(run, *args, use_reentrant=False)


class BatchNorm(nn.Module):
    """BatchNorm over the last axis with flax ``nn.BatchNorm(momentum=0.9,
    epsilon=1e-5)`` semantics (`layers.py:781`, `:793-794`). With running
    statistics (eval) it is the form that makes chunk-by-chunk encoding exact
    (`conformer_layer.py:23-118`). With ``use_running_stats=False`` it
    normalises with the statistics over every leading position (padded frames
    included), the biased variance mean(x²) - mean(x)², and updates the running
    buffers in place to 0.9·running + 0.1·batch (the biased variance, where
    ``F.batch_norm`` would write the unbiased one). Statistics and the
    normalisation are fp32; the output is rounded to ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.9,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.momentum, self.dtype = eps, momentum, dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x, use_running_stats: bool = True):
        x = x.float()
        if use_running_stats:
            mean, var = self.running_mean, self.running_var
        else:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dims)
            var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(self.dtype)


class KVCache:
    """Fixed-capacity KV buffer: k, v [B, T_max, H, Dh]. The write position
    lives on the device (``pos``, a 0-dim int64 tensor, JAX's traced
    ``index``), so a captured CUDA graph that appends writes where the cache
    stands at each replay; ``index`` is its host mirror, which the room check
    reads. ``append`` writes in place."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, index: int = 0):
        self.k, self.v, self.index = k, v, int(index)
        self.pos = torch.full((), self.index, dtype=torch.long, device=k.device)
        self._positions = torch.arange(k.shape[1], device=k.device)

    @classmethod
    def create(cls, batch: int, max_len: int, num_heads: int, head_dim: int,
               device, dtype=torch.float32) -> "KVCache":
        shape = (batch, max_len, num_heads, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

    @property
    def max_len(self) -> int:
        return self.k.shape[1]

    def truncate(self, new_len: int) -> "KVCache":
        """Prune to ``new_len`` valid positions (whole-word KV truncation,
        `agent/speech_to_speech.streamspeech.agent.py:554-574`); stale entries
        are overwritten by the next append."""
        self.index = min(self.index, int(new_len))
        self.pos.fill_(self.index)
        return self

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Write S new positions at the device position ``pos``
        (`layers.py:126` ``_append_kv``'s ``dynamic_update_slice``). Returns
        (k_all, v_all, valid [T_max]). Raises, from the host mirror, where
        JAX's dynamic_update_slice would silently clamp the write position."""
        s = k_new.shape[1]
        end = self.index + s
        if end > self.max_len:
            raise ValueError(f"KV cache overflow: {self.index} + {s} > "
                             f"capacity {self.max_len}")
        rows = self.pos + self._positions[:s]
        self.k.index_copy_(1, rows, k_new.to(self.k.dtype))
        self.v.index_copy_(1, rows, v_new.to(self.v.dtype))
        self.pos += s
        self.index = end
        return self.k, self.v, self.valid()

    def valid(self) -> torch.Tensor:
        return self._positions < self.pos


class StreamKVCache:
    """A KV buffer whose rows each append at their own position (JAX's
    ``KVCache.create(..., per_example_index=True)`` and the vmapped update of
    ``_append_kv``, `layers.py:99-150`): k, v [B, max_len + headroom, H, Dh].

    The cache keeps no length of its own. Its owner holds each row's valid
    length on the host, checks the room there (an index past the buffer
    would be a device fault, where JAX's ``dynamic_update_slice`` clamps),
    and sets ``index``, the rows' write positions [B] on the device, before
    an append: ``TransformerDecoder.step`` sets it from its position
    offsets, so every layer reads one tensor. Attention reads the first
    ``max_len`` positions; ``headroom`` positions past them take the entries
    that a fixed-length scan appends after a row has stopped, which the next
    call overwrites."""

    def __init__(self, k: torch.Tensor, v: torch.Tensor, max_len: int):
        self.k, self.v, self.max_len = k, v, max_len
        self.index: Optional[torch.Tensor] = None
        self._rows = torch.arange(k.shape[0], device=k.device)[:, None]
        self._positions = torch.arange(max_len, device=k.device)[None]

    @classmethod
    def create(cls, batch: int, max_len: int, num_heads: int, head_dim: int,
               device, dtype=torch.float32, headroom: int = 0) -> "StreamKVCache":
        shape = (batch, max_len + headroom, num_heads, head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), max_len)

    @property
    def capacity(self) -> int:
        return self.k.shape[1]

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Write S new positions at each row's ``index``. Returns (k_all,
        v_all, valid [B, max_len])."""
        s = k_new.shape[1]
        pos = self.index[:, None]
        if s > 1:
            pos = pos + torch.arange(s, device=pos.device)[None]
        self.k[self._rows, pos] = k_new.to(self.k.dtype)
        self.v[self._rows, pos] = v_new.to(self.v.dtype)
        valid = self._positions < (self.index + s)[:, None]
        return self.k[:, :self.max_len], self.v[:, :self.max_len], valid


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: Optional[torch.Tensor], scale: float, rate: float = 0.0,
           deterministic: bool = True,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """q [B,S,H,D], k/v [B,T,H,D], bias broadcastable to [B,H,S,T] → [B,S,H,D]
    (`layers.py:153` ``_attend``), with dropout of rate ``rate`` on the
    attention probabilities (fairseq MHA). Scores and softmax in fp32, the
    probabilities cast to v's dtype for the product."""
    scores = torch.einsum("bshd,bthd->bhst", (q * scale).float(), k.float())
    if bias is not None:
        scores = scores + bias
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    probs = dropout(probs, rate, deterministic, generator)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _masked_kernel_ok(t: int, head_dim: int) -> bool:
    """The TPU route's shape gate (`layers.py:56-72` ``_masked_pallas_ok``).
    On the card the kernel takes every head dim this admits up to 256 and
    raises past it: the route never turns into the plain version there."""
    return t >= MASKED_KERNEL_MIN_T and head_dim % 8 == 0


def _bias_kernel_ok(s: int, head_dim: int) -> bool:
    """The bias-attention route's gate (`layers.py:75-91` ``_bias_pallas_ok``
    less its backend test)."""
    return s >= BIAS_KERNEL_MIN_S and head_dim % 8 == 0


def _relpos_kernel_ok(t: int, head_dim: int) -> bool:
    """The rel-pos route's gate (`layers.py:42-53` ``_pallas_ok`` less its
    backend test)."""
    return t >= RELPOS_KERNEL_MIN_T and t % 128 == 0 and head_dim % 8 == 0


def _rate_and_seed(rate: float, deterministic: bool,
                   generator: Optional[torch.Generator], device):
    """A kernel route's dropout rate and seed (`layers.py:313-318`): the seed
    is drawn from ``generator`` only when the rate is above 0, so a route
    without dropout leaves the random stream where it was."""
    rate = 0.0 if deterministic else float(rate)
    if rate == 0.0:
        return 0.0, None
    return rate, attention_kernels.draw_seed(generator, device)


def set_kernel_train(model: nn.Module, on: bool) -> nn.Module:
    """Set ``kernel_train`` on every attention module of ``model``: whether
    ``deterministic=False`` (training) takes the attention kernel routes, the
    counterpart of the JAX package's ``STREAMSPEECH_PALLAS_TRAIN`` variable."""
    for module in model.modules():
        if isinstance(module, (MultiHeadAttention, RelPosMultiHeadAttention)):
            module.kernel_train = bool(on)
    return model


class MultiHeadAttention(nn.Module):
    """fairseq-style MHA, self or cross (`layers.py:192`). ``kdim`` is the width
    of the keys' source when it differs from ``embed_dim`` (the MT decoder's
    cross-attention reads the narrower encoder); ``dropout`` is the rate on the
    attention probabilities."""

    def __init__(self, embed_dim: int, num_heads: int, bias: bool = True,
                 kdim: Optional[int] = None, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.num_heads, self.dropout = embed_dim, num_heads, dropout
        self.kernel_train = False     # see set_kernel_train
        kdim = embed_dim if kdim is None else kdim
        self.q_proj = Dense(embed_dim, embed_dim, bias, dtype)
        self.k_proj = Dense(kdim, embed_dim, bias, dtype)
        self.v_proj = Dense(kdim, embed_dim, bias, dtype)
        self.out_proj = Dense(embed_dim, embed_dim, bias, dtype)

    def forward(self, query: torch.Tensor,
                key_value: Optional[torch.Tensor] = None,
                allowed: Optional[torch.Tensor] = None,
                key_valid: Optional[torch.Tensor] = None,
                cache: Optional[KVCache] = None,
                cache_is_cross: bool = False,
                causal: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Routes (`layers.py:240-287`): cached self-attention appends the new
        K/V first; cached cross-attention reads a cache filled by
        ``fill_cross_cache``; without a cache and with ``deterministic`` or
        ``kernel_train``, ``causal=True`` self-attention at T >= 256 goes
        through the causal masked-attention kernel, and a per-query mask (bias
        [B|1, 1, S, T]) at S >= 512 through the bias-attention kernel, with
        the dropout inside the kernel. Otherwise ``deterministic=False`` takes
        the plain route with dropout."""
        h = self.num_heads
        dh = self.embed_dim // h
        scale = dh ** -0.5
        b, s, _ = query.shape
        kv_in = query if key_value is None else key_value
        q = self.q_proj(query).view(b, s, h, dh)
        kernels = deterministic or self.kernel_train

        if cache is not None and not cache_is_cross and key_value is None:
            k_new = self.k_proj(kv_in).view(b, s, h, dh)
            v_new = self.v_proj(kv_in).view(b, s, h, dh)
            k, v, valid = cache.append(k_new, v_new)
            out = attend(q, k, v, mask_to_bias(allowed, valid), scale)
        elif cache is not None:
            valid = cache.valid() if key_valid is None else key_valid
            out = attend(q, cache.k, cache.v, mask_to_bias(allowed, valid), scale)
        else:
            t = kv_in.shape[1]
            k = self.k_proj(kv_in).view(b, t, h, dh)
            v = self.v_proj(kv_in).view(b, t, h, dh)
            if (causal and key_value is None and allowed is None and kernels
                    and _masked_kernel_ok(t, dh)):
                out = self._causal_kernel(q, k, v, key_valid, scale, *_rate_and_seed(
                    self.dropout, deterministic, generator, q.device))
            else:
                if causal and allowed is None:
                    allowed = causal_allowed(s, device=query.device)
                bias = mask_to_bias(allowed, key_valid)
                # only a genuine per-query mask, as `layers.py:274-283`: a
                # key-valid-only [B, 1, 1, T] bias stays on the plain path
                if (bias is not None and bias.shape[1] == 1 and bias.shape[-2] == s
                        and kernels and _bias_kernel_ok(s, dh)):
                    out = self._bias_kernel(q, k, v, bias, scale, *_rate_and_seed(
                        self.dropout, deterministic, generator, q.device))
                else:
                    out = attend(q, k, v, bias, scale, self.dropout, deterministic,
                                 generator)
        out = self.out_proj(out.reshape(b, s, self.embed_dim))
        return out, cache

    @staticmethod
    def _causal_kernel(q, k, v, key_valid, scale, rate=0.0, seed=None):
        """`layers.py:289-323` ``_causal_pallas``: pad T to the 128 tile (padded
        keys masked through the [B, T] bias, padded query rows sliced off) and
        run the causal masked-attention kernel, with dropout at ``rate`` from
        ``seed`` inside it. q/k/v [B, S, H, Dh], float32 or bfloat16 (the
        kernel's bf16 form); the output in v's dtype (:323)."""
        b, s, h, dh = q.shape
        t_pad = -(-s // 128) * 128
        if key_valid is None:
            kvb = torch.zeros((b, s), dtype=torch.float32, device=q.device)
        else:
            kv2 = key_valid if key_valid.dim() == 2 else key_valid[None].expand(b, s)
            kvb = torch.where(kv2, 0.0, NEG_INF).to(torch.float32)
        kvb = F.pad(kvb, (0, t_pad - s), value=NEG_INF)
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, t_pad - s)).transpose(1, 2).contiguous()
                   for a in (q, k, v))
        out = attention_kernels.masked_attention(q, k, v, kvb[:, None, :], scale, rate,
                                                 seed)
        return out.transpose(1, 2)[:, :s].to(v.dtype)

    @staticmethod
    def _bias_kernel(q, k, v, bias, scale, rate=0.0, seed=None):
        """`layers.py:325-362` ``_bias_pallas``: the bias [B|1, 1, S, T] carries
        the whole mask; the keys are padded to the 128 tile as JAX pads them
        (zero K and V, NEG_INF bias), which decides a wholly masked query row:
        its softmax is uniform over the padded keys, so its output is the sum
        of V over T divided by T_pad, not by T. The kernel masks its own ragged
        query edge, so the queries are not padded. Dropout at ``rate`` from
        ``seed`` inside the kernel. q [B, S, H, Dh], k/v [B, T, H, Dh] →
        [B, S, H, Dh] in v's dtype (:362)."""
        b, s, _, _ = q.shape
        t = k.shape[1]
        t_pad = -(-t // 128) * 128
        b3 = F.pad(bias[:, 0].expand(b, s, t), (0, t_pad - t), value=NEG_INF).contiguous()
        q = q.transpose(1, 2).contiguous()
        k, v = (F.pad(a, (0, 0, 0, 0, 0, t_pad - t)).transpose(1, 2).contiguous()
                for a in (k, v))
        return attention_kernels.bias_attention(q, k, v, b3, scale, rate,
                                                seed).transpose(1, 2).to(v.dtype)

    def fill_cross_cache(self, key_value: torch.Tensor, cache: KVCache) -> KVCache:
        """Project encoder states once and append them to a cross-attention cache."""
        b, t, _ = key_value.shape
        h, dh = self.num_heads, self.embed_dim // self.num_heads
        cache.append(self.k_proj(key_value).view(b, t, h, dh),
                     self.v_proj(key_value).view(b, t, h, dh))
        return cache


class RelPosMultiHeadAttention(nn.Module):
    """espnet RelPositionMultiHeadedAttention (`layers.py:374-502`). ``pos_emb``
    [R, C] covers relative positions (q_offset + S - 1) ... downwards; bd[i, j]
    is read at table row rmax - (q_offset + i - j). With a cache the new K/V are
    appended first (the serving route); without one (the offline forward,
    R = 2T-1) and with ``deterministic`` or ``kernel_train`` the rel-pos kernel
    takes T >= 256, T % 128 == 0. ``dropout`` is the rate on the attention
    probabilities (`layers.py:499`), drawn inside the kernel on its route."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.num_heads, self.dropout = embed_dim, num_heads, dropout
        self.kernel_train = False     # see set_kernel_train
        dh = embed_dim // num_heads
        self.q_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.k_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.v_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.out_proj = Dense(embed_dim, embed_dim, dtype=dtype)
        self.linear_pos = Dense(embed_dim, embed_dim, bias=False, dtype=dtype)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, dh))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, dh))

    def forward(self, x: torch.Tensor, pos_emb: torch.Tensor,
                allowed: Optional[torch.Tensor], cache: Optional[KVCache] = None,
                q_offset: int = 0, key_valid: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        h = self.num_heads
        dh = self.embed_dim // h
        scale = dh ** -0.5
        b, s, _ = x.shape
        q = self.q_proj(x).view(b, s, h, dh)
        k_new = self.k_proj(x).view(b, s, h, dh)
        v_new = self.v_proj(x).view(b, s, h, dh)
        if cache is not None:
            k, v, valid = cache.append(k_new, v_new)
            key_valid = valid if key_valid is None else key_valid
        else:
            k, v = k_new, v_new
        t = k.shape[1]
        p = self.linear_pos(pos_emb).view(-1, h, dh)     # [R, H, Dh]
        r = p.shape[0]
        # float32 parameters: q_u and q_v are float32 whatever q's dtype, as in jnp
        q_u, q_v = q + self.pos_bias_u, q + self.pos_bias_v
        bias = mask_to_bias(allowed, key_valid)
        if (cache is None and (deterministic or self.kernel_train) and s == t
                and r == 2 * t - 1 and _relpos_kernel_ok(t, dh)):
            out = self._relpos_kernel(q_u, q_v, k, v, p, bias, scale, *_rate_and_seed(
                self.dropout, deterministic, generator, x.device)).to(x.dtype)
        else:
            rmax = q_offset + s - 1
            ac = torch.einsum("bshd,bthd->bhst", q_u.float(), k.float())
            bd_full = torch.einsum("bshd,rhd->bhsr", q_v.float(), p.float())
            i = torch.arange(s, device=x.device)[:, None]
            j = torch.arange(t, device=x.device)[None, :]
            u = torch.clamp(rmax - (q_offset + i - j), 0, r - 1)
            bd = torch.gather(bd_full, -1, u[None, None].expand(b, h, s, t))
            scores = (ac + bd) * scale
            if bias is not None:
                scores = scores + bias
            probs = dropout(torch.softmax(scores, dim=-1).to(v.dtype), self.dropout,
                            deterministic, generator)
            out = torch.einsum("bhst,bthd->bshd", probs, v)
        return self.out_proj(out.reshape(b, s, self.embed_dim)), cache

    @staticmethod
    def _relpos_kernel(q_u, q_v, k, v, p, bias, scale, rate=0.0, seed=None):
        """`layers.py:446-480`: [B, T, H, Dh] inputs to the kernel's
        [B, H, T, Dh]; the table [R, H, Dh] to [H, R, Dh]; the bias (chunk mask +
        key validity, [B|1, 1, T, T] or None) broadcast to [B, 1, T, T]; dropout
        at ``rate`` from ``seed`` inside the kernel. Every input is cast to
        float32 first, whatever the model's dtype (:472-476): the kernel is
        fp32 only; the caller casts the output back."""
        b, t, _, _ = q_u.shape
        if bias is None:
            bias = torch.zeros((1, 1, t, t), dtype=torch.float32, device=q_u.device)
        bias = bias.expand(b, 1, t, t).contiguous()
        q_u, q_v, k, v = (a.transpose(1, 2).float().contiguous() for a in (q_u, q_v, k, v))
        out = attention_kernels.relpos_attention(
            q_u, q_v, k, v, p.transpose(0, 1).float().contiguous(), bias, scale, rate, seed)
        return out.transpose(1, 2)


class FeedForward(nn.Module):
    """Conformer macaron FFN: LN → W1 → swish → drop → W2 → drop
    (`conformer_layer.py:121-161`, `layers.py:602-620`)."""

    def __init__(self, embed_dim: int, ffn_dim: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.layer_norm = LayerNorm(embed_dim, dtype)
        self.w_1 = Dense(embed_dim, ffn_dim, dtype=dtype)
        self.w_2 = Dense(ffn_dim, embed_dim, dtype=dtype)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        x = F.silu(self.w_1(self.layer_norm(x)))
        x = self.w_2(dropout(x, self.dropout, deterministic, generator))
        return dropout(x, self.dropout, deterministic, generator)


# ---------------------------------------------------------------------------
# Chunk-causal convolution (`researches/chunk_unity/modules/chunk_causal_conv1d.py`)
# as a masked-tap convolution: out[t] = sum_d W[:, :, d] x[t*s - pad + d], with
# the taps beyond t's chunk boundary masked.
# ---------------------------------------------------------------------------


def chunk_tap_allowed(t_out: int, kernel_size: int, stride: int,
                      chunk_size: Optional[int], device=None) -> torch.Tensor:
    """[t_out, K] bool: tap d of output t reads u = t*stride - pad + d and is
    allowed iff u < (t*stride // chunk + 1) * chunk (`layers.py:628-640`)."""
    if chunk_size is None or chunk_size >= 999:
        return torch.ones((t_out, kernel_size), dtype=torch.bool, device=device)
    tpos = torch.arange(t_out, device=device)[:, None] * stride
    u = tpos - kernel_size // 2 + torch.arange(kernel_size, device=device)[None, :]
    return u < (tpos // chunk_size + 1) * chunk_size


def _masked_taps(xp, weight, bias, stride, t_out, allowed, depthwise):
    """xp [B, T_pad, Cin] (padding included); weight [Cout, Cin, K] or depthwise
    [C, 1, K] → [B, t_out, Cout], in the promoted dtype of xp and the weight
    (a bf16 weight on an fp32 input computes in fp32, as ``jnp``'s ``@``)."""
    dt = torch.promote_types(xp.dtype, weight.dtype)
    xp, weight = xp.to(dt), weight.to(dt)
    bias = None if bias is None else bias.to(dt)
    k = weight.shape[-1]
    win = xp.unfold(1, k, stride)[:, :t_out]               # [B, t_out, Cin, K]
    win = win * allowed[None, :, None, :].to(xp.dtype)
    if depthwise:
        out = torch.einsum("btck,ck->btc", win, weight[:, 0])
    else:
        out = torch.einsum("btck,ock->bto", win, weight)
    return out if bias is None else out + bias


def chunk_causal_conv1d(x, weight, bias, stride: int, chunk_size: Optional[int],
                        depthwise: bool = False):
    """Offline form (`layers.py:643`): x [B, T, Cin], output length
    floor((T + 2*pad - K)/stride) + 1."""
    k = weight.shape[-1]
    pad = k // 2
    t_out = (x.shape[1] + 2 * pad - k) // stride + 1
    xp = F.pad(x, (0, 0, pad, pad))
    allowed = chunk_tap_allowed(t_out, k, stride, chunk_size, device=x.device)
    return _masked_taps(xp, weight, bias, stride, t_out, allowed, depthwise)


def chunk_causal_conv1d_step(x_ctx, weight, bias, stride: int,
                             chunk_size: Optional[int], depthwise: bool = False):
    """Incremental block step (`layers.py:680`). x_ctx = [left context (K//2),
    new block of Tb frames]; the block starts on a chunk boundary and
    Tb % stride == 0. Returns (out [B, Tb/stride, Cout], new_ctx [B, K//2, Cin])."""
    k = weight.shape[-1]
    pad = k // 2
    t_out = (x_ctx.shape[1] - pad) // stride
    new_ctx = x_ctx[:, x_ctx.shape[1] - pad:]
    xp = F.pad(x_ctx, (0, 0, 0, pad))
    allowed = chunk_tap_allowed(t_out, k, stride, chunk_size, device=x_ctx.device)
    return _masked_taps(xp, weight, bias, stride, t_out, allowed, depthwise), new_ctx


class ChunkCausalConv(nn.Module):
    """Holds the conv parameters: weight [Cout, Cin, K], or [C, 1, K] depthwise.
    ``forward`` is the offline convolution (`layers.py:746-749`), ``step`` the
    incremental one; both cast the weight and bias to ``dtype`` first
    (`layers.py:747-753`)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, use_bias: bool = True, depthwise: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if depthwise and in_channels != out_channels:
            raise ValueError("depthwise conv needs in_channels == out_channels")
        self.stride, self.depthwise, self.kernel_size = stride, depthwise, kernel_size
        self.dtype = dtype
        cin = 1 if depthwise else in_channels
        self.weight = nn.Parameter(torch.zeros(out_channels, cin, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def _params(self):
        return self.weight.to(self.dtype), _cast(self.bias, self.dtype)

    def forward(self, x, chunk_size: Optional[int]):
        return chunk_causal_conv1d(x, *self._params(), self.stride, chunk_size,
                                   self.depthwise)

    def step(self, x_ctx, chunk_size: Optional[int]):
        return chunk_causal_conv1d_step(x_ctx, *self._params(), self.stride, chunk_size,
                                        self.depthwise)


def cast_compute_weights_(model: nn.Module) -> nn.Module:
    """Casts, once and in place, the weight and bias of every ``Dense`` and
    ``ChunkCausalConv`` in ``model`` whose compute dtype is not float32 to that
    dtype, so that serving launches no cast of them at each call: their
    per-call ``.to`` then returns the tensor itself. The numbers are those of
    the per-call cast. For a model that only serves: the parameters become
    bf16, and a train step keeps float32 parameters and Adam state (train a
    bf16 model uncast: its ``Dense`` casts at every call, as flax's does);
    LayerNorm, BatchNorm and the embedding tables stay float32 (the MT decoder
    reads its rows uncast)."""
    for m in model.modules():
        if isinstance(m, (Dense, ChunkCausalConv)) and m.dtype != torch.float32:
            for p in (m.weight, m.bias):
                if p is not None:
                    p.data = p.data.to(m.dtype)
    return model


class ConvolutionModule(nn.Module):
    """Conformer convolution module (`conformer_layer.py:23-118`): LN →
    pointwise(2C) → GLU → chunk-causal depthwise → BatchNorm → swish →
    pointwise(C) → dropout. ``forward`` is the offline form
    (`layers.py:799-803`; batch statistics with ``use_running_stats=False``),
    ``step`` the incremental one (running statistics, no dropout)."""

    def __init__(self, embed_dim: int, depthwise_kernel_size: int = 31,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        c = embed_dim
        self.dropout = dropout
        self.layer_norm = LayerNorm(c, dtype)
        self.pointwise_conv1 = Dense(c, 2 * c, bias=False, dtype=dtype)
        self.depthwise_conv = ChunkCausalConv(c, c, depthwise_kernel_size,
                                              use_bias=False, depthwise=True, dtype=dtype)
        self.batch_norm = BatchNorm(c, dtype=dtype)
        self.pointwise_conv2 = Dense(c, c, bias=False, dtype=dtype)

    def _pre(self, x):
        a, g = self.pointwise_conv1(self.layer_norm(x)).chunk(2, dim=-1)
        return a * torch.sigmoid(g)

    def _post(self, x, use_running_stats: bool = True):
        return self.pointwise_conv2(F.silu(self.batch_norm(x, use_running_stats)))

    def forward(self, x, chunk_size: Optional[int], deterministic: bool = True,
                use_running_stats: bool = True,
                generator: Optional[torch.Generator] = None):
        x = self._post(self.depthwise_conv(self._pre(x), chunk_size), use_running_stats)
        return dropout(x, self.dropout, deterministic, generator)

    def step(self, x_new, conv_ctx, chunk_size: Optional[int],
             frame_valid: Optional[torch.Tensor] = None):
        """conv_ctx [B, K//2, C] holds the previous post-GLU activations.
        ``frame_valid`` [B, S] (B streams in lockstep): a row's frames past its
        end read as zero taps, as the single stream's right zero-padding gives
        them (`layers.py:805-819`). Returns (y, new_ctx)."""
        x = self._pre(x_new)
        if frame_valid is not None:
            x = x * frame_valid[:, :, None].to(x.dtype)
        x, new_ctx = self.depthwise_conv.step(torch.cat([conv_ctx, x], dim=1), chunk_size)
        return self._post(x), new_ctx
