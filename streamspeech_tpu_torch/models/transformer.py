"""Transformer stacks (``streamspeech_tpu/models/transformer.py``): the MT decoder
(offline forward, incremental steps, full-prefix features), the causal T2U
encoder, the NAR unit-CTC decoder (training and serving forms) and the CTC
heads.

References: `researches/ctc_unity/modules/transformer_decoder.py:39-419`,
`transformer_encoder.py:15-112`, `ctc_transformer_unit_decoder.py:25-267`,
`fairseq/fairseq/models/speech_to_speech/modules/ctc_decoder.py:11`.

``dtype`` is the compute dtype, as in the JAX modules: the MT decoder's token
embedding is read from the float32 table (`transformer.py:532-534`) and its
output projections use the table cast to the features' dtype (:536-537);
the unit decoder's positions are cast to its input's dtype (:686).
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from streamspeech_tpu_torch.config import DecoderConfig, UnitDecoderConfig
from streamspeech_tpu_torch.models.layers import (
    Dense,
    KVCache,
    LayerNorm,
    MultiHeadAttention,
    dropout,
)
from streamspeech_tpu_torch.ops.masks import causal_allowed, waitk_allowed
from streamspeech_tpu_torch.ops.pos_encoding import sinusoidal_embedding

PAD = 1  # fairseq padding index


def fairseq_positions(tokens: torch.Tensor, padding_idx: int = PAD) -> torch.Tensor:
    """Non-pad tokens get padding_idx + their 1-based position among non-pads;
    pads get padding_idx (`fairseq/fairseq/utils.py:256-266`)."""
    mask = (tokens != padding_idx).long()
    return torch.cumsum(mask, dim=1) * mask + padding_idx


def _pos_table(num_positions: int, dim: int) -> torch.Tensor:
    return torch.from_numpy(sinusoidal_embedding(num_positions, dim, PAD))


class TransformerFFN(nn.Module):
    """fc1 → relu → activation dropout → fc2 → dropout (`transformer.py:126-139`)."""

    def __init__(self, ffn_dim: int, embed_dim: int, dropout: float = 0.0,
                 activation_dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout, self.activation_dropout = dropout, activation_dropout
        self.fc1 = Dense(embed_dim, ffn_dim, dtype=dtype)
        self.fc2 = Dense(ffn_dim, embed_dim, dtype=dtype)

    def forward(self, x, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        x = dropout(F.relu(self.fc1(x)), self.activation_dropout, deterministic, generator)
        return dropout(self.fc2(x), self.dropout, deterministic, generator)


class TransformerEncoderLayer(nn.Module):
    """fairseq pre-norm encoder layer (`transformer.py:142-180`): attention
    dropout, residual dropout and the FFN's two dropouts all at ``dropout``."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(embed_dim, num_heads, dropout=dropout,
                                            dtype=dtype)
        self.self_attn_layer_norm = LayerNorm(embed_dim, dtype)
        self.ffn = TransformerFFN(ffn_dim, embed_dim, dropout, dropout, dtype)
        self.final_layer_norm = LayerNorm(embed_dim, dtype)

    def forward(self, x, allowed=None, key_valid=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        drop = dict(deterministic=deterministic, generator=generator)
        y, _ = self.self_attn(self.self_attn_layer_norm(x), None, allowed, key_valid,
                              **drop)
        x = x + dropout(y, self.dropout, **drop)
        return x + self.ffn(self.final_layer_norm(x), **drop)


class UniTransformerEncoder(nn.Module):
    """T2U synthesizer encoder over MT decoder states: pre-norm, causal
    (`transformer_encoder.py:15-77`; `transformer.py:183-209`)."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 num_layers: int, dropout: float = 0.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layers_{i}", TransformerEncoderLayer(
                embed_dim, ffn_dim, num_heads, dropout, dtype))
        self.layer_norm = LayerNorm(embed_dim, dtype)

    def forward(self, x, key_valid=None, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        allowed = causal_allowed(x.shape[1], device=x.device)
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x, allowed, key_valid, deterministic,
                                             generator)
        return self.layer_norm(x)


class TransformerDecoderLayer(nn.Module):
    """fairseq decoder layer (`transformer_layer.py`; `transformer.py:265-333`),
    pre- or post-norm. ``dropout`` follows each attention sublayer and the
    FFN; ``attention_dropout`` is on both attentions' probabilities,
    ``activation_dropout`` after the FFN's relu."""

    def __init__(self, embed_dim: int, ffn_dim: int, num_heads: int,
                 normalize_before: bool, enc_dim: int, dropout: float = 0.0,
                 attention_dropout: float = 0.0, activation_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.normalize_before, self.dropout = normalize_before, dropout
        self.self_attn = MultiHeadAttention(embed_dim, num_heads,
                                            dropout=attention_dropout, dtype=dtype)
        self.self_attn_layer_norm = LayerNorm(embed_dim, dtype)
        self.encoder_attn = MultiHeadAttention(embed_dim, num_heads, kdim=enc_dim,
                                               dropout=attention_dropout, dtype=dtype)
        self.encoder_attn_layer_norm = LayerNorm(embed_dim, dtype)
        self.ffn = TransformerFFN(ffn_dim, embed_dim, dropout, activation_dropout, dtype)
        self.final_layer_norm = LayerNorm(embed_dim, dtype)

    def _sublayer(self, x, ln, fn):
        if self.normalize_before:
            return x + fn(ln(x))
        return ln(x + fn(x))

    def forward(self, x, enc=None, allowed_cross=None, self_valid=None,
                enc_valid=None, self_cache: Optional[KVCache] = None,
                cross_cache: Optional[KVCache] = None, self_causal: bool = False,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        drop = dict(deterministic=deterministic, generator=generator)

        def self_attn(y):
            y, _ = self.self_attn(y, None, None, self_valid, self_cache,
                                  causal=self_causal, **drop)
            return dropout(y, self.dropout, **drop)

        def cross(y):
            if cross_cache is not None:
                y, _ = self.encoder_attn(y, None, allowed_cross, enc_valid, cross_cache,
                                         cache_is_cross=True, **drop)
            else:
                y, _ = self.encoder_attn(y, enc, allowed_cross, enc_valid, **drop)
            return dropout(y, self.dropout, **drop)

        x = self._sublayer(x, self.self_attn_layer_norm, self_attn)
        x = self._sublayer(x, self.encoder_attn_layer_norm, cross)
        return self._sublayer(x, self.final_layer_norm, lambda y: self.ffn(y, **drop))

    def fill_cross(self, enc_new: torch.Tensor, cross_cache: KVCache) -> KVCache:
        return self.encoder_attn.fill_cross_cache(enc_new, cross_cache)


class TransformerDecoder(nn.Module):
    """First-pass MT text decoder (`transformer.py:483-597`); ``enc_dim`` is the
    speech encoder's width."""

    def __init__(self, cfg: DecoderConfig, enc_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.base_layers:
            raise NotImplementedError("BASE expert layers are not ported")
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.embed_dim))
        self.register_buffer("pos_table", _pos_table(cfg.max_target_positions,
                                                     cfg.embed_dim), persistent=False)
        self.embed_scale = 1.0 if cfg.no_scale_embedding else math.sqrt(cfg.embed_dim)
        for i in range(cfg.layers):      # no attention or activation dropout (:498-502)
            self.add_module(f"layers_{i}", TransformerDecoderLayer(
                cfg.embed_dim, cfg.ffn_embed_dim, cfg.attention_heads,
                cfg.normalize_before, enc_dim, cfg.dropout, dtype=dtype))
        self.layer_norm = LayerNorm(cfg.embed_dim, dtype) if cfg.normalize_before else None

    def layers(self) -> List[TransformerDecoderLayer]:
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.layers)]

    def embed(self, tokens, positions):
        return self.embed_scale * self.embed_tokens[tokens] + self.pos_table[positions]

    def output_layer(self, x):
        return x @ self.embed_tokens.to(x.dtype).T

    def _final(self, x):
        return x if self.layer_norm is None else self.layer_norm(x)

    def extract_features(self, prev_output_tokens, enc, enc_valid=None,
                         allowed_cross=None, deterministic: bool = True,
                         generator: Optional[torch.Generator] = None):
        """Full-prefix features [B, S, C] (`transformer.py:539-560`)."""
        x = self.embed(prev_output_tokens, fairseq_positions(prev_output_tokens))
        x = dropout(x, self.cfg.dropout, deterministic, generator)
        self_valid = prev_output_tokens != PAD
        for layer in self.layers():
            x = layer(x, enc, allowed_cross, self_valid, enc_valid, self_causal=True,
                      deterministic=deterministic, generator=generator)
        return self._final(x)

    def forward(self, prev_output_tokens, enc, enc_valid=None, allowed_cross=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Teacher-forced decoding (`transformer.py:562-566`) with the streaming
        mask ``allowed_cross`` ([B|1, S, T] or None) on the cross-attention.
        Returns (logits [B, S, V], features [B, S, C])."""
        x = self.extract_features(prev_output_tokens, enc, enc_valid, allowed_cross,
                                  deterministic, generator)
        return self.output_layer(x), x

    def step(self, tokens_new, position_offset, self_caches, cross_caches,
             cross_valid: Optional[torch.Tensor] = None):
        """Incremental decode of tokens_new [B, S_new] after ``position_offset``
        fed tokens; caches are updated in place. ``position_offset`` is an int
        with ``KVCache`` self caches, or a tensor [B] with ``StreamKVCache``
        ones, each stream decoding at its own position: the fed tokens are
        the cache's valid length, so the offsets are also the rows' write
        positions. The cross-attention reads the cache's valid length unless
        ``cross_valid`` [B, T] says each row's. Returns (logits, features)
        (`transformer.py:568-593`)."""
        b, s = tokens_new.shape
        offset = position_offset
        if torch.is_tensor(offset):
            for sc in self_caches:
                sc.index = offset
            offset = offset[:, None]
        positions = PAD + 1 + offset + torch.arange(s, device=tokens_new.device)[None]
        x = self.embed(tokens_new, positions.expand(b, s))
        for layer, sc, cc in zip(self.layers(), self_caches, cross_caches):
            x = layer(x, enc_valid=cross_valid, self_cache=sc, cross_cache=cc)
        x = self._final(x)
        return self.output_layer(x), x

    def fill_cross_caches(self, enc_new, cross_caches):
        return [layer.fill_cross(enc_new, cc)
                for layer, cc in zip(self.layers(), cross_caches)]


def unit_decoder_positions(pos_table: torch.Tensor, batch: int, time: int
                           ) -> torch.Tensor:
    """The reference quirk (`transformer.py:600-610`): every step of batch row b
    gets the constant embedding pe[PAD + 1 + b]. Returns [batch, time, C]."""
    pe = pos_table[PAD + 1:PAD + 1 + batch]
    return pe[:, None, :].expand(batch, time, pe.shape[-1])


def _repeat_frames(x: torch.Tensor, up: int) -> torch.Tensor:
    """``repeat_interleave(x, up, dim=1)`` as a broadcast copy: each frame of
    x [B, T, ...] ``up`` times, [B, T*up, ...], with no read of the repeats
    on the host (so a CUDA graph can capture it)."""
    b, t = x.shape[:2]
    return x[:, :, None].expand(b, t, up, *x.shape[2:]).reshape(b, t * up, *x.shape[2:])


class CTCTransformerUnitDecoder(nn.Module):
    """NAR upsampling unit decoder (`transformer.py:613-705`): repeat each T2U
    state ×upsample, pre-norm layers with causal self-attention (the causal
    masked-attention kernel at T >= 256) and cross-attention over the T2U
    states (width ``enc_dim``) under the wait-k mask (the bias-attention kernel
    at T >= 512), project to unit-CTC logits through the embedding table."""

    def __init__(self, cfg: UnitDecoderConfig, enc_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.n_frames_per_step != 1:
            raise NotImplementedError("stacked units (n_frames_per_step > 1) "
                                      "are not ported")
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(torch.zeros(cfg.vocab_size, cfg.embed_dim))
        self.register_buffer("pos_table", _pos_table(cfg.max_target_positions,
                                                     cfg.embed_dim), persistent=False)
        for i in range(cfg.layers):      # every dropout at cfg.dropout (:636-641)
            self.add_module(f"layers_{i}", TransformerDecoderLayer(
                cfg.embed_dim, cfg.ffn_embed_dim, cfg.attention_heads, True,
                enc_dim, cfg.dropout, cfg.dropout, cfg.dropout, dtype))
        self.layer_norm = LayerNorm(cfg.embed_dim, dtype)

    def forward(self, enc: torch.Tensor, enc_valid: Optional[torch.Tensor] = None,
                src_wait: Optional[int] = None, src_step: Optional[int] = None,
                allowed_cross: Optional[torch.Tensor] = None,
                serving_positions: bool = False, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """`transformer.py:662-705`. enc [B, T_mt, C] T2U states, enc_valid
        [B, T_mt]. ``src_step`` (n2) sets the wait-k cross mask, target step
        src_step × upsample, unless ``allowed_cross`` is given. Row b gets the
        positional embedding pe[2 + b] (the training quirk), or pe[2] for every
        row with ``serving_positions`` (the serving form). Returns (unit logits
        [B, T_mt*up, V], features)."""
        b, t_mt, _ = enc.shape
        up = self.cfg.ctc_upsample_rate
        x = _repeat_frames(enc, up)
        t_up = x.shape[1]
        x = x + unit_decoder_positions(self.pos_table, 1 if serving_positions else b,
                                       t_up).to(x.dtype)
        x = dropout(x, self.cfg.dropout, deterministic, generator)
        self_valid = (None if enc_valid is None
                      else _repeat_frames(enc_valid, up))
        if allowed_cross is None and src_step is not None:
            allowed_cross = waitk_allowed(t_up, t_mt, src_wait or 0, src_step,
                                          src_step * up, device=enc.device)
        for i in range(self.cfg.layers):
            x = getattr(self, f"layers_{i}")(x, enc, allowed_cross, self_valid,
                                             enc_valid, self_causal=True,
                                             deterministic=deterministic,
                                             generator=generator)
        x = self.layer_norm(x)
        return x @ self.embed_tokens.to(x.dtype).T, x


class CTCHead(nn.Module):
    """Linear CTC projection over encoder states."""

    def __init__(self, embed_dim: int, vocab_size: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.proj = Dense(embed_dim, vocab_size, dtype=dtype)

    def forward(self, x):
        return self.proj(x)
