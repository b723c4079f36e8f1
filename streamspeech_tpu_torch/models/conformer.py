"""Chunk Conformer speech encoder, offline and incremental
(``streamspeech_tpu/models/conformer.py``; reference
`researches/chunk_unity/models/s2t_conformer.py:37-213`).

fbank [B, T, 80] → Conv1dSubsampler (2 × stride-2 chunk-causal conv + GLU) →
×sqrt(d) → Linear → N conformer layers (FFN·½ → rel-pos MHSA with the chunk
mask → conv module → FFN·½ → LN). ``forward`` encodes a whole utterance (the
rel-pos kernel route at T >= 256 in eval mode, and in training on the kernel
train route; dropout and batch statistics in training); ``encode_block``
encodes one new block against the caches, and the chunk mask makes that
exactly the offline encoding's rows. Only the ``rel_pos`` encoder is ported.

``dtype`` is the compute dtype (flax's): the fbank input stays float32 through
the subsampler (its bf16 weights promote to the input's fp32, as in ``jnp``),
the linear after it casts to ``dtype``, the rel-pos table and the streaming
caches are made in ``dtype`` (`conformer.py:267-268`, :326-332).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from streamspeech_tpu_torch.config import EncoderConfig
from streamspeech_tpu_torch.models.layers import (
    ChunkCausalConv,
    ConvolutionModule,
    Dense,
    FeedForward,
    KVCache,
    LayerNorm,
    RelPosMultiHeadAttention,
    dropout,
)
from streamspeech_tpu_torch.ops.masks import chunk_allowed, lengths_to_mask
from streamspeech_tpu_torch.ops.pos_encoding import rel_pos_encoding


@dataclasses.dataclass
class EncoderStreamState:
    """Incremental-encoding state: subsampler conv tails (input-rate frames),
    per-layer depthwise-conv tails, per-layer attention KV caches, and the
    encoder frames emitted so far: ``pos_dev`` on the device (a 0-dim int64
    tensor, JAX's traced ``pos``), which the block step reads, and ``pos``,
    its host mirror. A block step updates every tensor in place, so a
    captured CUDA graph of it advances the same state at each replay."""

    sub_ctx: List[torch.Tensor]
    conv_ctx: List[torch.Tensor]
    kv: List[KVCache]
    pos_dev: torch.Tensor
    pos: int = 0


def _glu(x):
    a, g = x.chunk(2, dim=-1)
    return a * torch.sigmoid(g)


class Conv1dSubsampler(nn.Module):
    """2 × (chunk-causal conv stride 2 + GLU): 80 → conv_channels/2 → embed_dim
    (`chunk_unity/modules/convolution.py:36-60`)."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        n = len(cfg.conv_kernel_sizes)
        in_ch = cfg.input_feat_per_channel * cfg.input_channels
        for i, k in enumerate(cfg.conv_kernel_sizes):
            out_ch = cfg.conv_channels if i < n - 1 else cfg.embed_dim * 2
            self.add_module(f"conv_{i}", ChunkCausalConv(in_ch, out_ch, k, stride=2,
                                                         dtype=dtype))
            in_ch = out_ch // 2
        self.n_convs = n

    def convs(self) -> List[ChunkCausalConv]:
        return [getattr(self, f"conv_{i}") for i in range(self.n_convs)]

    def forward(self, x, conv_chunk_size: Optional[int]):
        """Offline (`conformer.py:90-95`): x [B, T, F] → [B, out_length(T), C]."""
        for conv in self.convs():
            x = _glu(conv(x, conv_chunk_size))
        return x

    @staticmethod
    def out_length(in_length):
        """((L - 1) // 2 + 1), twice (`conformer.py:123-129`)."""
        for _ in range(2):
            in_length = (in_length - 1) // 2 + 1
        return in_length

    def step(self, x_block, ctxs, conv_chunk_size, valid_len=None):
        """x_block [B, Tb, F] (Tb divisible by 4); ctxs = per-conv input tails.
        ``valid_len`` (final partial block only): real frames in the block, an
        int or a tensor [B] (B streams in lockstep, each its own); the frames
        past ceil(valid/2) of each level are zeroed, as the offline conv's right
        zero-padding would make them (`conformer.py:97-121`)."""
        new_ctxs = []
        for conv, ctx in zip(self.convs(), ctxs):
            x_block, new_ctx = conv.step(torch.cat([ctx, x_block], dim=1),
                                         conv_chunk_size)
            new_ctxs.append(ctx.copy_(new_ctx))
            x_block = _glu(x_block)
            if valid_len is not None:
                valid_len = -(-valid_len // 2)
                r = torch.arange(x_block.shape[1], device=x_block.device)
                keep = (r[None] < valid_len[:, None] if torch.is_tensor(valid_len)
                        else (r < valid_len)[None])
                x_block = x_block * keep[:, :, None].to(x_block.dtype)
        return x_block, new_ctxs


class ConformerLayer(nn.Module):
    """`chunk_unity/modules/conformer_layer.py:167-312` (rel-pos espnet attention)."""

    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.pos_enc_type != "rel_pos":
            raise NotImplementedError(f"pos_enc_type {cfg.pos_enc_type!r}: only "
                                      "'rel_pos' is ported")
        self.dropout = cfg.dropout
        self.ffn1 = FeedForward(cfg.embed_dim, cfg.ffn_embed_dim, cfg.dropout, dtype)
        self.self_attn_layer_norm = LayerNorm(cfg.embed_dim, dtype)
        self.self_attn = RelPosMultiHeadAttention(cfg.embed_dim, cfg.attention_heads,
                                                  cfg.dropout, dtype)
        self.conv_module = ConvolutionModule(cfg.embed_dim, cfg.depthwise_conv_kernel_size,
                                             cfg.dropout, dtype)
        self.ffn2 = FeedForward(cfg.embed_dim, cfg.ffn_embed_dim, cfg.dropout, dtype)
        self.final_layer_norm = LayerNorm(cfg.embed_dim, dtype)

    def forward(self, x, pos_emb, allowed, key_valid, conv_chunk_size,
                deterministic: bool = True, use_running_stats: bool = True,
                generator: Optional[torch.Generator] = None):
        """Offline layer (`conformer.py:174-189`)."""
        drop = dict(deterministic=deterministic, generator=generator)
        x = x + 0.5 * self.ffn1(x, **drop)
        y, _ = self.self_attn(self.self_attn_layer_norm(x), pos_emb, allowed,
                              key_valid=key_valid, **drop)
        x = x + dropout(y, self.dropout, **drop)                  # self_attn_dropout
        x = x + self.conv_module(x, conv_chunk_size, use_running_stats=use_running_stats,
                                 **drop)
        x = x + 0.5 * self.ffn2(x, **drop)
        return self.final_layer_norm(x)

    def step(self, x, pos_emb, allowed, kv: KVCache, conv_ctx, q_offset: int,
             conv_chunk_size, frame_valid: Optional[torch.Tensor] = None):
        """Incremental block step (`conformer.py:191`). Returns (y, kv, conv_ctx')."""
        x = x + 0.5 * self.ffn1(x)
        y, kv = self.self_attn(self.self_attn_layer_norm(x), pos_emb, allowed, kv,
                               q_offset)
        x = x + y
        y, conv_ctx = self.conv_module.step(x, conv_ctx, conv_chunk_size, frame_valid)
        x = x + y
        x = x + 0.5 * self.ffn2(x)
        return self.final_layer_norm(x), kv, conv_ctx


class ChunkConformerEncoder(nn.Module):
    def __init__(self, cfg: EncoderConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.speaker_embed_dim:
            raise NotImplementedError("speaker_embed_dim: the encoder's spk_emb_proj is "
                                      "not ported (ROADMAP §A item 8)")
        self.cfg, self.dtype = cfg, dtype
        self.subsample = Conv1dSubsampler(cfg, dtype)
        self.linear = Dense(cfg.embed_dim, cfg.embed_dim, dtype=dtype)
        for i in range(cfg.layers):
            self.add_module(f"layers_{i}", ConformerLayer(cfg, dtype))
        self.embed_scale = 1.0 if cfg.no_scale_embedding else math.sqrt(cfg.embed_dim)
        self._rel_tables: Dict[Tuple[int, str], torch.Tensor] = {}
        self._aranges: Dict[Tuple[int, str], torch.Tensor] = {}

    def layers(self) -> List[ConformerLayer]:
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.layers)]

    def forward(self, src_tokens: torch.Tensor, src_lengths: torch.Tensor,
                chunk_size: Optional[int] = None,
                conv_chunk_size: Optional[int] = None, deterministic: bool = True,
                use_running_stats: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Offline encoding of whole utterances (`conformer.py:249-292`):
        fbank [B, T, 80], lengths [B] → (encoder_out [B, T', C], out_lengths
        [B]). Attention sees its own and earlier chunks (``chunk_size`` None or
        >= 999: everything) and only valid frames. ``deterministic=False``
        turns dropout on (keep masks from ``generator``);
        ``use_running_stats=False`` takes BatchNorm's batch statistics."""
        x = self.subsample(src_tokens, conv_chunk_size)
        out_lengths = Conv1dSubsampler.out_length(src_lengths)
        t = x.shape[1]
        pos_emb = self._rel_table(t, x.device)                      # [2t-1, C]
        x = dropout(self.linear(x * self.embed_scale), self.cfg.dropout, deterministic,
                    generator)
        allowed = None
        if chunk_size is not None and chunk_size < 999:
            allowed = chunk_allowed(t, chunk_size, device=x.device)
        key_valid = lengths_to_mask(out_lengths, t)
        for layer in self.layers():
            x = layer(x, pos_emb, allowed, key_valid, conv_chunk_size, deterministic,
                      use_running_stats, generator)
        return x, out_lengths

    def init_stream_state(self, batch: int, max_frames: int,
                          device) -> EncoderStreamState:
        """max_frames = encoder-frame KV capacity (post-subsample)."""
        c = self.cfg
        dh = c.embed_dim // c.attention_heads
        sub_ctx = []
        in_ch = c.input_feat_per_channel * c.input_channels
        for conv in self.subsample.convs():
            sub_ctx.append(torch.zeros((batch, conv.kernel_size // 2, in_ch),
                                       dtype=self.dtype, device=device))
            in_ch = conv.weight.shape[0] // 2
        pad = c.depthwise_conv_kernel_size // 2
        conv_ctx = [torch.zeros((batch, pad, c.embed_dim), dtype=self.dtype, device=device)
                    for _ in range(c.layers)]
        kv = [KVCache.create(batch, max_frames, c.attention_heads, dh, device, self.dtype)
              for _ in range(c.layers)]
        return EncoderStreamState(sub_ctx, conv_ctx, kv,
                                  torch.zeros((), dtype=torch.long, device=device))

    def _steps(self, n: int, device) -> torch.Tensor:
        """arange(n) on ``device``, made once."""
        key = (n, str(device))
        if key not in self._aranges:
            self._aranges[key] = torch.arange(n, device=device)
        return self._aranges[key]

    def _rel_table(self, n: int, device) -> torch.Tensor:
        key = (n, str(device))
        if key not in self._rel_tables:
            self._rel_tables[key] = torch.from_numpy(
                rel_pos_encoding(n, self.cfg.embed_dim)).to(device, self.dtype)
        return self._rel_tables[key]

    def encode_block(self, block: torch.Tensor, state: EncoderStreamState,
                     chunk_size: int, conv_chunk_size: int, valid_len=None
                     ) -> Tuple[torch.Tensor, EncoderStreamState]:
        """Encode one new block [B, Tb, 80] (Tb = 4 × whole chunks) against the
        caches (`conformer.py:337-402`). Returns (enc [B, Tb/4, C], state');
        the state's tensors and caches are updated in place.

        ``valid_len`` as a tensor [B] (B streams in lockstep): row b holds
        ``valid_len[b]`` real frames, and its encoder frames past
        ceil(valid/4) are masked as attention keys and as depthwise-conv taps,
        so that its real frames equal its single-stream encoding; a row of 0
        (a finished stream) gives frames that the caller throws away."""
        x, state.sub_ctx = self.subsample.step(block, state.sub_ctx,
                                               conv_chunk_size, valid_len)
        s = x.shape[1]
        x = self.linear(x * self.embed_scale)
        max_frames = state.kv[0].max_len
        pos = state.pos_dev
        # table row 0 <-> relative position (pos + s - 1) (`conformer.py:367-372`):
        # rows (max_frames + s - 1) - (pos + s - 1) on, gathered at the device pos
        table = self._rel_table(max_frames + s, x.device)
        pos_emb = table.index_select(0, max_frames - pos + self._steps(s + max_frames,
                                                                       x.device))
        # query i (absolute pos+i) may see key j iff j < ((pos+i)//chunk + 1)*chunk
        q_abs = pos + self._steps(s, x.device)
        j_abs = self._steps(max_frames, x.device)[None, :]
        allowed = j_abs < (q_abs[:, None] // chunk_size + 1) * chunk_size
        frame_valid = None
        if torch.is_tensor(valid_len):
            enc_end = pos - (-valid_len // 4)                       # [B] absolute
            allowed = allowed[None] & (j_abs[None] < enc_end[:, None, None])
            frame_valid = q_abs[None] < enc_end[:, None]
        for i, layer in enumerate(self.layers()):
            x, state.kv[i], y = layer.step(
                x, pos_emb, allowed, state.kv[i], state.conv_ctx[i], state.pos,
                conv_chunk_size, frame_valid)
            state.conv_ctx[i].copy_(y)
        state.pos_dev += s
        state.pos += s
        return x, state
