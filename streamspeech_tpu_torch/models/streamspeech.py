"""StreamSpeech model assembly and its streaming methods
(``streamspeech_tpu/models/streamspeech.py:185-267``; reference
`researches/ctc_unity/models/streamspeech_model.py:57-430`).

Conventions: PAD=1, EOS=2; the aux CTC heads' blank is index 0, the unit CTC
blank the last index. The offline ``__call__`` (streaming-mask training
forward) belongs to a later slice.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from streamspeech_tpu_torch.config import StreamSpeechConfig
from streamspeech_tpu_torch.models.conformer import (
    ChunkConformerEncoder,
    EncoderStreamState,
)
from streamspeech_tpu_torch.models.layers import KVCache
from streamspeech_tpu_torch.models.transformer import (
    PAD,
    CTCHead,
    CTCTransformerUnitDecoder,
    TransformerDecoder,
    UniTransformerEncoder,
)
from streamspeech_tpu_torch.ops.masks import lengths_to_mask

EOS = 2


class StreamSpeechModel(nn.Module):
    def __init__(self, cfg: StreamSpeechConfig):
        super().__init__()
        if cfg.cascade or cfg.synthesizer_encoder_layers <= 0:
            raise NotImplementedError("only the T2U-encoder (non-cascade) "
                                      "StreamSpeech variant is ported")
        self.cfg = cfg
        e, d = cfg.encoder, cfg.mt_decoder
        self.encoder = ChunkConformerEncoder(e)
        self.source_unigram_head = CTCHead(e.embed_dim, cfg.source_unigram_vocab)
        self.ctc_target_unigram_head = CTCHead(e.embed_dim,
                                               cfg.ctc_target_unigram_vocab)
        self.mt_decoder = TransformerDecoder(d, e.embed_dim)
        self.synthesizer_encoder = UniTransformerEncoder(
            d.embed_dim, d.ffn_embed_dim, d.attention_heads,
            cfg.synthesizer_encoder_layers)
        self.unit_decoder = CTCTransformerUnitDecoder(cfg.unit_decoder, d.embed_dim)

    def encoder_stream_init(self, batch: int, max_frames: int,
                            device) -> EncoderStreamState:
        return self.encoder.init_stream_state(batch, max_frames, device)

    def encode_block_with_ctc(self, block, state: EncoderStreamState,
                              chunk_size: int, conv_chunk_size: int,
                              valid_len: Optional[int] = None):
        """Encode one block and return the aux-CTC argmax ids of its frames
        (the policy inputs). Returns (enc_block, state', asr_ids, st_ids)."""
        enc, state = self.encoder.encode_block(block, state, chunk_size,
                                               conv_chunk_size, valid_len)
        asr_ids = torch.argmax(self.source_unigram_head(enc), dim=-1)
        st_ids = torch.argmax(self.ctc_target_unigram_head(enc), dim=-1)
        return enc, state, asr_ids, st_ids

    def mt_decode_greedy(self, first_token: int, offset: int, budget: int,
                         self_caches: List[KVCache], cross_caches: List[KVCache],
                         max_steps: int) -> Tuple[List[int], bool]:
        """Greedy-decode up to ``min(budget, max_steps)`` MT tokens for one
        stream (`streamspeech.py:206-237`). A Python loop takes the place of the
        JAX scan and stops at EOS or the budget. Returns (tokens, hit_eos); the
        self caches hold one new entry per step, which the caller truncates to
        offset + len(tokens)."""
        feed = first_token
        device = self.mt_decoder.embed_tokens.device
        tokens: List[int] = []
        for i in range(max_steps):
            if len(tokens) >= budget:
                break
            logits, _ = self.mt_decoder.step(
                torch.tensor([[feed]], device=device), offset + i, self_caches,
                cross_caches)
            nxt = int(torch.argmax(logits[0, -1]))
            if nxt in (PAD, EOS):  # PAD is never emitted: it reads as EOS
                return tokens, True
            tokens.append(nxt)
            feed = nxt
        return tokens, False

    def mt_fill_cross(self, enc_new, cross_caches):
        return self.mt_decoder.fill_cross_caches(enc_new, cross_caches)

    def synthesize_units(self, prev_output_tokens_mt, enc, enc_len):
        """Full-prefix unit synthesis, the reference's emission path
        (`agent/...agent.py:638-700`): MT features over the prefix against the
        current encoder buffer (no streaming mask), causal T2U encoder, NAR unit
        decoder. enc [B, T_max, C]; enc_len [B] valid frames. Returns
        (argmax unit ids [B, S*up], unit logits)."""
        enc_valid = lengths_to_mask(enc_len, enc.shape[1])
        feats = self.mt_decoder.extract_features(prev_output_tokens_mt, enc,
                                                 enc_valid)
        mt_valid = prev_output_tokens_mt != PAD
        t2u = self.synthesizer_encoder(feats, mt_valid)
        unit_logits, _ = self.unit_decoder(t2u, mt_valid)
        return torch.argmax(unit_logits, dim=-1), unit_logits
