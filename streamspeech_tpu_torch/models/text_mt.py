"""Simultaneous text-to-text MT: a transformer MT model with wait-k
cross-attention, and its incremental wait-k agent
(``streamspeech_tpu/models/text_mt.py``; the reference's text-MT baselines,
`researches/hmt/`, `agent/mt/*_sequence_generator.py`).

Model: a token transformer encoder (unidirectional by default,
``UniTransformerEncoderWithEmb``) and the MT ``TransformerDecoder``, with a
wait-k cross-attention mask when ``waitk`` is given. The training loss
(``text_mt_loss``) is not ported yet.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from streamspeech_tpu_torch.agents.base import (
    AgentStates,
    EmptySegment,
    ReadAction,
    TextSegment,
    WriteAction,
)
from streamspeech_tpu_torch.config import DecoderConfig
from streamspeech_tpu_torch.generation import resolve_device
from streamspeech_tpu_torch.models.transformer import (
    PAD,
    TransformerDecoder,
    UniTransformerEncoderWithEmb,
)
from streamspeech_tpu_torch.ops.masks import waitk_allowed
from streamspeech_tpu_torch.registry import AGENTS


class TextMTModel(nn.Module):
    """Wait-k capable text MT transformer (`text_mt.py:32-63`)."""

    def __init__(self, src_vocab: int, decoder_cfg: DecoderConfig, encoder_layers: int = 6,
                 unidirectional_encoder: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        d = decoder_cfg
        self.decoder_cfg = d
        self.encoder = UniTransformerEncoderWithEmb(
            d.embed_dim, d.ffn_embed_dim, d.attention_heads, encoder_layers, src_vocab,
            d.dropout, unidirectional=unidirectional_encoder, dtype=dtype)
        self.decoder = TransformerDecoder(d, d.embed_dim, dtype)

    def forward(self, src_tokens, prev_output_tokens, waitk: Optional[int] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        enc = self.encoder(src_tokens, deterministic, generator)
        enc_valid = src_tokens != PAD
        allowed_cross = None
        if waitk is not None and waitk > 0:
            allowed_cross = waitk_allowed(prev_output_tokens.shape[1], src_tokens.shape[1],
                                          src_wait=waitk, src_step=1, tgt_step=1,
                                          device=src_tokens.device)
        logits, _ = self.decoder(prev_output_tokens, enc, enc_valid, allowed_cross,
                                 deterministic, generator)
        return {"logits": logits, "encoder_out": enc}


def pad_bucket(ids, mult: int = 8, rows: int = 1) -> np.ndarray:
    """``ids`` in ``rows`` rows of PAD, the length rounded up to a multiple of
    ``mult`` (JAX buckets its shapes so; the padding is masked)."""
    m = -(-max(len(ids), 1) // mult) * mult
    arr = np.full((rows, m), PAD, np.int64)
    arr[:, :len(ids)] = ids
    return arr


@AGENTS.register("waitk_text")
class WaitkTextAgent:
    """Wait-k simultaneous text-MT policy (`text_mt.py:78-176`;
    `agent/mt/*_sequence_generator.py` role): after k source tokens, emit one
    target token per new source token. Re-encodes the (short) source prefix
    each call — exact with a unidirectional encoder. The model runs on the
    card unless ``device="cpu"``."""

    source_type = "text"
    target_type = "text"

    def __init__(self, model: TextMTModel, src_dict, tgt_dict, waitk: int = 3,
                 max_len: int = 200, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.src_dict = src_dict
        self.tgt_dict = tgt_dict
        self.waitk = waitk
        self.max_len = max_len
        self.states = AgentStates()
        self.reset()

    @torch.no_grad()
    def _step(self, src: np.ndarray, prev: np.ndarray, prev_len: int) -> int:
        out = self.model(torch.from_numpy(src).to(self.device),
                         torch.from_numpy(prev).to(self.device))
        return int(torch.argmax(out["logits"][0, prev_len - 1], dim=-1))

    def reset(self):
        self.states.reset()
        self.hyp = []

    def policy(self):
        src_words = list(self.states.source)
        finished = self.states.source_finished
        n_src = len(src_words)
        if not finished and n_src < self.waitk + len(self.hyp):
            return ReadAction()
        src_ids = [self.src_dict.index(w) for w in src_words] or [self.src_dict.eos()]
        src = pad_bucket(src_ids)
        budget = self.max_len if finished else n_src - self.waitk + 1 - len(self.hyp)
        emitted = []
        while budget > 0 and len(self.hyp) < self.max_len:
            prefix = [self.tgt_dict.eos()] + self.hyp
            nxt = self._step(src, pad_bucket(prefix), len(prefix))
            if nxt == self.tgt_dict.eos():
                break
            self.hyp.append(nxt)
            emitted.append(nxt)
            budget -= 1
            if not finished:
                break  # one token per new source token mid-stream
        text = " ".join(self.tgt_dict[t] for t in emitted)
        done = finished and (budget <= 0 or not emitted or len(self.hyp) >= self.max_len)
        if not emitted and not finished:
            return ReadAction()
        if done:
            self.states.target_finished = True
        return WriteAction(TextSegment(content=text, finished=done), finished=done)

    # GenericAgent protocol
    def push(self, segment):
        self.states.update_source(segment)

    def pop(self):
        action = self.policy()
        if action.is_read():
            return EmptySegment(finished=self.states.target_finished)
        seg = action.content
        self.states.update_target(seg)
        return seg

    def pushpop(self, segment):
        self.push(segment)
        return self.pop()
