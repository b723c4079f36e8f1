"""StreamSpeech model assembly: the offline (teacher-forced) forward and the
streaming methods (``streamspeech_tpu/models/streamspeech.py``; reference
`researches/ctc_unity/models/streamspeech_model.py:57-430`).

Conventions: PAD=1, EOS=2; the aux CTC heads' blank is index 0, the unit CTC
blank the last index. The forward takes flax's training options:
``deterministic=False`` (dropout, with an explicit ``torch.Generator``, and the
plain attention routes, or the kernel routes once ``layers.set_kernel_train``
has set the switch) and ``use_running_stats=False`` (BatchNorm's batch
statistics).

``StreamSpeechModel(cfg, dtype=torch.bfloat16)`` is the counterpart of
``StreamSpeechModel(cfg, dtype=jnp.bfloat16)``: float32 parameters (so
``weights.load_flax_variables`` loads it unchanged), bf16 compute where the
JAX modules compute in their ``dtype``. Its forward and serving run the bf16
forms of the causal, bias and not-blank kernels; rel-pos attention casts to
float32 for its kernel, as in JAX. ``train.trainer.make_train_step`` trains
it with float32 parameters and optimizer state; its kernel route launches the
bf16 training forms and bf16 backwards of the causal and bias kernels.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from streamspeech_tpu_torch.config import StreamSpeechConfig
from streamspeech_tpu_torch.kernels import policy
from streamspeech_tpu_torch.models.conformer import (
    ChunkConformerEncoder,
    EncoderStreamState,
)
from streamspeech_tpu_torch.models.layers import KVCache, StreamKVCache
from streamspeech_tpu_torch.models.transformer import (
    PAD,
    CTCHead,
    CTCTransformerUnitDecoder,
    TransformerDecoder,
    UniTransformerEncoder,
)
from streamspeech_tpu_torch.ops.masks import (
    lengths_to_mask,
    streaming_allowed_from_ctc,
    waitk_allowed,
)

EOS = 2


def ctc_not_blank_probs(logits: torch.Tensor, blank: int = 0) -> torch.Tensor:
    """P(a new token at frame t) of one aux CTC head [B, T, V] (float32 or
    bfloat16) → [B, T] float32, no gradient (`streamspeech.py:41-67`). Routes
    on the TPU gate (t >= 64, v >= 512) to the not-blank kernel, which widens
    bf16 logits inside it, else computes the plain version, which widens them
    first (:61)."""
    if policy.nb_kernel_ok(logits.shape[1], logits.shape[-1]):
        return policy.not_blank_probs(logits.contiguous(), blank)
    return policy.not_blank_probs_reference(logits.detach(), blank)


COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


class StreamSpeechModel(nn.Module):
    """The StreamSpeech model at compute dtype ``dtype`` (float32 or bfloat16;
    `streamspeech.py:70-104`), parameters float32. As in the JAX package,
    ``cfg.dtype`` is read by nothing: the constructor's ``dtype`` decides."""

    def __init__(self, cfg: StreamSpeechConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        if cfg.cascade or cfg.synthesizer_encoder_layers <= 0:
            raise NotImplementedError("only the T2U-encoder (non-cascade) "
                                      "StreamSpeech variant is ported")
        if dtype not in COMPUTE_DTYPES:
            raise NotImplementedError(f"compute dtype {dtype}: the port's kernels take "
                                      "float32 and bfloat16")
        self.cfg, self.dtype = cfg, dtype
        e, d = cfg.encoder, cfg.mt_decoder
        self.encoder = ChunkConformerEncoder(e, dtype)
        self.source_unigram_head = CTCHead(e.embed_dim, cfg.source_unigram_vocab, dtype)
        self.ctc_target_unigram_head = CTCHead(e.embed_dim,
                                               cfg.ctc_target_unigram_vocab, dtype)
        self.mt_decoder = TransformerDecoder(d, e.embed_dim, dtype)
        self.synthesizer_encoder = UniTransformerEncoder(
            d.embed_dim, d.ffn_embed_dim, d.attention_heads,
            cfg.synthesizer_encoder_layers, d.dropout, dtype)
        self.unit_decoder = CTCTransformerUnitDecoder(cfg.unit_decoder, d.embed_dim, dtype)
        self._stop_tokens: Dict[str, torch.Tensor] = {}

    def _check_generator(self, deterministic: bool,
                         generator: Optional[torch.Generator]) -> None:
        if deterministic or generator is not None:
            return
        c = self.cfg
        if max(c.encoder.dropout, c.mt_decoder.dropout, c.unit_decoder.dropout) > 0:
            raise ValueError("deterministic=False with dropout > 0 needs a "
                             "torch.Generator on the model's device (generator=...)")

    def encode(self, src_tokens, src_lengths, chunk_size=None, conv_chunk_size=None,
               deterministic: bool = True, use_running_stats: bool = True,
               generator: Optional[torch.Generator] = None):
        """Offline encoder (`streamspeech.py:106-109`). Returns (enc, lengths)."""
        self._check_generator(deterministic, generator)
        return self.encoder(src_tokens, src_lengths, chunk_size, conv_chunk_size,
                            deterministic, use_running_stats, generator)

    def forward(self, src_tokens: torch.Tensor, src_lengths: torch.Tensor,
                prev_output_tokens_mt: torch.Tensor, chunk_size: Optional[int] = 8,
                conv_chunk_size: Optional[int] = 8, k1: int = 0, n1: int = 1,
                k2: int = 0, n2: Optional[int] = None, streaming: bool = True,
                mt_mask_mode: str = "ctc", deterministic: bool = True,
                use_running_stats: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """The teacher-forced forward (`streamspeech.py:111-178`): src_tokens
        fbank [B, T, 80], src_lengths [B], prev_output_tokens_mt [B, S].
        ``streaming`` restricts the MT cross-attention with the CTC-derived mask
        (``mt_mask_mode="ctc"``, k1/n1, rounded up to ``chunk_size``) or a fixed
        wait-k mask (``"waitk"``), and the unit decoder's with wait-k k2/n2 when
        n2 is given. Returns the JAX forward's nine outputs.

        Training (`trainer.py:106-112`): ``deterministic=False`` turns dropout
        on, its keep masks drawn from ``generator`` (required when any dropout
        is above 0), and takes the plain attention routes unless the attention
        modules' ``kernel_train`` is set (``layers.set_kernel_train``);
        ``use_running_stats=False`` normalises with batch statistics and
        updates BatchNorm's running buffers in place. The not-blank kernel still
        builds the CTC mask, which carries no gradient."""
        if mt_mask_mode not in ("ctc", "waitk"):
            raise ValueError(f"mt_mask_mode must be 'ctc' or 'waitk', got {mt_mask_mode!r}")
        self._check_generator(deterministic, generator)
        drop = dict(deterministic=deterministic, generator=generator)
        enc, enc_lengths = self.encoder(src_tokens, src_lengths, chunk_size,
                                        conv_chunk_size,
                                        use_running_stats=use_running_stats, **drop)
        t_enc = enc.shape[1]
        s = prev_output_tokens_mt.shape[1]
        enc_valid = lengths_to_mask(enc_lengths, t_enc)
        asr_logits = self.source_unigram_head(enc)
        st_logits = self.ctc_target_unigram_head(enc)

        allowed_cross = None
        if streaming and mt_mask_mode == "waitk":
            allowed_cross = waitk_allowed(s, t_enc, k1, n1, n1, device=enc.device)
        elif streaming:
            asr_nb = ctc_not_blank_probs(asr_logits, blank=0)
            st_nb = ctc_not_blank_probs(st_logits, blank=0)
            eff_chunk = chunk_size if chunk_size is not None and chunk_size < 999 else None
            allowed_cross = streaming_allowed_from_ctc(
                asr_nb, st_nb, s, src_wait=k1, src_step=n1, tgt_step=n1,
                chunk_size=eff_chunk)

        mt_logits, mt_feats = self.mt_decoder(prev_output_tokens_mt, enc, enc_valid,
                                              allowed_cross, **drop)
        mt_valid = prev_output_tokens_mt != PAD
        t2u = self.synthesizer_encoder(mt_feats, mt_valid, **drop)
        unit_logits, _ = self.unit_decoder(
            t2u, mt_valid, src_wait=k2 if streaming else None,
            src_step=int(n2) if streaming and n2 is not None else None, **drop)
        return {
            "unit_logits": unit_logits,          # [B, S*up, V_units]
            "mt_logits": mt_logits,              # [B, S, V_text]
            "mt_features": mt_feats,
            "asr_logits": asr_logits,            # [B, T', V_src]
            "st_logits": st_logits,              # [B, T', V_tgt_text]
            "encoder_out": enc,
            "encoder_lengths": enc_lengths,
            "encoder_valid": enc_valid,
            "mt_valid": mt_valid,
        }

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

    def mt_decode_greedy(self, first: torch.Tensor, offset: torch.Tensor,
                         budget: torch.Tensor, self_caches: List[StreamKVCache],
                         cross_caches: List[KVCache], max_steps: int,
                         cross_valid: Optional[torch.Tensor] = None):
        """Greedy MT decode for B streams in the scan form
        (`streamspeech.py:206-237`): ``max_steps`` decoder steps, each stream
        stopping on the card at its EOS (PAD reads as EOS) or its ``budget``;
        nothing is read back, so the caller reads the three results once.
        first, offset, budget [B] on the model's device; offset is each
        stream's fed tokens, its self caches' valid length. Returns (tokens
        [B, max_steps] PAD past each stream's stop, emitted [B], hit_eos [B]).
        ``hit_eos`` counts only an EOS predicted by a step within the budget,
        where JAX's scan also reports one from the steps past it. Every step
        appends to every row's self caches, which the caller's next offsets
        (offset + emitted) cut back."""
        b = first.shape[0]
        dev = first.device
        stop_token = self._stop_token(dev)
        live = budget > 0
        emitted = torch.zeros((b,), dtype=torch.long, device=dev)
        hit_eos = torch.zeros((b,), dtype=torch.bool, device=dev)
        feed, steps = first.long(), []
        for i in range(max_steps):
            logits, _ = self.mt_decoder.step(feed[:, None], offset + i, self_caches,
                                             cross_caches, cross_valid)
            # a stopped row's later steps feed its own predictions; they are
            # neither emitted nor kept in its caches' valid length
            feed = torch.argmax(logits[:, -1], dim=-1)
            steps.append(feed)
            emits = live & ~stop_token[feed]
            hit_eos |= live ^ emits             # live rows that predicted a stop
            emitted += emits
            live = emits & (emitted < budget)
        # a row emits its first ``emitted`` steps and nothing after
        tokens = torch.stack(steps, dim=1)
        kept = torch.arange(max_steps, device=dev)[None] < emitted[:, None]
        return torch.where(kept, tokens, PAD), emitted, hit_eos

    def _stop_token(self, device) -> torch.Tensor:
        """[V] bool, True at EOS and PAD (PAD is never emitted: it reads as
        EOS), made once a device, so that a decode allocates nothing for it
        (nor inside a CUDA-graph capture)."""
        key = str(torch.device(device))
        table = self._stop_tokens.get(key)
        if table is None:
            table = torch.zeros((self.mt_decoder.embed_tokens.shape[0],),
                                dtype=torch.bool, device=device)
            table[EOS] = True
            table[PAD] = True
            self._stop_tokens[key] = table
        return table

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
        unit_logits, _ = self.unit_decoder(t2u, mt_valid, serving_positions=True)
        return torch.argmax(unit_logits, dim=-1), unit_logits

