"""Hidden Markov Transformer (HMT) — simultaneous text MT with latent
translating moments (ICLR'23), the serving half of
``streamspeech_tpu/models/hmt.py``.

Behavioral reference: `researches/hmt/hmt_model.py:794-1014`:

- Every target position i has K candidate translating moments
  cands[i, k] = first_read + i + k (`hmt_model.py:1001-1005`), clamped to the
  source length.
- The decoder runs all K states in parallel (target embeddings repeated ×K);
  state (i, k) cross-attends to the first cands[i,k] source tokens and
  self-attends to states of previous tokens with moments ≤ its own.
- Transition head: p(translate now | keep reading) from
  cat(decoder state, cumulative-mean encoder state at the moment)
  (`hmt_model.py:826-855`); the last state must translate.

Here: the model, the greedy simultaneous agent, the offline beam search and
the simultaneous beam search with its agent. The model's step programs are
plain functions on tensors. The training half (the HMM forward algorithm
``_construct_transition`` / ``_alpha_scan`` and ``hmt_loss``) is not ported
yet.

Both of the decoder's attentions carry a per-query mask (the [S·K, S·K]
state mask is not causal), so at S·K >= 512 both take the bias-attention
kernel route, as in JAX; neither reaches the causal kernel.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from streamspeech_tpu_torch.agents.base import ReadAction, TextSegment, WriteAction
from streamspeech_tpu_torch.config import DecoderConfig
from streamspeech_tpu_torch.models.layers import Dense, LayerNorm, dropout
from streamspeech_tpu_torch.models.text_mt import WaitkTextAgent, pad_bucket
from streamspeech_tpu_torch.models.transformer import (
    PAD,
    TransformerDecoderLayer,
    UniTransformerEncoderWithEmb,
    _pos_table,
    fairseq_positions,
)
from streamspeech_tpu_torch.registry import AGENTS

NEG = -1e9


def build_cands(tgt_len: int, first_read: int, k: int, device=None) -> torch.Tensor:
    """[tgt_len, K]: translating moment candidates (source tokens read)."""
    i = torch.arange(tgt_len, device=device)[:, None]
    return first_read + i + torch.arange(k, device=device)[None, :]


class HMTDecoder(nn.Module):
    """The HMT decoder (`hmt.py:55-134`): pre-norm decoder layers over the K
    states of each target position, the output projection tied to the
    token table, and the transition head."""

    def __init__(self, cfg: DecoderConfig, first_read: int = 3, cands_per_token: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c = cfg
        self.cfg, self.first_read, self.cands_per_token = c, first_read, cands_per_token
        self.embed_tokens = nn.Parameter(torch.zeros(c.vocab_size, c.embed_dim))
        self.register_buffer("pos_table", _pos_table(c.max_target_positions, c.embed_dim),
                             persistent=False)
        self.embed_scale = c.embed_dim ** 0.5
        for i in range(c.layers):
            self.add_module(f"layers_{i}", TransformerDecoderLayer(
                c.embed_dim, c.ffn_embed_dim, c.attention_heads, True, c.embed_dim,
                c.dropout, dtype=dtype))
        self.layer_norm = LayerNorm(c.embed_dim, dtype)
        self.transition_proj = Dense(2 * c.embed_dim, 2, bias=False, dtype=dtype)

    def forward(self, prev_output_tokens, enc, src_lengths, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Returns (emission logits [B,S,K,V], transition logits [B,S,K,2],
        cands [S,K])."""
        c = self.cfg
        k = self.cands_per_token
        b, s = prev_output_tokens.shape
        t_src = enc.shape[1]
        dev = prev_output_tokens.device
        cands = build_cands(s, self.first_read, k, dev)      # [S, K]
        flat_cands = cands.reshape(-1)                       # [S*K]

        x = self.embed_scale * self.embed_tokens[prev_output_tokens] + \
            self.pos_table[fairseq_positions(prev_output_tokens)]
        x = x.repeat_interleave(k, dim=1)                    # [B, S*K, C]
        x = dropout(x, c.dropout, deterministic, generator)

        # self-attn: (i,k) sees (i',k') iff i' < i and cands' <= cands, or self
        tok_idx = torch.arange(s, device=dev).repeat_interleave(k)
        same = torch.eye(s * k, dtype=torch.bool, device=dev)
        earlier = tok_idx[None, :] < tok_idx[:, None]
        moment_ok = flat_cands[None, :] <= flat_cands[:, None]
        allowed_self = same | (earlier & moment_ok)

        # cross-attn: (i,k) sees source j < cands[i,k] (padding via enc_valid)
        j = torch.arange(t_src, device=dev)[None, :]
        allowed_cross = j < flat_cands[:, None]
        enc_valid = j < src_lengths[:, None]

        self_valid = (prev_output_tokens != PAD).repeat_interleave(k, dim=1)
        for i in range(c.layers):
            x = getattr(self, f"layers_{i}")(
                x, enc, allowed_cross, self_valid, enc_valid, deterministic=deterministic,
                generator=generator, allowed_self=allowed_self)
        x = self.layer_norm(x)

        emission = (x @ self.embed_tokens.to(x.dtype).T).reshape(b, s, k, c.vocab_size)

        # transition features: decoder state + cumulative-mean encoder state at
        # the (clamped) moment (`hmt_model.py:826-841`)
        cummean = torch.cumsum(enc, dim=1) / torch.arange(
            1, t_src + 1, dtype=enc.dtype, device=dev)[None, :, None]
        moment = torch.clamp(torch.minimum(flat_cands[None], src_lengths[:, None]) - 1,
                             0, t_src - 1)                   # [B, S*K]
        gathered = torch.gather(cummean, 1, moment[..., None].expand(-1, -1, enc.shape[-1]))
        trans = self.transition_proj(torch.cat([x, gathered], dim=-1)).reshape(b, s, k, 2)
        # the last state must translate: mask its "keep reading" logit
        last = torch.zeros((k, 2), dtype=torch.bool, device=dev)
        last[k - 1, 0] = True
        return emission, torch.where(last, torch.full_like(trans, NEG), trans), cands


class HMTModel(nn.Module):
    """Unidirectional text encoder + HMT decoder (`hmt.py:137-165`,
    ``hmt_transformer`` arch)."""

    def __init__(self, src_vocab: int, decoder_cfg: DecoderConfig, encoder_layers: int = 6,
                 first_read: int = 3, cands_per_token: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        d = decoder_cfg
        self.decoder_cfg, self.first_read, self.cands_per_token = d, first_read, cands_per_token
        self.encoder = UniTransformerEncoderWithEmb(
            d.embed_dim, d.ffn_embed_dim, d.attention_heads, encoder_layers, src_vocab,
            d.dropout, unidirectional=True, dtype=dtype)
        self.decoder = HMTDecoder(d, first_read, cands_per_token, dtype)

    def forward(self, src_tokens, src_lengths, prev_output_tokens, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        enc = self.encoder(src_tokens, deterministic, generator)
        return self.decoder(prev_output_tokens, enc, src_lengths, deterministic, generator)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def _model_step(model: HMTModel, src: np.ndarray, src_len: np.ndarray, prev: np.ndarray):
    """The model on host arrays, on its own device: (emission, transition)."""
    dev = _device_of(model)
    em, tr, _ = model(torch.from_numpy(src).to(dev), torch.from_numpy(src_len).to(dev),
                      torch.from_numpy(prev).to(dev))
    return em, tr


@AGENTS.register("hmt_text")
class HMTAgent(WaitkTextAgent):
    """Simultaneous inference policy (`hmt.py:249-345`;
    `agent/mt/hmt_sim_sequence_generator.py` role): at target position i with
    n source tokens read, the active state is k = n - first_read - i; READ
    while the transition head prefers reading and k < K-1, else WRITE the
    argmax token. The model runs on the card unless ``device="cpu"``."""

    def __init__(self, model: HMTModel, src_dict, tgt_dict, max_len: int = 100,
                 device="cuda"):
        super().__init__(model, src_dict, tgt_dict, max_len=max_len, device=device)

    def policy(self):
        fr = self.model.first_read
        kk = self.model.cands_per_token
        n_src = len(self.states.source)
        i = len(self.hyp)
        finished = self.states.source_finished
        k = n_src - fr - i
        if not finished and k < 0:
            return ReadAction()
        k = max(0, min(k, kk - 1)) if not finished else kk - 1

        src_ids = [self.src_dict.index(w) for w in self.states.source] or \
            [self.src_dict.eos()]
        em, tr = _model_step(self.model, pad_bucket(src_ids),
                             np.asarray([len(src_ids)], np.int64),
                             pad_bucket([self.tgt_dict.eos()] + self.hyp))
        tok_k = torch.argmax(em[0, i], dim=-1).cpu().numpy()
        tr_k = F.log_softmax(tr.float(), dim=-1)[0, i].cpu().numpy()
        translate = finished or float(tr_k[k, 1]) >= float(tr_k[k, 0]) or k >= kk - 1
        if not translate:
            return ReadAction()
        nxt = int(tok_k[k])
        done = finished and (nxt == self.tgt_dict.eos() or len(self.hyp) + 1 >= self.max_len)
        if nxt == self.tgt_dict.eos():
            self.states.target_finished = True
            return WriteAction(TextSegment(content="", finished=True), finished=True)
        self.hyp.append(nxt)
        if done:
            self.states.target_finished = True
        return WriteAction(TextSegment(content=self.tgt_dict[nxt], finished=done),
                           finished=done)


# ---------------------------------------------------------------------------
# offline beam generation
# ---------------------------------------------------------------------------


def _beam_step(model: HMTModel, src, src_len, prev, pos: int) -> np.ndarray:
    """Each row's emission log-probs [B, V] at target position ``pos``, read
    at its FIRST state whose transition says translate (p >= 0.5), the last
    state where none does (`hmt.py:358-374`)."""
    em, tr = _model_step(model, src, src_len, prev)
    tp = torch.softmax(tr.float(), dim=-1)[:, pos]                  # [B,K,2]
    ok = tp[:, :, 1] >= 0.5
    sel = torch.where(ok.any(dim=1), torch.argmax(ok.int(), dim=1),
                      torch.full_like(ok[:, 0], model.cands_per_token - 1, dtype=torch.long))
    lp = F.log_softmax(em.float(), dim=-1)[:, pos]                  # [B,K,V]
    lp = torch.gather(lp, 1, sel[:, None, None].expand(-1, 1, lp.shape[-1]))[:, 0]
    return lp.cpu().numpy()


def hmt_beam_generate(model: HMTModel, src_ids, beam_size: int = 5, max_len: int = 100,
                      len_penalty: float = 1.0, min_len: int = 1, eos: int = 2,
                      pad: int = PAD):
    """Offline HMT beam search (`hmt.py:377-456`;
    `agent/mt/hmt_sequence_generator.py:207-728`), on the model's device.

    Per beam row at each step, the active HMM state is the FIRST candidate
    whose transition head says translate (p >= 0.5, `:443` next_selected_idx;
    the last state is forced to translate by the model); emission log-probs
    are gathered at that state and stepped with fairseq beam mechanics:
    2*beam candidate expansion, EOS hypotheses finalized with score /
    (len ** len_penalty) (`fairseq/sequence_generator.py` semantics), pad
    never selected, EOS banned before ``min_len`` and forced at ``max_len``.

    Returns a list of (tokens: List[int] without EOS, score: float), best
    first. The beam rows run as one batch, the prefix padded to a multiple
    of 8; one host read a step.
    """
    bsz = beam_size
    n_src = len(src_ids)
    src = pad_bucket(src_ids, rows=bsz)
    src_len = np.full((bsz,), n_src, np.int64)

    tokens = np.full((bsz, max_len + 2), pad, np.int64)
    tokens[:, 0] = eos  # fairseq convention: prev starts with EOS
    scores = np.zeros((bsz,), np.float64)
    scores[1:] = -np.inf  # step 0: all beams identical — keep only row 0
    finalized = []  # (score_normalized, tokens)

    for step_i in range(max_len + 1):
        pm = -(-(step_i + 1) // 8) * 8
        prev = np.full((bsz, pm), pad, np.int64)
        prev[:, :step_i + 1] = tokens[:, :step_i + 1]
        lp = _beam_step(model, src, src_len, prev, step_i).astype(np.float64)
        lp[:, pad] = -np.inf
        if step_i < min_len:
            lp[:, eos] = -np.inf
        if step_i >= max_len:
            keep = lp[:, eos].copy()
            lp[:] = -np.inf
            lp[:, eos] = keep
        cand = scores[:, None] + lp                     # [B, V]
        flat = cand.reshape(-1)
        top = np.argsort(-flat)[: 2 * bsz]
        new_rows = []
        for f in top:
            b, t = divmod(int(f), lp.shape[1])
            sc = flat[f]
            if not np.isfinite(sc):
                continue
            if t == eos:
                norm = sc / float((step_i + 1) ** len_penalty)
                finalized.append((norm, tokens[b, 1:step_i + 1].tolist()))
            elif len(new_rows) < bsz:
                new_rows.append((b, t, sc))
        if len(finalized) >= bsz or not new_rows:
            break
        order = np.asarray([b for b, _, _ in new_rows], np.int64)
        tokens = tokens[order]
        tokens[:, step_i + 1] = [t for _, t, _ in new_rows]
        scores = np.asarray([sc for _, _, sc in new_rows], np.float64)
        if len(new_rows) < bsz:  # pad dead rows (keep shapes static)
            k = bsz - len(new_rows)
            tokens = np.concatenate([tokens, tokens[-1:].repeat(k, 0)], 0)
            scores = np.concatenate([scores, np.full((k,), -np.inf)])
    finalized.sort(key=lambda x: -x[0])
    return [(toks, float(sc)) for sc, toks in finalized[:bsz]]


# ---------------------------------------------------------------------------
# simultaneous beam generation
# ---------------------------------------------------------------------------


def sim_step(model: HMTModel, src: np.ndarray, prev: np.ndarray, pos: int, num_read: int):
    """The sim beam's step: emission log-probs [B,K,V] and transition probs
    [B,K,2] of ALL candidate states at target position ``pos``, the
    cross-attention clipped to the first ``num_read`` source tokens (the
    unidirectional encoder makes full-encode + length-clamp exactly equal
    to the reference's partial-encoder slicing,
    `hmt_sim_sequence_generator.py:755-771`)."""
    em, tr = _model_step(model, src, np.full((src.shape[0],), num_read, np.int64), prev)
    lp = F.log_softmax(em.float(), dim=-1)[:, pos]
    tp = torch.softmax(tr.float(), dim=-1)[:, pos]
    return lp.cpu().numpy(), tp.cpu().numpy()


def hmt_sim_beam_generate(model: HMTModel, src_ids, src_finished: bool,
                          prefix_tokens=None, num_read_start: int = 1,
                          beam_size: int = 5, max_len: int = 100,
                          len_penalty: float = 1.0, min_len: int = 1,
                          eos: int = 2, pad: int = PAD, step_fn=None):
    """SIMULTANEOUS beam search with HMM read-states per hypothesis
    (`hmt.py:481-640`; `agent/mt/hmt_sim_sequence_generator.py:206-753`).
    Decoding interleaves READs with beam WRITE steps:

    - while ``num_read - first_read - step < 0`` the generator must READ
      (`:434-436`); when the low-boundary state's translate probability is
      below 0.5 it keeps READing within the candidate window (`:464-470`);
    - each beam row then translates from its FIRST state with
      p(translate) >= 0.5, transitions for states already passed by the
      running-max read being masked to 0 (`:456-461, 486-489`);
    - when more source is wanted but none is available and the source is
      unfinished, ``return_read_flag`` forces EOS (`:438-440, 472-481`) so
      the caller can commit the stable tokens and READ;
    - standard fairseq beam mechanics otherwise: 2x-beam candidate
      expansion, EOS finalization with score/len**penalty, per-row reorder
      of the read trace (`:422-431`).

    Returns (finalized, return_read_flag, num_read) where finalized is a
    best-first list of (tokens WITHOUT the forced/natural EOS, score,
    reads) and ``reads[i]`` is the running-max source tokens read when
    token i was emitted — the READ/WRITE trace.

    ``step_fn(prev [B,S], pos, num_read) -> (lprobs [B,K,V], tprobs
    [B,K,2])`` overrides the model's step (``sim_step``; testing with
    constructed HMMs); only ``model.first_read`` and
    ``model.cands_per_token`` are read then.
    """
    fr, kk = model.first_read, model.cands_per_token
    n_src = len(src_ids)
    if step_fn is None:
        src = pad_bucket(src_ids, rows=beam_size)

        def step_fn(prev, pos, num_read):
            return sim_step(model, src, prev, pos, num_read)

    bsz = beam_size
    tokens = np.full((bsz, max_len + 2), pad, np.int64)
    tokens[:, 0] = eos
    start = 0
    if prefix_tokens:
        tokens[:, 1:len(prefix_tokens) + 1] = prefix_tokens
        start = len(prefix_tokens)
    scores = np.zeros((bsz,), np.float64)
    scores[1:] = -np.inf
    reads = np.zeros((bsz, max_len + 2), np.int64)
    n_reads = start
    finalized = []
    num_read = min(max(num_read_start, 1), n_src)
    return_read_flag = False

    step_i = start
    while step_i < max_len + 1:
        finish_read = num_read >= n_src
        if num_read - fr - step_i < 0 and not finish_read:
            num_read += 1
            continue
        if num_read - fr - step_i < 0 and finish_read and not src_finished:
            return_read_flag = True

        pm = -(-(step_i + 1) // 8) * 8
        prev = np.full((bsz, pm), pad, np.int64)
        prev[:, :step_i + 1] = tokens[:, :step_i + 1]
        lp, tp = step_fn(prev, step_i, num_read)
        lp = np.asarray(lp, np.float64)
        tp = np.asarray(tp, np.float64)

        # running-max read monotonicity: states whose candidate moment lies
        # before what a row has already read cannot be selected (`:456-461`)
        cands_row = np.minimum(fr + step_i + np.arange(kk), n_src)  # [K]
        if n_reads > start or start > 0:
            prev_read = reads[:, n_reads - 1] if n_reads > 0 else \
                np.zeros((bsz,), np.int64)
            t_masked = np.where(cands_row[None, :] < prev_read[:, None], 0.0, tp[:, :, 1])
        else:
            t_masked = tp[:, :, 1]

        k_low = num_read - fr - step_i
        if (k_low < kk and not finish_read
                and t_masked[0, max(k_low, 0)] < 0.5):
            num_read += 1
            continue
        if (k_low < kk and not src_finished and not return_read_flag
                and finish_read and t_masked[0, max(k_low, 0)] < 0.5):
            return_read_flag = True

        ok = t_masked >= 0.5                             # [B, K]
        sel = np.where(ok.any(1), ok.argmax(1), 0)       # first True (`:486`)
        row_lp = np.take_along_axis(lp, sel[:, None, None].repeat(
            lp.shape[2], 2), axis=1)[:, 0]               # [B, V]

        read_now = np.maximum(
            np.full((bsz,), num_read, np.int64),
            reads[:, n_reads - 1] if n_reads > 0 else np.zeros((bsz,), np.int64))
        row_lp[:, pad] = -np.inf
        if return_read_flag:
            keep = row_lp[:, eos].copy()
            row_lp[:] = -np.inf
            row_lp[:, eos] = keep
        if step_i < min_len:
            row_lp[:, eos] = -np.inf
        if step_i >= max_len:
            keep = row_lp[:, eos].copy()
            row_lp[:] = -np.inf
            row_lp[:, eos] = keep

        cand = scores[:, None] + row_lp
        flat = cand.reshape(-1)
        top = np.argsort(-flat)[: 2 * bsz]
        new_rows = []
        for f in top:
            b, t = divmod(int(f), row_lp.shape[1])
            sc = flat[f]
            if not np.isfinite(sc):
                continue
            if t == eos:
                norm = sc / float((step_i + 1) ** len_penalty)
                finalized.append((norm, tokens[b, 1:step_i + 1].tolist(),
                                  reads[b, :n_reads].tolist()))
            elif len(new_rows) < bsz:
                new_rows.append((b, t, sc))
        if len(finalized) >= bsz or not new_rows:
            break
        order = np.asarray([b for b, _, _ in new_rows], np.int64)
        tokens = tokens[order]
        tokens[:, step_i + 1] = [t for _, t, _ in new_rows]
        reads = reads[order]
        reads[:, n_reads] = read_now[order]
        n_reads += 1
        scores = np.asarray([sc for _, _, sc in new_rows], np.float64)
        if len(new_rows) < bsz:
            k = bsz - len(new_rows)
            tokens = np.concatenate([tokens, tokens[-1:].repeat(k, 0)], 0)
            reads = np.concatenate([reads, reads[-1:].repeat(k, 0)], 0)
            scores = np.concatenate([scores, np.full((k,), -np.inf)])
        step_i += 1

    finalized.sort(key=lambda x: -x[0])
    out = [(toks, float(sc), rd) for sc, toks, rd in finalized[:bsz]]
    return out, return_read_flag, num_read


@AGENTS.register("hmt_text_beam")
class HMTSimBeamAgent(HMTAgent):
    """Simultaneous HMT agent with BEAM decoding (`hmt.py:641-`) — the quality
    path between the greedy sim agent and the offline beam: each policy call
    re-runs the sim beam over the available source with the committed
    hypothesis as the beam prefix; tokens decoded before the generator
    demanded more source are committed and written
    (`agent/mt/hmt_sim_sequence_generator.py` semantics; READ surfaces as
    return_read_flag)."""

    def __init__(self, model: HMTModel, src_dict, tgt_dict, beam_size: int = 5,
                 max_len: int = 100, device="cuda"):
        super().__init__(model, src_dict, tgt_dict, max_len=max_len, device=device)
        self.beam_size = beam_size

    def reset(self):
        super().reset()
        self._num_read = 1

    def policy(self):
        finished = self.states.source_finished
        src_ids: List[int] = [self.src_dict.index(w) for w in self.states.source] or \
            [self.src_dict.eos()]
        out, need_read, self._num_read = hmt_sim_beam_generate(
            self.model, src_ids, finished, prefix_tokens=list(self.hyp),
            num_read_start=self._num_read, beam_size=self.beam_size, max_len=self.max_len,
            eos=self.tgt_dict.eos())
        if not out:
            if finished:
                self.states.target_finished = True
                return WriteAction(TextSegment(content="", finished=True), finished=True)
            return ReadAction()
        toks = out[0][0]
        new = toks[len(self.hyp):]
        if need_read and not finished:
            if not new:
                return ReadAction()
            self.hyp.extend(new)
            return WriteAction(TextSegment(
                content=" ".join(self.tgt_dict[t] for t in new), finished=False),
                finished=False)
        # finalized naturally (EOS with the available source)
        self.hyp.extend(new)
        done = finished
        if done:
            self.states.target_finished = True
        return WriteAction(TextSegment(
            content=" ".join(self.tgt_dict[t] for t in new), finished=done),
            finished=done)
