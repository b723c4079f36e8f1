"""Offline generation: ASR/ST CTC greedy + MT beam search + NAR unit CTC
(``streamspeech_tpu/generation.py``).

Behavioral reference: `researches/ctc_unity/sequence_generator_multi_decoder_ctc.py:15-331`
(the generator behind fairseq-generate for --task speech_to_speech_ctc) and the
fairseq beam search (`fairseq/fairseq/sequence_generator.py`): cumulative
log-probs, never select pad, EOS finalization with length-normalized scores
(score / len^lenpen), beam candidates 2*beam per step.

The beam lives in the batch dimension of the MT decoder's KV caches ([beam,
...]); a reorder gathers cache rows with ``index_select``. Each step's
log-probs are read on the host in float64, where the beam bookkeeping runs
in NumPy, as in JAX. The NAR unit pass is one full-sequence forward.

The generators run on the card unless ``device="cpu"`` is given; without a
card they raise.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from streamspeech_tpu_torch.models.layers import KVCache, StreamKVCache
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.ops.ctc import ctc_collapse

PAD, EOS = 1, 2
NO_CHUNK = 99999           # a chunk size that no utterance reaches: offline


@dataclass
class BeamHypothesis:
    tokens: List[int]
    score: float


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a card that is absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' (the "
                           "CLIs: --cpu) to run on the CPU")
    return device


def block_repeat_ngrams(lp: np.ndarray, hyps, ngram: int):
    """Ban tokens that would complete an already-seen n-gram — the NumPy form
    of the reference's CUDA ngram_repeat_block extension
    (`fairseq/fairseq/clib/cuda/ngram_repeat_block_cuda*`; fairseq
    sequence_generator --no-repeat-ngram-size)."""
    if ngram <= 0:
        return lp
    for b, hyp in enumerate(hyps):
        if len(hyp) < ngram - 1:
            continue
        prefix = tuple(hyp[-(ngram - 1):]) if ngram > 1 else tuple()
        for i in range(len(hyp) - ngram + 1):
            if tuple(hyp[i:i + ngram - 1]) == prefix:
                lp[b, hyp[i + ngram - 1]] = -np.inf
    return lp


def _combined_argmax(logits: List[torch.Tensor]) -> torch.Tensor:
    """The argmax of one model's logits, or of N members' probabilities
    averaged (logsumexp of the log-probs, `generation.py:387-389`)."""
    if len(logits) == 1:
        return torch.argmax(logits[0], dim=-1)
    lp = torch.stack([F.log_softmax(x.float(), dim=-1) for x in logits])
    return torch.argmax(torch.logsumexp(lp, dim=0), dim=-1)


class OfflineGenerator:
    """Greedy/beam offline inference over the full model. ``EnsembleGenerator``
    runs the same search over N members."""

    def __init__(self, model: StreamSpeechModel, beam: int = 1, max_len: int = 200,
                 len_penalty: float = 1.0, no_repeat_ngram_size: int = 0, device="cuda"):
        self.device = resolve_device(device)
        self.models = [m.to(self.device).eval() for m in self._members(model)]
        self.model = self.models[0]
        self.beam = beam
        self.max_len = max_len
        self.len_penalty = len_penalty
        self.no_repeat_ngram_size = no_repeat_ngram_size

    @staticmethod
    def _members(model) -> List[StreamSpeechModel]:
        return [model]

    # -- the model calls, each over every member ---------------------------

    def _encode(self, src: np.ndarray, lens: np.ndarray, chunk: int, conv_chunk: int):
        """Returns (each member's encoder output, lengths, ASR ids, ST ids)."""
        src = torch.from_numpy(src).to(self.device)
        lens = torch.from_numpy(lens).long().to(self.device)
        encs, asr, st = [], [], []
        for m in self.models:
            enc, enc_lens = m.encode(src, lens, chunk, conv_chunk)
            encs.append(enc)
            asr.append(m.source_unigram_head(enc))
            st.append(m.ctc_target_unigram_head(enc))
        # encoder lengths depend on the input lengths alone: equal across members
        return (encs, enc_lens.cpu().numpy(), _combined_argmax(asr).cpu().numpy(),
                _combined_argmax(st).cpu().numpy())

    def _caches(self, batch: int, length: int, cls=KVCache) -> List[List]:
        c = self.model.cfg.mt_decoder
        h = c.attention_heads
        return [[cls.create(batch, length, h, c.embed_dim // h, self.device)
                 for _ in range(c.layers)] for _ in self.models]

    def _mt_step(self, tokens: torch.Tensor, offset: int, self_c, cross) -> torch.Tensor:
        """The next token's log-probs [B, V] float32: one model's, or the
        members' probabilities averaged (logsumexp − log N, `:400-411`)."""
        lps = [F.log_softmax(m.mt_decoder_step(tokens, offset, sc, cc)[0][:, -1].float(),
                             dim=-1)
               for m, sc, cc in zip(self.models, self_c, cross)]
        if len(lps) == 1:
            return lps[0]
        return torch.logsumexp(torch.stack(lps), dim=0) - math.log(len(lps))

    def _synthesize(self, prev: np.ndarray, encs, enc_len: np.ndarray) -> np.ndarray:
        prev = torch.from_numpy(prev).long().to(self.device)
        enc_len = torch.from_numpy(np.asarray(enc_len)).long().to(self.device)
        logits = [m.synthesize_units(prev, e, enc_len)[1]
                  for m, e in zip(self.models, encs)]
        return _combined_argmax(logits).cpu().numpy()

    # ------------------------------------------------------------------

    @torch.no_grad()
    def beam_search_mt(self, encs: List[torch.Tensor], enc_len: int) -> List[BeamHypothesis]:
        """Each member's enc [1, T, C] → beam hypotheses (sorted best-first, no
        EOS token)."""
        beam = self.beam
        self_c = self._caches(beam, self.max_len + 2)
        cross = self._caches(beam, encs[0].shape[1])
        for m, e, cc in zip(self.models, encs, cross):
            m.mt_fill_cross(e.expand(beam, -1, -1), cc)
            # enc rows beyond enc_len are padding: the cache's valid length
            # hides them from the attention (KVCache.truncate)
            for kv in cc:
                kv.truncate(enc_len)

        tokens = np.full((beam, 1), EOS, np.int64)
        scores = np.full((beam,), -1e9, np.float64)
        scores[0] = 0.0
        alive = np.ones((beam,), bool)
        finished: List[BeamHypothesis] = []
        hyps: List[List[int]] = [[] for _ in range(beam)]

        for step in range(self.max_len):
            lp = self._mt_step(torch.from_numpy(tokens).to(self.device), step, self_c, cross)
            lp = lp.cpu().numpy().astype(np.float64)            # [beam, V]
            lp[:, PAD] = -np.inf
            lp = block_repeat_ngrams(lp, hyps, self.no_repeat_ngram_size)
            total = scores[:, None] + lp
            total[~alive] = -np.inf
            if step == 0:
                total[1:] = -np.inf  # all beams identical at step 0
            flat = total.reshape(-1)
            top = np.argpartition(-flat, 2 * beam)[: 2 * beam]
            top = top[np.argsort(-flat[top])]
            new_tokens, new_scores, new_order, new_hyps = [], [], [], []
            for cand in top:
                b, v = divmod(int(cand), lp.shape[1])
                if v == EOS:
                    norm = flat[cand] / ((step + 1) ** self.len_penalty)
                    finished.append(BeamHypothesis(hyps[b][:], float(norm)))
                    continue
                new_tokens.append(v)
                new_scores.append(flat[cand])
                new_order.append(b)
                new_hyps.append(hyps[b] + [v])
                if len(new_tokens) == beam:
                    break
            if not new_tokens or len(finished) >= beam:
                break
            while len(new_tokens) < beam:
                new_tokens.append(PAD)
                new_scores.append(-np.inf)
                new_order.append(0)
                new_hyps.append([])
            order = torch.tensor(new_order, dtype=torch.long, device=self.device)
            for member in self_c:
                for kv in member:
                    kv.k = kv.k.index_select(0, order)
                    kv.v = kv.v.index_select(0, order)
            tokens = np.asarray(new_tokens, np.int64)[:, None]
            scores = np.asarray(new_scores, np.float64)
            alive = np.isfinite(scores)
            hyps = new_hyps

        if not finished:
            best = int(np.argmax(scores))
            finished = [BeamHypothesis(hyps[best], float(
                scores[best] / max(len(hyps[best]), 1) ** self.len_penalty))]
        finished.sort(key=lambda x: -x.score)
        return finished

    # ------------------------------------------------------------------

    def _units(self, unit_ids: np.ndarray, n_tokens: int) -> List[int]:
        """Collapse a row's unit CTC ids over its ``n_tokens`` (the MT prefix
        with its EOS) × the upsampling, keeping dictionary units."""
        ud = self.model.cfg.unit_decoder
        unit_blank = ud.vocab_size - 1
        units, _ = ctc_collapse(unit_ids[: n_tokens * ud.ctc_upsample_rate],
                                blank=unit_blank, pad=PAD)
        return [u for u in units if 4 <= u < unit_blank]

    @torch.no_grad()
    def generate_batch_greedy(self, feats_list, chunk_size: Optional[int] = None,
                              conv_chunk_size: Optional[int] = None,
                              max_tokens: int = 64):
        """Batched greedy offline inference (beam=1): pads a whole batch, runs
        one encode, one greedy decode of ``max_tokens`` steps with each row's
        encoder frames valid to its length, and one NAR pass — the throughput
        path for dataset-scale offline evaluation (fairseq-generate batches the
        same way; the beam>1 path stays per-utterance)."""
        b = len(feats_list)
        t = max(f.shape[0] for f in feats_list)
        pad_t = -(-t // 32) * 32
        src = np.zeros((b, pad_t, feats_list[0].shape[1]), np.float32)
        lens = np.zeros((b,), np.int64)
        for i, f in enumerate(feats_list):
            src[i, : f.shape[0]] = f
            lens[i] = f.shape[0]
        encs, enc_lens, asr_ids, st_ids = self._encode(
            src, lens, NO_CHUNK if chunk_size is None else chunk_size,
            NO_CHUNK if conv_chunk_size is None else conv_chunk_size)
        (enc,) = encs

        (self_c,) = self._caches(b, max_tokens + 2, StreamKVCache)
        (cross,) = self._caches(b, enc.shape[1])
        self.model.mt_fill_cross(enc, cross)
        dev = self.device
        cross_valid = (torch.arange(enc.shape[1], device=dev)[None, :]
                       < torch.from_numpy(enc_lens).to(dev)[:, None])
        toks, emitted, _ = self.model.mt_decode_greedy(
            torch.full((b,), EOS, dtype=torch.long, device=dev),
            torch.zeros((b,), dtype=torch.long, device=dev),
            torch.full((b,), max_tokens, dtype=torch.long, device=dev),
            self_c, cross, max_tokens, cross_valid)
        toks, emitted = toks.cpu().numpy(), emitted.cpu().numpy()

        s_pad = -(-int(emitted.max() + 1) // 8) * 8
        prev = np.full((b, s_pad), PAD, np.int64)
        prev[:, 0] = EOS
        for i in range(b):
            prev[i, 1: emitted[i] + 1] = toks[i, : emitted[i]]
        unit_ids = self._synthesize(prev, encs, enc_lens)
        results = []
        for i in range(b):
            e = int(enc_lens[i])
            asr_tokens, _ = ctc_collapse(asr_ids[i][:e], blank=0)
            st_tokens, _ = ctc_collapse(st_ids[i][:e], blank=0)
            results.append({
                "asr_tokens": asr_tokens,
                "st_tokens": st_tokens,
                "mt_tokens": toks[i, : emitted[i]].tolist(),
                "units": self._units(unit_ids[i], int(emitted[i]) + 1),
            })
        return results

    @torch.no_grad()
    def generate(self, feats: np.ndarray, chunk_size: Optional[int] = None,
                 conv_chunk_size: Optional[int] = None) -> Dict:
        """Full offline pass on one utterance: returns dict with asr/st token
        lists, MT hypothesis and its score, and unit sequence (dictionary ids)."""
        t = feats.shape[0]
        pad_t = -(-t // 32) * 32
        src = np.zeros((1, pad_t, feats.shape[1]), np.float32)
        src[0, :t] = feats
        encs, lens, asr_ids, st_ids = self._encode(
            src, np.asarray([t], np.int64),
            NO_CHUNK if chunk_size is None else chunk_size,
            NO_CHUNK if conv_chunk_size is None else conv_chunk_size)
        enc_len = int(lens[0])
        asr_tokens, _ = ctc_collapse(asr_ids[0][:enc_len], blank=0)
        st_tokens, _ = ctc_collapse(st_ids[0][:enc_len], blank=0)

        hyps = self.beam_search_mt(encs, enc_len)
        mt_tokens = hyps[0].tokens

        # the MT prefix bucketed to multiples of 8, as JAX buckets its shapes
        s = len(mt_tokens) + 1
        s_pad = -(-s // 8) * 8
        prev = np.full((1, s_pad), PAD, np.int64)
        prev[0, 0] = EOS
        prev[0, 1:s] = mt_tokens
        unit_ids = self._synthesize(prev, encs, np.asarray([enc_len]))
        return {
            "asr_tokens": asr_tokens,
            "st_tokens": st_tokens,
            "mt_tokens": mt_tokens,
            "mt_score": hyps[0].score,
            "units": self._units(unit_ids[0], s),
        }


def _tree_structure(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, Mapping):
            yield from _tree_structure(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(np.shape(v))


def _stack_tree(trees):
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack_tree([t[k] for t in trees]) for k in first}
    return np.stack([np.asarray(t) for t in trees])


def _check_members(structures: List[list]) -> None:
    """Raise ``ValueError`` where a member's (name, shape) list differs from
    member 0's: the members share one arch, the contract of fairseq's
    load_model_ensemble."""
    for i, s in enumerate(structures[1:], 1):
        if s != structures[0]:
            raise ValueError(f"ensemble member {i} has a different parameter "
                             "structure than member 0")


def stack_variables(variables_list: List[Dict]) -> Dict:
    """Stack N same-architecture flax variable trees (NumPy leaves) on a new
    leading member axis, raising where their structures differ
    (`generation.py:314`). Kept for parity with JAX's: the port's ensemble
    runs its members in turn and stacks nothing."""
    clean = [{"params": v["params"], "batch_stats": v.get("batch_stats", {})}
             for v in variables_list]
    _check_members([list(_tree_structure(v)) for v in clean])
    return _stack_tree(clean)


class EnsembleGenerator(OfflineGenerator):
    """N-checkpoint ensemble decoding (``generation.py:328-435``).

    Reference semantics: fairseq's EnsembleModel
    (`fairseq/fairseq/sequence_generator.py:744-850` forward_decoder /
    `checkpoint_utils.py:288` load_model_ensemble): every member runs its own
    encoder and per-step decoder log-probs; members combine in PROBABILITY
    space — logsumexp over members minus log(N). The CTC heads (ASR/ST aux
    and the NAR unit decoder) combine the same way before the argmax.

    The members are N port models run one after another at every call, as
    fairseq's EnsembleModel runs them (JAX stacks them and vmaps one program);
    each keeps its own KV caches, reordered alike.
    """

    def __init__(self, models: List[StreamSpeechModel], **kw):
        if not models:
            raise ValueError("ensemble needs at least one member")
        _check_members([[(n, tuple(p.shape)) for n, p in m.state_dict().items()]
                        for m in models])
        super().__init__(models, **kw)

    @staticmethod
    def _members(model) -> List[StreamSpeechModel]:
        return list(model)

    def generate_batch_greedy(self, feats_list, chunk_size=None,
                              conv_chunk_size=None, max_tokens: int = 64):
        """The batched greedy decode argmaxes inside the model's decode, so
        members' probabilities cannot be averaged after it — ensemble decoding
        runs the per-utterance beam path instead, as JAX's does (fairseq-generate
        with an ensemble pays the same N-model cost per step)."""
        return [self.generate(f, chunk_size, conv_chunk_size) for f in feats_list]
