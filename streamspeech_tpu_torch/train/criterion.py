"""Training criterion: unit CTC + multitask (CE + aux CTC) losses
(``streamspeech_tpu/train/criterion.py``; behavioural reference
`researches/ctc_unity/criterions/speech_to_speech_ctc_asr_st_criterion.py:70-232`
and `fairseq/fairseq/criterions/speech_to_speech_criterion.py:29-110`):

  total = unit_ctc(unit logits, target units; blank = last, zero_infinity, sum)
        + 8.0 * label-smoothed CE (MT decoder ↔ target_unigram)
        + 4.0 * CTC (ASR head ↔ source_unigram transcript; blank = 0)
        + 4.0 * CTC (ST head ↔ ctc_target_unigram text; blank = 0)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from streamspeech_tpu_torch.ops.ctc import ctc_loss_sum, ctc_loss_sum_pair


def label_smoothed_nll(logits: torch.Tensor, targets: torch.Tensor,
                       valid: torch.Tensor, epsilon: float) -> Dict[str, torch.Tensor]:
    """fairseq's label_smoothed_nll_loss, summed over valid positions
    (`criterion.py:28-41`): eps_i = eps / (V - 1) and the loss is
    (1 - eps - eps_i)·nll + eps_i·Σ -lprobs. ``F.cross_entropy``'s
    ``label_smoothing`` (eps / V) is not this."""
    lprobs = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(lprobs, -1, targets.long()[..., None])[..., 0]
    smooth = -torch.sum(lprobs, dim=-1)
    v = valid.to(torch.float32)
    eps_i = epsilon / (logits.shape[-1] - 1)
    loss = (1.0 - epsilon - eps_i) * nll + eps_i * smooth
    return {"loss": torch.sum(loss * v), "nll_loss": torch.sum(nll * v)}


@dataclass(frozen=True)
class CriterionWeights:
    target_unigram: float = 8.0
    source_unigram: float = 4.0
    ctc_target_unigram: float = 4.0
    label_smoothing: float = 0.1
    # main-pass unit CTC weight; exactly 0.0 drops the term (`criterion.py:50-55`)
    unit_ctc: float = 1.0
    # profiling only: the unit CTC DP replaced by a trivial surrogate
    # (mean |logit|, `criterion.py:56-60`); never set in training
    unit_surrogate: bool = False


def streamspeech_loss(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                      unit_blank: int,
                      weights: CriterionWeights = CriterionWeights()
                      ) -> Dict[str, torch.Tensor]:
    """`criterion.py:63-132`. ``out`` is the model's forward dict; ``batch``
    carries target_units [B, N] / target_unit_lengths [B], mt_targets [B, S]
    (valid where != PAD), src_text / src_text_lengths (the source_unigram
    transcript) and tgt_text / tgt_text_lengths (the ctc_target_unigram text).
    The aux CTCs share the encoder frames and run as one fused DP pair."""
    dev = out["mt_logits"].device
    zero = torch.zeros((), dtype=torch.float32, device=dev)

    if weights.unit_ctc != 0.0:
        unit_logits = out["unit_logits"]
        up_valid = torch.repeat_interleave(
            out["mt_valid"], unit_logits.shape[1] // out["mt_valid"].shape[1], dim=1)
        unit_input_lengths = up_valid.sum(dim=-1)
        if weights.unit_surrogate:
            unit_loss = torch.sum(torch.abs(unit_logits.to(torch.float32))) * 1e-6
        else:
            unit_loss = ctc_loss_sum(unit_logits, unit_input_lengths,
                                     batch["target_units"], batch["target_unit_lengths"],
                                     blank_id=unit_blank)
    else:
        unit_loss = zero

    mt_valid = batch["mt_targets"] != 1
    if weights.target_unigram != 0.0:
        ce = label_smoothed_nll(out["mt_logits"], batch["mt_targets"], mt_valid,
                                weights.label_smoothing)
    else:
        ce = {"loss": zero, "nll_loss": zero}

    if weights.source_unigram != 0.0 or weights.ctc_target_unigram != 0.0:
        enc_lengths = out["encoder_lengths"]
        asr_loss, st_loss = ctc_loss_sum_pair(
            out["asr_logits"], enc_lengths, batch["src_text"], batch["src_text_lengths"],
            out["st_logits"], enc_lengths, batch["tgt_text"], batch["tgt_text_lengths"],
            blank_id=0)
    else:
        asr_loss, st_loss = zero, zero

    total = (weights.unit_ctc * unit_loss
             + weights.target_unigram * ce["loss"]
             + weights.source_unigram * asr_loss
             + weights.ctc_target_unigram * st_loss)
    sample_size = torch.clamp(torch.sum(batch["target_unit_lengths"]), min=1)
    return {
        "loss": total,
        "unit_ctc_loss": unit_loss,
        "mt_loss": ce["loss"],
        "mt_nll_loss": ce["nll_loss"],
        "asr_ctc_loss": asr_loss,
        "st_ctc_loss": st_loss,
        "sample_size": sample_size,
        "mt_ntokens": torch.sum(mt_valid),
    }
