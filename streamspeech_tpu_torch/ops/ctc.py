"""CTC loss and greedy-CTC path collapse (``streamspeech_tpu/ops/ctc.py``).

The loss has fairseq's semantics (reduction sum, zero_infinity; reference
`researches/ctc_unity/criterions/speech_to_speech_ctc_asr_st_criterion.py:223-232`)
and always runs the alpha/beta DP of ``kernels/ctc.py``: its CUDA kernels on
the card, their plain versions on the CPU. ``ctc_neg_log_likelihood`` is the
scan form, a plain reference differentiated by autograd. The JAX package's
``STREAMSPEECH_OPTAX_CTC`` route is not ported.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

NNEG = -1e30  # effective -inf that survives arithmetic


def gather_extended_logprobs_from_logits(logits: torch.Tensor, labels: torch.Tensor,
                                         blank_id: int) -> torch.Tensor:
    """log_softmax(logits) over the blank-interleaved extended label sequence
    [blank, l0, blank, l1, ..., blank] → lp_ext [B, T, 2N+1] float32
    (`ctc.py:43-67`): the raw logits are gathered and a [B, T] logsumexp is
    subtracted, so the [B, T, V] log-softmax is never built. A 0/1 selection
    is exact, so this equals JAX's one-hot einsum."""
    b, t, _ = logits.shape
    n = labels.shape[1]
    x = logits.to(torch.float32)
    idx = labels.long()[:, None, :].expand(b, t, n)
    g_lab = torch.gather(x, -1, idx)                                # [B, T, N]
    g_blank = x[:, :, blank_id:blank_id + 1]                        # [B, T, 1]
    inter = torch.stack([g_blank.expand(b, t, n), g_lab], dim=-1).reshape(b, t, 2 * n)
    ext = torch.cat([inter, g_blank], dim=-1)
    return ext - torch.logsumexp(x, dim=-1)[:, :, None]


def lse3(a0, a1, a2):
    """log(exp a0 + exp a1 + exp a2), NNEG where all three are NNEG-sized
    (`pallas_ctc.py:60-63`)."""
    m = torch.maximum(torch.maximum(a0, a1), a2)
    out = m + torch.log(torch.exp(a0 - m) + torch.exp(a1 - m) + torch.exp(a2 - m))
    return torch.where(m <= NNEG / 2, torch.full_like(out, NNEG), out)


def ctc_neg_log_likelihood(logits: torch.Tensor, logit_lengths: torch.Tensor,
                           labels: torch.Tensor, label_lengths: torch.Tensor,
                           blank_id: int) -> torch.Tensor:
    """Per-row CTC -log p(labels | logits) [B], the scan form
    (`ctc.py:70-141`): logits [B, T, V], labels [B, N] (padded past each
    row's length with any valid id). A Python loop over T, differentiated by
    autograd: the plain reference of the DP kernels."""
    b, t, _ = logits.shape
    n = labels.shape[1]
    s = 2 * n + 1
    dev = logits.device
    lbl_prev = torch.cat([torch.full_like(labels[:, :1], -1), labels[:, :-1]], dim=1)
    skip = torch.zeros((b, s), dtype=torch.bool, device=dev)
    skip[:, 1::2] = labels != lbl_prev
    lp_ext = gather_extended_logprobs_from_logits(logits, labels, blank_id)
    frame_valid = torch.arange(t, device=dev)[None, :] < logit_lengths[:, None]
    has_label = label_lengths > 0
    nneg_col = lp_ext.new_full((b, 1), NNEG)

    alpha = lp_ext.new_full((b, s), NNEG)
    alpha[:, 0] = lp_ext[:, 0, 0]
    if s > 1:
        alpha[:, 1] = torch.where(has_label, lp_ext[:, 0, 1], NNEG)
    for i in range(1, t):
        sh1 = torch.cat([nneg_col, alpha[:, :-1]], dim=1)
        sh2 = torch.cat([nneg_col, nneg_col, alpha[:, :-2]], dim=1)[:, :s]
        sh2 = torch.where(skip, sh2, torch.full_like(sh2, NNEG))
        new = lse3(alpha, sh1, sh2) + lp_ext[:, i]
        alpha = torch.where(frame_valid[:, i, None], new, alpha)

    end = 2 * label_lengths.long()
    a_end = torch.gather(alpha, 1, end[:, None])[:, 0]
    a_last = torch.gather(alpha, 1, torch.clamp(end - 1, min=0)[:, None])[:, 0]
    a_last = torch.where(has_label, a_last, torch.full_like(a_last, NNEG))
    m = torch.maximum(a_end, a_last)
    return -(m + torch.log(torch.exp(a_end - m) + torch.exp(a_last - m)))


def _zero_infinity_sum(nll: torch.Tensor) -> torch.Tensor:
    """zero_infinity=True: an infinite (or NNEG-sized) row counts 0."""
    keep = torch.isfinite(nll) & (nll < 1e29)
    return torch.sum(torch.where(keep, nll, torch.zeros_like(nll)))


def ctc_loss_sum(logits: torch.Tensor, logit_lengths: torch.Tensor,
                 labels: torch.Tensor, label_lengths: torch.Tensor,
                 blank_id: int) -> torch.Tensor:
    """Summed CTC loss with zero_infinity (`ctc.py:144-179`) through the DP
    kernels: logits [B, T, V] raw (the log-softmax happens inside)."""
    from streamspeech_tpu_torch.kernels import ctc as ctc_kernels

    return _zero_infinity_sum(ctc_kernels.ctc_neg_log_likelihood_kernel(
        logits, logit_lengths, labels, label_lengths, blank_id))


def ctc_loss_sum_pair(logits_a, lengths_a, labels_a, label_lengths_a,
                      logits_b, lengths_b, labels_b, label_lengths_b,
                      blank_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two CTC sums over the same frame axis in one DP pass (`ctc.py:182-214`):
    the heads' rows are concatenated, so the pair takes one alpha and one
    beta launch. Always the fused route, as JAX takes on the chip."""
    from streamspeech_tpu_torch.kernels import ctc as ctc_kernels

    nll_a, nll_b = ctc_kernels.ctc_neg_log_likelihood_kernel_multi(
        [(logits_a, lengths_a, labels_a, label_lengths_a),
         (logits_b, lengths_b, labels_b, label_lengths_b)], blank_id)
    return _zero_infinity_sum(nll_a), _zero_infinity_sum(nll_b)


def ctc_collapse(ids, blank: int, pad: Optional[int] = None
                 ) -> Tuple[List[int], List[int]]:
    """Returns (tokens, frame_indices): repeats removed keeping the FIRST frame
    of a run (`agent/ctc_decoder.py:67-89`), then blanks (and pad) removed."""
    tokens: List[int] = []
    index: List[int] = []
    prev = None
    for t, i in enumerate(np.asarray(ids).tolist()):
        if i != prev:
            prev = i
            if i != blank and (pad is None or i != pad):
                tokens.append(i)
                index.append(t)
    return tokens, index


def ctc_collapse_device(ids: torch.Tensor, blank: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static-shape collapse on the tensor's own device: ids [..., T] →
    (tokens [..., T] left-packed with trailing ``blank`` fill, count [...])."""
    t = ids.shape[-1]
    prev = torch.cat([torch.full_like(ids[..., :1], -1), ids[..., :-1]], dim=-1)
    keep = (ids != prev) & (ids != blank)
    # each kept id goes to its rank among the kept; the others to a spare
    # last column, cut off after (a scatter: no sort, nothing read on the host)
    dest = torch.where(keep, torch.cumsum(keep, dim=-1) - 1, t)
    packed = torch.full((*ids.shape[:-1], t + 1), blank, dtype=ids.dtype,
                        device=ids.device)
    packed.scatter_(-1, dest, ids)
    return packed[..., :t], keep.sum(dim=-1)
