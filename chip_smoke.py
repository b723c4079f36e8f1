"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):
1. env      torch version, the card, ``nvidia-smi`` name and power limit;
            refuses to run without a CUDA device of capability (9, 0).
2. build    compiles every ``streamspeech_tpu_torch/csrc/*.cu`` with nvcc
            (one process per source, started together): wall seconds, seconds
            per source, registers and spill bytes per kernel instance.
3. kernel   each kernel against its plain PyTorch version on the same inputs:
            causal masked attention at the unit decoder's serving shapes
            (B=1, H=8, D=64, T_pad 512/896/1664/3200), the forward's
            (T_pad 640) and the batched wave's (B=8, T_pad 1664, each row's
            keys valid to its own length, 400-1664: ``MASKED_BATCHED_SHAPE``);
            rel-pos attention at [1|8, 4, 256, 64] and [1, 4, 512, 64]; bias attention at TQ/TK 600/24 (B=1) and
            1200/48 (B=8), H=8, D=64; the not-blank posterior at
            [1|8, 256, 6000], and untimed at [3, 65, 513] with blank V - 1
            (its 4-byte loads). Max abs error against its tolerance; the device
            ms of one call (CUDA-graph replay of 20 calls, median CUDA-event
            time) of the kernel, the plain version and (attention with a mask)
            one ``F.scaled_dot_product_attention`` call as a yardstick; the
            kernel's eager per-call ms (host launch cost included); and the
            bound: max(flops / 67 TFLOP/s fp32, bytes / 3.35 TB/s), each
            input read and each output written once; for the causal, rel-pos
            and bias kernels, which run their products as 3xTF32 on the
            tensor cores, max(3 flops / 495 TFLOP/s, bytes / 3.35 TB/s), with
            ``cuda_core_bound_ms`` beside it (the rel-pos rows add the flops
            its band products run, ``kernel_flops``, with their bound).
4. serving  the full-width StreamSpeech model (``full_config``, seeded random
            weights, doctored so the policy writes) with a full-width
            CodeHiFiGAN vocoder, through the S2ST agent over three synthetic
            speech-like utterances of 3, 6 and 10 s in 320 ms segments; the
            masked-attention kernel's launch count over this phase must be > 0.
4b. serving_fused  phase 4's agent and utterances on the fused tick
            (``use_fused``) after ``engine.warmup`` captured its B = 1 CUDA
            graphs: each utterance's write turns, MT tokens and units equal
            to phase 4's and its wav within ``REFERENCE_WAV_ATOL``; B3
            launched inside the replayed graphs (a count is the launches a
            graph holds times its replays). Graphs captured, capture s, pool
            bytes, replays, wall; the 10 s utterance again under
            ``torch.profiler``: device busy ms and share, the CUDA API
            launches by call (a graph replay one). Its host decodes (the
            finish, the budget-over continuations) replay the decode graphs.
4c. serving_pipelined  phase 4's agent and utterances on the overlapped
            loop (``StreamSpeechAgentConfig.pipelined``) after
            ``engine.warmup(pipelined=True)`` (a graph a MT bucket, its two
            conds IF nodes): at ``pipe_max_lag`` 8 with the age rule off and
            at the defaults, each utterance's delays, MT tokens and units equal
            to phase 4b's, its wav within ``REFERENCE_WAV_ATOL``; wall,
            dispatches, fetches that waited, the deepest count in flight, B3
            launches (counted from the fetched flags), graphs captured, capture
            s, pool bytes; the 10 s utterance under ``torch.profiler``: CUDA
            API launches, busy share, and the blocking CUDA API calls by where
            they fell, none inside a dispatch or between two consecutive
            dispatches outside a fetch (``_pipe_waits``).
5. reference ``full_config`` widths with a 2-layer encoder, run on the card
            and on the CPU over the same audio: the same MT tokens and units,
            the wav within tolerance.
5b. serving_batched  (after phase 5) phase 4's engine, vocoder and
            dictionaries serve eight ``_babble`` utterances of 2-10 s
            (``BATCHED_SECONDS``, the first three phase 4's) as one wave of
            ``BatchedS2STEvaluator(batch=8, quality_metrics=[])`` in 320 ms
            segments, and each alone through
            the sequential ``SentenceLevelEvaluator`` over phase 4's agent:
            every instance the same delays, MT tokens and units, its stitched
            wav within ``REFERENCE_WAV_ATOL``; B3 launched, some of it at batch
            8 (``masked_attention.launches_by_batch``). A line an instance
            (writes, tokens, units, its latency scores) and one for the wave,
            timed after a warm-up wave: wall s, seconds of audio per wall
            second of the wave and of the eight single runs summed, launches,
            and the card's busy share (the wave again under ``torch.profiler``:
            kernel time over the profiled wave's wall and over the timed one's).
5c. serving_batched_fused  phase 5b's wave with ``use_fused=True`` after
            ``engine.warmup`` captured the B = 8 graphs (the timed wave, a
            profiled one): every instance equal to its single run as in
            phase 5b; the numbers of phase 4b.
6. forward  the offline (teacher-forced) forward of the same ``full_config``
            model, batch 2 (fbank lengths 1024 and 800, MT prefix 24 with the
            second row PAD after 18, chunk 8, CTC streaming mask, n2=1) on the
            card and on the CPU: the same CTC streaming mask, every output
            within tolerance, and in the card run 12 rel-pos, 2 bias, 2
            not-blank and 2 masked-attention launches. Then ``entry()``
            (``streamspeech_tpu_torch/entry.py``) on the card: finite unit
            logits of the expected shape; and the card forward's median time
            at B=1 (1024 frames, MT 24) and B=8 (MT 48).
7. kernel   (continued) the CTC alpha and beta kernels against their plain
            versions at the train step's unit CTC [8, 1200, S=513], its fused
            ASR + ST pair [16, 256, 65] and at [1, 1200, 513]: alpha and the
            NLL within 1e-5·max(1, |ref|), the occupancy gradient within 1e-6,
            and the NLL within 1e-4·max(1, |ref|) of one ``F.ctc_loss`` call
            on the same log-probs, the library yardstick (eager CUDA-event
            time: forward for alpha, forward + backward minus forward for beta);
            each row adds the cut the kernels launch (``kernels.ctc.cluster_plan``:
            blocks a cluster, states a block and a lane, warps a block, ring
            slots, frames handed over at once) and ``ms_per_serial_step``.
8. train    the train step at ``full_config`` (fp32, dropout 0.1) at
            ``measure_train_step``'s shape: B=8, 1024 fbank frames, MT 48
            (unit T 1200), 256 target units, 32 text tokens, n2=2, chunk 8,
            conv chunk 8, Adam with warmup 10000, lr 1e-3, clip 10; one warm-up
            step and 5 timed steps (CUDA events, synchronized): finite loss
            components, and per step 2 alpha, 2 beta and 2 not-blank launches
            and none of the attention kernels (training takes their plain
            route); median step ms, peak memory, step-1 losses, parameters.
9. train_reference  ``full_config`` widths with a 2-layer encoder and dropout
            0, B=2 (fbank 1024 and 800, MT 24, the second row PAD after 18):
            one train step from the same weights and batch on the card and on
            the CPU; loss components within 1e-4·max(1, |ref|), every
            gradient within 1e-3·max|g_ref| + 1e-7, batch statistics within
            1e-4·max(1, |ref|).
10. kernel  (continued) the training forms of the three attention kernels at
            the kernel train route's shapes: rel-pos [8, 4, 256, 64], causal
            [8, 8, 1280, 64] (1200 valid), bias [8, 8, 1200 x 48, 64], and one
            ragged shape each, at dropout 0 and 0.1: the mask the kernels draw
            equals ``dropout_keep_reference`` exactly and keeps 1 - rate of the
            elements (3 sigma); the forward with dropout and the backward
            (dq, dK, dV; rel-pos dq_u, dq_v, dP) within 1e-4·max|ref| of the
            plain forward and the plain backward under the same mask; two
            backward calls with one seed equal bit for bit; device ms of the
            forward, the backward, the plain backward, autograd through the
            plain forward, and (causal, bias)
            ``F.scaled_dot_product_attention`` under the same float mask with
            the same ``dropout_p``: forward, and forward + backward minus forward;
            at 0.1 each timed row's ``dropout_gap_ms``, its time at 0.1 less its
            time at 0. The mask's writer at [8, 8, 1280, 1280], its bound the
            least integer work of its draws on each of the two integer pipes
            (``DRAW_FMA_OPS``, ``DRAW_ALU_OPS`` over ``INT_PIPE_OPS``) or its
            bytes, whichever is larger. B1-B6 run
            their products as 3xTF32 on the tensor cores: their ``bound_ms``
            is max(3 flops / 495 TFLOP/s, bytes / 3.35 TB/s), with
            ``cuda_core_bound_ms`` (the fp32 CUDA cores' 67 TFLOP/s) beside
            it; B1's and B2's rows add the flops their band products run
            (``kernel_flops``, their bound beside) and the bytes of its
            scratch, B6's its form, query-tile groups G and the bytes of its
            scratch (these stay off the ``kernels`` line).
11. train_kernels  phase 8's model, batch and optimizer with
            ``make_train_step(..., kernel_attention=True)``: per step 12/2/2
            rel-pos/causal/bias forward launches and as many backward calls,
            32 of them drawing the mask (``mask_draws``), 2 not-blank, 2 alpha,
            2 beta; the same row as phase 8, so the two routes read side by side.
12. train_kernels_reference  phase 9's setup with the kernel route on, card
            against CPU (the plain versions), at dropout 0 and at attention
            dropout 0.1. The CUDA and the CPU ``torch.Generator`` hand out
            different numbers, so the per-call seeds are passed explicitly
            (call n gets seed 1000 + n on both devices); tolerances as phase 9,
            the gradients' norm within 1e-3 of itself, and every gradient
            within 1e-3·max|g_ref| + 1e-7 but the rows that ``_grad_check``
            leaves out: a ReLU unit whose CPU preactivation comes within
            ``RELU_TIE_RTOL`` of 0 may land on the other side on the card;
            past the tolerance, its fc1 weight row and bias element are left
            out, at most ``RELU_TIES_MAX`` units a step. The row prints them,
            their distance, and the worst remaining distance.
Phases 13-15 run after phases 3, 4 and 6 in turn:
13. kernel  (continued) the bf16 forms of B3, B5 and B7 (``csrc/attention_bf16.cuh``,
            ``not_blank.cu``) at the shapes of phase 3, bf16 q/k/v (logits),
            against their plain bf16 versions: each attention output element
            within 2^-7 sum_j p_j |v_j| + 1e-5, p the plain version's fp32
            probabilities (each probability rounded to bf16, at most 2^-8
            relative, once on each side,
            the kernel before normalising, the plain version after; the row
            gives the largest share of its bound an element reached), B7
            within 1e-6; ms,
            plain ms, one bf16 SDPA call under the mask cast to bf16 (none for
            B7), and the bound at the bf16 tensor-core peak, max(flops / 989
            TFLOP/s, bytes / 3.35 TB/s). The attention rows add the form the
            call takes (``bf16_forward_form``), the CUDA kernels one call
            launches, read from a captured graph's kernel nodes, with each
            one's device ms by ``torch.profiler`` over graph replays
            (``kernels_a_call``, ``kernels_ms_launches``) and the HGMMA count of
            the library (``cuobjdump -sass``); the phase fails unless D = 64
            runs the wgmma form, one kernel a call, HGMMA in its library.
14. forward_bf16  phase 6's model and inputs with ``dtype=torch.bfloat16``
            (fp32 weights, bf16 compute): card against the same bf16 model on
            the CPU, each float output's RMS distance within 2x the CPU bf16
            model's own from the CPU fp32 forward, the CTC streaming mask in 99 %
            of places; the card's distance from its fp32 forward reported; in
            one card forward 2 bf16 causal, 2 bf16 bias, 2 bf16 not-blank and 12
            rel-pos (fp32) launches and no fp32 causal, bias or not-blank one;
            times at B=1 MT 24 and B=8 MT 48 beside phase 6's.
15. serving_bf16  phase 4's agent and utterances with the bf16 model (the
            vocoder float32): writes, units, RTF, bf16 causal launches (> 0); the
            counterpart of ``measure_bf16_drift`` against phase 4: each
            utterance's unit normalised edit distance and write positions that
            differ, reported, not gated. Then serving_bf16_batched_fused:
            phase 5c with the bf16 agent, each instance held to the same
            engine's host wave (run first).
Phases 16-19 run after phase 12:
16. kernel  (continued) the bf16 training forms: B3-bf16 and B5-bf16 with
            dropout and row statistics, B4-bf16 and B6-bf16
            (``csrc/attention_bwd_bf16.cuh``) at phase 10's shapes, bf16 q/k/v
            and an fp32 g, at dropout 0 and 0.1: the forward within the bf16
            forward's bound of its plain version under the same mask; dq, dK
            and dV (bf16) within one bf16 ulp plus ``BF16_GRAD_TERMS`` of
            their terms' magnitudes (dp's own terms in ds) of the plain bf16
            backward; delta, the dQ
            pass's scratch, within 2^-16 of its terms' magnitudes of Σ p dp
            while rowsum(g out) misses by more than ten times that (V offset by 4:
            a kernel that took delta from the output fails); two backward
            calls equal bit for bit; each kernel's own keep bits (v, g the
            identity, T = D = 64) equal to ``dropout_keep_reference``; device
            ms of each, its plain version, bf16 SDPA under the same mask and
            ``dropout_p`` (forward; forward + backward minus forward) and the
            bound at the bf16 tensor-core peak; a timed forward row adds its
            form, CUDA kernels and HGMMA count as phase 13's (and fails the
            same way); a backward row also gives the
            CUDA kernels a call launches (B4-bf16 two, B6-bf16 one at TK <=
            128; the graph's kernel nodes) and each kernel's device ms by
            ``torch.profiler`` over CUDA-graph replays (``kernels_ms_launches``).
17. train_bf16, train_bf16_kernels  phase 8's and 11's steps with the model
            computing in bf16 (``StreamSpeechModel(cfg, dtype=torch.bfloat16)``,
            fp32 parameters and Adam): per step 2 bf16 not-blank, 2 alpha, 2
            beta launches; on the kernel route also 2/2 bf16 causal/bias
            training forwards and as many bf16 backward calls, 12/12 fp32
            rel-pos (the route casts to fp32) and 32 mask draws.
18. train_bf16_reference, train_bf16_kernels_reference (at dropout 0 and at
            attention dropout 0.1)  phases 9 and 12 with the bf16 model: the
            card's step against the same bf16 step on the CPU, held to the CPU
            bf16 step's own distance from phase 9's or 12's CPU fp32 step:
            the whole gradient and the batch statistics within
            ``BF16_DRIFT``, each gradient tensor within ``BF16_TENSOR_DRIFT``,
            each loss within ``BF16_LOSS_RTOL`` of itself; the CPU bf16
            step's ReLU ties reported.
The bias route pads its keys to the 128 tile as JAX does
(``models/layers.py`` ``_bias_kernel``), so every bias-attention row runs at
TK = 128 with the valid keys beside (``tk_valid``).
Every phase line gives ``at_s``, the script's seconds so far.
Then the ``kernels`` summary line (sixteen entries, the ten kernels, the
bf16 forms of B3-B7 and the set-conditional kernel of the overlapped tick's
IF nodes (``_check_graph_cond``, after phase 13), launches by path; the bf16 B3 and B5 entries carry their
training form, the B3 entry its batched shape (``batched_shape``); the mask's
own kernel runs on no path, so its entry carries the draws by path), the card's
name and power limit, and last the ``ok`` line.

fp32 throughout but the bf16 phases: TF32 is switched off for matmuls and
cuDNN convolutions. Phase 12's train shapes are also phase 16's.
"""

from __future__ import annotations

import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import streamspeech_tpu_torch  # noqa: F401  (fails at once outside a checkout)

KERNEL_ATOL = 1e-5          # fp32 kernel vs fp32 plain version: summation order only
NOT_BLANK_ATOL = 1e-6       # the not-blank posterior, values in [0, 1]
REFERENCE_WAV_ATOL = 1e-5   # card vs CPU run of the same model, fp32
FORWARD_RTOL = 1e-4         # card vs CPU forward: |err| <= 1e-4 * max(1, max |ref|)
# (T_pad, T): the unit decoder's serving buckets, then the forward's 24 x 25
MASKED_SHAPES = [(512, 400), (896, 800), (1664, 1600), (3200, 3200), (640, 600)]
RELPOS_SHAPES = [(1, 256), (8, 256), (1, 512)]            # (B, T); H=4, D=64
BIAS_SHAPES = [(1, 600, 24), (8, 1200, 48)]               # (B, TQ, TK); H=8, D=64
NOT_BLANK_SHAPES = [(1, 256, 6000), (8, 256, 6000)]       # (B, T, V)
NOT_BLANK_ODD_SHAPES = [(3, 65, 513)]                     # checked, not timed; blank V - 1
# (B, T, V, N, blank): the train step's unit CTC, its fused ASR + ST pair, B=1
CTC_SHAPES = [(8, 1200, 1005, 256, 1004), (16, 256, 6000, 32, 0),
              (1, 1200, 1005, 256, 1004)]
CTC_RTOL = 1e-5             # alpha and NLL: |err| <= 1e-5 * max(1, |ref|)
CTC_GRAD_ATOL = 1e-6        # the occupancy gradient, values in [-1, 0]
CTC_LIBRARY_RTOL = 1e-4     # our NLL vs F.ctc_loss: another recursion, fp32
TRAIN_RTOL = 1e-4           # card vs CPU train step: loss components, batch stats
TRAIN_GRAD_RTOL = 1e-3      # card vs CPU gradients, of max |g_ref| per tensor
# the attention kernels' training forms vs their plain versions under the same
# mask: |err| <= 1e-4 * max |ref| per tensor (fp32 both sides, another summation
# order; a mask that differed in one element would show as an error of order 1)
ATTN_TRAIN_RTOL = 1e-4
# card vs CPU on the kernel route: a ReLU unit whose preactivation on the CPU
# step is within this much of max|pre| of its layer from 0 at some position (a
# tie: fp32 rounding, here the attention kernels' 1e-6 off the plain versions,
# decides its side) may land on the other side on the card, and a ReLU
# network's gradient is not continuous there. Past TRAIN_GRAD_RTOL, its row of
# fc1.weight and its element of fc1.bias are left out (`_grad_check`); at most
# RELU_TIES_MAX units a step. 13 units of the reference step are ties; unit
# 113 of unit_decoder.layers_0, at 6.7e-9, has moved its row by 2.1e-3.
RELU_TIE_RTOL = 1e-6
RELU_TIES_MAX = 4
ATTN_DROPOUT = 0.1
# (B, T_pad, valid): the unit decoder's train shape (1200 padded to the 128 tile), ragged
MASKED_TRAIN_SHAPES = [(8, 1280, 1200), (2, 384, 300)]
RELPOS_TRAIN_SHAPES = [(8, 256, 256), (2, 384, 300)]      # (B, T, valid keys of the last row)
BIAS_TRAIN_SHAPES = [(8, 1200, 48), (2, 650, 30)]         # (B, TQ, TK)
# the bias route pads its keys to this tile, as JAX does (models/layers.py
# _bias_kernel): the bias kernels run at TK = 128 with the valid TK above
BIAS_KEY_TILE = 128
UTTERANCE_SECONDS = (3.0, 6.0, 10.0)
# the batched serving wave: phase 4's three utterances, then five more
BATCHED_SECONDS = UTTERANCE_SECONDS + (2.0, 4.0, 5.0, 7.0, 8.0)
# (B, T_pad, valid keys of each row): causal attention as the unit decoder
# runs it for B streams served together, each row at its own length
MASKED_BATCHED_SHAPE = (8, 1664, (400, 575, 750, 925, 1100, 1275, 1450, 1664))
SEED = 0
FP32_FLOPS = 67e12          # H100 SXM fp32 (non-tensor-core) peak, FLOP/s
# Integer instructions a second on each of an SM's two integer pipes, which
# issue side by side: the FMA pipe (IMAD) and the ALU pipe (LOP3, ISETP, IADD3)
# take 16 lanes a sub-partition a clock each, 64 an SM, at the clock that 67
# TFLOP/s implies (67e12 / (2 * 128 * 132) = 1.98 GHz).
INT_PIPE_OPS = 16.75e12
# The least integer work of one B10 draw (Philox-4x32-10, 4 elements), with a
# row's fixed rounds formed once a row as dropout.cuh does: 16 32 x 32 -> 64-bit
# products on the FMA pipe (one issue each at least); 18 XORs (three-input where
# a round key joins) and 4 compares with the threshold on the ALU pipe. A row's
# own rounds (3 products a row) add under 0.2 % at the writer's shape.
DRAW_FMA_OPS, DRAW_ALU_OPS = 16, 22
TF32_FLOPS = 495e12         # H100 SXM dense TF32 tensor-core peak, FLOP/s
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak, FLOP/s
HBM_BYTES = 3.35e12         # H100 SXM device-memory rate, B/s
BF16_ROUNDING = 2.0 ** -8   # bf16's unit roundoff (8 significant bits), relative
BF16_DRIFT = 2.0            # card bf16 vs CPU bf16: of the bf16 model's own drift
BF16_AGREEMENT = 0.99       # the bf16 forward's CTC streaming mask, card vs CPU
# a bf16 gradient element against the plain bf16 backward: one bf16 ulp (the
# two fp32 results may round apart) plus this share of its terms' magnitudes
# (the kernel's split products err by ~2^-16 of them)
BF16_GRAD_TERMS = 2.0 ** -12
# delta = Σ_j p dp against the kernel's: of Σ_j p Σ_d |g_d v_jd| (g split in
# two bf16 parts is g to 2^-17; rowsum(g out), from bf16-rounded
# probabilities, misses by ~2^-9 of Σ p |g v|)
BF16_DELTA_TERMS = 2.0 ** -16
# the bf16 train step, card vs CPU: of the CPU bf16 step's own distance from
# the CPU fp32 step, the whole gradient (and the batch statistics) within
# BF16_DRIFT, each tensor within BF16_TENSOR_DRIFT (ReLU units near 0 land on
# either side, tests/test_torch_bf16_train.py), each loss within 2^-8 of itself
BF16_TENSOR_DRIFT = 4.0
BF16_LOSS_RTOL = 2.0 ** -8


_START = time.perf_counter()


def emit(obj):
    """Print one JSON line; a phase's line also gives the script's seconds so
    far (``at_s``), so each phase's share of the time limit shows."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - _START}
    print(json.dumps(obj), flush=True)


def phase_env():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script only runs on the card")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs compute capability (9, 0), got {cap}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0), "capability": list(cap),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "tf32": False})
    print(smi, flush=True)
    return smi


def _instance_key(mangled: str) -> str:
    """A kernel's mangled name → its kernel and integer arguments (head dim
    first, then a cut): ``...9dq_kernelILi64E...`` → ``dq_kernel<64>``,
    ``relpos_attention_kernel<64,2,2>``; other names as they are."""
    arg = re.search(r"\d+([a-z_]+_kernel)I((?:L[ib]\d+E)+)", mangled)
    if arg is None:
        return mangled
    ints = ",".join(re.findall(r"Li(\d+)E", arg.group(2)))
    fused = ",fused" if "Lb1E" in arg.group(2) else ""
    return f"{arg.group(1)}<{ints}{fused}>"


def _ptxas_summary(log: str) -> dict:
    """``-Xptxas -v`` output → {entry: [registers, spill store bytes]}, each
    entry keyed by ``_instance_key``."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = _instance_key(m.group(1))
            out[entry] = out.get(entry, [None, 0])
        elif entry and (m := re.search(r"(\d+) bytes spill stores", line)):
            out[entry][1] = int(m.group(1))
        elif entry and (m := re.search(r"Used (\d+) registers", line)):
            out[entry][0] = int(m.group(1))
    return out


def phase_build():
    from streamspeech_tpu_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": build.kernel_names(),
          "seconds_by_source": {n: r["seconds"] for n, r in report.items()},
          "ptxas": {n: _ptxas_summary(r["nvcc"]) for n, r in report.items()}})


def _time_ms(fn, reps=50, warmup=5):
    """Median CUDA-event time of one eager call: the device's time plus any
    host launch cost the device waits for."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, calls=20, reps=20):
    """Device time of one call: ``calls`` calls captured in one CUDA graph,
    replayed ``reps`` times; the median replay's CUDA-event time / ``calls``.
    The replay has no host launch cost, so small kernels show their own time."""
    fn()                                     # warm up outside the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _time_ms(graph.replay, reps=reps, warmup=2) / calls


def _short_kernel_name(name: str) -> str:
    """``void ns::fwd_kernel<64>(float const*, ...)`` -> ``fwd_kernel``."""
    return name.split("(")[0].split("<")[0].replace("void ", "").split("::")[-1]


def _graph_nodes(graph) -> dict:
    """{kernel name: kernel nodes} of a captured ``torch.cuda.CUDAGraph(keep_graph=True)``,
    read from the graph itself with the driver API (``cuGraphGetNodes``, the
    kernel nodes' functions named by ``cuFuncGetName`` and demangled by
    ``cu++filt``); memcpy and memset nodes count under ``memcpy`` / ``memset``."""
    import ctypes

    from streamspeech_tpu_torch.kernels import build

    cu = ctypes.CDLL("libcuda.so.1")

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed: CUresult {rc}")

    class KernelNodeParams(ctypes.Structure):            # CUDA_KERNEL_NODE_PARAMS_v2
        _fields_ = [("func", ctypes.c_void_p)] + [
            (f, ctypes.c_uint) for f in ("gx", "gy", "gz", "bx", "by", "bz", "smem")] + [
            ("kernel_params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
            ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    mangled, out = [], {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        if kind.value in (1, 2):                         # CU_GRAPH_NODE_TYPE_MEMCPY / MEMSET
            key = "memcpy" if kind.value == 1 else "memset"
            out[key] = out.get(key, 0) + 1
        if kind.value != 0:                              # CU_GRAPH_NODE_TYPE_KERNEL
            continue
        params = KernelNodeParams()
        check(cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node), ctypes.byref(params)),
              "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            check(cu.cuFuncGetName(ctypes.byref(name), ctypes.c_void_p(params.func)),
                  "cuFuncGetName")
        else:
            check(cu.cuKernelGetName(ctypes.byref(name), ctypes.c_void_p(params.kern)),
                  "cuKernelGetName")
        mangled.append(name.value.decode())
    if mangled:
        tool = Path(build._nvcc()).with_name("cu++filt")
        names = subprocess.run([str(tool)], input="\n".join(mangled) + "\n",
                               capture_output=True, text=True, check=True,
                               timeout=60).stdout.splitlines()
        if len(names) != len(mangled):
            raise RuntimeError(f"cu++filt gave {len(names)} names for {len(mangled)}")
        for full in names:
            key = _short_kernel_name(full)
            out[key] = out.get(key, 0) + 1
    return out


def _kernel_ms(fn, calls=5, reps=10) -> dict:
    """{CUDA kernel name: [device ms a call, launches a call]} of ``fn``, from a
    CUDA graph of ``calls`` calls. The names and launches are the graph's own
    kernel nodes (``_graph_nodes``), exact. The ms is ``torch.profiler``'s mean
    duration of that kernel's records over ``reps`` replays times its launches
    a call (None where the profiler kept no record of it): the profiler may
    drop records, more of them late in a long process, so its counts are not
    used. The profiled window is padded with 20 ms of host sleep on each side."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    nodes = _graph_nodes(graph)
    graph.replay()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(0.02)
        for _ in range(reps):
            graph.replay()
        torch.cuda.synchronize()
        time.sleep(0.02)
    recorded = {}
    for evt in prof.key_averages():
        total = getattr(evt, "self_device_time_total", None)
        if total is None:
            total = evt.self_cuda_time_total
        if total <= 0 or evt.count <= 0:
            continue
        us, n = recorded.get(_short_kernel_name(evt.key), (0.0, 0))
        recorded[_short_kernel_name(evt.key)] = (us + total, n + evt.count)
    out = {}
    for name, n in sorted(nodes.items()):
        per_call = n / calls
        us, seen = recorded.get(name, (0.0, 0))
        out[name] = [us / seen / 1e3 * per_call if seen else None, per_call]
    return out


@functools.lru_cache(maxsize=None)
def _hgmma_count(source: str) -> int:
    """``cuobjdump -sass``'s count of HGMMA instructions (``wgmma``) in the
    built library of ``csrc/<source>.cu``."""
    from streamspeech_tpu_torch.kernels import build

    tool = Path(build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(tool), "-sass", str(build.library_path(source))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout.count("HGMMA")


def _bf16_forward_form(A, family, call, tk, d) -> dict:
    """The bf16 forward's form at this shape (``bf16_forward_form``), the CUDA
    kernels one call launches (``_kernel_ms``: their names and each one's
    launches a call, read from the captured graph's kernel nodes)
    and its library's HGMMA count; raises unless the head dim the path runs
    (64) takes the wgmma form, ``fwd_kernel`` once a call, from a library with
    HGMMA in it."""
    ms = _kernel_ms(call)
    row = {"form": A.bf16_forward_form(family, tk, d), "kernels_a_call": len(ms),
           "kernels_ms_launches": ms,
           "hgmma_instructions": _hgmma_count(f"{family}_attention_bf16")}
    if d == 64 and not (row["form"] == "wgmma" and list(ms) == ["fwd_kernel"]
                        and ms["fwd_kernel"][1] == 1
                        and row["hgmma_instructions"] > 0):
        raise AssertionError(f"the bf16 {family} forward at D = 64 does not run the wgmma "
                             f"form alone: {row}")
    return row


def _bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations over
    the fp32 peak and the bytes over the memory rate, and which one bounds."""
    by_ops, by_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


def _bound_3xtf32(flops: float, nbytes: float) -> dict:
    """The bound of fp32-faithful work on the tensor cores (B1-B6: each
    product is three TF32 products): max(3 flops / 495 TFLOP/s, bytes /
    3.35 TB/s), with the CUDA-core bound of ``_bound`` beside it, labelled."""
    by_ops, by_bytes = 3 * flops / TF32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    cuda_core = _bound(flops, nbytes)
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "bound_rate": "3xTF32 tensor cores, 495/3 TFLOP/s",
            "cuda_core_bound_ms": cuda_core["bound_ms"],
            "cuda_core_bound_by": cuda_core["bound_by"]}


def _bound_bf16(flops: float, nbytes: float) -> dict:
    """The bound of one bf16 product on the tensor cores: max(flops / 989
    TFLOP/s, bytes / 3.35 TB/s)."""
    by_ops, by_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "bound_rate": "bf16 tensor cores, 989 TFLOP/s"}


def _bf16_bound(reference, q, k, v, bias) -> torch.Tensor:
    """Each output element's bound for a bf16 attention form against its plain
    version ``reference``: each probability p_j is rounded to bf16 once on each
    side (at most 2^-8 p_j, round to nearest with 8 significant bits; the
    kernel before normalising, the plain version after), so the two differ by
    at most 2^-7 sum_j p_j |v_j|, plus the fp32 summation order. ``reference``
    on |v| in float32 forms that sum from its own fp32 probabilities, rounding
    none."""
    return 2 * BF16_ROUNDING * reference(q, k, v.float().abs(), bias, 0.125) + KERNEL_ATOL


def _bound_share(got: torch.Tensor, want: torch.Tensor, atol) -> float:
    """The largest share of its bound that any element's |got - want| reached
    (``atol`` a number or a tensor of per-element bounds)."""
    return float(((got - want).abs() / atol).max())


def _bound_draws(draws: float, nbytes: float) -> dict:
    """B10's bound: the larger of its draws' FMA-pipe and ALU-pipe instructions,
    each pipe at INT_PIPE_OPS, and its bytes at 3.35 TB/s."""
    fma = draws * DRAW_FMA_OPS / INT_PIPE_OPS * 1e3
    alu = draws * DRAW_ALU_OPS / INT_PIPE_OPS * 1e3
    by_bytes = nbytes / HBM_BYTES * 1e3
    return {"draws": draws, "bytes": nbytes, "fma_pipe_ms": fma, "alu_pipe_ms": alu,
            "bytes_ms": by_bytes, "bound_ms": max(fma, alu, by_bytes),
            "bound_by": "operations" if max(fma, alu) >= by_bytes else "bytes",
            "bound_rate": f"integer pipes at 16.75 T instructions/s each, {DRAW_FMA_OPS} "
                          f"FMA-pipe and {DRAW_ALU_OPS} ALU-pipe a draw of 4 elements"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _pad_keys(k, v, bias):
    """K, V and the bias [B, TQ, TK] as the bias route hands them to the kernel:
    keys padded to BIAS_KEY_TILE with zero K and V and a NEG_INF bias."""
    import torch.nn.functional as F

    from streamspeech_tpu_torch.ops.masks import NEG_INF

    pad = -(-k.shape[2] // BIAS_KEY_TILE) * BIAS_KEY_TILE - k.shape[2]
    return (F.pad(k, (0, 0, 0, pad)), F.pad(v, (0, 0, 0, pad)),
            F.pad(bias, (0, pad), value=NEG_INF).contiguous())


def _check_kernel(name, fn, plain, library, args, atol, bound, extra=None, **shape):
    """Run ``fn`` and ``plain`` on the same inputs, compare, time both (and the
    library yardstick, if any); emit and return the row (with the fields of
    ``extra(*args)``, if given)."""
    got = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    share = _bound_share(got, want, atol)
    if torch.is_tensor(atol):   # a bound for each element
        atol = {"per_element_max": float(atol.max()), "per_element_min": float(atol.min())}
    row = {"phase": "kernel", "name": name, **shape, "max_abs_err": err,
           "atol": atol, "bound_share": share, "ms": _device_ms(lambda: fn(*args)),
           "plain_ms": _device_ms(lambda: plain(*args)),
           "library_ms": None if library is None else _device_ms(lambda: library(*args)),
           "eager_call_ms": _time_ms(lambda: fn(*args)), **bound,
           **({} if extra is None else extra(*args))}
    emit(row)
    if not share <= 1.0:
        raise AssertionError(f"{name} disagrees with its plain version at {shape}: "
                             f"an error {share} of its bound {atol}")
    return row


def _check_masked_batched(A, randn, dev):
    """B3 at the batched wave's shape: B streams in one call, each row's keys
    valid to its own length (``MASKED_BATCHED_SHAPE``). The bound counts the
    pairs this data needs: query i of row b reads min(i + 1, valid_b) keys."""
    import torch.nn.functional as F

    from streamspeech_tpu_torch.ops.masks import NEG_INF

    b, t_pad, valid = MASKED_BATCHED_SHAPE
    q, k, v = (randn(b, 8, t_pad, 64) for _ in range(3))
    n_valid = torch.tensor(valid, device=dev)
    i = torch.arange(t_pad, device=dev)
    kvb = torch.where(i[None] < n_valid[:, None], 0.0, NEG_INF).float().view(b, 1, t_pad)
    mask = (kvb[:, :, None, :]
            + torch.where(i[:, None] >= i[None, :], 0.0, NEG_INF).float())
    pairs = sum(float(torch.clamp(i + 1, max=n).sum()) for n in valid)
    bound = _bound_3xtf32(4 * 8 * pairs * 64, _nbytes(q, k, v, kvb, q))
    return _check_kernel(
        "masked_attention", lambda *a: A.masked_attention(*a, 0.125),
        lambda *a: A.masked_attention_reference(*a, 0.125),
        lambda q, k, v, _: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                          scale=0.125),
        (q, k, v, kvb), KERNEL_ATOL, bound, b=b, h=8, t_pad=t_pad, t=max(valid), d=64,
        rows_valid=list(valid))


def phase_kernel():
    import torch.nn.functional as F

    from streamspeech_tpu_torch.kernels import attention as A
    from streamspeech_tpu_torch.kernels import policy
    from streamspeech_tpu_torch.ops.masks import NEG_INF

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    rows = {"masked_attention": [], "relpos_attention": [], "bias_attention": [],
            "not_blank_probs": []}

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    for t_pad, t in MASKED_SHAPES:
        q, k, v = (randn(1, 8, t_pad, 64) for _ in range(3))
        # the unit decoder's key bias: real rows valid, tile padding masked
        kvb = torch.where(torch.arange(t_pad) < t, 0.0, NEG_INF)
        kvb = kvb.to(torch.float32).view(1, 1, t_pad).to(dev)
        i = torch.arange(t_pad, device=dev)
        mask = (kvb[:, :, None, :]
                + torch.where(i[:, None] >= i[None, :], 0.0, NEG_INF).float())
        pairs = t_pad * (t_pad + 1) / 2        # the causal half the data needs
        bound = _bound_3xtf32(4 * 8 * pairs * 64, _nbytes(q, k, v, kvb, q))
        row = _check_kernel(
            "masked_attention", lambda *a: A.masked_attention(*a, 0.125),
            lambda *a: A.masked_attention_reference(*a, 0.125),
            lambda q, k, v, _: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                              scale=0.125),
            (q, k, v, kvb), KERNEL_ATOL, bound, b=1, h=8, t_pad=t_pad, t=t, d=64)
        rows["masked_attention"].append(row)

    rows["masked_attention"].append(_check_masked_batched(A, randn, dev))

    for b, t in RELPOS_SHAPES:
        qu, qv, k, v = (randn(b, 4, t, 64) for _ in range(4))
        p = randn(4, 2 * t - 1, 64)
        # the encoder's bias: chunk-8 mask plus key validity (last row shorter)
        n_valid = torch.tensor([t] * (b - 1) + [t - 56], device=dev)
        i, j = torch.arange(t, device=dev)[:, None], torch.arange(t, device=dev)[None]
        allowed = (j < ((i // 8 + 1) * 8).clamp(max=t))[None, None] & \
            (torch.arange(t, device=dev) < n_valid[:, None])[:, None, None, :]
        bias = torch.where(allowed, 0.0, NEG_INF).float().contiguous()
        pairs = b * 4 * t * t * 64
        nbytes = _nbytes(qu, qv, k, v, p, bias, qu)
        bound = {**_bound_3xtf32(6 * pairs, nbytes), **_relpos_fwd_plan(pairs, nbytes)}
        rows["relpos_attention"].append(_check_kernel(
            "relpos_attention", lambda *a: A.relpos_attention(*a, 0.125),
            lambda *a: A.relpos_attention_reference(*a, 0.125), None,
            (qu, qv, k, v, p, bias), KERNEL_ATOL, bound, b=b, h=4, t=t, d=64))

    for b, tq, tk in BIAS_SHAPES:
        q, k, v = randn(b, 8, tq, 64), randn(b, 8, tk, 64), randn(b, 8, tk, 64)
        # the unit decoder's wait-k cross mask (n2 = 1, upsample 25), the last
        # row with 5 padded keys
        iq, jk = torch.arange(tq, device=dev)[:, None], torch.arange(tk, device=dev)
        n_valid = torch.tensor([tk] * (b - 1) + [tk - 5], device=dev)
        allowed = (jk[None] < (iq // 25 + 1).clamp(max=tk))[None] & \
            (jk[None, None, :] < n_valid[:, None, None])
        k, v, bias = _pad_keys(k, v, torch.where(allowed, 0.0, NEG_INF).float())
        tk_valid, tk = tk, k.shape[2]
        bound = _bound_3xtf32(4 * b * 8 * tq * tk * 64, _nbytes(q, k, v, bias, q))
        rows["bias_attention"].append(_check_kernel(
            "bias_attention", lambda *a: A.bias_attention(*a, 0.125),
            lambda *a: A.bias_attention_reference(*a, 0.125),
            lambda q, k, v, bias: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias[:, None], scale=0.125),
            (q, k, v, bias), KERNEL_ATOL, bound, b=b, h=8, tq=tq, tk=tk, tk_valid=tk_valid,
            d=64))

    for b, t, vocab in NOT_BLANK_SHAPES:
        logits = randn(b, t, vocab) * 4
        # max, exp, sum and the product with the previous row: ~4 ops a logit
        bound = _bound(4 * b * t * vocab, b * t * vocab * 4 + b * t * 4)
        rows["not_blank_probs"].append(_check_kernel(
            "not_blank_probs", policy.not_blank_probs,
            policy.not_blank_probs_reference, None, (logits,), NOT_BLANK_ATOL,
            bound, b=b, t=t, v=vocab))
    for b, t, vocab in NOT_BLANK_ODD_SHAPES:  # 4-byte loads, a ragged last round
        logits = randn(b, t, vocab) * 4
        err = float((policy.not_blank_probs(logits, vocab - 1) -
                     policy.not_blank_probs_reference(logits, vocab - 1)).abs().max())
        row = {"phase": "kernel", "name": "not_blank_probs", "b": b, "t": t, "v": vocab,
               "blank": vocab - 1, "max_abs_err": err, "atol": NOT_BLANK_ATOL}
        emit(row)
        if not err <= NOT_BLANK_ATOL:
            raise AssertionError(f"not_blank_probs disagrees at {row}")
        rows["not_blank_probs"].append(row)
    rows["ctc_alpha"], rows["ctc_beta"] = [], []
    for shape in CTC_SHAPES:
        alpha_row, beta_row = _check_ctc(dev, gen, *shape)
        rows["ctc_alpha"].append(alpha_row)
        rows["ctc_beta"].append(beta_row)
    return rows


def phase_kernel_bf16():
    """The bf16 forms of B3, B5 and B7 against their plain bf16 versions at
    phase 3's shapes (bf16 q/k/v or logits, the biases fp32, fp32 outputs)."""
    import torch.nn.functional as F

    from streamspeech_tpu_torch.kernels import attention as A
    from streamspeech_tpu_torch.kernels import policy
    from streamspeech_tpu_torch.ops.masks import NEG_INF

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED + 7)
    rows = {"masked_attention_bf16": [], "bias_attention_bf16": [],
            "not_blank_probs_bf16": []}

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)

    for t_pad, t in MASKED_SHAPES:
        q, k, v = (randn(1, 8, t_pad, 64) for _ in range(3))
        kvb = torch.where(torch.arange(t_pad) < t, 0.0, NEG_INF)
        kvb = kvb.to(torch.float32).view(1, 1, t_pad).to(dev)
        i = torch.arange(t_pad, device=dev)
        mask = (kvb[:, :, None, :]
                + torch.where(i[:, None] >= i[None, :], 0.0, NEG_INF).float()).bfloat16()
        pairs = t_pad * (t_pad + 1) / 2        # the causal half the data needs
        # bf16 q, k, v read, the fp32 key bias read and the fp32 output written
        bound = _bound_bf16(4 * 8 * pairs * 64, _nbytes(q, k, v, kvb) + 4 * q.numel())
        rows["masked_attention_bf16"].append(_check_kernel(
            "masked_attention_bf16", lambda *a: A.masked_attention(*a, 0.125),
            lambda *a: A.masked_attention_reference(*a, 0.125),
            lambda q, k, v, _: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                              scale=0.125),
            (q, k, v, kvb), _bf16_bound(A.masked_attention_reference, q, k, v, kvb), bound,
            lambda *a: _bf16_forward_form(A, "masked", lambda: A.masked_attention(*a, 0.125),
                                          t_pad, 64),
            b=1, h=8, t_pad=t_pad, t=t, d=64))
        del mask

    for b, tq, tk in BIAS_SHAPES:
        q, k, v = randn(b, 8, tq, 64), randn(b, 8, tk, 64), randn(b, 8, tk, 64)
        iq, jk = torch.arange(tq, device=dev)[:, None], torch.arange(tk, device=dev)
        n_valid = torch.tensor([tk] * (b - 1) + [tk - 5], device=dev)
        allowed = (jk[None] < (iq // 25 + 1).clamp(max=tk))[None] & \
            (jk[None, None, :] < n_valid[:, None, None])
        k, v, bias = _pad_keys(k, v, torch.where(allowed, 0.0, NEG_INF).float())
        tk_valid, tk = tk, k.shape[2]
        mask = bias[:, None].bfloat16()
        bound = _bound_bf16(4 * b * 8 * tq * tk * 64, _nbytes(q, k, v, bias) + 4 * q.numel())
        rows["bias_attention_bf16"].append(_check_kernel(
            "bias_attention_bf16", lambda *a: A.bias_attention(*a, 0.125),
            lambda *a: A.bias_attention_reference(*a, 0.125),
            lambda q, k, v, _: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                              scale=0.125),
            (q, k, v, bias), _bf16_bound(A.bias_attention_reference, q, k, v, bias), bound,
            lambda *a: _bf16_forward_form(A, "bias", lambda: A.bias_attention(*a, 0.125), tk, 64),
            b=b, h=8, tq=tq, tk=tk, tk_valid=tk_valid, d=64))

    for b, t, vocab in NOT_BLANK_SHAPES:
        logits = randn(b, t, vocab) * 4
        # ~4 fp32 ops a logit on the CUDA cores; bf16 logits read once
        bound = _bound(4 * b * t * vocab, b * t * vocab * 2 + b * t * 4)
        rows["not_blank_probs_bf16"].append(_check_kernel(
            "not_blank_probs_bf16", policy.not_blank_probs,
            policy.not_blank_probs_reference, None, (logits,), NOT_BLANK_ATOL,
            bound, b=b, t=t, v=vocab))
    for b, t, vocab in NOT_BLANK_ODD_SHAPES:  # single-logit loads, a ragged last round
        logits = randn(b, t, vocab) * 4
        err = float((policy.not_blank_probs(logits, vocab - 1) -
                     policy.not_blank_probs_reference(logits, vocab - 1)).abs().max())
        row = {"phase": "kernel", "name": "not_blank_probs_bf16", "b": b, "t": t,
               "v": vocab, "blank": vocab - 1, "max_abs_err": err, "atol": NOT_BLANK_ATOL}
        emit(row)
        if not err <= NOT_BLANK_ATOL:
            raise AssertionError(f"not_blank_probs (bf16) disagrees at {row}")
        rows["not_blank_probs_bf16"].append(row)
    return rows


def _scaled_err(got, want):
    """(max |got - want| over reachable states, max |got - want| / max(1, |want|))."""
    from streamspeech_tpu_torch.kernels.ctc import NNEG

    err = (got - want).abs()
    reachable = want > NNEG / 2
    return (float(err[reachable].max()) if reachable.any() else 0.0,
            float((err / want.abs().clamp(min=1.0)).max()))


def _check_ctc(dev, gen, b, t, vocab, n, blank):
    """B8 and B9 against their plain versions on one CTC head's DP inputs:
    numpy-free seeded logits, labels that avoid the blank, the last row with
    1/8 of its frames padded and 5 labels fewer. Returns the two rows."""
    import torch.nn.functional as F

    from streamspeech_tpu_torch.kernels import ctc

    logits = (torch.randn(b, t, vocab, generator=gen) * 2).to(dev)
    labels = torch.randint(4, blank if blank > 0 else vocab, (b, n), generator=gen).to(dev)
    lengths = torch.tensor([t] * (b - 1) + [t - t // 8], device=dev)
    lab_len = torch.tensor([n] * (b - 1) + [n - 5], device=dev)
    parts = {k: v.contiguous() for k, v in
             ctc.ext_and_masks(logits, lengths, labels, lab_len, blank).items()}
    lp, init, end, skip, valid = (parts[k] for k in ("lp_ext", "initmask", "endmask",
                                                       "skipmask", "validmask"))
    s = lp.shape[2]
    shape = {"b": b, "t": t, "s": s, "v": vocab, "serial_steps": t}
    # the cut of the state axis both kernels launch: a cluster of blocks a row
    plan = ctc.cluster_plan(s)

    alpha = ctc.ctc_alpha(lp, init, skip, valid)
    want = ctc.ctc_alpha_reference(lp, init, skip, valid)
    nll, logz = ctc.nll_from_alpha(alpha, end)
    want_nll, _ = ctc.nll_from_alpha(want, end)
    zbias = torch.where(logz > ctc.NNEG / 2, -logz, torch.full_like(logz, ctc.NNEG))
    grad = ctc.ctc_beta_grad(lp, end, skip, zbias, valid, alpha)
    want_grad = ctc.ctc_beta_grad_reference(lp, end, skip, zbias, valid, alpha)
    # the library yardstick on the same log-probs (the port never calls it)
    log_probs = torch.log_softmax(logits, -1).transpose(0, 1).contiguous()
    lib_args = (labels, lengths, lab_len)

    def library(x):
        return F.ctc_loss(x, *lib_args, blank=blank, reduction="none",
                          zero_infinity=True)

    lib_nll = library(log_probs)
    torch.cuda.synchronize()
    alpha_abs, alpha_scaled = _scaled_err(alpha, want)
    _, nll_scaled = _scaled_err(nll, want_nll)
    _, lib_scaled = _scaled_err(nll, lib_nll)
    grad_err = float((grad - want_grad).abs().max())

    x_req = log_probs.detach().requires_grad_()

    def library_fwd_bwd():
        torch.autograd.grad(library(x_req).sum(), x_req)

    lib_fwd_ms = _time_ms(lambda: library(log_probs), reps=10, warmup=2)
    lib_fwd_bwd_ms = _time_ms(library_fwd_bwd, reps=10, warmup=2)
    n_el = b * t * s
    alpha_row = {
        "phase": "kernel", "name": "ctc_alpha", **shape, **plan, "max_abs_err": alpha_abs,
        "max_scaled_err": alpha_scaled, "nll_max_scaled_err": nll_scaled,
        "library_nll_max_scaled_err": lib_scaled, "tol": f"{CTC_RTOL}*max(1,|ref|)",
        "ms": _device_ms(lambda: ctc.ctc_alpha(lp, init, skip, valid), calls=5, reps=10),
        "plain_ms": _device_ms(lambda: ctc.ctc_alpha_reference(lp, init, skip, valid),
                               calls=1, reps=3),
        "library_ms": lib_fwd_ms, "library_timing": "eager, F.ctc_loss forward",
        "eager_call_ms": _time_ms(lambda: ctc.ctc_alpha(lp, init, skip, valid), reps=10),
        # lse3 of three terms, the add of lp and the select: ~14 ops a state
        **_bound(14 * n_el, _nbytes(lp, init, skip, valid, alpha))}
    alpha_row["ms_per_serial_step"] = alpha_row["ms"] / t
    emit(alpha_row)
    beta_row = {
        "phase": "kernel", "name": "ctc_beta", **shape, **plan, "max_abs_err": grad_err,
        "atol": CTC_GRAD_ATOL,
        "ms": _device_ms(lambda: ctc.ctc_beta_grad(lp, end, skip, zbias, valid, alpha),
                         calls=5, reps=10),
        "plain_ms": _device_ms(lambda: ctc.ctc_beta_grad_reference(
            lp, end, skip, zbias, valid, alpha), calls=1, reps=3),
        "library_ms": lib_fwd_bwd_ms - lib_fwd_ms,
        "library_timing": "eager, F.ctc_loss forward+backward minus forward",
        "eager_call_ms": _time_ms(lambda: ctc.ctc_beta_grad(lp, end, skip, zbias, valid,
                                                            alpha), reps=10),
        # lse3 (~14 ops) and the occupancy exp(min(a + b + z, 0)) (~5) a state
        **_bound(19 * n_el, _nbytes(lp, end, skip, zbias, valid, alpha, grad))}
    beta_row["ms_per_serial_step"] = beta_row["ms"] / t
    emit(beta_row)
    if not (alpha_scaled <= CTC_RTOL and nll_scaled <= CTC_RTOL):
        raise AssertionError(f"ctc_alpha disagrees with its plain version at {shape}: "
                             f"alpha {alpha_scaled}, nll {nll_scaled} > {CTC_RTOL}")
    if not grad_err <= CTC_GRAD_ATOL:
        raise AssertionError(f"ctc_beta disagrees with its plain version at {shape}: "
                             f"{grad_err} > {CTC_GRAD_ATOL}")
    if not lib_scaled <= CTC_LIBRARY_RTOL:
        raise AssertionError(f"CTC NLL disagrees with F.ctc_loss at {shape}: "
                             f"{lib_scaled} > {CTC_LIBRARY_RTOL}")
    return alpha_row, beta_row


def _fwd_bwd_ms(fn, xs, g, calls=3, reps=5):
    """Device ms of ``fn(*xs)`` and its backward for d loss / d out = g."""
    def run():
        leaves = [x.detach().requires_grad_() for x in xs]
        torch.autograd.grad(fn(*leaves), leaves, g)
    return _device_ms(run, calls=calls, reps=reps)


def _rel_err(got, want):
    """(max |got - want|, the same over max |want|)."""
    err = float((got - want).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def _check_train_kernel(family, A, diff, const, g, scale, keep_shape, library_mask,
                        fwd_bound, bwd_bound, timed, bwd_extra=None, **shape):
    """One attention family at one shape, at dropout 0 and ATTN_DROPOUT: mask,
    forward with dropout and backward against the plain versions; timed on the
    main shape. Returns (forward rows, backward rows, mask rows)."""
    import torch.nn.functional as F

    fwd = getattr(A, f"{family}_attention_forward")
    bwd = getattr(A, f"{family}_attention_backward")
    ref = getattr(A, f"{family}_attention_reference")
    ref_bwd = getattr(A, f"{family}_attention_backward_reference")
    public = getattr(A, f"{family}_attention")
    names = ["dq_u", "dq_v", "dk", "dv", "dp"] if family == "relpos" else ["dq", "dk", "dv"]
    seed = torch.tensor([SEED + 20 + keep_shape[2]], dtype=torch.int64, device=g.device)
    fwd_rows, bwd_rows, mask_rows = [], [], []
    for rate in (0.0, ATTN_DROPOUT):
        keep, sd = None, None
        if rate > 0:
            sd = seed
            keep = A.dropout_keep_reference(sd, *keep_shape, rate)
            drawn = A.dropout_keep(sd, *keep_shape, rate)
            share, n = float(keep.float().mean()), keep.numel()
            differing = int((drawn != keep).sum())
            mask_row = {"phase": "kernel", "name": "dropout_keep", "for": family, **shape,
                        "rate": rate, "elements": n, "differing": differing,
                        "max_abs_err": float(differing), "keep_share": share,
                        "three_sigma": 3 * (rate * (1 - rate) / n) ** 0.5}
            del drawn
            emit(mask_row)
            mask_rows.append(mask_row)
            if mask_row["differing"] != 0 or \
                    abs(share - (1 - rate)) > mask_row["three_sigma"]:
                raise AssertionError(f"dropout mask of {family} at {shape}: {mask_row}")
        out, stats = fwd(*diff, *const, scale, rate, sd, True)
        want = ref(*diff, *const, scale, keep, rate)
        got_grads = bwd(*diff, *const, g, out, stats, sd, scale, rate)
        again = bwd(*diff, *const, g, out, stats, sd, scale, rate)
        want_grads = ref_bwd(*diff, *const, g, scale, keep, rate)
        xs = [x.detach().requires_grad_() for x in diff]
        auto_grads = torch.autograd.grad(public(*xs, *const, scale, rate, sd), xs, g)
        torch.cuda.synchronize()
        out_err, out_rel = _rel_err(out, want)
        grad_errs = {n: _rel_err(a, w) for n, a, w in zip(names, got_grads, want_grads)}
        same = all(torch.equal(a, b) for a, b in zip(got_grads, again)) and \
            all(torch.equal(a, b) for a, b in zip(got_grads, auto_grads))
        del want, want_grads, again, auto_grads, xs
        base = {"phase": "kernel", **shape, "rate": rate, "rtol": ATTN_TRAIN_RTOL}
        fwd_row = {**base, "name": f"{family}_attention", "form": "training forward",
                   "max_abs_err": out_err, "max_rel_err": out_rel, **fwd_bound}
        bwd_row = {**base, "name": f"{family}_attention_bwd",
                   "max_abs_err": max(e for e, _ in grad_errs.values()),
                   "max_rel_err": max(r for _, r in grad_errs.values()),
                   "rel_err_by_grad": {n: r for n, (_, r) in grad_errs.items()},
                   "bit_identical_twice": same, **bwd_bound, **(bwd_extra or {})}
        if timed:
            fwd_row["ms"] = _device_ms(lambda: fwd(*diff, *const, scale, rate, sd, True),
                                       calls=5, reps=10)
            fwd_row["plain_ms"] = _device_ms(lambda: ref(*diff, *const, scale, keep, rate),
                                             calls=3, reps=5)
            bwd_row["ms"] = _device_ms(
                lambda: bwd(*diff, *const, g, out, stats, sd, scale, rate), calls=5, reps=10)
            bwd_row["plain_ms"] = _device_ms(
                lambda: ref_bwd(*diff, *const, g, scale, keep, rate), calls=3, reps=5)
            bwd_row["plain_autograd_fwd_bwd_ms"] = _fwd_bwd_ms(
                lambda *xs: ref(*xs, *const, scale, keep, rate), diff, g)
            bwd_row["kernel_fwd_bwd_ms"] = _fwd_bwd_ms(
                lambda *xs: public(*xs, *const, scale, rate, sd), diff, g, calls=5, reps=10)
            fwd_row["library_ms"] = bwd_row["library_ms"] = None
            if library_mask is not None:
                def sdpa(q, k, v):
                    return F.scaled_dot_product_attention(q, k, v, attn_mask=library_mask,
                                                          dropout_p=rate, scale=scale)
                fwd_row["library_ms"] = _device_ms(lambda: sdpa(*diff), calls=5, reps=10)
                both = _fwd_bwd_ms(sdpa, diff, g, calls=5, reps=10)
                bwd_row["library_fwd_bwd_ms"] = both
                bwd_row["library_ms"] = both - fwd_row["library_ms"]
                bwd_row["library_timing"] = ("SDPA forward + backward minus forward, "
                                             "the same float mask and dropout_p")
            if rate > 0:  # what drawing the mask costs, in this call
                for row, at_zero in ((fwd_row, fwd_rows[0]), (bwd_row, bwd_rows[0])):
                    row["dropout_gap_ms"] = row["ms"] - at_zero["ms"]
        emit(fwd_row)
        emit(bwd_row)
        fwd_rows.append(fwd_row)
        bwd_rows.append(bwd_row)
        if not (out_rel <= ATTN_TRAIN_RTOL and bwd_row["max_rel_err"] <= ATTN_TRAIN_RTOL
                and same):
            raise AssertionError(f"{family} attention's training form disagrees with "
                                 f"its plain version at {shape}: {fwd_row} {bwd_row}")
        del out, stats, got_grads, keep
    return fwd_rows, bwd_rows, mask_rows


def _bias_bwd_plan(A, b, h, tq, tk, d) -> dict:
    """B6's form at this shape: its query-tile groups G (0: two passes) and
    the bytes of the scratch its wrapper allocates (the groups' dK/dV
    partials, or delta)."""
    groups, shape = A.bias_backward_scratch(b, h, tq, tk, d)
    return {"groups": groups, "scratch_bytes": 4 * int(np.prod(shape)),
            "form": f"fused, {groups} query-tile groups" if groups else "two passes"}


def _relpos_bwd_plan(A, b, h, t, d, pairs, nbytes) -> dict:
    """B2's extra work at this shape: the flops its band products run (W =
    q_v Pwᵀ over 2 BT table rows, Z Pw and Zᵀ q_v over the [BT, 2 BT] band tile:
    11 products' worth where the function has 8) with their 3xTF32 bound, and
    the bytes of the scratch its wrapper allocates."""
    run = _bound_3xtf32(22 * pairs, nbytes)
    return {"kernel_flops": run["flops"], "kernel_flops_bound_ms": run["bound_ms"],
            "scratch_bytes": 4 * A.relpos_backward_scratch(b, h, t, d)}


def _relpos_fwd_plan(pairs, nbytes) -> dict:
    """B1's extra work: its band products run 16 x (KS + 16) scores for each
    16 x KS they yield (KS = 16 keys a warp), so 8 flops a (query, key,
    channel) where the function's three products have 6; with their 3xTF32
    bound."""
    run = _bound_3xtf32(8 * pairs, nbytes)
    return {"kernel_flops": run["flops"], "kernel_flops_bound_ms": run["bound_ms"]}


def _bias_train_inputs(b, tq, tk, randn, pad_keys=False):
    """q, K, V, g [b, 8, *, 64] from ``randn`` and the unit decoder's wait-k
    cross mask (n2 = 2, upsample 25) as a bias [b, tq, tk], the last row with
    5 padded keys; ``pad_keys``: the keys then padded as the bias route pads
    them (``_pad_keys``)."""
    from streamspeech_tpu_torch.ops.masks import NEG_INF

    q, g = randn(b, 8, tq, 64), randn(b, 8, tq, 64)
    k, v = randn(b, 8, tk, 64), randn(b, 8, tk, 64)
    dev = q.device
    iq, jk = torch.arange(tq, device=dev)[:, None], torch.arange(tk, device=dev)
    n_valid = torch.tensor([tk] * (b - 1) + [tk - 5], device=dev)
    allowed = (jk[None] < ((iq // 25 + 1) * 2).clamp(max=tk))[None] & \
        (jk[None, None, :] < n_valid[:, None, None])
    bias = torch.where(allowed, 0.0, NEG_INF).float().contiguous()
    if pad_keys:
        k, v, bias = _pad_keys(k, v, bias)
    return q, k, v, g, bias


def phase_kernel_train():
    """B1/B3/B5 with dropout and row statistics, B2/B4/B6 and B10 against their
    plain versions at the kernel train route's shapes."""
    from streamspeech_tpu_torch.kernels import attention as A
    from streamspeech_tpu_torch.ops.masks import NEG_INF

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED + 5)
    rows = {k: [] for k in ("masked_attention_train", "masked_attention_bwd",
                            "relpos_attention_train", "relpos_attention_bwd",
                            "bias_attention_train", "bias_attention_bwd", "dropout_keep")}

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    def collect(family, result):
        rows[f"{family}_attention_train"] += result[0]
        rows[f"{family}_attention_bwd"] += result[1]
        rows["dropout_keep"] += result[2]

    for n, (b, t, valid) in enumerate(RELPOS_TRAIN_SHAPES):
        qu, qv, k, v, g = (randn(b, 4, t, 64) for _ in range(5))
        p = randn(4, 2 * t - 1, 64)
        # the encoder's bias: chunk-8 mask plus key validity (last row shorter, so
        # its frames past `valid` are wholly masked rows)
        n_valid = torch.tensor([t] * (b - 1) + [valid], device=dev)
        i, j = torch.arange(t, device=dev)[:, None], torch.arange(t, device=dev)[None]
        allowed = (j < ((i // 8 + 1) * 8).clamp(max=t))[None, None] & \
            (torch.arange(t, device=dev) < n_valid[:, None])[:, None, None, :]
        bias = torch.where(allowed, 0.0, NEG_INF).float().contiguous()
        pairs = b * 4 * t * t * 64
        stats_bytes = b * 4 * t * 8
        # ac, bd and g.v recomputed; dq_u, dq_v, dK, dV, dP: 8 products
        bwd_bytes = _nbytes(qu, qv, k, v, p, bias, g, qu, qu, qv, k, v, p) + stats_bytes + 8
        fwd_bytes = _nbytes(qu, qv, k, v, p, bias, qu) + stats_bytes + 8
        collect("relpos", _check_train_kernel(
            "relpos", A, (qu, qv, k, v, p), (bias,), g, 0.125, (b, 4, t, t), None,
            {**_bound_3xtf32(6 * pairs, fwd_bytes), **_relpos_fwd_plan(pairs, fwd_bytes)},
            _bound_3xtf32(16 * pairs, bwd_bytes), timed=n == 0,
            bwd_extra=_relpos_bwd_plan(A, b, 4, t, 64, pairs, bwd_bytes), b=b, h=4, t=t,
            d=64, valid=valid))

    for n, (b, t_pad, t) in enumerate(MASKED_TRAIN_SHAPES):
        q, k, v, g = (randn(b, 8, t_pad, 64) for _ in range(4))
        kvb = torch.where(torch.arange(t_pad) < t, 0.0, NEG_INF)
        kvb = kvb.to(torch.float32).view(1, 1, t_pad).expand(b, 1, t_pad).contiguous().to(dev)
        i = torch.arange(t_pad, device=dev)
        mask = (kvb[:, :, None, :]
                + torch.where(i[:, None] >= i[None, :], 0.0, NEG_INF).float())
        pairs = b * 8 * (t_pad * (t_pad + 1) / 2) * 64   # the causal half the data needs
        stats_bytes = b * 8 * t_pad * 8
        collect("masked", _check_train_kernel(
            "masked", A, (q, k, v), (kvb,), g, 0.125, (b, 8, t_pad, t_pad),
            mask if n == 0 else None,
            _bound_3xtf32(4 * pairs, _nbytes(q, k, v, kvb, q) + stats_bytes + 8),
            # dq, dK, dV: 5 products (q.k and g.v are recomputed, not counted)
            _bound_3xtf32(10 * pairs,
                          _nbytes(q, k, v, kvb, g, q, q, k, v) + stats_bytes + 8),
            timed=n == 0, b=b, h=8, t_pad=t_pad, t=t, d=64))
        del mask

    for n, (b, tq, tk_valid) in enumerate(BIAS_TRAIN_SHAPES):
        q, k, v, g, bias = _bias_train_inputs(b, tq, tk_valid, randn, pad_keys=True)
        tk = k.shape[2]
        pairs = b * 8 * tq * tk * 64
        stats_bytes = b * 8 * tq * 8
        collect("bias", _check_train_kernel(
            "bias", A, (q, k, v), (bias,), g, 0.125, (b, 8, tq, tk),
            bias[:, None] if n == 0 else None,
            _bound_3xtf32(4 * pairs, _nbytes(q, k, v, bias, q) + stats_bytes + 8),
            _bound_3xtf32(10 * pairs,
                          _nbytes(q, k, v, bias, g, q, q, k, v) + stats_bytes + 8),
            timed=n == 0, bwd_extra=_bias_bwd_plan(A, b, 8, tq, tk, 64), b=b, h=8, tq=tq,
            tk=tk, tk_valid=tk_valid, d=64))

    # B10 alone: the mask of the unit decoder's causal attention, written out
    shape = (8, 8, 1280, 1280)
    seed = torch.tensor([SEED + 11], dtype=torch.int64, device=dev)
    n_el = shape[0] * shape[1] * shape[2] * shape[3]
    row = {"phase": "kernel", "name": "dropout_keep", "for": "timing", "b": shape[0],
           "h": shape[1], "tq": shape[2], "tk": shape[3], "rate": ATTN_DROPOUT,
           "max_abs_err": float(max(r["differing"] for r in rows["dropout_keep"])),
           "ms": _device_ms(lambda: A.dropout_keep(seed, *shape, ATTN_DROPOUT), calls=5,
                            reps=10),
           "plain_ms": _device_ms(lambda: A.dropout_keep_reference(seed, *shape,
                                                                   ATTN_DROPOUT),
                                  calls=1, reps=3),
           "library_ms": None}
    # a draw for each 4 columns of a row; one byte written an element
    row.update(_bound_draws(n_el // shape[3] * -(-shape[3] // 4), n_el + 8))
    emit(row)
    rows["dropout_keep"].append(row)
    return rows


def _bf16_ulp(x):
    """One bf16 ulp at each element's magnitude (8 significant bits); 0 at 0."""
    m, e = torch.frexp(x.float())
    return torch.where(x != 0, torch.ldexp(torch.ones_like(m), e - 8), torch.zeros_like(m))


def _bf16_backward_terms(family, A, q, k, v, bias, g, scale, keep, rate):
    """(the magnitudes of each gradient element's terms: of dq and dK ds with
    dp's own terms, p (|g||v|ᵀ kf + Σ p |g||v|ᵀ kf) scale (dp from g split in
    two bf16 parts errs by ~2^-17 of Σ_d |g_d v_jd|, and p (dp - delta) may
    cancel far below that), times |K| or |q|; of dV p kf |g|), and (delta =
    Σ_j p dp, the magnitudes of its terms Σ_j p kf Σ_d |g_d v_jd|) from the
    fp32 probabilities."""
    probs = (A._masked_probs if family == "masked" else A._bias_probs)(q, k, bias, scale)
    kf = torch.ones_like(probs) if keep is None else keep.float() / (1.0 - rate)
    dp_terms = torch.einsum("bhsd,bhtd->bhst", g.abs(), v.float().abs()) * kf
    absum = (probs * dp_terms).sum(-1)
    delta = (probs * torch.einsum("bhsd,bhtd->bhst", g, v.float()) * kf).sum(-1)
    ds = probs * (dp_terms + absum[..., None]) * scale
    terms = (torch.einsum("bhst,bhtd->bhsd", ds, k.float().abs()),
             torch.einsum("bhst,bhsd->bhtd", ds, q.float().abs()),
             torch.einsum("bhst,bhsd->bhtd", probs * kf, g.abs()))
    return terms, (delta, absum)


def _check_train_kernel_bf16(family, A, q, k, v, bias, g, scale, library_mask, fwd_bound,
                             bwd_bound, timed, **shape):
    """One bf16 attention family at one shape, at dropout 0 and ATTN_DROPOUT:
    the training forward within the bf16 forward's bound (2^-7 sum_j p kf |v|
    + 1e-5) of its plain version under the same mask; the backward's dq, dK,
    dV within one bf16 ulp plus BF16_GRAD_TERMS of their terms of the plain
    bf16 backward; delta (the dQ pass's scratch) within BF16_DELTA_TERMS of its
    terms' magnitudes of Σ p dp, where rowsum(g out) is checked to miss by more
    than 10 times that (V offset by 4, so that a kernel which took it fails);
    two backward calls equal bit for bit; timed on the main shape."""
    import torch.nn.functional as F

    fwd = getattr(A, f"{family}_attention_forward")
    bwd = getattr(A, f"{family}_attention_backward")
    ref = getattr(A, f"{family}_attention_reference")
    ref_bwd = getattr(A, f"{family}_attention_backward_reference")
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    seed = torch.tensor([SEED + 40 + tq], dtype=torch.int64, device=q.device)
    fwd_rows, bwd_rows = [], []
    for rate in (0.0, ATTN_DROPOUT):
        sd = seed if rate > 0 else None
        keep = A.dropout_keep_reference(seed, b, h, tq, tk, rate) if rate > 0 else None
        out, stats = fwd(q, k, v, bias, scale, rate, sd, True)
        grads = bwd(q, k, v, bias, g, out, stats, sd, scale, rate)
        again = bwd(q, k, v, bias, g, out, stats, sd, scale, rate)
        want = ref(q, k, v, bias, scale, keep, rate)
        out_bound = 2 * BF16_ROUNDING * ref(q, k, v.float().abs(), bias, scale, keep,
                                            rate) + KERNEL_ATOL
        out_share = _bound_share(out, want, out_bound)
        del want, out_bound
        want_grads = ref_bwd(q, k, v, bias, g, scale, keep, rate)
        terms, _ = _bf16_backward_terms(family, A, q, k, v, bias, g, scale, keep, rate)
        shares = {}
        for name, got, w, t in zip(("dq", "dk", "dv"), grads, want_grads, terms):
            bound = torch.maximum(_bf16_ulp(got), _bf16_ulp(w)) + BF16_GRAD_TERMS * t + 1e-30
            shares[name] = _bound_share(got.float(), w.float(), bound)
        grad_err = max(float((a.float() - w.float()).abs().max())
                       for a, w in zip(grads, want_grads))
        same = all(torch.equal(a, c) for a, c in zip(grads, again))
        del want_grads, terms, again
        # delta, with V offset as trained values are: the kernel's against
        # Σ p dp, and rowsum(g out) against it
        v4 = (v.float() + 4.0).bfloat16()
        out4, stats4 = fwd(q, k, v4, bias, scale, rate, sd, True)
        delta = A.backward_bf16(family, q, k, v4, bias, g, stats4, sd, scale, rate)[3]
        _, (true, absum) = _bf16_backward_terms(family, A, q, k, v4, bias, g, scale, keep,
                                                rate)
        tol = BF16_DELTA_TERMS * absum + 1e-6
        delta_share = _bound_share(delta, true, tol)
        from_out_share = _bound_share((g * out4).sum(-1), true, tol)
        torch.cuda.synchronize()
        del out4, stats4, delta, true, absum, tol, v4
        base = {"phase": "kernel", **shape, "rate": rate}
        fwd_row = {**base, "name": f"{family}_attention_bf16", "form": "training forward",
                   "max_abs_err": float((out - ref(q, k, v, bias, scale, keep, rate))
                                        .abs().max()),
                   "bound_share": out_share, **fwd_bound}
        bwd_row = {**base, "name": f"{family}_attention_bwd_bf16", "max_abs_err": grad_err,
                   "bound_share_by_grad": shares, "grad_terms_share": BF16_GRAD_TERMS,
                   "delta_bound_share": delta_share,
                   "delta_from_out_bound_share": from_out_share,
                   "bit_identical_twice": same, **bwd_bound,
                   "kernels_a_call": A.bf16_backward_kernels(
                       A._MASKED_BWD_BF16_KERNELS if family == "masked"
                       else A._BIAS_BWD_BF16_KERNELS, b, h, tq, tk, q.shape[3])}
        if timed:
            fwd_row["ms"] = _device_ms(lambda: fwd(q, k, v, bias, scale, rate, sd, True),
                                       calls=5, reps=10)
            fwd_row.update(_bf16_forward_form(
                A, family, lambda: fwd(q, k, v, bias, scale, rate, sd, True), tk, q.shape[3]))
            fwd_row["plain_ms"] = _device_ms(lambda: ref(q, k, v, bias, scale, keep, rate),
                                             calls=3, reps=5)
            bwd_row["ms"] = _device_ms(
                lambda: bwd(q, k, v, bias, g, out, stats, sd, scale, rate), calls=5, reps=10)
            bwd_row["kernels_ms_launches"] = _kernel_ms(
                lambda: bwd(q, k, v, bias, g, out, stats, sd, scale, rate))
            bwd_row["plain_ms"] = _device_ms(
                lambda: ref_bwd(q, k, v, bias, g, scale, keep, rate), calls=3, reps=5)

            def sdpa(q, k, v):
                return F.scaled_dot_product_attention(q, k, v, attn_mask=library_mask,
                                                      dropout_p=rate, scale=scale)
            fwd_row["library_ms"] = _device_ms(lambda: sdpa(q, k, v), calls=5, reps=10)
            both = _fwd_bwd_ms(sdpa, (q, k, v), g.bfloat16(), calls=5, reps=10)
            bwd_row["library_fwd_bwd_ms"] = both
            bwd_row["library_ms"] = both - fwd_row["library_ms"]
            bwd_row["library_timing"] = ("bf16 SDPA forward + backward minus forward, the "
                                         "same mask in bf16 and dropout_p")
            if rate > 0:
                for row, at_zero in ((fwd_row, fwd_rows[0]), (bwd_row, bwd_rows[0])):
                    row["dropout_gap_ms"] = row["ms"] - at_zero["ms"]
        emit(fwd_row)
        emit(bwd_row)
        fwd_rows.append(fwd_row)
        bwd_rows.append(bwd_row)
        if not (out_share <= 1.0 and max(shares.values()) <= 1.0 and delta_share <= 1.0
                and from_out_share > 10.0 and same):
            raise AssertionError(f"{family} bf16 training form disagrees with its plain "
                                 f"version at {shape}: {fwd_row} {bwd_row}")
        del out, stats, grads, keep
    return fwd_rows, bwd_rows


def _keep_bits_bf16(A, family, dev):
    """The bf16 training forms' own keep bits at T = D = 64: with v the
    identity the forward's out[i, j] is bf16(p kf)[i, j] / sum, with g the
    identity the backward's dV[j, i] is p kf; their nonzero elements must be
    the kept ones of ``dropout_keep_reference`` that the mask allows."""
    from streamspeech_tpu_torch.ops.masks import NEG_INF

    b, h, t = 2, 3, 64
    gen = torch.Generator().manual_seed(SEED + 9)
    q, k = (torch.randn(b, h, t, t, generator=gen).to(dev, torch.bfloat16) for _ in range(2))
    if family == "masked":
        bias = torch.zeros(b, 1, t, device=dev)
        bias[1, 0, t - 8:] = NEG_INF
    else:
        j = torch.arange(t, device=dev)
        bias = torch.where(j[None, None] < (j[None, :, None] // 3 + 1), 0.0, NEG_INF)
        bias = bias.expand(b, t, t).contiguous()
    eye = torch.eye(t, device=dev).expand(b, h, t, t).contiguous()
    seed = torch.tensor([SEED + 13], dtype=torch.int64, device=dev)
    ref = getattr(A, f"{family}_attention_reference")
    allowed = ref(q, k, eye.bfloat16(), bias, 0.125, None, 0.0) != 0
    want = A.dropout_keep_reference(seed, b, h, t, t, ATTN_DROPOUT) & allowed
    out, stats = getattr(A, f"{family}_attention_forward")(
        q, k, eye.bfloat16(), bias, 0.125, ATTN_DROPOUT, seed, True)
    dv = getattr(A, f"{family}_attention_backward")(
        q, k, eye.bfloat16(), bias, eye, out, stats, seed, 0.125, ATTN_DROPOUT)[2]
    torch.cuda.synchronize()
    row = {"phase": "kernel", "name": "dropout_keep", "for": f"{family}_bf16", "b": b, "h": h,
           "tq": t, "tk": t, "rate": ATTN_DROPOUT,
           "forward_differing": int(((out != 0) != want).sum()),
           "backward_differing": int(((dv.transpose(-1, -2) != 0) != want).sum())}
    row["differing"] = row["max_abs_err"] = row["forward_differing"] + row["backward_differing"]
    emit(row)
    if row["differing"] != 0:
        raise AssertionError(f"the bf16 {family} kernels' keep bits differ: {row}")
    return row


def phase_kernel_train_bf16():
    """B3-bf16 and B5-bf16 in their training form and B4-bf16, B6-bf16 against
    their plain bf16 versions at the kernel train route's shapes (bf16 q/k/v,
    an fp32 g), at dropout 0 and 0.1; the bf16 kernels' own keep bits."""
    from streamspeech_tpu_torch.kernels import attention as A
    from streamspeech_tpu_torch.ops.masks import NEG_INF

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED + 15)
    rows = {k: [] for k in ("masked_attention_bf16_train", "masked_attention_bwd_bf16",
                            "bias_attention_bf16_train", "bias_attention_bwd_bf16")}

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    for n, (b, t_pad, t) in enumerate(MASKED_TRAIN_SHAPES):
        q, k, v = (randn(b, 8, t_pad, 64).bfloat16() for _ in range(3))
        g = randn(b, 8, t_pad, 64)
        kvb = torch.where(torch.arange(t_pad) < t, 0.0, NEG_INF)
        kvb = kvb.to(torch.float32).view(1, 1, t_pad).expand(b, 1, t_pad).contiguous().to(dev)
        i = torch.arange(t_pad, device=dev)
        mask = (kvb[:, :, None, :] + torch.where(i[:, None] >= i[None, :], 0.0,
                                                 NEG_INF).float()).bfloat16()
        pairs = b * 8 * (t_pad * (t_pad + 1) / 2) * 64
        stats_bytes = b * 8 * t_pad * 8
        fwd, bwd = _check_train_kernel_bf16(
            "masked", A, q, k, v, kvb, g, 0.125, mask if n == 0 else None,
            _bound_bf16(4 * pairs, _nbytes(q, k, v, kvb) + 4 * q.numel() + stats_bytes + 8),
            # dq, dK, dV: 5 products; q, K, V, the key bias, g, the statistics
            # read, the bf16 gradients written
            _bound_bf16(10 * pairs, _nbytes(q, k, v, kvb, g, q, k, v) + stats_bytes + 8),
            timed=n == 0, b=b, h=8, t_pad=t_pad, t=t, d=64)
        rows["masked_attention_bf16_train"] += fwd
        rows["masked_attention_bwd_bf16"] += bwd
        del mask

    for n, (b, tq, tk_valid) in enumerate(BIAS_TRAIN_SHAPES):
        q, k, v, g, bias = _bias_train_inputs(b, tq, tk_valid, randn, pad_keys=True)
        q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
        tk = k.shape[2]
        pairs = b * 8 * tq * tk * 64
        stats_bytes = b * 8 * tq * 8
        fwd, bwd = _check_train_kernel_bf16(
            "bias", A, q, k, v, bias, g, 0.125, bias[:, None].bfloat16() if n == 0 else None,
            _bound_bf16(4 * pairs, _nbytes(q, k, v, bias) + 4 * q.numel() + stats_bytes + 8),
            _bound_bf16(10 * pairs, _nbytes(q, k, v, bias, g, q, k, v) + stats_bytes + 8),
            timed=n == 0, b=b, h=8, tq=tq, tk=tk, tk_valid=tk_valid, d=64)
        rows["bias_attention_bf16_train"] += fwd
        rows["bias_attention_bwd_bf16"] += bwd
    rows["dropout_keep_bf16"] = [_keep_bits_bf16(A, f, dev) for f in ("masked", "bias")]
    return rows


def _dicts(text_vocab: int, code_size: int):
    from streamspeech_tpu_torch.dictionary import Dictionary

    text = Dictionary()
    for i in range(text_vocab - 4):
        text.add_symbol("▁w" + str(i))
    units = Dictionary.units(code_size)
    units.add_blank()
    return text, units


def _build_agent(cfg, voc_cfg, device, seed, dtype=torch.float32, **engine_sizes):
    from streamspeech_tpu_torch.agents.streamspeech import (
        StreamSpeechAgentConfig,
        StreamSpeechS2STAgent,
    )
    from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
    from streamspeech_tpu_torch.models.vocoder import CodeGenerator
    from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine
    from streamspeech_tpu_torch.weights import doctor_params, random_init_

    model = doctor_params(random_init_(StreamSpeechModel(cfg, dtype=dtype), seed))
    vocoder = random_init_(CodeGenerator(voc_cfg), seed + 1)
    engine = StreamSpeechEngine(model, vocoder, device=device, **engine_sizes)
    text, units = _dicts(cfg.mt_decoder.vocab_size, voc_cfg["num_embeddings"])
    return StreamSpeechS2STAgent(engine, StreamSpeechAgentConfig(), text, text, units)


def _babble(rng, seconds: float) -> np.ndarray:
    """Speech-like synthetic audio at 16 kHz: 80-250 ms syllables, each a
    Hann-windowed harmonic tone (random f0 and gain) plus noise. Unlike
    stationary noise it changes from frame to frame, so the CTC hypotheses
    grow and the agent writes while the source is still streaming."""
    n = int(seconds * 16000)
    out = np.zeros(n, np.float32)
    t = 0
    while t < n:
        length = min(rng.randint(1280, 4000), n - t)
        f0, tt = rng.uniform(90, 300), np.arange(length) / 16000
        sig = sum(rng.uniform(0, 1) / h * np.sin(2 * np.pi * f0 * h * tt
                                                 + rng.uniform(0, 2 * np.pi))
                  for h in range(1, 8)) + rng.uniform(0, 0.5) * rng.randn(length)
        out[t:t + length] = (rng.uniform(0.02, 0.4) * np.hanning(length) * sig
                             / (np.abs(sig).max() + 1e-6))
        t += length
    return out


def _run_utterance(agent, samples):
    from streamspeech_tpu_torch.agents.base import stream_utterance

    wav, turns, write_turns, delays = [], 0, [], []
    t0 = time.perf_counter()
    for out in stream_utterance(agent, samples):
        turns += 1
        if not out.is_empty:
            write_turns.append(turns)
            # the evaluator's delay: the write's decision position, else the
            # source sent so far (``eval/instance.py`` ``_decision_ms``)
            delays.append(out.decision_ms if out.decision_ms is not None
                          else len(agent.states.source) / 16.0)
            wav.extend(out.content)
    if agent.engine.device.type == "cuda":
        torch.cuda.synchronize()
    return {"segments": turns, "writes": len(write_turns), "write_turns": write_turns,
            "delays": delays, "text_tokens": len(agent.session.mt_tokens),
            "units": len(agent.units), "wav_samples": len(wav),
            "wall_s": time.perf_counter() - t0}, np.asarray(wav, np.float32), \
        list(agent.session.mt_tokens), list(agent.units)


def _kernel_counters() -> dict:
    """Each kernel's (wrapper, counter attribute): a bf16 form is counted on
    its wrapper apart from the fp32 one."""
    from streamspeech_tpu_torch.kernels import attention, ctc, policy
    from streamspeech_tpu_torch.runtime import graphs

    return {"masked_attention": (attention.masked_attention, "launches"),
            "relpos_attention": (attention.relpos_attention, "launches"),
            "bias_attention": (attention.bias_attention, "launches"),
            "not_blank_probs": (policy.not_blank_probs, "launches"),
            "ctc_alpha": (ctc.ctc_alpha, "launches"),
            "ctc_beta": (ctc.ctc_beta_grad, "launches"),
            "relpos_attention_bwd": (attention.relpos_attention_backward, "launches"),
            "masked_attention_bwd": (attention.masked_attention_backward, "launches"),
            "bias_attention_bwd": (attention.bias_attention_backward, "launches"),
            "dropout_keep": (attention.dropout_keep, "launches"),
            "masked_attention_bf16": (attention.masked_attention, "bf16_launches"),
            "bias_attention_bf16": (attention.bias_attention, "bf16_launches"),
            "not_blank_probs_bf16": (policy.not_blank_probs, "bf16_launches"),
            "masked_attention_bwd_bf16": (attention.masked_attention_backward,
                                          "bf16_launches"),
            "bias_attention_bwd_bf16": (attention.bias_attention_backward, "bf16_launches"),
            "graph_cond": (graphs.cond, "launches")}


def _zero_counts():
    from streamspeech_tpu_torch.kernels import attention

    for fn, attr in _kernel_counters().values():
        setattr(fn, attr, 0)
    attention.mask_draws = 0


def _read_counts() -> dict:
    """Each kernel's launches, and ``mask_draws``: the attention launches
    that drew the dropout mask inside their own kernels."""
    from streamspeech_tpu_torch.kernels import attention

    return {**{name: getattr(fn, attr) for name, (fn, attr) in _kernel_counters().items()},
            "mask_draws": attention.mask_draws}


def _edit_distance(a, b) -> int:
    row = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, y in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1, prev + (x != y))
    return row[-1]


def phase_serving(dtype=torch.float32, fp32_runs=None):
    """Three utterances through the agent at ``full_config``; with a bf16
    model, each utterance also against its fp32 run (``fp32_runs``): the
    counterpart of ``measure_bf16_drift``, reported, not gated. Returns the
    launches and each utterance's (units, write turns)."""
    from streamspeech_tpu_torch.config import full_config
    from streamspeech_tpu_torch.models.vocoder import DEFAULT_VOCODER_CFG

    name = "serving" if dtype == torch.float32 else "serving_bf16"
    agent = _build_agent(full_config(), DEFAULT_VOCODER_CFG, "cuda", SEED, dtype)
    rng = np.random.RandomState(SEED)
    _zero_counts()
    runs, outputs = [], []
    for n, seconds in enumerate(UTTERANCE_SECONDS):
        stats, wav, tokens, units = _run_utterance(agent, _babble(rng, seconds))
        outputs.append((stats["write_turns"], tokens, units, wav))
        stats = {"phase": name, "seconds_audio": seconds, **stats,
                 "rtf": stats["wall_s"] / seconds}
        if fp32_runs is not None:
            units32, turns32 = fp32_runs[n]
            stats["unit_edit_distance_vs_fp32"] = (_edit_distance(units, units32)
                                                   / max(len(units32), 1))
            stats["write_turns_differing_vs_fp32"] = len(
                set(stats["write_turns"]) ^ set(turns32))
        emit(stats)
        runs.append((units, stats["write_turns"]))
        if stats["units"] < 1 or wav.size == 0:
            raise AssertionError(f"{seconds} s utterance wrote no units or no wav")
        if not np.isfinite(wav).all():
            raise AssertionError(f"{seconds} s utterance wrote non-finite wav")
    launches = _read_counts()
    emit({"phase": f"{name}_total", "launches": launches})
    causal = "masked_attention" if dtype == torch.float32 else "masked_attention_bf16"
    if launches[causal] < 1:
        raise AssertionError(f"{name} never launched the {causal} kernel")
    if dtype != torch.float32 and (launches["masked_attention"] or launches["bias_attention"]
                                   or launches["not_blank_probs"]):
        raise AssertionError(f"{name} launched an fp32 attention or not-blank kernel")
    return launches, runs, agent, outputs


def _trace_events(prof) -> list:
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return json.loads(path.read_text())["traceEvents"]


def _trace_summary(prof):
    """The card's busy ms in a profiled run: the summed duration of its
    kernels, copies and sets, read from the exported trace (one stream, so
    none overlap); and the CUDA API launches by call (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ...: a graph replay is one). ``key_averages`` would
    take about a minute over the wave's ~400,000 events; the export and a
    JSON parse take seconds."""
    events = _trace_events(prof)
    busy = sum(e.get("dur", 0) for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e3
    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "Launch" in e.get("name", ""):
            launches[e["name"]] = launches.get(e["name"], 0) + 1
    return busy, launches


def _instance_scores(evaluator, index) -> dict:
    """Every latency scorer of ``evaluator`` on its instance ``index`` alone."""
    ins = {index: evaluator.instances[index]}
    return {name: scorer(ins) for name, scorer in evaluator.latency_scorers.items()}


def phase_serving_batched(agent):
    """Phase 4's engine, vocoder and dictionaries serve ``BATCHED_SECONDS`` (8
    utterances, the first three phase 4's) as one wave of
    ``BatchedS2STEvaluator(batch=8)``, and each utterance alone through the
    sequential evaluator over phase 4's agent; every instance must have the
    same delays, MT tokens and units and its stitched wav within
    ``REFERENCE_WAV_ATOL``, and the wave must launch B3 at batch 8. A first
    wave warms its shapes; the counted wave is timed after it, and a third
    runs under ``torch.profiler`` for the card's busy time, given as a share
    of its own (profiled) wall and of the counted wave's. Returns the counted
    wave's launches and its row."""
    from streamspeech_tpu_torch.eval.batched_evaluator import BatchedS2STEvaluator
    from streamspeech_tpu_torch.eval.evaluator import SentenceLevelEvaluator
    from streamspeech_tpu_torch.kernels.attention import masked_attention

    rng = np.random.RandomState(SEED)
    sources = [_babble(rng, seconds).tolist() for seconds in BATCHED_SECONDS]
    refs = [None] * len(sources)    # no reference text: lengths from the delays
    seg_ms = agent.cfg.source_segment_size
    seq = SentenceLevelEvaluator(agent, source_segment_size=seg_ms, quality_metrics=[])
    singles = []
    for i, src in enumerate(sources):
        ins = seq._make_instance(i, src, None, 16000)
        t0 = time.perf_counter()
        seq.run_instance(ins)
        torch.cuda.synchronize()
        seq.instances[i] = ins
        singles.append((list(agent.session.mt_tokens), list(agent.units),
                        time.perf_counter() - t0))

    def wave():
        ev = BatchedS2STEvaluator(agent.engine, agent.cfg, agent.src_dict, agent.tgt_dict,
                                  agent.unit_dict, batch=len(sources), use_fused=False,
                                  quality_metrics=[])
        t0 = time.perf_counter()
        scores = ev(sources, refs)
        torch.cuda.synchronize()
        return ev, scores, time.perf_counter() - t0

    wave()
    _zero_counts()
    masked_attention.launches_by_batch = {}
    ev, scores, wall = wave()
    launches = _read_counts()
    by_batch = dict(masked_attention.launches_by_batch)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, _, profiled_wall = wave()
    busy_ms, _ = _trace_summary(prof)

    bad = []
    for i, seconds in enumerate(BATCHED_SECONDS):
        got, want = ev.instances[i], seq.instances[i]
        tokens, units, _ = singles[i]
        row = {"phase": "serving_batched_instance", "index": i, "seconds_audio": seconds,
               "writes": len(got.delays), "text_tokens": len(got.final_mt_tokens),
               "units": len(got.final_units),
               **_same_instance(got, (want.delays, tokens, units, want.stitched)),
               "atol": REFERENCE_WAV_ATOL, "single_wall_s": singles[i][2],
               "latency": _instance_scores(ev, i)}
        emit(row)
        if not all(row[k] for k in SAME_INSTANCE):
            bad.append(i)
    audio = sum(BATCHED_SECONDS)
    single_wall = sum(w for _, _, w in singles)
    row = {"phase": "serving_batched", "streams": len(sources), "seconds_audio": audio,
           "wave_wall_s": wall, "singles_wall_s": single_wall,
           "audio_s_per_wall_s": audio / wall,
           "singles_audio_s_per_wall_s": audio / single_wall,
           "launches": launches, "masked_attention_launches_by_batch": by_batch,
           "profiled_wave_wall_s": profiled_wall, "profiled_device_busy_ms": busy_ms,
           "busy_share_of_profiled_wall": busy_ms / 1e3 / profiled_wall,
           "busy_share_of_wall": busy_ms / 1e3 / wall, "scores": scores,
           "instances_differing": bad}
    emit(row)
    if bad:
        raise AssertionError(f"batched instances {bad} differ from their single runs")
    if launches["masked_attention"] < 1 or by_batch.get(len(sources), 0) < 1:
        raise AssertionError(f"the wave never launched B3 at batch {len(sources)}: "
                             f"{by_batch}")
    if sum(len(ins.final_units) for ins in ev.instances.values()) < 1:
        raise AssertionError("the wave wrote no units")
    return launches, row, {i: (ins.delays, singles[i][0], singles[i][1], ins.stitched)
                           for i, ins in seq.instances.items()}


SAME_INSTANCE = ("same_delays", "same_tokens", "same_units", "same_wav")


def _same_instance(got, want) -> dict:
    """How an instance of a wave compares with its reference run (delays, MT
    tokens, units, stitched wav): each check and the wav's max abs error."""
    delays, tokens, units, wav = want
    same_wav = (got.stitched is None) == (wav is None)
    err = None
    if same_wav and wav is not None:
        same_wav = got.stitched.shape == wav.shape
        err = float(np.abs(got.stitched - wav).max()) if same_wav else None
        same_wav = same_wav and err <= REFERENCE_WAV_ATOL
    return {"same_delays": got.delays == delays, "same_tokens": got.final_mt_tokens == tokens,
            "same_units": got.final_units == units, "same_wav": same_wav,
            "wav_max_abs_err": err}


def phase_serving_fused(agent, outputs):
    """Phase 4's agent and utterances on the fused path (``agent.use_fused``)
    after ``engine.warmup`` has captured the B = 1 graphs: each utterance's
    write turns, MT tokens and units equal to phase 4's, its wav within
    ``REFERENCE_WAV_ATOL``; B3 launched inside the replayed graphs (a count
    is the launches a graph holds times its replays). Then the 10 s
    utterance again under ``torch.profiler``: device ms, busy share and the
    CUDA API launches (a graph replay one). Returns the launches and each
    utterance's (delays, MT tokens, units, wav)."""
    engine, cfg = agent.engine, agent.cfg
    t0 = time.perf_counter()
    warm = engine.warmup(cfg.chunk_size, cfg.conv_chunk_size, batch_sizes=(1,))
    emit({"phase": "serving_fused_warmup", "batch_sizes": [1],
          "seconds": time.perf_counter() - t0, **warm})
    agent.use_fused = True
    rng = np.random.RandomState(SEED)
    _zero_counts()
    replays0 = engine.graphs.replays
    bad, wall, last, fused_outputs = [], 0.0, None, []
    for n, seconds in enumerate(UTTERANCE_SECONDS):
        last = _babble(rng, seconds)
        stats, wav, tokens, units = _run_utterance(agent, last)
        fused_outputs.append((stats["delays"], tokens, units, wav))
        turns, tokens0, units0, wav0 = outputs[n]
        same_shape = wav.shape == wav0.shape
        err = (float(np.abs(wav - wav0).max()) if wav.size else 0.0) if same_shape else None
        same = (stats["write_turns"] == turns and tokens == tokens0 and units == units0
                and same_shape and err <= REFERENCE_WAV_ATOL)
        wall += stats["wall_s"]
        emit({"phase": "serving_fused", "seconds_audio": seconds, **stats,
              "rtf": stats["wall_s"] / seconds, "same_write_turns": stats["write_turns"] == turns,
              "same_tokens": tokens == tokens0, "same_units": units == units0,
              "wav_max_abs_err": err, "atol": REFERENCE_WAV_ATOL})
        if not same:
            bad.append(seconds)
    launches = _read_counts()
    replays = engine.graphs.replays - replays0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        stats, *_ = _run_utterance(agent, last)
    busy_ms, api = _trace_summary(prof)
    agent.use_fused = False
    emit({"phase": "serving_fused_total", "utterances_s": list(UTTERANCE_SECONDS),
          "wall_s": wall, "launches": launches, "graph_replays": replays,
          **engine.graphs.stats(), "profiled_utterance_s": UTTERANCE_SECONDS[-1],
          "profiled_wall_s": stats["wall_s"], "profiled_device_busy_ms": busy_ms,
          "busy_share_of_profiled_wall": busy_ms / 1e3 / stats["wall_s"],
          "cuda_api_launches": api, "cuda_api_launches_total": sum(api.values()),
          "utterances_differing": bad})
    if bad:
        raise AssertionError(f"fused utterances {bad} differ from the host path's")
    if launches["masked_attention"] < 1 or replays < 1:
        raise AssertionError("the fused path replayed no graph or never launched B3")
    return launches, fused_outputs


def _check_graph_cond() -> dict:
    """The set-conditional kernel (``csrc/graph_cond.cu``) at the overlapped
    tick's predicate, one bool on the card: a graph of one ``cond`` whose
    body (a tanh of 4096 floats) must equal the eager body where the
    predicate holds and leave the skip value where it does not. ms: a
    replay with the predicate false (the setter kernel and the IF node);
    plain: the eager ``cond`` (the host reads the predicate); bound: the
    one byte read."""
    from streamspeech_tpu_torch.runtime import graphs

    dev = torch.device("cuda")
    x = torch.randn(4096, device=dev)
    out = torch.zeros_like(x)
    pred = torch.zeros((), dtype=torch.bool, device=dev)

    def part():
        graphs.cond(pred, lambda: out.copy_(torch.tanh(x) * 2))

    for value in (True, False):
        pred.fill_(value)
        part()                           # warm, eagerly
    torch.cuda.synchronize()
    with graphs._Capture(torch.cuda.graph_pool_handle(), torch.cuda.Stream(dev)) as cap:
        part()
    composed = graphs._Composed(cap.segments, dev)
    err = 0.0
    for value in (True, False, True):
        out.fill_(-1.0)
        pred.fill_(value)
        composed.replay()
        want = torch.tanh(x) * 2 if value else torch.full_like(x, -1.0)
        torch.cuda.synchronize()
        err = max(err, float((out - want).abs().max()))
    pred.fill_(False)
    row = {"pred": "[] bool", "body_elements": x.numel(), "max_abs_err": err,
           "ms": _time_ms(composed.replay), "plain_ms": _time_ms(part),
           **_bound(0.0, 1.0), "library_ms": None, "if_nodes": composed.if_nodes}
    emit({"phase": "kernel", "kernel": "graph_cond", **row})
    if err != 0.0 or composed.if_nodes != 1:
        raise AssertionError(f"graph_cond: {row}")
    return row


# the CUDA API calls after which the host has waited for the card
BLOCKING_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize",
                  "cudaMemcpy")


def _ranged(obj, name: str, label: str) -> None:
    """Wrap ``obj.name`` (an instance attribute shadowing the method, removed
    with ``delattr``) in a ``torch.profiler.record_function`` range."""
    fn = getattr(obj, name)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    setattr(obj, name, wrapped)


def _pipe_waits(events) -> dict:
    """The host's blocking CUDA API calls in a profiled overlapped run, by
    where they fell: anywhere; inside any fetch (``pipe_fetch``: the fetched
    chunk's copy had not landed; the finish's drain included); inside a
    dispatch (``pipe_dispatch`` ranges); between two consecutive dispatches
    with no host-path chunk between them, inside a fetch or elsewhere; and in
    gaps that hold a host-path chunk (a fallback, a drain). Each call counted
    by name."""
    def spans(label):
        return sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events
                      if e.get("cat") == "user_annotation" and e.get("name") == label)

    dispatches, fetches, host = spans("pipe_dispatch"), spans("pipe_fetch"), spans("host_path")
    calls = [(e["ts"], e["name"]) for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("name") in BLOCKING_CALLS]

    def inside(ts, ranges):
        return any(a <= ts <= b for a, b in ranges)

    out = {"dispatches": len(dispatches), "fetches": len(fetches), "anywhere": {},
           "in_any_fetch": {}, "in_dispatch": {}, "between_in_fetch": {},
           "between_elsewhere": {}, "host_path_gaps": 0, "in_host_path_gaps": {}}

    def add(where, name):
        out[where][name] = out[where].get(name, 0) + 1

    for ts, name in calls:
        add("anywhere", name)
        if inside(ts, fetches):
            add("in_any_fetch", name)
        if inside(ts, dispatches):
            add("in_dispatch", name)
    for (_, end), (start, _) in zip(dispatches, dispatches[1:]):
        gap = [(ts, name) for ts, name in calls if end < ts < start]
        if any(end < a < start for a, _ in host):
            out["host_path_gaps"] += 1
            for _, name in gap:
                add("in_host_path_gaps", name)
            continue
        for ts, name in gap:
            add("between_in_fetch" if inside(ts, fetches) else "between_elsewhere", name)
    return out


def phase_serving_pipelined(agent, reference):
    """Phase 4's agent and utterances on the overlapped loop
    (``StreamSpeechAgentConfig.pipelined``) after ``engine.warmup(pipelined=
    True)`` captured its graphs (one a chunk a MT bucket, its two conds IF
    nodes; the host decode), at ``pipe_max_lag`` 8 with the age rule off
    (``pipe_ready_s`` 3600: the deepest pipeline) and at the defaults: each
    utterance's delays, MT tokens and units equal to phase 4b's, its wav
    within ``REFERENCE_WAV_ATOL``. Per utterance: wall, dispatches, fetches,
    fetches that waited, the deepest count in flight. B3 is counted from the
    fetched flags (the emission's IF body ran). Then the 10 s utterance at
    the deepest setting under ``torch.profiler`` (host and card): CUDA API
    launches, device busy share, and the blocking CUDA API calls by where they
    fell (``_pipe_waits``): none may fall inside a dispatch or between two
    consecutive dispatches outside a fetch. Returns the deepest setting's
    launches."""
    import dataclasses

    engine, cfg0 = agent.engine, agent.cfg
    captured0 = engine.graphs.captured
    t0 = time.perf_counter()
    warm = engine.warmup(cfg0.chunk_size, cfg0.conv_chunk_size, pipelined=True)
    emit({"phase": "serving_pipelined_warmup", "seconds": time.perf_counter() - t0,
          "graphs_captured_here": engine.graphs.captured - captured0, **warm})
    if warm["if_nodes"] < 2 * len(engine.mt_buckets):
        raise AssertionError(f"the overlapped graphs hold {warm['if_nodes']} IF nodes")
    rng = np.random.RandomState(SEED)
    audio = [_babble(rng, seconds) for seconds in UTTERANCE_SECONDS]
    settings = {"deepest": dict(pipe_max_lag=8, pipe_ready_s=3600.0), "defaults": {}}
    bad, launches = [], None
    for name, knobs in settings.items():
        agent.cfg = dataclasses.replace(cfg0, pipelined=True, **knobs)
        _zero_counts()
        replays0 = dict(engine.graphs.replays_by_part)
        wall, deepest, dispatched = 0.0, 0, 0
        for n, seconds in enumerate(UTTERANCE_SECONDS):
            stats, wav, tokens, units = _run_utterance(agent, audio[n])
            pipe = dict(agent.session.pipe_stats)
            delays0, tokens0, units0, wav0 = reference[n]
            same_shape = wav.shape == wav0.shape
            err = (float(np.abs(wav - wav0).max()) if wav.size else 0.0) if same_shape else None
            same = {"same_delays": stats["delays"] == delays0, "same_tokens": tokens == tokens0,
                    "same_units": units == units0,
                    "same_wav": same_shape and err <= REFERENCE_WAV_ATOL}
            wall += stats["wall_s"]
            deepest, dispatched = max(deepest, pipe["deepest"]), dispatched + pipe["dispatches"]
            emit({"phase": "serving_pipelined", "setting": name,
                  "pipe_max_lag": agent.cfg.pipe_max_lag, "pipe_ready_s": agent.cfg.pipe_ready_s,
                  "seconds_audio": seconds, **stats, "rtf": stats["wall_s"] / seconds,
                  "pipe": pipe, "waited_fetches_per_chunk": pipe["waited_fetches"]
                  / max(pipe["fetches"], 1), **same, "wav_max_abs_err": err,
                  "atol": REFERENCE_WAV_ATOL})
            if not all(same.values()):
                bad.append((name, seconds))
        counts = _read_counts()
        replays = {k: v - replays0.get(k, 0) for k, v in engine.graphs.replays_by_part.items()
                   if v != replays0.get(k, 0)}
        emit({"phase": "serving_pipelined_total", "setting": name, "wall_s": wall,
              "launches": counts, "graph_replays_by_part": replays, "deepest_in_flight": deepest,
              "dispatches": dispatched})
        if launches is None:
            launches = counts
            if dispatched < 1 or deepest < 2:
                raise AssertionError(f"the deepest setting overlapped nothing: {dispatched} "
                                     f"dispatches, {deepest} in flight at most")
            if counts["masked_attention"] < 1:
                raise AssertionError("serving_pipelined never launched B3")
    agent.cfg = dataclasses.replace(cfg0, pipelined=True, **settings["deepest"])
    _ranged(engine, "policy_step_pipelined", "pipe_dispatch")
    _ranged(engine, "pipe_fetch", "pipe_fetch")
    for method in ("_host_policy", "_decode_and_emit", "_emit_from_host"):
        _ranged(agent, method, "host_path")
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            stats, *_ = _run_utterance(agent, audio[-1])
        pipe = dict(agent.session.pipe_stats)
    finally:
        for obj, method in ((engine, "policy_step_pipelined"), (engine, "pipe_fetch"),
                            (agent, "_host_policy"), (agent, "_decode_and_emit"),
                            (agent, "_emit_from_host")):
            delattr(obj, method)
        agent.cfg = cfg0
    events = _trace_events(prof)
    busy_ms = sum(e.get("dur", 0) for e in events
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e3
    api = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "Launch" in e.get("name", ""):
            api[e["name"]] = api.get(e["name"], 0) + 1
    waits = _pipe_waits(events)
    emit({"phase": "serving_pipelined_profiled", "seconds_audio": UTTERANCE_SECONDS[-1],
          "wall_s": stats["wall_s"], "device_busy_ms": busy_ms,
          "busy_share_of_wall": busy_ms / 1e3 / stats["wall_s"], "cuda_api_launches": api,
          "cuda_api_launches_total": sum(api.values()), "pipe": pipe,
          "blocking_waits": waits,
          "blocking_waits_per_chunk": {k: sum(waits[k].values()) / max(pipe["dispatches"], 1)
                                       for k in ("in_dispatch", "between_in_fetch",
                                                 "between_elsewhere")},
          **engine.graphs.stats(), "utterances_differing": bad})
    if bad:
        raise AssertionError(f"pipelined utterances {bad} differ from the fused path's")
    if waits["in_dispatch"] or waits["between_elsewhere"]:
        raise AssertionError(f"the host waited for the card between two dispatches: {waits}")
    if waits["dispatches"] != pipe["dispatches"]:
        raise AssertionError(f"the trace holds {waits['dispatches']} dispatch ranges of "
                             f"{pipe['dispatches']}")
    return launches


def phase_serving_batched_fused(agent, reference=None):
    """Phase 5b's wave of 8 through ``BatchedS2STEvaluator(use_fused=True)``
    after ``engine.warmup`` has captured the B = 8 graphs, every instance
    held to ``reference`` (phase 5b's single runs) as phase 5b holds its
    wave; without one (the bf16 agent), to the same engine's host wave, run
    here first. The timed wave (warm: the graphs were captured by the
    warmup, the host path's shapes by the host waves before it), then one
    under ``torch.profiler``: wall, device ms, busy share, CUDA API launches,
    the graphs' numbers. Returns the timed wave's launches."""
    from streamspeech_tpu_torch.eval.batched_evaluator import BatchedS2STEvaluator

    engine, cfg = agent.engine, agent.cfg
    bf16 = engine.model.dtype == torch.bfloat16
    name = "serving_bf16_batched_fused" if bf16 else "serving_batched_fused"
    causal = "masked_attention_bf16" if bf16 else "masked_attention"
    rng = np.random.RandomState(SEED)
    sources = [_babble(rng, seconds).tolist() for seconds in BATCHED_SECONDS]
    refs = [None] * len(sources)

    def wave(use_fused):
        ev = BatchedS2STEvaluator(engine, cfg, agent.src_dict, agent.tgt_dict,
                                  agent.unit_dict, batch=len(sources), use_fused=use_fused,
                                  quality_metrics=[])
        t0 = time.perf_counter()
        ev(sources, refs)
        torch.cuda.synchronize()
        return ev, time.perf_counter() - t0

    t0 = time.perf_counter()
    warm = engine.warmup(cfg.chunk_size, cfg.conv_chunk_size, batch_sizes=(len(sources),))
    warm_s = time.perf_counter() - t0
    host_wall = None
    if reference is None:
        host, host_wall = wave(False)
        reference = {i: (ins.delays, ins.final_mt_tokens, ins.final_units, ins.stitched)
                     for i, ins in host.instances.items()}
    _zero_counts()
    replays0, captured0 = engine.graphs.replays, engine.graphs.captured
    ev, wall = wave(True)
    launches = _read_counts()
    replays = engine.graphs.replays - replays0
    captured = engine.graphs.captured - captured0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, profiled_wall = wave(True)
    busy_ms, api = _trace_summary(prof)
    bad = []
    for i, seconds in enumerate(BATCHED_SECONDS):
        got = ev.instances[i]
        row = {"phase": f"{name}_instance", "index": i, "seconds_audio": seconds,
               "writes": len(got.delays), "text_tokens": len(got.final_mt_tokens),
               "units": len(got.final_units), **_same_instance(got, reference[i]),
               "atol": REFERENCE_WAV_ATOL}
        emit(row)
        if not all(row[k] for k in SAME_INSTANCE):
            bad.append(i)
    audio = sum(BATCHED_SECONDS)
    emit({"phase": name, "streams": len(sources), "seconds_audio": audio,
          "warmup_s": warm_s, "warmup": warm, "host_wave_wall_s": host_wall,
          "wave_wall_s": wall, "audio_s_per_wall_s": audio / wall,
          "launches": launches, "graph_replays": replays,
          "graphs_captured_in_wave": captured, **engine.graphs.stats(),
          "profiled_wave_wall_s": profiled_wall, "profiled_device_busy_ms": busy_ms,
          "busy_share_of_profiled_wall": busy_ms / 1e3 / profiled_wall,
          "busy_share_of_wall": busy_ms / 1e3 / wall,
          "cuda_api_launches": api, "cuda_api_launches_total": sum(api.values()),
          "instances_differing": bad})
    if bad:
        raise AssertionError(f"{name}: instances {bad} differ from their reference runs")
    if launches[causal] < 1 or replays < 1:
        raise AssertionError(f"{name} replayed no graph or never launched {causal}")
    return launches


def phase_reference():
    """The same model on the card (kernel route: T = 16*25 or 32*25, H=8,
    D=64) and on the CPU (plain version) over the same audio: ``full_config``
    widths with the encoder cut to 2 layers and a narrow vocoder, so that the
    CPU run takes seconds."""
    from streamspeech_tpu_torch.config import full_config
    from streamspeech_tpu_torch.models.vocoder import DEFAULT_VOCODER_CFG

    cfg = full_config()
    cfg.encoder.layers = 2
    voc_cfg = dict(DEFAULT_VOCODER_CFG, upsample_initial_channel=32)
    sizes = dict(max_enc_frames=128, max_mt_tokens=32, mt_buckets=(16, 32),
                 unit_buckets=(128, 256, 512, 1024))
    samples = _babble(np.random.RandomState(SEED + 1), 2.0)
    outs = {}
    for device in ("cuda", "cpu"):
        agent = _build_agent(cfg, voc_cfg, device, SEED + 2, **sizes)
        outs[device] = _run_utterance(agent, samples)
    (_, wav_g, tok_g, units_g), (stats_c, wav_c, tok_c, units_c) = outs["cuda"], outs["cpu"]
    err = float(np.abs(wav_g - wav_c).max()) if wav_g.shape == wav_c.shape else None
    row = {"phase": "reference", "writes": stats_c["writes"],
           "text_tokens": len(tok_c), "units": len(units_c),
           "wav_samples": int(wav_c.size), "same_tokens": tok_g == tok_c,
           "same_units": units_g == units_c, "wav_max_abs_err": err, "atol": REFERENCE_WAV_ATOL}
    emit(row)
    if not (row["same_tokens"] and row["same_units"] and err is not None
            and err <= REFERENCE_WAV_ATOL and len(units_c) > 0):
        raise AssertionError(f"card and CPU runs disagree: {row}")


# no backward, no bf16 form and no IF node of the overlapped serving tick
_NO_BACKWARD = {"relpos_attention_bwd": 0, "masked_attention_bwd": 0,
                "bias_attention_bwd": 0, "dropout_keep": 0, "mask_draws": 0,
                "masked_attention_bf16": 0, "bias_attention_bf16": 0,
                "not_blank_probs_bf16": 0, "masked_attention_bwd_bf16": 0,
                "bias_attention_bwd_bf16": 0, "graph_cond": 0}
FORWARD_LAUNCHES = {"relpos_attention": 12, "bias_attention": 2,
                    "not_blank_probs": 2, "masked_attention": 2, "ctc_alpha": 0,
                    "ctc_beta": 0, **_NO_BACKWARD}
# one bf16 forward: the bf16 forms of B3, B5 and B7; rel-pos attention in fp32
FORWARD_BF16_LAUNCHES = {**FORWARD_LAUNCHES, "masked_attention": 0, "bias_attention": 0,
                         "not_blank_probs": 0, "masked_attention_bf16": 2,
                         "bias_attention_bf16": 2, "not_blank_probs_bf16": 2}
# one train step on the default route: attention takes its plain version; the
# unit CTC and the fused aux pair each launch B8 and B9
TRAIN_LAUNCHES = {"relpos_attention": 0, "bias_attention": 0, "not_blank_probs": 2,
                  "masked_attention": 0, "ctc_alpha": 2, "ctc_beta": 2, **_NO_BACKWARD}
# one train step on the kernel route: 12 encoder layers (rel-pos), the unit
# decoder's 2 layers (causal self-attention, bias cross-attention), each with
# one forward launch and one backward call, all 32 drawing the dropout mask in
# their own kernels (the kernel that writes the mask out alone runs on no path)
TRAIN_KERNEL_LAUNCHES = {**TRAIN_LAUNCHES, "relpos_attention": 12, "masked_attention": 2,
                         "bias_attention": 2, "relpos_attention_bwd": 12,
                         "masked_attention_bwd": 2, "bias_attention_bwd": 2,
                         "mask_draws": 32}


# one bf16 train step on the default route: B7 on bf16 logits, B8 and B9 on
# the widened ones; on the kernel route also the bf16 training forms and
# backwards of B3 and B5 and fp32 B1/B2 (the rel-pos route casts to fp32)
TRAIN_BF16_LAUNCHES = {**TRAIN_LAUNCHES, "not_blank_probs": 0, "not_blank_probs_bf16": 2}
TRAIN_BF16_KERNEL_LAUNCHES = {**TRAIN_BF16_LAUNCHES, "relpos_attention": 12,
                              "relpos_attention_bwd": 12, "masked_attention_bf16": 2,
                              "bias_attention_bf16": 2, "masked_attention_bwd_bf16": 2,
                              "bias_attention_bwd_bf16": 2, "mask_draws": 32}


def _forward_inputs(batch: int, lengths, mt_len: int, pad_after=None, seed=SEED):
    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.randn(batch, max(lengths), 80).astype(np.float32))
    mt = torch.from_numpy(rng.randint(4, 6000, size=(batch, mt_len)))
    mt[:, 0] = 2                                     # EOS-prefixed, fairseq style
    if pad_after is not None:
        mt[-1, pad_after:] = 1                       # PAD
    return src, torch.tensor(lengths), mt


def _streaming_mask(model, out, mt_len: int):
    """The CTC streaming mask the forward built from its own aux-head logits
    (`StreamSpeechModel.forward`, k1=0, n1=1, chunk 8)."""
    from streamspeech_tpu_torch.models.streamspeech import ctc_not_blank_probs
    from streamspeech_tpu_torch.ops.masks import streaming_allowed_from_ctc

    return streaming_allowed_from_ctc(ctc_not_blank_probs(out["asr_logits"]),
                                      ctc_not_blank_probs(out["st_logits"]),
                                      mt_len, 0, 1, 1, 8)


def phase_forward():
    """The offline forward at ``full_config``: card vs CPU at batch 2, kernel
    launches in one card forward, then its card time at B=1 and B=8."""
    from streamspeech_tpu_torch.config import full_config
    from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
    from streamspeech_tpu_torch.weights import doctor_params, random_init_

    kw = dict(chunk_size=8, conv_chunk_size=8, k1=0, n1=1, k2=0, n2=1,
              mt_mask_mode="ctc")
    model = doctor_params(random_init_(StreamSpeechModel(full_config()), SEED)).eval()
    src, lens, mt = _forward_inputs(2, [1024, 800], 24, pad_after=18)
    with torch.no_grad():
        ref = model(src, lens, mt, **kw)
        ref_mask = _streaming_mask(model, ref, 24)
        model.cuda()
        dev_args = (src.cuda(), lens.cuda(), mt.cuda())
        torch.cuda.synchronize()
        _zero_counts()
        out = model(*dev_args, **kw)
        torch.cuda.synchronize()
        launches = _read_counts()
        mask = _streaming_mask(model, out, 24).cpu()
    errs = {}
    for key, want in ref.items():
        got = out[key].cpu()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"forward output {key}: card {got.dtype} "
                                 f"{tuple(got.shape)} vs CPU {want.dtype} "
                                 f"{tuple(want.shape)}")
        if want.dtype == torch.float32:
            tol = FORWARD_RTOL * max(1.0, float(want.abs().max()))
            errs[key] = [float((got - want).abs().max()), tol]
        else:
            errs[key] = [int((got != want).sum()), 0]
    row = {"phase": "forward", "batch": 2, "fbank_lengths": [1024, 800],
           "mt_len": 24, "launches": launches, "expected_launches": FORWARD_LAUNCHES,
           "same_allowed_cross": bool(torch.equal(mask, ref_mask)),
           "allowed_cross_differing": int((mask != ref_mask).sum()),
           "allowed_cross_allowed_share": float(ref_mask.float().mean()),
           "max_abs_err_and_tol": errs,
           "finite": all(bool(torch.isfinite(v.float()).all()) for v in out.values())}
    emit(row)
    bad = [k for k, (e, tol) in errs.items() if not e <= tol]
    if bad or not row["same_allowed_cross"] or not row["finite"]:
        raise AssertionError(f"card and CPU forwards disagree: {bad} {row}")
    if launches != FORWARD_LAUNCHES:
        raise AssertionError(f"forward launches {launches}, want {FORWARD_LAUNCHES}")

    from streamspeech_tpu_torch.entry import entry

    fn, args = entry("cuda")
    units = fn(*args)
    emit({"phase": "entry", "unit_logits_shape": list(units.shape),
          "finite": bool(torch.isfinite(units).all())})
    if tuple(units.shape) != (1, 400, 1005) or not torch.isfinite(units).all():
        raise AssertionError(f"entry() gave {tuple(units.shape)} unit logits")
    del fn, args, units

    times = {}
    for batch, mt_len in ((1, 24), (8, 48)):
        # measure_forward's inputs: every fbank 1024 frames, MT tokens all 4
        s_b = torch.randn(batch, 1024, 80, generator=torch.Generator().manual_seed(SEED))
        args = (s_b.cuda(), torch.full((batch,), 1024, device="cuda"),
                torch.full((batch, mt_len), 4, device="cuda"))
        with torch.no_grad():
            times[f"b{batch}_mt{mt_len}_ms"] = _time_ms(lambda: model(*args, **kw),
                                                        reps=20, warmup=3)
    emit({"phase": "forward_time", "frames": 1024, **times,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    return launches, times, model, ref, {k: v.cpu() for k, v in out.items()}


def _rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a.double() - b.double()) ** 2).mean().sqrt())


def phase_forward_bf16(model32, ref32, card32, times32):
    """Phase 6's model (its fp32 weights) computing in bf16: the card against
    the same bf16 model on the CPU, within BF16_DRIFT of the CPU bf16 model's
    own distance from the CPU fp32 forward; launches in one card forward; its
    times beside the fp32 ones."""
    from streamspeech_tpu_torch.config import full_config
    from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel

    kw = dict(chunk_size=8, conv_chunk_size=8, k1=0, n1=1, k2=0, n2=1,
              mt_mask_mode="ctc")
    model = StreamSpeechModel(full_config(), dtype=torch.bfloat16)
    model.load_state_dict(model32.state_dict())
    model.eval()
    del model32
    torch.cuda.empty_cache()
    src, lens, mt = _forward_inputs(2, [1024, 800], 24, pad_after=18)
    with torch.no_grad():
        ref = model(src, lens, mt, **kw)
        ref_mask = _streaming_mask(model, ref, 24)
        model.cuda()
        dev_args = (src.cuda(), lens.cuda(), mt.cuda())
        torch.cuda.synchronize()
        _zero_counts()
        out = model(*dev_args, **kw)
        torch.cuda.synchronize()
        launches = _read_counts()
        mask = _streaming_mask(model, out, 24).cpu()
    dists, bad = {}, []
    for key, want in ref.items():
        got = out[key].cpu()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"bf16 forward output {key}: card {got.dtype} "
                                 f"{tuple(got.shape)} vs CPU {want.dtype} "
                                 f"{tuple(want.shape)}")
        if want.dtype == torch.bfloat16:
            own = _rms(want, ref32[key])
            dists[key] = {"card_vs_cpu_bf16": _rms(got, want), "cpu_bf16_vs_fp32": own,
                          "card_vs_card_fp32": _rms(got, card32[key]),
                          "card_vs_cpu_bf16_max_abs": float((got.float() - want.float())
                                                            .abs().max())}
            if not dists[key]["card_vs_cpu_bf16"] <= BF16_DRIFT * own:
                bad.append(key)
        elif not torch.equal(got, want):
            bad.append(key)
    agreement = float((mask == ref_mask).float().mean())
    row = {"phase": "forward_bf16", "batch": 2, "fbank_lengths": [1024, 800],
           "mt_len": 24, "launches": launches, "expected_launches": FORWARD_BF16_LAUNCHES,
           "rms_distances": dists, "drift_factor": BF16_DRIFT,
           "allowed_cross_agreement": agreement, "agreement_min": BF16_AGREEMENT,
           "allowed_cross_allowed_share": float(ref_mask.float().mean()),
           "finite": all(bool(torch.isfinite(v.float()).all()) for v in out.values())}
    emit(row)
    if bad or agreement < BF16_AGREEMENT or not row["finite"]:
        raise AssertionError(f"card and CPU bf16 forwards disagree: {bad} {row}")
    if launches != FORWARD_BF16_LAUNCHES:
        raise AssertionError(f"bf16 forward launches {launches}, "
                             f"want {FORWARD_BF16_LAUNCHES}")
    times = {}
    for batch, mt_len in ((1, 24), (8, 48)):
        s_b = torch.randn(batch, 1024, 80, generator=torch.Generator().manual_seed(SEED))
        args = (s_b.cuda(), torch.full((batch,), 1024, device="cuda"),
                torch.full((batch, mt_len), 4, device="cuda"))
        with torch.no_grad():
            times[f"b{batch}_mt{mt_len}_ms"] = _time_ms(lambda: model(*args, **kw),
                                                        reps=20, warmup=3)
    emit({"phase": "forward_bf16_time", "frames": 1024, **times,
          "fp32": times32, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30})
    del model
    torch.cuda.empty_cache()
    return launches


def _train_setup(cfg, device, seed, kernel_attention=False, dtype=torch.float32):
    from streamspeech_tpu_torch.config import OptimizationConfig
    from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
    from streamspeech_tpu_torch.train.trainer import (
        TrainState,
        make_optimizer,
        make_train_step,
    )
    from streamspeech_tpu_torch.weights import random_init_

    model = random_init_(StreamSpeechModel(cfg, dtype=dtype), seed).to(device)
    # measure_train_step's optimizer (`benchmarks.py:258-259`)
    tx = make_optimizer(OptimizationConfig(update_freq=1, warmup_updates=10000, lr=1e-3,
                                           clip_norm=10.0))
    step = make_train_step(model, tx, unit_blank=cfg.unit_decoder.vocab_size - 1,
                           kernel_attention=kernel_attention)
    return model, step, TrainState.create(model, tx)


LOSS_KEYS = ("loss", "unit_ctc_loss", "mt_loss", "mt_nll_loss", "asr_ctc_loss",
             "st_ctc_loss")


def phase_train(kernel_attention=False, dtype=torch.float32):
    """The train step at ``full_config`` and ``measure_train_step``'s shape, on
    the default route or (phase ``train_kernels``) the kernel route, fp32 or
    (``train_bf16``, ``train_bf16_kernels``) bf16 compute: a warm-up step,
    then 5 timed steps."""
    from streamspeech_tpu_torch.config import full_config
    from streamspeech_tpu_torch.train.synthetic import batch_to_tensors, synthetic_batch

    bf16 = dtype == torch.bfloat16
    name = "train" + ("_bf16" if bf16 else "") + ("_kernels" if kernel_attention else "")
    expected = {(False, False): TRAIN_LAUNCHES, (True, False): TRAIN_KERNEL_LAUNCHES,
                (False, True): TRAIN_BF16_LAUNCHES,
                (True, True): TRAIN_BF16_KERNEL_LAUNCHES}[kernel_attention, bf16]
    cfg = full_config()
    model, step, state = _train_setup(cfg, "cuda", SEED, kernel_attention, dtype)
    batch = batch_to_tensors(synthetic_batch(cfg, batch=8, frames=1024, mt_len=48,
                                             units_len=256, text_len=32), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    step_ms, per_step, losses = [], [], []
    for _ in range(6):
        before = _read_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        start.record()
        state, metrics = step(state, batch, gen, 8, 8)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        after = _read_counts()
        per_step.append({k: after[k] - before[k] for k in after})
        losses.append({k: float(metrics[k]) for k in LOSS_KEYS + ("grad_norm",)})
    launches = _read_counts()
    row = {"phase": name, "dtype": str(dtype), "batch": 8, "frames": 1024, "mt_len": 48,
           "unit_t": 1200,
           "units_len": 256, "text_len": 32, "dropout": cfg.encoder.dropout,
           "params": sum(p.numel() for p in model.parameters()),
           "warmup_step_ms": step_ms[0], "step_ms": step_ms[1:],
           "median_step_ms": statistics.median(step_ms[1:]),
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "step1_losses": losses[0], "last_losses": losses[-1],
           "launches_per_step": per_step[0], "expected_launches": expected,
           "launches": launches}
    emit(row)
    bad = [i for i, loss in enumerate(losses)
           if not all(np.isfinite(v) for v in loss.values())]
    if bad:
        raise AssertionError(f"{name} steps {bad} gave non-finite losses: {losses}")
    if any(p != expected for p in per_step):
        raise AssertionError(f"{name} launches per step {per_step}, want {expected}")
    del model, step, state
    torch.cuda.empty_cache()
    return launches


def _kernel_route_attention(model):
    """The attention modules whose training route is a kernel at these shapes:
    the encoder's rel-pos self-attention and both of the unit decoder's."""
    from streamspeech_tpu_torch.models.layers import (
        MultiHeadAttention,
        RelPosMultiHeadAttention,
    )

    return [m for name, m in model.named_modules()
            if isinstance(m, RelPosMultiHeadAttention)
            or (isinstance(m, MultiHeadAttention) and name.startswith("unit_decoder."))]


def _relu_ties(model):
    """Forward hooks on every ReLU FFN's fc1 that collect the ties: per
    ``'<ffn>.fc1'``, the units whose preactivation came within RELU_TIE_RTOL of
    max|pre| of 0 at some position. Returns (ties, hook handles)."""
    from streamspeech_tpu_torch.models.transformer import TransformerFFN

    ties, handles = {}, []
    for name, module in model.named_modules():
        if isinstance(module, TransformerFFN):
            def hook(_, __, pre, key=f"{name}.fc1"):
                mag = pre.detach().reshape(-1, pre.shape[-1]).abs()
                near = mag.min(0).values <= RELU_TIE_RTOL * mag.max()
                ties.setdefault(key, set()).update(torch.nonzero(near).flatten().tolist())
            handles.append(module.fc1.register_forward_hook(hook))
    return ties, handles


def _grad_check(g, ref_g, ties):
    """Card gradients ``g`` against the CPU's ``ref_g``: per tensor
    [max |g - ref| over the rows held, TRAIN_GRAD_RTOL * max|ref| + 1e-7], and
    the rows left out: a tie's row of ``<ffn>.fc1.weight`` or element of its
    bias (``ties``, from the CPU step) whose distance is past the tolerance,
    with that distance over max|ref|."""
    errs, left_out = {}, []
    for n, want in ref_g.items():
        scale = max(float(want.abs().max()), 1e-30)
        tol = TRAIN_GRAD_RTOL * float(want.abs().max()) + 1e-7
        rows = (g[n] - want).abs().reshape(want.shape[0], -1).max(dim=1).values
        prefix, leaf = n.rsplit(".", 1)
        for unit in sorted(ties.get(prefix, ())) if leaf in ("weight", "bias") else ():
            if rows[unit] > tol:
                left_out.append({"tensor": n, "row": unit,
                                 "distance": float(rows[unit]) / scale})
                rows[unit] = 0.0
        errs[n] = [float(rows.max()), tol]
    return errs, left_out


def _reference_step(device, kernel_attention=False, attention_dropout=0.0,
                    dtype=torch.float32):
    """One train step of the reference phases' model and batch on ``device``:
    (losses and grad_norm, gradients, batch statistics, launch counts, the
    ReLU ties of ``_relu_ties``)."""
    from streamspeech_tpu_torch.config import full_config
    from streamspeech_tpu_torch.kernels import attention
    from streamspeech_tpu_torch.train.synthetic import batch_to_tensors, synthetic_batch

    cfg = full_config()
    cfg.encoder.layers = 2
    cfg.encoder.dropout = cfg.mt_decoder.dropout = cfg.unit_decoder.dropout = 0.0
    nb = synthetic_batch(cfg, batch=2, frames=1024, mt_len=24, units_len=128,
                         text_len=16, seed=SEED + 3)
    nb["src_lengths"] = np.array([1024, 800], np.int32)
    nb["prev_output_tokens_mt"][1, 18:] = 1                  # PAD
    nb["mt_targets"][1, 17:] = 1
    model, step, state = _train_setup(cfg, device, SEED + 4, kernel_attention, dtype)
    ties, hooks = _relu_ties(model)
    gen = None
    real_draw_seed = attention.draw_seed
    if attention_dropout > 0:
        for module in _kernel_route_attention(model):
            module.dropout = attention_dropout
        gen = torch.Generator(device=device).manual_seed(SEED)
        calls = iter(range(1000, 2000))
        attention.draw_seed = lambda _, dev: torch.tensor(    # noqa: E731
            [next(calls)], dtype=torch.int64, device=dev)
    _zero_counts()
    try:
        state, metrics = step(state, batch_to_tensors(nb, device=device), gen, 8, 8)
    finally:
        attention.draw_seed = real_draw_seed
        for handle in hooks:
            handle.remove()
    if device == "cuda":
        torch.cuda.synchronize()
    return ({k: float(metrics[k]) for k in LOSS_KEYS + ("grad_norm",)},
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
            {n: b.cpu() for n, b in state.batch_stats.items()}, _read_counts(), ties)


def phase_train_reference(kernel_attention=False, attention_dropout=0.0):
    """One train step from the same weights and batch on the card and on the
    CPU: ``full_config`` widths, a 2-layer encoder, dropout 0, B=2. With
    ``kernel_attention`` the step takes the kernel route (the card launches
    the kernels, the CPU computes their plain versions) and the ReLU ties'
    rows may be left out (``_grad_check``); ``attention_dropout`` then sets
    the rate of the attention modules on that route only, the mask drawn from
    explicit per-call seeds that are the same on both devices."""
    name = "train_kernels_reference" if kernel_attention else "train_reference"
    expected = dict(TRAIN_LAUNCHES)
    if kernel_attention:     # 2 encoder layers, 2 unit-decoder layers
        expected.update({k: 2 for k in TRAIN_KERNEL_LAUNCHES
                         if "attention" in k and not k.endswith("_bf16")},
                        mask_draws=12 if attention_dropout > 0 else 0)
    runs = {device: _reference_step(device, kernel_attention, attention_dropout)
            for device in ("cpu", "cuda")}
    (ref_m, ref_g, ref_s, _, ties), (m, g, st, launches, _) = runs["cpu"], runs["cuda"]
    loss_err = {k: [abs(m[k] - v), TRAIN_RTOL * max(1.0, abs(v))] for k, v in ref_m.items()}
    if kernel_attention:
        # a function of the gradients, held to their tolerance: it reads 9.9e-5
        # and 1.3e-4 of itself here, 2.3e-5 on the default route
        loss_err["grad_norm"][1] = TRAIN_GRAD_RTOL * max(1.0, abs(ref_m["grad_norm"]))
    grad_err, left_out = _grad_check(g, ref_g, ties if kernel_attention else {})
    units_left_out = sorted({(r["tensor"].rsplit(".", 1)[0], r["row"]) for r in left_out})
    stat_err = {n: [float((st[n] - want).abs().max()),
                    TRAIN_RTOL * max(1.0, float(want.abs().max()))]
                for n, want in ref_s.items()}
    worst = max(grad_err, key=lambda n: grad_err[n][0] / grad_err[n][1])
    row = {"phase": name, "batch": 2, "fbank_lengths": [1024, 800],
           "attention_dropout": attention_dropout, "grad_rtol": TRAIN_GRAD_RTOL,
           "relu_tie_rtol": RELU_TIE_RTOL if kernel_attention else None,
           "relu_ties": sum(len(u) for u in ties.values()) if kernel_attention else None,
           "rows_left_out": left_out, "units_left_out": len(units_left_out),
           "mt_len": 24, "losses_cpu": ref_m, "loss_err_and_tol": loss_err,
           "grad_tensors": len(grad_err), "worst_grad": [worst, *grad_err[worst]],
           "worst_remaining_distance": grad_err[worst][0]
           / max(float(ref_g[worst].abs().max()), 1e-30),
           "batch_stat_err_and_tol": stat_err, "launches": launches}
    emit(row)
    bad = [k for d in (loss_err, grad_err, stat_err) for k, (e, tol) in d.items()
           if not e <= tol]
    if bad:
        raise AssertionError(f"{name}: card and CPU train steps disagree: {bad}")
    if len(units_left_out) > RELU_TIES_MAX:
        raise AssertionError(f"{name}: {len(units_left_out)} ReLU units left out, "
                             f"more than {RELU_TIES_MAX}: {left_out}")
    if launches != expected:
        raise AssertionError(f"{name} launches {launches}, want {expected}")
    return runs["cpu"]


def _distance(got, want) -> float:
    """The L2 distance between two dicts of tensors, as one vector."""
    return float(sum(((got[n].double() - want[n].double()) ** 2).sum() for n in want) ** 0.5)


def phase_train_reference_bf16(cpu32, kernel_attention=False, attention_dropout=0.0):
    """Phase 9's (or 12's) step with the model computing in bf16, on the card
    and on the CPU, held to the CPU bf16 step's own distance from the CPU fp32
    step ``cpu32`` (the earlier phase's CPU run): the whole gradient and the
    batch statistics within BF16_DRIFT of it, each gradient tensor within
    BF16_TENSOR_DRIFT of its own, each loss within BF16_LOSS_RTOL of itself.
    cuBLAS's bf16 products and the CPU's may round differently, so the card is
    held to bf16's drift, not to TRAIN_GRAD_RTOL. Reports the ReLU units of
    the CPU bf16 step within RELU_TIE_RTOL of 0."""
    name = "train_bf16" + ("_kernels" if kernel_attention else "") + "_reference"
    expected = dict(TRAIN_BF16_LAUNCHES)
    if kernel_attention:     # 2 encoder layers, 2 unit-decoder layers
        expected.update({k: 2 for k in TRAIN_BF16_KERNEL_LAUNCHES
                         if "attention" in k and not k.startswith(("masked_attention",
                                                                   "bias_attention"))},
                        masked_attention_bf16=2, bias_attention_bf16=2,
                        masked_attention_bwd_bf16=2, bias_attention_bwd_bf16=2,
                        mask_draws=12 if attention_dropout > 0 else 0)
    runs = {device: _reference_step(device, kernel_attention, attention_dropout,
                                    torch.bfloat16) for device in ("cpu", "cuda")}
    (m32, g32, s32, _, _) = cpu32
    (m16, g16, s16, _, ties), (m, g, st, launches, _) = runs["cpu"], runs["cuda"]
    own, got = _distance(g16, g32), _distance(g, g16)
    stats_own, stats_got = _distance(s16, s32), _distance(st, s16)
    ratios = {n: float((g[n] - g16[n]).double().norm())
              / max(float((g16[n] - g32[n]).double().norm()), 1e-30) for n in g16}
    worst = max(ratios, key=ratios.get)
    loss_err = {k: [abs(m[k] - v), BF16_LOSS_RTOL * abs(v),
                    abs(m[k] - v) / max(abs(v - m32[k]), 1e-30)] for k, v in m16.items()}
    row = {"phase": name, "batch": 2, "fbank_lengths": [1024, 800], "mt_len": 24,
           "attention_dropout": attention_dropout, "losses_cpu_bf16": m16,
           "loss_err_tol_and_drift_ratio": loss_err,
           "grad_drift_ratio": got / max(own, 1e-30), "grad_drift_max": BF16_DRIFT,
           "grad_worst_tensor": [worst, ratios[worst]],
           "grad_median_ratio": statistics.median(ratios.values()),
           "grad_tensors_past_2x": sum(r > 2 for r in ratios.values()),
           "grad_tensor_max": BF16_TENSOR_DRIFT,
           "batch_stat_drift_ratio": stats_got / max(stats_own, 1e-30),
           "relu_ties_cpu_bf16": sum(len(u) for u in ties.values()),
           "relu_tie_rtol": RELU_TIE_RTOL, "launches": launches}
    emit(row)
    bad = [k for k, (e, tol, _) in loss_err.items() if not e <= tol]
    if bad or not got <= BF16_DRIFT * own or not ratios[worst] <= BF16_TENSOR_DRIFT or \
            not stats_got <= BF16_DRIFT * stats_own:
        raise AssertionError(f"{name}: card and CPU bf16 train steps disagree: {bad} {row}")
    if launches != expected:
        raise AssertionError(f"{name} launches {launches}, want {expected}")


def main():
    smi = phase_env()
    phase_build()
    rows = phase_kernel()
    rows.update(phase_kernel_bf16())
    rows["graph_cond"] = [_check_graph_cond()]
    serving_launches, fp32_runs, agent, outputs = phase_serving()
    serving_fused_launches, fused_outputs = phase_serving_fused(agent, outputs)
    serving_pipelined_launches = phase_serving_pipelined(agent, fused_outputs)
    serving_bf16_launches, _, agent_bf16, _ = phase_serving(torch.bfloat16, fp32_runs)
    bf16_fused_launches = phase_serving_batched_fused(agent_bf16)
    del agent_bf16
    torch.cuda.empty_cache()
    phase_reference()
    serving_batched_launches, _, singles = phase_serving_batched(agent)
    batched_fused_launches = phase_serving_batched_fused(agent, singles)
    del agent
    torch.cuda.empty_cache()
    forward_launches, times32, model32, ref32, card32 = phase_forward()
    forward_bf16_launches = phase_forward_bf16(model32, ref32, card32, times32)
    del model32, ref32, card32
    train_launches = phase_train()
    cpu32 = phase_train_reference()
    rows.update(phase_kernel_train())
    train_kernel_launches = phase_train(kernel_attention=True)
    cpu32_kernels = phase_train_reference(kernel_attention=True)
    cpu32_dropout = phase_train_reference(kernel_attention=True,
                                          attention_dropout=ATTN_DROPOUT)
    rows.update(phase_kernel_train_bf16())
    train_bf16_launches = phase_train(dtype=torch.bfloat16)
    train_bf16_kernel_launches = phase_train(kernel_attention=True, dtype=torch.bfloat16)
    phase_train_reference_bf16(cpu32)
    phase_train_reference_bf16(cpu32_kernels, kernel_attention=True)
    phase_train_reference_bf16(cpu32_dropout, kernel_attention=True,
                               attention_dropout=ATTN_DROPOUT)
    train_shape = lambda r: r.get("ms") is not None and r["rate"] == ATTN_DROPOUT  # noqa: E731
    sources = {
        "masked_attention": ("pallas_attention.py:425", "masked_attention.cu",
                             lambda r: r["t_pad"] == 3200),
        "relpos_attention": ("pallas_attention.py:95", "relpos_attention.cu",
                             lambda r: (r["b"], r["t"]) == (1, 256)),
        "bias_attention": ("pallas_attention.py:625", "bias_attention.cu",
                           lambda r: (r["b"], r["tq"]) == (1, 600)),
        "not_blank_probs": ("pallas_policy.py:99", "not_blank.cu",
                            lambda r: r["b"] == 1),
        "ctc_alpha": ("pallas_ctc.py:108", "ctc.cu", lambda r: (r["b"], r["t"]) == (8, 1200)),
        "ctc_beta": ("pallas_ctc.py:127", "ctc.cu", lambda r: (r["b"], r["t"]) == (8, 1200)),
        # the backward kernels and the mask: the kernel train route's shapes, dropout 0.1
        "relpos_attention_bwd": ("pallas_attention.py:243", "relpos_attention_bwd.cu",
                                 train_shape),
        "masked_attention_bwd": ("pallas_attention.py:508", "masked_attention_bwd.cu",
                                 train_shape),
        "bias_attention_bwd": ("pallas_attention.py:712", "bias_attention_bwd.cu",
                               train_shape),
        "dropout_keep": ("pallas_attention.py:36", "dropout.cuh",
                         lambda r: r.get("ms") is not None),
        # the bf16 forms, at the fp32 forms' main shapes
        "masked_attention_bf16": ("pallas_attention.py:425", "masked_attention_bf16.cu",
                                  lambda r: r["t_pad"] == 3200),
        "bias_attention_bf16": ("pallas_attention.py:625", "bias_attention_bf16.cu",
                                lambda r: (r["b"], r["tq"]) == (1, 600)),
        "not_blank_probs_bf16": ("pallas_policy.py:99", "not_blank.cu",
                                 lambda r: r["b"] == 1 and "ms" in r),
        # the bf16 backwards: the kernel train route's shapes, dropout 0.1
        "masked_attention_bwd_bf16": ("pallas_attention.py:508",
                                      "masked_attention_bwd_bf16.cu", train_shape),
        "bias_attention_bwd_bf16": ("pallas_attention.py:712", "bias_attention_bwd_bf16.cu",
                                    train_shape),
        # no TPU kernel: the set-conditional kernel of the overlapped tick's
        # IF nodes, in place of the decode's lax.cond (and the emission's, :515)
        "graph_cond": ("streamspeech_tpu/runtime/session.py:457", "graph_cond.cu",
                       lambda r: True),
    }
    # sources a kernel is built from beside the one named in its entry
    also = {"masked_attention": ["tc_mma.cuh", "dropout.cuh"],
            "relpos_attention": ["tc_mma.cuh", "dropout.cuh"],
            "bias_attention": ["tc_mma.cuh", "dropout.cuh"],
            "relpos_attention_bwd": ["tc_mma.cuh", "dropout.cuh"],
            "masked_attention_bwd": ["attention_bwd.cuh", "tc_mma.cuh", "dropout.cuh"],
            "bias_attention_bwd": ["attention_bwd.cuh", "tc_mma.cuh", "dropout.cuh"],
            "not_blank_probs": ["tc_mma.cuh"],
            "dropout_keep": ["dropout.cu", "tc_mma.cuh"],
            "masked_attention_bf16": ["attention_bf16.cuh", "wgmma.cuh", "tc_mma.cuh",
                                      "dropout.cuh"],
            "bias_attention_bf16": ["attention_bf16.cuh", "wgmma.cuh", "tc_mma.cuh",
                                    "dropout.cuh"],
            "not_blank_probs_bf16": ["tc_mma.cuh"],
            "masked_attention_bwd_bf16": ["attention_bwd_bf16.cuh", "attention_bf16.cuh",
                                          "wgmma.cuh", "tc_mma.cuh", "dropout.cuh"],
            "bias_attention_bwd_bf16": ["attention_bwd_bf16.cuh", "attention_bf16.cuh",
                                        "wgmma.cuh", "tc_mma.cuh", "dropout.cuh"]}
    paths = {"serving": serving_launches, "serving_batched": serving_batched_launches,
             "serving_fused": serving_fused_launches,
             "serving_pipelined": serving_pipelined_launches,
             "serving_batched_fused": batched_fused_launches,
             "serving_bf16_batched_fused": bf16_fused_launches,
             "forward": forward_launches,
             "train": train_launches, "train_kernels": train_kernel_launches,
             "serving_bf16": serving_bf16_launches, "forward_bf16": forward_bf16_launches,
             "train_bf16": train_bf16_launches, "train_bf16_kernels": train_bf16_kernel_launches}
    kernels = []
    for name, (replaces, source, main_shape) in sources.items():
        row = next(r for r in rows[name] if main_shape(r))
        by_path = {k: v[name] for k, v in paths.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"streamspeech_tpu_torch/csrc/{source}",
            "also_built_from": [f"streamspeech_tpu_torch/csrc/{s}"
                                for s in also.get(name, [])],
            "replaces": (replaces if replaces.startswith("streamspeech_tpu/")
                         else f"streamspeech_tpu/ops/{replaces}"),
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            # B10 runs inside the six attention kernels: the launches of theirs
            # that drew the mask. Its own kernel, which writes the mask out
            # alone and is what ms times, is launched on no path
            **({"draws_by_path": {k: v["mask_draws"] for k, v in paths.items()}}
               if name == "dropout_keep" else {}),
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            # the forward kernels' training form at the train shape with dropout
            "training_form": next(
                ({k: r.get(k) for k in ("rate", "ms", "plain_ms", "library_ms", "bound_ms",
                                        "bound_by", "max_rel_err", "bound_share",
                                        "dropout_gap_ms", "max_abs_err")}
                 for r in rows.get(f"{name}_train", []) if train_shape(r)), None),
            # the backward kernels at the same shape without dropout
            "without_dropout": next(
                ({k: r.get(k) for k in ("ms", "plain_ms", "library_ms",
                                        "plain_autograd_fwd_bwd_ms", "kernel_fwd_bwd_ms",
                                        "library_fwd_bwd_ms")}
                 for r in rows[name] if r.get("rate") == 0.0 and r.get("ms") is not None),
                None),
            "shape": {k: row[k] for k in ("b", "h", "t", "t_pad", "tq", "tk", "d", "v",
                                          "s") if k in row},
            **({"dropout_gap_ms": row["dropout_gap_ms"]} if "dropout_gap_ms" in row else {}),
            # B3 at the batched wave's shape: B streams, each row its own length
            **({"batched_shape": next(
                {k: r[k] for k in ("b", "h", "t_pad", "rows_valid", "d", "max_abs_err", "ms",
                                   "plain_ms", "library_ms", "bound_ms", "bound_by")}
                for r in rows[name] if "rows_valid" in r)}
               if name == "masked_attention" else {}),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
