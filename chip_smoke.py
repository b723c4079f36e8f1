"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):
1. env      torch version, the card, ``nvidia-smi`` name and power limit;
            refuses to run without a CUDA device of capability (9, 0).
2. build    compiles every ``streamspeech_tpu_torch/csrc/*.cu`` with nvcc
            (one process per source, started together).
3. kernel   each kernel against its plain PyTorch version on the same inputs:
            causal masked attention at the unit decoder's serving shapes
            (B=1, H=8, D=64, T_pad 512/896/1664/3200) and the forward's
            (T_pad 640); rel-pos attention at [1|8, 4, 256, 64] and
            [1, 4, 512, 64]; bias attention at TQ/TK 600/24 (B=1) and
            1200/48 (B=8), H=8, D=64; the not-blank posterior at
            [1|8, 256, 6000]. Max abs error against its tolerance; the device
            ms of one call (CUDA-graph replay of 20 calls, median CUDA-event
            time) of the kernel, the plain version and (attention with a mask)
            one ``F.scaled_dot_product_attention`` call as a yardstick; the
            kernel's eager per-call ms (host launch cost included); and the
            bound: max(flops / 67 TFLOP/s fp32, bytes / 3.35 TB/s), each
            input read and each output written once.
4. serving  the full-width StreamSpeech model (``full_config``, seeded random
            weights, doctored so the policy writes) with a full-width
            CodeHiFiGAN vocoder, through the S2ST agent over three synthetic
            speech-like utterances of 3, 6 and 10 s in 320 ms segments; the
            masked-attention kernel's launch count over this phase must be > 0.
5. reference ``full_config`` widths with a 2-layer encoder, run on the card
            and on the CPU over the same audio: the same MT tokens and units,
            the wav within tolerance.
6. forward  the offline (teacher-forced) forward of the same ``full_config``
            model, batch 2 (fbank lengths 1024 and 800, MT prefix 24 with the
            second row PAD after 18, chunk 8, CTC streaming mask, n2=1) on the
            card and on the CPU: the same CTC streaming mask, every output
            within tolerance, and in the card run 12 rel-pos, 2 bias, 2
            not-blank and 2 masked-attention launches. Then ``entry()``
            (``streamspeech_tpu_torch/entry.py``) on the card: finite unit
            logits of the expected shape; and the card forward's median time
            at B=1 (1024 frames, MT 24) and B=8 (MT 48).
Then the ``kernels`` summary line, the card's name and power limit, and last
the ``ok`` line.

fp32 throughout: TF32 is switched off for matmuls and cuDNN convolutions.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

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
UTTERANCE_SECONDS = (3.0, 6.0, 10.0)
SEED = 0
FP32_FLOPS = 67e12          # H100 SXM fp32 (non-tensor-core) peak, FLOP/s
HBM_BYTES = 3.35e12         # H100 SXM device-memory rate, B/s


def emit(obj):
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


def _ptxas_summary(log: str) -> dict:
    """``-Xptxas -v`` output → {entry: [registers, spill store bytes]}; a
    template instance ``...ILi64E...`` is keyed by its argument, ``<64>``."""
    out, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            arg = re.search(r"ILi(\d+)E", m.group(1))
            entry = f"<{arg.group(1)}>" if arg else m.group(1)
            out[entry] = [None, 0]
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


def _bound(flops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations over
    the fp32 peak and the bytes over the memory rate, and which one bounds."""
    by_ops, by_bytes = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(by_ops, by_bytes),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _check_kernel(name, fn, plain, library, args, atol, bound, **shape):
    """Run ``fn`` and ``plain`` on the same inputs, compare, time both (and the
    library yardstick, if any); emit and return the row."""
    got = fn(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    row = {"phase": "kernel", "name": name, **shape, "max_abs_err": err,
           "atol": atol, "ms": _device_ms(lambda: fn(*args)),
           "plain_ms": _device_ms(lambda: plain(*args)),
           "library_ms": None if library is None else _device_ms(lambda: library(*args)),
           "eager_call_ms": _time_ms(lambda: fn(*args)), **bound}
    emit(row)
    if not err <= atol:
        raise AssertionError(f"{name} disagrees with its plain version at {shape}: "
                             f"{err} > {atol}")
    return row


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
        bound = _bound(4 * 8 * pairs * 64, _nbytes(q, k, v, kvb, q))
        row = _check_kernel(
            "masked_attention", lambda *a: A.masked_attention(*a, 0.125),
            lambda *a: A.masked_attention_reference(*a, 0.125),
            lambda q, k, v, _: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                              scale=0.125),
            (q, k, v, kvb), KERNEL_ATOL, bound, b=1, h=8, t_pad=t_pad, t=t, d=64)
        rows["masked_attention"].append(row)

    for b, t in RELPOS_SHAPES:
        qu, qv, k, v = (randn(b, 4, t, 64) for _ in range(4))
        p = randn(4, 2 * t - 1, 64)
        # the encoder's bias: chunk-8 mask plus key validity (last row shorter)
        n_valid = torch.tensor([t] * (b - 1) + [t - 56], device=dev)
        i, j = torch.arange(t, device=dev)[:, None], torch.arange(t, device=dev)[None]
        allowed = (j < ((i // 8 + 1) * 8).clamp(max=t))[None, None] & \
            (torch.arange(t, device=dev) < n_valid[:, None])[:, None, None, :]
        bias = torch.where(allowed, 0.0, NEG_INF).float().contiguous()
        bound = _bound(6 * b * 4 * t * t * 64, _nbytes(qu, qv, k, v, p, bias, qu))
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
        bias = torch.where(allowed, 0.0, NEG_INF).float().contiguous()
        bound = _bound(4 * b * 8 * tq * tk * 64, _nbytes(q, k, v, bias, q))
        rows["bias_attention"].append(_check_kernel(
            "bias_attention", lambda *a: A.bias_attention(*a, 0.125),
            lambda *a: A.bias_attention_reference(*a, 0.125),
            lambda q, k, v, bias: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias[:, None], scale=0.125),
            (q, k, v, bias), KERNEL_ATOL, bound, b=b, h=8, tq=tq, tk=tk, d=64))

    for b, t, vocab in NOT_BLANK_SHAPES:
        logits = randn(b, t, vocab) * 4
        # max, exp, sum and the product with the previous row: ~4 ops a logit
        bound = _bound(4 * b * t * vocab, b * t * vocab * 4 + b * t * 4)
        rows["not_blank_probs"].append(_check_kernel(
            "not_blank_probs", policy.not_blank_probs,
            policy.not_blank_probs_reference, None, (logits,), NOT_BLANK_ATOL,
            bound, b=b, t=t, v=vocab))
    return rows


def _dicts(text_vocab: int, code_size: int):
    from streamspeech_tpu_torch.dictionary import Dictionary

    text = Dictionary()
    for i in range(text_vocab - 4):
        text.add_symbol("▁w" + str(i))
    units = Dictionary.units(code_size)
    units.add_blank()
    return text, units


def _build_agent(cfg, voc_cfg, device, seed, **engine_sizes):
    from streamspeech_tpu_torch.agents.streamspeech import (
        StreamSpeechAgentConfig,
        StreamSpeechS2STAgent,
    )
    from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
    from streamspeech_tpu_torch.models.vocoder import CodeGenerator
    from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine
    from streamspeech_tpu_torch.weights import doctor_params, random_init_

    model = doctor_params(random_init_(StreamSpeechModel(cfg), seed))
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

    wav, turns, writes = [], 0, 0
    t0 = time.perf_counter()
    for out in stream_utterance(agent, samples):
        turns += 1
        if not out.is_empty:
            writes += 1
            wav.extend(out.content)
    if agent.engine.device.type == "cuda":
        torch.cuda.synchronize()
    return {"segments": turns, "writes": writes,
            "text_tokens": len(agent.session.mt_tokens),
            "units": len(agent.units), "wav_samples": len(wav),
            "wall_s": time.perf_counter() - t0}, np.asarray(wav, np.float32), \
        list(agent.session.mt_tokens), list(agent.units)


def _kernel_wrappers() -> dict:
    from streamspeech_tpu_torch.kernels import attention, policy

    return {"masked_attention": attention.masked_attention,
            "relpos_attention": attention.relpos_attention,
            "bias_attention": attention.bias_attention,
            "not_blank_probs": policy.not_blank_probs}


def _zero_counts():
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def _read_counts() -> dict:
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


def phase_serving():
    from streamspeech_tpu_torch.config import full_config
    from streamspeech_tpu_torch.models.vocoder import DEFAULT_VOCODER_CFG

    agent = _build_agent(full_config(), DEFAULT_VOCODER_CFG, "cuda", SEED)
    rng = np.random.RandomState(SEED)
    _zero_counts()
    for seconds in UTTERANCE_SECONDS:
        stats, wav, _, _ = _run_utterance(agent, _babble(rng, seconds))
        stats = {"phase": "serving", "seconds_audio": seconds, **stats}
        emit(stats)
        if stats["units"] < 1 or wav.size == 0:
            raise AssertionError(f"{seconds} s utterance wrote no units or no wav")
        if not np.isfinite(wav).all():
            raise AssertionError(f"{seconds} s utterance wrote non-finite wav")
    launches = _read_counts()
    emit({"phase": "serving_total", "launches": launches})
    if launches["masked_attention"] < 1:
        raise AssertionError("serving never launched the masked-attention kernel")
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


FORWARD_LAUNCHES = {"relpos_attention": 12, "bias_attention": 2,
                    "not_blank_probs": 2, "masked_attention": 2}


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
    return launches, times


def main():
    smi = phase_env()
    phase_build()
    rows = phase_kernel()
    serving_launches = phase_serving()
    phase_reference()
    forward_launches, _ = phase_forward()
    sources = {
        "masked_attention": ("pallas_attention.py:425", "masked_attention.cu",
                             lambda r: r["t_pad"] == 3200),
        "relpos_attention": ("pallas_attention.py:95", "relpos_attention.cu",
                             lambda r: (r["b"], r["t"]) == (1, 256)),
        "bias_attention": ("pallas_attention.py:625", "bias_attention.cu",
                           lambda r: (r["b"], r["tq"]) == (1, 600)),
        "not_blank_probs": ("pallas_policy.py:99", "not_blank.cu",
                            lambda r: r["b"] == 1),
    }
    kernels = []
    for name, (replaces, source, main_shape) in sources.items():
        row = next(r for r in rows[name] if main_shape(r))
        by_path = {"serving": serving_launches[name], "forward": forward_launches[name]}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"streamspeech_tpu_torch/csrc/{source}",
            "replaces": f"streamspeech_tpu/ops/{replaces}",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows[name]),
            "shape": {k: row[k] for k in ("b", "h", "t", "t_pad", "tq", "tk", "d", "v")
                      if k in row},
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
