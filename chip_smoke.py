"""Drive the PyTorch/CUDA port on one NVIDIA Hopper card and check it.

    python3 chip_smoke.py

Phases, one JSON line each (any failure raises and exits non-zero):
1. env      torch version, the card, ``nvidia-smi`` name and power limit;
            refuses to run without a CUDA device of capability (9, 0).
2. build    compiles every ``streamspeech_tpu_torch/csrc/*.cu`` with nvcc
            (one process per source, started together).
3. kernel   the causal masked-attention kernel against its plain PyTorch
            version at the unit decoder's serving shapes (B=1, H=8, D=64,
            T_pad in 512/896/1664/3200); max abs error and median times.
4. serving  the full-width StreamSpeech model (``full_config``, seeded random
            weights, doctored so the policy writes) with a full-width
            CodeHiFiGAN vocoder, through the S2ST agent over three synthetic
            speech-like utterances of 3, 6 and 10 s in 320 ms segments; the
            kernel's launch count over this phase must be > 0.
5. reference ``full_config`` widths with a 2-layer encoder, run on the card
            and on the CPU over the same audio: the same MT tokens and units,
            the wav within tolerance.
Then the ``kernels`` summary line, and last the ``ok`` line.

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
REFERENCE_WAV_ATOL = 1e-5   # card vs CPU run of the same model, fp32
SERVING_SHAPES = [(512, 400), (896, 800), (1664, 1600), (3200, 3200)]  # (T_pad, T)
UTTERANCE_SECONDS = (3.0, 6.0, 10.0)
SEED = 0


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


def phase_kernel():
    from streamspeech_tpu_torch.kernels.attention import (
        masked_attention,
        masked_attention_reference,
    )
    from streamspeech_tpu_torch.ops.masks import NEG_INF

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(SEED)
    rows = []
    for t_pad, t in SERVING_SHAPES:
        q, k, v = (torch.randn(1, 8, t_pad, 64, generator=gen).to(dev)
                   for _ in range(3))
        # the unit decoder's key bias: real rows valid, tile padding masked
        kvb = torch.where(torch.arange(t_pad) < t, 0.0, NEG_INF)
        kvb = kvb.to(torch.float32).view(1, 1, t_pad).to(dev)
        got = masked_attention(q, k, v, kvb, 0.125)
        want = masked_attention_reference(q, k, v, kvb, 0.125)
        torch.cuda.synchronize()
        err = float((got - want)[..., :t, :].abs().max())
        ms = _time_ms(lambda: masked_attention(q, k, v, kvb, 0.125))
        plain_ms = _time_ms(lambda: masked_attention_reference(q, k, v, kvb, 0.125))
        row = {"phase": "kernel", "name": "masked_attention", "t_pad": t_pad,
               "t": t, "max_abs_err": err, "atol": KERNEL_ATOL, "ms": ms,
               "plain_ms": plain_ms}
        emit(row)
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"masked_attention disagrees at T={t_pad}: "
                                 f"{err} > {KERNEL_ATOL}")
        rows.append(row)
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


def phase_serving():
    from streamspeech_tpu_torch.config import full_config
    from streamspeech_tpu_torch.kernels.attention import masked_attention
    from streamspeech_tpu_torch.models.vocoder import DEFAULT_VOCODER_CFG

    agent = _build_agent(full_config(), DEFAULT_VOCODER_CFG, "cuda", SEED)
    rng = np.random.RandomState(SEED)
    masked_attention.launches = 0
    for seconds in UTTERANCE_SECONDS:
        stats, wav, _, _ = _run_utterance(agent, _babble(rng, seconds))
        stats = {"phase": "serving", "seconds_audio": seconds, **stats}
        emit(stats)
        if stats["units"] < 1 or wav.size == 0:
            raise AssertionError(f"{seconds} s utterance wrote no units or no wav")
        if not np.isfinite(wav).all():
            raise AssertionError(f"{seconds} s utterance wrote non-finite wav")
    launches = masked_attention.launches
    if launches < 1:
        raise AssertionError("serving never launched the masked-attention kernel")
    emit({"phase": "serving_total", "masked_attention_launches": launches})
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


def main():
    smi = phase_env()
    phase_build()
    rows = phase_kernel()
    launches = phase_serving()
    phase_reference()
    worst = max(rows, key=lambda r: r["t_pad"])
    emit({"kernels": [{
        "name": "masked_attention", "route": "cuda",
        "source": "streamspeech_tpu_torch/csrc/masked_attention.cu",
        "replaces": "streamspeech_tpu/ops/pallas_attention.py:425",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": worst["ms"], "plain_ms": worst["plain_ms"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    sys.exit(main())
