"""The port stands alone: it never imports jax, flax, optax or the JAX package, and its
yaml-free configs keep the JAX package's fields and defaults.

``chip_smoke.py`` drives the port on a machine that has neither jax nor the
JAX package's dependencies, and must import nothing of the JAX package, so the
port carries its own copies of the few jax-free modules it needs."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from streamspeech_tpu import config as jax_config
from streamspeech_tpu.train import synthetic as jax_synthetic

from streamspeech_tpu_torch import config as port_config

REPO = Path(__file__).resolve().parents[1]

_SESSION_STEP = r"""
import sys
import numpy as np
from streamspeech_tpu_torch.agents.base import stream_utterance
from streamspeech_tpu_torch.agents.streamspeech import (StreamSpeechAgentConfig,
                                                         StreamSpeechS2STAgent)
from streamspeech_tpu_torch.config import tiny_config
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.models.vocoder import DEFAULT_VOCODER_CFG, CodeGenerator
from streamspeech_tpu_torch.runtime.session import StreamSpeechEngine
from streamspeech_tpu_torch.weights import doctor_params, random_init_

cfg = tiny_config()
model = doctor_params(random_init_(StreamSpeechModel(cfg), 0))
voc = random_init_(CodeGenerator(dict(DEFAULT_VOCODER_CFG, upsample_initial_channel=32,
                                      num_embeddings=20)), 1)
engine = StreamSpeechEngine(model, voc, device="cpu", max_enc_frames=64,
                            max_mt_tokens=32, mt_buckets=(8, 16, 32),
                            unit_buckets=(16, 32, 64))
text = Dictionary()
for i in range(cfg.mt_decoder.vocab_size - 4):
    text.add_symbol("w" + str(i))
units = Dictionary.units(19)
units.add_blank()
agent = StreamSpeechS2STAgent(engine, StreamSpeechAgentConfig(), text, text, units)
samples = np.random.RandomState(0).uniform(-0.3, 0.3, 8000)
outs = list(stream_utterance(agent, samples))
assert outs[-1].finished and agent.session.enc_len > 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "streamspeech_tpu"))
print("FOREIGN", bad)
sys.exit(1 if bad else 0)
"""


_TRAIN_STEP = r"""
import sys
import torch
from streamspeech_tpu_torch.config import OptimizationConfig, tiny_config
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.train.synthetic import batch_to_tensors, synthetic_batch
from streamspeech_tpu_torch.train.trainer import (TrainState, make_optimizer,
                                                  make_train_step)
from streamspeech_tpu_torch.weights import random_init_

cfg = tiny_config()
model = random_init_(StreamSpeechModel(cfg), 0)
tx = make_optimizer(OptimizationConfig(update_freq=1, warmup_updates=10))
step = make_train_step(model, tx, unit_blank=cfg.unit_decoder.vocab_size - 1,
                       specaugment_cfg={}, rdrop_alpha=0.5)
state, metrics = step(TrainState.create(model, tx),
                      batch_to_tensors(synthetic_batch(cfg), device="cpu"),
                      torch.Generator().manual_seed(0), 4, 8)
assert torch.isfinite(metrics["loss_mean"]) and state.step == 1
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "streamspeech_tpu"))
print("FOREIGN", bad)
sys.exit(1 if bad else 0)
"""


# a bf16 step on the kernel route, every attention gate open, dropout on: the
# bf16 training forms and backwards of the causal and bias kernels (their
# plain versions here)
_TRAIN_STEP_BF16 = _TRAIN_STEP.replace(
    "model = random_init_(StreamSpeechModel(cfg), 0)",
    "from streamspeech_tpu_torch.models import layers\n"
    "for gate in ('_relpos_kernel_ok', '_masked_kernel_ok', '_bias_kernel_ok'):\n"
    "    setattr(layers, gate, lambda t, dh: True)\n"
    "model = random_init_(StreamSpeechModel(cfg, dtype=torch.bfloat16), 0)").replace(
    "specaugment_cfg={}, rdrop_alpha=0.5)", "kernel_attention=True)")


def _run_alone(script):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "FOREIGN []" in proc.stdout


def test_port_runs_without_jax_or_the_jax_package():
    _run_alone(_SESSION_STEP)


def test_port_trains_without_jax_or_the_jax_package():
    """A train step with SpecAugment and R-Drop imports nothing of JAX."""
    _run_alone(_TRAIN_STEP)


def test_port_trains_bf16_without_jax_or_the_jax_package():
    """A bf16 step on the kernel route imports nothing of JAX."""
    assert "dtype=torch.bfloat16" in _TRAIN_STEP_BF16 and "kernel_attention" in \
        _TRAIN_STEP_BF16
    _run_alone(_TRAIN_STEP_BF16)


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|streamspeech_tpu)\b",
                         re.M)
    files = sorted((REPO / "streamspeech_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"] + sorted((REPO / "tools").glob("profile_torch_*.py"))
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert not offenders, offenders


@pytest.mark.parametrize("name", ["EncoderConfig", "DecoderConfig",
                                  "UnitDecoderConfig", "MultitaskTaskConfig",
                                  "StreamSpeechConfig", "OptimizationConfig",
                                  "TrainingConfig"])
def test_config_fields_and_defaults_match(name):
    port_cls, jax_cls = getattr(port_config, name), getattr(jax_config, name)
    port_fields = [(f.name, f.type) for f in dataclasses.fields(port_cls)]
    jax_fields = [(f.name, f.type) for f in dataclasses.fields(jax_cls)]
    assert port_fields == jax_fields
    assert dataclasses.asdict(port_cls()) == dataclasses.asdict(jax_cls())


@pytest.mark.parametrize("name", ["tiny_config", "full_config"])
def test_named_configs_match(name):
    assert dataclasses.asdict(getattr(port_config, name)()) == \
        dataclasses.asdict(getattr(jax_synthetic, name)())
    assert dataclasses.asdict(port_config.StreamSpeechConfig.simul_s2st()) == \
        dataclasses.asdict(jax_config.StreamSpeechConfig.simul_s2st())
