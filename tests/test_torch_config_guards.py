"""The port raises on configuration fields it does not implement, rather than
computing something other than the JAX package would (no JAX needed)."""

import pytest
import torch

from streamspeech_tpu_torch.config import OptimizationConfig, tiny_config
from streamspeech_tpu_torch.models.conformer import ChunkConformerEncoder
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel


def test_model_raises_on_a_dtype_other_than_float32():
    """float32 and bfloat16 are the compute dtypes the kernels take; any other
    raises. ``cfg.dtype`` is read by nothing, as in the JAX package."""
    with pytest.raises(NotImplementedError, match="float32 and bfloat16"):
        StreamSpeechModel(tiny_config(), dtype=torch.float16)
    cfg = tiny_config()
    cfg.dtype = "bfloat16"
    assert StreamSpeechModel(cfg).dtype == torch.float32
    bf16 = StreamSpeechModel(tiny_config(), dtype=torch.bfloat16)
    assert {p.dtype for p in bf16.parameters()} == {torch.float32}


def test_encoder_raises_on_speaker_embed_dim():
    cfg = tiny_config()
    cfg.encoder.speaker_embed_dim = 64
    with pytest.raises(NotImplementedError, match="spk_emb_proj"):
        ChunkConformerEncoder(cfg.encoder)
    with pytest.raises(NotImplementedError, match="spk_emb_proj"):
        StreamSpeechModel(cfg)


def test_tiny_config_still_builds():
    cfg = tiny_config()
    assert cfg.dtype == "float32" and cfg.encoder.speaker_embed_dim is None
    model = StreamSpeechModel(cfg)
    assert sum(p.numel() for p in model.parameters()) > 0


def test_optimizer_dtype_keeps_the_jax_default():
    # read by nothing in either package: the step computes in the model's dtype
    assert OptimizationConfig().dtype == "bfloat16"


def test_train_step_raises_on_a_bf16_model():
    """A bf16 model now trains (its step is held to JAX's in
    ``tests/test_torch_bf16_train.py``); what raises is a model whose
    parameters were cast for serving, and a dtype other than float32 or
    bfloat16."""
    from streamspeech_tpu_torch.models.layers import cast_compute_weights_
    from streamspeech_tpu_torch.train.trainer import make_optimizer, make_train_step

    cfg = tiny_config()
    tx = make_optimizer(OptimizationConfig(update_freq=1))
    model = StreamSpeechModel(cfg, dtype=torch.bfloat16)
    make_train_step(model, tx, unit_blank=cfg.unit_decoder.vocab_size - 1)
    with pytest.raises(ValueError, match="cast for serving"):
        make_train_step(cast_compute_weights_(model), tx,
                        unit_blank=cfg.unit_decoder.vocab_size - 1)
    other = StreamSpeechModel(cfg)
    other.dtype = torch.float16
    with pytest.raises(NotImplementedError, match="float32 or bfloat16"):
        make_train_step(other, tx, unit_blank=cfg.unit_decoder.vocab_size - 1)
