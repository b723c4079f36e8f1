"""The port raises on configuration fields it does not implement, rather than
computing something other than the JAX package would (no JAX needed)."""

import pytest

from streamspeech_tpu_torch.config import OptimizationConfig, tiny_config
from streamspeech_tpu_torch.models.conformer import ChunkConformerEncoder
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel


def test_model_raises_on_a_dtype_other_than_float32():
    cfg = tiny_config()
    cfg.dtype = "bfloat16"
    with pytest.raises(NotImplementedError, match="float32"):
        StreamSpeechModel(cfg)


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
    # read by nothing in the port: the train step computes in float32
    assert OptimizationConfig().dtype == "bfloat16"
