"""Model-architecture and training dataclasses, without any YAML loader.

Field for field the same as ``streamspeech_tpu/config.py`` (a test holds names
and defaults equal); the data/multitask YAML parsers stay in the JAX package.
``full_config`` and ``tiny_config`` mirror ``streamspeech_tpu/train/synthetic.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class EncoderConfig:
    """Chunk Conformer encoder (`researches/chunk_unity/models/s2t_conformer.py:37`)."""

    input_feat_per_channel: int = 80
    input_channels: int = 1
    conv_kernel_sizes: List[int] = field(default_factory=lambda: [5, 5])
    conv_channels: int = 1024
    embed_dim: int = 256
    ffn_embed_dim: int = 2048
    layers: int = 16
    attention_heads: int = 4
    depthwise_conv_kernel_size: int = 31
    pos_enc_type: str = "rel_pos"
    attn_type: str = "espnet"
    max_source_positions: int = 6000
    dropout: float = 0.1
    chunk_size: Optional[int] = 8
    unidirectional: bool = True
    no_scale_embedding: bool = False
    speaker_embed_dim: Optional[int] = None
    remat: bool = False


@dataclass
class DecoderConfig:
    """Transformer decoder tower (MT first pass)."""

    embed_dim: int = 512
    ffn_embed_dim: int = 2048
    layers: int = 4
    attention_heads: int = 8
    dropout: float = 0.1
    max_target_positions: int = 1024
    share_input_output_embed: bool = True
    learned_pos: bool = False
    normalize_before: bool = True
    no_scale_embedding: bool = False
    layernorm_embedding: bool = False
    vocab_size: int = 0
    base_layers: int = 0
    base_num_experts: int = 8


@dataclass
class UnitDecoderConfig:
    """NAR upsampling unit-CTC decoder
    (`researches/ctc_unity/modules/ctc_transformer_unit_decoder.py:25`)."""

    embed_dim: int = 512
    ffn_embed_dim: int = 2048
    layers: int = 2
    attention_heads: int = 8
    dropout: float = 0.1
    ctc_upsample_rate: int = 25
    n_frames_per_step: int = 1
    max_target_positions: int = 8192
    vocab_size: int = 0
    remat: bool = False


@dataclass
class MultitaskTaskConfig:
    """One aux task from config_mtl_asr_st_ctcst.yaml (`data_cfg.py:244`)."""

    task_name: str = ""
    decoder_type: str = "ctc"
    dict_path: str = ""
    data: str = ""
    loss_weight: float = 1.0
    rdrop_alpha: float = 0.0
    label_smoothing: float = 0.1
    decoder_layers: int = 0
    decoder_embed_dim: int = 512
    decoder_ffn_embed_dim: int = 2048
    decoder_attention_heads: int = 8
    input_from: str = "encoder"
    is_first_pass_decoder: bool = False


@dataclass
class StreamSpeechConfig:
    """Full model assembly (`researches/ctc_unity/models/streamspeech_model.py:57`)."""

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    mt_decoder: DecoderConfig = field(default_factory=DecoderConfig)
    unit_decoder: UnitDecoderConfig = field(default_factory=UnitDecoderConfig)
    synthesizer_encoder_layers: int = 2
    translation_decoder_layers: int = 4
    target_code_size: int = 1000
    multitasks: List[MultitaskTaskConfig] = field(default_factory=list)
    source_unigram_vocab: int = 0
    ctc_target_unigram_vocab: int = 0
    cascade: bool = False
    t2u_augmented_cross_attn: bool = False
    # read by nothing, as in the JAX package: the compute dtype is
    # StreamSpeechModel's ``dtype`` argument (float32 or bfloat16)
    dtype: str = "float32"

    @classmethod
    def simul_s2st(cls) -> "StreamSpeechConfig":
        """train.simul-s2st.sh hyperparameters."""
        cfg = cls()
        cfg.encoder.chunk_size = 8
        cfg.encoder.unidirectional = True
        cfg.unit_decoder.ctc_upsample_rate = 25
        return cfg


@dataclass
class OptimizationConfig:
    """train.simul-s2st.sh: Adam(0.9,0.98) lr 1e-3 inverse_sqrt warmup 10k, clip 10.

    ``dtype`` keeps the JAX default, ``"bfloat16"``, so that a configuration
    reads the same in both packages. Neither package reads it: the train step
    computes in the model's dtype, ``StreamSpeechModel(cfg, dtype=...)``
    (``jnp.bfloat16`` in ``measure_train_step``), with float32 parameters and
    optimizer state either way."""

    lr: float = 1e-3
    adam_betas: tuple = (0.9, 0.98)
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    warmup_updates: int = 10000
    warmup_init_lr: float = 1e-7
    lr_scheduler: str = "inverse_sqrt"
    clip_norm: float = 10.0
    max_update: int = 100000
    update_freq: int = 2
    max_tokens: int = 22000
    label_smoothing: float = 0.1
    dtype: str = "bfloat16"  # read by nothing: the port's train step runs float32
    # (bf16 training is ROADMAP §A item 4)


@dataclass
class TrainingConfig:
    model: StreamSpeechConfig = field(default_factory=StreamSpeechConfig.simul_s2st)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    seed: int = 1
    save_dir: str = "checkpoints"
    save_interval_updates: int = 1000
    keep_last_checkpoints: int = 10
    log_interval: int = 100
    # streaming-mask training (train.simul-s2st.sh: --k1 0 --k2 0 --n1 1 --n2 -1)
    k1: int = 0
    k2: int = 0
    n1: int = 1
    n2: int = -1
    multichunk: bool = True
    # parallelism
    mesh_shape: Dict[str, int] = field(default_factory=lambda: {"data": 1})
    fsdp: bool = False


def tiny_config(vocab_text: int = 32, vocab_units: int = 24,
                upsample: int = 4) -> StreamSpeechConfig:
    """Small widths for CPU tests (same values as the JAX package's)."""
    cfg = StreamSpeechConfig.simul_s2st()
    cfg.encoder.layers = 2
    cfg.encoder.embed_dim = 32
    cfg.encoder.ffn_embed_dim = 64
    cfg.encoder.attention_heads = 2
    cfg.encoder.conv_channels = 64
    cfg.encoder.depthwise_conv_kernel_size = 7
    cfg.mt_decoder.layers = 2
    cfg.mt_decoder.embed_dim = 32
    cfg.mt_decoder.ffn_embed_dim = 64
    cfg.mt_decoder.attention_heads = 2
    cfg.mt_decoder.vocab_size = vocab_text
    cfg.unit_decoder.layers = 1
    cfg.unit_decoder.embed_dim = 32
    cfg.unit_decoder.ffn_embed_dim = 64
    cfg.unit_decoder.attention_heads = 2
    cfg.unit_decoder.ctc_upsample_rate = upsample
    cfg.unit_decoder.vocab_size = vocab_units
    cfg.synthesizer_encoder_layers = 1
    cfg.source_unigram_vocab = vocab_text
    cfg.ctc_target_unigram_vocab = vocab_text
    return cfg


def full_config() -> StreamSpeechConfig:
    """The real simul-s2st architecture (train.simul-s2st.sh): 12L conformer d256,
    4L MT decoder d512 h8, 2L T2U, 2L unit decoder, upsample 25, units 1000+blank,
    text vocab 6000."""
    cfg = StreamSpeechConfig.simul_s2st()
    cfg.encoder.layers = 12
    cfg.mt_decoder.vocab_size = 6000
    cfg.unit_decoder.vocab_size = 1005  # 4 specials + 1000 units + <blank>
    cfg.source_unigram_vocab = 6000
    cfg.ctc_target_unigram_vocab = 6000
    return cfg
