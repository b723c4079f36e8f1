"""Model-architecture, data and training dataclasses.

Field for field the same as ``streamspeech_tpu/config.py`` (a test holds names
and defaults equal). The data configs (``S2SDataConfig``, ``MultitaskConfig``)
read their YAML files through ``load_yaml``, a reader of the subset of YAML
that fairseq's data configs use, since PyYAML is not a dependency of the port.
``full_config`` and ``tiny_config`` mirror ``streamspeech_tpu/train/synthetic.py``.
"""

from __future__ import annotations

import dataclasses
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple


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


# ---------------------------------------------------------------------------
# Data configs (YAML)
# ---------------------------------------------------------------------------


class YamlSubsetError(ValueError):
    """A YAML construct outside the subset that ``load_yaml`` reads."""


# PyYAML's implicit resolvers (YAML 1.1) for the forms this reader accepts
_NULL = re.compile(r"(?:~|null|Null|NULL)$")
_BOOL = {**dict.fromkeys("yes Yes YES true True TRUE on On ON".split(), True),
         **dict.fromkeys("no No NO false False FALSE off Off OFF".split(), False)}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# forms PyYAML resolves that this reader does not: binary, octal, hex and
# sexagesimal numbers
_OTHER_NUMBER = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|0x[0-9a-fA-F_]+"
                           r"|[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?)$")


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (a ``#`` at the start or after a
    space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str) -> Any:
    """A plain, quoted, int, float, bool or null scalar, or a ``[a, b]`` flow
    list of them, resolved as ``yaml.safe_load`` resolves them."""
    t = text.strip()
    if not t or _NULL.match(t):
        return None
    if t[0] in "&*!|>{%@`":
        raise YamlSubsetError(f"unsupported YAML construct: {t!r}")
    if t[0] == "[":
        if not t.endswith("]"):
            raise YamlSubsetError(f"unterminated flow list: {t!r}")
        inner = t[1:-1].strip()
        return [] if not inner else [_scalar(x) for x in _split_flow(inner)]
    if t[0] in "'\"":
        if len(t) < 2 or t[-1] != t[0]:
            raise YamlSubsetError(f"unterminated quoted scalar: {t!r}")
        body = t[1:-1]
        if t[0] == "'":
            return body.replace("''", "'")
        if "\\" in body:
            return body.encode("utf-8").decode("unicode_escape")
        return body
    if t in _BOOL:
        return _BOOL[t]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    m = _INF.match(t)
    if m:
        return float("-inf") if m.group(1) == "-" else float("inf")
    if _NAN.match(t):
        return float("nan")
    if _OTHER_NUMBER.match(t):
        raise YamlSubsetError(f"unsupported number form: {t!r}")
    return t


def _split_flow(inner: str) -> List[str]:
    parts, depth, quote, cur = [], 0, None, ""
    for ch in inner:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
            continue
        cur += ch
    parts.append(cur)
    return parts


def _key_value(text: str) -> Optional[Tuple[str, str]]:
    """``key: value`` → (key, value text); None when the text is not a mapping
    entry. A colon counts only when followed by a space or the line's end."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"" and i == 0:
            quote = ch
        elif ch == ":" and (i + 1 == len(text) or text[i + 1] in " \t"):
            key = text[:i].strip()
            if key[:1] in "'\"":
                key = _scalar(key)
            return str(key), text[i + 1:].strip()
    return None


def load_yaml(text: str) -> Any:
    """Parse the YAML subset of fairseq's data configs: block mappings nested
    by indentation, ``- item`` lists, ``[a, b]`` flow lists, plain, quoted,
    int, float, bool and null scalars, and ``#`` comments. Anything else
    (anchors, aliases, tags, multi-line strings, flow mappings, documents)
    raises ``YamlSubsetError``. An empty document is None, as in PyYAML."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError("tab in indentation")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line.strip() in ("---", "...") or line.startswith("%"):
            raise YamlSubsetError(f"unsupported YAML construct: {line.strip()!r}")
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    value, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise YamlSubsetError(f"unexpected indentation at {lines[pos][1]!r}")
    return value


def _block(lines, pos: int, indent: int):
    """The node whose lines start at ``pos`` with indentation ``indent``."""
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        out: List[Any] = []
        while pos < len(lines) and lines[pos][0] == indent and (
                lines[pos][1].startswith("- ") or lines[pos][1] == "-"):
            rest = lines[pos][1][1:].strip()
            pos += 1
            if rest:
                if _key_value(rest) is not None:
                    # "- key: value" opens a mapping at the item's column
                    sub = [(indent + 2, rest)]
                    while pos < len(lines) and lines[pos][0] > indent:
                        sub.append(lines[pos])
                        pos += 1
                    item, _ = _block(sub, 0, indent + 2)
                    out.append(item)
                else:
                    out.append(_scalar(rest))
            elif pos < len(lines) and lines[pos][0] > indent:
                item, pos = _block(lines, pos, lines[pos][0])
                out.append(item)
            else:
                out.append(None)
        return out, pos
    mapping: Dict[str, Any] = {}
    while pos < len(lines) and lines[pos][0] == indent:
        kv = _key_value(lines[pos][1])
        if kv is None:
            raise YamlSubsetError(f"expected 'key: value' at {lines[pos][1]!r}")
        key, rest = kv
        pos += 1
        if rest:
            mapping[key] = _scalar(rest)
        elif pos < len(lines) and (lines[pos][0] > indent or (
                lines[pos][0] == indent and lines[pos][1].startswith("-"))):
            mapping[key], pos = _block(lines, pos, lines[pos][0])
        else:
            mapping[key] = None
    return mapping, pos


def _load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return load_yaml(f.read()) or {}


@dataclass
class S2SDataConfig:
    """Parsed config_gcmvn.yaml. Paths are resolved relative to the yaml dir when
    the absolute path recorded at preprocessing time does not exist (the reference
    hardcodes the author's machine paths)."""

    yaml_dir: Path = field(default_factory=Path)
    input_feat_per_channel: int = 80
    input_channels: int = 1
    global_cmvn_stats_npz: Optional[str] = None
    transforms: Dict[str, List[str]] = field(default_factory=dict)
    specaugment: Dict[str, Any] = field(default_factory=dict)
    vocoder_checkpoint: Optional[str] = None
    vocoder_config: Optional[str] = None
    vocoder_type: str = "code_hifigan"
    target_sample_rate: int = 16000

    def _resolve(self, p: Optional[str]) -> Optional[str]:
        if p is None:
            return None
        if Path(p).exists():
            return p
        cand = self.yaml_dir / Path(p).name
        return str(cand) if cand.exists() else p

    @classmethod
    def load(cls, path: str) -> "S2SDataConfig":
        raw = _load_yaml(path)
        cfg = cls(yaml_dir=Path(path).parent)
        cfg.input_feat_per_channel = raw.get("input_feat_per_channel", 80)
        cfg.input_channels = raw.get("input_channels", 1)
        gc = raw.get("global_cmvn") or {}
        cfg.global_cmvn_stats_npz = cfg._resolve(gc.get("stats_npz_path"))
        cfg.transforms = raw.get("transforms", {})
        cfg.specaugment = raw.get("specaugment", {})
        voc = raw.get("vocoder") or {}
        cfg.vocoder_checkpoint = cfg._resolve(voc.get("checkpoint"))
        cfg.vocoder_config = cfg._resolve(voc.get("config"))
        cfg.vocoder_type = voc.get("type", "code_hifigan")
        return cfg

    def get_transforms(self, split: str) -> List[str]:
        # reference semantics (`data_cfg.py:35`): "_train" key for train splits,
        # "*" for everything else.
        key = "_train" if split.startswith("train") else "*"
        return self.transforms.get(key, self.transforms.get("*", []))


@dataclass
class MultitaskConfig:
    """Parsed config_mtl_asr_st_ctcst.yaml: one MultitaskTaskConfig per top-level key."""

    tasks: Dict[str, MultitaskTaskConfig] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "MultitaskConfig":
        raw = _load_yaml(path)
        yaml_dir = Path(path).parent
        cfg = cls()
        for name, body in raw.items():
            dargs = body.get("decoder_args", {}) or {}
            t = MultitaskTaskConfig(
                task_name=name,
                decoder_type=body.get("decoder_type", "ctc"),
                dict_path=str(body.get("dict", "")),
                data=str(body.get("data", "")),
                loss_weight=float(body.get("loss_weight", 1.0)),
                rdrop_alpha=float(body.get("rdrop_alpha", 0.0)),
                label_smoothing=float(body.get("label_smoothing", 0.1)),
                decoder_layers=int(dargs.get("decoder_layers", 0)),
                decoder_embed_dim=int(dargs.get("decoder_embed_dim", 512)),
                decoder_ffn_embed_dim=int(dargs.get("decoder_ffn_embed_dim", 2048)),
                decoder_attention_heads=int(dargs.get("decoder_attention_heads", 8)),
                input_from=body.get("input_from", "encoder"),
                # reference convention: the transformer-decoder aux task is the
                # first-pass MT decoder (`tasks/speech_to_speech.py:212-246`)
                is_first_pass_decoder=body.get("decoder_type") == "transformer",
            )
            if t.dict_path and not Path(t.dict_path).exists():
                cand = yaml_dir / Path(t.dict_path).parent.name / Path(t.dict_path).name
                if cand.exists():
                    t.dict_path = str(cand)
            cfg.tasks[name] = t
        return cfg


# ---------------------------------------------------------------------------
# Training config
# ---------------------------------------------------------------------------


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


def to_dict(cfg) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


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
