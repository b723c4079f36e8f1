"""Model loading for the port's CLIs (``streamspeech_tpu/cli/generate.py:25-65``,
``load_model``): a released fairseq StreamSpeech ``.pt`` (its config inferred
from the checkpoint's shapes) or a native checkpoint of the port's training
CLI (its config from the save directory's ``config.json``) → the port's model.
The offline generation CLI itself (JAX ``main`` with ``generation.py``'s
``OfflineGenerator``) and ensemble decoding (``EnsembleGenerator``) are not
ported yet (ROADMAP §A item 7)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple

from streamspeech_tpu_torch.config import StreamSpeechConfig, full_config
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.train.checkpoint import (
    import_fairseq_streamspeech,
    infer_config_from_params,
    load_model_ensemble,
)
from streamspeech_tpu_torch.weights import load_flax_variables


def config_from_json(path: Path) -> StreamSpeechConfig:
    """The model config a training run saved beside its checkpoints
    (``config.json``), over ``simul_s2st``'s defaults, as JAX's
    ``load_model`` reads it; without the file, ``full_config``."""
    if not path.exists():
        return full_config()
    raw = json.loads(path.read_text())
    cfg = StreamSpeechConfig.simul_s2st()
    for section in ("encoder", "mt_decoder", "unit_decoder"):
        for k, v in raw.get(section, {}).items():
            if hasattr(getattr(cfg, section), k):
                setattr(getattr(cfg, section), k, v)
    for k in ("synthesizer_encoder_layers", "translation_decoder_layers",
              "target_code_size", "source_unigram_vocab", "ctc_target_unigram_vocab"):
        if k in raw:
            setattr(cfg, k, raw[k])
    return cfg


def load_model(args) -> Tuple[StreamSpeechModel, StreamSpeechConfig]:
    """(model on the CPU, its config) from ``args.fairseq_checkpoint`` or from
    ``args.checkpoint`` (a native checkpoint directory; comma-separated paths,
    an ensemble, raise)."""
    if getattr(args, "fairseq_checkpoint", None):
        params, batch_stats, _ = import_fairseq_streamspeech(args.fairseq_checkpoint)
        cfg = infer_config_from_params(params, batch_stats)
        model = load_flax_variables(StreamSpeechModel(cfg),
                                    {"params": params, "batch_stats": batch_stats})
        return model, cfg
    if getattr(args, "checkpoint", None):
        paths = [p for p in args.checkpoint.split(",") if p]
        if len(paths) > 1:
            raise NotImplementedError(
                "ensemble decoding (comma-separated --checkpoint paths): "
                "EnsembleGenerator is not ported yet (ROADMAP §A item 7)")
        cfg = config_from_json(Path(paths[0]).parent / "config.json")
        (variables,) = load_model_ensemble(paths)
        return load_flax_variables(StreamSpeechModel(cfg), variables), cfg
    raise SystemExit("need --checkpoint or --fairseq-checkpoint")


if __name__ == "__main__":
    raise SystemExit("the offline generation CLI is not ported yet (ROADMAP §A item 7)")
