"""Model loading for the port's CLIs (``streamspeech_tpu/cli/generate.py:25-65``,
``load_model``): a released fairseq StreamSpeech ``.pt`` → the port's model,
its config inferred from the checkpoint's shapes. The offline generation
CLI itself (JAX ``main`` with ``generation.py``'s ``OfflineGenerator``) is not
ported yet (ROADMAP §A item 7), nor are the native (orbax) checkpoints of
``--checkpoint`` (ROADMAP §A item 5)."""

from __future__ import annotations

from typing import Tuple

from streamspeech_tpu_torch.config import StreamSpeechConfig
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.train.checkpoint import (
    import_fairseq_streamspeech,
    infer_config_from_params,
)
from streamspeech_tpu_torch.weights import load_flax_variables


def load_model(args) -> Tuple[StreamSpeechModel, StreamSpeechConfig]:
    """(model on the CPU, its config) from ``args.fairseq_checkpoint``;
    ``args.checkpoint`` (a native orbax checkpoint) raises."""
    if getattr(args, "fairseq_checkpoint", None):
        params, batch_stats, _ = import_fairseq_streamspeech(args.fairseq_checkpoint)
        cfg = infer_config_from_params(params, batch_stats)
        model = load_flax_variables(StreamSpeechModel(cfg),
                                    {"params": params, "batch_stats": batch_stats})
        return model, cfg
    if getattr(args, "checkpoint", None):
        raise NotImplementedError(
            "--checkpoint (a native orbax checkpoint) is not ported yet (ROADMAP §A "
            "item 5); pass a fairseq .pt with --fairseq-checkpoint")
    raise SystemExit("need --fairseq-checkpoint (or --checkpoint)")


if __name__ == "__main__":
    raise SystemExit("the offline generation CLI is not ported yet (ROADMAP §A item 7)")
