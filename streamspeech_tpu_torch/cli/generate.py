"""Offline batch inference CLI, the port of ``streamspeech_tpu/cli/generate.py``
(the fairseq-generate equivalent, `fairseq_cli/generate.py:28-201` driving
`CTCMultiDecoderSequenceGenerator`).

Reads a manifest (or wav list), loads a released fairseq StreamSpeech ``.pt``
(its config inferred from the checkpoint's shapes) or native checkpoints of
the port's ``cli.train`` (the config from the save directory's
``config.json``; comma-separated paths decode as an ensemble), and writes per
utterance the ``A-`` (ASR), ``D-`` (MT) and ``U-`` (units) lines, ``units.txt``
and, with ``--vocoder``, ``<id>_pred.wav`` — the output surface the
reference's `pred.offline-s2st.sh` postprocesses:

    python -m streamspeech_tpu_torch.cli.generate --manifest wav_list.txt \\
        --fairseq-checkpoint streamspeech.simultaneous.fr-en.pt --beam 10 \\
        --src-dict spm_unigram_fr.txt --tgt-dict spm_unigram_en.txt --output out/

The model runs on the card; ``--cpu`` runs it on the CPU, and without a card
and without ``--cpu`` the CLI raises.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Tuple, Union

import torch

from streamspeech_tpu_torch.config import StreamSpeechConfig, full_config
from streamspeech_tpu_torch.data.dataset import load_audio_or_features
from streamspeech_tpu_torch.dictionary import Dictionary
from streamspeech_tpu_torch.eval.instance import write_wav
from streamspeech_tpu_torch.generation import EnsembleGenerator, OfflineGenerator
from streamspeech_tpu_torch.models.streamspeech import StreamSpeechModel
from streamspeech_tpu_torch.ops.fbank import logmelfbank
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


def load_model(args) -> Tuple[Union[StreamSpeechModel, List[StreamSpeechModel]],
                               StreamSpeechConfig]:
    """(model on the CPU, its config) from ``args.fairseq_checkpoint`` or from
    ``args.checkpoint``, a native checkpoint directory; comma-separated
    checkpoint paths are an ensemble (fairseq-generate ``--path a.pt:b.pt``,
    `fairseq/fairseq/checkpoint_utils.py:288`): then a list of models, one a
    member, all of the first path's config."""
    if getattr(args, "fairseq_checkpoint", None):
        params, batch_stats, _ = import_fairseq_streamspeech(args.fairseq_checkpoint)
        cfg = infer_config_from_params(params, batch_stats)
        model = load_flax_variables(StreamSpeechModel(cfg),
                                    {"params": params, "batch_stats": batch_stats})
        return model, cfg
    if getattr(args, "checkpoint", None):
        paths = [p for p in args.checkpoint.split(",") if p]
        cfg = config_from_json(Path(paths[0]).parent / "config.json")
        # strict loads: a member of another structure raises
        models = [load_flax_variables(StreamSpeechModel(cfg), v)
                  for v in load_model_ensemble(paths)]
        return (models if len(models) > 1 else models[0]), cfg
    raise SystemExit("need --checkpoint or --fairseq-checkpoint")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--checkpoint", type=str, default=None,
                   help="native checkpoint directories of cli.train, comma-separated "
                        "for an ensemble")
    p.add_argument("--fairseq-checkpoint", type=str, default=None)
    p.add_argument("--model-config", type=str, default=None)
    p.add_argument("--manifest", type=str, required=True,
                   help="tsv manifest or newline list of wav/npy paths")
    p.add_argument("--src-dict", type=str, default=None)
    p.add_argument("--tgt-dict", type=str, default=None)
    p.add_argument("--beam", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=1,
                   help="batched greedy decoding (beam must be 1)")
    p.add_argument("--max-len", type=int, default=200)
    p.add_argument("--lenpen", type=float, default=1.0)
    p.add_argument("--cpu", action="store_true", default=False,
                   help="run the model on the CPU (default: the card)")
    p.add_argument("--output", type=str, default=None)
    p.add_argument("--vocoder", type=str, default=None)
    p.add_argument("--vocoder-cfg", type=str, default=None)
    return p


def _read_manifest(manifest: Path) -> List[Tuple[str, str]]:
    """(utterance id, audio reference) pairs of a tsv manifest (its ``id`` and
    ``src_audio`` columns) or of a list of paths (ids 0, 1, ...)."""
    refs = []
    if manifest.suffix == ".tsv":
        with open(manifest) as f:
            header = f.readline().rstrip().split("\t")
            col = {n: i for i, n in enumerate(header)}
            for line in f:
                row = line.rstrip("\n").split("\t")
                refs.append((row[col["id"]], row[col["src_audio"]]))
    else:
        for i, line in enumerate(manifest.read_text().splitlines()):
            if line.strip():
                refs.append((str(i), line.strip()))
    return refs


def main(argv=None):
    """Run the CLI; returns {utterance id: the generator's result}."""
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if not args.cpu and not torch.cuda.is_available():
        raise RuntimeError("generate: no CUDA device is available; pass --cpu to run "
                           "the model on the CPU")
    model, _ = load_model(args)
    kw = dict(beam=args.beam, max_len=args.max_len, len_penalty=args.lenpen,
              device=device)
    gen = (EnsembleGenerator(model, **kw) if isinstance(model, list)
           else OfflineGenerator(model, **kw))
    src_dict = Dictionary.load(args.src_dict) if args.src_dict else None
    tgt_dict = Dictionary.load(args.tgt_dict) if args.tgt_dict else None

    vocoder = None
    if args.vocoder:
        from streamspeech_tpu_torch.models.vocoder import CodeGenerator
        from streamspeech_tpu_torch.train.checkpoint import import_hifigan_vocoder
        from streamspeech_tpu_torch.weights import load_flax_vocoder

        voc_vars, voc_cfg = import_hifigan_vocoder(args.vocoder, args.vocoder_cfg)
        vocoder = load_flax_vocoder(CodeGenerator(voc_cfg), voc_vars).to(device).eval()

    out_dir = Path(args.output) if args.output else None
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
    unit_f = open(out_dir / "units.txt", "w") if out_dir else None
    manifest = Path(args.manifest)
    refs = _read_manifest(manifest)
    results = {}

    def emit_result(utt_id, out):
        results[utt_id] = out
        asr = src_dict.string(out["asr_tokens"], spm_to_text=True) \
            if src_dict else " ".join(map(str, out["asr_tokens"]))
        mt = tgt_dict.string(out["mt_tokens"], spm_to_text=True) \
            if tgt_dict else " ".join(map(str, out["mt_tokens"]))
        units = [u - 4 for u in out["units"]]
        print(f"A-{utt_id}\t{asr}")
        print(f"D-{utt_id}\t{mt}")
        print(f"U-{utt_id}\t{' '.join(map(str, units))}")
        if unit_f:
            unit_f.write(" ".join(map(str, units)) + "\n")
        if vocoder is not None and units and out_dir:
            with torch.no_grad():
                wav, n, _ = vocoder(torch.tensor([units], device=gen.device),
                                    max_frames=4 * len(units))
            write_wav(out_dir / f"{utt_id}_pred.wav",
                      wav[0][: int(n[0])].float().cpu().numpy(), 16000)

    def load_feats(ref):
        x = load_audio_or_features(ref, manifest.parent)
        return logmelfbank(x) if x.ndim == 1 else x

    try:
        if args.batch_size > 1 and args.beam == 1:
            for i in range(0, len(refs), args.batch_size):
                chunk = refs[i: i + args.batch_size]
                outs = gen.generate_batch_greedy([load_feats(r) for _, r in chunk],
                                                 max_tokens=min(args.max_len, 64))
                for (utt_id, _), out in zip(chunk, outs):
                    emit_result(utt_id, out)
        else:
            for utt_id, ref in refs:
                emit_result(utt_id, gen.generate(load_feats(ref)))
    finally:
        if unit_f:
            unit_f.close()
    return results


if __name__ == "__main__":
    main()
