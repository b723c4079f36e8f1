"""Checkpoint averaging CLI (the port of
``streamspeech_tpu/cli/average_checkpoints.py``, `fairseq/scripts/
average_checkpoints.py`) over the port's native checkpoints. It runs on the
host: the checkpoints are CPU tensors.

python -m streamspeech_tpu_torch.cli.average_checkpoints \\
    --inputs /ck/checkpoint_10 /ck/checkpoint_20 --output /ck/averaged
python -m streamspeech_tpu_torch.cli.average_checkpoints \\
    --inputs /ck --num-last 5 --output /ck/averaged
"""

import argparse
from pathlib import Path

from streamspeech_tpu_torch.train.checkpoint import (
    STATE_FILE,
    average_checkpoints,
    save_payload,
)


def collect_inputs(inputs, num_last=None):
    if len(inputs) == 1 and Path(inputs[0]).is_dir() and \
            not (Path(inputs[0]) / STATE_FILE).exists():
        d = Path(inputs[0])
        ckpts = sorted(d.glob("checkpoint_*"),
                       key=lambda p: int(p.name.split("_")[-1]))
        if not ckpts:
            raise FileNotFoundError(f"no checkpoint_* under {d}")
        if num_last:
            ckpts = ckpts[-num_last:]
        return [str(p) for p in ckpts]
    return list(inputs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--inputs", nargs="+", required=True,
                   help="checkpoint paths, or one save dir (see --num-last)")
    p.add_argument("--num-last", type=int, default=None,
                   help="with a single save-dir input: average the last N")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    paths = collect_inputs(args.inputs, args.num_last)
    print(f"averaging {len(paths)} checkpoints:")
    for path in paths:
        print(f"  {path}")
    out = save_payload(args.output, average_checkpoints(paths))
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
