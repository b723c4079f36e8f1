"""The learnability golden of the port on one CUDA card.

    python3 tools/run_learnability_golden.py [--max-update 2000] [--workdir DIR]
                                             [--out chiprun_out/golden.json]

Runs ``streamspeech_tpu_torch.data.toy_task.run_learnability_golden(device=
"cuda")``: the toy task written to ``--workdir`` (a temporary directory,
removed after, by default), the port's ``cli.train``
(tiny dims, the kernel train route, ``STREAMSPEECH_PALLAS_TRAIN=1``) for
``--max-update`` updates, then the untrained and the trained checkpoint
evaluated streaming (``cli.simuleval --agent s2tt`` for the text, the
streaming S2ST agent for the units), every stage its own process on the card.
Prints one JSON line (also written to ``--out``) with both score sets, the
gates of ``tests/test_learnability.py`` (each gate's value and whether it
holds), the wall seconds, and the card's ``nvidia-smi`` name and power limit;
exits 1 if a gate fails.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def gates(res):
    """``tests/test_learnability.py``'s gates: (name, value, holds)."""
    u, t = res["untrained"], res["trained"]
    return [("untrained unit_edit_rate > 0.6", u["unit_edit_rate"], u["unit_edit_rate"] > 0.6),
            ("trained unit_edit_rate < 0.3", t["unit_edit_rate"], t["unit_edit_rate"] < 0.3),
            ("trained unit_edit_rate < 0.5 * untrained",
             t["unit_edit_rate"] / max(u["unit_edit_rate"], 1e-30),
             t["unit_edit_rate"] < 0.5 * u["unit_edit_rate"]),
            ("trained text_token_acc > 0.8", t["text_token_acc"], t["text_token_acc"] > 0.8),
            ("trained BLEU > 30", t.get("BLEU", 0.0), t.get("BLEU", 0.0) > 30.0),
            ("trained AL finite", t.get("AL"), math.isfinite(t.get("AL", math.nan)))]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--max-update", type=int, default=2000)
    p.add_argument("--workdir", type=str, default=None)
    p.add_argument("--out", type=str, default="chiprun_out/golden.json")
    args = p.parse_args(argv)
    from streamspeech_tpu_torch.data.toy_task import run_learnability_golden

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        res = run_learnability_golden(args.workdir or tmp, max_update=args.max_update,
                                      device="cuda", verbose=True)
    wall = time.perf_counter() - t0
    checked = gates(res)
    line = json.dumps({"golden": res, "max_update": args.max_update, "wall_s": wall,
                       "gates": [{"gate": g, "value": v, "holds": bool(ok)}
                                 for g, v, ok in checked],
                       "nvidia_smi": smi.strip()}, default=float)
    print(line, flush=True)
    out = REPO / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(line + "\n")
    print(smi.strip(), flush=True)
    return 0 if all(ok for _, _, ok in checked) else 1


if __name__ == "__main__":
    sys.exit(main())
