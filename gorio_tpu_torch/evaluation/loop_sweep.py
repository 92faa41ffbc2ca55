"""Gate-policy sweep over recorded loop-replay pickles: `scripts/loop_sweep.py`
on the port.

Runs `loop_replay.replay` for each `LoopConfig` override combo against one
or more recordings (either package's) and prints one JSON line per
(recording, combo) with the script's keys: region recall, precision, gate
counts.

    python -m gorio_tpu_torch.evaluation.loop_sweep --rec REC.pkl [--rec REC2.pkl]
        [--combos FILE.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import pickle
from pathlib import Path

DEFAULT_COMBOS = [
    {},
    {"ellipse_base": 3.0},
    {"ellipse_base": 3.0, "pairwise_nearest": False},
    {"pairwise_nearest": False},
    {"pairwise_nearest": False, "fallback_max_trans": 6.5},
    {"pairwise_nearest": False, "min_loop_interval_dist": 5.0},
    {"pairwise_nearest": False, "fallback_max_trans": 6.5,
     "min_loop_interval_dist": 5.0},
    {"ellipse_base": 3.0, "pairwise_nearest": False,
     "fallback_max_trans": 6.5, "min_loop_interval_dist": 5.0},
]


def sweep(rec_path, combos=DEFAULT_COMBOS, device="cuda"):
    """Yield the JSON line of each combo replayed on one recording."""
    from .loop_replay import replay, summary

    with open(rec_path, "rb") as fh:
        rec = pickle.load(fh)
    for ov in combos:
        det, loops = replay(rec, ov, device)
        s = summary(rec, det, loops)
        yield {
            "rec": str(rec_path),
            "overrides": ov,
            "n_loops": s["n_loops"],
            "n_false": s["n_false"],
            "recall_regions": s["recall_regions"],
            "n_regions_covered": s["n_regions_covered"],
            "n_regions": s["n_regions"],
            "gate_counts": s["gate_counts"],
        }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rec", action="append", required=True)
    ap.add_argument("--combos", default=None,
                    help="JSON file with a list of override dicts")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    combos = DEFAULT_COMBOS
    if args.combos:
        combos = json.loads(Path(args.combos).read_text())
    for rec_path in args.rec:
        for line in sweep(rec_path, combos, args.device):
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
