"""Stored-accuracy sequences on the port: `scripts/accuracy_benchmark.py`
on the port's CLI.

Three deterministic synthetic sequences run the full stack (the fused
frontend with the preprocessing chain, UGPM, the floor constraint, loop
closure, GPS with a dropout window and outliers, zero-velocity stops,
Doppler-inconsistent moving objects):

  straight — 40 s, 5 Hz, 2 zero-velocity dwells, 4 moving objects, GPS
             (2 Hz, 0.5 m noise, a dropout window, 2% outliers), no loops
  circuit  — 2 laps in 75 s, 2 moving objects, loop closure, no GPS
  figure8  — 2.5 figure-8s in 150 s with an elevation profile (held out)

Check mode (no `--update`) holds each run against the JAX package's
`ACCURACY.json` (read only): ATE <= stored x 1.5 + 0.02 m, and ATE and RTE
under `tests/test_accuracy_regression.py`'s absolute ceilings.

    python -m gorio_tpu_torch.evaluation.accuracy [--seq straight] [--device cuda]
        [--update --out ACCURACY_PORT.json] [--stored ACCURACY.json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .sequence import REPO, card_name, resolve, run

ACCURACY_JSON = REPO / "ACCURACY.json"  # the JAX package's record: read, never written

# absolute ceilings (m) of tests/test_accuracy_regression.py: ~2% of path length
ATE_CEILING_M = {"straight": 1.6, "circuit": 2.5, "figure8": 3.0}
RTE_CEILING_M = {"straight": 1.6, "circuit": 2.5, "figure8": 3.0}

SEQUENCES = {
    "straight": {
        "simulate": [
            "--duration", "40", "--rate", "5", "--seed", "21",
            "--stops", "2", "--dynamic", "4", "--gps",
        ],
        # the reference optimizes on a 2-3 s timer, not once at the end
        "slam": ["--fused", "--preprocess", "--floor", "--preint", "ugpm",
                 "--no-loops", "--optimize-every", "15"],
    },
    "circuit": {
        # 2 laps in 75 s: the second lap revisits the first
        "simulate": [
            "--duration", "75", "--rate", "5", "--seed", "22", "--circuit",
            "--laps", "2", "--dynamic", "2",
        ],
        "slam": ["--fused", "--preprocess", "--floor", "--preint", "ugpm",
                 "--optimize-every", "15"],
    },
    # held out: a geometry no detector threshold was tuned on
    "figure8": {
        "simulate": [
            "--duration", "150", "--rate", "5", "--seed", "77", "--figure8",
            "--laps", "2.5", "--elev-amp", "0.12", "--dynamic", "2",
        ],
        "slam": ["--fused", "--preprocess", "--floor", "--preint", "ugpm",
                 "--optimize-every", "15"],
    },
}


def run_sequence(name: str, workdir: str | None = None, device="cuda", runs=None) -> dict:
    """One sequence (`name` of `SEQUENCES`, or a spec dict {"simulate": [...],
    "slam": [...], "name": ...}) through the port's `simulate` and `slam` on
    `device`: the script's keys. `runs`, a list, receives the
    `sequence.Run` (the dataset, the CLI's `RadarGraphSLAM`, the wall)."""
    from ..io.tum import ate_rmse, load_tum, rte

    name, spec = resolve(name, SEQUENCES)
    r = run(name, spec, workdir, device, prefix="gorio_acc_")
    if runs is not None:
        runs.append(r)
    es, ep = load_tum(r.est)
    gs, gp = load_tum(r.ds / "groundtruth.tum")
    tinfo = r.timing
    return {
        "ate_rmse_m": round(float(ate_rmse(es, ep, gs, gp)), 4),
        "rte_m": round(float(rte(es, ep, gs, gp)), 4),
        "n_keyframes": tinfo["n_keyframes"],
        "n_loops": tinfo["n_loops"],
        "stage_median_ms": {k: round(v, 2) for k, v in tinfo["stage_median_ms"].items()},
    }


def check(name: str, got: dict, stored: dict) -> list:
    """The gates a result misses: the jitter band against the stored record
    (ATE <= stored x 1.5 + 0.02 m) and the absolute ATE / RTE ceilings."""
    missed = []
    bound = stored["ate_rmse_m"] * 1.5 + 0.02
    if not got["ate_rmse_m"] <= bound:
        missed.append(f"ATE {got['ate_rmse_m']} m > stored {stored['ate_rmse_m']} m x 1.5 + "
                      f"0.02 = {bound:.4f} m")
    if not got["ate_rmse_m"] <= ATE_CEILING_M[name]:
        missed.append(f"ATE {got['ate_rmse_m']} m > ceiling {ATE_CEILING_M[name]} m")
    if not got["rte_m"] <= RTE_CEILING_M[name]:
        missed.append(f"RTE {got['rte_m']} m > ceiling {RTE_CEILING_M[name]} m")
    return missed


def main_cli(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--update", action="store_true", help="write the results to --out")
    ap.add_argument("--out", default=None, help="the port's accuracy record (JSON)")
    ap.add_argument("--stored", default=str(ACCURACY_JSON),
                    help="the record check mode holds the runs against (read only)")
    ap.add_argument("--seq", choices=list(SEQUENCES), default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.update and not args.out:
        ap.error("--update needs --out (the JAX package's ACCURACY.json is not written)")
    card = card_name(args.device)

    names = [args.seq] if args.seq else list(SEQUENCES)
    results = {}
    for name in names:
        print(f"== {name} ==", file=sys.stderr)
        runs = []
        results[name] = run_sequence(name, args.workdir, args.device, runs)
        print(json.dumps({name: results[name]}), flush=True)
        print(json.dumps({"seq": name, "card": card, "slam_wall_s": runs[0].wall_s,
                          "n_frames": runs[0].timing["n_frames"]}), file=sys.stderr, flush=True)

    if args.update:
        out = Path(args.out)
        stored = json.loads(out.read_text()) if out.exists() else {}
        stored.update(results)
        out.write_text(json.dumps(stored, indent=2) + "\n")
        print(f"wrote {out}", file=sys.stderr)
        return 0
    stored = json.loads(Path(args.stored).read_text())
    ok = True
    for name in names:
        missed = check(name, results[name], stored[name])
        ok &= not missed
        print(f"{name}: ate {results[name]['ate_rmse_m']} vs stored {stored[name]['ate_rmse_m']} "
              f"(bound {stored[name]['ate_rmse_m'] * 1.5 + 0.02:.4f}) "
              f"{'; '.join(missed) if missed else 'OK'}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main_cli())
