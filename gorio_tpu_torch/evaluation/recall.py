"""Loop-closure recall / precision of the port: `scripts/recall_benchmark.py`
on the port's CLI.

The same sequences (the stored-accuracy circuit, a 3-lap circuit and the
held-out figure-8), the same `slam` flags, and the same ground-truth
analysis (`gt_at` / `analyze`, copied: numpy, the same keys, the same
rounding). Definitions, as the script states them:

revisit pair   (i, j): keyframes whose ground-truth positions are within
               `revisit_radius` while their travelled distance differs by
               more than the detector's `accum_distance_thresh`.
revisit region maximal run of consecutive new-keyframe indices j that have
               at least one revisit partner, split every `interval` metres
               of ground-truth travel (the detector accepts at most one loop
               per interval): one opportunity the detector could have taken.
recall         fraction of regions containing either endpoint of a true
               accepted loop (`recall_key_new_only`: key_new only, with its
               structural ceiling `key_new_only_ceiling`).
false accept   accepted loop whose ground-truth endpoint distance exceeds
               `false_radius`.

    python -m gorio_tpu_torch.evaluation.recall [--seq circuit2] [--device cuda]
        [--update --out RECALL_PORT.json] [--accuracy-update --accuracy-out ACC.json]

The JAX package's `RECALL.json` and `ACCURACY.json` are never written.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from .sequence import card_name, resolve, run

SEQUENCES = {
    # the stored-accuracy circuit (same seed/params as ACCURACY.json)
    "circuit2": {
        "simulate": ["--duration", "75", "--rate", "5", "--seed", "22",
                     "--circuit", "--laps", "2", "--dynamic", "2"],
    },
    # harder: 3 laps, longer run, more accumulated drift before closure
    "circuit3": {
        "simulate": ["--duration", "115", "--rate", "5", "--seed", "23",
                     "--circuit", "--laps", "3", "--dynamic", "2"],
    },
    # held-out figure-8: never used for gate screening
    "figure8": {
        "simulate": ["--duration", "150", "--rate", "5", "--seed", "77",
                     "--figure8", "--laps", "2.5", "--elev-amp", "0.12",
                     "--dynamic", "2"],
    },
}

SLAM_ARGS = ["--fused", "--preprocess", "--floor", "--preint", "ugpm",
             "--optimize-every", "15"]

# recall sequence -> ACCURACY.json entry name (identical simulate+slam args)
ACCURACY_MAP = {"circuit2": "circuit", "figure8": "figure8"}


def gt_at(stamps, gt_stamps, gt_pos):
    """Ground-truth positions interpolated at the keyframe stamps."""
    out = np.stack(
        [np.interp(stamps, gt_stamps, gt_pos[:, k]) for k in range(3)], axis=1
    )
    return out


def analyze(kf_stamps, loops, gt_stamps, gt_pos, accum_gate=50.0,
            interval=10.0, revisit_radius=5.0, false_radius=7.0):
    kf_stamps = np.asarray(kf_stamps)
    pos = gt_at(kf_stamps, gt_stamps, gt_pos)
    n = len(kf_stamps)
    # ground-truth traveled distance per keyframe
    accum = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(pos, axis=0), axis=1))])
    d = np.linalg.norm(pos[None, :, :] - pos[:, None, :], axis=-1)
    elig = (d < revisit_radius) & (np.abs(accum[None, :] - accum[:, None]) > accum_gate)
    has_partner = elig.any(axis=0)  # j has some valid old partner i

    # split eligible j's into revisit regions every `interval` meters
    regions = []
    cur = None
    for j in range(n):
        if not has_partner[j]:
            if cur is not None:
                regions.append(cur)
                cur = None
            continue
        if cur is None:
            cur = [j, j, accum[j]]
        elif accum[j] - cur[2] >= interval:
            regions.append(cur)
            cur = [j, j, accum[j]]
        else:
            cur[1] = j
    if cur is not None:
        regions.append(cur)

    true_accepts, false_accepts = 0, 0
    for key_new, key_old, _fit in loops:
        if d[key_new, key_old] <= false_radius:
            true_accepts += 1
        else:
            false_accepts += 1
    covered, covered_new_only = set(), set()
    for k, (j0, j1, _) in enumerate(regions):
        for key_new, key_old, _fit in loops:
            if d[key_new, key_old] > false_radius:
                continue
            if j0 <= key_new <= j1:
                covered.add(k)
                covered_new_only.add(k)
            if j0 <= key_old <= j1:
                covered.add(k)
    # structural ceiling of the key_new-only metric: regions with no index
    # that has an OLDER partner can never host a key_new
    can_be_new = np.array(
        [bool((elig[j, :j] & (accum[j] - accum[:j] > accum_gate)).any())
         for j in range(n)]
    )
    n_reachable = sum(1 for j0, j1, _ in regions if can_be_new[j0 : j1 + 1].any())
    hits = len(covered)
    return {
        "n_keyframes": n,
        "n_revisit_pairs": int(elig.sum() // 2),
        "n_regions": len(regions),
        "n_loops_accepted": len(loops),
        "n_true_accepts": true_accepts,
        "n_false_accepts": false_accepts,
        "n_regions_covered": hits,
        "recall_regions": round(hits / max(len(regions), 1), 4),
        "recall_key_new_only": round(
            len(covered_new_only) / max(len(regions), 1), 4
        ),
        "n_regions_reachable_new": int(n_reachable),
        "key_new_only_ceiling": round(n_reachable / max(len(regions), 1), 4),
        "precision": round(true_accepts / max(len(loops), 1), 4) if loops else 1.0,
        "revisit_radius_m": revisit_radius,
        "false_radius_m": false_radius,
        "interval_m": interval,
        "accum_gate_m": accum_gate,
    }


def run_sequence(name, workdir=None, device="cuda", runs=None):
    """One sequence (`name` of `SEQUENCES`, or a spec dict {"simulate": [...],
    "slam": [...] (default `SLAM_ARGS`), "name": ...}) through the port's
    `simulate` and `slam` on `device`: the script's keys, `_accuracy_entry`
    included. `runs`, a list, receives the `sequence.Run`."""
    from ..io.tum import ate_rmse, load_tum, rte

    name, spec = resolve(name, SEQUENCES, SLAM_ARGS)
    r = run(name, spec, workdir, device, prefix="gorio_recall_")
    if runs is not None:
        runs.append(r)
    tinfo = r.timing
    gs, gp = load_tum(r.ds / "groundtruth.tum")
    out = analyze(tinfo["keyframe_stamps"], tinfo["loops"], gs, gp[:, :3, 3])
    out["loop_gate_counts"] = tinfo["loop_gate_counts"]
    out["loops"] = tinfo["loops"]
    # trajectory quality alongside (context for whether recall was needed)
    es, ep = load_tum(r.est)
    out["ate_rmse_m"] = round(float(ate_rmse(es, ep, gs, gp)), 4)
    # the same run carries everything the accuracy record stores
    out["_accuracy_entry"] = {
        "ate_rmse_m": out["ate_rmse_m"],
        "rte_m": round(float(rte(es, ep, gs, gp)), 4),
        "n_keyframes": tinfo["n_keyframes"],
        "n_loops": tinfo["n_loops"],
        "stage_median_ms": {
            k: round(v, 2) for k, v in tinfo["stage_median_ms"].items()
        },
    }
    return out


def _merge(path: Path, entries: dict):
    stored = json.loads(path.read_text()) if path.exists() else {}
    stored.update(entries)
    path.write_text(json.dumps(stored, indent=2) + "\n")
    print(f"wrote {path}", file=sys.stderr)


def main_cli(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--update", action="store_true", help="write the results to --out")
    ap.add_argument("--out", default=None, help="the port's recall record (JSON)")
    ap.add_argument("--accuracy-update", action="store_true",
                    help="also write the matching accuracy entries from the same runs "
                    "(circuit2 -> circuit, figure8) to --accuracy-out")
    ap.add_argument("--accuracy-out", default=None)
    ap.add_argument("--seq", choices=list(SEQUENCES), default=None)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.update and not args.out:
        ap.error("--update needs --out (the JAX package's RECALL.json is not written)")
    if args.accuracy_update and not args.accuracy_out:
        ap.error("--accuracy-update needs --accuracy-out")
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
    acc_entries = {
        ACCURACY_MAP[n]: r.pop("_accuracy_entry")
        for n, r in results.items()
        if n in ACCURACY_MAP
    }
    for r in results.values():
        r.pop("_accuracy_entry", None)
    if args.update:
        _merge(Path(args.out), results)
    if args.accuracy_update and acc_entries:
        _merge(Path(args.accuracy_out), acc_entries)
    return results


if __name__ == "__main__":
    main_cli()
