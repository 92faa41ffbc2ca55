"""Record / replay the port's loop detector: `scripts/loop_replay.py` on the
port.

`record` runs one real `slam` and records the loop detector's inputs at
every `detect_batch` call (the pose / odometry / accumulated-distance
snapshots), the Scan-Context descriptor bank and the keyframe clouds;
`replay` runs loop detection offline on those snapshots with `LoopConfig`
overrides: the Scan-Context search, the batched APDGICP verification (both
1-NN kernels on the card) and the accept chain.

The pickle holds only numpy arrays, lists and numbers, under the script's
keys, so a recording of either package replays in the other. Its arrays
keep the run's dtypes, which are a JAX recording's: the descriptor bank
float32, the masks bool, the keyframe clouds in the dtype the run computed
them in (the reader's float32 on the unfused path; float64 on the port's
`--fused` path, whose CLI uploads the frames as float64, where the JAX
CLI's stays in float32).

Caveat (as the script's): replay uses the recorded pose trajectory, so a
config that accepts a different loop set sees poses that the real pipeline
would have optimized differently afterwards. Replay is a screening tool.

    python -m gorio_tpu_torch.evaluation.loop_replay record --seq circuit2 --out REC.pkl
        [--device cuda]
    python -m gorio_tpu_torch.evaluation.loop_replay replay --rec REC.pkl
        [--set pairwise_check_trans_thresh=6.0 ...] [--log] [--device cuda]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pickle
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from .recall import SEQUENCES, SLAM_ARGS, analyze
from .sequence import device_of, gt_positions, resolve, run


@dataclass
class Capture:
    """What `capture` records: one snapshot per `detect_batch` call, the
    first-seen cloud of every keyframe, and the detector itself."""

    cycles: list = field(default_factory=list)
    clouds: dict = field(default_factory=dict)
    det: object = None


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@contextlib.contextmanager
def capture():
    """Wrap `LoopDetector.detect_batch` and `__post_init__` for the length of
    the block (restored in a `finally`), as the script's `record` does."""
    import gorio_tpu_torch.loopclosure.loop_detector as ld

    cap = Capture()
    orig = ld.LoopDetector.detect_batch
    orig_init = ld.LoopDetector.__post_init__

    def wrapped(self, new_indices, keyframe_clouds, keyframe_poses,
                keyframe_odoms, keyframe_accum, keyframe_altitudes=None):
        cap.cycles.append({
            "new_idx": list(map(int, new_indices)),
            "poses": np.array(keyframe_poses, copy=True),
            "odoms": np.array(keyframe_odoms, copy=True),
            "accum": np.array(keyframe_accum, copy=True),
            "alts": None if keyframe_altitudes is None else [
                None if a is None else float(a) for a in keyframe_altitudes
            ],
        })
        for k, c in enumerate(keyframe_clouds):
            if k not in cap.clouds:
                cap.clouds[k] = c
            elif cap.clouds[k] is not c:
                # replay verifies against the first-seen cloud
                print(f"WARNING: keyframe {k} cloud object changed between "
                      "detect_batch calls; replay uses the first-seen cloud",
                      file=sys.stderr)
        return orig(self, new_indices, keyframe_clouds, keyframe_poses,
                    keyframe_odoms, keyframe_accum, keyframe_altitudes)

    def wrapped_init(self):
        orig_init(self)
        cap.det = self

    ld.LoopDetector.detect_batch = wrapped
    ld.LoopDetector.__post_init__ = wrapped_init
    try:
        yield cap
    finally:
        ld.LoopDetector.detect_batch = orig
        ld.LoopDetector.__post_init__ = orig_init


def recording(cap: Capture, seq: str, ds, slam) -> dict:
    """The script's pickle contents from a finished capture of `slam` (the
    CLI's `RadarGraphSLAM`) on dataset `ds`: keyframe stamps and accepted
    loops as the CLI's `--timing-out` writes them."""
    det = cap.det
    gt_stamps, gt_pos = gt_positions(ds)
    return {
        "seq": seq,
        "cycles": cap.cycles,
        "clouds": {k: {f: _host(getattr(c, f)) for f in type(c)._fields}
                   for k, c in cap.clouds.items()},
        "descs": _host(det.db.descs),
        "ring_keys": _host(det.db.ring_keys),
        "count": int(det.db.count),
        "kf_stamps": [round(float(kf.stamp), 6) for kf in slam.keyframes],
        "gt_stamps": gt_stamps,
        "gt_pos": gt_pos,
        "loops_real": [[int(l.key_new), int(l.key_old), round(float(l.fitness), 4)]
                       for l in slam.loops],
        "gate_counts_real": dict(det.gate_counts),
        "candidate_log_real": list(det.candidate_log),
    }


def record(seq, out, workdir=None, device="cuda"):
    """One real `slam` of `seq` (a name of the recall `SEQUENCES`, run with
    `SLAM_ARGS`, or a spec dict {"simulate": [...], "slam": [...], "name":
    ...}) on `device`, its loop detector's inputs pickled to `out`. Returns
    the recording."""
    name, spec = resolve(seq, SEQUENCES, SLAM_ARGS)
    with capture() as cap:
        r = run(name, spec, workdir, device, prefix="gorio_replay_")
    rec = recording(cap, name, r.ds, r.slam)
    with open(out, "wb") as fh:
        pickle.dump(rec, fh)
    print(f"recorded {len(cap.cycles)} cycles, {len(cap.clouds)} clouds -> {out}",
          file=sys.stderr)
    return rec


def make_detector(rec, overrides, device="cuda"):
    """A `LoopDetector` on `device` with `LoopConfig()._replace(**overrides)`
    and the recorded descriptor bank."""
    from ..loopclosure.loop_detector import LoopConfig, LoopDetector

    cfg = LoopConfig()._replace(**overrides)
    det = LoopDetector(cfg=cfg, device=device_of(device))
    db = det.db
    while db.descs.shape[0] < rec["descs"].shape[0]:
        db = db.grow()
    n = rec["descs"].shape[0]
    db.descs[:n] = torch.as_tensor(np.asarray(rec["descs"]), dtype=db.descs.dtype)
    db.ring_keys[:n] = torch.as_tensor(np.asarray(rec["ring_keys"]), dtype=db.ring_keys.dtype)
    det.db = db._replace(count=int(rec["count"]))
    return det


def replay(rec, overrides, device="cuda"):
    """Loop detection over the recorded cycles on `device`: (detector,
    accepted loops)."""
    from ..core.pointcloud import PointCloud

    det = make_detector(rec, overrides, device)
    clouds = {
        int(k): PointCloud(**{f: torch.as_tensor(np.asarray(v), device=det.device)
                              for f, v in c.items()})
        for k, c in rec["clouds"].items()
    }
    cloud_list = [clouds.get(k) for k in range(max(clouds) + 1)]
    loops = []
    for cyc in rec["cycles"]:
        loops.extend(
            det.detect_batch(
                cyc["new_idx"], cloud_list, np.asarray(cyc["poses"]), np.asarray(cyc["odoms"]),
                np.asarray(cyc["accum"]), keyframe_altitudes=cyc["alts"],
            )
        )
    return det, loops


def classify(rec, loops, radius=7.0):
    """True/false per accepted loop via ground-truth interpolation."""
    kf = np.asarray(rec["kf_stamps"])
    gt_pos = np.stack(
        [np.interp(kf, rec["gt_stamps"], rec["gt_pos"][:, k]) for k in range(3)],
        axis=1,
    )
    out = []
    for lp in loops:
        i, m = (lp.key_new, lp.key_old) if hasattr(lp, "key_new") else (lp[0], lp[1])
        d = float(np.linalg.norm(gt_pos[i] - gt_pos[m]))
        out.append((int(i), int(m), round(d, 2), d <= radius))
    return out


def summary(rec, det, loops) -> dict:
    """The replay's JSON line without the overrides: loops classified,
    region recall on the recorded ground truth, gate counts."""
    cls = classify(rec, loops)
    regions = analyze(
        rec["kf_stamps"],
        [(int(l.key_new), int(l.key_old), float(l.fitness)) for l in loops],
        rec["gt_stamps"], rec["gt_pos"],
    )
    return {
        "n_loops": len(loops),
        "loops": cls,
        "n_false": sum(1 for c in cls if not c[3]),
        "recall_regions": regions["recall_regions"],
        "n_regions": regions["n_regions"],
        "n_regions_covered": regions["n_regions_covered"],
        "precision": regions["precision"],
        "gate_counts": det.gate_counts,
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    rp = sub.add_parser("record")
    rp.add_argument("--seq", default="circuit2", choices=list(SEQUENCES))
    rp.add_argument("--out", required=True)
    rp.add_argument("--workdir", default=None)
    rp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    pp = sub.add_parser("replay")
    pp.add_argument("--rec", required=True)
    pp.add_argument("--set", action="append", default=[],
                    help="LoopConfig override field=value")
    pp.add_argument("--log", action="store_true",
                    help="dump the per-candidate decision log")
    pp.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    if args.cmd == "record":
        record(args.seq, args.out, args.workdir, args.device)
        return
    with open(args.rec, "rb") as fh:
        rec = pickle.load(fh)
    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    det, loops = replay(rec, overrides, args.device)
    print(json.dumps({"overrides": overrides, **summary(rec, det, loops)}))
    if args.log:
        for r in det.candidate_log:
            print(json.dumps(r))


if __name__ == "__main__":
    main()
