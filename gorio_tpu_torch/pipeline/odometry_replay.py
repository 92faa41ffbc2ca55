"""Replay a `simulate` sequence through `ScanMatchingOdometry` alone, as
the unfused CLI's frame loop does (frames uploaded as float64, ego velocity
from a seeded generator), on the card.

Run as a script it checks that scan-to-submap odometry repeats to the bit,
for whichever `gorio_tpu_torch` is first on the path, so that two trees
compare on one card:

    PYTHONPATH=OTHER_TREE python gorio_tpu_torch/pipeline/odometry_replay.py SEQ
    PYTHONPATH=.          python gorio_tpu_torch/pipeline/odometry_replay.py SEQ

For APDGICP and NDT it runs the odometry twice in one process and prints
each run's 1-NN launch counts and odometry ATE, then whether the launches
are equal and the poses bitwise equal, the first frame where they differ
and the largest gap; one JSON line with the card's `nvidia-smi` name and
power limit. Needs a CUDA device and SEQ from `cli simulate`.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

CAPACITY = 2048  # `simulate`'s points per scan


def odometry_run(seq, cfg):
    """The frame loop over `seq` with `OdometryConfig` `cfg`. Returns
    (odometry, stamps, poses, the submap rebuild's seconds per keyframe,
    the card synchronised around each)."""
    from gorio_tpu_torch.core.pointcloud import make_cloud
    from gorio_tpu_torch.estimators.egovel import EgoVelConfig, estimate_ego_velocity
    from gorio_tpu_torch.io.native import NativePipelineDataset
    from gorio_tpu_torch.pipeline.odometry import ScanMatchingOdometry

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    odo = ScanMatchingOdometry(cfg)
    rebuild = odo._rebuild_submap
    rebuild_s = []

    def timed_rebuild():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rebuild()
        torch.cuda.synchronize()
        rebuild_s.append(time.perf_counter() - t0)

    odo._rebuild_submap = timed_rebuild
    stamps, poses = [], []
    for stamp, n, packed in NativePipelineDataset(sorted(Path(seq).glob("*.grf")),
                                                  capacity=CAPACITY):
        frame = torch.tensor(packed[:n], dtype=torch.float64, device=dev)
        cloud = make_cloud(frame[:, :3], intensity=frame[:, 3], doppler=frame[:, 4],
                           capacity=CAPACITY)
        v = estimate_ego_velocity(cloud, EgoVelConfig(), generator=gen).v.cpu().numpy()
        poses.append(odo.step(float(stamp), cloud, v))
        stamps.append(float(stamp))
    return odo, np.asarray(stamps), np.stack(poses), rebuild_s


def main(seq):
    from gorio_tpu_torch.io.native import build_native
    from gorio_tpu_torch.io.tum import ate_rmse, load_tum
    from gorio_tpu_torch.ops import nn as K
    from gorio_tpu_torch.pipeline.odometry import OdometryConfig

    K.build_library()
    K.load_library()
    build_native()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    gs, gp = load_tum(Path(seq) / "groundtruth.tum")
    out = {"card": card, "tree": str(Path(K.__file__).resolve().parents[2])}
    for reg in ("apdgicp", "ndt"):
        runs = []
        for rep in range(2):
            K.reset_launch_counts()
            _, stamps, poses, _ = odometry_run(
                seq, OdometryConfig(enable_scan_to_map=True, registration=reg))
            runs.append((dict(K.launch_counts), poses, ate_rmse(stamps, poses, gs, gp)))
            print(f"[{reg}] run {rep}: launches {runs[-1][0]}, ATE {runs[-1][2]!r} m", flush=True)
        (l0, p0, a0), (l1, p1, a1) = runs
        differ = np.any(p0 != p1, axis=(1, 2))
        out[reg] = {"launches": [l0, l1], "ate_m": [a0, a1], "launches_equal": l0 == l1,
                    "poses_bitwise_equal": not differ.any(),
                    "first_differing_frame": int(np.argmax(differ)) if differ.any() else None,
                    "max_pose_gap": float(np.abs(p0 - p1).max())}
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1])
