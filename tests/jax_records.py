"""The JAX package's CPU float64 records that `chip_smoke.py` holds the port
to, for the paths the port's CLI does not reach or that need the JAX
package's own run on the same input:

  python tests/jax_records.py scan-to-map SEQ   # scan-to-submap odometry
  python tests/jax_records.py align DIR         # the align pair, 8 methods

`scan-to-map` runs `ScanMatchingOdometry(OdometryConfig(
enable_scan_to_map=True, registration=r))` for r in ndt and apdgicp over a
`simulate` sequence (SEQ, the JAX CLI's default: seed 0, 98 frames), its
reader's frames handed over as float64, the ego velocity from
`estimate_ego_velocity` with the JAX CLI's key sequence; it prints the
odometry trajectory's ATE against the sequence's ground truth.

`align` writes `bench.synth_pair` (seed 0, 69,000 points; the target is
the source moved by a z-rotation of 0.02 rad and [0.3, 0.1, 0] m, plus
2 cm noise) to DIR/tgt.pcd and DIR/src.pcd and aligns them as the JAX
CLI's `align` does (0.1 m leaf, float32, NDT at resolution 2.0), printing
each method's error against the known transform.

Run with `PYTHONPATH= JAX_PLATFORMS=cpu` from the repository root; the
scan-to-map record needs `JAX_ENABLE_X64=1`.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def scan_to_map(seq):
    import jax
    import jax.numpy as jnp

    from gorio_tpu.core.pointcloud import make_cloud
    from gorio_tpu.estimators.egovel import EgoVelConfig, estimate_ego_velocity
    from gorio_tpu.io import native
    from gorio_tpu.io.tum import ate_rmse, load_tum
    from gorio_tpu.pipeline.odometry import OdometryConfig, ScanMatchingOdometry

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    seq = Path(seq)
    gs, gp = load_tum(seq / "groundtruth.tum")
    for reg in ("ndt", "apdgicp"):
        t0 = time.perf_counter()
        odo = ScanMatchingOdometry(OdometryConfig(enable_scan_to_map=True, registration=reg))
        key = jax.random.PRNGKey(0)
        stamps, poses = [], []
        for stamp, n, packed in native.NativePipelineDataset(sorted(seq.glob("*.grf")),
                                                             capacity=2048):
            frame = np.asarray(packed[:n], np.float64)
            cloud = make_cloud(jnp.asarray(frame[:, :3]), intensity=jnp.asarray(frame[:, 3]),
                               doppler=jnp.asarray(frame[:, 4]), capacity=2048)
            key, sub = jax.random.split(key)
            v = np.asarray(estimate_ego_velocity(cloud, EgoVelConfig(), key=sub).v)
            poses.append(odo.step(float(stamp), cloud, v))
            stamps.append(float(stamp))
        print(json.dumps({"registration": reg, "frames": len(stamps),
                          "keyframes": len(odo._submap_frames),
                          "ate_m": ate_rmse(np.asarray(stamps), np.stack(poses), gs, gp),
                          "used_prediction": sum(s.used_prediction for s in odo.statuses),
                          "s": time.perf_counter() - t0}), flush=True)


def align(out):
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from bench import synth_pair
    from gorio_tpu.core.pointcloud import make_cloud
    from gorio_tpu.io.pcd import read_pcd, voxel_centroid_downsample, write_pcd
    from gorio_tpu.registration import select_registration
    from gorio_tpu.registration.gicp import fitness_score

    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    (a, ia), (b, ib) = synth_pair(69000, seed=0)
    write_pcd(out / "tgt.pcd", b, ib)
    write_pcd(out / "src.pcd", a, ia)

    def load(p):
        xyz, _ = read_pcd(p)
        return voxel_centroid_downsample(xyz[np.all(np.isfinite(xyz), axis=1)], res=0.1)

    tgt, src = load(out / "tgt.pcd"), load(out / "src.pcd")
    cap = 1 << int(np.ceil(np.log2(max(len(src), len(tgt)))))
    target, source = (make_cloud(jnp.asarray(x), capacity=cap) for x in (tgt, src))
    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("z", 0.02).as_matrix()
    T[:3, 3] = [0.3, 0.1, 0.0]
    for name in ("ICP", "GICP", "FAST_GICP", "FAST_APDGICP", "FAST_VGICP", "FAST_VGICP_CUDA",
                 "NDT_OMP", "NDT_CUDA_D2D"):
        t0 = time.perf_counter()
        res = select_registration(name, **(dict(resolution=2.0) if "NDT" in name else {}))(
            source, target)
        Te = np.asarray(res.T, np.float64)
        d = np.linalg.inv(Te) @ T
        ang = np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))
        print(json.dumps({"method": name, "trans_err_m": float(np.linalg.norm(d[:3, 3])),
                          "rot_err_deg": float(np.degrees(ang)),
                          "fitness": float(fitness_score(source, target, res.T,
                                                         max_range=jnp.inf)[0]),
                          "iterations": int(res.iterations), "T": Te.tolist(),
                          "s": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    {"scan-to-map": scan_to_map, "align": align}[sys.argv[1]](sys.argv[2])
