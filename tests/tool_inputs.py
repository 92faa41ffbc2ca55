"""Inputs of the port's CLI tools, built the same way wherever they are
held: `chip_smoke.py` (on the card), the CPU tests and `tests/jax_records.py`
(the JAX package's records) all call these functions, so every run sees the
same bytes.

- `build_slice_bag` writes a `simulate` sequence as an NTU4DRadLM-style
  rosbag with the independent writer of `tests/test_bag_fire_drill.py`
  (chunks alternating bz2 / greedy LZ4 / none, connection, index and
  chunk-info records as `rosbag record` writes them): each frame in the
  radar frame (through the inverse of the converter's Radar_to_livox
  rotation),
  with its doppler, range and intensity as the power channel; the gyro,
  the twist stream and one NavSatFix per second, every stamp shifted by
  `t_base`. The fixes are the ground truth expressed in the first frame's
  ground-truth pose, mapped to lat / lon by inverting the converter's own
  UTM projection, so the converter's zeroed UTM and the SLAM world agree to
  well under a millimetre. It also writes the shifted ground truth and the
  fixes as absolute UTM rows (`utm-align`'s input).
- `frame_gaps` holds a converted sequence against the frames it came from.
- `drifty_truth` samples a ground-truth TUM, adds `tests/test_cli_tools.py`'s
  per-step drift and picks identity loop pairs one lap apart
  (`gt-adjust`'s input).

`python tests/tool_inputs.py SEQ OUT` writes all of them for `chip_smoke.py`.

Uses numpy, scipy and the port's numpy modules only; the fire drill's
module is loaded by file path (it imports bz2, struct, numpy and pytest).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
T_BASE = 1.6e9  # epoch stamps of a real recording
LAT0, LON0 = 1.3465, 103.6808  # NTU campus, as the fire drill
ALT0 = 30.0
TOPICS = {"radar": "/radar_enhanced_pcl", "imu": "/imu/data", "twist": "/radar_twist",
          "gps": "/gps/fix"}
CONVERT_FLAGS = ["--radar-topic", TOPICS["radar"], "--imu-topic", TOPICS["imu"],
                 "--twist-topic", TOPICS["twist"], "--gps-topic", TOPICS["gps"]]
GPS_VAR = 0.25  # the fire drill's NavSatFix covariance diagonal
# the fire drill's `slam` flags (loops on)
BAG_SLAM = ["--fused", "--preprocess", "--preint", "ugpm", "--optimize-every", "15"]
# the `slam` fields the bag's `--config` tree changes: the reference's 5 m
# drift gate (`gps_residual_skip_dist`) passes no fix on a run whose
# odometry stays centimetres from the fixes, so every fix that passes the
# other gates becomes a GPS edge
BAG_SLAM_FIELDS = {"gps_residual_skip_dist": 0.0}
# `simulate --duration 75 --seed 22 --circuit --laps 2`'s trajectory
CIRCUIT = dict(seed=22, duration=75.0, circuit=True, laps=2.0)


def fire_drill():
    """`tests/test_bag_fire_drill.py` as a module, loaded by its path."""
    spec = importlib.util.spec_from_file_location("bag_fire_drill",
                                                  HERE / "test_bag_fire_drill.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def utm_to_latlon(east, north, lat_guess, lon_guess):
    """Invert `io.gps.latlon_to_utm` by Newton's method (central
    differences), to ~1e-9 m in UTM."""
    from gorio_tpu_torch.io.gps import latlon_to_utm

    x = np.array([lat_guess, lon_guess], np.float64)
    target = np.array([east, north])
    h = 1e-6
    for _ in range(8):
        f = np.array(latlon_to_utm(*x)[:2]) - target
        if np.abs(f).max() < 1e-9:
            break
        J = np.empty((2, 2))
        for k in range(2):
            d = np.zeros(2)
            d[k] = h
            J[:, k] = (np.array(latlon_to_utm(*(x + d))[:2])
                       - np.array(latlon_to_utm(*(x - d))[:2])) / (2 * h)
        x = x - np.linalg.solve(J, f)
    return float(x[0]), float(x[1])


def _frames(seq):
    from gorio_tpu_torch.io.native import NativeDataset

    return list(NativeDataset(sorted(Path(seq).glob("*.grf")), capacity=1 << 16))


def build_slice_bag(seq, bag, t_base=T_BASE, gps_period=1.0):
    """Write `seq` (a `simulate` output) as the rosbag `bag`, and beside it
    `groundtruth.tum` (shifted by `t_base`) and `gps_utm.txt` (`stamp east
    north alt var_x var_y var_z` per fix). Returns the counts: frames,
    points, points the converter keeps (power above 0), IMU, twist and GPS
    messages."""
    from scipy.spatial.transform import Rotation

    from gorio_tpu_torch.io.gps import latlon_to_utm
    from gorio_tpu_torch.io.rosbag import radar_to_livox_extrinsic
    from gorio_tpu_torch.io.tum import load_tum, save_tum

    fd = fire_drill()
    seq, bag = Path(seq), Path(bag)
    imu = np.load(seq / "imu.npz")
    gs, gp = load_tum(seq / "groundtruth.tum")
    # the converter maps radar points p to R p; its calibration chain is
    # orthonormal to ~1e-6 only, so the exact inverse, not R^T
    R_inv = np.linalg.inv(radar_to_livox_extrinsic()[:3, :3])
    w = fd.NTUBagWriter()
    c_pcl = w.add_connection(TOPICS["radar"], "sensor_msgs/PointCloud")
    c_imu = w.add_connection(TOPICS["imu"], "sensor_msgs/Imu")
    c_twist = w.add_connection(TOPICS["twist"], "geometry_msgs/TwistWithCovarianceStamped")
    c_gps = w.add_connection(TOPICS["gps"], "sensor_msgs/NavSatFix")

    frames = _frames(seq)
    n_points = n_kept = 0
    for i, (stamp, xyz, inten, dop) in enumerate(frames):
        xyz_radar = np.asarray(xyz, np.float64) @ R_inv.T
        rng = np.linalg.norm(xyz, axis=1)
        w.add(c_pcl, t_base + stamp,
              fd.msg_pointcloud(t_base + stamp, xyz_radar, dop, rng, inten, i))
        n_points += len(xyz)
        n_kept += int(np.sum(inten > 0.0))

    def nearest(t):
        return int(np.clip(np.searchsorted(gs, t), 0, len(gs) - 1))

    for i, (t, g) in enumerate(zip(imu["gyr_t"], imu["gyr"])):
        q = Rotation.from_matrix(gp[nearest(t), :3, :3]).as_quat()
        w.add(c_imu, t_base + t, fd.msg_imu(t_base + t, q, g, [0.0, 0.0, 9.81], i))
    for i, (t, v) in enumerate(zip(imu["vel_t"], imu["vel"])):
        w.add(c_twist, t_base + t, fd.msg_twist_cov(t_base + t, v, [0.0, 0.0, 0.0], i))

    # fixes: the ground truth in the first frame's pose, from its stamp on
    t_first, t_last = frames[0][0], frames[-1][0]
    k0 = nearest(t_first)
    R0, p0 = gp[k0, :3, :3], np.array([np.interp(t_first, gs, gp[:, a, 3]) for a in range(3)])
    e0, n0, _, _ = latlon_to_utm(LAT0, LON0)
    rows = []
    fix_t = np.arange(t_first, t_last + 1e-9, gps_period)
    for i, t in enumerate(fix_t):
        p = np.array([np.interp(t, gs, gp[:, a, 3]) for a in range(3)])
        x, y, z = R0.T @ (p - p0)
        lat, lon = utm_to_latlon(e0 + x, n0 + y, LAT0 + y / 111320.0,
                                 LON0 + x / (111320.0 * np.cos(np.deg2rad(LAT0))))
        w.add(c_gps, t_base + t, fd.msg_navsatfix(t_base + t, lat, lon, ALT0 + z, i))
        e, n, _, _ = latlon_to_utm(lat, lon)
        rows.append((t_base + t, e, n, ALT0 + z, GPS_VAR, GPS_VAR, GPS_VAR))
    w.write(bag)
    save_tum(bag.parent / "groundtruth.tum", gs + t_base, gp)
    with open(bag.parent / "gps_utm.txt", "w") as fh:
        fh.write("# stamp east north alt var_x var_y var_z\n")
        for r in rows:
            fh.write(" ".join(repr(float(v)) for v in r) + "\n")
    return {"frames": len(frames), "points": n_points, "kept": n_kept,
            "imu": len(imu["gyr_t"]), "twist": len(imu["vel_t"]), "gps": len(fix_t)}


def frame_gaps(seq, converted, t_base=T_BASE):
    """A converted sequence against the frames it came from, each net of
    the points whose power is not above 0: frames, the largest point gap
    (m, and relative to the point's range: the float32 rotation round trip
    rounds twice, ~2.4e-7 of it), doppler and intensity equal to the bit,
    point counts equal, the largest stamp gap (s)."""
    a, b = _frames(seq), _frames(converted)
    xyz_gap = rel_gap = stamp_gap = 0.0
    same_bits, same_counts = True, len(a) == len(b)
    for (sa, xa, ia, da), (sb, xb, ib, db) in zip(a, b):
        keep = ia > 0.0
        if int(keep.sum()) != len(xb):
            same_counts = False
            continue
        gap = np.abs(xa[keep].astype(np.float64) - xb).max(axis=1, initial=0.0)
        xyz_gap = max(xyz_gap, float(gap.max(initial=0.0)))
        rng = np.maximum(np.linalg.norm(xa[keep], axis=1), 1.0)
        rel_gap = max(rel_gap, float((gap / rng).max(initial=0.0)))
        same_bits &= np.array_equal(da[keep], db) and np.array_equal(ia[keep], ib)
        stamp_gap = max(stamp_gap, abs(sb - (sa + t_base)))
    return {"frames": len(b), "xyz_gap_m": xyz_gap, "xyz_rel_gap": rel_gap,
            "bits_equal": bool(same_bits),
            "counts_equal": bool(same_counts), "stamp_gap_s": stamp_gap}


def drifty_truth(gt_tum, out_tum, every=60, drift=0.004, laps=2, radius=0.1, max_loops=16):
    """Every `every`-th pose of `gt_tum`, re-chained with `drift` m added to
    each step's x and y (`tests/test_cli_tools.py::_drifty_circuit`),
    written to `out_tum`. Returns (the `I:J` loop pairs: poses about one lap
    apart within `radius` m in the undrifted truth, at most `max_loops`
    spread over the lap; the undrifted poses)."""
    from gorio_tpu_torch.io.tum import load_tum, save_tum

    stamps, poses = load_tum(gt_tum)
    stamps, poses = stamps[::every], poses[::every]
    K = len(poses)
    out = [poses[0]]
    for k in range(1, K):
        step = np.linalg.inv(poses[k - 1]) @ poses[k]
        step[0, 3] += drift
        step[1, 3] += drift
        out.append(out[-1] @ step)
    save_tum(out_tum, stamps, np.stack(out))
    lap = K / laps
    cands = []
    for i in range(K):
        lo, hi = int(i + 0.75 * lap), min(K, int(i + 1.25 * lap))
        if lo >= hi:
            continue
        d = np.linalg.norm(poses[lo:hi, :3, 3] - poses[i, :3, 3], axis=1)
        j = int(np.argmin(d))
        if d[j] < radius:
            cands.append((i, lo + j))
    pick = np.unique(np.linspace(0, len(cands) - 1, min(max_loops, len(cands))).round()
                     .astype(int)) if cands else []
    return [f"{cands[k][0]}:{cands[k][1]}" for k in pick], poses


def gps_gates(slam, fix_t=None):
    """How many fixes and keyframes passed each GPS gate of a finished
    `RadarGraphSLAM` (either package's): keyframes within 0.2 s of a fix
    (with the fix stamps `fix_t`), keyframes given a `utm_coord` (closest
    fix within 0.2 s, covariance and spacing gates), and those past the
    drift gate, which became GPS edges."""
    stamps = np.asarray([kf.stamp for kf in slam.keyframes])
    out = {"gps_utm_coords": sum(kf.utm_coord is not None for kf in slam.keyframes),
           "gps_edges": sum(bool(getattr(kf, "_gps_edge", False)) for kf in slam.keyframes)}
    if fix_t is not None and len(fix_t):
        near = np.abs(np.asarray(fix_t)[None, :] - stamps[:, None]).min(axis=1) <= 0.2
        out["gps_near_keyframes"] = int(near.sum())
    return out


def circuit_truth(out_tum):
    """The circuit's ground truth as `simulate` writes it (1 kHz)."""
    from gorio_tpu_torch.io.synthetic import simulate_trajectory
    from gorio_tpu_torch.io.tum import save_tum

    traj = simulate_trajectory(**CIRCUIT)
    gt = np.zeros((traj.t.shape[0], 4, 4))
    gt[:, :3, :3] = traj.R
    gt[:, :3, 3] = traj.p
    gt[:, 3, 3] = 1.0
    save_tum(out_tum, traj.t, gt)


def end_gap(poses):
    """Distance between a trajectory's last and first positions (m)."""
    return float(np.linalg.norm(poses[-1][:3, 3] - poses[0][:3, 3]))


def loop_gap(poses, loops):
    """Mean distance (m) between the two poses of each `I:J` loop pair."""
    pairs = [tuple(int(x) for x in pair.split(":")) for pair in loops]
    return float(np.mean([np.linalg.norm(poses[i][:3, 3] - poses[j][:3, 3])
                          for i, j in pairs]))


def sampled(n, count=10):
    """The pose indices a record keeps: `count` + 1 spread over 0 .. n - 1."""
    return sorted({int(round(k)) for k in np.linspace(0, n - 1, count + 1)})


def write_bag_config(cli_main, path):
    """`dump-config` of the CLI `cli_main` (either package's), with
    `BAG_SLAM_FIELDS` set in its `slam` tree, at `path`."""
    import json

    cli_main(["dump-config", "--output", str(path)])
    tree = json.loads(Path(path).read_text())
    tree["slam"].update(BAG_SLAM_FIELDS)
    Path(path).write_text(json.dumps(tree, indent=2))


def main(seq, out):
    """Every input of `chip_smoke.py`'s bag and tools phases, from the
    slice `seq`, under `out`: the bag (`out/bag`), the circuit's ground
    truth and its drifted copy; prints their counts and loops as JSON."""
    import json
    import time

    out = Path(out)
    (out / "bag").mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    info = {"bag": build_slice_bag(seq, out / "bag" / "slice.bag")}
    info["bag_s"] = time.perf_counter() - t0
    info["bag_bytes"] = (out / "bag" / "slice.bag").stat().st_size
    circuit_truth(out / "circuit_gt.tum")
    loops, truth = drifty_truth(out / "circuit_gt.tum", out / "drifty.tum")
    info.update(loops=loops, poses=len(truth), inputs_s=time.perf_counter() - t0)
    (out / "inputs.json").write_text(json.dumps(info))
    print(json.dumps(info), flush=True)


if __name__ == "__main__":
    import sys

    sys.path.insert(0, str(HERE.parent))
    main(*sys.argv[1:3])
