"""Command-line tools of the PyTorch/CUDA port.

  simulate    — generate a synthetic sequence to .grf files
  slam        — run odometry + the pose-graph back-end over a .grf sequence
  stream      — replay a sequence on its recording's clock through the fused
                frontend and the back end, with deadline accounting
  evaluate    — ATE/RTE of a TUM trajectory vs ground truth
  align       — align two PCD scans with every registration method
  align-traj  — the rigid (or similarity) transform between two
                trajectories by stamp association (Umeyama closed form)
  gt-adjust   — graph-based ground-truth adjustment: Huber between edges
                and identity loop edges, LM on the card (`src/gt_adjust.cpp`)
  utm-align   — the UTM->world transform as a one-vertex graph solve over
                stamp-associated (trajectory, GPS) pairs
                (`src/gps_traj_align.cpp`)
  convert     — CSV / NPZ / NPY / PCD frames -> .grf sequence
  convert-bag — rosbag v2.0 (NTU4DRadLM-style) -> .grf sequence with
                imu.npz and gps.npz
  visualize   — render markers, trajectories and a map to a PNG
  dump-config — write the default typed config tree (JSON, or YAML)
  bench       — the root `bench.py`'s workloads on the card, one JSON line
                with its keys (`gorio_tpu_torch/bench.py`)

Usage: python -m gorio_tpu_torch.cli <command> [args]

`slam` and `stream` accept every flag of their `python -m gorio_tpu.cli`
counterparts and, like them, run loop closure unless `--no-loops`. `slam
--config` reads a `dump-config` tree (either package's), whose `slam` and
`odometry` fields the flags override; `--dump` writes the graph and the
keyframes, `--map` the voxelised map's points. `--device` (slam, stream,
align, gt-adjust, utm-align) picks the torch device (default cuda); there
is no fallback to the CPU. The other tools take the arguments and print
the JSON keys of their JAX CLI counterparts; `align-traj`, `convert`,
`convert-bag` and `visualize` are host numpy (`visualize` needs
matplotlib). `bench` runs only on a CUDA device (`--device`, default cuda).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

from .io.tum import ate_rmse, load_tum, rte, save_tum
from .utils.profiling import StageTimer


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name}: no CUDA device is available")
    return device


def cmd_simulate(args):
    from .io.native import write_frame
    from .io.synthetic import (
        make_dynamic_objects, make_world, render_radar_scan, sample_gps, sample_imu,
        simulate_trajectory,
    )

    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    traj = simulate_trajectory(
        seed=args.seed, duration=args.duration, circuit=args.circuit, stops=args.stops,
        laps=args.laps, figure8=args.figure8, elev_amp=args.elev_amp,
    )
    imu = sample_imu(traj, seed=args.seed + 1)
    # the landmark field covers everywhere the trajectory can see, at the
    # density `--landmarks` sets for a ±60 m world
    extent = float(np.abs(traj.p[:, :2]).max()) + 45.0
    n_landmarks = int(args.landmarks * max(1.0, (extent / 60.0) ** 2))
    world = make_world(seed=args.seed + 2, n_landmarks=n_landmarks, extent=extent)
    dyn = make_dynamic_objects(seed=args.seed + 3, n_objects=args.dynamic) if args.dynamic else None
    stamps = np.arange(0.2, args.duration - 0.2, 1.0 / args.rate)
    for i, t in enumerate(stamps):
        R, p = traj.interp_pose(np.array([t]))
        v = np.stack([np.interp(t, traj.t, traj.v_body[:, k]) for k in range(3)])
        dpts, dvel = dyn.points_at(float(t)) if dyn is not None else (None, None)
        cloud = render_radar_scan(
            world, R[0], p[0], v, capacity=args.capacity, seed=1000 + i,
            dynamic_points=dpts, dynamic_vel=dvel,
            azimuth_fov_deg=None if args.omni else args.fov_azimuth,
            elevation_fov_deg=None if args.omni else args.fov_elevation,
        )
        m = cloud.mask.numpy()
        write_frame(
            out / f"{i:06d}.grf", float(t), cloud.xyz.numpy()[m],
            cloud.intensity.numpy()[m], cloud.doppler.numpy()[m],
        )
    np.savez(
        out / "imu.npz", gyr_t=imu.gyr_t, gyr=imu.gyr, vel_t=imu.vel_t, vel=imu.vel,
        gyr_var=imu.gyr_var, vel_var=imu.vel_var,
    )
    if args.gps:
        g_t, g_xyz, g_cov = sample_gps(
            traj, rate=args.gps_rate, noise_xy=args.gps_noise_xy, seed=args.seed + 4
        )
        np.savez(out / "gps.npz", t=g_t, xyz=g_xyz, cov=g_cov)
    gt = np.zeros((traj.t.shape[0], 4, 4))
    gt[:, :3, :3] = traj.R
    gt[:, :3, 3] = traj.p
    gt[:, 3, 3] = 1.0
    save_tum(out / "groundtruth.tum", traj.t, gt)
    print(f"wrote {len(stamps)} frames to {out}")


def _imu_and_slam(args, src, device, floor, slam_cfg=None):
    """The sequence's IMU record and a `RadarGraphSLAM` on `device` loaded
    with its gyro and twist streams; the flags set the config's loop
    closure, preintegration and noise fields, and `floor` turns the floor
    constraint on."""
    from .pipeline.slam import RadarGraphSLAM, SLAMConfig

    imu = np.load(src / "imu.npz")
    base = slam_cfg if slam_cfg is not None else SLAMConfig()
    slam = RadarGraphSLAM(
        base._replace(
            enable_loop_closure=not args.no_loops,
            preint_mode=args.preint,
            gyr_var=float(imu["gyr_var"]),
            vel_var=float(imu["vel_var"]),
            enable_floor_constraint=floor or base.enable_floor_constraint,
        ),
        device=device,
    )
    for t, g in zip(imu["gyr_t"], imu["gyr"]):
        slam.push_imu(t, g)
    for t, v in zip(imu["vel_t"], imu["vel"]):
        slam.push_twist(t, v)
    return imu, slam


def _frames(src):
    frames = sorted(src.glob("*.grf"))
    if not frames:
        sys.exit(f"no .grf frames in {src}")
    return frames


def cmd_slam(args):
    """Run the slice; returns (slam, odometry, timer) for callers that drive
    it in-process."""
    from .core.pointcloud import make_cloud
    from .estimators.egovel import EgoVelConfig, estimate_ego_velocity
    from .io.native import NativePipelineDataset
    from .pipeline.odometry import OdometryConfig, ScanMatchingOdometry
    from .pipeline.preprocessing import PreprocessConfig

    device = _device(args.device)
    # full-f32 matmuls on the card: TF32 would cost the 6x6 solves and the
    # H/b reductions what the TPU's bf16 passes cost them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    src = Path(args.dataset)
    frames = _frames(src)
    # the typed config tree: the flags override its `slam` and `odometry`
    # fields, and `--preprocess` takes its `preprocess`
    tree = None
    if args.config:
        from .config import load_config

        tree = load_config(args.config)
    imu, slam = _imu_and_slam(args, src, device, args.floor, tree.slam if tree else None)
    # twist stream: the dataset's samples when it ships them, else the
    # per-scan ego-velocity estimates below
    online_twists = imu["vel_t"].size == 0
    gps_path = src / "gps.npz"
    if gps_path.exists() and not args.no_gps:
        gps_npz = np.load(gps_path)
        for t, xyz, cov in zip(gps_npz["t"], gps_npz["xyz"], gps_npz["cov"]):
            slam.push_gps(float(t), xyz, cov=cov)
        print(f"pushed {len(gps_npz['t'])} GPS fixes")

    odo_cfg = tree.odometry if tree else OdometryConfig()
    odo = ScanMatchingOdometry(odo_cfg._replace(registration=args.registration))
    if args.preprocess:
        odo.preprocess_cfg = tree.preprocess if tree else PreprocessConfig()
    gyr_t_arr, gyr_arr = np.asarray(imu["gyr_t"]), np.asarray(imu["gyr"])

    def omega_at(t):
        """The latest gyro sample at or before `t` (deskew's rate)."""
        if gyr_t_arr.size == 0:
            return None
        return gyr_arr[np.clip(np.searchsorted(gyr_t_arr, t) - 1, 0, gyr_t_arr.size - 1)]

    def accept_floor(n_ground, plane):
        """Confident, roughly horizontal ground fits only."""
        return (slam.cfg.enable_floor_constraint
                and n_ground >= slam.cfg.floor_min_ground_points
                and abs(plane[2]) > slam.cfg.floor_max_tilt_nz)

    timer = StageTimer(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    ds = NativePipelineDataset(frames, capacity=args.capacity)
    n = 0
    point_dist = np.zeros(100, np.int64)
    for stamp, n_pts, packed in ds:
        r = np.linalg.norm(packed[:n_pts, :3], axis=1)
        point_dist += np.bincount(np.clip(r.astype(np.int64), 0, 99), minlength=100)
        floor = None
        if args.fused:
            # one upload of the padded frame (a copy out of the reader's
            # reused buffer), one program, one pull. In float64: the JAX
            # package runs this path in the frame's float32, where its LM
            # ends millimetres away from its own float64 run
            with timer.stage("frontend_fused"):
                pose, v = odo.step_fused(
                    float(stamp), torch.tensor(packed, dtype=torch.float64, device=device), n_pts,
                    ground=args.floor,
                    omega=omega_at(float(stamp)) if args.preprocess else None, generator=gen)
            if online_twists:
                slam.push_twist(float(stamp), v)
            cloud = odo.last_cloud  # built on the device inside the step
            has_ground = args.floor or (args.preprocess and odo.preprocess_cfg.enable_ground_seg)
            if has_ground and accept_floor(odo.last_ground_count, odo.last_plane):
                floor = odo.last_plane
        else:
            # copy out of the reader's reused buffer onto the device
            frame = torch.tensor(packed[:n_pts], device=device)
            cloud = make_cloud(
                frame[:, :3], intensity=frame[:, 3], doppler=frame[:, 4], capacity=args.capacity
            )
            with timer.stage("ego_velocity"):
                ego = estimate_ego_velocity(cloud, EgoVelConfig(), generator=gen)
                v = ego.v.cpu().numpy()
                if online_twists:
                    slam.push_twist(float(stamp), v)
            with timer.stage("scan_matching"):
                pose = odo.step(float(stamp), cloud, v)
            if args.floor:
                from .estimators.groundseg import GroundSegConfig, estimate_ground

                with timer.stage("ground_seg"):
                    seg = estimate_ground(cloud, GroundSegConfig())
                    fit = torch.cat([torch.sum(seg.ground_mask).to(seg.plane.dtype)[None],
                                     seg.plane]).cpu().numpy()
                    if accept_floor(int(fit[0]), fit[1:].astype(np.float64)):
                        floor = fit[1:].astype(np.float64)
        with timer.stage("backend"):
            slam.add_frame(float(stamp), cloud, pose, floor_coeffs=floor)
            if args.optimize_every and len(slam.keyframes) % args.optimize_every == 0:
                slam.optimize(window=args.optimize_window or None)
        n += 1
    with timer.stage("final_optimize"):
        slam.optimize()
    stamps, poses = slam.trajectory()
    save_tum(args.output, stamps, poses)
    print(f"processed {n} frames -> {len(slam.keyframes)} keyframes, "
          f"{len(slam.loops)} loops; trajectory: {args.output}")
    print(timer.report())
    if args.timing_out:
        with open(args.timing_out, "w") as fh:
            json.dump(
                {
                    "stage_median_ms": {
                        k: 1000 * statistics.median(v) for k, v in timer.samples.items()
                    },
                    "n_frames": n,
                    "n_keyframes": len(slam.keyframes),
                    "n_loops": len(slam.loops),
                    # per-gate loop-closure rejection counts
                    "loop_gate_counts": slam.loop_detector.gate_counts,
                    # accepted loops as [key_new, key_old, fitness]
                    "loops": [
                        [int(l.key_new), int(l.key_old), round(float(l.fitness), 4)]
                        for l in slam.loops
                    ],
                    "lm_iterations": sum(st.iterations for st in odo.statuses),
                    "verify_lm_iterations": slam.loop_detector.verify_iterations,
                    "solver_counts": slam.solver_counts,
                    "floor_plane": (None if slam.floor_plane is None
                                    else slam.floor_plane.tolist()),
                    "keyframe_stamps": [round(float(s), 6) for s in stamps],
                    "point_distribution": (point_dist / max(n, 1)).round(2).tolist(),
                    "device": str(device),
                },
                fh,
            )
    if args.status_out:
        with open(args.status_out, "w") as fh:
            json.dump(
                [
                    {
                        "converged": st.converged,
                        "matching_error": st.matching_error,
                        "inlier_fraction": st.inlier_fraction,
                        "prediction_label": st.prediction_label,
                        "relative_pose": np.asarray(st.relative_pose).tolist(),
                        "prediction_error": (
                            None if st.prediction_error is None
                            else np.asarray(st.prediction_error).tolist()
                        ),
                        "used_prediction": st.used_prediction,
                        "iterations": st.iterations,
                    }
                    for st in odo.statuses
                ],
                fh,
            )
        print(f"statuses: {args.status_out} ({len(odo.statuses)} frames)")
    if args.dump:
        slam.save(args.dump)
    if args.map:
        m = slam.generate_map(resolution=args.map_resolution)
        xyz = m.xyz[m.mask].cpu().numpy()
        np.savez(args.map, xyz=xyz)
        print(f"map: {args.map} ({len(xyz)} points)")
    return slam, odo, timer


def _warm_up(args, frames, slam, odo, device):
    """Run two frames through a throwaway odometry and back end of the
    same configuration before the clock starts: it builds and loads the
    1-NN kernels and the native runtime, and creates the card's cuBLAS /
    cuSOLVER handles, which the first streamed frame would pay for."""
    from .io.native import NativeDataset
    from .pipeline.odometry import ScanMatchingOdometry
    from .pipeline.slam import RadarGraphSLAM

    w = ScanMatchingOdometry(odo.cfg)
    w.preprocess_cfg = odo.preprocess_cfg
    wslam = RadarGraphSLAM(slam.cfg._replace(keyframe_delta_trans=0.0, keyframe_delta_angle=0.0),
                           device=device, gyr_t=list(slam.gyr_t), gyr=list(slam.gyr),
                           vel_t=list(slam.vel_t), vel=list(slam.vel))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    for stamp, xyz, inten, dop in NativeDataset(frames[:2], capacity=args.capacity):
        packed = np.zeros((args.capacity, 5))
        packed[: len(xyz)] = np.column_stack([xyz, inten, dop])
        pose, _ = w.step_fused(float(stamp), torch.tensor(packed, device=device), len(xyz),
                               ground=args.floor, omega=np.zeros(3) if args.preprocess else None,
                               generator=gen)
        wslam.add_frame(float(stamp), w.last_cloud, pose)
    wslam.optimize()
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_stream(args):
    """Wall-clock streaming replay with backpressure and deadline accounting
    (`bag_player.py` with `/read_until` flow control; see
    `pipeline/streaming.py`). Pushes the dataset's gyro and twist streams,
    no GPS, and, as `slam` does, each frame's ego velocity only where the
    dataset ships no twist (the JAX CLI's `stream` pushes both). `--floor`
    fits the ground in each frame, as the JAX CLI's `stream` does, and
    leaves the back end's floor constraint off. Prints the report's JSON
    line."""
    from .pipeline.odometry import OdometryConfig, ScanMatchingOdometry
    from .pipeline.preprocessing import PreprocessConfig
    from .pipeline.streaming import stream_sequence

    device = _device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src = Path(args.dataset)
    frames = _frames(src)
    imu, slam = _imu_and_slam(args, src, device, floor=False)
    odo = ScanMatchingOdometry(OdometryConfig(registration=args.registration))
    if args.preprocess:
        odo.preprocess_cfg = PreprocessConfig()
    if args.warmup:
        _warm_up(args, frames, slam, odo, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    report = stream_sequence(
        frames, slam, odo, imu={"gyr_t": imu["gyr_t"], "gyr": imu["gyr"]},
        rate_multiplier=args.rate_multiplier, mode=args.mode, queue_depth=args.queue_depth,
        capacity=args.capacity, optimize_every=args.optimize_every,
        optimize_window=args.optimize_window, ground=args.floor, generator=gen,
    )
    print(report.to_json())
    if args.report_out:
        with open(args.report_out, "w") as fh:
            fh.write(report.to_json())
    if args.output:
        slam.optimize()
        stamps, poses = slam.trajectory()
        save_tum(args.output, stamps, poses)
    return report, slam, odo


def cmd_dump_config(args):
    from .config import GorioConfig, save_config

    save_config(GorioConfig(), args.output)
    print(f"wrote {args.output}")


def cmd_evaluate(args):
    es, ep = load_tum(args.estimate)
    gs, gp = load_tum(args.groundtruth)
    result = {"ate_rmse_m": ate_rmse(es, ep, gs, gp), "rte_m": rte(es, ep, gs, gp),
              "n_poses": len(es)}
    print(json.dumps(result))
    return result


ALIGN_METHODS = ("ICP", "GICP", "FAST_GICP", "FAST_APDGICP", "FAST_VGICP", "FAST_VGICP_CUDA",
                 "NDT_OMP", "NDT_CUDA_D2D")


def cmd_align(args):
    """Align two PCD scans with each method and print fitness and timing
    (`ndt_omp/apps/align.cpp`, `fast_apdgicp/src/align.cpp`): both scans
    voxel-downsampled at `--leaf` on the host, padded to the next power of
    two, aligned from the identity. Returns one dict per method: name,
    fitness, first and warm ms (the card synchronised around each), the
    estimate T (4, 4) and the outer iterations."""
    import time

    from .core.pointcloud import make_cloud
    from .io.pcd import read_pcd, voxel_centroid_downsample
    from .registration import select_registration
    from .registration.gicp import fitness_score

    device = _device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def load(path):
        xyz, _ = read_pcd(path)
        xyz = xyz[np.all(np.isfinite(xyz), axis=1)]
        return voxel_centroid_downsample(xyz, res=args.leaf)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    tgt, src = load(args.target), load(args.source)
    cap = 1 << int(np.ceil(np.log2(max(len(src), len(tgt)))))
    target = make_cloud(torch.as_tensor(tgt), capacity=cap, device=device)
    source = make_cloud(torch.as_tensor(src), capacity=cap, device=device)
    print(f"target: {len(tgt)} pts, source: {len(src)} pts (capacity {cap})")
    methods = args.methods.split(",") if args.methods else ALIGN_METHODS
    rows = []
    for name in methods:
        kwargs = dict(resolution=args.ndt_resolution) if "NDT" in name else {}
        align = select_registration(name, **kwargs)
        sync()
        t0 = time.perf_counter()
        res = align(source, target)
        sync()
        first = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        for _ in range(args.repeat):
            res = align(source, target)
        sync()
        warm = (time.perf_counter() - t0) * 1e3 / max(args.repeat, 1)
        rows.append({"method": name, "first_ms": first, "warm_ms": warm, "T": res.T,
                     "iterations": int(res.iterations)})
    print(f"{'method':<16} {'fitness':>9} {'first ms':>10} {'warm ms':>9}")
    for row in rows:  # fitness after all timing, as the JAX CLI does
        row["fitness"] = float(fitness_score(source, target, row["T"], max_range=float("inf"))[0])
        print(f"{row['method']:<16} {row['fitness']:>9.6f} {row['first_ms']:>10.2f} "
              f"{row['warm_ms']:>9.2f}")
    if args.print_transform:
        print("final transform (last method):")
        print(np.array_str(rows[-1]["T"].cpu().numpy(), precision=5, suppress_small=True))
    return rows


def cmd_align_traj(args):
    """The transform mapping `source`'s positions onto `target`'s at the
    associated stamps (Umeyama, with `--scale` a similarity); `--output`
    writes the aligned source. Returns the printed dict."""
    from .io.tum import umeyama_alignment

    es, ep = load_tum(args.source)
    gs, gp = load_tum(args.target)
    idx = np.clip(np.searchsorted(gs, es), 0, len(gs) - 1)
    c, R, t = umeyama_alignment(ep[:, :3, 3], gp[idx][:, :3, 3], with_scale=args.scale)
    T = np.eye(4)
    T[:3, :3] = c * R
    T[:3, 3] = t
    result = {"scale": c, "T": T.tolist()}
    print(json.dumps(result))
    if args.output:
        out = ep.copy()
        out[:, :3, 3] = (c * (R @ ep[:, :3, 3].T)).T + t
        out[:, :3, :3] = np.einsum("ij,njk->nik", R, ep[:, :3, :3])
        save_tum(args.output, es, out)
    return result


def cmd_gt_adjust(args):
    """Graph-based ground-truth adjustment (`src/gt_adjust.cpp`): between
    edges of the consecutive poses (information I / odom_stddev, Huber)
    and identity loop edges at the given index pairs (rotation information
    1 / loop_rot_var, translation 1 / loop_trans_var, `gt_adjust.cpp:
    74-78`), one dense LM solve on `--device` for every size, as the JAX
    CLI's. Returns the printed dict."""
    from .graph.graph import PoseGraph
    from .graph.solver import SolveConfig, optimize_graph

    device = _device(args.device)
    stamps, poses = load_tum(args.input)
    n = len(stamps)
    g = PoseGraph()
    for T in poses:
        g.add_pose(T)
    info_odom = np.eye(6) / args.odom_stddev
    for i in range(1, n):
        g.add_between(i - 1, i, np.linalg.inv(poses[i - 1]) @ poses[i], info=info_odom,
                      robust_delta=args.huber)
    info_loop = np.eye(6)
    info_loop[:3, :3] /= args.loop_rot_var  # [rot, trans] state order
    info_loop[3:, 3:] /= args.loop_trans_var
    n_loops = 0
    for pair in args.loop or []:
        i, j = (int(x) for x in pair.split(":"))
        if not (0 <= i < n and 0 <= j < n):
            sys.exit(f"loop index pair {pair} out of range (n={n})")
        g.add_between(i, j, np.eye(4), info=info_loop)
        n_loops += 1
    poses0, graph = g.freeze(device=device)
    res = optimize_graph(poses0, graph, SolveConfig(max_iterations=args.iters))
    save_tum(args.output, stamps, res.poses.cpu().numpy())
    result = {"n_poses": n, "n_loops": n_loops, "chi2": float(res.chi2),
              "iterations": int(res.iterations), "output": args.output}
    print(json.dumps(result))
    return result


def cmd_utm_align(args):
    """T_world_utm by a one-vertex graph solve (`src/gps_traj_align.cpp:
    225-247`): the GPS rows (`stamp east north alt [var_x var_y var_z]`,
    whitespace or commas, `#` comments) pass the covariance gate
    (`gps_traj_align.cpp:157-158`), each goes to the trajectory's nearest
    stamp within `--max-dt`, and one UTM-alignment factor per pair
    (information diag(1 / var)) refines the closed-form seed on
    `--device`. The fixes are recentred on their mean before the solve
    (raw UTM is ~1e6 m) and the centring undone after it. Returns the
    printed dict."""
    from .graph.graph import PoseGraph
    from .graph.solver import SolveConfig, optimize_graph_with_planes
    from .io.tum import umeyama_alignment

    device = _device(args.device)
    stamps, poses = load_tum(args.trajectory)
    rows = []
    with open(args.gps) as f:
        for line in f:
            line = line.strip().replace(",", " ")
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            rows.append(v + [args.default_var] * (7 - len(v)))
    if not rows:
        sys.exit("no GPS fixes parsed")
    gps = np.asarray(rows)
    gps = gps[(gps[:, 4] <= args.max_var_xy) & (gps[:, 6] <= args.max_var_z)]
    idx = np.clip(np.searchsorted(stamps, gps[:, 0]), 0, len(stamps) - 1)
    idx_lo = np.clip(idx - 1, 0, len(stamps) - 1)
    idx = np.where(np.abs(stamps[idx_lo] - gps[:, 0]) < np.abs(stamps[idx] - gps[:, 0]),
                   idx_lo, idx)
    ok = np.abs(stamps[idx] - gps[:, 0]) < args.max_dt
    gps, idx = gps[ok], idx[ok]
    if len(gps) < 3:
        sys.exit(f"only {len(gps)} associated pairs (need >= 3)")
    centroid = gps[:, 1:4].mean(axis=0)
    p_utm_c = gps[:, 1:4] - centroid
    p_world = poses[idx, :3, 3]
    _, R0, t0 = umeyama_alignment(p_utm_c, p_world, with_scale=False)
    T0 = np.eye(4)
    T0[:3, :3] = R0
    T0[:3, 3] = t0
    g = PoseGraph()
    g.add_pose(T0)
    for k in range(len(gps)):
        info = np.diag(1.0 / np.maximum(gps[k, 4:7], 1e-9))
        g.add_utm_align(0, p_utm_c[k], p_world[k], info=info)
    poses0, graph = g.freeze(device=device)
    planes0, pg = g.freeze_planes(device=device)
    res = optimize_graph_with_planes(
        poses0, planes0, graph, pg, SolveConfig(max_iterations=args.iters, fix_first=False))
    T = res.poses[0].cpu().numpy().astype(np.float64)
    T[:3, 3] = T[:3, 3] - T[:3, :3] @ centroid  # T_world_utm = T_c . Translate(-centroid)
    result = {"n_pairs": int(len(gps)), "chi2": float(res.chi2), "T_world_utm": T.tolist()}
    print(json.dumps(result))
    if args.output:
        np.savetxt(args.output, T)
    return result


def cmd_convert(args):
    """Raw frames (and an IMU CSV, a ground-truth TUM) -> .grf sequence."""
    from glob import glob

    from .io.convert import convert_sequence

    frames = [f for pat in args.frames for f in glob(pat)]
    # a broad glob easily swallows the sidecar files: drop them
    side = {str(Path(p).resolve()) for p in (args.imu, args.gt) if p}
    frames = [f for f in frames if str(Path(f).resolve()) not in side]
    if not frames:
        sys.exit("no input frames matched")
    n = convert_sequence(frames, args.output, imu_csv=args.imu, gt_tum=args.gt, rate=args.rate,
                         min_range=args.min_range, max_range=args.max_range)
    print(f"converted {n} frames -> {args.output}")
    return n


def cmd_convert_bag(args):
    """Rosbag -> .grf sequence (the NTU Radar_to_livox rotation unless
    `--no-ntu-extrinsic`), or with `--list-topics` the bag's topics.
    Returns the frame count, or the topics' summary {topic: (type, count)}."""
    from .io.rosbag import RosbagReader, convert_rosbag

    if args.list_topics:
        summary = RosbagReader(args.bag).topics_summary()
        for topic, (msgtype, count) in sorted(summary.items()):
            print(f"{topic:<40} {msgtype:<40} {count}")
        return summary
    if not args.output:
        sys.exit("--output is required (or use --list-topics)")
    n = convert_rosbag(
        args.bag, args.output, radar_topic=args.radar_topic, imu_topic=args.imu_topic,
        twist_topic=args.twist_topic, gps_topic=args.gps_topic,
        power_threshold=args.power_threshold, apply_ntu_extrinsic=not args.no_ntu_extrinsic,
        max_frames=args.max_frames,
    )
    print(f"converted {n} radar frames -> {args.output}")
    return n


def cmd_visualize(args):
    """A run's markers JSON, trajectories and map npz as a top-down PNG
    (the rviz MarkerArray and map topics, `radar_graph_slam_nodelet.cpp:
    885-1121`)."""
    from .utils.viz import render_run

    out = render_run(args.output, markers_json=args.markers, trajectory_tum=args.trajectory,
                     groundtruth_tum=args.groundtruth, map_npz=args.map, title=args.title)
    print(f"wrote {out}")
    return out


def cmd_bench(args):
    from . import bench

    return bench.main(_device(args.device))


def main(argv=None):
    p = argparse.ArgumentParser(prog="gorio_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("simulate")
    s.add_argument("--circuit", action="store_true",
                   help="closed-loop trajectory (revisits the start)")
    s.add_argument("--laps", type=float, default=1.0)
    s.add_argument("--figure8", action="store_true")
    s.add_argument("--elev-amp", type=float, default=0.0, dest="elev_amp")
    s.add_argument("--output", required=True)
    s.add_argument("--duration", type=float, default=20.0)
    s.add_argument("--rate", type=float, default=5.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--landmarks", type=int, default=9000,
                   help="landmark count per ±60 m world tile (scaled with the extent)")
    s.add_argument("--capacity", type=int, default=2048)
    s.add_argument("--stops", type=int, default=0)
    s.add_argument("--dynamic", type=int, default=0)
    s.add_argument("--gps", action="store_true")
    s.add_argument("--gps-rate", type=float, default=2.0)
    s.add_argument("--gps-noise-xy", type=float, default=0.5)
    s.add_argument("--fov-azimuth", type=float, default=56.5)
    s.add_argument("--fov-elevation", type=float, default=22.5)
    s.add_argument("--omni", action="store_true")
    s.set_defaults(fn=cmd_simulate)

    s = sub.add_parser("slam")
    s.add_argument("--config", default=None)
    s.add_argument("--floor", action="store_true")
    s.add_argument("--optimize-window", type=int, default=0)
    s.add_argument("--fused", action="store_true")
    s.add_argument("--status-out", default=None)
    s.add_argument("--preprocess", action="store_true")
    s.add_argument("--dataset", required=True)
    s.add_argument("--output", default="trajectory.tum")
    s.add_argument("--registration", default="apdgicp", choices=["apdgicp", "gicp", "ndt"])
    s.add_argument("--preint", default="lpm", choices=["lpm", "ugpm"])
    s.add_argument("--capacity", type=int, default=2048)
    s.add_argument("--optimize-every", type=int, default=0)
    s.add_argument("--no-loops", action="store_true")
    s.add_argument("--no-gps", action="store_true")
    s.add_argument("--timing-out", default=None)
    s.add_argument("--dump", default=None)
    s.add_argument("--map", default=None)
    s.add_argument("--map-resolution", type=float, default=0.2)
    s.add_argument("--device", default="cuda", help="torch device (default cuda)")
    s.set_defaults(fn=cmd_slam)

    s = sub.add_parser("stream")
    s.add_argument("--dataset", required=True)
    s.add_argument("--rate-multiplier", type=float, default=1.0,
                   help="replay speed against the recording's clock (1.0 = real time)")
    s.add_argument("--mode", default="block", choices=["block", "drop"],
                   help="backpressure: block the producer (the /read_until contract) or "
                        "drop the oldest queued frame (a live sensor)")
    s.add_argument("--queue-depth", type=int, default=4)
    s.add_argument("--capacity", type=int, default=2048)
    s.add_argument("--registration", default="apdgicp", choices=["apdgicp", "gicp", "ndt"])
    s.add_argument("--preint", default="lpm", choices=["lpm", "ugpm"])
    s.add_argument("--preprocess", action="store_true")
    s.add_argument("--floor", action="store_true")
    s.add_argument("--no-loops", action="store_true")
    s.add_argument("--optimize-every", type=int, default=0)
    s.add_argument("--optimize-window", type=int, default=0)
    s.add_argument("--warmup", action="store_true", default=True)
    s.add_argument("--no-warmup", dest="warmup", action="store_false")
    s.add_argument("--report-out", default=None)
    s.add_argument("--output", default=None, help="final optimized TUM trajectory")
    s.add_argument("--device", default="cuda", help="torch device (default cuda)")
    s.set_defaults(fn=cmd_stream)

    s = sub.add_parser("evaluate")
    s.add_argument("estimate")
    s.add_argument("groundtruth")
    s.set_defaults(fn=cmd_evaluate)

    s = sub.add_parser("align")
    s.add_argument("target")
    s.add_argument("source")
    s.add_argument("--leaf", type=float, default=0.1, help="voxel downsample leaf (m)")
    s.add_argument("--ndt-resolution", type=float, default=2.0)
    s.add_argument("--methods", default=None, help="comma-separated subset")
    s.add_argument("--repeat", type=int, default=3)
    s.add_argument("--print-transform", action="store_true")
    s.add_argument("--device", default="cuda", help="torch device (default cuda)")
    s.set_defaults(fn=cmd_align)

    s = sub.add_parser("align-traj")
    s.add_argument("source")
    s.add_argument("target")
    s.add_argument("--scale", action="store_true")
    s.add_argument("--output", default=None)
    s.set_defaults(fn=cmd_align_traj)

    s = sub.add_parser("convert")
    s.add_argument("frames", nargs="+", help="frame file globs (.csv/.npz/.npy/.pcd)")
    s.add_argument("--output", required=True)
    s.add_argument("--imu", default=None, help="CSV t,wx,wy,wz[,vx,vy,vz]")
    s.add_argument("--gt", default=None, help="ground-truth TUM file to bundle")
    s.add_argument("--rate", type=float, default=10.0)
    s.add_argument("--min-range", type=float, default=0.0)
    s.add_argument("--max-range", type=float, default=float("inf"))
    s.set_defaults(fn=cmd_convert)

    s = sub.add_parser("convert-bag")
    s.add_argument("bag", help="rosbag v2.0 file (NTU4DRadLM-style)")
    s.add_argument("--output", default=None)
    s.add_argument("--list-topics", action="store_true",
                   help="print topic/type/count summary and exit")
    s.add_argument("--radar-topic", default="/radar_enhanced_pcl")
    s.add_argument("--imu-topic", default="/imu/data")
    s.add_argument("--twist-topic", default=None)
    s.add_argument("--gps-topic", default=None)
    s.add_argument("--power-threshold", type=float, default=0.0)
    s.add_argument("--no-ntu-extrinsic", action="store_true",
                   help="skip the Radar_to_livox rotation (non-NTU rigs)")
    s.add_argument("--max-frames", type=int, default=None)
    s.set_defaults(fn=cmd_convert_bag)

    s = sub.add_parser("gt-adjust")
    s.add_argument("input", help="TUM trajectory to adjust")
    s.add_argument("output", help="adjusted TUM trajectory")
    s.add_argument("--loop", action="append", metavar="I:J",
                   help="identity loop edge between pose indices (repeatable), e.g. 0:8240")
    s.add_argument("--odom-stddev", type=float, default=0.05)
    s.add_argument("--loop-trans-var", type=float, default=0.5)
    s.add_argument("--loop-rot-var", type=float, default=1.0)
    s.add_argument("--huber", type=float, default=1.0)
    s.add_argument("--iters", type=int, default=64)
    s.add_argument("--device", default="cuda", help="torch device (default cuda)")
    s.set_defaults(fn=cmd_gt_adjust)

    s = sub.add_parser("utm-align")
    s.add_argument("trajectory", help="TUM world-frame trajectory")
    s.add_argument("gps", help="stamp east north alt [var_x var_y var_z] rows")
    s.add_argument("--output", default=None, help="write the 4x4 T_world_utm")
    s.add_argument("--max-dt", type=float, default=0.02)
    s.add_argument("--max-var-xy", type=float, default=3.0)
    s.add_argument("--max-var-z", type=float, default=8.0)
    s.add_argument("--default-var", type=float, default=1.0)
    s.add_argument("--iters", type=int, default=64)
    s.add_argument("--device", default="cuda", help="torch device (default cuda)")
    s.set_defaults(fn=cmd_utm_align)

    s = sub.add_parser("visualize")
    s.add_argument("--output", default="run.png")
    s.add_argument("--markers", default=None, help="export_markers JSON")
    s.add_argument("--trajectory", default=None, help="estimated TUM trajectory")
    s.add_argument("--groundtruth", default=None, help="ground-truth TUM trajectory")
    s.add_argument("--map", default=None, help="map npz (from slam --map)")
    s.add_argument("--title", default=None)
    s.set_defaults(fn=cmd_visualize)

    s = sub.add_parser("dump-config")
    s.add_argument("--output", default="gorio_config.json")
    s.set_defaults(fn=cmd_dump_config)

    s = sub.add_parser("bench")
    s.add_argument("--device", default="cuda")
    s.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
