"""The JAX package's CPU float64 records that `chip_smoke.py` holds the port
to, for the paths the port's CLI does not reach or that need the JAX
package's own run on the same input:

  python tests/jax_records.py scan-to-map SEQ   # scan-to-submap odometry
  python tests/jax_records.py align DIR         # the align pair, 8 methods
  python tests/jax_records.py slice-map SEQ OUT    # `slam --map` of the slice
  python tests/jax_records.py cg-slice SEQ OUT     # `slam --config` with solver "cg"
  python tests/jax_records.py preint-chunked       # chunked against one window
  python tests/jax_records.py candidates {jax,torch} SEQ OUT.json
  python tests/jax_records.py candidates-diff JAX.json TORCH.json
  python tests/jax_records.py verify-pairs SEQ TUM NEW:OLD [NEW:OLD ...]
  python tests/jax_records.py posterior SEQ TUM    # `sample_posterior` after `slam`
  python tests/jax_records.py smoother SEQ TUM [N]  # the loop smoother after `slam`
  python tests/jax_records.py bag SEQ OUT       # convert-bag -> slam -> evaluate
  python tests/jax_records.py utm-align BAGDIR  # `utm-align` on the bag's fixes
  python tests/jax_records.py gt-adjust OUT     # `gt-adjust` and `align-traj`
  python tests/jax_records.py straight OUT DURATION  # a shortened accuracy straight
  python tests/jax_records.py recall NAME OUT   # a recall sequence, float64 frames

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

`slice-map` runs the JAX CLI's default `slam` (loops on) on SEQ with
`--map OUT/map.npz --output OUT/est.tum` and prints the map's point count
and bounds (the 0.2 m voxel map of the keyframe clouds within 50 m).

`cg-slice` writes the JAX CLI's `dump-config` tree to OUT/config.json with
`slam.solve.solver` set to "cg", runs `slam --config` with it on SEQ (the
98-frame slice) writing OUT/est.tum, and prints the keyframe count and
`evaluate`'s ATE and RTE.

`preint-chunked` runs `preintegrate` over the 4 s window of the JAX test
`test_chunked_preintegration_matches_single` (noiseless streams, start
0.5 s, queries 1.1, 2.3 and 3.4 s, grid 1024), one window and
`quantum=1.0`, with LPM and with UGPM, and prints the largest rotation and
position gap between the two.

`candidates` runs one package's `slam --optimize-every 15` on a sequence
(the circuit: `simulate --duration 75 --rate 5 --seed 22 --circuit --laps
2 --dynamic 2`; the port with `--device cpu`) and writes its loop
detector's gate counts, its `candidate_log` with each verified pair's
convergence flag, and the (new, old) pair of every gated fallback match to
OUT.json; `candidates-diff` prints the pairs on which two such files differ.
`verify-pairs` runs both packages' loop verification (`_verify_batch`,
coarse then fine APDGICP from both seeds, the loop detector's default
configs) on keyframe pairs of a sequence, from the same inputs: the
keyframe clouds as the unfused CLI builds them (float32, capacity 2048) and
the relative pose of TUM's keyframe poses as the seed; each pair alone and
all pairs in one batch, printing each lane's convergence flag and fitness.

`posterior` runs the JAX CLI's `slam --optimize-every 15` on SEQ (the
circuit above), writing its trajectory to TUM, keeps the CLI's
`RadarGraphSLAM` and calls its `sample_posterior(jax.random.PRNGKey(0))` at
the defaults (4 chains x 200 draws after 100 warmup iterations, the
whitened kernel at step 0.15, 16 leapfrog steps): it prints the keyframes,
loops and dofs, the mean acceptance, the largest R-hat, the mean Laplace
std of the last pose's six coordinates and the wall times.

`smoother` runs the same `slam`, builds `chip_smoke.py`'s smoother graph on
its keyframes (the anchor prior, the odometry and preintegration betweens
around the odometry poses, the accepted loops tempered in) and runs the JAX
package's `smc_loop_relaxation` (N particles, default 1,024; 8 stages x 2
MALA moves; key 0) and the port's on the CPU with the same draws, in each
of `smoother_variants`: it prints each run's log evidence, its drop from
the true loops', the ESS per stage, the stages that resampled, the
acceptance and the two packages' largest difference.

`bag` writes SEQ (the port's `simulate` default: 98 frames) as a rosbag
with `tests/tool_inputs.build_slice_bag` (stamps from 1.6e9 s, one
NavSatFix per second) to OUT/bag, converts it with the JAX CLI's
`convert-bag` to OUT/seq, runs its `slam --fused --preprocess --preint ugpm
--optimize-every 15` (loops on; `--config` of its `dump-config` tree with
`tool_inputs.BAG_SLAM_FIELDS`; its reader's frames handed over as float64,
as the port's CLI uploads them) and prints the keyframes, loops, GPS gate
counts, the first keyframe stamp and `evaluate`'s ATE and RTE against the
bag's shifted ground truth. `utm-align` runs the JAX CLI's `utm-align` on
BAGDIR's ground truth and `gps_utm.txt` (the fixes as absolute UTM rows).
`gt-adjust` writes the circuit's ground truth (`simulate --duration 75
--seed 22 --circuit --laps 2`: 75,000 poses), takes every 60th pose with
`tests/test_cli_tools.py`'s per-step drift (`tool_inputs.drifty_truth`),
runs the JAX CLI's `gt-adjust` with its identity loops (1,250 poses, dense)
and `align-traj --scale` of the drifted trajectory onto the truth, and
prints both JSON lines, the end gaps and sampled poses.

`straight` writes `scripts/accuracy_benchmark.py`'s straight cut to
DURATION seconds (`simulate --duration DURATION --rate 5 --seed 21 --stops
2 --dynamic 4 --gps`, the port's simulator) to OUT/seq and runs the JAX
CLI's `slam` with the straight's flags (`--fused --preprocess --floor
--preint ugpm --no-loops --optimize-every 15`; its reader's frames handed
over as float64, as the port's CLI uploads them), printing the keyframes,
loops, GPS gate counts and `evaluate`'s ATE and RTE.

`recall` runs `scripts/recall_benchmark.py`'s sequence NAME (circuit2,
circuit3, figure8: the port's simulator) with its `slam` flags through the
JAX CLI on its reader's frames handed over as float64, and prints the
script's `analyze` of its keyframes and loops, each loop's ground-truth
endpoint gap, the gate counts, ATE and RTE.

Run with `PYTHONPATH= JAX_PLATFORMS=cpu` from the repository root; the
scan-to-map, candidates, posterior, smoother, bag, utm-align, gt-adjust,
straight and recall records need `JAX_ENABLE_X64=1`.
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


def slice_map(seq, out):
    import jax

    from gorio_tpu.cli import main

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    main(["slam", "--dataset", str(seq), "--output", str(out / "est.tum"), "--map",
          str(out / "map.npz")])
    xyz = np.load(out / "map.npz")["xyz"]
    print(json.dumps({"points": len(xyz), "min": xyz.min(axis=0).tolist(),
                      "max": xyz.max(axis=0).tolist()}))


def cg_slice(seq, out):
    import jax

    import gorio_tpu.cli as cli
    import gorio_tpu.pipeline.slam as slam_mod
    from gorio_tpu.io.tum import ate_rmse, load_tum, rte

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    cli.main(["dump-config", "--output", str(out / "config.json")])
    tree = json.loads((out / "config.json").read_text())
    tree["slam"]["solve"]["solver"] = "cg"
    (out / "config.json").write_text(json.dumps(tree, indent=2))
    made = []

    class Caught(slam_mod.RadarGraphSLAM):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    slam_mod.RadarGraphSLAM = Caught
    t0 = time.perf_counter()
    cli.main(["slam", "--dataset", str(seq), "--output", str(out / "est.tum"), "--config",
              str(out / "config.json")])
    wall = time.perf_counter() - t0
    es, ep = load_tum(out / "est.tum")
    gs, gp = load_tum(Path(seq) / "groundtruth.tum")
    print(json.dumps({"keyframes": len(made[0].keyframes), "loops": len(made[0].loops),
                      "ate_m": ate_rmse(es, ep, gs, gp), "rte_m": rte(es, ep, gs, gp),
                      "wall_s": wall}))


def preint_chunked():
    import jax
    import jax.numpy as jnp

    from gorio_tpu.core import lie
    from gorio_tpu.io.synthetic import sample_imu, simulate_trajectory
    from gorio_tpu.preintegration import preintegrate

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    traj = simulate_trajectory(seed=12, duration=4.0)
    imu = sample_imu(traj, gyr_rate=200.0, vel_rate=20.0, gyr_std=0.0, vel_std=0.0, seed=13)
    args = [jnp.asarray(a) for a in (imu.gyr_t, imu.gyr, imu.vel_t, imu.vel)]
    q = jnp.asarray([1.1, 2.3, 3.4])
    for method in ("lpm", "ugpm"):
        single, chunked = (preintegrate(*args, 0.5, q, 1e-6, 1e-6, method=method,
                                        quantum=quantum, grid_n=1024)
                           for quantum in (-1.0, 1.0))
        rad = max(float(lie.rotation_geodesic_angle(single.delta_R[i], chunked.delta_R[i]))
                  for i in range(3))
        m = float(jnp.abs(single.delta_p - chunked.delta_p).max())
        print(json.dumps({"method": method, "rad": rad, "m": m}), flush=True)


def candidates(pkg, seq, out):
    """One package's circuit run with its loop detector's diagnostics."""
    if pkg == "jax":
        import jax

        import gorio_tpu.cli as cli
        import gorio_tpu.loopclosure.loop_detector as det_mod
        import gorio_tpu.pipeline.slam as slam_mod

        assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    else:
        import gorio_tpu_torch.cli as cli
        import gorio_tpu_torch.loopclosure.loop_detector as det_mod
        import gorio_tpu_torch.pipeline.slam as slam_mod
    fallbacks = []
    count = det_mod.LoopDetector._count

    def recording_count(self, reason, n=1):
        # the caller's frame names the pair: the keyframe `idxs[k]` and the
        # gated match `mm`; the convergence flag follows the log entry
        f = sys._getframe(1).f_locals
        if reason == "gated_fallback_match":
            fallbacks.append([int(f["idxs"][f["k"]]), int(f["mm"])])
        elif reason == "not_converged":
            self.candidate_log[-1]["not_converged"] = True
        count(self, reason, n)

    made = []

    class Caught(slam_mod.RadarGraphSLAM):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    det_mod.LoopDetector._count = recording_count
    slam_mod.RadarGraphSLAM = Caught
    args = ["slam", "--dataset", str(seq), "--output", str(Path(out).with_suffix(".tum")),
            "--optimize-every", "15"]
    t0 = time.perf_counter()
    cli.main(args + (["--device", "cpu"] if pkg == "torch" else []))
    det = made[0].loop_detector
    Path(out).write_text(json.dumps({
        "gate_counts": det.gate_counts, "candidate_log": det.candidate_log,
        "fallbacks": fallbacks, "loops": [[int(l.key_new), int(l.key_old)]
                                          for l in made[0].loops],
        "s": time.perf_counter() - t0}))


def verify_pairs(seq, tum, *pairs):
    """Both packages' `_verify_batch` on the same inputs, alone and batched."""
    import jax
    import jax.numpy as jnp
    import torch

    import gorio_tpu.loopclosure.loop_detector as jl
    import gorio_tpu_torch.loopclosure.loop_detector as tl
    from gorio_tpu.core.pointcloud import make_cloud as jmake
    from gorio_tpu.io import native
    from gorio_tpu.io.tum import load_tum
    from gorio_tpu_torch.core.pointcloud import make_cloud as tmake

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    stamps, poses = load_tum(tum)
    pairs = [tuple(int(k) for k in p.split(":")) for p in pairs]
    keys = sorted({k for p in pairs for k in p})
    frames = {}
    for stamp, n, packed in native.NativePipelineDataset(sorted(Path(seq).glob("*.grf")),
                                                         capacity=2048):
        hit = np.flatnonzero(np.isclose(stamps[keys], stamp, atol=1e-6))
        if hit.size:
            frames[keys[hit[0]]] = np.array(packed[:n])
    jc = {k: jmake(jnp.asarray(f[:, :3]), intensity=jnp.asarray(f[:, 3]),
                   doppler=jnp.asarray(f[:, 4]), capacity=2048) for k, f in frames.items()}
    tc = {k: tmake(torch.as_tensor(f[:, :3]), intensity=torch.as_tensor(f[:, 3]),
                   doppler=torch.as_tensor(f[:, 4]), capacity=2048) for k, f in frames.items()}
    jdet, tdet = jl.LoopDetector(), tl.LoopDetector(device="cpu")
    jcoarse = jdet.gicp_cfg._replace(max_correspondence_distance=jdet.cfg.coarse_corr_dist)
    for batch in [[p] for p in pairs] + [pairs]:
        init = np.stack([np.linalg.inv(poses[m]) @ poses[i] for i, m in batch])
        pad = max(2, 1 << (len(batch) - 1).bit_length()) - len(batch)  # the JAX padding
        jb = batch + [batch[0]] * pad
        jinit = np.concatenate([init, init[:1].repeat(pad, 0)])
        js = jax.tree.map(lambda *x: jnp.stack(x), *[jc[i] for i, _ in jb])
        jt = jax.tree.map(lambda *x: jnp.stack(x), *[jc[m] for _, m in jb])
        _, jconv, _, jfit = jl._verify_batch(js, jt, jnp.asarray(jinit), jdet.gicp_cfg,
                                             jcoarse, jdet.info_cfg)
        _, tconv, _, tfit, _ = tl._verify_batch(
            tl._stack([tc[i] for i, _ in batch]), tl._stack([tc[m] for _, m in batch]),
            torch.as_tensor(init), tdet.gicp_cfg, tdet._coarse_cfg(), tdet.info_cfg)
        for n, pair in enumerate(batch):
            print(json.dumps({"batch": [list(p) for p in batch], "pair": list(pair),
                              "jax_converged": bool(jconv[n]), "jax_fitness": float(jfit[n]),
                              "torch_converged": bool(tconv[n]),
                              "torch_fitness": float(tfit[n])}), flush=True)


def _cli_slam(seq, tum):
    """The JAX CLI's `slam --optimize-every 15` on SEQ, its trajectory
    written to TUM: (its `RadarGraphSLAM`, wall seconds)."""
    import gorio_tpu.cli as cli
    import gorio_tpu.pipeline.slam as slam_mod

    made = []

    class Caught(slam_mod.RadarGraphSLAM):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    slam_mod.RadarGraphSLAM = Caught
    t0 = time.perf_counter()
    cli.main(["slam", "--dataset", str(seq), "--output", str(tum), "--optimize-every", "15"])
    return made[0], time.perf_counter() - t0


def posterior(seq, tum):
    """The JAX package's `sample_posterior` on the keyframes of its CLI's
    circuit run."""
    import jax
    import jax.numpy as jnp

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    slam, t_slam = _cli_slam(seq, tum)
    t0 = time.perf_counter()
    samples, accepts, rhat, cov = slam.sample_posterior(jax.random.PRNGKey(0))
    jax.block_until_ready(samples)
    t_post = time.perf_counter() - t0
    n = cov.shape[0]
    print(json.dumps({
        "keyframes": len(slam.keyframes), "loops": len(slam.loops), "dofs": int(n),
        "accept": float(jnp.mean(accepts)), "rhat_max": float(jnp.max(rhat)),
        "laplace_std_last_pose": float(jnp.mean(jnp.sqrt(jnp.diag(cov)[n - 6:]))),
        "finite": bool(jnp.isfinite(samples).all()), "slam_s": t_slam,
        "sample_posterior_s": t_post}), flush=True)


BOGUS_OFFSET_M, BOGUS_STDDEVS = (20.0, -15.0, 5.0), 255.0
JAX_TEST_LOOP_SQRT_INFO = 10.0  # `tests/test_smoother.py`'s loop: information 100 I, no Huber


def smoother_variants(between, idx, np_like=np.asarray):
    """`chip_smoke.py`'s smoother runs as edits of the between factors'
    fields (numpy): name -> {field: array} to replace. The first loop
    (slot `idx`) moved by [20, -15, 5] m; moved by 255 of its translation
    stddevs; and replaced by the JAX test's bogus loop (information 100 I,
    no Huber kernel, its measurement moved by [20, -15, 5] m)."""
    T = np.array(between["T_meas"])
    sq = np.array(between["sqrt_info"])[idx, 3:, 3:]
    stddev = float(np.sqrt(1.0 / np.mean(np.diag(sq.T @ sq))))

    def moved(k):
        Tk = T.copy()
        Tk[idx, :3, 3] += k * np.asarray(BOGUS_OFFSET_M)
        return Tk

    si = np.array(between["sqrt_info"])
    si[idx] = JAX_TEST_LOOP_SQRT_INFO * np.eye(6)
    rd = np.array(between["robust_delta"])
    rd[idx] = np.inf
    return stddev, {
        "true loops": {},
        "first loop moved [20, -15, 5] m": {"T_meas": moved(1.0)},
        "first loop moved 255 of its stddevs": {
            "T_meas": moved(BOGUS_STDDEVS * stddev / np.linalg.norm(BOGUS_OFFSET_M))},
        "the JAX test's bogus loop in place of the first": {
            "T_meas": moved(1.0), "sqrt_info": si, "robust_delta": rd},
    }


def smoother(seq, tum, n_particles="1024"):
    """The JAX package's `smc_loop_relaxation` (8 stages x 2 moves, one
    CPU device) and the port's on the CPU, on the JAX CLI's circuit
    keyframes built as `chip_smoke.py`'s smoother graph, with the same
    draws (rebuilt from the JAX key), in each of `smoother_variants`."""
    import jax
    import jax.numpy as jnp
    import torch
    from jax.sharding import Mesh

    from gorio_tpu.graph.graph import PoseGraph
    from gorio_tpu.inference import smoother as js
    from gorio_tpu_torch.convert import graph_from_numpy
    from gorio_tpu_torch.inference import smoother as ts

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_posterior import smoother_draws

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    slam, t_slam = _cli_slam(seq, tum)
    kfs = slam.keyframes
    g = PoseGraph()
    for kf in kfs:
        g.add_pose(kf.odom_scan2scan)
    g.add_prior(0, kfs[0].odom_scan2scan, info=np.eye(6) * slam.cfg.anchor_info)
    for k in range(1, len(kfs)):
        prev, curr = kfs[k - 1], kfs[k]
        g.add_between(k - 1, k, np.linalg.inv(prev.odom_scan2scan) @ curr.odom_scan2scan,
                      info=curr.edge_info)
        if curr.trans_integrated is not None:
            var = np.clip(np.diag(curr.preint_cov), 1e-6, None)
            g.add_between(k - 1, k, curr.trans_integrated, info=np.diag(1.0 / var))
    slots = []
    for loop in slam.loops:
        slots.append(len(g._between))
        g.add_between(loop.key_old, loop.key_new, loop.T_rel, info=loop.information,
                      robust_delta=slam.cfg.loop_robust_delta)
    poses0, data = g.freeze()
    mask = np.zeros(data.between.mask.shape[0], bool)
    mask[slots] = True
    # the preconditioner's eager `build_normal_equations` compiles per
    # primitive; the same function under `jax.jit`
    js.build_normal_equations = jax.jit(js.build_normal_equations)
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("dp",))
    N, S, M = int(n_particles), 8, 2
    key = jax.random.PRNGKey(0)
    draws = smoother_draws(key, N, poses0.shape[0] * 6, S, M)
    stddev, variants = smoother_variants(data.between._asdict(), slots[0])
    rec = {"keyframes": len(kfs), "loops": len(slots), "particles": N, "stages": S, "moves": M,
           "first_loop_stddev_m": stddev, "slam_s": t_slam}
    for name, edit in variants.items():
        bw = data.between._replace(**{k: jnp.asarray(v) for k, v in edit.items()})
        gv = data._replace(between=bw)
        t0 = time.perf_counter()
        jres = js.smc_loop_relaxation(mesh, poses0, gv, jnp.asarray(mask), n_particles=N,
                                      n_stages=S, n_moves=M)(key)
        jax.block_until_ready(jres)
        t_jax = time.perf_counter() - t0
        t0 = time.perf_counter()
        tres = ts.smc_loop_relaxation(None, torch.as_tensor(np.asarray(poses0)),
                                      graph_from_numpy(gv), mask, n_particles=N, n_stages=S,
                                      n_moves=M)(draws=draws)
        t_port = time.perf_counter() - t0
        ess = np.asarray(jres.ess_per_stage)
        rec[name] = {
            "log_evidence": float(jres.log_evidence), "ess_per_stage": ess.tolist(),
            "resampled_stages": int(np.sum(ess < 0.5 * N)),
            "accept": float(jres.accept_rate), "port_log_evidence": float(tres.log_evidence),
            "port_max_abs_diff": max(
                float(np.max(np.abs(getattr(tres, f).numpy() - np.asarray(getattr(jres, f)))))
                for f in ts.SmootherResult._fields),
            "jax_s": t_jax, "port_s": t_port}
        if name != "true loops":
            rec[name]["drop"] = rec["true loops"]["log_evidence"] - rec[name]["log_evidence"]
        print(json.dumps({name: rec[name]}), flush=True)
    print(json.dumps(rec), flush=True)


def _tool_inputs():
    sys.path.insert(0, str(ROOT / "tests"))
    import tool_inputs

    return tool_inputs


def bag(seq, out):
    """The JAX CLI's convert-bag -> slam -> evaluate on the slice's bag."""
    import jax

    import gorio_tpu.cli as cli
    import gorio_tpu.io.native as jnative
    import gorio_tpu.pipeline.slam as slam_mod
    from gorio_tpu.io.tum import ate_rmse, load_tum, rte

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    ti = _tool_inputs()
    out = Path(out)
    (out / "bag").mkdir(parents=True, exist_ok=True)
    info = ti.build_slice_bag(seq, out / "bag" / "slice.bag")
    t0 = time.perf_counter()
    cli.main(["convert-bag", str(out / "bag" / "slice.bag"), "--output", str(out / "seq"),
              *ti.CONVERT_FLAGS])
    t_convert = time.perf_counter() - t0
    made = []

    class Caught(slam_mod.RadarGraphSLAM):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    class Float64Frames(jnative.NativePipelineDataset):
        def __next__(self):
            stamp, n, packed = super().__next__()
            return stamp, n, np.asarray(packed, np.float64)

    slam_mod.RadarGraphSLAM = Caught
    jnative.NativePipelineDataset = Float64Frames
    t0 = time.perf_counter()
    ti.write_bag_config(cli.main, out / "config.json")
    cli.main(["slam", "--dataset", str(out / "seq"), "--output", str(out / "est.tum"),
              *ti.BAG_SLAM, "--config", str(out / "config.json")])
    wall = time.perf_counter() - t0
    slam = made[0]
    es, ep = load_tum(out / "est.tum")
    gs, gp = load_tum(out / "bag" / "groundtruth.tum")
    print(json.dumps({"bag": info, "convert_s": t_convert, "keyframes": len(slam.keyframes),
                      "loops": [[int(l.key_new), int(l.key_old), round(float(l.fitness), 4)]
                                for l in slam.loops],
                      **ti.gps_gates(slam, np.load(out / "seq" / "gps.npz")["t"]),
                      "first_stamp": float(es[0]),
                      "ate_m": ate_rmse(es, ep, gs, gp), "rte_m": rte(es, ep, gs, gp),
                      "wall_s": wall}), flush=True)


def utm_align(bagdir):
    """The JAX CLI's `utm-align` on the bag's ground truth and fixes."""
    import jax

    from gorio_tpu.cli import main

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    bagdir = Path(bagdir)
    main(["utm-align", str(bagdir / "groundtruth.tum"), str(bagdir / "gps_utm.txt")])


def gt_adjust(out):
    """The JAX CLI's `gt-adjust` (dense, 1,250 poses) and `align-traj`."""
    import jax

    from gorio_tpu.cli import main
    from gorio_tpu.io.tum import load_tum

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    ti = _tool_inputs()
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    ti.circuit_truth(out / "circuit_gt.tum")
    loops, _ = ti.drifty_truth(out / "circuit_gt.tum", out / "drifty.tum")
    _, before = load_tum(out / "drifty.tum")
    t0 = time.perf_counter()
    main(["gt-adjust", str(out / "drifty.tum"), str(out / "adjusted.tum"),
          *[f"--loop={pair}" for pair in loops]])
    wall = time.perf_counter() - t0
    _, after = load_tum(out / "adjusted.tum")
    print(json.dumps({"loops": loops, "wall_s": wall, "poses": len(after),
                      "end_gap_before_m": ti.end_gap(before),
                      "end_gap_after_m": ti.end_gap(after),
                      "loop_gap_before_m": ti.loop_gap(before, loops),
                      "loop_gap_after_m": ti.loop_gap(after, loops),
                      "sampled": {int(k): after[k, :3, 3].tolist()
                                  for k in ti.sampled(len(after))}}), flush=True)
    main(["align-traj", str(out / "drifty.tum"), str(out / "circuit_gt.tum"), "--scale"])


def straight(out, duration):
    """The JAX CLI's `slam` on a shortened accuracy straight, float64 frames."""
    import jax

    import gorio_tpu.cli as cli
    import gorio_tpu.io.native as jnative
    import gorio_tpu.pipeline.slam as slam_mod
    from gorio_tpu.io.tum import ate_rmse, load_tum, rte
    from gorio_tpu_torch.cli import main as torch_cli

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    out = Path(out)
    torch_cli(["simulate", "--output", str(out / "seq"), "--duration", duration, "--rate", "5",
               "--seed", "21", "--stops", "2", "--dynamic", "4", "--gps"])
    made = []

    class Caught(slam_mod.RadarGraphSLAM):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    class Float64Frames(jnative.NativePipelineDataset):
        def __next__(self):
            stamp, n, packed = super().__next__()
            return stamp, n, np.asarray(packed, np.float64)

    slam_mod.RadarGraphSLAM = Caught
    jnative.NativePipelineDataset = Float64Frames
    t0 = time.perf_counter()
    cli.main(["slam", "--dataset", str(out / "seq"), "--output", str(out / "est.tum"),
              "--fused", "--preprocess", "--floor", "--preint", "ugpm", "--no-loops",
              "--optimize-every", "15"])
    wall = time.perf_counter() - t0
    slam = made[0]
    es, ep = load_tum(out / "est.tum")
    gs, gp = load_tum(out / "seq" / "groundtruth.tum")
    print(json.dumps({"keyframes": len(slam.keyframes),
                      "loops": [[int(l.key_new), int(l.key_old), round(float(l.fitness), 4)]
                                for l in slam.loops],
                      **_tool_inputs().gps_gates(slam, np.load(out / "seq" / "gps.npz")["t"]),
                      "ate_m": ate_rmse(es, ep, gs, gp), "rte_m": rte(es, ep, gs, gp),
                      "wall_s": wall}), flush=True)


def recall(name, out):
    """The JAX CLI's `slam` on a recall sequence, float64 frames, analysed."""
    import jax

    import gorio_tpu.cli as cli
    import gorio_tpu.io.native as jnative
    import gorio_tpu.pipeline.slam as slam_mod
    from gorio_tpu.io.tum import ate_rmse, load_tum, rte
    from gorio_tpu_torch.cli import main as torch_cli

    sys.path.insert(0, str(ROOT / "scripts"))
    import recall_benchmark as rb

    assert jax.config.jax_enable_x64, "run with JAX_ENABLE_X64=1"
    out = Path(out)
    torch_cli(["simulate", "--output", str(out / "seq"), *rb.SEQUENCES[name]["simulate"]])
    made = []

    class Caught(slam_mod.RadarGraphSLAM):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    class Float64Frames(jnative.NativePipelineDataset):
        def __next__(self):
            stamp, n, packed = super().__next__()
            return stamp, n, np.asarray(packed, np.float64)

    slam_mod.RadarGraphSLAM = Caught
    jnative.NativePipelineDataset = Float64Frames
    t0 = time.perf_counter()
    cli.main(["slam", "--dataset", str(out / "seq"), "--output", str(out / "est.tum"),
              *rb.SLAM_ARGS])
    wall = time.perf_counter() - t0
    slam = made[0]
    es, ep = load_tum(out / "est.tum")
    gs, gp = load_tum(out / "seq" / "groundtruth.tum")
    stamps = [kf.stamp for kf in slam.keyframes]
    loops = [(int(l.key_new), int(l.key_old), round(float(l.fitness), 4)) for l in slam.loops]
    pos = rb.gt_at(np.asarray(stamps), gs, gp[:, :3, 3])
    print(json.dumps({"name": name, **rb.analyze(stamps, loops, gs, gp[:, :3, 3]),
                      "loops": loops,
                      "loop_gaps_m": [round(float(np.linalg.norm(pos[i] - pos[j])), 3)
                                      for i, j, _ in loops],
                      "gate_counts": slam.loop_detector.gate_counts,
                      "ate_m": ate_rmse(es, ep, gs, gp), "rte_m": rte(es, ep, gs, gp),
                      "wall_s": wall}), flush=True)


def candidates_diff(a, b):
    """Print where two `candidates` records differ."""
    ra, rb = (json.loads(Path(p).read_text()) for p in (a, b))
    print("gate counts differ:", {k: (ra["gate_counts"].get(k), rb["gate_counts"].get(k))
                                  for k in set(ra["gate_counts"]) | set(rb["gate_counts"])
                                  if ra["gate_counts"].get(k) != rb["gate_counts"].get(k)})
    fa, fb = ({tuple(x) for x in r["fallbacks"]} for r in (ra, rb))
    print("gated fallback matches only in the first:", sorted(fa - fb))
    print("gated fallback matches only in the second:", sorted(fb - fa))
    la, lb = ({(c["new"], c["old"]): c for c in r["candidate_log"]} for r in (ra, rb))
    for pair in sorted(set(la) | set(lb)):
        ca, cb = la.get(pair), lb.get(pair)
        if (ca is None or cb is None or ca["gate"] != cb["gate"]
                or ca.get("not_converged") != cb.get("not_converged")):
            print("verified pair", pair, "first:", ca, "second:", cb)
    print("loops equal:", ra["loops"] == rb["loops"])


if __name__ == "__main__":
    if sys.argv[1] == "candidates":
        candidates(*sys.argv[2:5])
    elif sys.argv[1] == "candidates-diff":
        candidates_diff(*sys.argv[2:4])
    elif sys.argv[1] == "verify-pairs":
        verify_pairs(*sys.argv[2:])
    elif sys.argv[1] == "posterior":
        posterior(*sys.argv[2:4])
    elif sys.argv[1] == "smoother":
        smoother(*sys.argv[2:5])
    elif sys.argv[1] == "preint-chunked":
        preint_chunked()
    else:
        {"scan-to-map": scan_to_map, "align": align, "slice-map": slice_map,
         "cg-slice": cg_slice, "bag": bag, "utm-align": utm_align,
         "gt-adjust": gt_adjust, "straight": straight, "recall": recall}[sys.argv[1]](
            *sys.argv[2:])
