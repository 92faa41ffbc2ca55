"""Port parity: `gorio_tpu_torch.pipeline` (odometry, keyframes, slam)
against `gorio_tpu.pipeline`: per-frame odometry poses and statuses on the
same float64 scans and ego velocities, with and without the IMU fallback and
roll/pitch fusion; the keyframe decisions on the resulting poses; and the
back-end (LPM preintegration, fitness-based edge information, GPS priors,
dense solve) on the same frames.

Tolerance: each frame is one GICP align (deterministic float64, same
iteration count) plus host numpy, so poses agree to 1e-9; the back-end's
solve to 1e-8."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gorio_tpu.io.synthetic import make_world, render_radar_scan, sample_imu, simulate_trajectory
from gorio_tpu.pipeline import keyframes as jk
from gorio_tpu.pipeline import odometry as jo
from gorio_tpu.pipeline import slam as js
from gorio_tpu_torch.convert import cloud_from_numpy, config_from_dict
from gorio_tpu_torch.pipeline import keyframes as tk
from gorio_tpu_torch.pipeline import odometry as to
from gorio_tpu_torch.pipeline import slam as ts


@pytest.fixture(scope="module")
def frames():
    traj = simulate_trajectory(seed=0, duration=3.0)
    imu = sample_imu(traj, seed=1)
    world = make_world(seed=2, n_landmarks=4000)
    out = []
    for i, t in enumerate(np.arange(0.2, 2.4, 0.25)):
        R, p = traj.interp_pose(np.array([t]))
        v = np.array([np.interp(t, traj.t, traj.v_body[:, k]) for k in range(3)])
        cloud = render_radar_scan(world, R[0], p[0], v, capacity=512, seed=1000 + i,
                                  azimuth_fov_deg=56.5, elevation_fov_deg=22.5)
        q = Rotation.from_matrix(R[0]).as_quat()  # x y z w
        out.append((float(t), cloud, v, np.array([q[3], q[0], q[1], q[2]]), p[0]))
    return out, imu


@pytest.mark.parametrize("imu", [False, True])
def test_odometry_steps_match_jax(frames, imu):
    kw = dict(enable_imu_fusion=True, max_acceptable_trans=0.3, max_diff_trans=0.05) if imu else {}
    jcfg = jo.OdometryConfig(**kw)
    jodo = jo.ScanMatchingOdometry(jcfg)
    todo = to.ScanMatchingOdometry(config_from_dict(to.OdometryConfig, jcfg._asdict()))
    jupd, tupd = jk.KeyframeUpdater(), tk.KeyframeUpdater()
    for stamp, cloud, v, quat, _ in frames[0]:
        if imu:
            for o in (jodo, todo):
                o.push_imu(stamp, quat)
        jpose = jodo.step(stamp, cloud, v)
        tpose = todo.step(stamp, cloud_from_numpy(cloud), v)
        np.testing.assert_allclose(tpose, jpose, atol=1e-9)
        assert tupd.decide(tpose, stamp) == jupd.decide(jpose, stamp)
        assert tupd.accum_distance == pytest.approx(jupd.accum_distance, abs=1e-9)
    assert len(todo.statuses) == len(jodo.statuses) == len(frames[0]) - 1
    for ts, js in zip(todo.statuses, jodo.statuses):
        assert ts.converged == js.converged and ts.used_prediction == js.used_prediction
        np.testing.assert_allclose(ts.matching_error, js.matching_error, rtol=1e-9)
        np.testing.assert_allclose(ts.inlier_fraction, js.inlier_fraction, rtol=1e-12)
        assert ts.iterations > 0
    if imu:  # the gates fired and the IMU fallback replaced those transforms
        assert any(s.used_prediction for s in todo.statuses)


def test_slam_backend_matches_jax(frames):
    """Keyframes every frame, LPM between them, GPS fixes 6 m off the
    trajectory (so the drift gate lets their priors in), dense solve."""
    frames, imu = frames
    kw = dict(enable_loop_closure=False, keyframe_delta_trans=0.0, keyframe_delta_angle=0.0,
              gyr_var=imu.gyr_var, vel_var=imu.vel_var, gps_edge_intervals=2)
    jslam = js.RadarGraphSLAM(js.SLAMConfig(**kw))
    tslam = ts.RadarGraphSLAM(config_from_dict(ts.SLAMConfig, jslam.cfg._asdict()),
                              device="cpu")
    rng = np.random.default_rng(0)
    for s in (jslam, tslam):
        for t, g in zip(imu.gyr_t, imu.gyr):
            s.push_imu(t, g)
        for t, v in zip(imu.vel_t, imu.vel):
            s.push_twist(t, v)
    for stamp, cloud, _, quat, p in frames:
        fix = p + np.array([6.0, 0.0, 0.0]) + 0.1 * rng.normal(size=3)
        for s in (jslam, tslam):
            s.push_gps(stamp, fix, cov=np.array([0.5, 0.5, 1.0]))
    pose = np.eye(4)
    for k, (stamp, cloud, v, _, _) in enumerate(frames):
        pose = pose.copy()
        pose[:3, 3] += v * 0.25 + 0.01 * rng.normal(size=3)
        assert jslam.add_frame(stamp, cloud, pose) == tslam.add_frame(
            stamp, cloud_from_numpy(cloud), pose)
    assert jslam.keyframes[0].trans_integrated is tslam.keyframes[0].trans_integrated is None
    for a, b in zip(jslam.keyframes[1:], tslam.keyframes[1:]):
        np.testing.assert_allclose(b.trans_integrated, a.trans_integrated, atol=1e-10)
        np.testing.assert_allclose(b.preint_cov, a.preint_cov, rtol=1e-9, atol=1e-15)
    jopt, topt = jslam.optimize(), tslam.optimize()
    assert sum(bool(getattr(kf, "_gps_edge", False)) for kf in tslam.keyframes) >= 2
    for a, b in zip(jslam.keyframes, tslam.keyframes):
        if a.edge_info is not None:  # keyframe 0 has no odometry edge
            np.testing.assert_allclose(b.edge_info, a.edge_info, rtol=1e-10)
        assert getattr(a, "_gps_edge", False) == getattr(b, "_gps_edge", False)
    np.testing.assert_allclose(topt, jopt, atol=1e-8)
    for a, b in zip(jslam.trajectory(), tslam.trajectory()):
        np.testing.assert_allclose(b, a, atol=1e-8)


def test_unported_slam_modes_raise(frames):
    """UGPM and the floor constraint run now (`test_torch_frontend.py`), and
    so does `solver="cg"`: the joint pose + floor-plane solve that the back
    end reaches runs CG (counted under "cg") and, on this 4-pose graph
    (27 coordinates, fewer than its 100 CG steps), ends at the dense
    solve's poses. An unknown preintegration mode is refused up front."""
    from gorio_tpu_torch.graph.solver import SolveConfig

    with pytest.raises(ValueError, match="preint_mode"):
        ts.RadarGraphSLAM(ts.SLAMConfig(preint_mode="imu"), device="cpu")
    out = {}
    for solver in ("cg", "dense"):
        slam = ts.RadarGraphSLAM(ts.SLAMConfig(
            enable_loop_closure=False, enable_preintegration=False,
            enable_floor_constraint=True, keyframe_delta_trans=0.0,
            solve=SolveConfig(solver=solver)), device="cpu")
        for stamp, cloud, _, _, p in frames[0][:3]:
            pose = np.eye(4)
            pose[:3, 3] = p
            slam.add_frame(stamp, cloud_from_numpy(cloud), pose,
                           floor_coeffs=np.array([0.0, 0.0, 1.0, 1.8]))
        out[solver] = slam.optimize()
        assert slam.solver_counts["dense_planes"] == 1
        assert slam.solver_counts["cg"] == (solver == "cg")
    np.testing.assert_allclose(out["cg"], out["dense"], rtol=0, atol=1e-6)


def test_slam_defaults_to_the_card():
    """`RadarGraphSLAM()` targets CUDA; without a card it raises instead of
    falling back to the CPU (as the CLI's `--device cuda` does)."""
    assert ts.RadarGraphSLAM.device == torch.device("cuda")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.RadarGraphSLAM()
    assert ts.RadarGraphSLAM(device="cpu").device == torch.device("cpu")
