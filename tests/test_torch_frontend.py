"""Port parity: the preprocessing front end (`core.pointcloud.distance_filter`,
`estimators.{covariances,deskew,groundseg,clustering}`,
`pipeline.preprocessing`), the fused odometry step and the SLAM back end
with the floor constraint and UGPM, against the JAX package.

`jax.random.choice` cannot be reproduced with torch's generators, so the
RANSAC hypotheses of each ego-velocity estimate are drawn with JAX exactly
as the JAX package draws them for its key and handed to the port
(`hyp_idx`). Tolerances, float64 unless stated:
- point-wise maps (distance gate, polar covariances, deskew): 1e-12;
- ground segmentation: masks and patch decisions equal; the plane within
  1e-9 rad / 1e-9 m in float64, 1e-4 rad / 1e-3 m in float32 (the 3x3 and
  4x4 `eigh` of another LAPACK path, the segment sums in another order);
  the fit does not depend on the basis `eigh` returns for a repeated
  smallest eigenvalue (the port's pick is basis-free; LAPACK's, which the
  JAX package keeps, is not: `test_step_fused_matches_jax` hands the port
  that pick);
- DBSCAN: cluster ids equal (they index APDGICP's payload);
- the fused step: poses to 1e-8, ground counts equal, planes to 1e-9;
- the back end: UGPM's deltas to 1e-8, its covariance to 1e-7 of its
  largest entry (keyframe windows on the sample lattice, unlike
  `test_torch_ugpm.py`'s), optimized poses and the floor plane to 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorio_tpu.core import pointcloud as jpc
from gorio_tpu.estimators import clustering as jcl
from gorio_tpu.estimators import covariances as jcov
from gorio_tpu.estimators import deskew as jdk
from gorio_tpu.estimators import egovel as je
from gorio_tpu.estimators import groundseg as jgs
from gorio_tpu.io.synthetic import (make_dynamic_objects, make_world, render_radar_scan,
                                    sample_imu, simulate_trajectory)
from gorio_tpu.pipeline import odometry as jo
from gorio_tpu.pipeline import preprocessing as jpp
from gorio_tpu.pipeline import slam as js
from gorio_tpu_torch.convert import cloud_from_numpy, config_from_dict
from gorio_tpu_torch.core import pointcloud as tpc
from gorio_tpu_torch.estimators import clustering as tcl
from gorio_tpu_torch.estimators import covariances as tcov
from gorio_tpu_torch.estimators import deskew as tdk
from gorio_tpu_torch.estimators import groundseg as tgs
from gorio_tpu_torch.pipeline import odometry as to
from gorio_tpu_torch.pipeline import preprocessing as tpp
from gorio_tpu_torch.pipeline import slam as ts

CAP = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small tensors run fastest on one CPU thread, and the test
    files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def drive():
    """A 1.7 s drive through the synthetic world of the CLI's `simulate`
    (ground at z = -1.8, walls, boxes, 9000 landmarks; two moving objects),
    scans at half its capacity: per frame (stamp, cloud, body velocity,
    pose R, p), plus the IMU streams."""
    traj = simulate_trajectory(seed=0, duration=3.0)
    imu = sample_imu(traj, seed=1)
    world = make_world(seed=2, n_landmarks=9000)
    objects = make_dynamic_objects(seed=9, n_objects=2, extent=15.0)
    out = []
    for i, t in enumerate(np.arange(0.2, 1.95, 0.25)):
        R, p = traj.interp_pose(np.array([t]))
        v = np.array([np.interp(t, traj.t, traj.v_body[:, k]) for k in range(3)])
        dpts, dvel = objects.points_at(t)
        cloud = render_radar_scan(world, R[0], p[0], v, capacity=CAP, seed=1000 + i,
                                  dynamic_points=dpts, dynamic_vel=dvel,
                                  azimuth_fov_deg=56.5, elevation_fov_deg=22.5)
        out.append((float(t), cloud, v, R[0], p[0]))
    return out, imu


def _to_dtype(cloud, dtype):
    """A JAX `PointCloud` with its float fields cast (numpy arrays)."""
    return cloud._replace(**{f: np.asarray(getattr(cloud, f)).astype(dtype)
                             for f in ("xyz", "intensity", "doppler")})


def _jax_hypotheses(cloud, cfg, key):
    """The (iters, k) indices `estimate_ego_velocity` draws for `key`."""
    valid, _ = je._gate(cloud, cfg)
    w = valid.astype(cloud.xyz.dtype)
    p = w / jnp.maximum(jnp.sum(w), 1.0)
    return np.asarray(jax.random.choice(key, cloud.capacity,
                                        shape=(cfg.ransac_iter, cfg.n_ransac_points),
                                        replace=True, p=p))


def _jax_pp_hypotheses(cloud, cfg, key):
    """The hypotheses `preprocess_frame` draws: on the power- and
    distance-gated cloud."""
    c = jpc.filter_cloud(cloud, cloud.intensity > cfg.power_threshold)
    c = jpc.distance_filter(c, cfg.min_distance, cfg.max_distance, cfg.min_z, cfg.max_z)
    return _jax_hypotheses(c, cfg.egovel, key)


def _assert_cloud(tc, jc, atol=1e-12):
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_allclose(tc.xyz.numpy(), np.asarray(jc.xyz), rtol=0, atol=atol)
    np.testing.assert_array_equal(tc.cluster.numpy(), np.asarray(jc.cluster).astype(np.float64))


def _plane_gap(a, b):
    """(angle between the normals in rad, offset difference)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = np.clip(a[:3] @ b[:3] / np.linalg.norm(a[:3]) / np.linalg.norm(b[:3]), -1.0, 1.0)
    return float(np.arccos(cos)), float(abs(a[3] - b[3]))


def test_distance_filter_and_polar_covariances_match_jax(drive):
    cloud = drive[0][3][1]
    got = tpc.distance_filter(cloud_from_numpy(cloud), 2.0, 30.0, -1.5, 3.0)
    want = jpc.distance_filter(cloud, 2.0, 30.0, -1.5, 3.0)
    _assert_cloud(got, want)
    assert 0 < int(got.mask.sum()) < int(np.asarray(cloud.mask).sum())
    xyz = np.asarray(cloud.xyz)[np.asarray(cloud.mask)]
    np.testing.assert_allclose(tcov.polar_covariances(torch.as_tensor(xyz)).numpy(),
                               np.asarray(jcov.polar_covariances(jnp.asarray(xyz))),
                               rtol=1e-12, atol=1e-15)


def test_deskew_matches_jax(drive):
    cloud = drive[0][5][1]
    omega = np.array([0.05, -0.1, 0.6])
    got = tdk.deskew(cloud_from_numpy(cloud), torch.as_tensor(omega), 0.1)
    want = jdk.deskew(cloud, jnp.asarray(omega), 0.1)
    _assert_cloud(got, want)
    moved = np.linalg.norm(got.xyz.numpy() - np.asarray(cloud.xyz), axis=1)
    assert moved[np.asarray(cloud.mask)].max() > 1e-3  # the rotation did something


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("agle", [False, True])
def test_estimate_ground_matches_jax(drive, dtype, agle):
    """Patchwork++ on radar scans, cold (no A-GLE state, the fused path's
    call) and with an A-GLE state warmed by two frames; `update_agle` too."""
    frames = drive[0]
    jcfg = jgs.GroundSegConfig()
    tcfg = config_from_dict(tgs.GroundSegConfig, jcfg._asdict())
    jst = jgs.AGLEState.init(getattr(jnp, dtype), cfg=jcfg) if agle else None
    tst = tgs.AGLEState.init(getattr(torch, dtype), cfg=tcfg) if agle else None
    n_ground = 0
    for _, cloud, _, _, _ in frames[2:5]:
        jc = _to_dtype(cloud, dtype)
        want = jgs.estimate_ground(jc, jcfg, jst)
        got = tgs.estimate_ground(cloud_from_numpy(jc), tcfg, tst)
        for f in ("ground_mask", "nonground_mask", "removed_mask", "patch_valid", "patch_stored"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                          err_msg=f)
        ang, off = _plane_gap(got.plane.numpy(), want.plane)
        ang_lim, off_lim = (1e-9, 1e-9) if dtype == "float64" else (1e-4, 1e-3)
        assert got.plane.dtype == getattr(torch, dtype), got.plane.dtype
        assert ang < ang_lim and off < off_lim, (ang, off)
        n_ground += int(got.ground_mask.sum())
        if agle:
            jst = jgs.update_agle(jst, want, jcfg)
            tst = tgs.update_agle(tst, got, tcfg)
            for f in jgs.AGLEState._fields:
                np.testing.assert_allclose(getattr(tst, f).numpy(), np.asarray(getattr(jst, f)),
                                           rtol=1e-9 if dtype == "float64" else 1e-4,
                                           atol=1e-12 if dtype == "float64" else 1e-5, err_msg=f)
    assert n_ground > 50  # the scans see the floor


def _rotated_eigh(eigh):
    """`eigh` as another solver could return it: where the two smallest
    eigenvalues are equal (within the port's 100 eps), their eigenvectors
    turned by 0.7 rad inside their eigenspace."""
    def rotated(A):
        ev, V = eigh(A)
        tol = 100 * torch.finfo(A.dtype).eps * torch.amax(torch.abs(ev), dim=-1, keepdim=True)
        pair = ((ev[..., 1:2] - ev[..., :1]) <= tol)[..., None, :]
        c, s = np.cos(0.7), np.sin(0.7)
        v0, v1 = V[..., :, 0:1], V[..., :, 1:2]
        return ev, torch.cat([torch.where(pair, c * v0 + s * v1, v0),
                              torch.where(pair, c * v1 - s * v0, v1), V[..., :, 2:]], dim=-1)
    return rotated


def _lapack_pick(A):
    """The JAX package's rule: the first eigenvector as the solver returns it."""
    ev, V = torch.linalg.eigh(A)
    return ev, V[..., :, 0]


def test_eigh_smallest_picks_a_basis_free_vector(monkeypatch):
    """A simple smallest eigenvalue gives `eigh`'s own eigenvector; a
    repeated one (two points, two equal axes in 4D, a multiple of the
    identity, an eigenspace without z) a unit vector of its eigenspace
    that stays the same when the solver turns its basis: z's projection,
    else x's, and x for a multiple of the identity."""
    rng = np.random.default_rng(5)
    Q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    d = rng.normal(size=3)  # the gap between two points: a rank-1 covariance
    two_pts = np.outer(d, d) / 4 + 1e-12 * np.eye(3)
    x_line = np.diag([4.0, 0.0, 0.0]) + 1e-12 * np.eye(3)  # the points differ in x only
    z_line = np.diag([0.0, 0.0, 4.0]) + 1e-12 * np.eye(3)  # ... in z only
    cases = {3: np.stack([Q @ np.diag([0.5, 2.0, 3.0]) @ Q.T, two_pts, x_line, z_line,
                          1e-12 * np.eye(3)]),
             4: np.stack([np.diag([7.0, 7.0, 9.0, 11.0]), 1e-9 * np.eye(4)])}
    for n, A in cases.items():
        A = torch.as_tensor(A)
        ev, v = tgs._eigh_smallest(A)
        ev_ref, V_ref = torch.linalg.eigh(A)
        torch.testing.assert_close(ev, ev_ref, rtol=0, atol=0)
        torch.testing.assert_close(torch.linalg.norm(v, dim=-1), torch.ones(len(A), dtype=A.dtype),
                                   rtol=0, atol=1e-14)
        residual = torch.einsum("bij,bj->bi", A, v) - ev[:, :1] * v
        assert float(residual.abs().max()) < 1e-13  # an eigenvector of the smallest
        with monkeypatch.context() as m:
            m.setattr(torch.linalg, "eigh", _rotated_eigh(torch.linalg.eigh))
            _, v_rot = tgs._eigh_smallest(A)
            _, v_lapack_rot = _lapack_pick(A)
        torch.testing.assert_close(v_rot, v, rtol=0, atol=1e-14)
        if n == 3:
            torch.testing.assert_close(v[0], V_ref[0, :, 0], rtol=0, atol=0)  # simple
            assert not torch.allclose(v_lapack_rot[1], v[1], atol=1e-3)  # the raw pick moves
            assert abs(float(v[1] @ (A[1] @ v[1]))) < 1e-11  # a plane through both points,
            # the most horizontal one
            assert float(v[1, 2]) == pytest.approx(np.sqrt(1 - d[2] ** 2 / (d @ d)), abs=1e-12)
            torch.testing.assert_close(v[2], torch.eye(3, dtype=A.dtype)[2], rtol=0, atol=0)
            torch.testing.assert_close(v[3], torch.eye(3, dtype=A.dtype)[0], rtol=0, atol=0)
        # a multiple of the identity: LAPACK's pick, the first axis
        torch.testing.assert_close(v[-1], torch.eye(n, dtype=A.dtype)[0], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ground_fit_is_basis_free(drive, monkeypatch, dtype):
    """The preprocessing chain (deskew on) with `eigh`'s repeated-eigenvalue
    bases turned as another solver could turn them: the same ground masks
    and plane. With LAPACK's raw pick (the JAX package's rule) the same
    turn moves the ground counts of these frames, by up to twice."""
    frames, imu = drive
    jcfg, tcfg = jpp.PreprocessConfig(), tpp.PreprocessConfig()
    moved = 0
    for k in (0, 1, 3):
        stamp, cloud = frames[k][0], _to_dtype(frames[k][1], dtype)
        omega = torch.as_tensor(imu.gyr[np.clip(np.searchsorted(imu.gyr_t, stamp) - 1, 0, None)])
        hyp = _jax_pp_hypotheses(cloud, jcfg, jax.random.PRNGKey(k))
        outs = {}
        for name, rotate, pick in [("port", False, tgs._eigh_smallest),
                                   ("port turned", True, tgs._eigh_smallest),
                                   ("lapack", False, _lapack_pick),
                                   ("lapack turned", True, _lapack_pick)]:
            with monkeypatch.context() as m:
                m.setattr(tgs, "_eigh_smallest", pick)
                if rotate:
                    m.setattr(torch.linalg, "eigh", _rotated_eigh(torch.linalg.eigh))
                got, _ = tpp.preprocess_frame(cloud_from_numpy(cloud), omega.to(getattr(torch, dtype)),
                                              tcfg, hyp_idx=hyp)
            outs[name] = (got.ground_mask.numpy(), got.plane.numpy())
        np.testing.assert_array_equal(outs["port turned"][0], outs["port"][0])
        np.testing.assert_array_equal(outs["port turned"][1], outs["port"][1])
        assert outs["port"][0].sum() > 20
        moved += int(outs["lapack turned"][0].sum() != outs["lapack"][0].sum())
    assert moved >= 2


def test_ground_plane_of_a_flat_scene_matches_jax():
    """A dense floor at z = -0.7 plus two boxes: the refined plane is the
    floor, and the port's equals the JAX package's."""
    rng = np.random.default_rng(0)
    ground = np.concatenate([rng.uniform(-20, 20, (600, 2)), -0.7 + 0.03 * rng.normal(size=(600, 1))],
                            axis=1)
    boxes = np.concatenate([[8.0, 3.0, 0.3] + rng.normal(size=(150, 3)) * [0.8, 0.4, 0.5],
                            [15.0, -6.0, 0.5] + rng.normal(size=(150, 3)) * [0.5, 0.5, 0.8]])
    cloud = jpc.make_cloud(np.concatenate([ground, boxes]), intensity=10 + np.zeros(900),
                           capacity=1024)
    want = jgs.estimate_ground(cloud, jgs.GroundSegConfig())
    got = tgs.estimate_ground(cloud_from_numpy(cloud), tgs.GroundSegConfig())
    np.testing.assert_array_equal(got.ground_mask.numpy(), np.asarray(want.ground_mask))
    ang, off = _plane_gap(got.plane.numpy(), want.plane)
    assert ang < 1e-9 and off < 1e-9
    assert got.plane[2] > 0.99 and abs(float(got.plane[3]) - 0.7) < 0.05


@pytest.mark.parametrize("adaptive", [False, True])
def test_dbscan_ids_equal_jax(drive, adaptive):
    """On a radar scan (walls, boxes, moving objects) and on two blobs with
    noise: the same cluster ids point for point."""
    jcfg = jcl.DBSCANConfig(adaptive_eps=adaptive)
    tcfg = config_from_dict(tcl.DBSCANConfig, jcfg._asdict())
    rng = np.random.default_rng(3)
    blobs = np.concatenate([[5.0, 0.0, 0.0] + 0.2 * rng.normal(size=(60, 3)),
                            [12.0, 4.0, 0.0] + 0.2 * rng.normal(size=(80, 3)),
                            rng.uniform(-30, 30, size=(40, 3))])
    clouds = [drive[0][k][1] for k in (1, 6)] + [jpc.make_cloud(blobs, capacity=256)]
    n_clusters = []
    for cloud in clouds:
        want = np.asarray(jcl.dbscan_cluster(cloud, jcfg).cluster)
        got = tcl.dbscan_cluster(cloud_from_numpy(cloud), tcfg).cluster.numpy()
        np.testing.assert_array_equal(got, want)
        n_clusters.append(int(got.max()))
    assert min(n_clusters) >= 2  # ranked clusters, not all noise


@pytest.mark.parametrize("deskew_omega", [None, (0.02, -0.05, 0.4)])
def test_preprocess_frame_matches_jax(drive, deskew_omega):
    """The whole chain (gates, ego-velocity with dynamic-object removal,
    deskew, ground segmentation and under-ground removal, DBSCAN ids) on the
    same hypotheses."""
    jcfg = jpp.PreprocessConfig(enable_deskew=deskew_omega is not None)
    tcfg = config_from_dict(tpp.PreprocessConfig, jcfg._asdict())
    omega = np.zeros(3) if deskew_omega is None else np.asarray(deskew_omega)
    for k in (2, 6):
        cloud = drive[0][k][1]
        key = jax.random.PRNGKey(k)
        want, _ = jpp.preprocess_frame(cloud, jnp.asarray(omega), jcfg, key=key)
        got, agle = tpp.preprocess_frame(cloud_from_numpy(cloud), torch.as_tensor(omega), tcfg,
                                         hyp_idx=_jax_pp_hypotheses(cloud, jcfg, key))
        assert agle is None
        _assert_cloud(got.cloud, want.cloud)
        np.testing.assert_allclose(got.ego.v.numpy(), np.asarray(want.ego.v), rtol=1e-10, atol=1e-12)
        np.testing.assert_array_equal(got.ego.inlier_mask.numpy(), np.asarray(want.ego.inlier_mask))
        np.testing.assert_array_equal(got.ground_mask.numpy(), np.asarray(want.ground_mask))
        ang, off = _plane_gap(got.plane.numpy(), want.plane)
        assert ang < 1e-9 and off < 1e-9
        assert int(got.cloud.cluster.max()) >= 1


@pytest.mark.parametrize("method", ["statistical", "radius"])
def test_preprocess_with_outlier_filter_matches_jax(drive, method):
    """The chain with the statistical or radius outlier filter after the
    gates (`estimators/outliers.py`), on the hypotheses the JAX package
    draws from the filtered cloud: the same masks, ids and plane."""
    from gorio_tpu.estimators import outliers as jol

    jcfg = jpp.PreprocessConfig(outlier_method=method)
    tcfg = config_from_dict(tpp.PreprocessConfig, jcfg._asdict())
    cloud = drive[0][3][1]
    key = jax.random.PRNGKey(3)
    want, _ = jpp.preprocess_frame(cloud, jnp.zeros(3), jcfg, key=key)
    c = jpc.filter_cloud(cloud, cloud.intensity > jcfg.power_threshold)
    c = jpc.distance_filter(c, jcfg.min_distance, jcfg.max_distance, jcfg.min_z, jcfg.max_z)
    c = (jol.statistical_outlier_removal(c, jcfg.statistical_mean_k, jcfg.statistical_stddev)
         if method == "statistical"
         else jol.radius_outlier_removal(c, jcfg.radius_radius, jcfg.radius_min_neighbors))
    assert int(jnp.sum(c.mask)) < int(jnp.sum(jpc.distance_filter(
        cloud, jcfg.min_distance, jcfg.max_distance, jcfg.min_z, jcfg.max_z).mask))
    got, _ = tpp.preprocess_frame(cloud_from_numpy(cloud), torch.zeros(3, dtype=torch.float64),
                                  tcfg, hyp_idx=_jax_hypotheses(c, jcfg.egovel, key))
    _assert_cloud(got.cloud, want.cloud)
    np.testing.assert_array_equal(got.ground_mask.numpy(), np.asarray(want.ground_mask))
    ang, off = _plane_gap(got.plane.numpy(), want.plane)
    assert ang < 1e-9 and off < 1e-9


@pytest.mark.cuda
def test_frontend_sums_repeat_to_the_bit_on_the_card(drive):
    """Ground segmentation and DBSCAN sum floats per patch / cluster with a
    sorted, segmented reduction, not atomics: two runs on one scan on the
    card are bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cloud = cloud_from_numpy(drive[0][3][1], device="cuda")
    for run in (lambda: tgs.estimate_ground(cloud, tgs.GroundSegConfig()),
                lambda: tcl.dbscan_cluster(cloud, tcl.DBSCANConfig())):
        first, again = run(), run()
        for f, a, b in zip(first._fields, first, again):
            if isinstance(a, torch.Tensor):
                assert a.device.type == "cuda" and torch.equal(a, b), f


def test_segment_sum_by_id_matches_index_add():
    """The sorted segmented sum equals `index_add_` on the CPU (rows in row
    order per id) for 1-D and matrix rows; ids outside [0, n) count nowhere."""
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(-1, 9, (500,), generator=g)
    for shape in ((500,), (500, 3, 3)):
        x = torch.randn(shape, generator=g, dtype=torch.float64)
        keep = ((ids >= 0) & (ids < 7)).reshape(-1, *([1] * (x.dim() - 1)))
        want = torch.zeros((7,) + shape[1:], dtype=x.dtype).index_add_(
            0, ids.clamp(0, 6), torch.where(keep, x, 0.0))
        torch.testing.assert_close(tpc.segment_sum_by_id(x, ids, 7), want, rtol=0, atol=1e-12)


def _packed(cloud):
    """The native reader's frame: valid rows first, zero-padded to CAP."""
    m = np.asarray(cloud.mask)
    rows = np.concatenate([np.asarray(cloud.xyz)[m], np.asarray(cloud.intensity)[m, None],
                           np.asarray(cloud.doppler)[m, None]], axis=1)
    out = np.zeros((CAP, 5))
    out[: len(rows)] = rows
    return out, len(rows)


@pytest.mark.parametrize("mode", ["plain", "ground", "preprocess"])
def test_step_fused_matches_jax(drive, mode, monkeypatch):
    """`ScanMatchingOdometry.step_fused` frame by frame: without
    preprocessing, with the ground fit fused in (`ground=True`), and with the
    full preprocessing chain and deskew (the `--fused --preprocess --floor`
    path). Same poses, ego velocities, ground counts and planes, statuses.
    The first frame's chain has two-point ground patches, where the port's
    basis-free pick and LAPACK's differ (35 vs 51 ground points): the port
    runs with LAPACK's pick here, the pick itself is held by
    `test_ground_fit_is_basis_free`."""
    monkeypatch.setattr(tgs, "_eigh_smallest", _lapack_pick)
    frames, imu = drive[0][:5], drive[1]
    jodo, todo = jo.ScanMatchingOdometry(), to.ScanMatchingOdometry()
    if mode == "preprocess":
        jodo.preprocess_cfg = jpp.PreprocessConfig()
        todo.preprocess_cfg = tpp.PreprocessConfig()
    ground = mode != "plain"
    n_ground = 0
    for idx, (stamp, cloud, _, _, _) in enumerate(frames):
        packed, n = _packed(cloud)
        omega = None
        if mode == "preprocess":
            omega = imu.gyr[np.clip(np.searchsorted(imu.gyr_t, stamp) - 1, 0, None)]
        key = jax.random.fold_in(jax.random.PRNGKey(0), idx)
        jcloud = jo._cloud_from_packed(jnp.asarray(packed), n)
        hyp = (_jax_pp_hypotheses(jcloud, jodo.preprocess_cfg, key) if mode == "preprocess"
               else _jax_hypotheses(jcloud, jodo.cfg.egovel, key))
        jpose, jv = jodo.step_fused(stamp, packed, n, ground=ground, omega=omega)
        tpose, tv = todo.step_fused(stamp, torch.as_tensor(packed), n, ground=ground,
                                    omega=omega, hyp_idx=hyp)
        np.testing.assert_allclose(tpose, jpose, rtol=0, atol=1e-8, err_msg=f"frame {idx}")
        np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-10, atol=1e-12)
        if ground:
            assert todo.last_ground_count == jodo.last_ground_count
            ang, off = _plane_gap(todo.last_plane, jodo.last_plane)
            assert ang < 1e-9 and off < 1e-9
            n_ground += todo.last_ground_count
        _assert_cloud(todo.last_cloud, jodo.last_cloud, atol=1e-12)
    assert len(todo.statuses) == len(jodo.statuses) == len(frames) - 1
    assert n_ground > 0 or not ground
    for a, b in zip(todo.statuses, jodo.statuses):
        assert a.converged == b.converged and a.used_prediction == b.used_prediction
        np.testing.assert_allclose(a.matching_error, b.matching_error, rtol=1e-8)
        np.testing.assert_allclose(a.inlier_fraction, b.inlier_fraction, rtol=1e-12)
        assert a.iterations > 0


@pytest.mark.parametrize("solver", ["dense", "sparse"])
def test_slam_floor_and_ugpm_match_jax(drive, solver):
    """The back end with UGPM preintegration and the floor constraint: a
    keyframe per frame, each with the JAX package's ground fit as its
    `floor_coeffs`; the joint pose + floor-plane solve dense, or block-sparse
    with the dense cutoff lowered below the 16 padded poses."""
    frames, imu = drive
    kw = dict(enable_loop_closure=False, keyframe_delta_trans=0.0, keyframe_delta_angle=0.0,
              gyr_var=imu.gyr_var, vel_var=imu.vel_var, preint_mode="ugpm",
              enable_floor_constraint=True,
              solve_dense_max_dim=24 if solver == "sparse" else 768)
    jslam = js.RadarGraphSLAM(js.SLAMConfig(**kw))
    tslam = ts.RadarGraphSLAM(config_from_dict(ts.SLAMConfig, jslam.cfg._asdict()), device="cpu")
    assert isinstance(tslam.cfg.ugpm, type(ts.SLAMConfig().ugpm))
    for s in (jslam, tslam):
        for t, g in zip(imu.gyr_t, imu.gyr):
            s.push_imu(t, g)
        for t, v in zip(imu.vel_t, imu.vel):
            s.push_twist(t, v)
    rng = np.random.default_rng(0)
    gcfg = jgs.GroundSegConfig()
    n_floor = 0
    for stamp, cloud, _, R, p in frames:
        pose = np.eye(4)
        pose[:3, :3], pose[:3, 3] = R, p + 0.02 * rng.normal(size=3)
        seg = jgs.estimate_ground(cloud, gcfg)
        plane, n_g = np.asarray(seg.plane), int(np.asarray(seg.ground_mask).sum())
        floor = plane if (n_g >= jslam.cfg.floor_min_ground_points
                          and abs(plane[2]) > jslam.cfg.floor_max_tilt_nz) else None
        n_floor += floor is not None
        assert jslam.add_frame(stamp, cloud, pose, floor_coeffs=floor) == tslam.add_frame(
            stamp, cloud_from_numpy(cloud), pose, floor_coeffs=floor)
    assert n_floor >= 3
    for a, b in zip(jslam.keyframes[1:], tslam.keyframes[1:]):
        np.testing.assert_allclose(b.trans_integrated, a.trans_integrated, rtol=0, atol=1e-8)
        np.testing.assert_allclose(b.preint_cov, a.preint_cov, rtol=0,
                                   atol=1e-7 * np.abs(a.preint_cov).max())
    jopt, topt = jslam.optimize(), tslam.optimize()
    np.testing.assert_allclose(topt, jopt, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tslam.floor_plane, np.asarray(jslam.floor_plane), rtol=0, atol=1e-8)
    assert tslam.solver_counts[f"{solver}_planes"] == 1 and sum(tslam.solver_counts.values()) == 1
    for a, b in zip(jslam.trajectory(), tslam.trajectory()):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-8)


def test_frontend_configs_carry_over_from_jax():
    """`convert.config_from_dict` maps the JAX configs of this slice onto the
    port's, nested ones and tuple fields (read back from JSON as lists)
    included."""
    jg = jgs.GroundSegConfig(rings_per_zone=(2, 4, 2, 2), num_iter=3)
    tg = config_from_dict(tgs.GroundSegConfig, jg._asdict())
    assert tg == tgs.GroundSegConfig(rings_per_zone=(2, 4, 2, 2), num_iter=3)
    assert tg.num_patches == jg.num_patches
    assert config_from_dict(tgs.GroundSegConfig, {"sectors_per_zone": [3, 1, 1, 3]}) == \
        tgs.GroundSegConfig()
    assert config_from_dict(tcl.DBSCANConfig, jcl.DBSCANConfig(eps=0.5)._asdict()) == \
        tcl.DBSCANConfig(eps=0.5)
    jp = jpp.PreprocessConfig(min_distance=1.0, dbscan=jcl.DBSCANConfig(core_min_pts=6),
                              groundseg=jg)
    tp = config_from_dict(tpp.PreprocessConfig, jp._asdict())
    assert tp == tpp.PreprocessConfig(min_distance=1.0, dbscan=tcl.DBSCANConfig(core_min_pts=6),
                                      groundseg=tg)
    odo = config_from_dict(to.OdometryConfig, jo.OdometryConfig()._asdict())
    assert isinstance(odo.groundseg, tgs.GroundSegConfig) and odo.groundseg == tgs.GroundSegConfig()
