"""Port parity: VGICP and its voxel map, the RBF covariances, GICP with
`covariance_method="rbf"`, the registration factory, the PCD files, NDT and
scan-to-submap odometry (`step` and the fused step) and the CLI's
`slam --registration ndt` and `align`, against the JAX package.

Tolerances, float64 unless stated: voxel sets, keys, validity and tables
exact, means and covariances rtol 1e-10; an align takes the same number
of iterations and ends within 1e-8 in T; odometry poses within 1e-8 and
statuses equal. The CLIs: keyframe stamps equal and poses within 5 mm /
5 mrad (the port's RANSAC draws from a torch generator, see
`tests/test_torch_slice.py`).

The RBF tests run on a dense patch (ground and a wall, every point with
neighbours within `rbf_max_dist`). At a point with no neighbour the
covariance is the cancellation residue E[x x^T] - mu mu^T: exactly zero in
the port, whose distances are direct differences (the point's own weight
is exactly 1), and rounding noise in the JAX package, whose distances are
expanded (|q|^2 + |r|^2 - 2 q.r), so that its PLANE-regularised covariance
there has an arbitrary normal. `test_rbf_isolated_point_is_exact` holds
the port's side of that."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gorio_tpu.cli import main as jax_cli
from gorio_tpu.core.pointcloud import make_cloud as jmake_cloud
from gorio_tpu.io import pcd as jpcd
from gorio_tpu.io.synthetic import make_world, render_radar_scan, simulate_trajectory
from gorio_tpu.io.tum import load_tum
from gorio_tpu.pipeline import odometry as jo
import gorio_tpu.registration as jreg
import gorio_tpu_torch.registration as treg
from gorio_tpu.registration import gicp as jg
from gorio_tpu.registration import ndt as jn
from gorio_tpu.registration import select_registration as jselect
from gorio_tpu.registration import vgicp as jv
from gorio_tpu.registration.knn import rbf_covariances as jrbf
from gorio_tpu_torch.cli import main as torch_cli
from gorio_tpu_torch.convert import cloud_from_numpy, config_from_dict
from gorio_tpu_torch.io import pcd as tpcd
from gorio_tpu_torch.pipeline import odometry as to
from gorio_tpu_torch.registration import gicp as tg
from gorio_tpu_torch.registration import ndt as tn
from gorio_tpu_torch.registration import select_registration as tselect
from gorio_tpu_torch.registration import vgicp as tv
from gorio_tpu_torch.registration.knn import rbf_covariances as trbf

from jax_native_build import ensure_built

ensure_built()  # the JAX package's native library, built once under a lock

NDT_ODO = jn.NDTConfig(resolution=2.0, min_points_per_voxel=3)
SIM = ["--duration", "4", "--rate", "4", "--capacity", "512", "--landmarks", "3000"]


def dense_patch(rng, n_ground=300, n_wall=212):
    """Ground (20 x 20 m, 3 cm noise) and a wall at y = 6 m."""
    g = np.concatenate([rng.uniform(-10, 10, (n_ground, 2)),
                        -1.8 + 0.03 * rng.normal(size=(n_ground, 1))], 1)
    wall = np.stack([rng.uniform(-8, 8, n_wall), 6 + 0.05 * rng.normal(size=n_wall),
                     rng.uniform(-1.8, 2, n_wall)], 1)
    return np.concatenate([g, wall])


def known_T(yaw=0.03, t=(0.3, 0.1, 0.0)):
    T = np.eye(4)
    T[:3, :3] = Rotation.from_euler("z", yaw).as_matrix()
    T[:3, 3] = t
    return T


@pytest.fixture(scope="module")
def patch():
    """(JAX target, JAX source, port target, port source, init): the source
    is the target moved by `known_T` plus 1 cm noise; init the identity."""
    rng = np.random.default_rng(0)
    xyz = dense_patch(rng)
    T = known_T()
    moved = xyz @ T[:3, :3].T + T[:3, 3] + 0.01 * rng.normal(size=xyz.shape)
    jt, js = jmake_cloud(jnp.asarray(xyz)), jmake_cloud(jnp.asarray(moved))
    return jt, js, cloud_from_numpy(jt), cloud_from_numpy(js), np.eye(4)


@pytest.fixture(scope="module")
def scans():
    """Two radar scans (capacity 512) 0.54 m and 0.04 rad apart, and a
    guess 0.19 m off the truth (`tests/test_ndt.py`'s pair)."""
    world = make_world(seed=21, n_landmarks=6000)
    R1 = Rotation.from_euler("ZYX", [0.04, 0.0, 0.0]).as_matrix()
    target = render_radar_scan(world, np.eye(3), np.zeros(3), np.zeros(3), capacity=512, seed=1)
    source = render_radar_scan(world, R1, np.array([0.5, 0.2, 0.0]), np.zeros(3), capacity=512,
                               seed=2)
    T0 = np.eye(4)
    T0[:3, :3] = R1
    T0[:3, 3] = [0.65, 0.1, 0.05]
    return target, source, cloud_from_numpy(target), cloud_from_numpy(source), T0


def assert_same_align(got, want, min_iterations=2):
    assert int(got.iterations) == int(want.iterations) >= min_iterations
    np.testing.assert_allclose(got.T.numpy(), np.asarray(want.T), atol=1e-8)
    assert float(got.error) == pytest.approx(float(want.error), rel=1e-10)


def test_rbf_covariances_match_jax(patch):
    jt, _, tt, _, _ = patch
    want = jrbf(jt.xyz, jt.mask)
    got = trbf(tt.xyz, tt.mask)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=1e-10)
    assert float(got[2].min()) > 2.0  # every point has neighbours
    reg, geo = tg.rbf_regularized_covariances(tt.xyz, tt.mask, 0.25, 3.0, 1e-3)
    jreg, jgeo = jg.rbf_regularized_covariances(jt.xyz, jt.mask, 0.25, 3.0, 1e-3)
    np.testing.assert_allclose(reg.numpy(), np.asarray(jreg), atol=1e-8)
    np.testing.assert_allclose(geo.numpy(), np.asarray(jgeo), atol=1e-8)


def test_rbf_isolated_point_is_exact():
    """A point alone within `max_dist`: weight exactly 1, mean the point,
    covariance exactly 0 (then the isotropic branch of `sym_eigh3`)."""
    xyz = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.2, 0.1], [0.1, 0.7, -0.2], [37.3, -11.9, 2.7]],
                       dtype=torch.float64)
    mean, cov, sum_w = trbf(xyz, torch.ones(4, dtype=torch.bool))
    assert float(sum_w[3]) == 1.0
    assert torch.equal(mean[3], xyz[3]) and torch.equal(cov[3], torch.zeros(3, 3,
                                                                          dtype=torch.float64))


@pytest.mark.parametrize("method,table_size", [("knn", 1 << 21), ("rbf", 1 << 21),
                                               ("knn", 64)])
def test_build_gaussian_voxel_map_matches_jax(patch, method, table_size):
    jt, _, tt, _, _ = patch
    cfg = jv.VGICPConfig(covariance_method=method, table_size=table_size)
    want = jv.build_gaussian_voxel_map(jt, cfg)
    got = tv.build_gaussian_voxel_map(tt, config_from_dict(tv.VGICPConfig, cfg._asdict()))
    for f in want._fields:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f in ("keys", "valid", "table", "table_dims"):
            np.testing.assert_array_equal(g, w, err_msg=f)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-10, atol=1e-12, err_msg=f)
    assert int(np.asarray(want.valid).sum()) > 50


@pytest.mark.parametrize("method", ["knn", "rbf"])
def test_vgicp_align_matches_jax(patch, method):
    jt, js, tt, ts, T0 = patch
    cfg = jv.VGICPConfig(covariance_method=method)
    want = jv.vgicp_align(js, jt, jnp.asarray(T0), cfg)
    got = tv.vgicp_align(ts, tt, torch.tensor(T0),
                         config_from_dict(tv.VGICPConfig, cfg._asdict()))
    assert_same_align(got, want)
    assert bool(got.converged) == bool(want.converged)


def test_gicp_rbf_matches_jax(patch):
    jt, js, tt, ts, T0 = patch
    cfg = jg.GICPConfig(covariance_method="rbf")
    want = jg.gicp_align(js, jt, jnp.asarray(T0), cfg)
    got = tg.gicp_align(ts, tt, torch.tensor(T0), config_from_dict(tg.GICPConfig, cfg._asdict()))
    assert_same_align(got, want)


@pytest.mark.parametrize("method", list(jreg._METHODS))
def test_select_registration_matches_jax(scans, method):
    """Every name of the JAX factory maps to the same aligner and mode in
    the port and aligns the pair as the JAX package does (NDT at
    resolution 2.0 with 3 points per voxel; names are case-blind)."""
    jt, js, tt, ts, T0 = scans
    assert treg._METHODS[method] == jreg._METHODS[method]
    kw = dict(resolution=2.0, min_points_per_voxel=3) if "NDT" in method else {}
    want = jselect(method, **kw)(js, jt, jnp.asarray(T0))
    got = tselect(method.lower(), **kw)(ts, tt, torch.tensor(T0))
    assert_same_align(got, want, min_iterations=1)


@pytest.mark.parametrize("binary", [True, False])
def test_pcd_files_interoperate(tmp_path, binary):
    """Both writers give the same bytes, and each package reads the other's
    file (with and without intensity) as the same float32 arrays."""
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(57, 3)).astype(np.float32) * 20
    inten = rng.uniform(0, 40, 57).astype(np.float32)
    t, j, bare = tmp_path / "t.pcd", tmp_path / "j.pcd", tmp_path / "bare.pcd"
    tpcd.write_pcd(t, xyz, inten, binary=binary)
    jpcd.write_pcd(j, xyz, inten, binary=binary)
    assert t.read_bytes() == j.read_bytes()
    for path in (t, j):
        (jx, ji), (tx, ti) = jpcd.read_pcd(path), tpcd.read_pcd(path)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tx, xyz, atol=0 if binary else 1e-5)
    tpcd.write_pcd(bare, xyz, binary=binary)
    assert jpcd.read_pcd(bare)[1] is None and tpcd.read_pcd(bare)[1] is None
    np.testing.assert_array_equal(jpcd.read_pcd(bare)[0], tx)


def test_voxel_centroid_downsample_matches_jax():
    xyz = np.random.default_rng(4).uniform(-3, 3, (4000, 3)).astype(np.float32)
    got = tpcd.voxel_centroid_downsample(xyz, 0.5)
    np.testing.assert_array_equal(got, jpcd.voxel_centroid_downsample(xyz, 0.5))
    assert 100 < len(got) < 4000


@pytest.fixture(scope="module")
def frames():
    traj = simulate_trajectory(seed=0, duration=3.0)
    world = make_world(seed=2, n_landmarks=4000)
    out = []
    for i, t in enumerate(np.arange(0.2, 1.9, 0.25)):
        R, p = traj.interp_pose(np.array([t]))
        v = np.array([np.interp(t, traj.t, traj.v_body[:, k]) for k in range(3)])
        cloud = render_radar_scan(world, R[0], p[0], v, capacity=512, seed=1000 + i,
                                  azimuth_fov_deg=56.5, elevation_fov_deg=22.5)
        out.append((float(t), cloud, v))
    return out


ODO_CASES = {
    "ndt": dict(registration="ndt", ndt=NDT_ODO),
    "scan-to-map-ndt": dict(registration="ndt", ndt=NDT_ODO, enable_scan_to_map=True,
                            submap_capacity=1024, keyframe_delta_time=0.4),
    "scan-to-map-apdgicp": dict(enable_scan_to_map=True, submap_capacity=1024,
                                keyframe_delta_time=0.4),
}


def assert_same_statuses(todo, jodo, n):
    assert len(todo.statuses) == len(jodo.statuses) == n
    for a, b in zip(todo.statuses, jodo.statuses):
        assert a.converged == b.converged and a.used_prediction == b.used_prediction
        np.testing.assert_allclose(a.matching_error, b.matching_error, rtol=1e-8, atol=1e-9)
        np.testing.assert_allclose(a.inlier_fraction, b.inlier_fraction, rtol=1e-12)


@pytest.mark.parametrize("case", list(ODO_CASES))
def test_odometry_steps_match_jax(frames, case):
    """`ScanMatchingOdometry.step` over 7 frames: NDT against the last
    keyframe, and scan-to-submap with NDT and APDGICP (a keyframe every
    other frame, so the submap is rebuilt from up to 4 keyframe clouds)."""
    jcfg = jo.OdometryConfig(**ODO_CASES[case])
    jodo = jo.ScanMatchingOdometry(jcfg)
    todo = to.ScanMatchingOdometry(config_from_dict(to.OdometryConfig, jcfg._asdict()))
    assert isinstance(todo.cfg.ndt, tn.NDTConfig)
    for stamp, cloud, v in frames:
        np.testing.assert_allclose(todo.step(stamp, cloud_from_numpy(cloud), v),
                                   jodo.step(stamp, cloud, v), rtol=0, atol=1e-8)
    assert_same_statuses(todo, jodo, len(frames) - 1)
    assert max(s.iterations for s in todo.statuses) >= 2
    if jcfg.enable_scan_to_map:
        assert len(todo._submap_frames) == len(jodo._submap_frames) >= 3
        jk, tk = jodo.keyframe_cloud, todo.keyframe_cloud
        assert tk.capacity == jcfg.submap_capacity
        np.testing.assert_array_equal(tk.mask.numpy(), np.asarray(jk.mask))
        np.testing.assert_allclose(tk.xyz.numpy(), np.asarray(jk.xyz), rtol=0, atol=1e-9)


def test_submap_rebuild_stays_on_the_clouds_device(frames, monkeypatch):
    """The submap is merged, downsampled and packed with tensor ops on the
    keyframe clouds' device: no tensor goes to numpy or to the CPU."""
    todo = to.ScanMatchingOdometry(to.OdometryConfig(enable_scan_to_map=True,
                                                     submap_capacity=1024))
    for stamp, cloud, v in frames[:3]:
        todo._submap_frames.append((np.eye(4), cloud_from_numpy(cloud)))
    todo.keyframe_pose = np.eye(4)

    def refuse(*args, **kwargs):
        raise AssertionError("a host round trip")

    monkeypatch.setattr(torch.Tensor, "numpy", refuse)
    monkeypatch.setattr(torch.Tensor, "cpu", refuse)
    todo._rebuild_submap()
    monkeypatch.undo()
    kf = todo.keyframe_cloud
    assert kf.capacity == 1024 and kf.xyz.device == todo._submap_frames[0][1].xyz.device
    assert 0 < int(kf.mask.sum()) <= 1024


@pytest.mark.cuda
def test_submap_lives_on_the_card(frames):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    todo = to.ScanMatchingOdometry(to.OdometryConfig(enable_scan_to_map=True))
    for stamp, cloud, v in frames[:4]:
        todo.step(stamp, cloud_from_numpy(cloud, device="cuda"), v)
    assert todo.keyframe_cloud.xyz.device.type == "cuda"


def _packed(cloud, cap=512):
    m = np.asarray(cloud.mask)
    rows = np.concatenate([np.asarray(cloud.xyz)[m], np.asarray(cloud.intensity)[m, None],
                           np.asarray(cloud.doppler)[m, None]], axis=1)
    out = np.zeros((cap, 5))
    out[: len(rows)] = rows
    return out, len(rows)


@pytest.mark.parametrize("case", ["ndt", "scan-to-map-apdgicp"])
def test_step_fused_matches_jax(frames, case):
    """The fused step on float64 frames, with NDT and with scan-to-submap
    APDGICP; the RANSAC hypotheses drawn by JAX for its key and handed to
    the port (`tests/test_torch_frontend.py`)."""
    from gorio_tpu.estimators import egovel as je

    jcfg = jo.OdometryConfig(**ODO_CASES[case])
    jodo = jo.ScanMatchingOdometry(jcfg)
    todo = to.ScanMatchingOdometry(config_from_dict(to.OdometryConfig, jcfg._asdict()))
    for idx, (stamp, cloud, _) in enumerate(frames):
        packed, n = _packed(cloud)
        jcloud = jo._cloud_from_packed(jnp.asarray(packed), n)
        valid, _ = je._gate(jcloud, jcfg.egovel)
        w = valid.astype(jcloud.xyz.dtype)
        hyp = np.asarray(jax.random.choice(
            jax.random.fold_in(jax.random.PRNGKey(0), idx), 512,
            shape=(jcfg.egovel.ransac_iter, jcfg.egovel.n_ransac_points), replace=True,
            p=w / jnp.maximum(jnp.sum(w), 1.0)))
        jpose, jv = jodo.step_fused(stamp, packed, n)
        tpose, tv = todo.step_fused(stamp, torch.as_tensor(packed), n, hyp_idx=hyp)
        np.testing.assert_allclose(tpose, jpose, rtol=0, atol=1e-8, err_msg=f"frame {idx}")
        np.testing.assert_allclose(tv, np.asarray(jv), rtol=1e-10, atol=1e-12)
    assert_same_statuses(todo, jodo, len(frames) - 1)
    assert max(s.iterations for s in todo.statuses) >= 2
    # the next keyframe target is a ref of the 1-NN kernels, which take
    # contiguous tensors
    assert todo.last_cloud.xyz.is_contiguous() and todo.keyframe_cloud.xyz.is_contiguous()
    if jcfg.enable_scan_to_map:
        assert len(todo._submap_frames) == len(jodo._submap_frames) >= 3


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    d = tmp_path_factory.mktemp("ndt_slam")
    torch_cli(["simulate", "--output", str(d / "seq"), *SIM])
    return d


@pytest.mark.parametrize("fused", [False, True])
def test_slam_ndt_matches_jax(seq, fused, monkeypatch):
    """`slam --registration ndt [--fused]` on the 4 s sequence against the
    JAX CLI on float64 frames (as `tests/test_torch_slice.py::full_runs`)."""
    import gorio_tpu.io.native as jnative

    class Float64Frames(jnative.NativePipelineDataset):
        def __next__(self):
            stamp, n, packed = super().__next__()
            return stamp, n, np.asarray(packed, np.float64)

    flags = ["--capacity", "512", "--registration", "ndt", "--no-loops"] + (
        ["--fused"] if fused else [])
    name = "fused" if fused else "plain"
    monkeypatch.setenv("GORIO_NO_COMPILE_CACHE", "1")
    monkeypatch.setattr(jnative, "NativePipelineDataset", Float64Frames)
    jax_cli(["slam", "--dataset", str(seq / "seq"), "--output", str(seq / f"jax_{name}.tum"),
             *flags, "--timing-out", str(seq / f"jax_{name}.json")])
    monkeypatch.undo()
    slam, odo, _ = torch_cli(["slam", "--dataset", str(seq / "seq"), "--output",
                              str(seq / f"torch_{name}.tum"), *flags, "--device", "cpu",
                              "--timing-out", str(seq / f"torch_{name}.json")])
    jt = json.loads((seq / f"jax_{name}.json").read_text())
    tt = json.loads((seq / f"torch_{name}.json").read_text())
    assert tt["keyframe_stamps"] == jt["keyframe_stamps"]
    assert tt["solver_counts"]["dense"] >= 1
    _, jp = load_tum(seq / f"jax_{name}.tum")
    _, tp = load_tum(seq / f"torch_{name}.tum")
    dpos = np.linalg.norm(tp[:, :3, 3] - jp[:, :3, 3], axis=1)
    dR = np.einsum("nji,njk->nik", jp[:, :3, :3], tp[:, :3, :3])
    dang = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert dpos.max() < 5e-3 and dang.max() < 5e-3, (dpos.max(), dang.max())
    assert odo.cfg.registration == "ndt" and len(odo.statuses) == jt["n_frames"] - 1


def test_align_cli_recovers_a_known_transform(tmp_path):
    """`align --device cpu` with its eight default methods on a small pair
    (a dense patch of 512 points, moved by 0.03 rad and 0.3 m): each
    recovers the transform within `tests/test_reference_pcd.py`'s 0.05 m /
    1 deg where the JAX package's aligner does on the same clouds, and
    otherwise ends within those margins of the JAX package's error."""
    rng = np.random.default_rng(5)
    xyz = dense_patch(rng, 350, 162).astype(np.float32)
    T = known_T()
    tpcd.write_pcd(tmp_path / "tgt.pcd", xyz @ T[:3, :3].T + T[:3, 3])
    tpcd.write_pcd(tmp_path / "src.pcd", xyz)
    rows = torch_cli(["align", str(tmp_path / "tgt.pcd"), str(tmp_path / "src.pcd"), "--repeat",
                      "0", "--device", "cpu", "--leaf", "0.05", "--ndt-resolution", "1.0"])
    assert [r["method"] for r in rows] == ["ICP", "GICP", "FAST_GICP", "FAST_APDGICP",
                                           "FAST_VGICP", "FAST_VGICP_CUDA", "NDT_OMP",
                                           "NDT_CUDA_D2D"]
    tgt, src = (jmake_cloud(jnp.asarray(tpcd.voxel_centroid_downsample(
        tpcd.read_pcd(tmp_path / f)[0], 0.05)), capacity=512) for f in ("tgt.pcd", "src.pcd"))

    def errors(est):
        d = np.linalg.inv(est) @ T
        ang = np.degrees(np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1)))
        return float(np.linalg.norm(d[:3, 3])), float(ang)

    passed = 0
    for row in rows:
        kw = dict(resolution=1.0) if "NDT" in row["method"] else {}
        jte, jre = errors(np.asarray(jselect(row["method"], **kw)(src, tgt).T, np.float64))
        te, re = errors(row["T"].double().numpy())
        assert te < max(0.05, jte + 0.05) and re < max(1.0, jre + 1.0), (row["method"], te, re)
        passed += jte < 0.05 and jre < 1.0
        assert np.isfinite(row["fitness"]) and row["first_ms"] > 0
    assert passed >= 6


def test_align_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tpcd.write_pcd(tmp_path / "a.pcd", np.zeros((4, 3)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli(["align", str(tmp_path / "a.pcd"), str(tmp_path / "a.pcd")])


def test_kernel_wrappers_import_first():
    """`chip_smoke.py` imports `ops.nn` before anything else of the port;
    `ops.nn` imports `registration.knn`, so the registration package must
    not import `gicp` (which imports `ops.nn`) when it loads."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import gorio_tpu_torch.ops.nn\n"
            "from gorio_tpu_torch.registration import select_registration\n"
            "select_registration('NDT_OMP')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=Path(__file__).resolve().parents[1], timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
