"""Port parity: the typed config tree (`config.py`, `dump-config`), g2o
persistence of `PoseGraph`, `KeyFrame` save / load, and `slam --config
--dump --map` against the JAX package, on the CPU.

- `dump-config` writes the JAX CLI's file byte for byte (JSON; YAML where
  PyYAML imports), and each package loads the other's trees.
- A graph written by either package (SE(3) vertices, between edges and
  priors with robust kernels in the sidecar, plane vertices and every plane
  factor family) loads in the other with the same entries and information
  matrices to 1e-12 (a rank-deficient information's Cholesky root takes
  both packages' 1e-15 jitter, so roots are compared as their squares);
  both packages write the same bytes for the same graph (float64).
- Keyframe directories load both ways with the same metadata and cloud.
- `slam --fused --preprocess --config` (radius outlier removal in the
  tree) `--dump --map --no-loops` on a 4 s sequence: the JAX CLI runs on
  its reader's frames handed over as float64, as the port uploads them.
  The RANSAC hypotheses come from different generators, so, as in
  `test_torch_slice.py`, keyframe poses agree within 5 mm / 5 mrad; the
  dumped graphs cross-load and hold the trajectory (each its own to 1e-9 m);
  the maps (0.2 m voxels) agree in point count within 2% and in their
  bounds within 0.05 m."""

import json

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gorio_tpu import config as jcfg
from gorio_tpu.cli import main as jax_cli
from gorio_tpu.core.pointcloud import make_cloud as jmake
from gorio_tpu.graph.graph import PoseGraph as JGraph
from gorio_tpu.io.tum import load_tum
from gorio_tpu.pipeline.keyframes import KeyFrame as JKeyFrame
from gorio_tpu_torch import config as tcfg
from gorio_tpu_torch.cli import main as torch_cli
from gorio_tpu_torch.core.pointcloud import make_cloud as tmake
from gorio_tpu_torch.graph.graph import PoseGraph as TGraph
from gorio_tpu_torch.pipeline.keyframes import KeyFrame as TKeyFrame

from jax_native_build import ensure_built

ensure_built()  # the JAX package's native library, built once under a lock

SIM = ["--duration", "4", "--rate", "4", "--capacity", "512", "--landmarks", "3000"]
FAMILIES = ("_between", "_priors", "_plane_priors", "_plane_plane", "_se3_plane", "_z_between",
            "_utm_align")



@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small tensors run fastest on one CPU thread, and the test
    files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_dump_config_equals_jax(tmp_path, suffix):
    if suffix == ".yaml":
        pytest.importorskip("yaml")
    torch_cli(["dump-config", "--output", str(tmp_path / f"t{suffix}")])
    jax_cli(["dump-config", "--output", str(tmp_path / f"j{suffix}")])
    assert (tmp_path / f"t{suffix}").read_bytes() == (tmp_path / f"j{suffix}").read_bytes()


@pytest.mark.parametrize("suffix", [".json", ".yaml"])
def test_config_trees_load_both_ways(tmp_path, suffix):
    """A JAX-written tree with changed nested fields loads in the port to the
    same dict, and the port's copy loads back in the JAX package."""
    if suffix == ".yaml":
        pytest.importorskip("yaml")
    tree = jcfg.GorioConfig()
    tree.preprocess = tree.preprocess._replace(outlier_method="radius", radius_radius=1.5)
    tree.odometry = tree.odometry._replace(
        registration="ndt", ndt=tree.odometry.ndt._replace(resolution=2.0))
    tree.slam = tree.slam._replace(
        loop=tree.slam.loop._replace(accum_distance_thresh=20.0), gyr_var=3e-5)
    tree.frames.base_frame = "body"
    jcfg.save_config(tree, tmp_path / f"j{suffix}")
    got = tcfg.load_config(tmp_path / f"j{suffix}")
    assert tcfg.to_dict(got) == jcfg.to_dict(tree)
    assert got.preprocess.outlier_method == "radius" and got.odometry.ndt.resolution == 2.0
    assert type(got.odometry.ndt).__module__.startswith("gorio_tpu_torch")
    tcfg.save_config(got, tmp_path / f"t{suffix}")
    assert jcfg.to_dict(jcfg.load_config(tmp_path / f"t{suffix}")) == jcfg.to_dict(tree)


def _pose(rng, scale=1.0):
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(0.3 * rng.normal(size=3)).as_matrix()
    T[:3, 3] = scale * rng.normal(size=3)
    return T


def _graph(cls):
    """Poses, between edges and priors (two robust), two plane vertices and
    every plane factor family (some robust)."""
    rng = np.random.default_rng(0)
    g = cls()
    for _ in range(4):
        g.add_pose(_pose(rng))
    A = rng.normal(size=(6, 6))
    info = A @ A.T + 6 * np.eye(6)
    g.add_between(0, 1, _pose(rng, 0.1), info)
    g.add_between(1, 2, _pose(rng, 0.1), np.eye(6) * 3.0, robust_delta=1.0)
    g.add_between(2, 3, _pose(rng, 0.1), info)
    g.add_prior(0, _pose(rng), np.eye(6) * 1e6)
    g.add_prior(3, _pose(rng), info, robust_delta=0.5)
    j = g.add_plane([0.01, 0.02, 1.0, 2.0])
    k = g.add_plane([1.0, 0.0, 0.1, 3.0])
    g.add_plane_prior_normal(j, [0.0, 0.0, 1.0], np.eye(3) * 5.0)
    g.add_plane_prior_distance(j, 2.0, 4.0, robust_delta=0.3)
    g.add_plane_parallel(j, k, np.zeros(3), 2.0)
    g.add_plane_perpendicular(j, k, 7.0, robust_delta=2.0)
    g.add_plane_identity(j, k, np.zeros(4), 1.0)
    g.add_se3_plane(1, j, [0.0, 0.1, 1.0, 1.5], np.diag([100.0, 100.0, 100.0]), robust_delta=1.0)
    g.add_se3_z(0, 1, 0.3, 9.0)
    g.add_utm_align(2, [1.0, 2.0, 3.0], [4.0, 5.0, 6.0], np.eye(3) * 2.0, robust_delta=4.0)
    return g


def _assert_same_graph(a, b):
    np.testing.assert_allclose(np.stack(a.poses), np.stack(b.poses), rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.stack(a.planes), np.stack(b.planes), rtol=0, atol=1e-12)
    for fam in FAMILIES:
        ea, eb = getattr(a, fam), getattr(b, fam)
        assert len(ea) == len(eb) > 0, fam
        for x, y in zip(ea, eb):
            for n, (u, v) in enumerate(zip(x, y)):
                if isinstance(u, (int, np.integer)):
                    assert u == v, fam
                    continue
                u, v = np.asarray(u, float), np.asarray(v, float)
                if n == len(x) - 2:  # the square-root information: compare the information
                    u, v = u.T @ u, v.T @ v  # (a rank-deficient one reloads jittered)
                np.testing.assert_allclose(u, v, rtol=1e-12, atol=1e-12, err_msg=fam)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_pose_graph_files_cross_load(tmp_path, writer):
    """Written by one package, read by the other (and by itself): the same
    graph; the sidecar holds the robust kernels; both write the same bytes."""
    src, dst = (JGraph, TGraph) if writer == "jax" else (TGraph, JGraph)
    g = _graph(src)
    g.save(tmp_path / "g.g2o")
    kernels = (tmp_path / "g.g2o.kernels").read_text().splitlines()
    assert len(kernels) == 6 and kernels[0] == "EDGE_SE3:QUAT 1 Huber 1.0"
    for cls in (dst, src):
        _assert_same_graph(cls.load(tmp_path / "g.g2o"), g)
    _graph(dst).save(tmp_path / "h.g2o")
    assert (tmp_path / "h.g2o").read_bytes() == (tmp_path / "g.g2o").read_bytes()
    assert (tmp_path / "h.g2o.kernels").read_bytes() == (tmp_path / "g.g2o.kernels").read_bytes()


def test_loaded_graph_freezes_and_solves_like_the_original(tmp_path):
    """The port's loaded graph freezes to the same chi2 (the pose and the
    plane terms, to 1e-9 relative) as the graph it was saved from."""
    from gorio_tpu_torch.graph.solver import graph_chi2, plane_graph_chi2

    g = _graph(TGraph)
    g.save(tmp_path / "g.g2o")
    h = TGraph.load(tmp_path / "g.g2o")
    chi2 = []
    for graph in (g, h):
        poses, pose_graph = graph.freeze()
        planes, plane_graph = graph.freeze_planes()
        chi2.append([float(graph_chi2(poses, pose_graph)),
                     float(plane_graph_chi2(poses, planes, plane_graph))])
    np.testing.assert_allclose(chi2[1], chi2[0], rtol=1e-9)
    assert min(chi2[0]) > 0


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_keyframe_directories_load_both_ways(tmp_path, writer):
    rng = np.random.default_rng(1)
    xyz = rng.uniform(-20, 20, size=(40, 3))
    extras = dict(floor_coeffs=np.array([0.01, 0.0, 1.0, 1.8]), utm_coord=np.array([1.0, 2.0, 3.0]),
                  altitude=12.5, orientation=np.array([1.0, 0.0, 0.0, 0.0]))
    T, odom = _pose(rng), _pose(rng)
    if writer == "jax":
        cloud = jmake(np.asarray(xyz), intensity=rng.uniform(0, 30, 40), capacity=64)
        kf = JKeyFrame(index=7, stamp=3.25, odom_scan2scan=odom, accum_distance=4.5, cloud=cloud,
                       **extras)
    else:
        cloud = tmake(torch.as_tensor(xyz), intensity=torch.as_tensor(rng.uniform(0, 30, 40)),
                      capacity=64)
        kf = TKeyFrame(index=7, stamp=3.25, odom_scan2scan=odom, accum_distance=4.5, cloud=cloud,
                       **extras)
    kf.optimized_pose = T
    kf.save(tmp_path / "kf")
    want = JKeyFrame.load(tmp_path / "kf")
    got = TKeyFrame.load(tmp_path / "kf", device="cpu")
    for name in ("index", "stamp", "accum_distance", "altitude"):
        assert getattr(got, name) == getattr(want, name) == getattr(kf, name), name
    for name in ("odom_scan2scan", "optimized_pose", *extras):
        np.testing.assert_array_equal(np.asarray(getattr(got, name)), getattr(want, name))
    np.testing.assert_array_equal(got.optimized_pose, T)
    for f in got.cloud._fields:
        np.testing.assert_array_equal(getattr(got.cloud, f).numpy(),
                                      np.asarray(getattr(want.cloud, f)))
    assert got.cloud.xyz.dtype == torch.float64 and got.cloud.mask.dtype == torch.bool


def test_keyframe_load_defaults_to_the_card(tmp_path):
    """`KeyFrame.load` puts the cloud on the card unless the caller names
    the CPU; without a card it raises instead of falling back."""
    cloud = tmake(torch.zeros(4, 3, dtype=torch.float64), capacity=8)
    TKeyFrame(index=0, stamp=0.5, odom_scan2scan=np.eye(4), accum_distance=0.0,
              cloud=cloud).save(tmp_path / "kf")
    if torch.cuda.is_available():
        assert TKeyFrame.load(tmp_path / "kf").cloud.xyz.is_cuda
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TKeyFrame.load(tmp_path / "kf")
    assert TKeyFrame.load(tmp_path / "kf", device="cpu").cloud.xyz.device.type == "cpu"


@pytest.fixture(scope="module")
def dumped(tmp_path_factory):
    """Both CLIs: `slam --fused --preprocess --config C --dump --map
    --no-loops`, C a JAX-written tree with radius outlier removal."""
    import gorio_tpu.io.native as jnative

    d = tmp_path_factory.mktemp("persist")
    torch_cli(["simulate", "--output", str(d / "seq"), *SIM])
    tree = jcfg.GorioConfig()
    tree.preprocess = tree.preprocess._replace(outlier_method="radius")
    jcfg.save_config(tree, d / "cfg.json")

    class Float64Frames(jnative.NativePipelineDataset):
        def __next__(self):
            stamp, n, packed = super().__next__()
            return stamp, n, np.asarray(packed, np.float64)

    args = ["slam", "--dataset", str(d / "seq"), "--capacity", "512", "--no-loops", "--fused",
            "--preprocess", "--config", str(d / "cfg.json")]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GORIO_NO_COMPILE_CACHE", "1")
        mp.setattr(jnative, "NativePipelineDataset", Float64Frames)
        jax_cli([*args, "--output", str(d / "jax.tum"), "--dump", str(d / "jax_dump"),
                 "--map", str(d / "jax_map.npz")])
    slam, odo, _ = torch_cli([*args, "--output", str(d / "torch.tum"), "--dump",
                              str(d / "torch_dump"), "--map", str(d / "torch_map.npz"),
                              "--device", "cpu"])
    return d, slam, odo


def _gap(a, b):
    dpos = np.linalg.norm(a[:, :3, 3] - b[:, :3, 3], axis=1)
    dR = np.einsum("nji,njk->nik", a[:, :3, :3], b[:, :3, :3])
    dang = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    return dpos.max(), dang.max()


def test_slam_config_reaches_the_frontend(dumped):
    d, slam, odo = dumped
    assert odo.preprocess_cfg.outlier_method == "radius"
    assert type(odo.preprocess_cfg).__module__ == "gorio_tpu_torch.pipeline.preprocessing"
    js, jp = load_tum(d / "jax.tum")
    ts, tp = load_tum(d / "torch.tum")
    np.testing.assert_array_equal(ts, js)
    dpos, dang = _gap(tp, jp)
    assert dpos < 5e-3 and dang < 5e-3, (dpos, dang)


def test_dumped_graphs_cross_load(dumped):
    """Each dump's graph holds one vertex per keyframe at its trajectory's
    poses and one between edge per consecutive pair; each package reads
    both dumps; the keyframe directories load with their clouds."""
    d, slam, _ = dumped
    _, tp = load_tum(d / "torch.tum")
    _, jp = load_tum(d / "jax.tum")
    for name, traj in (("torch", tp), ("jax", jp)):
        for cls in (TGraph, JGraph):
            g = cls.load(d / f"{name}_dump" / "graph.g2o")
            assert len(g.poses) == len(traj) == len(slam.keyframes)
            assert len(g._between) == len(traj) - 1
            np.testing.assert_allclose(np.stack(g.poses)[:, :3, 3], traj[:, :3, 3], rtol=0,
                                       atol=1e-9)
    dirs = sorted(p.name for p in (d / "torch_dump").iterdir() if p.is_dir())
    assert dirs == sorted(p.name for p in (d / "jax_dump").iterdir() if p.is_dir())
    assert len(dirs) == len(slam.keyframes)
    for k in (0, len(dirs) - 1):
        kf = TKeyFrame.load(d / "torch_dump" / dirs[k], device="cpu")
        want = slam.keyframes[k]
        assert kf.index == want.index and kf.stamp == want.stamp
        np.testing.assert_array_equal(kf.cloud.mask.numpy(), want.cloud.mask.numpy())
        np.testing.assert_array_equal(kf.cloud.xyz.numpy(), want.cloud.xyz.numpy())
        jkf = JKeyFrame.load(d / "jax_dump" / dirs[k])
        assert jkf.stamp == kf.stamp
        np.testing.assert_allclose(jkf.optimized_pose, kf.optimized_pose, rtol=0, atol=5e-3)


def test_maps_match_jax(dumped):
    d, slam, _ = dumped
    t = np.load(d / "torch_map.npz")["xyz"]
    j = np.load(d / "jax_map.npz")["xyz"]
    assert t.dtype == np.float64 and np.isfinite(t).all()
    assert abs(len(t) - len(j)) <= 0.02 * len(j), (len(t), len(j))
    np.testing.assert_allclose(t.min(axis=0), j.min(axis=0), rtol=0, atol=0.05)
    np.testing.assert_allclose(t.max(axis=0), j.max(axis=0), rtol=0, atol=0.05)
    m = slam.generate_map(resolution=0.2)
    np.testing.assert_array_equal(m.xyz[m.mask].numpy(), t)


def test_export_markers(dumped, tmp_path):
    d, slam, _ = dumped
    slam.export_markers(tmp_path / "m.json")
    data = json.loads((tmp_path / "m.json").read_text())
    assert len(data["nodes"]) == len(slam.keyframes)
    assert len(data["edges"]) == len(slam.keyframes) - 1 and data["loops"] == []
    assert data["loop_search_radius"] == 2.0 * slam.cfg.loop.distance_thresh
