"""The slice as a whole: `python -m gorio_tpu_torch.cli simulate / slam /
evaluate` against `python -m gorio_tpu.cli` on the CPU, on a small
sequence (capacity 512, 3000 landmarks): 4 s at 4 Hz with loops off, and
again with the paper's configuration (`--fused --preprocess --floor
--preint ugpm`: the fused preprocessing frontend, UGPM and the floor
plane). The loop circuit runs in `tests/test_torch_slice_loops.py`.

End-to-end tolerance: the port draws its RANSAC hypotheses from a torch
generator, not `jax.random`, so the ego-velocity motion guesses differ by
the RANSAC noise; the LM then stops anywhere inside its 5e-4 m / 2e-3 rad
convergence box (`lsq.py` epsilons). Keyframe poses must agree within
5 mm / 5 mrad, and the ATEs within 20% + 1 mm."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gorio_tpu.cli import main as jax_cli
from gorio_tpu.io.tum import load_tum
from gorio_tpu_torch.cli import main as torch_cli

ROOT = Path(__file__).resolve().parents[1]
SIM = ["--duration", "4", "--rate", "4", "--capacity", "512", "--landmarks", "3000"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("slice")
    torch_cli(["simulate", "--output", str(d / "seq"), *SIM])
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GORIO_NO_COMPILE_CACHE", "1")  # keep the JAX CLI's cache out of HOME
        jax_cli(["simulate", "--output", str(d / "seq_jax"), *SIM])
        jax_cli(["slam", "--dataset", str(d / "seq"), "--output", str(d / "jax.tum"),
                 "--no-loops", "--capacity", "512"])
    slam, odo, _ = torch_cli(["slam", "--dataset", str(d / "seq"), "--output",
                              str(d / "torch.tum"), "--no-loops", "--capacity", "512",
                              "--device", "cpu", "--timing-out", str(d / "timing.json")])
    return d, slam, odo


FULL = ["--fused", "--preprocess", "--floor", "--preint", "ugpm"]


@pytest.fixture(scope="module")
def full_runs(runs):
    """Both CLIs with the paper's four flags on the 4 s sequence. The JAX
    CLI's reader hands it the frames as float64, as the port's CLI uploads
    them: on its float32 frames the JAX package's fused LM ends millimetres
    from its own float64 run. Its back end is caught on construction for
    the floor plane."""
    import gorio_tpu.io.native as jnative
    import gorio_tpu.pipeline.slam as jslam

    d = runs[0]
    made = []

    class Caught(jslam.RadarGraphSLAM):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    class Float64Frames(jnative.NativePipelineDataset):
        def __next__(self):
            stamp, n, packed = super().__next__()
            return stamp, n, np.asarray(packed, np.float64)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GORIO_NO_COMPILE_CACHE", "1")
        mp.setattr(jslam, "RadarGraphSLAM", Caught)
        mp.setattr(jnative, "NativePipelineDataset", Float64Frames)
        jax_cli(["slam", "--dataset", str(d / "seq"), "--output", str(d / "jax_full.tum"),
                 "--capacity", "512", *FULL, "--timing-out", str(d / "jax_full.json")])
    slam, odo, _ = torch_cli(["slam", "--dataset", str(d / "seq"), "--output",
                              str(d / "torch_full.tum"), "--capacity", "512", *FULL,
                              "--device", "cpu", "--timing-out", str(d / "torch_full.json")])
    return d, made[0], slam, odo


def test_simulate_writes_the_same_sequence(runs):
    d = runs[0]
    names = sorted(p.name for p in (d / "seq").iterdir())
    assert names == sorted(p.name for p in (d / "seq_jax").iterdir())
    for name in names:
        if name.endswith(".npz"):
            a, b = np.load(d / "seq" / name), np.load(d / "seq_jax" / name)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            assert (d / "seq" / name).read_bytes() == (d / "seq_jax" / name).read_bytes(), name


def test_slam_matches_jax(runs):
    d, slam, odo = runs
    js, jp = load_tum(d / "jax.tum")
    ts, tp = load_tum(d / "torch.tum")
    assert len(ts) == len(js) == len(slam.keyframes)
    np.testing.assert_array_equal(ts, js)
    dpos = np.linalg.norm(tp[:, :3, 3] - jp[:, :3, 3], axis=1)
    dR = np.einsum("nji,njk->nik", jp[:, :3, :3], tp[:, :3, :3])
    dang = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert dpos.max() < 5e-3 and dang.max() < 5e-3, (dpos.max(), dang.max())

    gt = str(d / "seq" / "groundtruth.tum")
    ej = torch_cli(["evaluate", str(d / "jax.tum"), gt])["ate_rmse_m"]
    et = torch_cli(["evaluate", str(d / "torch.tum"), gt])["ate_rmse_m"]
    assert abs(et - ej) <= 0.2 * ej + 1e-3, (et, ej)
    assert et < 0.05

    timing = json.loads((d / "timing.json").read_text())
    assert timing["n_keyframes"] == len(ts) and timing["device"] == "cpu"
    assert timing["lm_iterations"] == sum(st.iterations for st in odo.statuses) > 0


def test_full_configuration_matches_jax(full_runs):
    """`--fused --preprocess --floor --preint ugpm`, both CLIs on float64
    frames: the same keyframes and loops (none on this drive), the
    trajectory within 5 mm / 5 mrad, the floor plane within 1e-2 rad /
    0.05 m, the ATE within 20% + 1 mm; the fused stages timed under the JAX
    package's names, the floor plane solved jointly with the poses."""
    d, jslam, tslam, odo = full_runs
    jt = json.loads((d / "jax_full.json").read_text())
    tt = json.loads((d / "torch_full.json").read_text())
    assert tt["keyframe_stamps"] == jt["keyframe_stamps"]
    assert tt["loops"] == jt["loops"] == []
    assert set(tt["stage_median_ms"]) == set(jt["stage_median_ms"]) == {
        "frontend_fused", "backend", "final_optimize"}
    assert tt["solver_counts"]["dense_planes"] >= 1 and tt["solver_counts"]["dense"] == 0
    assert odo.preprocess_cfg is not None and odo.last_ground_count > 0
    assert str(odo.last_cloud.xyz.dtype) == "torch.float64"  # the frames go up as float64
    assert sum(kf.floor_coeffs is not None for kf in tslam.keyframes) == \
        sum(kf.floor_coeffs is not None for kf in jslam.keyframes) > 0
    n_t, n_j = tslam.floor_plane[:3], np.asarray(jslam.floor_plane)[:3]
    assert np.arccos(np.clip(n_t @ n_j, -1.0, 1.0)) < 1e-2
    assert abs(tslam.floor_plane[3] - float(jslam.floor_plane[3])) < 0.05
    np.testing.assert_allclose(tt["floor_plane"], tslam.floor_plane.tolist())
    _, jp = load_tum(d / "jax_full.tum")
    _, tp = load_tum(d / "torch_full.tum")
    dpos = np.linalg.norm(tp[:, :3, 3] - jp[:, :3, 3], axis=1)
    dR = np.einsum("nji,njk->nik", jp[:, :3, :3], tp[:, :3, :3])
    dang = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert dpos.max() < 5e-3 and dang.max() < 5e-3, (dpos.max(), dang.max())
    gt = str(d / "seq" / "groundtruth.tum")
    ej = torch_cli(["evaluate", str(d / "jax_full.tum"), gt])["ate_rmse_m"]
    et = torch_cli(["evaluate", str(d / "torch_full.tum"), gt])["ate_rmse_m"]
    assert abs(et - ej) <= 0.2 * ej + 1e-3, (et, ej)


def test_cuda_device_without_a_card_raises(runs):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli(["slam", "--dataset", str(runs[0] / "seq"), "--no-loops"])


def test_port_runs_without_jax(runs, full_runs, tmp_path):
    """A process in which `import jax`, `import jaxlib` and `import
    gorio_tpu` (and every submodule) fail runs the port's whole slice, loop
    closure on: simulate, slam (the default path, the paper's four flags
    with `--config` of `dump-config`'s tree, `--dump` and `--map`, and
    `--registration ndt`), stream, evaluate, align, `sample_posterior`,
    the loop smoother and CG solves (and imports `preintegrate` and
    `gn_optimize`), the slice written as a rosbag through `convert-bag`,
    and `gt-adjust` — with the same results as this process (with loops off: the 4 s sequence never passes the 50 m
    gate; the config tree's defaults are the flags').
    (An import hook blocks them: a `sys.modules['jax'] = None` entry trips
    scipy's array-API helper, which looks the module up by name.)"""
    d = runs[0]
    code = (
        "import sys\n"
        "class NoJax:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'gorio_tpu'):\n"
        "            raise ImportError(f'{name} is blocked')\n"
        "sys.meta_path.insert(0, NoJax())\n"
        "from gorio_tpu_torch.cli import main\n"
        f"main(['simulate', '--output', 'seq', *{SIM!r}])\n"
        f"slam = main(['slam', '--dataset', 'seq', '--output', {str(tmp_path / 'e.tum')!r},"
        " '--capacity', '512', '--device', 'cpu'])[0]\n"
        f"r = main(['evaluate', {str(tmp_path / 'e.tum')!r}, 'seq/groundtruth.tum'])\n"
        "assert r['ate_rmse_m'] < 0.05\n"
        "import numpy as np, torch\n"
        "s, a, rh, c = slam.sample_posterior(torch.Generator().manual_seed(0), n_chains=2,"
        " n_samples=4, window=4)\n"
        "assert s.shape == (2, 4, 24) and bool(torch.isfinite(s).all()) and c.shape == (24, 24)\n"
        "from gorio_tpu_torch.graph.graph import PoseGraph\n"
        "from gorio_tpu_torch.inference import smc, smoother\n"
        "P, g = slam.trajectory()[1][:6], PoseGraph()\n"
        "for T in P: g.add_pose(T)\n"
        "g.add_prior(0, P[0], np.eye(6) * 1e6)\n"
        "for k in range(6): g.add_between(k, (k + 1) % 6, np.linalg.inv(P[k]) @ P[(k + 1) % 6],"
        " np.eye(6) * 100.0)\n"
        "p0, gd = g.freeze()\n"
        "m = np.arange(gd.between.mask.shape[0]) == 5\n"
        "res = smoother.smc_loop_relaxation(None, p0, gd, m, n_particles=16, n_stages=2,"
        " n_moves=1)(torch.Generator().manual_seed(0))\n"
        "assert np.isfinite(float(res.log_evidence)) and smoother.loop_evidence_gate(res)\n"
        "from gorio_tpu_torch.graph import solver as gs, sparse as gsp\n"
        "for fn in (gs.optimize_graph, gsp.optimize_graph_sparse):\n"
        "    assert np.isfinite(fn(p0, gd, gs.SolveConfig(solver='cg')).poses.numpy()).all()\n"
        "from gorio_tpu_torch.preintegration import combine_preints, preintegrate\n"
        "from gorio_tpu_torch.registration import gn_optimize\n"
        "main(['dump-config', '--output', 'c.json'])\n"
        f"main(['slam', '--dataset', 'seq', '--output', {str(tmp_path / 'f.tum')!r},"
        f" '--capacity', '512', '--device', 'cpu', *{FULL!r}, '--config', 'c.json',"
        " '--dump', 'dump', '--map', 'map.npz'])\n"
        "r = main(['stream', '--dataset', 'seq', '--capacity', '512', '--device', 'cpu',"
        " '--rate-multiplier', '20', '--no-loops', '--output', 's.tum'])[0]\n"
        "assert r.n_processed == r.n_frames > 0 and r.n_dropped == 0\n"
        f"main(['slam', '--dataset', 'seq', '--output', {str(tmp_path / 'n.tum')!r},"
        " '--capacity', '512', '--device', 'cpu', '--registration', 'ndt'])\n"
        "from gorio_tpu_torch.io.pcd import write_pcd\n"
        "import numpy as np\n"
        "xyz = np.random.default_rng(0).uniform(-5, 5, (300, 3))\n"
        "write_pcd('a.pcd', xyz)\n"
        "rows = main(['align', 'a.pcd', 'a.pcd', '--repeat', '0', '--device', 'cpu',"
        " '--methods', 'NDT_OMP,FAST_VGICP'])\n"
        "assert len(rows) == 2 and all(np.isfinite(r['T'].numpy()).all() for r in rows)\n"
        f"sys.path.insert(0, {str(ROOT / 'tests')!r})\n"
        "import tool_inputs as ti\n"
        "ti.build_slice_bag('seq', 'slice.bag')\n"
        "n = main(['convert-bag', 'slice.bag', '--output', 'bag', *ti.CONVERT_FLAGS])\n"
        "import pathlib\n"
        "assert n == len(list(pathlib.Path('seq').glob('*.grf'))) > 0\n"
        f"r = main(['gt-adjust', {str(tmp_path / 'e.tum')!r}, 'adj.tum', '--loop', '0:3',"
        " '--device', 'cpu'])\n"
        "assert r['n_loops'] == 1 and np.isfinite(r['chi2'])\n"
        "assert not [m for m, v in sys.modules.items() if v is not None\n"
        "            and m.split('.')[0] in ('jax', 'jaxlib', 'gorio_tpu')]\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    np.testing.assert_allclose(load_tum(tmp_path / "e.tum")[1], load_tum(d / "torch.tum")[1],
                               atol=1e-7)
    # the fused path draws its hypotheses from the same seeded generator
    np.testing.assert_allclose(load_tum(tmp_path / "f.tum")[1],
                               load_tum(d / "torch_full.tum")[1], atol=1e-7)
    assert np.isfinite(load_tum(tmp_path / "n.tum")[1]).all()
    assert np.isfinite(load_tum(tmp_path / "s.tum")[1]).all()
    assert len(list((tmp_path / "dump").glob("0*"))) == len(load_tum(tmp_path / "f.tum")[0])
    assert len(np.load(tmp_path / "map.npz")["xyz"]) > 0


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [*(ROOT / "gorio_tpu_torch").rglob("*.py"),
                                       ROOT / "chip_smoke.py"]
    if "_build" not in p.relative_to(ROOT).parts))  # build output, not the port
def test_port_imports_nothing_of_the_jax_package(path):
    """No module of the port, and not chip_smoke.py, imports jax, jaxlib or
    the JAX package (`gorio_tpu`, numpy-only modules included), at any
    depth of the code."""
    bad = [m for m in _imported_modules(ROOT / path)
           if m.split(".")[0] in ("jax", "jaxlib", "gorio_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_configs_carry_over_from_jax():
    """`convert.config_from_dict` maps the JAX CLI's configs (nested ones
    included: loop closure, Scan Context, the solver, the odometry's NDT)
    onto the port's."""
    from gorio_tpu.loopclosure.loop_detector import LoopConfig as JLoop
    from gorio_tpu.loopclosure.scancontext import ScanContextConfig as JSC
    from gorio_tpu_torch.graph.solver import SolveConfig
    from gorio_tpu_torch.loopclosure.loop_detector import LoopConfig
    from gorio_tpu_torch.loopclosure.scancontext import ScanContextConfig
    from gorio_tpu.pipeline.odometry import OdometryConfig as JOdo
    from gorio_tpu.pipeline.slam import SLAMConfig as JSlam
    from gorio_tpu_torch.convert import config_from_dict
    from gorio_tpu_torch.pipeline.odometry import OdometryConfig
    from gorio_tpu_torch.pipeline.slam import SLAMConfig
    from gorio_tpu_torch.preintegration.ugpm import UGPMConfig
    from gorio_tpu.registration.ndt import NDTConfig as JNDT
    from gorio_tpu.registration.vgicp import VGICPConfig as JVGICP
    from gorio_tpu_torch.registration.ndt import NDTConfig
    from gorio_tpu_torch.registration.vgicp import VGICPConfig

    jslam = JSlam(enable_loop_closure=False, gyr_var=2e-5,
                  loop=JLoop(accum_distance_thresh=20.0, sc_candidates=1))
    slam_cfg = config_from_dict(SLAMConfig, jslam._asdict())
    assert slam_cfg.gyr_var == 2e-5 and slam_cfg.solve.max_iterations == 30
    assert slam_cfg.info == config_from_dict(type(slam_cfg.info), jslam.info._asdict())
    assert slam_cfg.loop == LoopConfig(accum_distance_thresh=20.0, sc_candidates=1)
    assert isinstance(slam_cfg.solve, SolveConfig) and slam_cfg.ugpm == UGPMConfig()
    assert config_from_dict(ScanContextConfig, JSC(num_candidates=5)._asdict()) == \
        ScanContextConfig(num_candidates=5)
    odo = config_from_dict(OdometryConfig, JOdo(registration="gicp")._asdict())
    assert odo.registration == "gicp" and odo.gicp.lm.max_iterations == 64
    assert odo == OdometryConfig(registration="gicp")
    assert isinstance(odo.ndt, NDTConfig) and odo.ndt == NDTConfig()
    odo = config_from_dict(OdometryConfig, JOdo(registration="ndt", ndt=JNDT(resolution=2.0),
                                                enable_scan_to_map=True)._asdict())
    assert odo == OdometryConfig(registration="ndt", ndt=NDTConfig(resolution=2.0),
                                 enable_scan_to_map=True)
    assert config_from_dict(VGICPConfig, JVGICP(covariance_method="rbf")._asdict()) == \
        VGICPConfig(covariance_method="rbf")
    with pytest.raises(ValueError, match="no fields"):
        config_from_dict(SLAMConfig, {"not_a_field": 1})
