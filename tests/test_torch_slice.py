"""The slice as a whole: `python -m gorio_tpu_torch.cli simulate / slam /
evaluate` against `python -m gorio_tpu.cli` on the CPU, on a small
sequence (capacity 512, 3000 landmarks): 4 s at 4 Hz with loops off. The
same sequence with the paper's configuration runs in
`tests/test_torch_slice_full.py`, the loop circuit in
`tests/test_torch_slice_loops.py`, and the slice in a process without JAX
in `tests/test_torch_no_jax.py`: each file goes to a worker of its own
under `--dist loadfile`.

End-to-end tolerance: the port draws its RANSAC hypotheses from a torch
generator, not `jax.random`, so the ego-velocity motion guesses differ by
the RANSAC noise; the LM then stops anywhere inside its 5e-4 m / 2e-3 rad
convergence box (`lsq.py` epsilons). Keyframe poses must agree within
5 mm / 5 mrad, and the ATEs within 20% + 1 mm."""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gorio_tpu.cli import main as jax_cli
from gorio_tpu.io.tum import load_tum
from gorio_tpu_torch.cli import main as torch_cli

from jax_native_build import ensure_built

ensure_built()  # the JAX package's native library, built once under a lock

ROOT = Path(__file__).resolve().parents[1]
SIM = ["--duration", "4", "--rate", "4", "--capacity", "512", "--landmarks", "3000"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's runs on one torch thread: at these sizes ~7x faster on
    the CPU than on the default threads, with the same poses to ~1e-11."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_cuda_device_without_a_card_raises(runs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_cli(["slam", "--dataset", str(runs[0] / "seq"), "--no-loops"])


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
    the JAX package (`gorio_tpu`, numpy-only modules included), nor the
    repo's `scripts/` or root `bench.py` (which import it), at any depth of
    the code."""
    bad = [m for m in _imported_modules(ROOT / path)
           if m.split(".")[0] in ("jax", "jaxlib", "gorio_tpu", "scripts", "bench")]
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
