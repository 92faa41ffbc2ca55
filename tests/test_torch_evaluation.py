"""Port parity: `gorio_tpu_torch/evaluation/` against the repo's `scripts/`
(imported from `scripts/` as `tests/test_accuracy_regression.py` does) and
the JAX package, on the CPU in float64.

Tolerances: `analyze` and the host LM are the same numpy / scipy code on the
same inputs, so they agree exactly (the LM's chi2 to 1e-9 relative, its
iteration count equal). The port's `optimize_graph_sparse` against the JAX
package's: the same LM in float64, only reduction order differs; the chi2
agrees to 1e-9 relative after one iteration, and at the caps 10 / 20 both
sit at the rounding floor of a noise-free graph (~1e-27 against an initial
chi2 of ~1.5e3), where they are held to 1e-9 of the initial chi2, with the
same iteration counts. The stream runs the port only: its keys and frame
counts."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gorio_tpu_torch.evaluation import (
    accuracy, graph_baseline, loop_replay, loop_sweep, recall, stream,
)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))

import accuracy_benchmark as j_accuracy  # noqa: E402
import graph_baseline as j_graph  # noqa: E402
import loop_sweep as j_sweep  # noqa: E402
import recall_benchmark as j_recall  # noqa: E402
from test_accuracy_regression import ATE_CEILING_M, RTE_CEILING_M  # noqa: E402

NO_CARD = not torch.cuda.is_available()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_case(seed):
    """A random closed drive (two laps of a wobbly loop, 1 kHz ground truth),
    random keyframe stamps and a random loop set, some of it false."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 60.0, 6001)
    r = 15.0 + rng.uniform(-3, 3)
    phase = 2 * np.pi * 2 * t / t[-1]
    gt_pos = np.stack([r * np.cos(phase) + 0.3 * np.sin(5 * phase),
                       r * np.sin(phase) + rng.normal(0, 0.05, t.size).cumsum() * 0.01,
                       0.1 * np.sin(3 * phase)], axis=1)
    kf = np.sort(rng.choice(t[1:-1], size=rng.integers(120, 260), replace=False))
    n = kf.size
    loops = [(int(i), int(j), float(rng.uniform(0.05, 0.5)))
             for i, j in zip(rng.integers(n // 2, n, 12), rng.integers(0, n // 2, 12))]
    return kf, loops, t, gt_pos


@pytest.mark.parametrize("seed", range(6))
def test_analyze_matches_the_script_on_random_drives(seed):
    kf, loops, t, gt_pos = _random_case(seed)
    for kw in ({}, {"accum_gate": 20.0, "interval": 5.0}):
        want = j_recall.analyze(kf, loops, t, gt_pos, **kw)
        got = recall.analyze(kf, loops, t, gt_pos, **kw)
        assert got == want
        assert list(got) == list(want)
    assert recall.analyze(kf, [], t, gt_pos) == j_recall.analyze(kf, [], t, gt_pos)


def test_analyze_matches_the_script_on_the_circuit():
    """The stored-accuracy circuit's ground truth (`simulate --duration 75
    --seed 22 --circuit --laps 2`), 360 keyframes spread over it and
    RECALL.json's circuit2 loops."""
    from gorio_tpu_torch.io.synthetic import simulate_trajectory

    traj = simulate_trajectory(seed=22, duration=75.0, circuit=True, laps=2.0)
    kf = np.linspace(traj.t[0], traj.t[-1], 360)
    loops = json.loads((ROOT / "RECALL.json").read_text())["circuit2"]["loops"]
    want = j_recall.analyze(kf, loops, traj.t, traj.p)
    got = recall.analyze(kf, loops, traj.t, traj.p)
    assert got == want
    np.testing.assert_array_equal(recall.gt_at(kf, traj.t, traj.p),
                                  j_recall.gt_at(kf, traj.t, traj.p))


def test_tables_equal_the_scripts():
    assert recall.SEQUENCES == j_recall.SEQUENCES
    assert recall.SLAM_ARGS == j_recall.SLAM_ARGS
    assert recall.ACCURACY_MAP == j_recall.ACCURACY_MAP
    assert accuracy.SEQUENCES == j_accuracy.SEQUENCES
    assert loop_sweep.DEFAULT_COMBOS == j_sweep.DEFAULT_COMBOS
    assert accuracy.ATE_CEILING_M == ATE_CEILING_M
    assert accuracy.RTE_CEILING_M == RTE_CEILING_M
    assert stream.CIRCUIT_SIM == recall.SEQUENCES["circuit2"]["simulate"]


def test_check_mode_holds_the_band_and_the_ceilings():
    """accuracy.check: the script's stored x 1.5 + 0.02 m band and the
    regression test's absolute ceilings, each miss named."""
    stored = json.loads((ROOT / "ACCURACY.json").read_text())
    for name, rec in stored.items():
        assert accuracy.check(name, rec, rec) == []
        bound = rec["ate_rmse_m"] * 1.5 + 0.02
        over = dict(rec, ate_rmse_m=round(bound + 1e-4, 4))
        assert any("x 1.5" in m for m in accuracy.check(name, over, rec))
    far = dict(stored["straight"], ate_rmse_m=1.7, rte_m=1.7)
    missed = accuracy.check("straight", far, dict(stored["straight"], ate_rmse_m=10.0))
    assert len(missed) == 2 and all("ceiling" in m for m in missed)


@pytest.mark.parametrize("max_iterations", [1, 10, 100])
def test_host_lm_matches_the_script(max_iterations):
    """The copied host LM on the port's `make_solve_graph(32)` against the
    script's on the root `bench.py`'s."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("root_bench", ROOT / "bench.py")
    root_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_bench)
    from gorio_tpu_torch.bench import make_solve_graph

    jh = j_graph.HostGraph(root_bench.make_solve_graph(32))
    th = graph_baseline.HostGraph(make_solve_graph(32))
    np.testing.assert_array_equal(th.poses0, jh.poses0)
    assert th.chi2(th.poses0) == jh.chi2(jh.poses0)
    jt, tt = [], []
    _, jchi2, jit, _ = j_graph.host_lm(jh, max_iterations, collect=jt)
    _, tchi2, tit, _ = graph_baseline.host_lm(th, max_iterations, collect=tt)
    assert tit == jit
    assert abs(tchi2 - jchi2) <= 1e-9 * abs(jchi2)
    np.testing.assert_allclose(tt, jt, rtol=1e-9)


def test_repo_solver_matches_jax_in_float64():
    """`solver_caps` (what `repo_solver_convergence` reports) on the CPU
    against the JAX package's `optimize_graph_sparse` on the same float64
    graph, at the caps 1, 10 and 20."""
    import jax.numpy as jnp

    from gorio_tpu.graph.graph import PoseGraph
    from gorio_tpu.graph.solver import SolveConfig
    from gorio_tpu.graph.sparse import optimize_graph_sparse
    from gorio_tpu_torch.bench import make_solve_graph

    K, caps = 32, (1, 10, 20)
    tg = make_solve_graph(K, dtype=np.float64)
    jg = PoseGraph(dtype=np.float64)
    jg.poses, jg._between, jg._priors = list(tg.poses), list(tg._between), list(tg._priors)
    poses, gdata = jg.freeze(as_numpy=True)
    hg = graph_baseline.HostGraph(tg)
    chi2_init = hg.chi2(hg.poses0)
    got = graph_baseline.solver_caps(K, caps, device="cpu")
    for cap in caps:
        rs = optimize_graph_sparse(jnp.asarray(poses, jnp.float64), gdata,
                                   SolveConfig(max_iterations=cap, solver="direct",
                                               loop_capacity=64))
        chi2, iters = got[cap]
        assert iters == int(rs.iterations), (cap, iters, int(rs.iterations))
        tol = 1e-9 * float(rs.chi2) if cap == 1 else 1e-9 * chi2_init
        assert abs(chi2 - float(rs.chi2)) <= tol, (cap, chi2, float(rs.chi2))
    table = graph_baseline.repo_solver_convergence(K, (10,), device="cpu")
    assert table == {"10": {"chi2": graph_baseline._sig(got[10][0]), "iterations_used": 10}}


def test_stream_block_run_processes_every_frame(tmp_path):
    """`stream.run` in block mode at 100x on a 4 s circuit: STREAM.json's
    keys, every frame processed, none dropped, an optimize cycle run on the
    async worker."""
    from gorio_tpu_torch.cli import main as cli

    cli(["simulate", "--output", str(tmp_path / "seq"), "--duration", "4", "--rate", "5",
         "--seed", "22", "--circuit", "--dynamic", "2", "--landmarks", "3000"])
    out = stream.run(100.0, "block", tmp_path, device="cpu")
    keys = json.loads((ROOT / "STREAM.json").read_text())["block_rate1"]
    assert set(keys) | {"ate_rmse_m"} <= set(out), set(keys) - set(out)
    assert out["mode"] == "block"
    assert out["n_frames"] == len(list((tmp_path / "seq").glob("*.grf"))) > 0
    assert out["n_processed"] == out["n_frames"] and out["n_dropped"] == 0
    assert out["n_opt_cycles"] >= 1
    assert np.isfinite(out["ate_rmse_m"])


@pytest.mark.skipif(not NO_CARD, reason="checks the refusal where no card is present")
def test_entry_points_refuse_without_a_card(tmp_path):
    """Every entry point runs on the card unless asked for the CPU: without
    one, `--device cuda` (the default) raises before any work."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accuracy.run_sequence({"simulate": ["--duration", "1"]}, tmp_path)
    assert not (tmp_path / "seq").exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recall.run_sequence("circuit2", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        stream.run(1.0, "block", tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graph_baseline.solver_caps(8, (1,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop_replay.make_detector({}, {})
    for main in (recall.main_cli, accuracy.main_cli, stream.main_cli, graph_baseline.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([])
    with pytest.raises(SystemExit):
        accuracy.main_cli(["--update", "--device", "cpu"])  # --update needs --out
