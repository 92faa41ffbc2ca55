"""Port parity: `solver="cg"` of the four graph solvers
(`gorio_tpu_torch.graph.solver` / `sparse`) against the JAX package's, and
the SPIKE factor / apply split of the block-tridiagonal preconditioner, in
float64 on the CPU. Every graph has noisy measurements, so its optimum's
chi2 is far above rounding and the LM's relative-change stop fires.

- Dense Jacobi-preconditioned CG: on `tests/test_graph.py`'s CG graph (a
  12-pose chain, here with noisy edges and two loops; `cg_iters=200`, where
  CG meets its tolerance) and on a 24-pose chain with loops where every CG solve stops
  at `cg_iters=5`: poses within 1e-8 of JAX's. The joint pose + plane form
  on a 12-pose floor graph with a loop, CG stopping at `cg_iters=20`. A CG
  that stops on its tolerance after many steps on an ill-conditioned system
  is chaotic in the last bits (the step at which r.r crosses tol^2 b.b
  moves), in either package; these graphs avoid that, and the sparse
  solvers' block preconditioner converges in a few steps anyway.
- The port's dense CG against its own dense Cholesky, within the JAX
  test's 1e-3 m.
- Block PCG: `optimize_graph_sparse` on 48 (block Thomas) and 64 (SPIKE)
  pose chains with three loops and GPS priors, with and without
  `fix_first`; `optimize_graph_with_planes_sparse` on a 48-pose graph with
  two loops, the floor plane, a wall plane and a z-between edge (with
  `fix_first`), and on a 64-pose floor graph (SPIKE). Poses and planes within 1e-8, the same LM
  iteration counts.
- `spike_factor` / `spike_apply` against `block_tridiag_solve` within
  1e-10 relative; `pcg` reading its stop flag every 10 steps gives the bits
  of never reading it.
- The CLI: `slam --device cpu --config` with `dump-config`'s tree and
  `slam.solve.solver = "cg"` against the JAX CLI with the same file, on
  `tests/test_streaming.py`'s 26-frame sequence at capacity 512, the JAX
  reader's frames handed over as float64 (as the port uploads them) and the
  port's RANSAC hypotheses JAX's own draws for the JAX CLI's key sequence
  (`jax.random` cannot be reproduced with torch's generators): the same
  keyframe stamps, the trajectories within 1e-6 m.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from gorio_tpu.graph import graph as jg
from gorio_tpu.graph import solver as jsv
from gorio_tpu.graph import sparse as jsp
from gorio_tpu_torch.convert import config_from_dict, graph_from_numpy
from gorio_tpu_torch.graph import solver as tsv
from gorio_tpu_torch.graph import sparse as tsp
from jax_native_build import ensure_built
from test_sparse_solver import make_chain_graph
from test_torch_planes import _frozen
from test_torch_streaming import tiny_sequence  # noqa: F401 (a fixture)

ensure_built()  # the JAX package's native library, built once under a lock


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _test_graph_cg_graph():
    """`tests/test_graph.py::test_cg_matches_dense`'s chain (12 poses on a
    circle, perturbed initial poses, a 1e6 anchor), its edges noisy, and
    two noisy loop edges."""
    rng = np.random.default_rng(4)
    n = 12
    truth = [np.eye(4)]
    for _ in range(1, n):
        step = np.eye(4)
        step[:3, :3] = Rotation.from_euler("z", 2 * np.pi / n).as_matrix()
        step[:3, 3] = [1.0, 0.05 * rng.normal(), 0.0]
        truth.append(truth[-1] @ step)
    g = jg.PoseGraph()
    for T in truth:
        P = np.eye(4)
        P[:3, :3] = Rotation.from_rotvec(rng.normal(scale=0.03, size=3)).as_matrix()
        P[:3, 3] = rng.normal(scale=0.1, size=3)
        g.add_pose(T @ P)
    for k in range(1, n):
        rel = np.linalg.inv(truth[k - 1]) @ truth[k]
        rel[:3, 3] += rng.normal(scale=0.02, size=3)
        g.add_between(k - 1, k, rel, info=np.eye(6) * 50.0)
    for i, j in ((n - 1, 0), (2, 8)):  # loops: a chain alone fits any noise exactly
        rel = np.linalg.inv(truth[i]) @ truth[j]
        rel[:3, 3] += rng.normal(scale=0.02, size=3)
        g.add_between(i, j, rel, info=np.eye(6) * 20.0)
    g.add_prior(0, truth[0], info=np.eye(6) * 1e6)
    return g.freeze()


def _chain(K, seed=1):
    g, _ = make_chain_graph(K=K, n_loops=3, seed=seed)
    poses0, graph = g.freeze()
    return poses0, graph, torch.as_tensor(np.asarray(poses0)), graph_from_numpy(graph)


def _same_solve(t, j):
    assert int(t.iterations) == int(j.iterations)
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses), rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(t.chi2), float(j.chi2), rtol=1e-9)
    if hasattr(j, "planes"):
        np.testing.assert_allclose(t.planes.numpy(), np.asarray(j.planes), rtol=0, atol=1e-8)


@pytest.mark.parametrize("case", ["converges", "stops_at_cg_iters"])
def test_dense_cg_matches_jax(case):
    if case == "converges":
        poses0, graph = _test_graph_cg_graph()
        jcfg = jsv.SolveConfig(solver="cg", cg_iters=200)
    else:
        poses0, graph, _, _ = _chain(24)
        jcfg = jsv.SolveConfig(max_iterations=40, solver="cg", cg_iters=5)
    j = jsv.optimize_graph(poses0, graph, jcfg)
    t = tsv.optimize_graph(torch.as_tensor(np.asarray(poses0)), graph_from_numpy(graph),
                           config_from_dict(tsv.SolveConfig, jcfg._asdict()))
    _same_solve(t, j)
    assert int(t.iterations) > 1


def test_dense_cg_equals_dense_solve():
    """The JAX test's own check, on the port: CG and Cholesky reach the same
    optimum (positions within 1e-3 m)."""
    poses0, graph = _test_graph_cg_graph()
    tp, tg = torch.as_tensor(np.asarray(poses0)), graph_from_numpy(graph)
    dense = tsv.optimize_graph(tp, tg, tsv.SolveConfig(solver="dense"))
    cg = tsv.optimize_graph(tp, tg, tsv.SolveConfig(solver="cg", cg_iters=200))
    np.testing.assert_allclose(cg.poses[:, :3, 3].numpy(), dense.poses[:, :3, 3].numpy(),
                               atol=1e-3)


def test_dense_plane_cg_matches_jax():
    (jposes, jgd, jplanes, jpg), (tposes, tgd, tplanes, tpg) = _frozen(
        12, 2, loops=[(1, 10)], all_families=False)
    jcfg = jsv.SolveConfig(max_iterations=15, solver="cg", cg_iters=20)
    j = jsv.optimize_graph_with_planes(jnp.asarray(jposes), jnp.asarray(jplanes),
                                       jax.tree.map(jnp.asarray, jgd),
                                       jax.tree.map(jnp.asarray, jpg), jcfg)
    t = tsv.optimize_graph_with_planes(tposes, tplanes, tgd, tpg,
                                       config_from_dict(tsv.SolveConfig, jcfg._asdict()))
    _same_solve(t, j)


@pytest.mark.parametrize("K,fix_first", [(48, False), (64, False), (48, True)])
def test_sparse_cg_matches_jax(K, fix_first):
    poses0, graph, tp, tg = _chain(K)
    jcfg = jsv.SolveConfig(max_iterations=40, solver="cg", fix_first=fix_first)
    j = jsp.optimize_graph_sparse(poses0, graph, jcfg)
    t = tsp.optimize_graph_sparse(tp, tg, config_from_dict(tsv.SolveConfig, jcfg._asdict()))
    _same_solve(t, j)
    np.testing.assert_allclose(t.H_diag.numpy(), np.asarray(j.H_diag), rtol=1e-9, atol=1e-6)


@pytest.mark.parametrize("K,loops,all_families,fix_first", [
    (48, [(2, 40), (10, 30)], True, True),
    (64, [(5, 50), (20, 60)], False, False),
])
def test_sparse_plane_cg_matches_jax(K, loops, all_families, fix_first):
    (jposes, jgd, jplanes, jpg), (tposes, tgd, tplanes, tpg) = _frozen(
        K, 3, loops=loops, all_families=all_families)
    jcfg = jsv.SolveConfig(max_iterations=8, solver="cg", fix_first=fix_first)
    j = jsp.optimize_graph_with_planes_sparse(jnp.asarray(jposes), jnp.asarray(jplanes),
                                              jax.tree.map(jnp.asarray, jgd),
                                              jax.tree.map(jnp.asarray, jpg), jcfg)
    t = tsp.optimize_graph_with_planes_sparse(tposes, tplanes, tgd, tpg,
                                              config_from_dict(tsv.SolveConfig, jcfg._asdict()))
    _same_solve(t, j)


@pytest.mark.parametrize("K", [64, 256])
def test_spike_factor_apply_matches_thomas(K):
    gen = torch.Generator().manual_seed(K)
    X = torch.randn(K, 6, 12, dtype=torch.float64, generator=gen)
    A = X @ X.transpose(-1, -2) + 6.0 * torch.eye(6, dtype=torch.float64)
    C = 0.3 * torch.randn(K - 1, 6, 6, dtype=torch.float64, generator=gen)
    b = torch.randn(K, 6, 3, dtype=torch.float64, generator=gen)
    want = tsp.block_tridiag_solve(tsp.block_tridiag_factor(A, C), C, b)
    got = tsp.spike_apply(tsp.spike_factor(A, C), b)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-10
    # the one-pass solve of the direct solver, on the same split helpers
    fused = tsp.solve_block_tridiag_spike(A, C, b)
    assert float((fused - want).abs().max() / want.abs().max()) < 1e-10


def test_pcg_stop_reads_change_nothing():
    """Steps after the stop mask fires are frozen: reading the flag every 10
    steps to skip them gives the bits of running all of them."""
    _, _, tp, tg = _chain(48)
    Hdiag, Hoff, b, _ = tsp.build_block_normal_equations(tp, tg)
    f = tg.between
    A = tsp._damped(Hdiag, torch.tensor(1e-4, dtype=torch.float64))
    C = tsp._chain_upper_blocks(Hoff, f.i, f.j, 48, torch.float64)
    M = 48
    H = torch.zeros(M, M, 6, 6, dtype=torch.float64)
    k = torch.arange(M)
    H[k, k] = A
    H = H.index_put((f.i, f.j), Hoff, accumulate=True)
    H = H.index_put((f.j, f.i), Hoff.transpose(-1, -2), accumulate=True)
    H = H.permute(0, 2, 1, 3).reshape(6 * M, 6 * M)
    pre = tsp.tridiag_preconditioner(A, C)

    def run(check_every):
        return tsv.pcg(lambda v: ((H @ v[0].reshape(-1)).reshape(M, 6),), (-b,),
                       lambda v: (pre(v[0]),), 100, check_every=check_every)[0]

    x = run(10)
    assert torch.equal(x, run(None))
    ref = torch.linalg.solve(H, -b.reshape(-1)).reshape(M, 6)
    assert float((x - ref).abs().max() / ref.abs().max()) < 1e-4


def test_slam_cli_cg_matches_jax(tiny_sequence, tmp_path):  # noqa: F811
    import gorio_tpu.io.native as jnative
    from gorio_tpu.cli import main as jax_cli
    from gorio_tpu.core.pointcloud import PointCloud as JCloud
    from gorio_tpu.estimators import egovel as je
    from gorio_tpu.io.tum import load_tum
    from gorio_tpu_torch.cli import main as torch_cli
    from gorio_tpu_torch.estimators import egovel as te
    from test_torch_egovel import _jax_hypotheses

    cfg = tmp_path / "cg.json"
    jax_cli(["dump-config", "--output", str(cfg)])
    tree = json.loads(cfg.read_text())
    tree["slam"]["solve"]["solver"] = "cg"
    cfg.write_text(json.dumps(tree))
    args = ["--dataset", str(tiny_sequence), "--capacity", "512", "--config", str(cfg)]

    class Float64Frames(jnative.NativePipelineDataset):
        def __next__(self):
            stamp, n, packed = super().__next__()
            return stamp, n, np.asarray(packed, np.float64)

    estimate = te.estimate_ego_velocity
    keys = [jax.random.PRNGKey(0)]

    def with_jax_draws(cloud, ecfg, generator=None, hyp_idx=None):
        """The JAX CLI's draw for this frame: its key chain, its gate."""
        keys[0], sub = jax.random.split(keys[0])
        jcloud = JCloud(*(jnp.asarray(x.cpu().numpy()) for x in cloud))
        hyp = _jax_hypotheses(jcloud, je.EgoVelConfig(**ecfg._asdict()), sub)
        return estimate(cloud, ecfg, hyp_idx=torch.as_tensor(np.asarray(hyp)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GORIO_NO_COMPILE_CACHE", "1")
        mp.setattr(jnative, "NativePipelineDataset", Float64Frames)
        mp.setattr(te, "estimate_ego_velocity", with_jax_draws)
        jax_cli(["slam", *args, "--output", str(tmp_path / "jax.tum")])
        slam, _, _ = torch_cli(["slam", *args, "--output", str(tmp_path / "torch.tum"),
                                "--device", "cpu"])
    assert slam.solver_counts["cg"] >= 1 and slam.solver_counts["dense"] >= 1
    js, jp = load_tum(tmp_path / "jax.tum")
    ts, tp = load_tum(tmp_path / "torch.tum")
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
