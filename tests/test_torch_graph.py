"""Port parity: `gorio_tpu_torch.graph` (factors, PoseGraph, dense LM) against
`gorio_tpu.graph` and the independent numpy oracle `tests/oracle_graph.py`,
on the random graphs of `tests/test_graph_oracle.py` (every pose-factor
family, Huber kernels included).

Tolerances: the JAX package and the port evaluate the same residuals and
forward-mode Jacobians in float64; only reduction order differs, so H, b and
chi2 agree to 1e-10 relative, and the LM takes the same iterations to the
same poses (atol 1e-9). Against the finite-difference oracle the bounds are
those of `test_graph_oracle.py` (chi2 rtol 1e-5, poses 2e-4)."""

import jax
import numpy as np
import pytest
import torch

import oracle_graph as og
from gorio_tpu.graph.solver import SolveConfig as JSolveConfig
from gorio_tpu.graph.solver import build_normal_equations as j_normal
from gorio_tpu.graph.solver import graph_chi2 as j_chi2
from gorio_tpu.graph.solver import optimize_graph as j_optimize
from gorio_tpu_torch.convert import config_from_dict, graph_from_numpy
from gorio_tpu_torch.graph import graph as tgraph
from gorio_tpu_torch.graph import solver as ts
from test_graph_oracle import build_pose_graph


def _frozen(seed, robust):
    g, vars0, fac, truth = build_pose_graph(seed, n=8, robust=robust)
    poses0, graph = g.freeze()
    return g, vars0, fac, poses0, graph


@pytest.mark.parametrize("seed,robust", [(0, False), (2, True)])
def test_normal_equations_match_jax_and_oracle(seed, robust):
    g, vars0, fac, poses0, graph = _frozen(seed, robust)
    tp, tgr = torch.as_tensor(np.asarray(poses0)), graph_from_numpy(graph)
    jH, jb, jc = jax.jit(j_normal)(poses0, graph)
    tH, tb, tc = ts.build_normal_equations(tp, tgr)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-10, atol=1e-8)
    np.testing.assert_allclose(float(tc), float(jc), rtol=1e-10)
    np.testing.assert_allclose(float(ts.graph_chi2(tp, tgr)), float(jax.jit(j_chi2)(poses0, graph)),
                               rtol=1e-10)
    np.testing.assert_allclose(float(ts.graph_chi2(tp, tgr)), og.total_chi2(fac, vars0), rtol=1e-9)


def test_posegraph_freeze_matches_jax():
    """The port's PoseGraph packs the same factors into the same arrays."""
    g, _, _, poses0, graph = _frozen(1, True)
    pg = tgraph.PoseGraph()
    pg.poses = list(g.poses)
    for name in ("_between", "_priors", "_point_priors", "_quat_priors", "_vec_priors",
                 "_plane_factors"):
        setattr(pg, name, list(getattr(g, name)))
    tp, tgr = pg.freeze()
    np.testing.assert_array_equal(tp.numpy(), np.asarray(poses0))
    for jf, tf in zip(graph, tgr):
        for a, b in zip(jf, tf):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the public adders build the same square-root informations
    pg2 = tgraph.PoseGraph()
    pg2.add_pose(np.eye(4))
    info = np.diag([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    pg2.add_between(0, 0, np.eye(4), info=info)
    np.testing.assert_allclose(pg2._between[0][3].T @ pg2._between[0][3], info, atol=1e-12)


@pytest.mark.parametrize("seed,robust", [(7, False), (11, True)])
def test_optimize_graph_matches_jax_and_oracle(seed, robust):
    g, vars0, fac, poses0, graph = _frozen(seed, robust)
    jcfg = JSolveConfig(max_iterations=100)
    jr = j_optimize(poses0, graph, jcfg)
    tr = ts.optimize_graph(torch.as_tensor(np.asarray(poses0)), graph_from_numpy(graph),
                           config_from_dict(ts.SolveConfig, jcfg._asdict()))
    assert int(tr.iterations) == int(jr.iterations)
    np.testing.assert_allclose(tr.poses.numpy(), np.asarray(jr.poses), atol=1e-9)
    np.testing.assert_allclose(float(tr.chi2), float(jr.chi2), rtol=1e-9)
    np.testing.assert_allclose(float(tr.lm_lambda), float(jr.lm_lambda), rtol=1e-12)
    np.testing.assert_allclose(tr.H.numpy(), np.asarray(jr.H), rtol=1e-8, atol=1e-6)

    ov, ochi2, _ = og.optimize(vars0, fac, max_iters=200)
    np.testing.assert_allclose(float(tr.chi2), ochi2, rtol=1e-4 if robust else 1e-5)
    for k in range(len(g.poses)):
        np.testing.assert_allclose(tr.poses[k, :3, 3].numpy(), ov[f"x{k}"][:3, 3],
                                   atol=5e-4 if robust else 2e-4)


def test_unported_solvers_raise():
    """`solver="cg"` is no longer refused: the Jacobi-preconditioned CG
    runs and matches the JAX package's (`tests/test_torch_cg.py` has the
    wider checks)."""
    _, _, _, poses0, graph = _frozen(0, False)
    jcfg = JSolveConfig(max_iterations=100, solver="cg", cg_iters=10)
    jr = j_optimize(poses0, graph, jcfg)
    tr = ts.optimize_graph(torch.as_tensor(np.asarray(poses0)), graph_from_numpy(graph),
                           config_from_dict(ts.SolveConfig, jcfg._asdict()))
    assert int(tr.iterations) == int(jr.iterations)
    np.testing.assert_allclose(tr.poses.numpy(), np.asarray(jr.poses), atol=1e-9)
