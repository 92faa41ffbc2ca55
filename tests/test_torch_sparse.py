"""Port parity: `gorio_tpu_torch.graph.sparse` (block normal equations,
block-Thomas and SPIKE tridiagonal solves, the Woodbury loop correction,
the sparse LM) against `gorio_tpu.graph.sparse`, against a dense
`torch.linalg.solve` and against the port's dense solver, on the noisy
circular chains with loop closures and GPS priors of
`tests/test_sparse_solver.py`.

Tolerances: the same float64 arithmetic in another reduction order, so the
normal equations agree to 1e-10 relative and the LM takes the same
iterations to the same poses (atol 1e-9); one Woodbury solve equals the
dense solve of the same damped system to 1e-10 relative; the sparse and the
dense LM reach the same optimum (5e-4 m, the JAX package's own bound)."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorio_tpu.graph import sparse as js
from gorio_tpu.graph.solver import SolveConfig as JSolveConfig
from gorio_tpu_torch.convert import config_from_dict, graph_from_numpy
from gorio_tpu_torch.graph import solver as tsol
from gorio_tpu_torch.graph import sparse as ts
from test_sparse_solver import make_chain_graph

SOLVE = dict(max_iterations=40, solver="direct", loop_capacity=8)


def _graph(K, n_loops, seed, loop_at_0=False):
    g, _ = make_chain_graph(K=K, n_loops=n_loops, seed=seed)
    if loop_at_0:  # a loop closure that touches the anchored pose
        g.add_between(0, K - 3, np.linalg.inv(g.poses[0]) @ g.poses[K - 3],
                      info=np.eye(6) * 30.0, robust_delta=1.0)
    poses0, graph = g.freeze()
    return poses0, graph, torch.as_tensor(np.asarray(poses0)), graph_from_numpy(graph)


def _system(tp, tg, lam=1e-3):
    """The damped block system of one LM step: (A, C, Hoff, b)."""
    Hdiag, Hoff, b, _ = ts.build_block_normal_equations(tp, tg)
    f = tg.between
    A = ts._damped(Hdiag, torch.tensor(lam, dtype=tp.dtype))
    return A, ts._chain_upper_blocks(Hoff, f.i, f.j, tp.shape[0], tp.dtype), Hoff, b


def _dense(A, C, Hoff, between, sel=None):
    """The (6K)^2 matrix of the same system: diagonal blocks A, chain blocks
    C, and the off-diagonal blocks of the loop edges in `sel` (all of them
    when None)."""
    K = A.shape[0]
    H = torch.zeros(K, K, 6, 6, dtype=A.dtype)
    k = torch.arange(K)
    H[k, k] = A
    H[k[:-1], k[:-1] + 1] = C
    H[k[:-1] + 1, k[:-1]] = C.transpose(-1, -2)
    fi, fj = between.i, between.j
    loops = torch.nonzero(between.mask & (fj != fi + 1) & (fi != fj + 1))[:, 0].tolist()
    for e in loops if sel is None else sel:
        H[fi[e], fj[e]] += Hoff[e]
        H[fj[e], fi[e]] += Hoff[e].T
    return H.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)


@pytest.mark.parametrize("K", [48, 128])
def test_block_normal_equations_match_jax(K):
    poses0, graph, tp, tg = _graph(K, 4, seed=K)
    want = jax.jit(js.build_block_normal_equations)(poses0, graph)
    got = ts.build_block_normal_equations(tp, tg)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-10, atol=1e-8)
    f = tg.between
    np.testing.assert_allclose(
        ts._chain_upper_blocks(got[1], f.i, f.j, K, tp.dtype).numpy(),
        np.asarray(jax.jit(js._chain_upper_blocks, static_argnums=(3, 4))(
            want[1], graph.between.i, graph.between.j, K, poses0.dtype)), rtol=1e-10, atol=1e-8)


def test_closed_form_inverses_match_jax():
    """`inv6_spd` (with its Newton-Schulz step), `_inv6_gen`, `_inv12_gen`
    on mixed-scale SPD and general matrices."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(16, 6, 6))
    spd = X @ X.transpose(0, 2, 1) + np.diag([1e6, 1e6, 1e6, 10, 10, 10])
    gen6 = np.eye(6) + 0.2 * rng.normal(size=(16, 6, 6))
    gen12 = np.eye(12) + 0.1 * rng.normal(size=(16, 12, 12))
    for t_fn, j_fn, M in ((ts.inv6_spd, js.inv6_spd, spd), (ts._inv6_gen, js._inv6_gen, gen6),
                          (ts._inv12_gen, js._inv12_gen, gen12)):
        got = t_fn(torch.as_tensor(M)).numpy()
        np.testing.assert_allclose(got, np.asarray(jax.jit(j_fn)(jnp.asarray(M))), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(got @ M, np.broadcast_to(np.eye(M.shape[-1]), M.shape),
                                   atol=1e-9)


def test_spike_matches_thomas_and_jax():
    """SPIKE (groups of m = 16, 32, 64) equals the sequential block-Thomas
    and the JAX package's SPIKE, with several right-hand sides."""
    poses0, graph, tp, tg = _graph(128, 4, seed=11)
    A, C, _, _ = _system(tp, tg, lam=1e-6)
    rhs = np.random.default_rng(0).normal(size=(128, 6, 5))
    x_ref = ts.block_tridiag_solve(ts.block_tridiag_factor(A, C), C, torch.as_tensor(rhs))
    for m in (16, 32, 64):
        x = ts.solve_block_tridiag_spike(A, C, torch.as_tensor(rhs), m=m)
        np.testing.assert_allclose(x.numpy(), x_ref.numpy(), rtol=1e-8, atol=1e-10)
        xj = jax.jit(js.solve_block_tridiag_spike, static_argnames="m")(
            jnp.asarray(A.numpy()), jnp.asarray(C.numpy()), jnp.asarray(rhs), m=m)
        np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("n_loops,loop_capacity,fix_first", [
    (5, 8, False),  # every loop in the correction
    (5, 2, False),  # the loop_capacity bucket truncates: the first 2 loops only
    (4, 8, True),   # fix_first, with a loop touching pose 0 left out
])
@pytest.mark.parametrize("K", [48, 128])  # the block-Thomas path, then SPIKE
def test_woodbury_equals_dense_solve(K, n_loops, loop_capacity, fix_first):
    """One `solve_tridiag_woodbury` against `torch.linalg.solve` of the
    (6K)^2 system it stands for, and against the JAX package's."""
    poses0, graph, tp, tg = _graph(K, n_loops, seed=K + n_loops, loop_at_0=fix_first)
    A, C, Hoff, b = _system(tp, tg)
    f = tg.between
    fw = f._replace(mask=f.mask & (f.i != 0) & (f.j != 0)) if fix_first else f
    x = ts.solve_tridiag_woodbury(A, C, tp, fw, -b, loop_capacity)
    loops = torch.nonzero(fw.mask & (f.j != f.i + 1) & (f.i != f.j + 1))[:, 0].tolist()
    assert len(loops) > loop_capacity or loop_capacity == 8
    H = _dense(A, C, Hoff, fw, sel=loops[:loop_capacity])
    want = torch.linalg.solve(H, -b.reshape(-1)).reshape(K, 6)
    assert float((x - want).norm() / want.norm()) < 1e-10
    jf = graph.between
    jfw = jf._replace(mask=jnp.asarray(fw.mask.numpy())) if fix_first else jf
    xj = jax.jit(js.solve_tridiag_woodbury, static_argnums=5)(
        jnp.asarray(A.numpy()), jnp.asarray(C.numpy()), poses0, jfw, -jnp.asarray(b.numpy()),
        loop_capacity)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("K,fix_first", [(48, False), (128, False), (48, True)])
def test_optimize_graph_sparse_matches_jax_and_dense(K, fix_first):
    poses0, graph, tp, tg = _graph(K, 6, seed=K + 1, loop_at_0=fix_first)
    jcfg = JSolveConfig(**SOLVE, fix_first=fix_first)
    cfg = config_from_dict(tsol.SolveConfig, jcfg._asdict())
    jr = js.optimize_graph_sparse(poses0, graph, jcfg)
    tr = ts.optimize_graph_sparse(tp, tg, cfg)
    assert int(tr.iterations) == int(jr.iterations)
    np.testing.assert_allclose(tr.poses.numpy(), np.asarray(jr.poses), atol=1e-9)
    np.testing.assert_allclose(float(tr.chi2), float(jr.chi2), rtol=1e-9)
    np.testing.assert_allclose(float(tr.lm_lambda), float(jr.lm_lambda), rtol=1e-12)
    np.testing.assert_allclose(tr.H_diag.numpy(), np.asarray(jr.H_diag), rtol=1e-9, atol=1e-6)
    if fix_first:
        np.testing.assert_array_equal(tr.poses[0].numpy(), tp[0].numpy())
    dense = tsol.optimize_graph(tp, tg, cfg._replace(solver="dense"))
    assert float(tr.chi2) <= float(dense.chi2) * 1.001 + 1e-9
    np.testing.assert_allclose(tr.poses[:, :3, 3].numpy(), dense.poses[:, :3, 3].numpy(),
                               atol=5e-4)


@pytest.mark.parametrize("n_edges,cap", [(12, 8), (12, 2), (3, 8)])
def test_loop_slots_follow_nonzero(n_edges, cap):
    """`_loop_slots` is `jnp.nonzero(is_loop, size=cap, fill_value=0)`: the
    first `cap` loop edges in order, padded with edge 0."""
    rng = np.random.default_rng(n_edges + cap)
    i = rng.integers(0, 20, n_edges)
    j = np.where(rng.random(n_edges) < 0.5, i + 1, rng.integers(0, 20, n_edges))
    mask = rng.random(n_edges) < 0.8
    f = SimpleNamespace(i=torch.as_tensor(i), j=torch.as_tensor(j), mask=torch.as_tensor(mask))
    sel, lmask = ts._loop_slots(f, cap)
    is_loop = mask & (j != i + 1) & (i != j + 1)
    (want,) = jnp.nonzero(jnp.asarray(is_loop), size=cap, fill_value=0)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(want))
    np.testing.assert_array_equal(lmask.numpy(), is_loop[np.asarray(want)])


def test_unported_sparse_options_raise():
    """`solver="cg"` is no longer refused: the block-preconditioned CG runs
    and matches the JAX package's (`tests/test_torch_cg.py` has the wider
    checks)."""
    poses0, graph, tp, tg = _graph(16, 1, seed=0)
    jcfg = JSolveConfig(max_iterations=40, solver="cg")
    want = jax.jit(js.optimize_graph_sparse, static_argnames="cfg")(poses0, graph, cfg=jcfg)
    got = ts.optimize_graph_sparse(tp, tg, tsol.SolveConfig(**jcfg._asdict()))
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(got.poses.numpy(), np.asarray(want.poses), rtol=0, atol=1e-9)
