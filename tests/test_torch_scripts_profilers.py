"""The profilers' components (`gorio_tpu_torch/evaluation/profile_*.py`,
the ports of `scripts/profile_linearize.py`, `profile_ndt.py`,
`profile_graph_solve.py`, `profile_ugpm.py` and `profile_ugpm2.py`), each
evaluated once in float64 on the CPU and held against the same expression
built from the JAX package's functions on the same inputs.

- Linearize, N = 256 (the script's cloud and shift, the port's
  `random_cloud` draws handed to both packages): the full linearize's
  cost / H / b, the 1-NN (d2 1e-10), the gather sum, APD + inverse and the H / b
  einsums within 1e-9 of each quantity's largest entry (the 1-NN indices
  exact).
- NDT, `bench.synth_pair(n=16000)` through the port's `ndt_inputs` (0.1 m
  leaf, DIRECT7 at 1.0 m), the JAX map built from the same downsampled
  clouds: the gather (found exact, mu / c6 1e-10), the frozen score, the
  11-candidate sweep and the 27-column reduction (1e-10 relative), and the
  align's iterations, T (1e-8) and score (1e-10).
- Graph solve, K = 32 (the root `bench.py`'s `make_solve_graph`, its
  float32 graph in float64 for both): the block normal equations (1e-10),
  PCG at 20 and 100 iterations with the block-Thomas preconditioner
  against `jax.scipy.sparse.linalg.cg` (x within 1e-8 of its largest
  entry, the same relative residual to 1e-6 relative), the factor and the
  solve alone (1e-10), and the full CG LM's iterations (equal) and chi2
  (1e-8 relative).
- UGPM, W = 2 windows of the scripts' inputs, each of the four variants:
  the fitted state against `jax.vmap(ugpm_fit)` (1e-7 of each field's
  largest entry; the LM's dense solves sum in another order), and the
  second script's inputs (its velocities, then its gyro batches). Each
  config's JAX program is compiled once (`jfit_program`): the full fit's
  serves both tests."""

import functools
import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gorio_tpu.core import lie as jlie
from gorio_tpu.core import pointcloud as jpc
from gorio_tpu.graph import sparse as jsp
from gorio_tpu.graph.solver import SolveConfig as JSolveConfig
from gorio_tpu.ops.nn_pallas import nn1_best as jnn1
from gorio_tpu.preintegration import ugpm as ju
from gorio_tpu.registration import gicp as jg
from gorio_tpu.registration import ndt as jn
from gorio_tpu_torch.convert import graph_from_numpy
from gorio_tpu_torch.evaluation import profile_graph_solve as pg
from gorio_tpu_torch.evaluation import profile_linearize as pl
from gorio_tpu_torch.evaluation import profile_ndt as pn
from gorio_tpu_torch.evaluation import profile_ugpm as pu
from gorio_tpu_torch.evaluation.sequence import REPO
from gorio_tpu_torch.preintegration.ugpm import UGPMConfig

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the port's many small ops run several times faster
    on the CPU than on the default threads, with the same values."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol, msg=""):
    """Within rtol of the largest |want|."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300),
                               err_msg=msg)


def jcloud(cloud):
    return jpc.PointCloud(*(jnp.asarray(x.numpy()) for x in cloud))


# ---- linearize ---------------------------------------------------------------


@pytest.fixture(scope="module")
def lin():
    src, tgt, prob, cfg = pl.problem(CPU, n=256, dtype=torch.float64)
    jcfg = jg.GICPConfig()
    jprob = jg.prepare_gicp(jcloud(src), jcloud(tgt), jcfg)
    close(prob.tgt_cov, jprob.tgt_cov, 1e-10, "prepare_gicp")
    return src, prob, cfg, jprob, jcfg


def test_linearize_full(lin):
    from gorio_tpu_torch.registration.gicp import make_gicp_callbacks

    src, prob, cfg, jprob, jcfg = lin
    T = np.eye(4)
    T[:3, 3] = [-0.3, -0.1, 0.0]  # short of the shift: most points matched
    got = pl.full_linearize(make_gicp_callbacks(prob, cfg)[0], torch.as_tensor(T))
    want = jg.make_gicp_callbacks(jprob, jcfg)[0](jnp.asarray(T))[:3]
    assert float(want[0]) > 0.0
    for g, w, name in zip(got, want, ("cost", "H", "b")):
        close(g, w, 1e-9, name)


def test_linearize_nn_and_gather(lin):
    src, prob, _, jprob, _ = lin
    idx, d2 = pl.nn_only(prob, src.xyz)
    jidx, jd2 = jnn1(jnp.asarray(src.xyz.numpy()), jprob.tgt_xyz, ref_mask=jprob.tgt_mask)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    close(d2, jd2, 1e-10, "d2")
    ji = np.asarray(jidx)
    want = (jnp.sum(jprob.tgt_cov[ji]) + jnp.sum(jprob.tgt_xyz[ji])
            + jnp.sum(jprob.tgt_cluster[ji]) + jnp.sum(jd2))
    close(pl.nn_gather(prob, src.xyz), want, 1e-10, "gather")


def test_linearize_apd_inv3_and_hb(lin):
    src, prob, cfg, jprob, jcfg = lin
    x = jnp.asarray(src.xyz.numpy())
    cov_d = jg.apd_polar_cov(x, jcfg.dist_var, jcfg.azimuth_var_deg, jcfg.elevation_var_deg)
    want = jg._inv3((jprob.tgt_cov + cov_d) + (jprob.src_cov + cov_d))
    close(pl.apd_inv3(prob, cfg, src.xyz), want, 1e-9, "apd+inv3")

    mah0 = jg._inv3(jprob.tgt_cov + jprob.src_cov)
    err0 = jprob.tgt_xyz - jprob.src_xyz
    okf0 = jprob.src_mask.astype(x.dtype)
    sk = jlie.hat(x)
    MS = mah0 @ sk
    want = (jnp.einsum("nji,njk,n->ik", sk, MS, okf0),
            -jnp.einsum("nji,njk,n->ik", sk, mah0, okf0),
            jnp.einsum("nij,n->ij", mah0, okf0),
            jnp.einsum("nji,nj,n->i", sk, jnp.einsum("nij,nj->ni", mah0, err0), okf0))
    for g, w, name in zip(pl.hb_einsums(src.xyz, *pl.hb_inputs(prob)), want,
                          ("H_rr", "H_rt", "H_tt", "b_r")):
        close(g, w, 1e-9, name)


# ---- NDT ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def ndt():
    from gorio_tpu_torch.bench import synth_pair

    (a, _), (b, _) = synth_pair(n=16000)
    inp, _ = pn.inputs(CPU, pair=(a, b, "small synth pair"), dtype=torch.float64)
    jcfg = jn.NDTConfig(**inp.cfg._asdict())
    jsrc, jtgt = jcloud(inp.source), jcloud(inp.target)
    jmap = jn.build_voxel_map(jtgt, jcfg)
    T = np.eye(4)
    T[:3, 3] = [-0.2, -0.05, 0.0]  # toward the pair's known offset
    return inp, jcfg, jsrc, jmap, T


def test_ndt_gather_and_scores(ndt):
    inp, jcfg, jsrc, jmap, T = ndt
    Tt, Tj = torch.as_tensor(T), jnp.asarray(T)
    frozen = pn.gather_pass(inp, Tt)
    jfound, jmu, jc6 = jn._gather_correspondences(jsrc, jmap, Tj, jcfg)
    np.testing.assert_array_equal(frozen[0].numpy(), np.asarray(jfound))
    ok = np.asarray(jfound)
    assert ok.sum() > 100
    np.testing.assert_allclose(frozen[1].numpy()[ok], np.asarray(jmu)[ok], rtol=1e-10)
    for a, b in zip(frozen[2], jc6):
        np.testing.assert_allclose(a.numpy()[ok], np.asarray(b)[ok], rtol=1e-10, atol=1e-12)

    d1, d2 = jn._gauss_coeffs(jcfg, jnp.float64)
    want = jn._score_cached(jsrc, jfound, jmu, jc6, d1, d2, Tj)
    assert float(want) < -10.0
    close(pn.frozen_score(inp, frozen, Tt), want, 1e-10, "frozen score")

    s = 4
    src_ls = jax.tree.map(lambda x: x[::s], jsrc)
    cand = jnp.linspace(0.001, 0.01, 11)[:, None] * jnp.ones((11, 6))
    want = jax.vmap(lambda dd: jn._score_cached(
        src_ls, jfound[::s], jmu[::s], tuple(c[::s] for c in jc6), d1, d2,
        jlie.se3_exp_split(dd) @ Tj))(cand)
    close(pn.line_search_sweep(inp, frozen, Tt, pn.candidates(torch.float64, CPU)), want, 1e-10,
          "sweep")


def test_ndt_deriv_reduction(ndt):
    inp, jcfg, jsrc, jmap, T = ndt
    Tj = jnp.asarray(T)
    found, mu, c6 = jn._gather_correspondences(jsrc, jmap, Tj, jcfg)
    d1, d2 = jn._gauss_coeffs(jcfg, jnp.float64)
    moved = jsrc.xyz @ Tj[:3, :3].T + Tj[:3, 3]
    md2, _, (q0, q1, q2) = jn._md2_comp(moved, mu, c6)
    coef = jnp.where(found, -d2 * d1 * jnp.exp(-0.5 * d2 * md2), 0.0)
    m0, m1, m2 = moved[:, None, 0], moved[:, None, 1], moved[:, None, 2]
    u = (m1 * q2 - m2 * q1, m2 * q0 - m0 * q2, m0 * q1 - m1 * q0, q0, q1, q2)
    cols = jnp.stack(list(u) + [u[i] * u[j] for i in range(6) for j in range(i, 6)], axis=0)
    want = cols.reshape(27, -1) @ coef.reshape(-1)
    got = pn.deriv_reduction(inp, pn.gather_pass(inp, torch.as_tensor(T)), torch.as_tensor(T))
    close(got, want, 1e-10, "27 columns")


def test_ndt_full_align(ndt):
    inp, jcfg, jsrc, jmap, T = ndt
    got = pn.full_align(inp, torch.eye(4, dtype=torch.float64))
    want = jn.ndt_align_with_map(jsrc, jmap, jnp.eye(4), jcfg)
    assert int(got.iterations) == int(want.iterations) >= 2
    close(got.T, want.T, 1e-8, "T")
    assert float(got.error) == pytest.approx(float(want.error), rel=1e-10)


# ---- graph solve -------------------------------------------------------------


@pytest.fixture(scope="module")
def graph():
    spec = importlib.util.spec_from_file_location("root_bench", REPO / "bench.py")
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    poses, g = jbench.make_solve_graph(32).freeze(as_numpy=True)
    f64 = lambda x: np.asarray(x, np.float64) if np.asarray(x).dtype.kind == "f" else x  # noqa
    poses, g = f64(poses), jax.tree.map(f64, g)
    jpose, jgraph = jnp.asarray(poses), jax.tree.map(jnp.asarray, g)
    tpose, tgraph = torch.as_tensor(poses), graph_from_numpy(g)
    # the module's own graph is the same problem, built in float64
    mp, mg = pg.graph(32, CPU)
    close(mp, poses, 1e-6, "poses0")
    close(mg.between.T_meas, g.between.T_meas, 1e-6, "T_meas")
    return jpose, jgraph, tpose, tgraph


@pytest.fixture(scope="module")
def jax_blocks(graph):
    """The JAX package's block normal equations, damped blocks and
    block-Thomas factors of the graph (jitted: eager, its ops compile one
    by one)."""
    jpose, jgraph = graph[:2]
    f = jgraph.between

    @jax.jit
    def blocks(poses):
        Hd, Ho, b, chi2 = jsp.build_block_normal_equations(poses, jgraph)
        A = jsp._damped(Hd, pg.LAM)
        C = jsp._chain_upper_blocks(Ho, f.i, f.j, 32, jnp.float64)
        Dinv = jsp.block_tridiag_factor(A, C)
        return (Hd, Ho, b, chi2), A, C, Dinv, jsp.block_tridiag_solve(Dinv, C, b)

    return blocks(jpose)


def test_graph_build_and_tridiag(graph, jax_blocks):
    from gorio_tpu_torch.graph.sparse import block_tridiag_factor, block_tridiag_solve

    tpose, tgraph = graph[2:]
    want, A, C, Dinv, x = jax_blocks
    got = pg.build(tpose, tgraph)
    for g, w, name in zip(got, want, ("Hdiag", "Hoff", "b", "chi2")):
        close(g, w, 1e-10, name)
    tA, tC = pg.damped_blocks(*got[:2], tgraph)
    close(tA, A, 1e-12, "A")
    close(tC, C, 1e-12, "C")
    tD = block_tridiag_factor(tA, tC)
    close(tD, Dinv, 1e-10, "Dinv")
    close(block_tridiag_solve(tD, tC, got[2][..., None])[..., 0], x, 1e-10, "tridiag solve")


@pytest.mark.parametrize("iters", pg.CG_ITERS)
def test_graph_cg(graph, jax_blocks, iters):
    jpose, jgraph, tpose, tgraph = graph
    (_, Ho, b, _), A, C, Dinv, _ = jax_blocks
    f = jgraph.between

    def mv(x):
        y = jnp.einsum("kij,kj->ki", A, x)
        y = y.at[f.i].add(jnp.einsum("eij,ej->ei", Ho, x[f.j]))
        return y.at[f.j].add(jnp.einsum("eji,ej->ei", Ho, x[f.i]))

    want = jax.jit(lambda: jax.scipy.sparse.linalg.cg(
        mv, -b, M=lambda v: jsp.block_tridiag_solve(Dinv, C, v), maxiter=iters)[0])()
    want_r = float(jnp.linalg.norm(mv(want) + b) / jnp.linalg.norm(b))
    tHd, tHo, tb, _ = pg.build(tpose, tgraph)
    got = pg.solve_cg(tHd, tHo, tb, tgraph, iters)
    close(got, want, 1e-8, "x")
    got_r = float(pg.rel_residual(tHd, tHo, tb, tgraph, got))
    assert got_r == pytest.approx(want_r, rel=1e-6) and got_r < 1e-3


def test_graph_full_solve(graph):
    jpose, jgraph, tpose, tgraph = graph
    want = jsp.optimize_graph_sparse(jpose, jgraph, JSolveConfig(**pg.FULL_CFG))
    got = pg.full_solve(tpose, tgraph)
    assert int(got.iterations) == int(want.iterations)
    assert float(got.chi2) == pytest.approx(float(want.chi2), rel=1e-8, abs=1e-12)
    close(got.poses, want.poses, 1e-8, "poses")


# ---- UGPM --------------------------------------------------------------------

STATE = ("s_rot", "s_vel", "mean_rot", "mean_vel", "alpha", "state_var")


@functools.lru_cache(maxsize=None)
def jfit_program(cfg):
    """The JAX package's batched fit under one config, jitted."""
    jcfg = ju.UGPMConfig(**cfg._asdict())
    return jax.jit(jax.vmap(lambda a, b, c, d, s: ju.ugpm_fit(a, b, c, d, s, pu.GYR_VAR,
                                                              pu.VEL_VAR, jcfg)))


def jfit(args, cfg):
    return jfit_program(cfg)(*(jnp.asarray(x.numpy()) for x in args))


@pytest.mark.parametrize("variant", list(pu.VARIANTS))
def test_ugpm_variants(variant):
    args = pu.inputs(CPU, w=2)
    cfg = pu.config(variant)
    assert cfg == UGPMConfig(window_duration=0.6, lm_iters=10)._replace(**pu.VARIANTS[variant])
    got, want = pu.fit(args, cfg), jfit(args, cfg)
    for f in STATE:
        close(getattr(got, f), getattr(want, f), 1e-7, f"{variant}: {f}")


def test_ugpm_batches():
    """The second script's inputs: the velocities are its first draw, then
    the gyro batches; the fit of one batch against JAX's."""
    (gyr_t, vel_t, vel, starts), batches = pu.batch_inputs(CPU, w=2, n_batches=2)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(vel.numpy(), rng.normal(scale=1.0, size=(2, pu.V, 3)))
    np.testing.assert_array_equal(batches[0].numpy(), rng.normal(scale=0.2, size=(2, pu.G, 3)))
    args = (gyr_t, batches[1], vel_t, vel, starts)
    cfg = pu.config("full fit")
    got, want = pu.fit(args, cfg), jfit(args, cfg)
    close(got.alpha, want.alpha, 1e-7, "alpha")
    distinct, same = pu.batch_rates((gyr_t, vel_t, vel, starts), batches, cfg, CPU)
    assert distinct > 0 and same > 0


def test_profilers_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for main in (pl.main, pn.main, pg.main, pu.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main("cuda")
