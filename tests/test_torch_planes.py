"""Port parity: the plane-vertex factor families and the joint pose + plane
solvers (`gorio_tpu_torch.graph`) against the JAX package, float64.

Every family's residual and its Jacobian w.r.t. the local perturbations of
its vertices go through both packages on the same random vertices
(tolerance 1e-12: a handful of float64 products). Graphs are built by the
same calls on both `PoseGraph`s; the port's `freeze_planes` must give the
arrays of the JAX package's, and the frozen JAX graphs carried across by
`convert.py` must equal them. The dense joint solver runs on a 24-pose graph
with every plane family, the block-sparse one on a 160-pose graph (960 pose
dimensions, above the 768 of the dense cutoff) with loop closures and the
floor plane; poses and planes must agree to 1e-8 and the LM iteration counts
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from gorio_tpu.graph import factors as jf
from gorio_tpu.graph import graph as jg
from gorio_tpu.graph import solver as jsv
from gorio_tpu.graph import sparse as jsp
from gorio_tpu_torch.convert import config_from_dict, graph_from_numpy, plane_graph_from_numpy
from gorio_tpu_torch.graph import factors as tf
from gorio_tpu_torch.graph import graph as tg
from gorio_tpu_torch.graph import solver as tsv
from gorio_tpu_torch.graph import sparse as tsp


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's small tensors run fastest on one CPU thread, and the test
    files run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_pose(rng, scale=1.0):
    from scipy.spatial.transform import Rotation

    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(0.3 * rng.normal(size=3)).as_matrix()
    T[:3, 3] = scale * rng.normal(size=3)
    return T


def _rand_plane(rng, up=True):
    n = rng.normal(size=3) * 0.2 + (np.array([0.0, 0.0, 1.0]) if up else 0.0)
    n = n / np.linalg.norm(n)
    return np.concatenate([n, [rng.normal()]])


def _local_fns(fam, ffac, lie_retract, plane_retract, args):
    """(n_delta, f(d)) of one factor of `fam`: the residual at the vertices
    moved by the local perturbation d."""
    if fam == "plane_prior":
        p, nm, dm = args
        return 3, lambda d: ffac.PlanePriorFactors.residual(plane_retract(p, d), nm, dm)
    if fam.startswith("plane_plane"):
        pi, pj, kind, meas = args
        return 6, lambda d: ffac.PlanePlaneFactors.residual(
            plane_retract(pi, d[:3]), plane_retract(pj, d[3:]), kind, meas)
    if fam == "se3_plane":
        T, p, meas = args
        return 9, lambda d: ffac.SE3PlaneFactors.residual(lie_retract(T, d[:6]),
                                                          plane_retract(p, d[6:]), meas)
    if fam == "z_between":
        Ti, Tj, z = args
        return 12, lambda d: ffac.ZBetweenFactors.residual(lie_retract(Ti, d[:6]),
                                                           lie_retract(Tj, d[6:]), z)
    T, pu, pw = args
    return 6, lambda d: ffac.UTMAlignFactors.residual(lie_retract(T, d), pu, pw)


def _args(fam, rng):
    if fam == "plane_prior":
        n = _rand_plane(rng)[:3]
        if rng.random() < 0.5:
            n = -n  # the sign fix must flip the vertex
        return [_rand_plane(rng), n, rng.normal()]
    if fam.startswith("plane_plane"):
        kind = int(fam[-1])
        pj = _rand_plane(rng) * (-1.0 if rng.random() < 0.5 else 1.0)
        return [_rand_plane(rng), pj, kind, 0.1 * rng.normal(size=4)]
    if fam == "se3_plane":
        meas = _rand_plane(rng)
        meas[:3] *= -1.0 if rng.random() < 0.5 else 1.0
        return [_rand_pose(rng), _rand_plane(rng), meas]
    if fam == "z_between":
        return [_rand_pose(rng), _rand_pose(rng), rng.normal()]
    return [_rand_pose(rng), rng.normal(size=3), rng.normal(size=3)]


FAMILIES = ["plane_prior", "plane_plane0", "plane_plane1", "plane_plane2", "se3_plane",
            "z_between", "utm_align"]


@pytest.mark.parametrize("fam", FAMILIES)
def test_plane_family_residual_and_jacobian_match_jax(fam):
    rng = np.random.default_rng(FAMILIES.index(fam))
    for _ in range(4):
        args = _args(fam, rng)
        n, fj = _local_fns(fam, jf, jf.retract, jf.retract_plane,
                           [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args])
        _, ft = _local_fns(fam, tf, tf.retract, tf.retract_plane,
                           [torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args])
        rj, Jj = fj(jnp.zeros(n)), jax.jacfwd(fj)(jnp.zeros(n))
        d0 = torch.zeros(n, dtype=torch.float64)
        rt, Jt = ft(d0), jacfwd(ft)(d0)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), rtol=1e-12, atol=1e-12)


def test_plane_chart_matches_jax():
    rng = np.random.default_rng(9)
    for up in (True, False):  # both seed axes of the tangent basis
        p, d, T = _rand_plane(rng, up), 0.3 * rng.normal(size=3), _rand_pose(rng)
        np.testing.assert_allclose(tf.plane_tangent_basis(torch.as_tensor(p[:3])).numpy(),
                                   np.asarray(jf.plane_tangent_basis(jnp.asarray(p[:3]))),
                                   atol=1e-14)
        np.testing.assert_allclose(tf.retract_plane(torch.as_tensor(p), torch.as_tensor(d)).numpy(),
                                   np.asarray(jf.retract_plane(jnp.asarray(p), jnp.asarray(d))),
                                   atol=1e-14)
        np.testing.assert_allclose(tf.transform_plane(torch.as_tensor(T), torch.as_tensor(p)).numpy(),
                                   np.asarray(jf.transform_plane(jnp.asarray(T), jnp.asarray(p))),
                                   atol=1e-14)


def _build(G, K, rng, loops=(), all_families=True):
    """The same graph on either package's `PoseGraph`: a noisy odometry
    chain with an anchor, loop closures, a floor plane seen from every third
    pose; with `all_families`, a wall plane with its priors, the three
    plane-plane kinds, an altitude edge and a UTM alignment."""
    g = G()
    truth = [np.eye(4)]
    for k in range(1, K):
        step = _rand_pose(rng, 0.3)
        step[:3, 3] += [1.0, 0.0, 0.0]
        truth.append(truth[-1] @ step)
    for T in truth:
        noisy = T @ _rand_pose(rng, 0.05)
        g.add_pose(noisy)
    g.add_prior(0, truth[0], info=np.eye(6) * 1e6)
    for k in range(1, K):
        rel = np.linalg.inv(truth[k - 1]) @ truth[k] @ _rand_pose(rng, 0.01)
        g.add_between(k - 1, k, rel, info=np.eye(6) * 100.0)
    for i, j in loops:
        g.add_between(i, j, np.linalg.inv(truth[i]) @ truth[j], info=np.eye(6) * 50.0,
                      robust_delta=1.0)
    floor = np.array([0.01, -0.02, 1.0, 0.7])
    floor /= np.linalg.norm(floor[:3])
    jfl = g.add_plane(floor + np.array([0.02, 0.0, 0.0, 0.05]))
    info3 = np.diag([100.0, 100.0, 100.0])
    for k in range(0, K, 3):
        n_b = truth[k][:3, :3].T @ floor[:3]
        meas = np.concatenate([n_b, [floor[3] + floor[:3] @ truth[k][:3, 3]]])
        g.add_se3_plane(k, jfl, meas + 0.01 * rng.normal(size=4), info3, robust_delta=1.0)
    if all_families:
        wall = g.add_plane([1.0, 0.05, 0.02, -3.0])
        g.add_plane_prior_normal(wall, [1.0, 0.0, 0.0], np.eye(3) * 10.0)
        g.add_plane_prior_distance(wall, -3.1, 4.0)
        g.add_plane_perpendicular(jfl, wall, 10.0)
        g.add_plane_parallel(wall, wall, np.zeros(3), np.eye(3))
        g.add_plane_identity(jfl, jfl, np.zeros(4), np.eye(4))
        g.add_se3_z(1, 2, truth[2][2, 3] - truth[1][2, 3], 25.0)
        g.add_utm_align(K - 1, truth[K - 1][:3, 3] + 0.1, truth[K - 1][:3, 3], np.eye(3))
    return g


def _frozen(K, seed, loops=(), all_families=True):
    jgraph = _build(jg.PoseGraph, K, np.random.default_rng(seed), loops, all_families)
    tgraph = _build(tg.PoseGraph, K, np.random.default_rng(seed), loops, all_families)
    jposes, jgd = jgraph.freeze(as_numpy=True)
    jplanes, jpg = jgraph.freeze_planes(as_numpy=True)
    tposes, tgd = tgraph.freeze()
    tplanes, tpg = tgraph.freeze_planes()
    return (jposes, jgd, jplanes, jpg), (tposes, tgd, tplanes, tpg)


def _same_tree(a, b):
    for fa, fb in zip(a, b):
        for xa, xb in zip(fa, fb):
            assert torch.equal(xa, xb)


def test_freeze_planes_matches_jax_and_converts():
    """The port's freeze of the same graph equals the frozen JAX graph
    carried across by `convert.py` (poses, pose factors, planes, plane
    factors)."""
    (jposes, jgd, jplanes, jpg), (tposes, tgd, tplanes, tpg) = _frozen(16, 0, loops=[(2, 12)])
    assert torch.equal(tposes, torch.as_tensor(jposes))
    _same_tree(graph_from_numpy(jgd), tgd)
    cplanes, cpg = plane_graph_from_numpy(jplanes, jpg)
    assert torch.equal(cplanes, tplanes) and cplanes.shape == (2, 4)
    _same_tree(cpg, tpg)
    assert int(tpg.se3_plane.mask.sum()) == 6 and int(tpg.plane_plane.mask.sum()) == 3
    # no plane vertex: one unused [0, 0, 1, 0]
    planes, _ = tg.PoseGraph().freeze_planes()
    assert planes.tolist() == [[0.0, 0.0, 1.0, 0.0]]


def test_plane_terms_and_chi2_match_jax():
    (jposes, jgd, jplanes, jpg), (tposes, tgd, tplanes, tpg) = _frozen(12, 1, loops=[(1, 9)])
    jout = jax.jit(jsv._plane_terms)(jnp.asarray(jposes), jnp.asarray(jplanes),
                            jax.tree.map(jnp.asarray, jpg))
    tout = tsv._plane_terms(tposes, tplanes, tpg)
    for name, a, b in zip(("Hxx", "Hxp", "Hpp", "bx", "bp", "chi2"), tout, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(
        float(tsv.plane_graph_chi2(tposes, tplanes, tpg)),
        float(jax.jit(jsv.plane_graph_chi2)(jnp.asarray(jposes), jnp.asarray(jplanes),
                                   jax.tree.map(jnp.asarray, jpg))), rtol=1e-12)
    jb = jax.jit(jsp._plane_block_terms)(jnp.asarray(jposes), jnp.asarray(jplanes),
                                jax.tree.map(jnp.asarray, jpg))
    tb = tsp._plane_block_terms(tposes, tplanes, tpg)
    for name, a, b in zip(("Hx", "Hz_off", "Hpp", "Hxp", "bx", "bp", "chi2"), tb, jb):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-9, err_msg=name)


def _check_solve(t, j, iters_equal=True):
    np.testing.assert_allclose(t.poses.numpy(), np.asarray(j.poses), atol=1e-8)
    np.testing.assert_allclose(t.planes.numpy(), np.asarray(j.planes), atol=1e-8)
    np.testing.assert_allclose(float(t.chi2), float(j.chi2), rtol=1e-8)
    assert int(t.iterations) == int(j.iterations)


@pytest.mark.parametrize("fix_first", [False, True])
def test_dense_plane_solve_matches_jax(fix_first):
    (jposes, jgd, jplanes, jpg), (tposes, tgd, tplanes, tpg) = _frozen(24, 2, loops=[(3, 20)])
    jcfg = jsv.SolveConfig(max_iterations=15, fix_first=fix_first)
    j = jsv.optimize_graph_with_planes(jnp.asarray(jposes), jnp.asarray(jplanes),
                                       jax.tree.map(jnp.asarray, jgd),
                                       jax.tree.map(jnp.asarray, jpg), jcfg)
    t = tsv.optimize_graph_with_planes(tposes, tplanes, tgd, tpg,
                                       config_from_dict(tsv.SolveConfig, jcfg._asdict()))
    _check_solve(t, j)
    assert t.H.shape == (6 * 24 + 3 * 2,) * 2
    assert int(t.iterations) > 1


def test_sparse_plane_solve_matches_jax():
    """160 poses (960 pose dimensions), three loops, the floor plane only
    (the slam back end's graph), `solver="direct"`."""
    loops = [(5, 150), (20, 130), (40, 100)]
    (jposes, jgd, jplanes, jpg), (tposes, tgd, tplanes, tpg) = _frozen(
        160, 3, loops=loops, all_families=False)
    jcfg = jsv.SolveConfig(max_iterations=8, solver="direct", loop_capacity=8)
    j = jsp.optimize_graph_with_planes_sparse(jnp.asarray(jposes), jnp.asarray(jplanes),
                                              jax.tree.map(jnp.asarray, jgd),
                                              jax.tree.map(jnp.asarray, jpg), jcfg)
    t = tsp.optimize_graph_with_planes_sparse(tposes, tplanes, tgd, tpg,
                                              config_from_dict(tsv.SolveConfig, jcfg._asdict()))
    _check_solve(t, j)


@pytest.mark.parametrize("fix_first", [False, True])
def test_sparse_plane_solve_equals_dense(fix_first):
    """The exact sparse solve (block-Thomas at 48 poses, every plane family
    except a non-adjacent altitude edge) gives the dense joint solve's
    answer."""
    _, (tposes, tgd, tplanes, tpg) = _frozen(48, 4, loops=[(2, 40), (10, 30)])
    cfg = tsv.SolveConfig(max_iterations=10, fix_first=fix_first)
    d = tsv.optimize_graph_with_planes(tposes, tplanes, tgd, tpg, cfg)
    s = tsp.optimize_graph_with_planes_sparse(tposes, tplanes, tgd, tpg,
                                              cfg._replace(solver="direct", loop_capacity=8))
    np.testing.assert_allclose(s.poses.numpy(), d.poses.numpy(), atol=1e-8)
    np.testing.assert_allclose(s.planes.numpy(), d.planes.numpy(), atol=1e-8)
    assert int(s.iterations) == int(d.iterations)


@pytest.mark.parametrize("which", ["dense", "sparse"])
def test_plane_solvers_refuse_cg(which):
    """`solver="cg"` is no longer refused: both joint solvers run CG and
    match the JAX package's (`cg_iters=10`, where every dense CG solve stops
    at the cap; `tests/test_torch_cg.py` has the wider checks)."""
    (jposes, jgd, jplanes, jpg), (tposes, tgd, tplanes, tpg) = _frozen(8, 5, all_families=False)
    jcfg = jsv.SolveConfig(max_iterations=15, solver="cg", cg_iters=10)
    jfn, tfn = ((jsv.optimize_graph_with_planes, tsv.optimize_graph_with_planes)
                if which == "dense" else
                (jsp.optimize_graph_with_planes_sparse, tsp.optimize_graph_with_planes_sparse))
    j = jfn(jnp.asarray(jposes), jnp.asarray(jplanes), jax.tree.map(jnp.asarray, jgd),
            jax.tree.map(jnp.asarray, jpg), jcfg)
    t = tfn(tposes, tplanes, tgd, tpg, config_from_dict(tsv.SolveConfig, jcfg._asdict()))
    _check_solve(t, j)
