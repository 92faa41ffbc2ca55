"""Dense Levenberg-Marquardt pose-graph solver, poses alone or jointly
with plane vertices.

Port of `build_normal_equations`, `graph_chi2`, `_solve_dense`,
`_solve_cg`, `optimize_graph`, `_plane_terms`, `plane_graph_chi2` and
`optimize_graph_with_planes` from `gorio_tpu/graph/solver.py`
(`GraphSLAM::optimize`, `graph_slam.cpp:353-382`): factor residuals are
evaluated batched per family, their Jacobians with `torch.func.jacfwd`
under `torch.func.vmap`, scatter-added into block normal equations, and the
damped system is solved by a dense Cholesky (`solver="dense"`) or by
Jacobi-preconditioned conjugate gradients (`solver="cg"`, `pcg`). The JAX
`lax.while_loop` becomes a Python loop with the same bound and the same
accept/reject rule; the host reads the stop flag once per iteration. Matrix
products keep full float32 on the card (TF32 off, the JAX package's
`_f32_matmuls`).

The block-sparse solvers are `graph/sparse.py` (the SLAM back end switches
to them above 128 padded poses).
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from .factors import (
    BetweenFactors,
    GraphData,
    GroundPlaneFactors,
    PlaneGraphData,
    PlanePlaneFactors,
    PlanePriorFactors,
    PointPriorFactors,
    PriorFactors,
    QuatPriorFactors,
    SE3PlaneFactors,
    UTMAlignFactors,
    VecPriorFactors,
    ZBetweenFactors,
    huber_weight,
    retract,
    retract_plane,
)

CG_TOL = 1e-5  # `jax.scipy.sparse.linalg.cg`'s default relative tolerance
CG_CHECK_EVERY = 10  # CG iterations between two reads of the stop flag


@contextlib.contextmanager
def f32_matmuls():
    """TF32 off for cuBLAS matmuls inside the block (restored afterwards)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _f32_matmuls(fn):
    """Run `fn` inside `f32_matmuls()`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with f32_matmuls():
            return fn(*args, **kwargs)

    return wrapped


class SolveConfig(NamedTuple):
    max_iterations: int = 50
    lm_lambda_init: float = 1e-6
    lm_lambda_factor: float = 10.0
    rel_tol: float = 1e-9
    # "dense" | "direct" (the sparse path's exact solve; a dense solve here) |
    # "cg" (preconditioned conjugate gradients, at most cg_iters steps)
    solver: str = "dense"
    cg_iters: int = 100
    loop_capacity: int = 64
    # freeze pose 0 (default off: the anchor prior fixes the gauge)
    fix_first: bool = False


class SolveResult(NamedTuple):
    poses: torch.Tensor  # (K, 4, 4)
    chi2: torch.Tensor
    iterations: torch.Tensor  # () int, on the CPU
    lm_lambda: torch.Tensor
    H: torch.Tensor  # (6K, 6K) Gauss-Newton Hessian of the last linearization


def _unary_terms(poses, fac, res_fn, meas):
    """Residuals (F, d) and Jacobians (F, d, 6) of a unary family."""

    def local(d, T, *m):
        r = res_fn(retract(T, d), *m)
        return r, r

    d0 = torch.zeros((fac.i.shape[0], 6), dtype=poses.dtype, device=poses.device)
    J, r = vmap(jacfwd(local, has_aux=True))(d0, poses[fac.i], *meas)
    return r, J


def _binary_terms(poses, fac, res_fn, meas):
    """Residuals (F, d) and Jacobians (F, d, 6) w.r.t. both poses."""

    def local(d, Ti, Tj, *m):
        r = res_fn(retract(Ti, d[:6]), retract(Tj, d[6:]), *m)
        return r, r

    d0 = torch.zeros((fac.i.shape[0], 12), dtype=poses.dtype, device=poses.device)
    J, r = vmap(jacfwd(local, has_aux=True))(d0, poses[fac.i], poses[fac.j], *meas)
    return r, J[..., :6], J[..., 6:]


def _weighted(r, sqrt_info, robust_delta, mask):
    """Whiten with sqrt_info and the robust kernel; masked factors zeroed.
    `r` is (..., F, d); the chi2 sums over the factor axis."""
    rw = torch.einsum("fij,...fj->...fi", sqrt_info, r)
    chi2 = torch.sum(rw * rw, dim=-1)
    w = huber_weight(chi2, robust_delta) * mask.to(r.dtype)
    return rw, w, torch.sum(w * chi2, dim=-1)


def _unary_families(graph: GraphData):
    return (
        (graph.priors, PriorFactors.residual, (graph.priors.T_meas,)),
        (graph.point_priors, PointPriorFactors.residual,
         (graph.point_priors.p_meas, graph.point_priors.axis_mask)),
        (graph.quat_priors, QuatPriorFactors.residual, (graph.quat_priors.R_meas,)),
        (graph.vec_priors, VecPriorFactors.residual,
         (graph.vec_priors.dir_world, graph.vec_priors.dir_meas)),
        (graph.plane_factors, GroundPlaneFactors.residual,
         (graph.plane_factors.plane_world, graph.plane_factors.plane_meas)),
    )


def build_normal_equations(poses, graph: GraphData):
    """Assemble block H (K, K, 6, 6), b (K, 6) and chi2."""
    K = poses.shape[0]
    Hb = torch.zeros((K, K, 6, 6), dtype=poses.dtype, device=poses.device)
    bb = torch.zeros((K, 6), dtype=poses.dtype, device=poses.device)

    f = graph.between
    r, Ji, Jj = _binary_terms(poses, f, BetweenFactors.residual, (f.T_meas,))
    rw, w, chi2 = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    Jiw = torch.einsum("fij,fjk->fik", f.sqrt_info, Ji)
    Jjw = torch.einsum("fij,fjk->fik", f.sqrt_info, Jj)
    for a, Ja, bj, Jb in ((f.i, Jiw, f.i, Jiw), (f.j, Jjw, f.j, Jjw),
                          (f.i, Jiw, f.j, Jjw), (f.j, Jjw, f.i, Jiw)):
        Hb = Hb.index_put((a, bj), torch.einsum("fji,fjk,f->fik", Ja, Jb, w), accumulate=True)
    bb = bb.index_put((f.i,), torch.einsum("fji,fj,f->fi", Jiw, rw, w), accumulate=True)
    bb = bb.index_put((f.j,), torch.einsum("fji,fj,f->fi", Jjw, rw, w), accumulate=True)

    for fac, res_fn, meas in _unary_families(graph):
        r, Ji = _unary_terms(poses, fac, res_fn, meas)
        rw, w, c2 = _weighted(r, fac.sqrt_info, fac.robust_delta, fac.mask)
        Jiw = torch.einsum("fij,fjk->fik", fac.sqrt_info, Ji)
        Hb = Hb.index_put((fac.i, fac.i), torch.einsum("fji,fjk,f->fik", Jiw, Jiw, w),
                          accumulate=True)
        bb = bb.index_put((fac.i,), torch.einsum("fji,fj,f->fi", Jiw, rw, w), accumulate=True)
        chi2 = chi2 + c2
    return Hb, bb, chi2


def graph_chi2(poses, graph: GraphData):
    """Total robustified chi2 (no Jacobians) of poses (..., K, 4, 4) -> (...).
    A family with no rows (`live_graph`) is skipped."""
    f = graph.between
    r = BetweenFactors.residual(poses[..., f.i, :, :], poses[..., f.j, :, :], f.T_meas)
    c2 = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)[2]
    for fac, res_fn, meas in _unary_families(graph):
        if fac.i.shape[0]:
            r = res_fn(poses[..., fac.i, :, :], *meas)
            c2 = c2 + _weighted(r, fac.sqrt_info, fac.robust_delta, fac.mask)[2]
    return c2


def live_graph(graph: GraphData) -> GraphData:
    """`graph` with each family cut to its live (masked-in) factors: the
    padding rows contribute nothing to the chi2, and a density evaluated
    thousands of times skips their work. Reads the masks on the host once."""
    def cut(fam):
        keep = torch.nonzero(fam.mask).squeeze(1)
        return type(fam)(*(t[keep] for t in fam))

    return GraphData(*(cut(fam) for fam in graph))


def laplace_covariance(result: SolveResult):
    """Gaussian (Laplace) posterior covariance over the stacked local
    coordinates: H^-1 at the optimum, (6K, 6K)."""
    n = result.H.shape[0]
    eye = torch.eye(n, dtype=result.H.dtype, device=result.H.device)
    L = torch.linalg.cholesky(result.H + 1e-9 * eye)
    return torch.cholesky_solve(eye, L)


def _flatten_H(Hb):
    K = Hb.shape[0]
    return Hb.permute(0, 2, 1, 3).reshape(K * 6, K * 6)


def _solve_dense(H, b, lam):
    """Solve (H + lam diag(max(diag H, 1))) x = -b by Cholesky. A matrix
    that is not positive definite gives NaN (as JAX's Cholesky does), which
    the LM loop rejects like any other failed step."""
    A = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1.0))
    L, info = torch.linalg.cholesky_ex(A)
    x = torch.cholesky_solve(-b[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def _dot(a, b):
    """Sum of the elementwise products over tuples of tensors (JAX's
    `_vdot_real_tree`, leaf by leaf in order)."""
    out = None
    for x, y in zip(a, b):
        d = torch.vdot(x.reshape(-1), y.reshape(-1))
        out = d if out is None else out + d
    return out


def pcg(mv, b, precond, iters: int, check_every: int = CG_CHECK_EVERY):
    """Preconditioned conjugate gradients on tuples of tensors: the rule of
    `jax.scipy.sparse.linalg.cg` with x0 = 0, atol = 0. r0 = b, z = M r,
    gamma = r.z; each step alpha = gamma / p.Ap, x += alpha p, r -= alpha Ap,
    z = M r, beta = gamma' / gamma, p = z + beta p; it stops once
    r.r <= CG_TOL^2 b.b (with a preconditioner JAX compares r.r, not
    gamma) or after `iters` steps.

    The stop test is an on-device mask that freezes x, r, p and gamma, so
    the steps after it change nothing; the host reads it once every
    `check_every` steps (None: never) only to skip those steps. The result
    is the same either way."""
    stop2 = CG_TOL * CG_TOL * _dot(b, b)
    x = tuple(torch.zeros_like(t) for t in b)
    r = b
    p = precond(r)
    gamma = _dot(r, p)
    done = _dot(r, r) <= stop2
    for k in range(iters):
        if check_every and k and k % check_every == 0 and bool(done):
            break
        Ap = mv(p)
        alpha = gamma / _dot(p, Ap)
        x_new = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r_new = tuple(ri - alpha * api for ri, api in zip(r, Ap))
        z = precond(r_new)
        gamma_new = _dot(r_new, z)
        p_new = tuple(zi + (gamma_new / gamma) * pi for zi, pi in zip(z, p))
        x = tuple(torch.where(done, a, c) for a, c in zip(x, x_new))
        r = tuple(torch.where(done, a, c) for a, c in zip(r, r_new))
        p = tuple(torch.where(done, a, c) for a, c in zip(p, p_new))
        gamma = torch.where(done, gamma, gamma_new)
        done = done | (_dot(r, r) <= stop2)
    return x


def _solve_cg(H, b, lam, iters):
    """(H + lam diag(max(diag H, 1))) x = -b by CG with the Jacobi
    preconditioner 1 / (max(diag H, 1e-12) (1 + lam)), as the JAX
    package's `_solve_cg`."""
    diag = torch.clamp(torch.diagonal(H), min=1e-12)
    A = H + lam * torch.diag(torch.clamp(diag, min=1.0))
    Minv = 1.0 / (diag * (1.0 + lam))
    return pcg(lambda v: (A @ v[0],), (-b,), lambda v: (Minv * v[0],), iters)[0]


def _solve(H, b, lam, cfg: SolveConfig):
    return _solve_cg(H, b, lam, cfg.cg_iters) if cfg.solver == "cg" else _solve_dense(H, b, lam)


@_f32_matmuls
def optimize_graph(poses0, graph: GraphData, cfg: SolveConfig = SolveConfig()) -> SolveResult:
    """LM optimization; the gauge is fixed by the anchor prior or, with
    cfg.fix_first, by freezing pose 0."""
    return lm_graph(poses0, lambda p: build_normal_equations(p, graph),
                    lambda p: graph_chi2(p, graph), cfg)


def lm_graph(poses0, normal_equations, chi2_of, cfg: SolveConfig) -> SolveResult:
    """`optimize_graph`'s LM loop over callables: normal_equations(poses) ->
    (Hb (K, K, 6, 6), bb (K, 6), chi2) and chi2_of(poses) -> chi2. The
    factor-sharded solve (`parallel/sharded.py`) hands it all-reduced ones."""
    K = poses0.shape[0]
    dtype, device = poses0.dtype, poses0.device
    free = torch.ones((K, 6), dtype=dtype, device=device)
    if cfg.fix_first:
        free[0] = 0.0
    free_flat = free.reshape(-1)

    poses = poses0
    lam = torch.tensor(cfg.lm_lambda_init, dtype=dtype, device=device)
    chi2_state = torch.tensor(float("inf"), dtype=dtype, device=device)
    H = torch.eye(K * 6, dtype=dtype, device=device)
    it, done = 0, False
    while it < cfg.max_iterations and not done:
        Hb, bb, chi2 = normal_equations(poses)
        # gauge fixing: zero rows/cols of fixed vars, unit diagonal
        H = _flatten_H(Hb) * free_flat[:, None] * free_flat[None, :] + torch.diag(1.0 - free_flat)
        b = bb.reshape(-1) * free_flat
        delta = _solve(H, b, lam, cfg) * free_flat
        poses_new = retract(poses, delta.reshape(K, 6))
        chi2_new = chi2_of(poses_new)
        accept = chi2_new < chi2
        poses = torch.where(accept, poses_new, poses)
        lam = torch.where(accept, lam / cfg.lm_lambda_factor, lam * cfg.lm_lambda_factor)
        rel = torch.abs(chi2 - chi2_new) / torch.clamp(chi2, min=1e-30)
        chi2_state = torch.where(accept, chi2_new, chi2)
        done = bool(accept & (rel < cfg.rel_tol))
        it += 1
    return SolveResult(
        poses=poses, chi2=chi2_state, iterations=torch.tensor(it), lm_lambda=lam, H=H
    )


# ---------------------------------------------------------------------------
# Joint pose + plane-vertex optimization (g2o VertexPlane graphs)
# ---------------------------------------------------------------------------


def _jac_terms(local, n_delta, *args):
    """vmap(jacfwd) of `local(d, *args)` at d = 0 over the factor axis:
    (residuals (F, r), Jacobians (F, r, n_delta))."""

    def with_aux(d, *a):
        r = local(d, *a)
        return r, r

    d0 = args[0].new_zeros((args[0].shape[0], n_delta))
    J, r = vmap(jacfwd(with_aux, has_aux=True))(d0, *args)
    return r, J


def _whitened(f, r, *Js):
    """`_weighted` plus each Jacobian whitened by sqrt_info."""
    rw, w, c2 = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    return (rw, w, c2) + tuple(torch.einsum("fij,fjk->fik", f.sqrt_info, J) for J in Js)


def _plane_factor_terms(poses, planes, pg: PlaneGraphData):
    """Whitened residuals and Jacobians of every plane-vertex family, shared
    by the dense and the block-sparse assembly: a dict family -> (rw, w,
    chi2, J...)."""
    out = {}
    f = pg.plane_priors  # unary on a plane; residual at the plane as it is
    _, J = _jac_terms(lambda d, p, nm, dm: PlanePriorFactors.residual(retract_plane(p, d), nm, dm),
                      3, planes[f.i], f.n_meas, f.d_meas)
    out["plane_priors"] = _whitened(f, PlanePriorFactors.residual(planes[f.i], f.n_meas, f.d_meas),
                                    J)
    f = pg.plane_plane
    r, J = _jac_terms(
        lambda d, pi, pj, kind, meas: PlanePlaneFactors.residual(
            retract_plane(pi, d[:3]), retract_plane(pj, d[3:]), kind, meas),
        6, planes[f.i], planes[f.j], f.kind, f.meas)
    out["plane_plane"] = _whitened(f, r, J[..., :3], J[..., 3:])
    f = pg.se3_plane
    r, J = _jac_terms(
        lambda d, T, p, meas: SE3PlaneFactors.residual(retract(T, d[:6]),
                                                       retract_plane(p, d[6:]), meas),
        9, poses[f.i], planes[f.j], f.plane_meas)
    out["se3_plane"] = _whitened(f, r, J[..., :6], J[..., 6:])
    f = pg.z_between
    r, Ji, Jj = _binary_terms(poses, f, ZBetweenFactors.residual, (f.z_meas,))
    out["z_between"] = _whitened(f, r, Ji, Jj)
    f = pg.utm_align
    r, Ji = _unary_terms(poses, f, UTMAlignFactors.residual, (f.p_utm, f.p_world))
    out["utm_align"] = _whitened(f, r, Ji)
    return out


def _JtJ(Ja, Jb, w):
    return torch.einsum("fji,fjk,f->fik", Ja, Jb, w)


def _Jtr(Ja, rw, w):
    return torch.einsum("fji,fj,f->fi", Ja, rw, w)


def _plane_terms(poses, planes, pg: PlaneGraphData):
    """Block normal-equation contributions of the plane-vertex families:
    pose-pose (K,K,6,6), pose-plane (K,M,6,3), plane-plane (M,M,3,3),
    gradients (K,6) / (M,3), and chi2."""
    K, M = poses.shape[0], planes.shape[0]
    z = dict(dtype=poses.dtype, device=poses.device)
    Hxx, Hxp = torch.zeros((K, K, 6, 6), **z), torch.zeros((K, M, 6, 3), **z)
    Hpp, bx, bp = torch.zeros((M, M, 3, 3), **z), torch.zeros((K, 6), **z), torch.zeros((M, 3), **z)
    t = _plane_factor_terms(poses, planes, pg)

    f, (rw, w, c_pp, Jw) = pg.plane_priors, t["plane_priors"]
    Hpp = Hpp.index_put((f.i, f.i), _JtJ(Jw, Jw, w), accumulate=True)
    bp = bp.index_put((f.i,), _Jtr(Jw, rw, w), accumulate=True)

    f, (rw, w, c_p2, Jiw, Jjw) = pg.plane_plane, t["plane_plane"]
    for a, Ja, c, Jc in ((f.i, Jiw, f.i, Jiw), (f.j, Jjw, f.j, Jjw),
                         (f.i, Jiw, f.j, Jjw), (f.j, Jjw, f.i, Jiw)):
        Hpp = Hpp.index_put((a, c), _JtJ(Ja, Jc, w), accumulate=True)
    bp = bp.index_put((f.i,), _Jtr(Jiw, rw, w), accumulate=True)
    bp = bp.index_put((f.j,), _Jtr(Jjw, rw, w), accumulate=True)

    f, (rw, w, c_sp, Jxw, Jpw) = pg.se3_plane, t["se3_plane"]
    Hxx = Hxx.index_put((f.i, f.i), _JtJ(Jxw, Jxw, w), accumulate=True)
    Hpp = Hpp.index_put((f.j, f.j), _JtJ(Jpw, Jpw, w), accumulate=True)
    Hxp = Hxp.index_put((f.i, f.j), _JtJ(Jxw, Jpw, w), accumulate=True)
    bx = bx.index_put((f.i,), _Jtr(Jxw, rw, w), accumulate=True)
    bp = bp.index_put((f.j,), _Jtr(Jpw, rw, w), accumulate=True)

    f, (rw, w, c_z, Jiw, Jjw) = pg.z_between, t["z_between"]
    for a, Ja, c, Jc in ((f.i, Jiw, f.i, Jiw), (f.j, Jjw, f.j, Jjw),
                         (f.i, Jiw, f.j, Jjw), (f.j, Jjw, f.i, Jiw)):
        Hxx = Hxx.index_put((a, c), _JtJ(Ja, Jc, w), accumulate=True)
    bx = bx.index_put((f.i,), _Jtr(Jiw, rw, w), accumulate=True)
    bx = bx.index_put((f.j,), _Jtr(Jjw, rw, w), accumulate=True)

    f, (rw, w, c_u, Jiw) = pg.utm_align, t["utm_align"]
    Hxx = Hxx.index_put((f.i, f.i), _JtJ(Jiw, Jiw, w), accumulate=True)
    bx = bx.index_put((f.i,), _Jtr(Jiw, rw, w), accumulate=True)
    return Hxx, Hxp, Hpp, bx, bp, c_pp + c_p2 + c_sp + c_z + c_u


def plane_graph_chi2(poses, planes, pg: PlaneGraphData):
    """Robustified chi2 of the plane-vertex families only."""
    f = pg.plane_priors
    c2 = _weighted(PlanePriorFactors.residual(planes[f.i], f.n_meas, f.d_meas),
                   f.sqrt_info, f.robust_delta, f.mask)[2]
    f = pg.plane_plane
    c2 = c2 + _weighted(PlanePlaneFactors.residual(planes[f.i], planes[f.j], f.kind, f.meas),
                        f.sqrt_info, f.robust_delta, f.mask)[2]
    f = pg.se3_plane
    c2 = c2 + _weighted(SE3PlaneFactors.residual(poses[f.i], planes[f.j], f.plane_meas),
                        f.sqrt_info, f.robust_delta, f.mask)[2]
    f = pg.z_between
    c2 = c2 + _weighted(ZBetweenFactors.residual(poses[f.i], poses[f.j], f.z_meas),
                        f.sqrt_info, f.robust_delta, f.mask)[2]
    f = pg.utm_align
    c2 = c2 + _weighted(UTMAlignFactors.residual(poses[f.i], f.p_utm, f.p_world),
                        f.sqrt_info, f.robust_delta, f.mask)[2]
    return c2


class PlaneSolveResult(NamedTuple):
    poses: torch.Tensor  # (K, 4, 4)
    planes: torch.Tensor  # (M, 4)
    chi2: torch.Tensor
    iterations: torch.Tensor  # () int, on the CPU
    lm_lambda: torch.Tensor
    H: torch.Tensor  # (6K+3M, 6K+3M)


@_f32_matmuls
def optimize_graph_with_planes(poses0, planes0, graph: GraphData, plane_graph: PlaneGraphData,
                               cfg: SolveConfig = SolveConfig()) -> PlaneSolveResult:
    """Joint LM over SE3 poses and plane vertices (`VertexSE3` +
    `VertexPlane`, `graph_slam.cpp:88-123`) in one dense solve over the
    state [6K pose coordinates | 3M plane coordinates]."""
    K, M = poses0.shape[0], planes0.shape[0]
    dtype, device = poses0.dtype, poses0.device
    D = 6 * K + 3 * M
    free = torch.ones((D,), dtype=dtype, device=device)
    if cfg.fix_first:
        free[:6] = 0.0

    def lin(poses, planes):
        Hb, bb, chi2 = build_normal_equations(poses, graph)
        Hxx, Hxp, Hpp, bx, bp, c2p = _plane_terms(poses, planes, plane_graph)
        Hpose = _flatten_H(Hb + Hxx)
        Hplane = Hpp.permute(0, 2, 1, 3).reshape(3 * M, 3 * M)
        Hcross = Hxp.permute(0, 2, 1, 3).reshape(6 * K, 3 * M)
        H = torch.cat([torch.cat([Hpose, Hcross], 1), torch.cat([Hcross.T, Hplane], 1)], 0)
        b = torch.cat([(bb + bx).reshape(-1), bp.reshape(-1)])
        H = H * free[:, None] * free[None, :] + torch.diag(1.0 - free)
        return H, b * free, chi2 + c2p

    def full_chi2(poses, planes):
        return graph_chi2(poses, graph) + plane_graph_chi2(poses, planes, plane_graph)

    poses, planes = poses0, planes0
    lam = torch.tensor(cfg.lm_lambda_init, dtype=dtype, device=device)
    chi2_state = torch.tensor(float("inf"), dtype=dtype, device=device)
    H = torch.eye(D, dtype=dtype, device=device)
    it, done = 0, False
    while it < cfg.max_iterations and not done:
        H, b, chi2 = lin(poses, planes)
        delta = _solve(H, b, lam, cfg) * free
        poses_new = retract(poses, delta[: 6 * K].reshape(K, 6))
        planes_new = retract_plane(planes, delta[6 * K:].reshape(M, 3))
        chi2_new = full_chi2(poses_new, planes_new)
        accept = chi2_new < chi2
        poses = torch.where(accept, poses_new, poses)
        planes = torch.where(accept, planes_new, planes)
        lam = torch.where(accept, lam / cfg.lm_lambda_factor, lam * cfg.lm_lambda_factor)
        rel = torch.abs(chi2 - chi2_new) / torch.clamp(chi2, min=1e-30)
        chi2_state = torch.where(accept, chi2_new, chi2)
        done = bool(accept & (rel < cfg.rel_tol))
        it += 1
    return PlaneSolveResult(poses=poses, planes=planes, chi2=chi2_state,
                            iterations=torch.tensor(it), lm_lambda=lam, H=H)
