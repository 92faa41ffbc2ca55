"""Dense Levenberg-Marquardt pose-graph solver.

Port of `build_normal_equations`, `graph_chi2`, `_solve_dense` and
`optimize_graph` from `gorio_tpu/graph/solver.py` (`GraphSLAM::optimize`,
`graph_slam.cpp:353-382`): factor residuals are evaluated batched per
family, their Jacobians with `torch.func.jacfwd` under `torch.func.vmap`,
scatter-added into block normal equations, and the damped system is solved
by a dense Cholesky. The JAX `lax.while_loop` becomes a Python loop with
the same bound and the same accept/reject rule; the host reads the stop
flag once per iteration.

The block-sparse direct solver is `graph/sparse.py` (the SLAM back end
switches to it above 128 padded poses); the CG option is not ported yet
(ROADMAP A7-sparse-cg).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from .factors import (
    BetweenFactors,
    GraphData,
    GroundPlaneFactors,
    PointPriorFactors,
    PriorFactors,
    QuatPriorFactors,
    VecPriorFactors,
    huber_weight,
    retract,
)


class SolveConfig(NamedTuple):
    max_iterations: int = 50
    lm_lambda_init: float = 1e-6
    lm_lambda_factor: float = 10.0
    rel_tol: float = 1e-9
    # "dense" | "direct" (the sparse path's exact solve; a dense solve here) |
    # "cg" (ROADMAP A7-sparse-cg)
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
    """Whiten with sqrt_info and the robust kernel; masked factors zeroed."""
    rw = torch.einsum("fij,fj->fi", sqrt_info, r)
    chi2 = torch.sum(rw * rw, dim=-1)
    w = huber_weight(chi2, robust_delta) * mask.to(r.dtype)
    return rw, w, torch.sum(w * chi2)


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
    """Total robustified chi2 (no Jacobians)."""
    f = graph.between
    r = BetweenFactors.residual(poses[f.i], poses[f.j], f.T_meas)
    c2 = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)[2]
    for fac, res_fn, meas in _unary_families(graph):
        r = res_fn(poses[fac.i], *meas)
        c2 = c2 + _weighted(r, fac.sqrt_info, fac.robust_delta, fac.mask)[2]
    return c2


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


def optimize_graph(poses0, graph: GraphData, cfg: SolveConfig = SolveConfig()) -> SolveResult:
    """LM optimization; the gauge is fixed by the anchor prior or, with
    cfg.fix_first, by freezing pose 0."""
    if cfg.solver == "cg":
        raise NotImplementedError(
            "solver='cg' (Jacobi-preconditioned CG) is not ported yet (ROADMAP A7-sparse-cg)"
        )
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
        Hb, bb, chi2 = build_normal_equations(poses, graph)
        # gauge fixing: zero rows/cols of fixed vars, unit diagonal
        H = _flatten_H(Hb) * free_flat[:, None] * free_flat[None, :] + torch.diag(1.0 - free_flat)
        b = bb.reshape(-1) * free_flat
        delta = _solve_dense(H, b, lam) * free_flat
        poses_new = retract(poses, delta.reshape(K, 6))
        chi2_new = graph_chi2(poses_new, graph)
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
