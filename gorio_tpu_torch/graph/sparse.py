"""Block-sparse pose-graph solver: block-tridiagonal (chain) factorization
plus an exact Woodbury correction for the loop-closure edges
(`solver="direct"`), or conjugate gradients preconditioned by that
tridiagonal (`solver="cg"`).

Port of `gorio_tpu/graph/sparse.py` (g2o's sparse backend,
`graph_slam.cpp:353-382`, solver `lm_var_cholmod`). The normal equations
live as block arrays, never as a (6K)^2 matrix:

    Hdiag (K,6,6)   one 6x6 block per pose (all unary + binary self terms)
    Hoff  (E,6,6)   one 6x6 block per binary factor e: H[i_e, j_e]

A SLAM graph is a chain of odometry / preintegration factors plus a few loop
closures and unary priors, so H = T + G^T G: T block tridiagonal, G the
whitened Jacobians of the L loop edges. `solve_tridiag_woodbury` factorizes
T once, solves it for [b | G^T] in one multi-RHS pass and corrects with a
(6L)^2 Cholesky: an exact direct solve.

The JAX package runs the tridiagonal recurrences as `lax.scan`s. Here every
step is a handful of batched 6x6 (or 12x12) tensor ops, so sequential depth
is what costs host launches: for K a multiple of 32 and K >= 64 (every
padded pose count from 64 on) the SPIKE partition solves the S = K / 32
groups' interiors as one batch (32 steps each way) and couples them through
an S-step reduced system, ~2 * 32 + S steps instead of ~2K.

Matrix products keep full float32 on the card (`allow_tf32 = False`, the
JAX package's `_f32_matmuls`): TF32 would floor the LM's chi2 the way the
TPU's bf16 passes did.

The joint pose + plane solver `optimize_graph_with_planes_sparse` carries
the 3M plane coordinates as a dense tail: the pose block is solved by the
same tridiagonal + Woodbury pass with the pose-plane coupling columns as
extra right-hand sides, then a 3M x 3M Schur complement gives the planes.

With `solver="cg"` both solvers run the JAX package's preconditioned CG
(`solver.pcg`): the matvec is A x plus the off-diagonal blocks' products,
summed per row by one sorted segment reduction (no float atomics, so the
card repeats to the bit); the preconditioner is the block tridiagonal,
factorized once per LM iteration and applied once per CG step
(`spike_factor` / `spike_apply`, or the sequential Thomas factors where K
is not a multiple of 32 of at least 64). The joint solver's plane tail is
preconditioned by the inverse of its damped dense block.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import torch

from ..core.pointcloud import segment_sum
from .factors import BetweenFactors, GraphData, PlaneGraphData, retract, retract_plane
from .solver import (
    SolveConfig,
    _binary_terms,
    _f32_matmuls,
    _JtJ,
    _Jtr,
    _plane_factor_terms,
    _unary_families,
    _unary_terms,
    _weighted,
    graph_chi2,
    pcg,
    plane_graph_chi2,
)


class SparseSolveResult(NamedTuple):
    poses: torch.Tensor  # (K, 4, 4)
    chi2: torch.Tensor
    iterations: torch.Tensor  # () int, on the CPU
    lm_lambda: torch.Tensor
    H_diag: torch.Tensor  # (K, 6, 6) diagonal blocks of H at the last linearization


class SparsePlaneSolveResult(NamedTuple):
    poses: torch.Tensor
    planes: torch.Tensor  # (M, 4)
    chi2: torch.Tensor
    iterations: torch.Tensor
    lm_lambda: torch.Tensor
    H_diag: torch.Tensor


def _t(M):
    return M.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Block normal equations
# ---------------------------------------------------------------------------


def build_block_normal_equations(poses, graph: GraphData):
    """(Hdiag (K,6,6), Hoff (E,6,6), b (K,6), chi2): the block form of
    `solver.build_normal_equations` without the (K,K,6,6) tensor."""
    K = poses.shape[0]
    Hdiag = torch.zeros((K, 6, 6), dtype=poses.dtype, device=poses.device)
    b = torch.zeros((K, 6), dtype=poses.dtype, device=poses.device)

    f = graph.between
    r, Ji, Jj = _binary_terms(poses, f, BetweenFactors.residual, (f.T_meas,))
    rw, w, chi2 = _weighted(r, f.sqrt_info, f.robust_delta, f.mask)
    Jiw = torch.einsum("fij,fjk->fik", f.sqrt_info, Ji)
    Jjw = torch.einsum("fij,fjk->fik", f.sqrt_info, Jj)
    Hdiag = Hdiag.index_put((f.i,), torch.einsum("fji,fjk,f->fik", Jiw, Jiw, w), accumulate=True)
    Hdiag = Hdiag.index_put((f.j,), torch.einsum("fji,fjk,f->fik", Jjw, Jjw, w), accumulate=True)
    Hoff = torch.einsum("fji,fjk,f->fik", Jiw, Jjw, w)  # H[i_e, j_e]
    b = b.index_put((f.i,), torch.einsum("fji,fj,f->fi", Jiw, rw, w), accumulate=True)
    b = b.index_put((f.j,), torch.einsum("fji,fj,f->fi", Jjw, rw, w), accumulate=True)

    for fac, res_fn, meas in _unary_families(graph):
        r, Ji = _unary_terms(poses, fac, res_fn, meas)
        rw, w, c2 = _weighted(r, fac.sqrt_info, fac.robust_delta, fac.mask)
        Jiw = torch.einsum("fij,fjk->fik", fac.sqrt_info, Ji)
        Hdiag = Hdiag.index_put((fac.i,), torch.einsum("fji,fjk,f->fik", Jiw, Jiw, w),
                                accumulate=True)
        b = b.index_put((fac.i,), torch.einsum("fji,fj,f->fi", Jiw, rw, w), accumulate=True)
        chi2 = chi2 + c2
    return Hdiag, Hoff, b, chi2


# ---------------------------------------------------------------------------
# Block-tridiagonal factorization (block-Thomas)
# ---------------------------------------------------------------------------


def _chain_upper_blocks(Hoff, fi, fj, K, dtype):
    """(K-1, 6, 6) consecutive blocks C[k] = H[k, k+1], gathered from the
    per-factor off-diagonal blocks (non-chain factors contribute nothing)."""
    C = torch.zeros((K, 6, 6), dtype=dtype, device=Hoff.device)
    zero = torch.zeros_like(Hoff)
    fwd = (fj == fi + 1)[:, None, None]
    C = C.index_put((fi,), torch.where(fwd, Hoff, zero), accumulate=True)
    rev = (fi == fj + 1)[:, None, None]  # stored as (k+1, k): H[k, k+1] = Hoff^T
    C = C.index_put((fj,), torch.where(rev, _t(Hoff), zero), accumulate=True)
    return C[: K - 1]


def _inv3c(M):
    """Closed-form batched 3x3 inverse (adjugate / det). Row k of the
    cofactor matrix is the cross product of rows k+1 and k+2 (cyclic), the
    same products and differences as the JAX package's expanded form, in a
    handful of tensor ops instead of dozens: the sparse solve launches this
    once per block per sequential step."""
    cof = torch.linalg.cross(torch.roll(M, -1, dims=-2), torch.roll(M, 1, dims=-2), dim=-1)
    det = torch.sum(M[..., 0, :] * cof[..., 0, :], dim=-1)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))
    return _t(cof) * inv_det[..., None, None]


def _eye_like(n, M):
    return torch.eye(n, dtype=M.dtype, device=M.device).expand(M.shape)


def inv6_spd(M):
    """Closed-form batched inverse of an SPD 6x6 through the 3x3-block Schur
    complement, then one Newton-Schulz step X (2I - M X), which squares the
    residual of the adjugate-based inverse (mixed information scales:
    anchor priors at 1e6 against edges at 1e1)."""
    P, Q, S = M[..., :3, :3], M[..., :3, 3:], M[..., 3:, 3:]
    Pinv = _inv3c(P)
    PinvQ = Pinv @ Q
    Scinv = _inv3c(S - _t(Q) @ PinvQ)
    TR = -PinvQ @ Scinv
    TL = Pinv - TR @ _t(PinvQ)
    X = torch.cat([torch.cat([TL, TR], -1), torch.cat([_t(TR), Scinv], -1)], -2)
    return X @ (2.0 * _eye_like(6, X) - M @ X)


def block_tridiag_factor(A, C):
    """Block-Thomas factorization of the SPD block tridiagonal (A_k, C_k)
    along axis -3 (any leading batch axes): returns Dinv (..., K, 6, 6) with
    D_0 = A_0, D_k = A_k - C_{k-1}^T D_{k-1}^{-1} C_{k-1}."""
    Dinv = [inv6_spd(A[..., 0, :, :])]
    for k in range(1, A.shape[-3]):
        Ck = C[..., k - 1, :, :]
        Dinv.append(inv6_spd(A[..., k, :, :] - _t(Ck) @ Dinv[-1] @ Ck))
    return torch.stack(Dinv, dim=-3)


def block_tridiag_solve(Dinv, C, b):
    """Solve the block-tridiagonal system given its block-Thomas factors.
    b (..., K, 6, R): the extra right-hand-side columns ride along."""
    K = b.shape[-3]
    z = [b[..., 0, :, :]]
    for k in range(1, K):
        z.append(b[..., k, :, :] - _t(C[..., k - 1, :, :]) @ (Dinv[..., k - 1, :, :] @ z[-1]))
    x = [Dinv[..., K - 1, :, :] @ z[K - 1]]
    for k in range(K - 2, -1, -1):
        x.append(Dinv[..., k, :, :] @ (z[k] - C[..., k, :, :] @ x[-1]))
    return torch.stack(x[::-1], dim=-3)


# ---------------------------------------------------------------------------
# SPIKE partitioned block-tridiagonal solve
# ---------------------------------------------------------------------------


def _schur_inverse(M, half, inv_half):
    """General inverse of (..., 2h, 2h) through the h x h block Schur
    complement (no pivoting)."""
    P, Q = M[..., :half, :half], M[..., :half, half:]
    Rb, S = M[..., half:, :half], M[..., half:, half:]
    Pinv = inv_half(P)
    PinvQ = Pinv @ Q
    Scinv = inv_half(S - Rb @ PinvQ)
    TR = -PinvQ @ Scinv
    BL = -Scinv @ (Rb @ Pinv)
    TL = Pinv - PinvQ @ BL
    return torch.cat([torch.cat([TL, TR], -1), torch.cat([BL, Scinv], -1)], -2)


def _inv6_gen(M):
    """Closed-form general 6x6 inverse (3x3-block Schur, no pivoting: the
    SPIKE interface blocks are near identity)."""
    return _schur_inverse(M, 3, _inv3c)


def _inv12_gen(M):
    """Closed-form general 12x12 inverse via 6x6-block Schur on `_inv6_gen`,
    plus one Newton-Schulz step."""
    X = _schur_inverse(M, 6, _inv6_gen)
    return X @ (2.0 * _eye_like(12, X) - M @ X)


def _general_block_tridiag_factor(M, L, U):
    """LU-Thomas factors of the non-symmetric block tridiagonal with block
    rows M_s u_s + L_s u_{s-1} + U_s u_{s+1}; M/L/U (S,d,d). Returns
    (Dinv, G), lists of S blocks."""
    Dinv = [_inv12_gen(M[0])]
    G = [Dinv[0] @ U[0]]
    for s in range(1, M.shape[0]):
        Dinv.append(_inv12_gen(M[s] - L[s] @ G[-1]))
        G.append(Dinv[-1] @ U[s])
    return Dinv, G


def _general_block_tridiag_apply(factors, L, h):
    """Solve with `_general_block_tridiag_factor`'s factors; h (S,d,R)."""
    Dinv, G = factors
    y = [Dinv[0] @ h[0]]
    for s in range(1, len(Dinv)):
        y.append(Dinv[s] @ (h[s] - L[s] @ y[-1]))
    x = [y[-1]]
    for s in range(len(Dinv) - 2, -1, -1):
        x.append(y[s] - G[s] @ x[-1])
    return torch.stack(x[::-1])


def _general_block_tridiag_solve(M, L, U, h):
    """Non-symmetric block-tridiagonal solve (LU-Thomas) of the block rows
    M_s u_s + L_s u_{s-1} + U_s u_{s+1} = h_s; M/L/U (S,d,d), h (S,d,R)."""
    return _general_block_tridiag_apply(_general_block_tridiag_factor(M, L, U), L, h)


def _spike_groups(A, C, m):
    """The SPIKE partition of (A (K,6,6), C (K-1,6,6)) into S = K // m
    groups: (S, the groups' interior Thomas factors Dinv_g (S,m,6,6), their
    chain blocks Cg_int (S,m-1,6,6), the coupling blocks Cint (S-1,6,6)
    between group s's last row and group s+1's first)."""
    K = A.shape[0]
    S = K // m
    Cg = torch.cat([C, C.new_zeros(1, 6, 6)]).reshape(S, m, 6, 6)
    Cg_int = Cg[:, : m - 1]
    return S, block_tridiag_factor(A.reshape(S, m, 6, 6), Cg_int), Cg_int, Cg[: S - 1, m - 1]


def _spike_rhs(b, Cint, S, m):
    """Per-group right-hand sides [b | spike V (6 cols) | spike W (6 cols)]:
    V_s = D_s^-1 e_{m-1} Cint[s], W_s = D_s^-1 e_0 Cint[s-1]^T."""
    R = b.shape[-1]
    rhs = b.new_zeros(S, m, 6, R + 12)
    rhs[..., :R] = b.reshape(S, m, 6, R)
    rhs[: S - 1, m - 1, :, R: R + 6] = Cint
    rhs[1:, 0, :, R + 6:] = _t(Cint)
    return rhs


def _reduced_blocks(V, W, m):
    """The reduced system over u_s = (x_{s,0}, x_{s,m-1}):
    u_s + L_s u_{s-1} + U_s u_{s+1} = h_s. Returns (Mred, Lred, Ured)."""
    S = V.shape[0]
    z2 = V.new_zeros(S, 6, 6)
    Lred = torch.cat([torch.cat([z2, W[:, 0]], -1), torch.cat([z2, W[:, m - 1]], -1)], -2)
    Ured = torch.cat([torch.cat([V[:, 0], z2], -1), torch.cat([V[:, m - 1], z2], -1)], -2)
    Mred = torch.eye(12, dtype=V.dtype, device=V.device).expand(S, 12, 12)
    return Mred, Lred, Ured


def _spike_back(g, V, W, u):
    """Back-substitution, all groups at once:
    x_s = g_s - V_s y_{s+1} - W_s z_{s-1}, u_s = (y_s, z_s)."""
    S, m, _, R = g.shape
    y, z = u[:, :6], u[:, 6:]  # x_{s,0}, x_{s,m-1}
    y_next = torch.cat([y[1:], y.new_zeros(1, 6, R)])
    z_prev = torch.cat([z.new_zeros(1, 6, R), z[: S - 1]])
    x = g - torch.einsum("smij,sjr->smir", V, y_next) - torch.einsum("smij,sjr->smir", W, z_prev)
    return x.reshape(S * m, 6, R)


def solve_block_tridiag_spike(A, C, b, m=32):
    """Exact solve of the SPD block tridiagonal (A (K,6,6), C (K-1,6,6))
    against b (K,6,R), partitioned into S = K // m groups of m rows. Needs
    m | K and K >= 2m (callers take the sequential Thomas otherwise).

    Every group's interior is factorized and solved as one batch for its
    right-hand side and its two coupling spikes; the groups' first and last
    rows then form a reduced block-tridiagonal system of S 12-blocks,
    solved sequentially; a batched back-substitution finishes."""
    R = b.shape[-1]
    S, Dinv_g, Cg_int, Cint = _spike_groups(A, C, m)
    sol = block_tridiag_solve(Dinv_g, Cg_int, _spike_rhs(b, Cint, S, m))  # (S, m, 6, R + 12)
    g, V, W = sol[..., :R], sol[..., R: R + 6], sol[..., R + 6:]
    Mred, Lred, Ured = _reduced_blocks(V, W, m)
    u = _general_block_tridiag_solve(Mred, Lred, Ured, torch.cat([g[:, 0], g[:, m - 1]], -2))
    return _spike_back(g, V, W, u)


class SpikeFactors(NamedTuple):
    """`spike_factor`'s output: everything of the SPIKE solve that does not
    depend on the right-hand side, with the Thomas steps pre-multiplied so
    that each sequential step of `spike_apply` is one batched product."""

    E: torch.Tensor  # (S, m-1, 6, 6) C_{k-1}^T Dinv_{k-1}: forward steps of the groups
    F: torch.Tensor  # (S, m-1, 6, 6) Dinv_k C_k: backward steps of the groups
    Dinv_g: torch.Tensor  # (S, m, 6, 6)
    V: torch.Tensor  # (S, m, 6, 6) the spikes
    W: torch.Tensor
    DL: torch.Tensor  # (S, 12, 12) Dred_s^-1 L_s of the reduced system
    Dred_inv: torch.Tensor  # (S, 12, 12)
    G: torch.Tensor  # (S, 12, 12) Dred_s^-1 U_s


def spike_factor(A, C, m=32) -> SpikeFactors:
    """Factorize the block tridiagonal (A, C) for repeated SPIKE solves
    (`spike_apply`): the groups' interior Thomas factors, the spikes, and
    the reduced system's LU-Thomas factors. Same conditions on K as
    `solve_block_tridiag_spike`."""
    S, Dinv_g, Cg_int, Cint = _spike_groups(A, C, m)
    sol = block_tridiag_solve(Dinv_g, Cg_int, _spike_rhs(A.new_zeros(S * m, 6, 0), Cint, S, m))
    V, W = sol[..., :6], sol[..., 6:]
    _, Lred, Ured = _reduced_blocks(V, W, m)
    Dred_inv, G = (torch.stack(t) for t in _general_block_tridiag_factor(
        torch.eye(12, dtype=A.dtype, device=A.device).expand(S, 12, 12), Lred, Ured))
    return SpikeFactors(E=_t(Cg_int) @ Dinv_g[:, :-1], F=Dinv_g[:, :-1] @ Cg_int,
                        Dinv_g=Dinv_g, V=V, W=W, DL=Dred_inv @ Lred, Dred_inv=Dred_inv, G=G)


def spike_apply(f: SpikeFactors, b):
    """Solve the factorized block tridiagonal against b (K, 6, R): the same
    solution as `solve_block_tridiag_spike` up to rounding, in about
    2 (m + S) batched products."""
    S, m = f.Dinv_g.shape[:2]
    bg = b.reshape(S, m, 6, -1)
    z = [bg[:, 0]]
    for k in range(1, m):  # forward: z_k = b_k - C_{k-1}^T Dinv_{k-1} z_{k-1}
        z.append(torch.baddbmm(bg[:, k], f.E[:, k - 1], z[-1], alpha=-1.0))
    w = f.Dinv_g @ torch.stack(z, 1)
    x = [w[:, m - 1]]
    for k in range(m - 2, -1, -1):  # backward: x_k = Dinv_k z_k - Dinv_k C_k x_{k+1}
        x.append(torch.baddbmm(w[:, k], f.F[:, k], x[-1], alpha=-1.0))
    g = torch.stack(x[::-1], 1)
    h = f.Dred_inv @ torch.cat([g[:, 0], g[:, m - 1]], -2)
    y = [h[0]]
    for s in range(1, S):
        y.append(torch.addmm(h[s], f.DL[s], y[-1], alpha=-1.0))
    u = [y[-1]]
    for s in range(S - 2, -1, -1):
        u.append(torch.addmm(y[s], f.G[s], u[-1], alpha=-1.0))
    return _spike_back(g, f.V, f.W, torch.stack(u[::-1]))


# ---------------------------------------------------------------------------
# Exact direct solve: block tridiagonal + Woodbury loop-closure correction
# ---------------------------------------------------------------------------


def _loop_slots(between, loop_capacity):
    """`jnp.nonzero(is_loop, size=loop_capacity, fill_value=0)` without a
    host sync: the indices of the first `loop_capacity` non-adjacent
    ("loop") between edges in order, padded with 0; later loops are
    dropped. Returns (sel (Lcap,) int64, lmask (Lcap,) = is_loop[sel])."""
    fi, fj = between.i, between.j
    is_loop = between.mask & (fj != fi + 1) & (fi != fj + 1)
    pos = torch.cumsum(is_loop.to(torch.int64), 0) - 1
    slot = torch.where(is_loop & (pos < loop_capacity), pos, torch.full_like(pos, loop_capacity))
    sel = torch.zeros(loop_capacity + 1, dtype=torch.int64, device=fi.device)
    sel = sel.scatter(0, slot, torch.arange(fi.shape[0], device=fi.device))[:loop_capacity]
    return sel, is_loop[sel]


def solve_tridiag_woodbury(A, C, poses, between, b, loop_capacity):
    """Exact solve of H x = b, H = the block tridiagonal (A, C) + the loop
    between edges. Each loop edge enters in PSD form g_e^T g_e with
    g_e = sqrt(w_e) [S_e J_i | S_e J_j] (6 rows), so H = T' + G^T G with T'
    the tridiagonal minus the loop edges' diagonal blocks, and Woodbury
    needs the SPD capacitance I + G T'^-1 G^T: a (6L)^2 Cholesky.

    A (K,6,6) damped diagonal blocks (loop-edge diagonal terms included;
    they are subtracted here), C (K-1,6,6) chain blocks, `poses`/`between`
    the linearization state, b (K,6) or (K,6,Rb). `loop_capacity` bounds
    the loop edges taken, in order; later ones are left out of the
    correction, as in the JAX package."""
    squeeze = b.dim() == 2
    if squeeze:
        b = b[..., None]
    Rb, K = b.shape[-1], b.shape[0]
    Lcap = loop_capacity
    sel, lmask = _loop_slots(between, Lcap)
    li, lj = between.i[sel], between.j[sel]

    # the selected edges' whitened Jacobians, recomputed (O(Lcap))
    r, Ji, Jj = _binary_terms(poses, SimpleNamespace(i=li, j=lj), BetweenFactors.residual,
                              (between.T_meas[sel],))
    sq = between.sqrt_info[sel]
    _, w, _ = _weighted(r, sq, between.robust_delta[sel], lmask)
    sw = torch.sqrt(w)[:, None, None]
    Giw = sw * torch.einsum("eij,ejk->eik", sq, Ji)  # (L, 6, 6): g_e's columns at li
    Gjw = sw * torch.einsum("eij,ejk->eik", sq, Jj)

    # T' = the tridiagonal minus the loop edges' diagonal contributions
    A = A.index_put((li,), -torch.einsum("eji,ejk->eik", Giw, Giw), accumulate=True)
    A = A.index_put((lj,), -torch.einsum("eji,ejk->eik", Gjw, Gjw), accumulate=True)

    R = 6 * Lcap
    # right-hand side [b | G^T]: G^T's columns live at rows li (Giw^T), lj (Gjw^T)
    rows6 = torch.arange(6, device=b.device)
    cols = Rb + 6 * torch.arange(Lcap, device=b.device)[:, None, None] + rows6[None, None, :]
    rhs = b.new_zeros(K, 6, Rb + R)
    rhs[..., :Rb] = b
    rhs = rhs.index_put((li[:, None, None], rows6[None, :, None], cols), _t(Giw), accumulate=True)
    rhs = rhs.index_put((lj[:, None, None], rows6[None, :, None], cols), _t(Gjw), accumulate=True)

    if K % 32 == 0 and K >= 64:
        sol = solve_block_tridiag_spike(A, C, rhs, m=32)
    else:
        sol = block_tridiag_solve(block_tridiag_factor(A, C), C, rhs)
    x0, Y = sol[..., :Rb], sol[..., Rb:]  # Y = T'^-1 G^T (K, 6, R)

    def G_apply(V):  # V (K, 6, n) -> G V (R, n)
        return (torch.einsum("eij,ejn->ein", Giw, V[li])
                + torch.einsum("eij,ejn->ein", Gjw, V[lj])).reshape(R, -1)

    cap = torch.eye(R, dtype=b.dtype, device=b.device) + G_apply(Y)  # SPD capacitance
    Lc, info = torch.linalg.cholesky_ex(cap)
    z = torch.cholesky_solve(G_apply(x0), Lc)
    z = torch.where(info == 0, z, torch.full_like(z, float("nan")))  # as JAX's Cholesky
    out = x0 - torch.einsum("kir,rn->kin", Y, z)
    return out[..., 0] if squeeze else out


# ---------------------------------------------------------------------------
# Preconditioned CG on the block system
# ---------------------------------------------------------------------------


def tridiag_preconditioner(A, C):
    """v (K, 6) -> T^-1 v for the block tridiagonal T = (A, C), factorized
    here once: by SPIKE where K is a multiple of 32 of at least 64, else by
    the sequential block Thomas (the JAX package's, a `lax.scan` there)."""
    K = A.shape[0]
    if K % 32 == 0 and K >= 64:
        factors = spike_factor(A, C, m=32)
        return lambda v: spike_apply(factors, v[..., None])[..., 0]
    Dinv = block_tridiag_factor(A, C)
    return lambda v: block_tridiag_solve(Dinv, C, v[..., None])[..., 0]


def _row_sum_plan(rows, n_rows):
    """A fixed scatter pattern sorted once: (order, segment bounds). The
    contributions to the rows, gathered in `order`, are summed per row by
    one segmented reduction (`segment_sum`) in a fixed order, so the card
    repeats to the bit."""
    order = torch.argsort(rows, stable=True)
    bounds = torch.searchsorted(
        rows[order], torch.arange(n_rows + 1, dtype=rows.dtype, device=rows.device))
    return order, bounds


def _mv_blocks(blocks, v):
    """(n, r, c) blocks times (n, c) vectors -> (n, r)."""
    return (blocks @ v[..., None])[..., 0]


# ---------------------------------------------------------------------------
# Pose-only solver
# ---------------------------------------------------------------------------


def _damped(Hdiag, lam):
    """Hdiag + lam * diag(max(diag Hdiag, 1)) per block."""
    d = torch.diagonal(Hdiag, dim1=-2, dim2=-1)  # (K, 6)
    return Hdiag + torch.diag_embed(lam * torch.clamp(d, min=1.0))


@_f32_matmuls
def optimize_graph_sparse(poses0, graph: GraphData, cfg: SolveConfig = SolveConfig()
                          ) -> SparseSolveResult:
    """LM over the block-sparse normal equations with the exact
    tridiagonal + Woodbury solve (`solver="direct"`) or, for any other
    solver name (as in the JAX package), CG preconditioned by the block
    tridiagonal, at most `cg_iters` steps. Semantics match `optimize_graph`
    (same factors, damping, accept rule): only the linear solve differs.
    The host reads the stop flag once per iteration."""
    K = poses0.shape[0]
    dtype, device = poses0.dtype, poses0.device
    f = graph.between
    # under fix_first an edge touching pose 0 degenerates to a diagonal term
    # at its free endpoint (already in A): keep it out of the correction
    fw = f._replace(mask=f.mask & (f.i != 0) & (f.j != 0)) if cfg.fix_first else f
    touch0 = ((f.i == 0) | (f.j == 0))[:, None, None]
    if cfg.solver != "direct":
        # CG's matvec: row i_e gets H[i_e, j_e] x_j, row j_e gets H[i_e, j_e]^T x_i
        plan = _row_sum_plan(torch.cat([f.i, f.j]), K)
        cols = torch.cat([f.j, f.i])[plan[0]]

    poses = poses0
    lam = torch.tensor(cfg.lm_lambda_init, dtype=dtype, device=device)
    chi2_state = torch.tensor(float("inf"), dtype=dtype, device=device)
    Hd = torch.eye(6, dtype=dtype, device=device).expand(K, 6, 6)
    it, done = 0, False
    while it < cfg.max_iterations and not done:
        Hdiag, Hoff, b, chi2 = build_block_normal_equations(poses, graph)
        if cfg.fix_first:
            Hdiag = Hdiag.clone()
            Hdiag[0] = torch.eye(6, dtype=dtype, device=device)
            Hoff = torch.where(touch0, torch.zeros_like(Hoff), Hoff)
            b = b.clone()
            b[0] = 0.0
        A = _damped(Hdiag, lam)
        C = _chain_upper_blocks(Hoff, f.i, f.j, K, dtype)
        if cfg.solver == "direct":
            delta = solve_tridiag_woodbury(A, C, poses, fw, -b, cfg.loop_capacity)
        else:
            blocks = torch.cat([Hoff, _t(Hoff)])[plan[0]]

            def mv(v):
                x = v[0]
                return (_mv_blocks(A, x) + segment_sum(_mv_blocks(blocks, x[cols]), plan[1]),)

            precond = tridiag_preconditioner(A, C)
            delta = pcg(mv, (-b,), lambda v: (precond(v[0]),), cfg.cg_iters)[0]
        if cfg.fix_first:
            delta = delta.clone()
            delta[0] = 0.0
        poses_new = retract(poses, delta)
        chi2_new = graph_chi2(poses_new, graph)
        accept = chi2_new < chi2
        poses = torch.where(accept, poses_new, poses)
        lam = torch.where(accept, lam / cfg.lm_lambda_factor, lam * cfg.lm_lambda_factor)
        rel = torch.abs(chi2 - chi2_new) / torch.clamp(chi2, min=1e-30)
        chi2_state = torch.where(accept, chi2_new, chi2)
        Hd = Hdiag
        done = bool(accept & (rel < cfg.rel_tol))
        it += 1
    return SparseSolveResult(poses=poses, chi2=chi2_state, iterations=torch.tensor(it),
                             lm_lambda=lam, H_diag=Hd)


# ---------------------------------------------------------------------------
# Joint pose + plane solver
# ---------------------------------------------------------------------------


def _plane_block_terms(poses, planes, pg: PlaneGraphData):
    """Block contributions of the plane-vertex families: pose diagonal
    (K,6,6), pose-pose off blocks of the z_between factors (E2,6,6), the
    dense plane block (M,M,3,3), pose-plane cross blocks per SE3-plane
    factor (F,6,3), gradients, chi2. `solver._plane_terms` without the
    (K,K,...) tensors."""
    K, M = poses.shape[0], planes.shape[0]
    z = dict(dtype=poses.dtype, device=poses.device)
    Hx, Hpp = torch.zeros((K, 6, 6), **z), torch.zeros((M, M, 3, 3), **z)
    bx, bp = torch.zeros((K, 6), **z), torch.zeros((M, 3), **z)
    t = _plane_factor_terms(poses, planes, pg)

    f, (rw, w, c_pp, Jw) = pg.plane_priors, t["plane_priors"]
    Hpp = Hpp.index_put((f.i, f.i), _JtJ(Jw, Jw, w), accumulate=True)
    bp = bp.index_put((f.i,), _Jtr(Jw, rw, w), accumulate=True)

    f, (rw, w, c_p2, Jiw, Jjw) = pg.plane_plane, t["plane_plane"]  # M is tiny: dense
    for a, Ja, c, Jc in ((f.i, Jiw, f.i, Jiw), (f.j, Jjw, f.j, Jjw),
                         (f.i, Jiw, f.j, Jjw), (f.j, Jjw, f.i, Jiw)):
        Hpp = Hpp.index_put((a, c), _JtJ(Ja, Jc, w), accumulate=True)
    bp = bp.index_put((f.i,), _Jtr(Jiw, rw, w), accumulate=True)
    bp = bp.index_put((f.j,), _Jtr(Jjw, rw, w), accumulate=True)

    f, (rw, w, c_sp, Jxw, Jpw) = pg.se3_plane, t["se3_plane"]
    Hx = Hx.index_put((f.i,), _JtJ(Jxw, Jxw, w), accumulate=True)
    Hpp = Hpp.index_put((f.j, f.j), _JtJ(Jpw, Jpw, w), accumulate=True)
    Hxp = _JtJ(Jxw, Jpw, w)  # (F, 6, 3)
    bx = bx.index_put((f.i,), _Jtr(Jxw, rw, w), accumulate=True)
    bp = bp.index_put((f.j,), _Jtr(Jpw, rw, w), accumulate=True)

    f, (rw, w, c_z, Jiw, Jjw) = pg.z_between, t["z_between"]
    Hx = Hx.index_put((f.i,), _JtJ(Jiw, Jiw, w), accumulate=True)
    Hx = Hx.index_put((f.j,), _JtJ(Jjw, Jjw, w), accumulate=True)
    Hz_off = _JtJ(Jiw, Jjw, w)  # (E2, 6, 6)
    bx = bx.index_put((f.i,), _Jtr(Jiw, rw, w), accumulate=True)
    bx = bx.index_put((f.j,), _Jtr(Jjw, rw, w), accumulate=True)

    f, (rw, w, c_u, Jiw) = pg.utm_align, t["utm_align"]
    Hx = Hx.index_put((f.i,), _JtJ(Jiw, Jiw, w), accumulate=True)
    bx = bx.index_put((f.i,), _Jtr(Jiw, rw, w), accumulate=True)
    return Hx, Hz_off, Hpp, Hxp, bx, bp, c_pp + c_p2 + c_sp + c_z + c_u


class _PlanesCGPlans(NamedTuple):
    """The fixed scatter patterns of the joint CG matvec: pose rows take the
    between and z_between off-diagonal products both ways and the
    pose-plane products; plane rows the plane-pose products."""

    pose: tuple  # (order, bounds) over the pose rows
    pose_cols: torch.Tensor  # the pose column of each 6x6 block, sorted
    plane_cols: torch.Tensor  # the plane index of each pose-plane block (F,)
    plane: tuple  # (order, bounds) over the plane rows of the F blocks
    pose_of_plane_rows: torch.Tensor  # fsp.i, sorted by plane


def _planes_cg_plans(fb, fz, fsp, K, M):
    rows = torch.cat([fb.i, fb.j, fz.i, fz.j, fsp.i])
    cols = torch.cat([fb.j, fb.i, fz.j, fz.i])
    pose = _row_sum_plan(rows, K)
    plane = _row_sum_plan(fsp.j, M)
    return _PlanesCGPlans(pose=pose, pose_cols=cols, plane_cols=fsp.j, plane=plane,
                          pose_of_plane_rows=fsp.i[plane[0]])


def _planes_cg(A, C, Hoff, Hz_off, Hxp, Hpp_d, b, bp, plans: _PlanesCGPlans, iters):
    """The JAX package's tuple CG of `optimize_graph_with_planes_sparse`
    (`sparse.py:765-791`) over (dx (K, 6), dp (M, 3))."""
    M = bp.shape[0]
    blocks = torch.cat([Hoff, _t(Hoff), Hz_off, _t(Hz_off)])
    order, bounds = plans.pose
    HxpT_s = _t(Hxp)[plans.plane[0]]
    Hpp_inv = torch.linalg.inv_ex(
        Hpp_d + 1e-12 * torch.eye(3 * M, dtype=A.dtype, device=A.device))[0]
    precond_x = tridiag_preconditioner(A, C)

    def mv(v):
        x, xp = v
        contrib = torch.cat([_mv_blocks(blocks, x[plans.pose_cols]),
                             _mv_blocks(Hxp, xp[plans.plane_cols])])
        y = _mv_blocks(A, x) + segment_sum(contrib[order], bounds)
        yp = (Hpp_d @ xp.reshape(-1)).reshape(M, 3) + segment_sum(
            _mv_blocks(HxpT_s, x[plans.pose_of_plane_rows]), plans.plane[1])
        return y, yp

    def precond(v):
        return precond_x(v[0]), (Hpp_inv @ v[1].reshape(-1)).reshape(M, 3)

    return pcg(mv, (-b, -bp), precond, iters)


@_f32_matmuls
def optimize_graph_with_planes_sparse(poses0, planes0, graph: GraphData,
                                      plane_graph: PlaneGraphData,
                                      cfg: SolveConfig = SolveConfig()) -> SparsePlaneSolveResult:
    """Joint LM over poses and plane vertices on the block-sparse system,
    `solver="direct"`: the pose block by the tridiagonal + Woodbury solve,
    whose multi-RHS pass also carries the pose-plane coupling columns, then
    a dense Schur complement over the 3M plane coordinates. Non-adjacent
    z_between edges are not folded into the correction (the pipeline never
    creates them), as in the JAX package; use `solver="cg"` for such
    graphs. Any other solver name runs CG over the tuple (poses (K, 6),
    planes (M, 3)): the pose-plane blocks exact in the matvec, the
    preconditioner the poses' block tridiagonal and the inverse of the
    damped plane block. The host reads the stop flag once per iteration."""
    K, M = poses0.shape[0], planes0.shape[0]
    dtype, device = poses0.dtype, poses0.device
    fb, fz, fsp = graph.between, plane_graph.z_between, plane_graph.se3_plane
    M3 = 3 * M
    fw = fb._replace(mask=fb.mask & (fb.i != 0) & (fb.j != 0)) if cfg.fix_first else fb
    rows6 = torch.arange(6, device=device)
    cols3 = torch.arange(3, device=device)
    colp = 3 * fsp.j[:, None, None] + cols3[None, None, :]  # (F, 1, 3) plane columns
    rowp = (3 * fsp.j)[:, None, None] + cols3[None, :, None]  # (F, 3, 1) plane rows
    plans = _planes_cg_plans(fb, fz, fsp, K, M) if cfg.solver != "direct" else None

    poses, planes = poses0, planes0
    lam = torch.tensor(cfg.lm_lambda_init, dtype=dtype, device=device)
    chi2_state = torch.tensor(float("inf"), dtype=dtype, device=device)
    Hd = torch.eye(6, dtype=dtype, device=device).expand(K, 6, 6)
    it, done = 0, False
    while it < cfg.max_iterations and not done:
        Hdiag, Hoff, b, chi2 = build_block_normal_equations(poses, graph)
        Hx, Hz_off, Hpp, Hxp, bx, bp, c2p = _plane_block_terms(poses, planes, plane_graph)
        Hdiag, b, chi2 = Hdiag + Hx, b + bx, chi2 + c2p
        if cfg.fix_first:
            Hdiag[0] = torch.eye(6, dtype=dtype, device=device)
            Hoff = torch.where(((fb.i == 0) | (fb.j == 0))[:, None, None], 0.0, Hoff)
            Hz_off = torch.where(((fz.i == 0) | (fz.j == 0))[:, None, None], 0.0, Hz_off)
            Hxp = torch.where((fsp.i == 0)[:, None, None], 0.0, Hxp)
            b[0] = 0.0
        A = _damped(Hdiag, lam)
        Hpp_d = Hpp.permute(0, 2, 1, 3).reshape(M3, M3)
        Hpp_d = Hpp_d + torch.diag(lam * torch.clamp(torch.diagonal(Hpp_d), min=1.0))
        C = (_chain_upper_blocks(Hoff, fb.i, fb.j, K, dtype)
             + _chain_upper_blocks(Hz_off, fz.i, fz.j, K, dtype))
        if cfg.solver == "direct":
            # pose block: [ -b | G_p ] with G_p the pose-plane coupling columns
            Gp = torch.zeros((K, 6, M3), dtype=dtype, device=device).index_put(
                (fsp.i[:, None, None], rows6[None, :, None], colp), Hxp, accumulate=True)
            X = solve_tridiag_woodbury(A, C, poses, fw, torch.cat([(-b)[..., None], Gp], -1),
                                       cfg.loop_capacity)
            # Schur complement over the plane coordinates
            contrib = torch.einsum("fij,fin->fjn", Hxp, X[fsp.i])  # (F, 3, 1 + M3)
            GtX = torch.zeros((M3, 1 + M3), dtype=dtype, device=device).index_put(
                (rowp, torch.arange(1 + M3, device=device)[None, None, :]), contrib,
                accumulate=True)
            dpl = torch.linalg.solve_ex(Hpp_d - GtX[:, 1:], -bp.reshape(-1) - GtX[:, 0])[0]
            dx = X[:, :, 0] - torch.einsum("kin,n->ki", X[:, :, 1:], dpl)
        else:
            dx, dpl = _planes_cg(A, C, Hoff, Hz_off, Hxp, Hpp_d, b, bp, plans, cfg.cg_iters)
            dpl = dpl.reshape(-1)
        if cfg.fix_first:
            dx[0] = 0.0
        poses_new = retract(poses, dx)
        planes_new = retract_plane(planes, dpl.reshape(M, 3))
        chi2_new = graph_chi2(poses_new, graph) + plane_graph_chi2(poses_new, planes_new,
                                                                   plane_graph)
        accept = chi2_new < chi2
        poses = torch.where(accept, poses_new, poses)
        planes = torch.where(accept, planes_new, planes)
        lam = torch.where(accept, lam / cfg.lm_lambda_factor, lam * cfg.lm_lambda_factor)
        rel = torch.abs(chi2 - chi2_new) / torch.clamp(chi2, min=1e-30)
        chi2_state = torch.where(accept, chi2_new, chi2)
        Hd = Hdiag
        done = bool(accept & (rel < cfg.rel_tol))
        it += 1
    return SparsePlaneSolveResult(poses=poses, planes=planes, chi2=chi2_state,
                                  iterations=torch.tensor(it), lm_lambda=lam, H_diag=Hd)
