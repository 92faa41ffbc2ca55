"""LPM (linear preintegration model): gyro + ego-velocity -> PreintMeas.

Port of `gorio_tpu/preintegration/lpm.py` (`ugpm::IterativeIntegrator`,
`VelInt/preint.h:170-742`):

  * the timeline is a uniform grid of `grid_n` points over the window,
  * SO(3) integration and the rotation-covariance recurrence
    Sigma' = A Sigma A^T + B Q B^T are prefix products, computed by a
    log-depth (Hillis-Steele) scan: ceil(log2(grid_n)) batched steps instead
    of grid_n sequential ones. The scan reassociates the products; in
    float64 the result agrees with the JAX associative scan to ~1e-13,
  * the bias/time-shift Jacobians come from `torch.func.jacfwd` through the
    whole integrator,
  * queries at arbitrary times compose the prefix at the bracketing grid
    cell with an exact partial step.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd

from ..core import lie
from ..core.gp import linear_interp
from .types import PreintMeas

_COV_MIN_DIAG = 1e-6  # `preint.h:393-405` (minCovDiag)


def _scan(elems, comb):
    """Inclusive prefix scan of the tuple `elems` (leading axis L) under the
    associative `comb(earlier, later)`: out[k] = e[0] . e[1] . ... . e[k]."""
    n = elems[0].shape[0]
    d = 1
    while d < n:
        new = comb(tuple(e[:-d] for e in elems), tuple(e[d:] for e in elems))
        elems = tuple(torch.cat([e[:d], ne], dim=0) for e, ne in zip(elems, new))
        d *= 2
    return elems


def _rotation_prefix(w_grid, dt):
    """Prefix rotations R_k = prod_{i<k} exp(w_i dt) (left-endpoint rule,
    `preint.h:421-470`). w_grid (N, 3) -> (N, 3, 3)."""
    steps = lie.so3_exp(w_grid[:-1] * dt)
    (prefix,) = _scan((steps,), lambda a, b: (a[0] @ b[0],))
    eye = torch.eye(3, dtype=w_grid.dtype, device=w_grid.device)[None]
    return torch.cat([eye, prefix], dim=0)


def _cov_prefix(w_grid, dt, step_active, gyr_var):
    """Affine-recurrence scan for the rotation covariance (`preint.h:456-466`):
    Sigma_{k+1} = A Sigma A^T + B Q B^T with A = exp(w dt)^T,
    B = J_r(w dt) dt. Inactive steps contribute identity. Returns the
    per-grid-point (A_prefix, C_prefix) applied from 0."""
    wdt = w_grid[:-1] * dt
    A = lie.so3_exp(wdt).transpose(-1, -2)
    B = lie.so3_right_jacobian(wdt) * dt
    C = gyr_var * (B @ B.transpose(-1, -2))
    eye = torch.eye(3, dtype=w_grid.dtype, device=w_grid.device)
    active = step_active[:, None, None]
    A = torch.where(active, A, eye)
    C = torch.where(active, C, torch.zeros_like(C))

    def comb(first, second):
        A1, C1 = first
        A2, C2 = second
        return A2 @ A1, A2 @ C1 @ A2.transpose(-1, -2) + C2

    Ap, Cp = _scan((A, C), comb)
    return torch.cat([eye[None], Ap], dim=0), torch.cat([torch.zeros_like(eye)[None], Cp], dim=0)


def _bracket(grid_t, t):
    n = grid_t.shape[0]
    return torch.clamp(torch.searchsorted(grid_t, t, right=True) - 1, 0, n - 2)


def lpm_preintegrate(
    gyr_t,
    gyr,
    vel_t,
    vel,
    start_t,
    query_t,
    gyr_var,
    vel_var,
    grid_n: int = 512,
    with_jacobians: bool = True,
) -> PreintMeas:
    """Preintegrate over [start_t, query_t[i]] for all queries at once.

    gyr_t (G,), gyr (G,3): angular-rate samples (bias prior removed)
    vel_t (V,), vel (V,3): body-frame ego-velocity samples
    query_t (Q,): inference times (may precede start_t)
    Returns a PreintMeas batched over Q."""
    dtype, device = gyr.dtype, gyr.device
    start_t = torch.as_tensor(start_t, dtype=dtype, device=device)
    query_t = torch.as_tensor(query_t, dtype=dtype, device=device)
    Q = query_t.shape[0]

    t_lo = torch.minimum(torch.min(query_t), start_t)
    t_hi = torch.maximum(torch.max(query_t), start_t)
    span = torch.clamp(t_hi - t_lo, min=1e-6)
    grid_t = t_lo + span * torch.arange(grid_n, dtype=dtype, device=device) / (grid_n - 1)
    dt = span / (grid_n - 1)

    def integrate(bw, bv, tau):
        """The whole preintegration as a function of measurement offsets;
        evaluating the streams at (t + tau) is the reference's time shift."""
        w_grid = linear_interp(grid_t + tau, gyr_t, gyr) + bw  # (N, 3)
        R_pref = _rotation_prefix(w_grid, dt)

        def R_at(t):  # t (T,) -> (T, 3, 3)
            j = _bracket(grid_t, t)
            return R_pref[j] @ lie.so3_exp(w_grid[j] * (t - grid_t[j])[:, None])

        R_startT = R_at(start_t[None])[0].T
        dR_q = R_startT[None] @ R_at(query_t)

        # velocity reprojection at the sample times (`preint.h:271-287`)
        v_shifted = linear_interp(vel_t + tau, vel_t, vel) + bv
        v_rot = torch.einsum("nij,nj->ni", R_startT[None] @ R_at(vel_t), v_shifted)

        # cumulative trapezoid over the sample times
        seg = 0.5 * (v_rot[1:] + v_rot[:-1]) * (vel_t[1:] - vel_t[:-1])[:, None]
        cum = torch.cat([torch.zeros_like(v_rot[:1]), torch.cumsum(seg, dim=0)], dim=0)

        def P_at(t):  # t (T,) -> (T, 3)
            j = _bracket(vel_t, t)
            w = (t - vel_t[j]) / torch.clamp(vel_t[j + 1] - vel_t[j], min=1e-30)
            v_t = v_rot[j] + torch.clamp(w, -2.0, 2.0)[:, None] * (v_rot[j + 1] - v_rot[j])
            return cum[j] + (t - vel_t[j])[:, None] * 0.5 * (v_rot[j] + v_t)

        dp_q = P_at(query_t) - P_at(start_t[None])
        return dR_q, dp_q

    zeros3 = torch.zeros(3, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    dR_q, dp_q = integrate(zeros3, zeros3, zero)
    dts = query_t - start_t

    # rotation covariance
    w_grid0 = linear_interp(grid_t, gyr_t, gyr)
    step_active = (grid_t[1:] > start_t) & (grid_t[1:] <= t_hi + 1e-12)
    Ap, Cp = _cov_prefix(w_grid0, dt, step_active, gyr_var)
    j = _bracket(grid_t, query_t)
    frac = torch.clamp(query_t - torch.maximum(grid_t[j], start_t), min=0.0)
    wdt = w_grid0[j] * frac[:, None]
    A = lie.so3_exp(wdt).transpose(-1, -2)
    B = lie.so3_right_jacobian(wdt) * frac[:, None, None]
    rot_cov_q = A @ Cp[j] @ A.transpose(-1, -2) + gyr_var * (B @ B.transpose(-1, -2))

    eye3 = torch.eye(3, dtype=dtype, device=device)
    pos_cov_q = (torch.clamp(dts, min=0.0) * vel_var)[:, None, None] * eye3  # `preint.h:643`
    zero33 = torch.zeros((Q, 3, 3), dtype=dtype, device=device)
    cov = torch.cat([torch.cat([rot_cov_q, zero33], 2), torch.cat([zero33, pos_cov_q], 2)], 1)
    diag = torch.diagonal(cov, dim1=-2, dim2=-1)
    cov = cov + torch.diag_embed(torch.clamp(_COV_MIN_DIAG - diag, min=0.0))

    if not with_jacobians:
        z3 = torch.zeros((Q, 3), dtype=dtype, device=device)
        return PreintMeas(dR_q, dp_q, dts, 0.5 * dts * dts, cov, zero33, z3, zero33, zero33, z3)

    dR0T = dR_q.transpose(-1, -2)

    def log_and_p(bw, bv, tau):
        dR, dp = integrate(bw, bv, tau)
        # right-trivialized rotation delta: log(dR0^T dR(eps)); exact at eps=0
        return lie.so3_log(dR0T @ dR), dp

    d_r_bw, d_p_bw = jacfwd(log_and_p, argnums=0)(zeros3, zeros3, zero)
    _, d_p_bv = jacfwd(log_and_p, argnums=1)(zeros3, zeros3, zero)
    d_r_t, d_p_t = jacfwd(log_and_p, argnums=2)(zeros3, zeros3, zero)
    return PreintMeas(
        delta_R=dR_q,
        delta_p=dp_q,
        dt=dts,
        dt_sq_half=0.5 * dts * dts,
        cov=cov,
        d_delta_R_d_bw=d_r_bw,
        d_delta_R_d_t=d_r_t,
        d_delta_p_d_bw=d_p_bw,
        d_delta_p_d_bv=d_p_bv,
        d_delta_p_d_t=d_p_t,
    )
