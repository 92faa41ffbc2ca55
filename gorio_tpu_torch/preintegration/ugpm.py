"""UGPM: Gaussian-process continuous velocity preintegration.

Port of `gorio_tpu/preintegration/ugpm.py` (`ugpm::Se3Integrator`,
`VelInt/preint.h:747-1494`, and its Ceres cost functions). Per window:

  1. the GP state (3 rotation-rate + 3 velocity channels at `state_freq`,
     `overlap` extra knots on both sides) is warm-started from an LPM-style
     integration, its derivatives w.r.t. a gyro offset and a time shift from
     `torch.func.jacfwd` through that integration,
  2. stage 1 fits the rotation channels by a dense LM with a fixed number of
     iterations (the JAX `lax.scan`): a Python loop with on-device accept
     masks and no host read,
  3. stage 2 conditions the velocity channels on the measurements in closed
     form (kriging) with the rotation frozen,
  4. the state covariance comes from the stacked residual Jacobian
     (`jacfwd` over all 6S state entries), and `ugpm_query` projects the
     posterior moments to query times through the analytic SE-kernel
     integrals.

Every tensor stays on the caller's device and in its dtype (the SLAM back
end runs it in float64). `ugpm_fit`, `ugpm_query` and `ugpm_preintegrate`
also take W windows along a leading axis (gyr (W, G, 3), ...), the
counterpart of the JAX package's `jax.vmap` over windows
(`parallel/sharded.py` `sharded_ugpm_windows`): the per-window body has no
data-dependent Python control flow, so `torch.func.vmap` carries the axis
through the unwrap, the `jacfwd` warm start and the fixed LM iterations, and
every operation runs once for the whole batch. `with_jacobians=False` skips the bias / time-shift
Jacobians, which the SLAM back end does not use; `delta_R`, `delta_p` and
`cov` are the same either way.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch.func import jacfwd, vmap

from ..core import gp, lie
from ..core.gp import linear_interp
from .lpm import _bracket, _rotation_prefix
from .types import PreintMeas

_DEFAULT_STATE_FREQ = 50.0  # `preint.h:757`
_OVERLAP = 8  # `preint.h:19` (kOverlap)


class UGPMConfig(NamedTuple):
    state_freq: float = _DEFAULT_STATE_FREQ
    overlap: int = _OVERLAP
    window_duration: float = 1.0  # sets nb_state
    lm_iters: int = 30
    correlate: bool = True
    init_grid_n: int = 512

    @property
    def nb_state(self) -> int:
        return int(math.ceil(self.window_duration * self.state_freq)) + 2 * self.overlap


class _GPState(NamedTuple):
    state_time: torch.Tensor  # (S,)
    s_rot: torch.Tensor  # (S, 3) zero-mean rotation-rate states
    s_vel: torch.Tensor  # (S, 3) zero-mean velocity states
    mean_rot: torch.Tensor  # (3,)
    mean_vel: torch.Tensor  # (3,)
    l2: torch.Tensor  # ()
    sf2: torch.Tensor  # (6,)
    sz2: torch.Tensor  # (6,)
    K_inv: torch.Tensor  # (6, S, S)
    KK_inv: torch.Tensor  # (6, S, S)
    K_int_K_inv: torch.Tensor  # (6, S, S)
    prior_w: torch.Tensor  # (6, S) GP-regularizer weights
    alpha: torch.Tensor  # (6, S)
    # the bias / time-shift Jacobians; None when fitted with_jacobians=False
    d_state_bw: Optional[torch.Tensor]  # (S, 3, 3) d s_rot / d gyro offset
    d_d_r_dt: Optional[torch.Tensor]  # (S, 3) d s_rot / d time shift
    d_vel_bv: Optional[torch.Tensor]  # (S, 3, 3)
    d_vel_bw: Optional[torch.Tensor]  # (S, 3, 3)
    d_vel_dt: Optional[torch.Tensor]  # (S, 3)
    state_cov: torch.Tensor  # (6S, 6S) correlation-rescaled state covariance
    state_var: torch.Tensor  # (6S,)


_JACOBIAN_FIELDS = ("d_state_bw", "d_d_r_dt", "d_vel_bv", "d_vel_bw", "d_vel_dt")


class _GPStatePre(NamedTuple):
    """Precomputed kernel products shared by the cost functions."""

    state_time: torch.Tensor
    mean_rot: torch.Tensor
    K_inv: torch.Tensor  # (6, S, S)
    KK_inv: torch.Tensor
    Ks_K_inv: torch.Tensor  # (3, G, S) gyro-time cross-kernel (rot channels)
    Ks_int_K_inv: torch.Tensor  # (3, G, S)
    prior_w: torch.Tensor  # (6, S)


def _chan_apply(M, s):
    """Per-channel mat-vec: M (C, R, S) with s (C, S) -> (R, C)."""
    return (M @ s[..., None])[..., 0].T


def _unwrap_scan(r_seq):
    """Revolution-unwrap a sequence of rotation vectors so consecutive
    entries stay close (`addN2Pi` / `getClosest`, `math_utils.h:385-412`).
    The three candidates r - 2pi u, r, r + 2pi u of every entry are built at
    once; only the choice, which depends on the previous pick, runs
    sequentially. The 1e-9 bias on the shifted candidates keeps the
    unshifted one at a tie (r = 0 has no clean unit vector)."""
    norm = torch.sqrt(torch.clamp(torch.sum(r_seq * r_seq, dim=-1, keepdim=True), min=1e-18))
    shift = r_seq / norm * (2 * math.pi)
    cands = torch.stack([r_seq - shift, r_seq, r_seq + shift], dim=1)  # (S, 3, 3)
    bias = torch.tensor([1e-9, 0.0, 1e-9], dtype=r_seq.dtype, device=r_seq.device)
    prev = torch.zeros(1, 3, dtype=r_seq.dtype, device=r_seq.device)
    picks = []
    for s in range(r_seq.shape[0]):
        d = torch.linalg.norm(cands[s] - prev, dim=-1) + bias
        # a (1,) index keeps the pick on the device (a 0-d one is read back
        # to the host, one synchronisation per state)
        k = torch.argmin(d, dim=0, keepdim=True)
        prev = cands[s].index_select(0, k)
        picks.append(k)
    k = torch.cat(picks)
    return cands[torch.arange(r_seq.shape[0], device=r_seq.device), k]


def _init_states(gyr_t, gyr, vel_t, vel, start_t, state_time, grid_n, bw, tau):
    """LPM-style state init as a differentiable function of the measurement
    offsets (gyro offset `bw`, time shift `tau`). Returns (state_d_r,
    state_vel, state_r), each (S, 3).

    `initialiseStateWithLPM` (`preint.h:1198-1264`), with the rate computed
    analytically (d/dt log = J_r^-1(r) w); `jacfwd` through this function
    replaces `initialiseStateDiff` / `finishStateDiff` (`:1265-1441`)."""
    dtype, device = gyr.dtype, gyr.device
    t_lo = torch.minimum(state_time[0], start_t)
    t_hi = torch.maximum(state_time[-1], start_t)
    span = torch.clamp(t_hi - t_lo, min=1e-6)
    grid_t = t_lo + span * torch.arange(grid_n, dtype=dtype, device=device) / (grid_n - 1)
    dt = span / (grid_n - 1)
    w_grid = linear_interp(grid_t + tau, gyr_t, gyr) + bw
    R_pref = _rotation_prefix(w_grid, dt)

    def R_at(t):  # t (T,) -> (T, 3, 3)
        j = _bracket(grid_t, t)
        return R_pref[j] @ lie.so3_exp(w_grid[j] * (t - grid_t[j])[:, None])

    R_start = R_at(start_t[None])[0]
    dR = R_start.T[None] @ R_at(state_time)  # (S, 3, 3)
    r = _unwrap_scan(lie.so3_log(dR))
    w_state = linear_interp(state_time + tau, gyr_t, gyr) + bw
    state_d_r = torch.einsum("sij,sj->si", lie.so3_right_jacobian_inv(r), w_state)
    v_state = linear_interp(state_time + tau, vel_t, vel)
    state_vel = torch.einsum("sij,sj->si", dR, v_state)
    return state_d_r, state_vel, r


def _rot_data_residuals(s_rot_flat, st: _GPStatePre, gyr, d_time):
    """Gyro-prediction residuals J_r(r(t_g)) r'(t_g) - w(t_g), (3G,)."""
    s = s_rot_flat.reshape(3, -1)
    rot_vec = _chan_apply(st.Ks_int_K_inv, s) + d_time[:, None] * st.mean_rot[None, :]
    d_rot = _chan_apply(st.Ks_K_inv, s) + st.mean_rot[None, :]
    pred = torch.einsum("gij,gj->gi", lie.so3_right_jacobian(rot_vec), d_rot)
    return (pred - gyr).reshape(-1)


def _residuals_rot(s_rot_flat, st: _GPStatePre, gyr, d_time):
    """Stage-1 residuals: gyro prediction + GP regularizers (rot channels).

    `RotCostFunction::Evaluate` (`cost_functions.h:201-253`): the gyro term
    is unweighted and the GP term uses w = 1/sqrt(1000 var) (`preint.h:853`
    scales var by 1000)."""
    s = s_rot_flat.reshape(3, -1)
    res_prior = (_chan_apply(st.KK_inv[:3], s).T - s) * st.prior_w[:3]
    return torch.cat([_rot_data_residuals(s_rot_flat, st, gyr, d_time), res_prior.reshape(-1)])


def _lm_solve(res_fn, x0, iters, jac_fn=None):
    """Small dense LM (DENSE_NORMAL_CHOLESKY equivalent, `preint.h:943-952`)
    with a fixed number of iterations and on-device accept masks: nothing is
    read back to the host. `jac_fn` overrides the generic `jacfwd`."""
    if jac_fn is None:
        jac_fn = jacfwd(res_fn)
    x = x0
    lam = torch.tensor(1e-6, dtype=x0.dtype, device=x0.device)
    r = res_fn(x)
    for _ in range(iters):
        J = jac_fn(x)
        H = J.T @ J
        g = J.T @ r
        A = H + lam * torch.diag(torch.clamp(torch.diagonal(H), min=1e-12))
        dx = -torch.linalg.solve_ex(A, g)[0]
        x_new = x + dx
        r_new = res_fn(x_new)
        better = torch.sum(r_new ** 2) < torch.sum(r ** 2)
        x = torch.where(better, x_new, x)
        r = torch.where(better, r_new, r)  # res_fn(x) of the next iteration
        lam = torch.where(better, lam * 0.33, lam * 10.0)
    return x


def _right_jacobian_action_jac(r, v):
    """Jacobian of f(r, v) = J_r(r) v w.r.t. the stacked (r, v), (..., 3, 6),
    in closed form: with J_r = I - b K + c K^2, K = hat(r), and b', c' the
    derivatives of `lie._sinc_coeffs`' b, c w.r.t. theta^2 (their Taylor
    branch's below its threshold, as autodiff of that function gives),
      df/dv = J_r,
      df/dr = b hat(v) - 2 b' (r x v) r^T
              + c ((r.v) I + r v^T - 2 v r^T) + 2 c' (r x (r x v)) r^T.
    The JAX package differentiates f with a vmapped `jacfwd`; in eager torch
    that is a few hundred launches per LM iteration, this is ~30."""
    theta2 = torch.sum(r * r, dim=-1)
    a, b, c = lie._sinc_coeffs(theta2)
    small = theta2 < lie._EPS
    t2 = torch.clamp(theta2, min=lie._EPS)
    db = torch.where(small, -1.0 / 24.0, (a - 2.0 * b) / (2.0 * t2))[..., None, None]
    dc = torch.where(small, -1.0 / 120.0, (b - 3.0 * c) / (2.0 * t2))[..., None, None]
    b, c = b[..., None, None], c[..., None, None]
    K = lie.hat(r)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    rxv = torch.linalg.cross(r, v)
    rrxv = torch.linalg.cross(r, rxv)
    outer = lambda x, y: x[..., :, None] * y[..., None, :]  # noqa: E731
    d_r = (b * lie.hat(v) - 2.0 * db * outer(rxv, r)
           + c * (torch.sum(r * v, dim=-1)[..., None, None] * eye + outer(r, v) - 2.0 * outer(v, r))
           + 2.0 * dc * outer(rrxv, r))
    return torch.cat([d_r, eye - b * K + c * (K @ K)], dim=-1)


def _rot_jacobian(s_rot_flat, st: _GPStatePre, d_time, J_prior):
    """Structured Jacobian of `_residuals_rot` w.r.t. the stacked state.

    Per gyro sample the residual is a 6-dim pointwise function of
    rot = Ks_int_K_inv s and drot = Ks_K_inv s (linear): its (3, 6)
    Jacobian in closed form (the twin of `JacobianRes`,
    `cost_functions.h:73-145`) composed with the kernel rows. The GP-prior
    rows `J_prior` are constant."""
    s = s_rot_flat.reshape(3, -1)
    S, G = s.shape[1], st.Ks_K_inv.shape[1]
    rot_vec = _chan_apply(st.Ks_int_K_inv, s) + d_time[:, None] * st.mean_rot[None, :]
    d_rot = _chan_apply(st.Ks_K_inv, s) + st.mean_rot[None, :]
    dfd = _right_jacobian_action_jac(rot_vec, d_rot)  # (G, 3, 6)
    # J_data[(g, row), (axis, s)] = dfd[g, row, axis] Ks_int[axis, g, s]
    #                              + dfd[g, row, 3 + axis] Ks[axis, g, s]
    J_data = (dfd[:, :, :3, None] * st.Ks_int_K_inv.permute(1, 0, 2)[:, None]
              + dfd[:, :, 3:, None] * st.Ks_K_inv.permute(1, 0, 2)[:, None])  # (G, 3, 3, S)
    return torch.cat([J_data.reshape(G * 3, 3 * S), J_prior], dim=0)


def _windows(start_t, gyr):
    """The per-window start times (W,) of a batch."""
    return torch.as_tensor(start_t, dtype=gyr.dtype, device=gyr.device).expand(gyr.shape[0])


def ugpm_fit(gyr_t, gyr, vel_t, vel, start_t, gyr_var, vel_var,
             cfg: UGPMConfig = UGPMConfig(), with_jacobians: bool = True) -> _GPState:
    """Fit the 6-channel GP state of one window (gyr_t (G,), gyr (G, 3),
    vel_t (V,), vel (V, 3)), or of W windows along a leading axis (start_t
    (W,) or one start for all); the state's fields then gain the axis."""
    if gyr.dim() == 3:
        out = _GPState(*(None if f in _JACOBIAN_FIELDS and not with_jacobians else 0
                         for f in _GPState._fields))
        return vmap(lambda *a: _fit(*a, gyr_var, vel_var, cfg, with_jacobians), out_dims=out)(
            gyr_t, gyr, vel_t, vel, _windows(start_t, gyr))
    return _fit(gyr_t, gyr, vel_t, vel, start_t, gyr_var, vel_var, cfg, with_jacobians)


def _fit(gyr_t, gyr, vel_t, vel, start_t, gyr_var, vel_var, cfg, with_jacobians):
    dtype, device = gyr.dtype, gyr.device
    start_t = torch.as_tensor(start_t, dtype=dtype, device=device)
    S = cfg.nb_state
    state_time = (start_t - cfg.overlap / cfg.state_freq
                  + torch.arange(S, dtype=dtype, device=device) / cfg.state_freq)

    # ---- LPM warm start and its derivative states (autodiff) ------------
    def init_fn(x):  # x = [gyro offset (3), time shift]
        d_r, v, _ = _init_states(gyr_t, gyr, vel_t, vel, start_t, state_time,
                                 cfg.init_grid_n, x[:3], x[3])
        return d_r, (d_r, v)

    zeros4 = torch.zeros(4, dtype=dtype, device=device)
    if with_jacobians:
        d_init, (s_rot0, s_vel0) = jacfwd(init_fn, has_aux=True)(zeros4)
        d_init_bw, d_init_dt = d_init[..., :3], d_init[..., 3]  # (S, 3, 3), (S, 3)
    else:
        _, (s_rot0, s_vel0) = init_fn(zeros4)

    # ---- hyperparameters (`initialiseHyperParam`, preint.h:1444-1476) ----
    mean_rot = torch.mean(s_rot0, dim=0)
    mean_vel = torch.mean(s_vel0, dim=0)
    sf2_rot = torch.clamp(torch.mean((s_rot0 - mean_rot) ** 2, dim=0), min=gyr_var)
    sf2_vel = torch.clamp(torch.mean((s_vel0 - mean_vel) ** 2, dim=0), min=vel_var)
    sf2 = torch.cat([sf2_rot, sf2_vel])
    l2 = torch.tensor((3.0 / cfg.state_freq) ** 2, dtype=dtype, device=device)
    sz2 = torch.cat([torch.full((3,), gyr_var, dtype=dtype, device=device),
                     torch.full((3,), vel_var, dtype=dtype, device=device)])
    s_rot = s_rot0 - mean_rot
    sf2_c, sz2_c = sf2[:, None, None], sz2[:, None, None]  # per channel, broadcast

    # ---- kernel precomputations (`preint.h:827-866`), all 6 channels ----
    K = gp.se_kernel(state_time, state_time, l2, sf2_c)  # (6, S, S)
    K_inv = gp.gp_inv(K, sz2_c)
    KK_inv = K @ K_inv
    K_int_K_inv = gp.se_kernel_integral(start_t, state_time, state_time, l2, sf2_c) @ K_inv
    ch_var = torch.diagonal(-KK_inv @ K, dim1=-2, dim2=-1) + sf2[:, None] + sz2[:, None]
    ch_var = torch.where(ch_var <= 0, sz2[:, None].expand_as(ch_var), ch_var)  # (6, S)
    prior_w = 1.0 / torch.sqrt(1000.0 * ch_var)

    # ---- stage 1: rotation channels (nonlinear LM) ----------------------
    Ks_K_inv = gp.se_kernel(gyr_t, state_time, l2, sf2_c[:3]) @ K_inv[:3]
    Ks_int_K_inv = gp.se_kernel_integral(start_t, gyr_t, state_time, l2, sf2_c[:3]) @ K_inv[:3]
    pre = _GPStatePre(state_time=state_time, mean_rot=mean_rot, K_inv=K_inv, KK_inv=KK_inv,
                      Ks_K_inv=Ks_K_inv, Ks_int_K_inv=Ks_int_K_inv, prior_w=prior_w)
    eye = torch.eye(S, dtype=dtype, device=device)
    J_prior = torch.block_diag(*[(KK_inv[i] - eye) * prior_w[i][:, None] for i in range(3)])
    d_time_g = gyr_t - start_t
    s_rot_opt = _lm_solve(
        lambda x: _residuals_rot(x, pre, gyr, d_time_g), s_rot.T.reshape(-1), cfg.lm_iters,
        jac_fn=lambda x: _rot_jacobian(x, pre, d_time_g, J_prior),
    ).reshape(3, S).T

    # ---- stage 2: velocity channels (closed form, rotation frozen) ------
    # (`preint.h:954-967`; the JAX package conditions the velocity channels
    # on the start-frame observations R_T^T vel by kriging instead of the
    # reference's ill-conditioned LS over knot values, see its comment)
    Kv_K_inv = gp.se_kernel(vel_t, state_time, l2, sf2_c[3:]) @ K_inv[3:]  # (3, V, S)
    Kg_int_K_inv_v = (gp.se_kernel_integral(start_t, vel_t, state_time, l2, sf2_c[:3])
                      @ K_inv[:3])
    d_time_v = vel_t - start_t
    rot_v = _chan_apply(Kg_int_K_inv_v, s_rot_opt.T) + d_time_v[:, None] * mean_rot[None, :]
    R_T = lie.so3_exp(-rot_v)  # (V, 3, 3)
    w_vel = 1.0 / math.sqrt(vel_var)
    v_obs = torch.einsum("vji,vj->vi", R_T, vel)  # R_T^T vel: start-frame observations
    V = vel_t.shape[0]
    K_vv = gp.se_kernel(vel_t, vel_t, l2, sf2_c[3:])  # (3, V, V)
    K_sv = gp.se_kernel(state_time, vel_t, l2, sf2_c[3:])  # (3, S, V)
    w = torch.linalg.solve_ex(
        K_vv + vel_var * torch.eye(V, dtype=dtype, device=device),
        (v_obs - mean_vel).T[..., None],
    )[0]
    s_vel_opt = (K_sv @ w)[..., 0].T  # (S, 3)

    # ---- inference preparation (`preint.h:977-1060`) --------------------
    alpha = (K_inv @ torch.cat([s_rot_opt, s_vel_opt], dim=1).T[..., None])[..., 0]  # (6, S)
    d_state_bw = d_d_r_dt = d_vel_bv = d_vel_bw = d_vel_dt = None
    if with_jacobians:
        dt_state = state_time - start_t
        state_r = _chan_apply(K_int_K_inv[:3], s_rot_opt.T) + dt_state[:, None] * mean_rot
        # [state, channel, bias axis]: sum_t K_int_K_inv[i, s, t] d_init_bw[t, i, j]
        d_state_r_bw = torch.einsum("ist,tij->sij", K_int_K_inv[:3], d_init_bw)
        v_full = s_vel_opt + mean_vel[None, :]
        d_vel_bv = lie.so3_exp(state_r)  # d(rotated vel)/d(vel offset) = delta_R rows
        d_vel_bw = -lie.hat(v_full) @ lie.so3_right_jacobian(-state_r) @ d_state_r_bw
        # time-shift Jacobian of the rotated velocity (`preint.h:1024-1058`)
        ks1 = gp.se_kernel_integral(start_t, (start_t + 0.01)[None], state_time, l2,
                                    sf2_c[:3])[:, 0]  # (3, S)
        start_r_dt = torch.sum(ks1 * alpha[:3], dim=-1) + 0.01 * mean_rot
        vel_rot_dt = torch.einsum("ij,sj->si", lie.so3_exp(start_r_dt).T, v_full)
        d_vel_dt = (vel_rot_dt - v_full) / 0.01
        d_state_bw, d_d_r_dt = d_init_bw, d_init_dt

    # ---- state covariance from the stacked residual Jacobian ------------
    # (`computeStateCorr`, preint.h:1478-1492)
    def stacked_residuals(x):
        s_r, s_v = x[: 3 * S], x[3 * S:].reshape(3, S)
        r_rot = _rot_data_residuals(s_r, pre, gyr, d_time_g)
        rot_v_x = (_chan_apply(Kg_int_K_inv_v, s_r.reshape(3, S))
                   + d_time_v[:, None] * mean_rot[None, :])
        v_pred = _chan_apply(Kv_K_inv, s_v) + mean_vel
        r_vel = (torch.einsum("vij,vj->vi", lie.so3_exp(-rot_v_x), v_pred) - vel).reshape(-1)
        return torch.cat([r_rot, r_vel * w_vel])

    x_opt = torch.cat([s_rot_opt.T.reshape(-1), s_vel_opt.T.reshape(-1)])
    state_var = ch_var.reshape(-1)
    if cfg.correlate:
        J = jacfwd(stacked_residuals)(x_opt)  # (3G + 3V, 6S)
        JtJ = J.T @ J
        # scale-aware regularization (the reference's absolute 1e-5,
        # `preint.h:1482`, vanishes against JtJ entries of 1e5+ in f32)
        reg = 1e-5 + 1e-6 * torch.trace(JtJ) / (6 * S)
        cor = torch.linalg.inv_ex(JtJ + reg * torch.eye(6 * S, dtype=dtype, device=device))[0]
        d_inv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(cor), min=1e-30))
        scale = torch.sqrt(state_var) * d_inv
        state_cov = cor * scale[:, None] * scale[None, :]
    else:
        state_cov = torch.diag(state_var)

    return _GPState(
        state_time=state_time, s_rot=s_rot_opt, s_vel=s_vel_opt, mean_rot=mean_rot,
        mean_vel=mean_vel, l2=l2, sf2=sf2, sz2=sz2, K_inv=K_inv, KK_inv=KK_inv,
        K_int_K_inv=K_int_K_inv, prior_w=prior_w, alpha=alpha, d_state_bw=d_state_bw,
        d_d_r_dt=d_d_r_dt, d_vel_bv=d_vel_bv, d_vel_bw=d_vel_bw, d_vel_dt=d_vel_dt,
        state_cov=state_cov, state_var=state_var,
    )


def ugpm_query(state: _GPState, start_t, query_t) -> PreintMeas:
    """Posterior preintegrated measurements at `query_t` (Q,)
    (`Se3Integrator::get`, `preint.h:1069-1153`), all queries at once; for
    a state of W windows, query_t (W, Q) and start_t (W,) or one start. The
    Jacobian fields are zero for a state fitted with_jacobians=False."""
    if state.alpha.dim() == 3:
        query_t = torch.as_tensor(query_t, dtype=state.alpha.dtype, device=state.alpha.device)
        dims = _GPState(*(None if x is None else 0 for x in state))
        return vmap(_query, in_dims=(dims, 0, 0))(state, _windows(start_t, state.alpha), query_t)
    return _query(state, start_t, query_t)


def _query(state: _GPState, start_t, query_t) -> PreintMeas:
    dtype, device = state.alpha.dtype, state.alpha.device
    S = state.state_time.shape[0]
    start_t = torch.as_tensor(start_t, dtype=dtype, device=device)
    query_t = torch.as_tensor(query_t, dtype=dtype, device=device)
    Q = query_t.shape[0]
    dt = query_t - start_t
    sf2_c = state.sf2[:, None, None]

    ks = gp.se_kernel_integral(start_t, query_t, state.state_time, state.l2, sf2_c)  # (6, Q, S)
    ksK = ks @ state.K_inv  # (6, Q, S)
    means = torch.cat([state.mean_rot, state.mean_vel])
    vals = (ks @ state.alpha[..., None])[..., 0] + dt[None, :] * means[:, None]  # (6, Q)
    var = gp.kss_int(start_t, query_t, state.l2, state.sf2[:, None]) - torch.sum(ksK * ks, dim=-1)
    var = torch.where(var <= 0, dt * dt * state.sz2[:, None], var)
    r, p = vals[:3].T, vals[3:].T  # (Q, 3)

    if state.d_state_bw is None:
        z3, z33 = dt.new_zeros(Q, 3), dt.new_zeros(Q, 3, 3)
        d_r_dw, d_r_dt, d_p_dw, d_p_dv, d_p_dt = z33, z3, z33, z33, z3
    else:
        d_r_dw = torch.einsum("iqs,sij->qij", ksK[:3], state.d_state_bw)
        d_r_dt = torch.einsum("iqs,si->qi", ksK[:3], state.d_d_r_dt)
        ks_dt = gp.se_kernel_integral_dt(start_t, query_t, state.state_time, state.l2,
                                         sf2_c[3:])
        d_p_dt = (ks_dt @ state.alpha[3:, :, None])[..., 0].T + torch.einsum(
            "iqs,si->qi", ksK[3:], state.d_vel_dt)
        d_p_dw = torch.einsum("iqs,sij->qij", ksK[3:], state.d_vel_bw)
        d_p_dv = torch.einsum("iqs,sij->qij", ksK[3:], state.d_vel_bv)

    # covariance reprojection (`preint.h:1085-1151`): the (Q, 6, 6S)
    # block-diagonal query rows against the (6S, 6S) state covariance
    cov = torch.einsum("iqs,isjt,jqt->qij", ksK, state.state_cov.reshape(6, S, 6, S), ksK)
    var_vec = var.T  # (Q, 6)
    d_inv = 1.0 / torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1), min=1e-30))
    d_scale = torch.sqrt(torch.clamp(var_vec, min=0.0)) * d_inv
    cov = cov * d_scale[:, :, None] * d_scale[:, None, :]
    # reconditioning guard (`preint.h:1141-1151` spirit): a projection gone
    # indefinite or non-finite under f32 ill-conditioning falls back to the
    # decorrelated diagonal for that query (the diagonal is var_vec either
    # way; only the cross-correlations are dropped)
    diag_ok = torch.diagonal(cov, dim1=-2, dim2=-1) > 0
    cov_ok = torch.isfinite(cov).all(dim=-1).all(dim=-1) & diag_ok.all(dim=-1)
    cov_diag = torch.diag_embed(var_vec)
    cov = torch.where(cov_ok[:, None, None], cov, cov_diag)

    j_right = lie.so3_right_jacobian(r)
    cov_rr = j_right @ cov[:, :3, :3] @ j_right.transpose(-1, -2)
    cov_rp = j_right @ cov[:, :3, 3:]
    cov = torch.cat([torch.cat([cov_rr, cov_rp], dim=-1),
                     torch.cat([cov_rp.transpose(-1, -2), cov[:, 3:, 3:]], dim=-1)], dim=-2)

    return PreintMeas(
        delta_R=lie.so3_exp(r),
        delta_p=p,
        dt=dt,
        dt_sq_half=0.5 * dt * dt,
        cov=cov,
        d_delta_R_d_bw=j_right @ d_r_dw,
        d_delta_R_d_t=torch.einsum("qij,qj->qi", j_right, d_r_dt),
        d_delta_p_d_bw=d_p_dw,
        d_delta_p_d_bv=d_p_dv,
        d_delta_p_d_t=d_p_dt,
    )


def ugpm_preintegrate(gyr_t, gyr, vel_t, vel, start_t, query_t, gyr_var, vel_var,
                      cfg: UGPMConfig = UGPMConfig(), with_jacobians: bool = True) -> PreintMeas:
    """Fit + query in one call (the `VelPreintegration` facade for UGPM,
    `preint.h:1540-1566`), for one window or W windows along a leading
    axis (query_t (W, Q))."""
    state = ugpm_fit(gyr_t, gyr, vel_t, vel, start_t, gyr_var, vel_var, cfg, with_jacobians)
    return ugpm_query(state, start_t, query_t)
