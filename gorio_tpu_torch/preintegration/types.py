"""Preintegrated-measurement containers and their algebra; port of
`gorio_tpu/preintegration/types.py` (`VelInt/types.h:236-311`): the
measurement, the bias prior, the bias-covariance inflation and the
combination of two consecutive chunks. Every function keeps leading batch
axes."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import lie


class PreintMeas(NamedTuple):
    """Preintegrated gyro + ego-velocity measurement over [start_t, t].

      delta_R         (..., 3, 3)  rotation from start frame to t
      delta_p         (..., 3)     position change in the start frame
      dt              (...)        t - start_t
      dt_sq_half      (...)        dt^2 / 2
      cov             (..., 6, 6)  [rot, pos] covariance
      d_delta_R_d_bw  (..., 3, 3)  right-trivialized d(log dR)/d(gyro offset)
      d_delta_R_d_t   (..., 3)     ... /d(time shift)
      d_delta_p_d_bw  (..., 3, 3)
      d_delta_p_d_bv  (..., 3, 3)  d(dp)/d(velocity offset)
      d_delta_p_d_t   (..., 3)
    """

    delta_R: torch.Tensor
    delta_p: torch.Tensor
    dt: torch.Tensor
    dt_sq_half: torch.Tensor
    cov: torch.Tensor
    d_delta_R_d_bw: torch.Tensor
    d_delta_R_d_t: torch.Tensor
    d_delta_p_d_bw: torch.Tensor
    d_delta_p_d_bv: torch.Tensor
    d_delta_p_d_t: torch.Tensor


class PreintPrior(NamedTuple):
    """Bias priors subtracted from the raw streams (`types.h:292-298`)."""

    gyr_bias: np.ndarray = np.zeros(3)
    vel_bias: np.ndarray = np.zeros(3)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def add_bias_cov(meas: PreintMeas, vel_bias_std=0.3, gyr_bias_std=0.03) -> PreintMeas:
    """Inflate the covariance with bias uncertainty
    (`VelPreintegration::get`, `preint.h:1744-1757`): J maps [bw, bv]
    through the preintegration Jacobians."""
    cov = meas.cov
    batch = cov.shape[:-2]
    J = cov.new_zeros(batch + (6, 6))
    J[..., 0:3, 0:3] = torch.eye(3, dtype=cov.dtype, device=cov.device)  # invJr(0) = I
    J[..., 3:6, 0:3] = meas.d_delta_p_d_bw
    J[..., 3:6, 3:6] = meas.d_delta_p_d_bv
    b_var = torch.tensor([gyr_bias_std ** 2] * 3 + [vel_bias_std ** 2] * 3, dtype=cov.dtype,
                         device=cov.device)
    return meas._replace(cov=cov + (J * b_var) @ J.transpose(-1, -2))


def combine_preints(prev: PreintMeas, curr: PreintMeas) -> PreintMeas:
    """Combine two consecutive preintegration chunks (`math_utils.h:689`,
    combinePreints, in the JAX package's analytic first-order form):
      R_c = R1 R2,  p_c = p1 + R1 p2,
      rotation Jacobians D_c = R2^T D1 + D2,
      position Jacobians Dp_c = Dp1 + R1 Dp2 - R1 hat(p2) D1,
      cov = J blkdiag(cov1, cov2) J^T with the perturbation model of
      `math_utils.h:540-572`."""
    R1, p1 = prev.delta_R, prev.delta_p
    R2, p2 = curr.delta_R, curr.delta_p
    R2T = R2.transpose(-1, -2)
    R1_hat_p2 = R1 @ lie.hat(p2)

    d_R_bw = R2T @ prev.d_delta_R_d_bw + curr.d_delta_R_d_bw
    d_R_t = _mv(R2T, prev.d_delta_R_d_t) + curr.d_delta_R_d_t
    d_p_bw = prev.d_delta_p_d_bw + R1 @ curr.d_delta_p_d_bw - R1_hat_p2 @ prev.d_delta_R_d_bw
    d_p_bv = prev.d_delta_p_d_bv + R1 @ curr.d_delta_p_d_bv
    d_p_t = prev.d_delta_p_d_t + _mv(R1, curr.d_delta_p_d_t) - _mv(R1_hat_p2, prev.d_delta_R_d_t)

    # covariance over eps = [eps_r1, eps_p1, eps_r2, eps_p2] (12,)
    batch = torch.broadcast_shapes(prev.cov.shape[:-2], curr.cov.shape[:-2])
    eye3 = torch.eye(3, dtype=prev.cov.dtype, device=prev.cov.device).expand(batch + (3, 3))
    J = prev.cov.new_zeros(batch + (6, 12))
    J[..., 0:3, 0:3] = R2T
    J[..., 0:3, 6:9] = eye3
    J[..., 3:6, 0:3] = -R1_hat_p2
    J[..., 3:6, 3:6] = eye3
    J[..., 3:6, 9:12] = R1
    cov12 = prev.cov.new_zeros(batch + (12, 12))
    cov12[..., 0:6, 0:6] = prev.cov
    cov12[..., 6:12, 6:12] = curr.cov
    dt = prev.dt + curr.dt
    return PreintMeas(
        delta_R=R1 @ R2,
        delta_p=p1 + _mv(R1, p2),
        dt=dt,
        dt_sq_half=0.5 * dt * dt,
        cov=J @ cov12 @ J.transpose(-1, -2),
        d_delta_R_d_bw=d_R_bw,
        d_delta_R_d_t=d_R_t,
        d_delta_p_d_bw=d_p_bw,
        d_delta_p_d_bv=d_p_bv,
        d_delta_p_d_t=d_p_t,
    )
