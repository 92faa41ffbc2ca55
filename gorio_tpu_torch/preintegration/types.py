"""Preintegrated-measurement container; port of `PreintMeas` from
`gorio_tpu/preintegration/types.py` (`VelInt/types.h:236-282`)."""

from __future__ import annotations

from typing import NamedTuple

import torch


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
