"""Polar measurement covariance of radar returns.

Port of `gorio_tpu/estimators/covariances.py`: the range-dependent model
shared by APDGICP (`fast_apdgicp_impl.hpp:193-210`) and the Go-RIO
ground-plane refinement (`patchworkpp.hpp:497-523`).
"""

from __future__ import annotations

from ..registration.gicp import apd_polar_cov


def polar_covariances(xyz, dist_var: float = 0.86, azimuth_var_deg: float = 0.5,
                      elevation_var_deg: float = 1.0):
    """(N, 3) -> (N, 3, 3); the defaults are `patchworkpp.hpp:500-502`'s."""
    return apd_polar_cov(xyz, dist_var, azimuth_var_deg, elevation_var_deg)
