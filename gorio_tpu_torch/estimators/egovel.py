"""Doppler radar ego-velocity estimation: batched RANSAC + LSQ.

Port of `gorio_tpu/estimators/egovel.py`. Each static return at unit
direction r_hat measures y = r_hat . v_ego. All RANSAC hypotheses are drawn
at once and solved as one batch of 3x3 systems; inlier counting is one
(iters, N) product; the refit is a masked normal-equation solve.

`jax.random.choice` cannot be reproduced with torch's generators, so the
hypothesis index array `hyp_idx (iters, k)` may be passed in (the parity
tests pass JAX's); otherwise it is drawn from `generator` with the same
distribution (valid points, uniform, with replacement).

A cloud with a leading batch axis (xyz (B, N, 3)) is B scans at once, the
counterpart of a `jax.vmap`ped estimator: every field of the result gains
the axis, and `hyp_idx` is (B, iters, k). A single scan runs the same
operations as one lane.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ..core.pointcloud import PointCloud


class EgoVelConfig(NamedTuple):
    """Parity with `radar_ego_velocity_estimator.h:31-60` defaults."""

    min_dist: float = 1.0
    max_dist: float = 400.0
    min_db: float = 0.0
    elevation_thresh_deg: float = 22.5
    azimuth_thresh_deg: float = 56.5
    doppler_velocity_correction_factor: float = 1.0
    thresh_zero_velocity: float = 0.05
    allowed_outlier_percentage: float = 0.30
    sigma_zero_velocity_x: float = 1.0e-3
    sigma_zero_velocity_y: float = 3.2e-3
    sigma_zero_velocity_z: float = 1.0e-2
    sigma_offset_radar_x: float = 0.0
    sigma_offset_radar_y: float = 0.0
    sigma_offset_radar_z: float = 0.0
    max_sigma_x: float = 0.2
    max_sigma_y: float = 0.2
    max_sigma_z: float = 0.2
    use_ransac: bool = True
    outlier_prob: float = 0.05
    success_prob: float = 0.995
    n_ransac_points: int = 5
    inlier_thresh: float = 0.5
    # Hypotheses rejecting more than this fraction of points fall back to
    # "all points are inliers" (reinsert_mode="reference" only)
    outlier_reinsert_ratio: float = 0.05
    # "consensus": largest consensus wins, then `refine_rounds` of trimmed
    # refinement; "reference": the reference's blanket reinsertion
    reinsert_mode: str = "consensus"
    refine_rounds: int = 2
    min_ransac_iters: int = 16

    @property
    def ransac_iter(self) -> int:
        """Parity with `radar_ego_velocity_estimator.h:137-141`."""
        base = int(
            math.log(1.0 - self.success_prob)
            / math.log(1.0 - (1.0 - self.outlier_prob) ** self.n_ransac_points)
        )
        if self.reinsert_mode == "consensus":
            return max(base, self.min_ransac_iters)
        return base


class EgoVelResult(NamedTuple):
    v: torch.Tensor  # ([B,] 3) ego velocity in radar frame
    sigma: torch.Tensor  # ([B,] 3) per-axis std
    inlier_mask: torch.Tensor  # ([B,] N) bool — static (non-dynamic) returns
    valid_mask: torch.Tensor  # ([B,] N) bool — points that passed the gates
    ok: torch.Tensor  # ([B]) bool
    zero_velocity: torch.Tensor  # ([B]) bool


def _mv(M, v):
    """M (..., n, 3) times v (..., 3); an unbatched call stays one gemv."""
    return M @ v if v.dim() == 1 else (M @ v[..., None])[..., 0]


def _dot(a, b):
    return a @ b if a.dim() == 1 else (a[..., None, :] @ b[..., :, None])[..., 0, 0]


def _row(x, i):
    """x[..., i, :] with one index per lane."""
    return x[i] if i.dim() == 0 else torch.take_along_dim(x, i[..., None, None], dim=-2)[..., 0, :]


def _gate(cloud: PointCloud, cfg: EgoVelConfig):
    """FOV/range/SNR gating (`radar_ego_velocity_estimator.cpp:75-97`)."""
    x, y, z = cloud.xyz[..., 0], cloud.xyz[..., 1], cloud.xyz[..., 2]
    r = torch.linalg.norm(cloud.xyz, dim=-1)
    azimuth = torch.atan2(y, x)
    elevation = torch.atan2(torch.sqrt(x * x + y * y), z) - math.pi / 2
    valid = (
        cloud.mask
        & (r > cfg.min_dist)
        & (r < cfg.max_dist)
        & (cloud.intensity > cfg.min_db)
        & (torch.abs(azimuth) < math.radians(cfg.azimuth_thresh_deg))
        & (torch.abs(elevation) < math.radians(cfg.elevation_thresh_deg))
    )
    dirs = cloud.xyz / torch.clamp(r, min=1e-9)[..., None]
    return valid, dirs


def _masked_lstsq(H, y, w):
    """argmin ||w*(H v - y)|| with 3 unknowns, batched over leading axes of
    H (..., N, 3); returns (v, jittered normal matrix A, HtH)."""
    Hw = H * w[..., None]
    HtH = Hw.transpose(-1, -2) @ Hw
    Hty = (Hw.transpose(-1, -2) @ (y * w)[..., None])[..., 0]
    trace = torch.diagonal(HtH, dim1=-2, dim2=-1).sum(-1)
    jitter = 1e-9 * trace + 1e-12  # degenerate masks stay solvable
    A = HtH + jitter[..., None, None] * torch.eye(3, dtype=H.dtype, device=H.device)
    v = torch.linalg.solve(A, Hty)
    return v, A, HtH


def draw_hypotheses(valid, iters: int, k: int, generator: Optional[torch.Generator] = None):
    """([B,] iters, k) indices drawn uniformly with replacement among each
    scan's valid points (uniform over all points when none is valid)."""
    w = valid.to(torch.float64)
    w = torch.where(torch.sum(w, dim=-1, keepdim=True) > 0, w, torch.ones_like(w))
    idx = torch.multinomial(w, iters * k, replacement=True, generator=generator)
    return idx.view(*valid.shape[:-1], iters, k)


def estimate_ego_velocity(
    cloud: PointCloud,
    cfg: EgoVelConfig = EgoVelConfig(),
    generator: Optional[torch.Generator] = None,
    hyp_idx=None,
) -> EgoVelResult:
    """Ego-velocity estimate of one scan, or of B scans along a leading axis
    (`RadarEgoVelocityEstimator::estimate` -> `solve3DFullRansac` ->
    `solve3DFull`, `radar_ego_velocity_estimator.cpp:60,172,252`)."""
    dtype, device = cloud.xyz.dtype, cloud.xyz.device
    valid, dirs = _gate(cloud, cfg)
    n = cloud.xyz.shape[-2]
    y = cloud.doppler * cfg.doppler_velocity_correction_factor
    w_valid = valid.to(dtype)
    n_valid = torch.sum(w_valid, dim=-1)

    # zero-velocity detection: outlier-trimmed quantile of |doppler|
    # (`radar_ego_velocity_estimator.cpp:102-108`)
    abs_dop = torch.where(valid, torch.abs(y), torch.full_like(y, math.inf))
    sorted_dop = torch.sort(abs_dop).values
    q_idx = torch.clamp(
        (n_valid * (1.0 - cfg.allowed_outlier_percentage)).to(torch.int32), 0, n - 1
    )
    q_idx = q_idx.long()
    q_dop = sorted_dop[q_idx] if q_idx.dim() == 0 else torch.take_along_dim(
        sorted_dop, q_idx[..., None], dim=-1)[..., 0]
    zero_vel = q_dop < cfg.thresh_zero_velocity

    # batched RANSAC
    iters, k = cfg.ransac_iter, cfg.n_ransac_points
    if hyp_idx is None:
        hyp_idx = draw_hypotheses(valid, iters, k, generator)
    idx = torch.as_tensor(hyp_idx, device=device).long()
    if idx.dim() == 3:  # one index array per scan
        idx = (torch.arange(idx.shape[0], device=device)[:, None, None], idx)
    v_hyp, _, _ = _masked_lstsq(dirs[idx], y[idx], w_valid[idx])  # ([B,] iters, 3)
    err = torch.abs(y[..., None, :] - v_hyp @ dirs.transpose(-1, -2))  # ([B,] iters, N)
    inl = (err < cfg.inlier_thresh) & valid[..., None, :]
    n_inl = torch.sum(inl, dim=-1)
    if cfg.reinsert_mode == "reference":
        # outlier-ratio reinsertion (`radar_ego_velocity_estimator.cpp:216-221`)
        n_outl = n_valid.to(torch.int32)[..., None] - n_inl
        ratio = n_outl.to(dtype) / torch.clamp(n_valid, min=1.0)[..., None]
        reinsert = ratio > cfg.outlier_reinsert_ratio
        inl = torch.where(reinsert[..., None], valid[..., None, :], inl)
        n_inl = torch.sum(inl, dim=-1)
        # a genuine consensus always outranks a reinserted "all points" set
        score = n_inl + torch.where(reinsert, 0, n + 1)
        inlier_mask = _row(inl, torch.argmax(score, dim=-1))
    else:
        inlier_mask = _row(inl, torch.argmax(n_inl, dim=-1))
        for _ in range(cfg.refine_rounds):
            v_r, _, _ = _masked_lstsq(dirs, y, inlier_mask.to(dtype))
            inlier_mask = (torch.abs(y - _mv(dirs, v_r)) < cfg.inlier_thresh) & valid

    # refit on the best inliers with sigma estimation
    w_in = inlier_mask.to(dtype)
    n_in = torch.sum(w_in, dim=-1)
    v_fit, A, _ = _masked_lstsq(dirs, y, w_in)
    e = (_mv(dirs, v_fit) - y) * w_in
    dof = torch.clamp(n_in - 3.0, min=1.0)
    C = _dot(e, e)[..., None, None] * torch.linalg.inv(A) / dof[..., None, None]
    offsets = torch.tensor(
        [cfg.sigma_offset_radar_x, cfg.sigma_offset_radar_y, cfg.sigma_offset_radar_z],
        dtype=dtype, device=device,
    )
    sigma = torch.sqrt(torch.clamp(torch.diagonal(C, dim1=-2, dim2=-1), min=0.0)) + offsets
    sigma_ok = ((sigma[..., 0] < cfg.max_sigma_x) & (sigma[..., 1] < cfg.max_sigma_y)
                & (sigma[..., 2] < cfg.max_sigma_z))

    zero_sigma = torch.tensor(
        [cfg.sigma_zero_velocity_x, cfg.sigma_zero_velocity_y, cfg.sigma_zero_velocity_z],
        dtype=dtype, device=device,
    )
    zero_inliers = valid & (torch.abs(y) < cfg.thresh_zero_velocity)
    return EgoVelResult(
        v=torch.where(zero_vel[..., None], torch.zeros_like(v_fit), v_fit),
        sigma=torch.where(zero_vel[..., None], zero_sigma, sigma),
        inlier_mask=torch.where(zero_vel[..., None], zero_inliers, inlier_mask),
        valid_mask=valid,
        ok=(n_valid > 2) & (zero_vel | sigma_ok),
        zero_velocity=zero_vel,
    )
