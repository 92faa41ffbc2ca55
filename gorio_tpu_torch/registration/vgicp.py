"""Voxelized GICP (VGICP): distribution-to-distribution over a voxel map.

Port of `gorio_tpu/registration/vgicp.py` (`FastVGICP`, `FastVGICPCuda`):
the target becomes a Gaussian voxel map (mean and the mean of the
per-point regularised covariances per voxel), correspondences are
DIRECT1/7/27 voxel lookups of each moved source point through the dense
table of `ndt.py`, and the Mahalanobis matrix is (C_voxel + R C_src R^T)^-1,
feeding the port's LM (`lsq.lm_optimize`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import lie
from ..core.linalg import inv3
from ..core.pointcloud import PointCloud, masked_min_corner, segment_sum
from .gicp import _covariances, _transform
from .lsq import LMConfig, LMResult, lm_optimize
from .ndt import _offsets, _point_ijk, _sorted_voxels, _table_lookup, _voxel_runs, _voxel_table


class VGICPConfig(NamedTuple):
    resolution: float = 1.0
    k_correspondences: int = 20
    plane_eps: float = 1e-3
    neighborhood: str = "direct1"  # the reference's default for fast_vgicp
    voxel_capacity: int = 8192
    min_points_per_voxel: int = 1
    table_size: int = 1 << 21
    lm: LMConfig = LMConfig()
    # "knn" (FastVGICP) or "rbf" (FastVGICPCuda GPU_RBF_KERNEL)
    covariance_method: str = "knn"
    rbf_kernel_width: float = 0.25
    rbf_max_dist: float = 3.0


class GaussianVoxelMap(NamedTuple):
    keys: torch.Tensor
    means: torch.Tensor  # (V, 3)
    covs: torch.Tensor  # (V, 3, 3) mean of the regularised point covariances
    counts: torch.Tensor  # (V,)
    valid: torch.Tensor
    origin: torch.Tensor
    table: torch.Tensor  # dense lookup table (see ndt.VoxelGaussianMap)
    table_dims: torch.Tensor


def build_gaussian_voxel_map(cloud: PointCloud, cfg: VGICPConfig = VGICPConfig()
                             ) -> GaussianVoxelMap:
    """Additive voxel accumulation of the per-point (PLANE-regularised)
    covariances (`FastVGICP::create_voxelmap`, additive mode)."""
    n = cloud.capacity
    pt_cov, _ = _covariances(cloud, cfg)
    origin = masked_min_corner(cloud.xyz, cloud.mask, pad=2.0 * cfg.resolution)
    order, _, bounds, w, cnt, head_key = _voxel_runs(cloud, cfg.resolution, origin)
    norm = torch.clamp(cnt, min=1.0)
    mean = segment_sum(cloud.xyz[order] * w[:, None], bounds) / norm[:, None]
    cov = segment_sum(pt_cov[order] * w[:, None, None], bounds) / norm[:, None, None]
    valid = cnt >= cfg.min_points_per_voxel
    take = min(cfg.voxel_capacity, n)
    order2, keys_sorted, valid_sorted = _sorted_voxels(head_key, valid, take)
    table, dims = _voxel_table(keys_sorted, valid_sorted, cfg.table_size)
    return GaussianVoxelMap(keys=keys_sorted, means=mean[:take][order2], covs=cov[:take][order2],
                            counts=cnt[:take][order2], valid=valid_sorted, origin=origin,
                            table=table, table_dims=dims)


def vgicp_align(source: PointCloud, target: PointCloud, init_T=None,
                cfg: VGICPConfig = VGICPConfig()) -> LMResult:
    """Voxelised GICP alignment source -> target: builds the target map and
    the source covariances, then runs the LM in the promoted dtype of the
    pose and the cloud."""
    if init_T is None:
        init_T = torch.eye(4, dtype=source.xyz.dtype, device=source.xyz.device)
    dtype = torch.promote_types(init_T.dtype, source.xyz.dtype)
    vmap_t = build_gaussian_voxel_map(target, cfg)
    src_cov = _covariances(source, cfg)[0].to(dtype)
    covs_t, means_t = vmap_t.covs.to(dtype), vmap_t.means.to(dtype)
    offsets = _offsets(cfg, init_T.device)

    def correspondences(T):
        R = T[:3, :3]
        moved, _ = _transform(source.xyz, T)
        ijk = _point_ijk(moved, cfg.resolution, vmap_t.origin)
        idx, found = _table_lookup(vmap_t.keys, vmap_t.table, vmap_t.table_dims,
                                   cfg.table_size, ijk[:, None, :] + offsets[None])
        found = found & vmap_t.valid[idx] & source.mask[:, None]
        mah = inv3(covs_t[idx] + (R @ src_cov @ R.T)[:, None])  # (N, O, 3, 3)
        return idx, found, mah

    def error_terms(T, idx, found, mah):
        moved, _ = _transform(source.xyz, T)
        err = means_t[idx] - moved[:, None, :]  # (N, O, 3)
        m_err = torch.einsum("noij,noj->noi", mah, err)
        c = torch.einsum("noi,noi->no", err, m_err)
        return moved, m_err, torch.sum(torch.where(found, c, torch.zeros_like(c)))

    def linearize(T):
        idx, found, mah = correspondences(T)
        moved, m_err, cost = error_terms(T, idx, found, mah)
        sk = lie.hat(moved)  # (N, 3, 3)
        okf = found.to(moved.dtype)
        MS = torch.einsum("noij,njk->noik", mah, sk)
        H_rr = torch.einsum("nji,nojk,no->ik", sk, MS, okf)
        H_rt = -torch.einsum("nji,nojk,no->ik", sk, mah, okf)
        H_tt = torch.einsum("noij,no->ij", mah, okf)
        H = torch.cat([torch.cat([H_rr, H_rt], 1), torch.cat([H_rt.T, H_tt], 1)], 0)
        b = torch.cat([torch.einsum("nji,noj,no->i", sk, m_err, okf),
                       -torch.einsum("noi,no->i", m_err, okf)])
        return cost, H, b, (idx, found, mah)

    def compute_error(T, aux):
        return error_terms(T, *aux)[2]

    return lm_optimize(linearize, compute_error, init_T.to(dtype), cfg.lm)
