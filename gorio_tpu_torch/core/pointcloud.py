"""Fixed-shape point-cloud container.

Port of `PointCloud`, `make_cloud`, `filter_cloud` and `distance_filter` from
`gorio_tpu/core/pointcloud.py`: a NamedTuple of padded tensors plus a
validity mask, so every cloud of a sequence has the same shape and every op
is mask-aware.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PointCloud(NamedTuple):
    """Padded radar point cloud.

    xyz:       (N, 3) float   positions (padding rows hold `PAD_COORD`)
    intensity: (N,)   float   SNR / power (dB)
    doppler:   (N,)   float   radial Doppler velocity
    cluster:   (N,)   float   cluster rank id, -1 = none
    mask:      (N,)   bool    True for real points
    """

    xyz: torch.Tensor
    intensity: torch.Tensor
    doppler: torch.Tensor
    cluster: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def count(self):
        return torch.sum(self.mask.to(torch.int32))


# Padding rows are parked far away so masked brute-force NN never picks them.
PAD_COORD = 1.0e6


def make_cloud(xyz, intensity=None, doppler=None, cluster=None, mask=None, capacity=None,
               device=None):
    """Build a PointCloud, padding/truncating to `capacity` (default: len(xyz)).

    Inputs may be numpy arrays or tensors; the cloud lives on `device`
    (default: the device of `xyz` when it is a tensor, else the CPU)."""
    if device is None:
        device = xyz.device if isinstance(xyz, torch.Tensor) else torch.device("cpu")
    xyz = torch.as_tensor(xyz, device=device)
    n = xyz.shape[0]
    if capacity is None:
        capacity = n
    dtype = xyz.dtype

    def _pad1(x, fill):
        if x is None:
            x = torch.full((n,), fill, dtype=dtype, device=device)
        else:
            x = torch.as_tensor(x, device=device).to(dtype)
        if x.shape[0] >= capacity:
            return x[:capacity]
        pad = torch.full((capacity - x.shape[0],), fill, dtype=dtype, device=device)
        return torch.cat([x, pad])

    if n >= capacity:
        xyz_p = xyz[:capacity]
    else:
        pad = torch.full((capacity - n, 3), PAD_COORD, dtype=dtype, device=device)
        xyz_p = torch.cat([xyz, pad], dim=0)
    if mask is None:
        mask_p = torch.arange(capacity, device=device) < n
    else:
        mask = torch.as_tensor(mask, device=device).to(torch.bool)
        mask_p = _pad1(mask, 0.0) > 0.5
    return PointCloud(
        xyz=torch.where(mask_p[:, None], xyz_p, torch.full_like(xyz_p, PAD_COORD)),
        intensity=_pad1(intensity, 0.0),
        doppler=_pad1(doppler, 0.0),
        cluster=_pad1(cluster, -1.0),
        mask=mask_p,
    )


def filter_cloud(cloud: PointCloud, keep) -> PointCloud:
    """Mask out points (no re-packing; shapes stay static)."""
    new_mask = cloud.mask & keep
    return cloud._replace(
        mask=new_mask,
        xyz=torch.where(new_mask[:, None], cloud.xyz, torch.full_like(cloud.xyz, PAD_COORD)),
    )


def distance_filter(cloud: PointCloud, min_dist, max_dist, min_z=-1e30, max_z=1e30):
    """Range / z gating (`preprocessing_nodelet_ntu.cpp:639`)."""
    d = torch.linalg.norm(cloud.xyz, dim=-1)
    z = cloud.xyz[:, 2]
    return filter_cloud(cloud, (d > min_dist) & (d < max_dist) & (z > min_z) & (z < max_z))
