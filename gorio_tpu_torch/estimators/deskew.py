"""Gyro-based scan deskewing.

Port of `gorio_tpu/estimators/deskew.py` (`PreprocessingNodelet::deskewing`,
`preprocessing_nodelet_ntu.cpp:658-719`): point i of N is rotated back by
the rotation the scan accumulated over dt = scan_period * i / N at the rate
-omega (the reference negates the gyro rate, `:691`), one batched rotation.
"""

from __future__ import annotations

import torch

from ..core import lie
from ..core.pointcloud import PointCloud


def deskew(cloud: PointCloud, omega, scan_period: float = 0.1) -> PointCloud:
    """omega: (3,) angular velocity at scan time (body frame, rad/s)."""
    n = cloud.capacity
    dtype, device = cloud.xyz.dtype, cloud.xyz.device
    dt = scan_period * (torch.arange(n, dtype=dtype, device=device) / n)
    ang = -torch.as_tensor(omega, dtype=dtype, device=device)
    # exact small rotation exp(ang dt), inverted (the reference's
    # first-order quaternion differs by < 1e-6 rad at radar rates)
    R = lie.so3_exp(-dt[:, None] * ang[None, :])
    xyz = torch.einsum("nij,nj->ni", R, cloud.xyz)
    return cloud._replace(xyz=torch.where(cloud.mask[:, None], xyz, cloud.xyz))
