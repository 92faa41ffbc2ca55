"""Statistical and radius outlier removal, masked.

Port of `gorio_tpu/estimators/outliers.py` (the reference's
`pcl::StatisticalOutlierRemoval` / `pcl::RadiusOutlierRemoval` stage,
`preprocessing_nodelet_ntu.cpp:153-172`, applied at `:626-636`): the
neighbour statistics come from the blocked brute-force distances of
`registration/knn.py`, exact and parallel over points, and the removal only
clears mask bits (`filter_cloud`), so shapes stay static.
"""

from __future__ import annotations

import torch

from ..core.pointcloud import PointCloud, filter_cloud
from ..registration.knn import knn, radius_count


def statistical_outlier_mask(cloud: PointCloud, mean_k: int = 20, stddev_mul: float = 1.0):
    """Keep-mask: a point stays if its mean distance to its `mean_k` nearest
    neighbours is within `global_mean + stddev_mul * global_std` over the
    cloud (`:154-162`; the standard deviation with an n - 1 denominator)."""
    # k + 1: the point is its own neighbour at distance 0
    _, d2 = knn(cloud.xyz, cloud.xyz, k=mean_k + 1, ref_mask=cloud.mask)
    mean_dist = torch.mean(torch.sqrt(torch.clamp(d2[:, 1:], min=0.0)), dim=-1)
    w = cloud.mask.to(mean_dist.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mu = torch.sum(mean_dist * w) / n
    var = torch.sum((mean_dist - mu) ** 2 * w) / torch.clamp(n - 1.0, min=1.0)
    return cloud.mask & (mean_dist <= mu + stddev_mul * torch.sqrt(var))


def statistical_outlier_removal(cloud: PointCloud, mean_k: int = 20, stddev_mul: float = 1.0):
    return filter_cloud(cloud, statistical_outlier_mask(cloud, mean_k, stddev_mul))


def radius_outlier_mask(cloud: PointCloud, radius: float = 2.0, min_neighbors: int = 2):
    """Keep-mask: a point stays if at least `min_neighbors` other valid
    points lie within `radius` (`:163-172`)."""
    cnt = radius_count(cloud.xyz, cloud.xyz, radius, ref_mask=cloud.mask)
    return cloud.mask & (cnt - 1 >= min_neighbors)  # - 1: the point itself


def radius_outlier_removal(cloud: PointCloud, radius: float = 2.0, min_neighbors: int = 2):
    return filter_cloud(cloud, radius_outlier_mask(cloud, radius, min_neighbors))


def remove_outliers(cloud: PointCloud, method: str = "statistical", **kw) -> PointCloud:
    """The `outlier_removal_method` switch (`:153`): STATISTICAL | RADIUS |
    NONE."""
    method = method.lower()
    if method == "statistical":
        return statistical_outlier_removal(cloud, **kw)
    if method == "radius":
        return radius_outlier_removal(cloud, **kw)
    if method in ("none", ""):
        return cloud
    raise ValueError(f"unknown outlier removal method: {method}")
