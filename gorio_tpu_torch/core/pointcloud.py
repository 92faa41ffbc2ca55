"""Fixed-shape point-cloud container.

Port of `PointCloud`, `make_cloud`, `filter_cloud`, `compact_cloud`,
`distance_filter`, the voxel helpers (`voxel_key`, `masked_min_corner`,
`voxel_downsample`) and `random_cloud` from `gorio_tpu/core/pointcloud.py`:
a NamedTuple of padded tensors plus a validity mask, so every cloud of a
sequence has the same shape and every op is mask-aware.
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


def compact_cloud(cloud: PointCloud) -> PointCloud:
    """Move valid points to the front (stable), padding at the back."""
    order = torch.argsort((~cloud.mask).to(torch.int8), stable=True)
    return PointCloud(*(x[order] for x in cloud))


VOXEL_BITS = 10  # 1024 cells per axis; keys fit int32
VOXEL_SENTINEL = 2**30  # the key of padding rows: above every real key


def pack_voxel_key(ijk):
    """int32 key of integer voxel coordinates (..., 3), each in [0, 1024)."""
    return (ijk[..., 0] << (2 * VOXEL_BITS)) | (ijk[..., 1] << VOXEL_BITS) | ijk[..., 2]


def voxel_key(xyz, resolution, origin):
    """int32 voxel key per point: 10 bits per axis relative to `origin`
    ((3,), usually the masked min corner); out-of-range cells clamp to the
    boundary voxel."""
    ijk = torch.floor((xyz - origin) / resolution).to(torch.int32)
    return pack_voxel_key(torch.clamp(ijk, 0, (1 << VOXEL_BITS) - 1))


def masked_min_corner(xyz, mask, pad=1.0):
    """Min corner of the valid points (static-shape reduction)."""
    big = torch.full_like(xyz, 1e9)
    return torch.amin(torch.where(mask[:, None], xyz, big), dim=0) - pad


def segment_runs(key):
    """Stable sort of int32 voxel keys (padding = `VOXEL_SENTINEL`) and the
    runs of equal keys: (order, sorted keys, segment ids, bounds). A run's
    segment id counts from 0 in key order (`jnp.argsort` is stable, so ties
    keep their row order as in the JAX package). `bounds` (n + 1,) holds
    the first sorted row of each id, clamped to the first padding row, so
    that in `segment_sum` the padding's run, and every id past the last
    run, is empty."""
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    is_head = torch.ones_like(key_s, dtype=torch.bool)
    is_head[1:] = key_s[1:] != key_s[:-1]
    seg = torch.cumsum(is_head.to(torch.int64), 0) - 1
    ids = torch.arange(key.shape[0] + 1, device=key.device)
    first_pad = torch.searchsorted(key_s, torch.full((1,), VOXEL_SENTINEL, dtype=key_s.dtype,
                                                     device=key.device))
    return order, key_s, seg, torch.minimum(torch.searchsorted(seg, ids), first_pad)


def segment_sum(x, bounds):
    """`jax.ops.segment_sum` over the leading axis of rows sorted by segment,
    each segment the rows [bounds[i], bounds[i + 1]) (`segment_runs`). A
    segmented reduction, not atomics: the card sums in a fixed order, so
    repeated runs agree to the bit."""
    return torch.segment_reduce(x, "sum", offsets=bounds, axis=0, unsafe=True)


def segment_sum_by_id(x, ids, num_segments):
    """`jax.ops.segment_sum` of the rows of `x` over unsorted int64 `ids`;
    rows whose id is not in [0, num_segments) count nowhere. A stable sort
    by id and a segmented reduction: each segment sums in row order, so
    the card repeats to the bit (`index_add_` adds floats with atomics)."""
    order = torch.argsort(ids, stable=True)
    ids_s = ids[order]
    bounds = torch.searchsorted(
        ids_s, torch.arange(num_segments + 1, dtype=ids.dtype, device=ids.device))
    return segment_sum(x[order], bounds)


def segment_reduce(x, seg, num_segments, reduce, fill):
    """`jax.ops.segment_{max,min}` ("amax" / "amin") over a 1-D `x`; empty
    segments hold `fill`."""
    out = torch.full((num_segments,), fill, dtype=x.dtype, device=x.device)
    return out.scatter_reduce_(0, seg, x, reduce, include_self=True)


def voxel_downsample(cloud: PointCloud, resolution, capacity=None):
    """Voxel-grid centroid downsampling with a static output shape
    (`pcl::VoxelGrid`, `map_cloud_generator.cpp:41-49`): sort by voxel key,
    mean per run of equal keys; intensity is the run's max, doppler its
    mean, cluster its max. Valid voxels come first, in key order."""
    n = cloud.capacity
    if capacity is None:
        capacity = n
    origin = masked_min_corner(cloud.xyz, cloud.mask)
    key = torch.where(cloud.mask, voxel_key(cloud.xyz, resolution, origin),
                      torch.full_like(cloud.mask, VOXEL_SENTINEL, dtype=torch.int32))
    order, _, seg, bounds = segment_runs(key)
    xyz_s, mask_s = cloud.xyz[order], cloud.mask[order]
    w = mask_s.to(xyz_s.dtype)
    ninf = torch.full_like(w, -torch.inf)
    sums = segment_sum(xyz_s * w[:, None], bounds)
    cnts = segment_sum(w, bounds)
    inten_m = segment_reduce(torch.where(mask_s, cloud.intensity[order], ninf), seg, n, "amax",
                             -torch.inf)
    dop_sum = segment_sum(cloud.doppler[order] * w, bounds)
    clus_first = segment_reduce(torch.where(mask_s, cloud.cluster[order], ninf), seg, n, "amax",
                                -torch.inf)
    valid = cnts > 0
    centroid = sums / torch.clamp(cnts, min=1.0)[:, None]
    out = PointCloud(
        xyz=torch.where(valid[:, None], centroid, torch.full_like(centroid, PAD_COORD)),
        intensity=torch.where(valid, inten_m, torch.zeros_like(inten_m)),
        doppler=dop_sum / torch.clamp(cnts, min=1.0),
        cluster=torch.where(valid, clus_first, torch.full_like(clus_first, -1.0)),
        mask=valid,
    )
    if capacity != n:
        out = PointCloud(*(x[:capacity] for x in out))
    return out


def random_cloud(generator, n, extent=30.0, structured=True, dtype=torch.float32, capacity=None,
                 device=None):
    """Synthetic radar-like scan: planar ground + a few wall/box clusters
    (the JAX package's distribution: n // 3 ground points at z = -1.8 with
    3 cm noise, the rest around 12 cluster centres, or uniform when not
    `structured`; intensity in [10, 30)). The draws come from `generator`
    (a `torch.Generator`; JAX's key draws cannot be reproduced) on its own
    device, so a CPU generator gives the same cloud on every `device`."""
    gdev = generator.device
    like = dict(generator=generator, dtype=dtype, device=gdev)

    def uniform(*shape):
        return (2.0 * torch.rand(shape, **like) - 1.0) * extent

    n_ground = n // 3
    n_rest = n - n_ground
    gz = -1.8 + 0.03 * torch.randn(n_ground, **like)
    ground = torch.cat([uniform(n_ground, 2), gz[:, None]], dim=-1)
    if structured:
        # clusters of points on vertical planes (building walls, poles)
        n_clusters = 12
        centers = uniform(n_clusters, 3)
        centers[:, 2] = torch.abs(centers[:, 2]) * 0.15
        assign = torch.randint(0, n_clusters, (n_rest,), generator=generator, device=gdev)
        local = torch.randn(n_rest, 3, **like) * torch.tensor([2.0, 0.12, 1.2], dtype=dtype,
                                                             device=gdev)
        rest = centers[assign] + local
    else:
        rest = uniform(n_rest, 3)
    xyz = torch.cat([ground, rest], dim=0)
    inten = 10.0 + 20.0 * torch.rand(n, **like)
    return make_cloud(xyz, intensity=inten, capacity=capacity,
                      device=gdev if device is None else device)
