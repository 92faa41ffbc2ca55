"""Brute-force nearest-neighbour search, blocked over queries.

Port of `nn1`, `knn`, `radius_count` and `rbf_covariances` from
`gorio_tpu/registration/knn.py`. Distances are
the direct sum of squared coordinate differences (the JAX package expands
|q|^2 + |r|^2 - 2 q.r for its matrix unit; the direct form has no
cancellation at 50 m ranges in float32). Masked refs get the additive bias
1e12; `nn1` returns the first index on ties. `block` bounds the
(block, M) distance tile.

Both functions take an optional leading batch axis: query (B, N, 3),
ref (B, M, 3), ref_mask (B, M).
"""

from __future__ import annotations

import torch

_BIG = 1.0e12


def _prepare(query, ref, ref_mask):
    squeeze = query.dim() == 2
    if squeeze:
        query, ref = query[None], ref[None]
        ref_mask = None if ref_mask is None else ref_mask[None]
    dtype = torch.promote_types(query.dtype, ref.dtype)
    query, ref = query.to(dtype), ref.to(dtype)
    bias = torch.zeros(ref.shape[:2], dtype=dtype, device=ref.device)
    if ref_mask is not None:
        bias = torch.where(ref_mask, bias, torch.full_like(bias, _BIG))
    return query, ref, bias, squeeze


def _block_dists(q_blk, ref, bias):
    """Squared distances (B, blk, M) plus the per-ref bias."""
    q = q_blk[:, :, None, :]
    d2 = (q[..., 0] - ref[:, None, :, 0]) ** 2
    d2 = d2 + (q[..., 1] - ref[:, None, :, 1]) ** 2
    d2 = d2 + (q[..., 2] - ref[:, None, :, 2]) ** 2
    return d2 + bias[:, None, :]


def nn1(query, ref, ref_mask=None, block: int = 1024):
    """1-NN: returns (idx (.., N) int64, sqdist (.., N)). Exact."""
    q, r, bias, squeeze = _prepare(query, ref, ref_mask)
    idx_parts, d2_parts = [], []
    for s in range(0, q.shape[1], block):
        d2 = _block_dists(q[:, s : s + block], r, bias)
        i = torch.argmin(d2, dim=-1)  # first index of the minimum
        idx_parts.append(i)
        d2_parts.append(torch.gather(d2, -1, i[..., None])[..., 0])
    if not idx_parts:
        empty = q.new_zeros(q.shape[:2])
        idx, d2 = empty.long(), empty
    else:
        idx, d2 = torch.cat(idx_parts, dim=1), torch.cat(d2_parts, dim=1)
    return (idx[0], d2[0]) if squeeze else (idx, d2)


def knn(query, ref, k: int, ref_mask=None, block: int = 512):
    """k-NN: returns (idx (.., N, k) int64, sqdist (.., N, k)), ascending."""
    q, r, bias, squeeze = _prepare(query, ref, ref_mask)
    idx_parts, d2_parts = [], []
    for s in range(0, q.shape[1], block):
        d2 = _block_dists(q[:, s : s + block], r, bias)
        vals, i = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
        idx_parts.append(i)
        d2_parts.append(vals)
    idx, d2 = torch.cat(idx_parts, dim=1), torch.cat(d2_parts, dim=1)
    return (idx[0], d2[0]) if squeeze else (idx, d2)


def radius_count(query, ref, radius, ref_mask=None, block: int = 1024):
    """Number of valid refs within `radius` of each query (.., N) int32,
    the query itself counted where it is a ref (`pcl::RadiusOutlierRemoval`'s
    radiusSearch, exact)."""
    q, r, bias, squeeze = _prepare(query, ref, ref_mask)
    r2 = float(radius) ** 2
    parts = [torch.sum(_block_dists(q[:, s : s + block], r, bias) <= r2, dim=-1,
                       dtype=torch.int32)
             for s in range(0, q.shape[1], block)]
    cnt = torch.cat(parts, dim=1) if parts else q.new_zeros(q.shape[:2], dtype=torch.int32)
    return cnt[0] if squeeze else cnt


def rbf_covariances(xyz, mask=None, kernel_width: float = 0.25, max_dist: float = 3.0,
                    block: int = 512):
    """RBF-kernel-weighted neighbourhood mean and covariance per point
    (`covariance_estimation_rbf.cu:67-110`, FastVGICPCuda's
    GPU_RBF_KERNEL): every valid neighbour within `max_dist` weighs
    w = exp(-kernel_width * d^2); the weighted second moment about the
    weighted mean is the covariance. Blocked over queries.
    Returns (mean (N, 3), cov (N, 3, 3), sum_w (N,))."""
    q, r, bias, _ = _prepare(xyz, xyz, mask)
    md2 = max_dist * max_dist
    x = r[0]
    r2 = torch.stack([x[:, 0] * x[:, 0], x[:, 0] * x[:, 1], x[:, 0] * x[:, 2],
                      x[:, 1] * x[:, 1], x[:, 1] * x[:, 2], x[:, 2] * x[:, 2]], dim=-1)
    sw_parts, m1_parts, m2_parts = [], [], []
    for s in range(0, q.shape[1], block):
        d2 = _block_dists(q[:, s : s + block], r, bias)[0]
        w = torch.where(d2 <= md2, torch.exp(-kernel_width * d2), torch.zeros_like(d2))
        sw_parts.append(torch.sum(w, dim=-1))
        m1_parts.append(w @ x)  # weighted sum of positions
        m2_parts.append(w @ r2)  # weighted sum of the second moments
    sum_w, m1, m2 = torch.cat(sw_parts), torch.cat(m1_parts), torch.cat(m2_parts)
    sw = torch.clamp(sum_w, min=1e-12)
    mean = m1 / sw[:, None]
    exx = torch.stack([torch.stack([m2[:, 0], m2[:, 1], m2[:, 2]], -1),
                       torch.stack([m2[:, 1], m2[:, 3], m2[:, 4]], -1),
                       torch.stack([m2[:, 2], m2[:, 4], m2[:, 5]], -1)], dim=-2) / sw[:, None, None]
    return mean, exx - mean[:, :, None] * mean[:, None, :], sum_w
