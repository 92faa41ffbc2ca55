"""Intensity Scan Context as tensor ops.

Port of `gorio_tpu/loopclosure/scancontext.py` (`SCManager`,
`Scancontext.cpp`): the 40-ring x 20-sector max-intensity polar descriptor is
a `scatter_reduce("amax")` into a -inf-filled buffer, the ring-key search is a
batched L2 distance against the whole database, and the shifted cosine
distance evaluates all sector shifts in one gather.

Ties follow the JAX package: the candidate search keeps the lower database
index first among equal ring-key distances (ineligible entries are all
+inf, so they tie), and the best shift is the first one at the minimum.
`torch.topk` promises no order among equal values, so the searches sort
with `stable=True` instead.

Every search is batched over queries: `search` takes (B, R, S) query
descriptors, one database count per query (query i may only match entries
below count_i - num_exclude_recent) and optional (B, C) candidate masks.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core.pointcloud import PointCloud


class ScanContextConfig(NamedTuple):
    """Defaults mirror `Scancontext.h:108-130`."""

    num_ring: int = 40
    num_sector: int = 20
    max_radius: float = 80.0
    azimuth_max_deg: float = 56.5  # radar FOV
    lidar_height: float = 1.2
    num_exclude_recent: int = 10
    num_candidates: int = 3
    dist_threshold: float = 0.5


def make_scancontext(cloud: PointCloud, cfg: ScanContextConfig = ScanContextConfig()):
    """Descriptor (num_ring, num_sector): max intensity per polar bin, 0 for
    empty bins. Parity: `makeScancontext` (`Scancontext.cpp:160-215`),
    including the atan2(x, y) - pi/2 azimuth and ceil-based 1-indexed bins."""
    R, S = cfg.num_ring, cfg.num_sector
    x, y = cloud.xyz[:, 0], cloud.xyz[:, 1]
    rng = torch.sqrt(x * x + y * y)
    azim_deg = torch.rad2deg(torch.atan2(x, y) - math.pi / 2)
    ok = cloud.mask & (torch.abs(azim_deg) <= cfg.azimuth_max_deg) & (rng <= cfg.max_radius)
    ring = torch.clamp(torch.ceil(rng / cfg.max_radius * R).to(torch.int32), 1, R) - 1
    sector = torch.clamp(
        torch.ceil((azim_deg + cfg.azimuth_max_deg) / (2 * cfg.azimuth_max_deg) * S)
        .to(torch.int32), 1, S,
    ) - 1
    flat = torch.where(ok, ring * S + sector, torch.full_like(ring, R * S)).long()
    inten = torch.where(ok, cloud.intensity, torch.full_like(cloud.intensity, -math.inf))
    buf = torch.full((R * S + 1,), -math.inf, dtype=inten.dtype, device=inten.device)
    desc = buf.scatter_reduce(0, flat, inten, "amax")[: R * S]
    desc = torch.where(torch.isfinite(desc), desc, torch.zeros_like(desc))
    return desc.reshape(R, S)


def ring_key(desc):
    """Row-wise mean (`makeRingkeyFromScancontext`)."""
    return torch.mean(desc, dim=-1)


def sector_key(desc):
    """Column-wise mean (`makeSectorkeyFromScancontext`)."""
    return torch.mean(desc, dim=-2)


def _norm(x, dim):
    return torch.sqrt(torch.sum(x * x, dim=dim))


def sc_distance(desc1, desc2):
    """Min over all sector shifts of the column-wise cosine distance.
    Parity: `distanceBtnScanContext` + `distDirectSC`
    (`Scancontext.cpp:104-159`), brute force over every shift. desc1, desc2
    (..., R, S), broadcast against each other -> (dist (...), shift (...))."""
    S = desc1.shape[-1]
    ar = torch.arange(S, device=desc2.device)
    cols = (ar[None, :] - ar[:, None]) % S  # shift k: column j <- column (j - k) mod S
    d2s = desc2[..., cols]  # (..., R, K, S)
    dots = torch.sum(desc1[..., :, None, :] * d2s, dim=-3)  # (..., K, S)
    n1 = _norm(desc1, -2)[..., None, :]  # (..., 1, S)
    n2 = _norm(d2s, -3)  # (..., K, S)
    eff = (n1 > 0) & (n2 > 0)
    sim = torch.where(eff, dots / torch.clamp(n1 * n2, min=1e-12), torch.zeros_like(dots))
    n_eff = torch.clamp(torch.sum(eff, dim=-1), min=1)
    dist = 1.0 - torch.sum(sim, dim=-1) / n_eff
    best = torch.argmin(dist, dim=-1)  # first shift at the minimum
    return torch.gather(dist, -1, best[..., None])[..., 0], best


class ScanContextDB(NamedTuple):
    """Fixed-capacity descriptor database on the device (replaces the
    kd-tree + vectors). `count` is a host int."""

    descs: torch.Tensor  # (C, R, S)
    ring_keys: torch.Tensor  # (C, R)
    count: int

    @staticmethod
    def create(capacity: int, cfg: ScanContextConfig = ScanContextConfig(),
               dtype=torch.float32, device=None):
        return ScanContextDB(
            descs=torch.zeros((capacity, cfg.num_ring, cfg.num_sector), dtype=dtype,
                              device=device),
            ring_keys=torch.zeros((capacity, cfg.num_ring), dtype=dtype, device=device),
            count=0,
        )

    def add(self, desc):
        """Store `desc` at index `count`, in place: every search reads only
        entries below its own count, so a reader holding this DB never sees
        the write. Past capacity, `grow()` first."""
        i = self.count
        if i >= self.descs.shape[0]:
            raise IndexError(f"ScanContextDB is full ({i} entries): grow() it first")
        self.descs[i] = desc
        self.ring_keys[i] = ring_key(desc)
        return self._replace(count=i + 1)

    def grow(self, factor: int = 2):
        """A copy with `factor` times the capacity (new tensors: a reader of
        the old DB keeps the old ones)."""
        reps = factor - 1
        return ScanContextDB(
            descs=torch.cat([self.descs] + [torch.zeros_like(self.descs)] * reps, dim=0),
            ring_keys=torch.cat([self.ring_keys] + [torch.zeros_like(self.ring_keys)] * reps,
                                dim=0),
            count=self.count,
        )


class SearchResult(NamedTuple):
    """Per query: the `num_candidates` ring-key candidates, ordered by
    ring-key distance, with their shifted-cosine distances (+inf for an
    ineligible candidate) and best shifts."""

    cand: torch.Tensor  # (B, nc) int64
    dists: torch.Tensor  # (B, nc)
    shifts: torch.Tensor  # (B, nc) int64


def search(db: ScanContextDB, query_descs, counts, cfg: ScanContextConfig = ScanContextConfig(),
           cand_masks=None) -> SearchResult:
    """Batched ring-key candidate search + shifted-cosine verification:
    query b sees database entries below max(counts[b] - num_exclude_recent,
    0), restricted to `cand_masks[b]` when given (`detect_loop`'s
    cand_mask). query_descs (B, R, S), counts (B,) -> SearchResult."""
    qk = ring_key(query_descs)  # (B, R)
    n = db.ring_keys.shape[0]
    idxs = torch.arange(n, device=qk.device)
    counts = torch.as_tensor(counts, device=qk.device)
    eligible = idxs[None, :] < torch.clamp(counts - cfg.num_exclude_recent, min=0)[:, None]
    if cand_masks is not None:
        eligible = eligible & cand_masks
    d2 = torch.sum((db.ring_keys[None, :, :] - qk[:, None, :]) ** 2, dim=-1)  # (B, C)
    d2 = torch.where(eligible, d2, torch.full_like(d2, math.inf))
    # lax.top_k(-d2): the smallest first, the lower index first among equals
    d2_sorted, order = torch.sort(d2, dim=-1, stable=True)
    cand = order[:, : cfg.num_candidates]
    dists, shifts = sc_distance(query_descs[:, None], db.descs[cand])
    dists = torch.where(torch.isinf(d2_sorted[:, : cfg.num_candidates]),
                        torch.full_like(dists, math.inf), dists)
    return SearchResult(cand=cand, dists=dists, shifts=shifts)


def _yaw(shift, cfg: ScanContextConfig, dtype):
    """Sector shift -> yaw (rad) over the limited FOV."""
    sector_angle = 2 * cfg.azimuth_max_deg / cfg.num_sector
    half = cfg.num_sector // 2
    signed = torch.where(shift > half, shift - cfg.num_sector, shift)
    return torch.deg2rad(signed.to(dtype) * sector_angle)


def best_match(res: SearchResult, cfg: ScanContextConfig, dtype):
    """`detect_loop`'s pick from a search: (match (B,) int64, -1 if none;
    yaw (B,); dist (B,))."""
    best = torch.argmin(res.dists, dim=-1, keepdim=True)
    dist = torch.gather(res.dists, -1, best)[:, 0]
    match = torch.where(dist < cfg.dist_threshold, torch.gather(res.cand, -1, best)[:, 0],
                        torch.full_like(best[:, 0], -1))
    return match, _yaw(torch.gather(res.shifts, -1, best)[:, 0], cfg, dtype), dist


def top_matches(res: SearchResult, cfg: ScanContextConfig, dtype, k: int = 2):
    """`detect_loop_topk`'s pick: the best min(k, num_candidates) by
    distance (stable: the earlier candidate first among equals), -1 where
    above the threshold. Returns (matches (B, k'), yaws (B, k'), dists)."""
    _, order = torch.sort(res.dists, dim=-1, stable=True)
    order = order[:, : min(k, cfg.num_candidates)]
    top_d = torch.gather(res.dists, -1, order)
    matches = torch.where(top_d < cfg.dist_threshold, torch.gather(res.cand, -1, order),
                          torch.full_like(order, -1))
    return matches, _yaw(torch.gather(res.shifts, -1, order), cfg, dtype), top_d


def detect_loop(db: ScanContextDB, query_desc, cfg: ScanContextConfig = ScanContextConfig(),
                cand_mask=None):
    """Best loop candidate for one query descriptor among the first
    `db.count` entries. Parity: `detectLoopClosureID`
    (`Scancontext.cpp:272-374`) with the JAX package's in-search gating
    (`cand_mask`). Returns (match (-1 if none), yaw_diff_rad, distance) as
    0-dim tensors."""
    res = search(db, query_desc[None], [db.count], cfg,
                 None if cand_mask is None else cand_mask[None])
    match, yaw, dist = best_match(res, cfg, query_desc.dtype)
    return match[0], yaw[0], dist[0]


def detect_loop_topk(db: ScanContextDB, query_desc, cfg: ScanContextConfig = ScanContextConfig(),
                     cand_mask=None, k: int = 2):
    """Top-`k` loop candidates of one query by full shifted-cosine distance,
    best first; entries above the threshold are -1. Returns (matches (k,),
    yaws (k,), dists (k,))."""
    res = search(db, query_desc[None], [db.count], cfg,
                 None if cand_mask is None else cand_mask[None])
    matches, yaws, dists = top_matches(res, cfg, query_desc.dtype, k)
    return matches[0], yaws[0], dists[0]


# ---- observability: descriptor images (numpy; copied from the JAX package)


def sc_image(desc, upscale: int = 8) -> np.ndarray:
    """uint8 grayscale image of one descriptor (rings x sectors), intensity
    normalized to 0-255 and nearest-neighbor upscaled for visibility."""
    d = np.asarray(desc.cpu() if isinstance(desc, torch.Tensor) else desc, dtype=np.float64)
    rng = d.max() - d.min()
    img = np.zeros_like(d) if rng <= 0 else (d - d.min()) / rng
    img = (img * 255.0).astype(np.uint8)
    return np.kron(img, np.ones((upscale, upscale), np.uint8))


def sc_pair_image(desc_cur, desc_prev, upscale: int = 8) -> np.ndarray:
    """The two matched descriptors stacked with a separator row (the
    cur/prev Scan-Context images the reference publishes on a loop)."""
    a = sc_image(desc_cur, upscale)
    b = sc_image(desc_prev, upscale)
    sep = np.full((2, a.shape[1]), 255, np.uint8)
    return np.concatenate([a, sep, b], axis=0)


def save_pgm(path, img: np.ndarray) -> None:
    """Dependency-free binary PGM writer for the images above."""
    img = np.asarray(img, np.uint8)
    with open(path, "wb") as fh:
        fh.write(f"P5\n{img.shape[1]} {img.shape[0]}\n255\n".encode())
        fh.write(img.tobytes())
