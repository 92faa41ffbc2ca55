"""Ground segmentation: batched Patchwork++ (the Go-RIO variant).

Port of `gorio_tpu/estimators/groundseg.py`
(`include/patchworkpp/patchworkpp.hpp`):

  * CZM binning becomes a per-point (zone, ring, sector) -> patch id (Go-RIO's
    radar CZM: rings {4,4,2,2} x sectors {3,1,1,3} = 24 patches),
  * the per-patch R-GPF plane fits (`extract_piecewiseground`, `:1024-1127`)
    are masked segment sums of the covariance (sorted by patch and
    segmented, so the card repeats them to the bit) and one batched 3x3
    `eigh` over all patches, `num_iter` times (a repeated smallest
    eigenvalue gets a basis-free normal, `_eigh_smallest`),
  * seed selection (the lowest points of each patch) is a (P, N) masked
    `topk`,
  * the covariance-weighted whole-ground refinement (`estimate_plane_cov`,
    `:497-585`) is a few IRLS solves with the polar measurement covariance,
    each the smallest eigenvector of a 4x4 normal matrix,
  * under-ground multipath removal (`:867-879`) masks points more than 1 m
    below the refined plane.

The A-GLE / TGR thresholds (`:894-1010`) ride in an explicit per-ring
`AGLEState` that the caller threads through frames (`update_agle`).

Everything runs in the cloud's dtype on its device. The card's segmented
sums and cuSOLVER's `eigh` round differently from XLA's `segment_sum` and
LAPACK, so results on the card differ from the JAX package's in the last
bits.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.pointcloud import PointCloud, segment_sum_by_id
from .covariances import polar_covariances


class GroundSegConfig(NamedTuple):
    """Defaults mirror `patchworkpp.hpp` Params (`:126-167`, Go-RIO values)."""

    sensor_height: float = 0.7
    num_iter: int = 4
    num_lpr: int = 20
    num_min_pts: int = 10
    th_seeds: float = 0.5
    th_dist: float = 1.0
    max_range: float = 50.0
    min_range: float = 1.0
    uprightness_thr: float = 0.5
    adaptive_seed_selection_margin: float = -1.2
    num_zones: int = 4
    rings_per_zone: tuple = (4, 4, 2, 2)
    sectors_per_zone: tuple = (3, 1, 1, 3)
    enable_RNR: bool = True
    rnr_ver_angle_thr: float = -15.0
    rnr_intensity_thr: float = 0.1
    # Go-RIO radar height gate for ground candidates (`:1102,1106`)
    radar_height_gate: float = 0.5
    underground_dist: float = -1.0  # `:874`
    refine_iters: int = 3
    # A-GLE / TGR (`:244`: num_rings_of_interest_ = elevation_thr_.size();
    # `:986` line gate)
    num_rings_of_interest: int = 4
    line_variable_thresh: float = 8.0
    enable_TGR: bool = True

    @property
    def num_patches(self) -> int:
        return sum(r * s for r, s in zip(self.rings_per_zone, self.sectors_per_zone))

    @property
    def num_rings(self) -> int:
        return sum(self.rings_per_zone)


class GroundSegResult(NamedTuple):
    ground_mask: torch.Tensor  # (N,)
    nonground_mask: torch.Tensor  # (N,)
    removed_mask: torch.Tensor  # (N,) under-ground artifacts
    plane: torch.Tensor  # (4,) refined [nx, ny, nz, d], |n| = 1, nz > 0
    patch_normal: torch.Tensor  # (P, 3)
    patch_mean_z: torch.Tensor  # (P,)
    patch_valid: torch.Tensor  # (P,)
    patch_flatness: torch.Tensor  # (P,) smallest covariance eigenvalue of the fit
    patch_stored: torch.Tensor  # (P,) A-GLE storage mask (`:794-800`)


class AGLEState(NamedTuple):
    """Per-ring adaptive ground-likelihood state (`patchworkpp.hpp:894-950`):
    EMA-tracked per-ring moments (fixed memory) and the thresholds derived
    from them (elevation ring 0 = mean + 3 std and sensor_height = -mean,
    rings 1+ = mean + 2 std; flatness = mean + std). Shapes (R,)."""

    elevation_thr: torch.Tensor
    flatness_thr: torch.Tensor
    elev_mean: torch.Tensor
    elev_var: torch.Tensor
    flat_mean: torch.Tensor
    flat_var: torch.Tensor
    count: torch.Tensor
    sensor_height: torch.Tensor  # () NaN until ring 0 has data

    @staticmethod
    def init(dtype=torch.float64, rings: int = 4, cfg: Optional[GroundSegConfig] = None,
             device=None):
        if cfg is not None:
            rings = cfg.num_rings_of_interest
        cold_elev = 1.0 - (cfg.sensor_height if cfg is not None else 0.7)
        z = dict(dtype=dtype, device=device)
        return AGLEState(
            elevation_thr=torch.full((rings,), cold_elev, **z), flatness_thr=torch.zeros(rings, **z),
            elev_mean=torch.zeros(rings, **z), elev_var=torch.zeros(rings, **z),
            flat_mean=torch.zeros(rings, **z), flat_var=torch.zeros(rings, **z),
            count=torch.zeros(rings, **z), sensor_height=torch.tensor(math.nan, **z),
        )


def ring_of_patch(cfg: GroundSegConfig) -> np.ndarray:
    """Static (P,) concentric ring index per patch (the `concentric_idx`
    counter of `estimate_ground`'s zone/ring/sector loop, `:718-855`)."""
    out = np.zeros(cfg.num_patches, np.int64)
    offset, cring = 0, 0
    for z in range(cfg.num_zones):
        nr, ns = cfg.rings_per_zone[z], cfg.sectors_per_zone[z]
        for r in range(nr):
            out[offset + r * ns: offset + (r + 1) * ns] = cring + r
        offset += nr * ns
        cring += nr
    return out


def _zone_boundaries(cfg: GroundSegConfig):
    """The standard Patchwork++ radial zone split."""
    mn, mx = cfg.min_range, cfg.max_range
    return [mn, (7 * mn + mx) / 8.0, (3 * mn + mx) / 4.0, (mn + mx) / 2.0, mx]


def _patch_ids(xyz, cfg: GroundSegConfig):
    """(zone, ring, sector) -> flat patch id; out of range -> P (dropped)."""
    r = torch.linalg.norm(xyz[:, :2], dim=-1)
    theta = torch.atan2(xyz[:, 1], xyz[:, 0]) + math.pi  # [0, 2pi)
    bounds = _zone_boundaries(cfg)
    P = cfg.num_patches
    pid = torch.full((xyz.shape[0],), P, dtype=torch.int64, device=xyz.device)
    offset = 0
    for z in range(cfg.num_zones):
        lo, hi = bounds[z], bounds[z + 1]
        in_zone = (r >= lo) & (r < hi)
        nr, ns = cfg.rings_per_zone[z], cfg.sectors_per_zone[z]
        ring = torch.clamp(((r - lo) / (hi - lo) * nr).to(torch.int32), 0, nr - 1)
        sector = torch.clamp((theta / (2 * math.pi) * ns).to(torch.int32), 0, ns - 1)
        pid = torch.where(in_zone, (offset + ring * ns + sector).long(), pid)
        offset += nr * ns
    return pid


def _eigh_smallest(A):
    """Ascending eigenvalues of the symmetric (..., n, n) `A` and a unit
    vector of the eigenspace of the smallest one, on `A`'s device.

    Where the smallest eigenvalue is simple that vector is `eigh`'s own
    eigenvector. Where it is not (a patch of two points, or of collinear
    ones, has a rank-1 covariance; an empty one a multiple of the identity)
    every vector of the eigenspace is one, and LAPACK and cuSOLVER return
    different ones: the ground decisions, and over a long run the loop
    closures, follow. There the vector is the projection of an axis onto
    the eigenspace, which does not depend on the basis the solver picked:
    of z where the eigenspace holds z (two seeds of a patch then give the
    most horizontal plane through them), else of the first axis it holds;
    of x for a multiple of the identity (an empty fit: LAPACK's pick, whose
    plane through the origin no point of the patch lies near). Eigenvalues
    closer than 100 eps times the largest magnitude count as equal; an axis
    counts as held where its projection's squared norm passes 0.01."""
    evals, evecs = torch.linalg.eigh(A)
    lmax = torch.amax(torch.abs(evals), dim=-1, keepdim=True)
    tol = 100.0 * torch.finfo(A.dtype).eps * lmax
    same = (evals - evals[..., :1]) <= tol  # (..., n) the smallest eigenspace
    proj = (evecs * same[..., None, :]) @ evecs.transpose(-1, -2)  # its projector
    diag = torch.diagonal(proj, dim1=-2, dim2=-1)
    k = torch.argmax((diag > 0.01).to(torch.int8), dim=-1)  # the first axis it holds
    k = torch.where(diag[..., 2] > 0.01, 2, k)  # z before it
    k = torch.where(torch.all(same, dim=-1), 0, k)  # a multiple of the identity: x
    col = torch.take_along_dim(proj, k[..., None, None].expand(*proj.shape[:-1], 1), dim=-1)[..., 0]
    canon = col / torch.sqrt(torch.take_along_dim(diag, k[..., None], dim=-1))
    simple = torch.sum(same, dim=-1, keepdim=True) == 1
    return evals, torch.where(simple, evecs[..., :, 0], canon)


def _plane_from_masked(xyz, w, pid, P):
    """Per-patch PCA plane of the weighted points: normal (P,3), d (P,),
    mean (P,3), count (P,), ascending covariance eigenvalues (P,3)."""
    cnt = segment_sum_by_id(w, pid, P + 1)[:P]
    mean = segment_sum_by_id(xyz * w[:, None], pid, P + 1)[:P]
    mean = mean / torch.clamp(cnt, min=1.0)[:, None]
    centered = xyz - mean[torch.clamp(pid, 0, P - 1)]
    outer = centered[:, :, None] * centered[:, None, :] * w[:, None, None]
    cov = segment_sum_by_id(outer, pid, P + 1)[:P] / torch.clamp(cnt, min=1.0)[:, None, None]
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    evals, normal = _eigh_smallest(cov + 1e-12 * eye)
    normal = torch.where(normal[:, 2:3] < 0, -normal, normal)
    d = -torch.sum(normal * mean, dim=-1)
    return normal, d, mean, cnt, evals


def estimate_ground(cloud: PointCloud, cfg: GroundSegConfig = GroundSegConfig(),
                    agle: Optional[AGLEState] = None) -> GroundSegResult:
    xyz = cloud.xyz
    n = cloud.capacity
    dtype, device = xyz.dtype, xyz.device
    P = cfg.num_patches
    z = xyz[:, 2]

    # adaptive sensor height: ring-0 A-GLE re-estimates it each frame
    # (`:903-905`); NaN until warm -> the config value
    sh = torch.tensor(cfg.sensor_height, dtype=dtype, device=device)
    if agle is not None:
        sh = torch.where(torch.isfinite(agle.sensor_height), agle.sensor_height.to(dtype), sh)

    valid = cloud.mask
    if cfg.enable_RNR:  # steep-downward low-intensity returns (`:657`)
        r2d = torch.linalg.norm(xyz[:, :2], dim=-1)
        ver_deg = torch.rad2deg(torch.atan2(z, torch.clamp(r2d, min=1e-9)))
        noise = ((ver_deg < cfg.rnr_ver_angle_thr) & (cloud.intensity < cfg.rnr_intensity_thr)
                 & (z < -sh - 0.8))
        valid = valid & ~noise

    pid = torch.where(valid, _patch_ids(xyz, cfg), torch.full_like(z, P, dtype=torch.int64))
    pid_c = torch.clamp(pid, 0, P - 1)

    # ---- seeds: mean of the num_lpr lowest z per patch + th_seeds --------
    # adaptive seed margin (`:1177-1183`) and the Go-RIO radar height gate
    seed_ok = (z > cfg.adaptive_seed_selection_margin * sh) & (z < -sh + cfg.radar_height_gate)
    big = 1e9
    in_patch = pid[None, :] == torch.arange(P, device=device)[:, None]
    z_mat = torch.where(in_patch & seed_ok[None, :], z[None, :], torch.full_like(z, big))
    low_k = torch.topk(z_mat, cfg.num_lpr, dim=1, largest=False, sorted=True).values
    k_valid = low_k < big / 2
    lpr = (torch.sum(torch.where(k_valid, low_k, torch.zeros_like(low_k)), dim=1)
           / torch.clamp(torch.sum(k_valid, dim=1), min=1))
    ground = valid & seed_ok & (z < lpr[pid_c] + cfg.th_seeds) & (pid < P)

    # ---- R-GPF iterations (`:1024-1127`) --------------------------------
    for _ in range(cfg.num_iter):
        normal, dplane, mean, cnt, evals = _plane_from_masked(xyz, ground.to(dtype), pid, P)
        dist = torch.sum(normal[pid_c] * xyz, dim=-1) + dplane[pid_c]
        ground = (valid & (pid < P) & (torch.abs(dist) < cfg.th_dist)
                  & (z < -sh + cfg.radar_height_gate))
    if cfg.num_iter == 0:
        normal = torch.zeros((P, 3), dtype=dtype, device=device)
        mean, evals = torch.zeros_like(normal), torch.zeros_like(normal)
        cnt = torch.zeros((P,), dtype=dtype, device=device)

    # ---- patch classification (uprightness + per-ring elevation A-GLE)
    # and TGR: the decision chain of `:780-826` with the stats of `:756-760`
    flat = evals[:, 0]
    line_var = evals[:, 2] / torch.clamp(evals[:, 1], min=1e-12)
    heading_out = torch.sum(mean * normal, dim=-1) < 0.0
    upright = torch.abs(normal[:, 2]) > cfg.uprightness_thr
    enough = cnt >= cfg.num_min_pts

    R = cfg.num_rings_of_interest
    ring_idx = torch.as_tensor(ring_of_patch(cfg), device=device)
    near = ring_idx < R
    ring_roi = torch.clamp(ring_idx, 0, R - 1)
    if agle is not None:
        elev_thr_p = agle.elevation_thr.to(dtype)[ring_roi]
        flat_thr_p = agle.flatness_thr.to(dtype)[ring_roi]
    else:
        elev_thr_p = torch.full((P,), 1.0 - cfg.sensor_height, dtype=dtype, device=device)
        flat_thr_p = torch.zeros((P,), dtype=dtype, device=device)
    not_elev = mean[:, 2] < elev_thr_p
    is_flat = flat < flat_thr_p

    # A-GLE storage mask (`:794-800`)
    stored = upright & enough & not_elev & near
    patch_is_ground = upright & enough & (~near | (heading_out & (not_elev | is_flat)))
    candidate = upright & enough & near & heading_out & ~(not_elev | is_flat)

    if cfg.enable_TGR:
        # temporal ground revert (`:952-1010`): per-ring mean/std of this
        # frame's stored flatness, sigmoid revert probability, line gate
        zero = torch.zeros_like(flat)
        n_r = segment_sum_by_id(stored.to(dtype), ring_roi, R)
        f_mean = (segment_sum_by_id(torch.where(stored, flat, zero), ring_roi, R)
                  / torch.clamp(n_r, min=1.0))
        f_sq = segment_sum_by_id(
            torch.where(stored, (flat - f_mean[ring_roi]) ** 2, zero), ring_roi, R)
        f_std = torch.sqrt(f_sq / torch.clamp(n_r - 1.0, min=1.0))
        mu_p = (f_mean + 1.5 * f_std)[ring_roi]  # `:980`
        prob_flat = 1.0 / (1.0 + torch.exp((flat - mu_p) / torch.clamp(mu_p / 10.0, min=1e-12)))
        # big flat patches always revert (`:983`)
        prob_flat = torch.where((cnt > 1500.0) & (flat < cfg.th_dist ** 2),
                                torch.ones_like(prob_flat), prob_flat)
        prob_line = torch.where(line_var > cfg.line_variable_thresh, 0.0, 1.0).to(dtype)  # `:986`
        tgr_revert = candidate & (n_r[ring_roi] > 0) & (prob_line * prob_flat > 0.5)
        patch_is_ground = patch_is_ground | tgr_revert
    ground = ground & patch_is_ground[pid_c]

    # ---- Go-RIO whole-ground covariance-weighted refinement -------------
    cov_polar = polar_covariances(xyz)  # (N, 3, 3), the APDGICP model
    wg = ground.to(dtype)
    n_g = torch.clamp(torch.sum(wg), min=1.0)
    gmean = torch.sum(xyz * wg[:, None], dim=0) / n_g
    gc = (xyz - gmean) * wg[:, None]
    gcov = gc.T @ gc / n_g
    _, nvec = _eigh_smallest(gcov + 1e-12 * torch.eye(3, dtype=dtype, device=device))
    nvec = torch.where(nvec[2] < 0, -nvec, nvec)
    plane = torch.cat([nvec, -(nvec @ gmean)[None]])
    A = torch.cat([xyz, torch.ones((n, 1), dtype=dtype, device=device)], dim=1)
    eye4 = torch.eye(4, dtype=dtype, device=device)
    for _ in range(cfg.refine_iters):
        nv = plane[:3]
        sig2 = torch.einsum("i,nij,j->n", nv, cov_polar, nv) + 1e-6
        wts = wg / sig2
        # homogeneous weighted LSQ on (n, d): the smallest eigenvector of
        # A^T W A, renormalized (Gauss-Newton on the normalized cost)
        H = A.T @ (A * wts[:, None])
        _, sol = _eigh_smallest(H + 1e-9 * eye4)
        sol = sol / torch.clamp(torch.linalg.norm(sol[:3]), min=1e-12)
        plane = torch.where(sol[2] < 0, -sol, sol)

    # ---- under-ground multipath removal (`:867-879`) --------------------
    signed = xyz @ plane[:3] + plane[3]
    removed = valid & (signed < cfg.underground_dist)
    ground_final = ground & ~removed
    return GroundSegResult(
        ground_mask=ground_final,
        nonground_mask=valid & ~ground_final & ~removed,
        removed_mask=removed | (cloud.mask & ~valid),
        plane=plane,
        patch_normal=normal,
        patch_mean_z=mean[:, 2],
        patch_valid=patch_is_ground,
        patch_flatness=flat,
        patch_stored=stored,
    )


def update_agle(state: AGLEState, result: GroundSegResult,
                cfg: GroundSegConfig = GroundSegConfig(), decay: float = 0.95) -> AGLEState:
    """Per-ring EMA counterpart of the reference's elevation / flatness
    storage (`update_elevation_thr`, `:894-922`; `update_flatness_thr`,
    `:925-950`). Rings with no stored patch this frame keep their state."""
    R = cfg.num_rings_of_interest
    dtype, device = state.elev_mean.dtype, state.elev_mean.device
    ring_idx = torch.as_tensor(ring_of_patch(cfg), device=device)
    ring_roi = torch.clamp(ring_idx, 0, R - 1)
    stored = result.patch_stored & (ring_idx < R)

    def ring_stats(vals):
        vals = vals.to(dtype)
        zero = torch.zeros_like(vals)
        n_r = segment_sum_by_id(stored.to(dtype), ring_roi, R)
        m = (segment_sum_by_id(torch.where(stored, vals, zero), ring_roi, R)
             / torch.clamp(n_r, min=1.0))
        sq = segment_sum_by_id(
            torch.where(stored, (vals - m[ring_roi]) ** 2, zero), ring_roi, R)
        return n_r, m, sq / torch.clamp(n_r, min=1.0)

    n_r, em, ev = ring_stats(result.patch_mean_z)
    _, fm, fv = ring_stats(result.patch_flatness)
    has = n_r > 0
    blend = torch.where(state.count > 0, decay, 0.0).to(dtype)

    def ema(old, new):
        return torch.where(has, blend * old + (1.0 - blend) * new, old)

    elev_mean, elev_var = ema(state.elev_mean, em), ema(state.elev_var, ev)
    flat_mean, flat_var = ema(state.flat_mean, fm), ema(state.flat_var, fv)
    count = state.count + has.to(dtype)
    k_elev = torch.where(torch.arange(R, device=device) == 0, 3.0, 2.0).to(dtype)
    return AGLEState(
        elevation_thr=torch.where(count > 0, elev_mean + k_elev * torch.sqrt(elev_var),
                                  state.elevation_thr),
        flatness_thr=torch.where(count > 0, flat_mean + torch.sqrt(flat_var), state.flatness_thr),
        elev_mean=elev_mean, elev_var=elev_var, flat_mean=flat_mean, flat_var=flat_var,
        count=count,
        sensor_height=torch.where(count[0] > 0, -elev_mean[0], state.sensor_height),
    )
