"""NDT (normal distributions transform) registration: P2D, coarse-to-fine
and D2D.

Port of `gorio_tpu/registration/ndt.py` (`pclomp::NormalDistributionsTransform`
+ `VoxelGridCovariance`, `NDTCuda`): the voxel Gaussian map is one stable
sort and segment reduce (mean and covariance per voxel, eigenvalue
inflation), with a dense linear-cell table so that each correspondence is
two gathers (the table cell and a 16-column packed payload row that carries
the voxel key for verification); the DIRECT1/7/27 and KDTREE neighbourhoods
are fixed voxel offsets. The Newton loop is the JAX package's: the
closed-form derivatives reduced by one (48, N*O) x (N*O,) product, a
Gershgorin-damped solve, an 11-candidate step search scored on a stride-4
subsample, 3 frozen-correspondence inner steps per gather.

The JAX `lax.while_loop` becomes a Python loop with the same bound and
stop test; the inner steps stay on the device (`torch.where` accept masks)
and the host reads one stop flag per outer iteration. The computation runs
in the promoted dtype of the pose and the cloud (a float64 guess on a
float32 scan runs in float64), as the port's LM does. Plain torch: NDT is
XLA code in the JAX package, not a Pallas kernel. `ndt_align_with_map` and
`ndt_align_multires` also align B sources along a leading axis against one
map pair, with per-lane stop flags (the JAX package's `jax.vmap` of them).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.func

from ..core import lie
from ..core.linalg import inv3, sym_eigh3
from ..core.pointcloud import VOXEL_BITS, VOXEL_SENTINEL, PointCloud, masked_min_corner, \
    pack_voxel_key, segment_reduce, segment_runs, segment_sum
from .gicp import _transform
from .lsq import LMResult


class NDTConfig(NamedTuple):
    """Defaults mirror `ndt_omp.h` / `ndt_omp_impl.hpp` and the align app."""

    resolution: float = 1.0
    outlier_ratio: float = 0.55
    step_size: float = 0.1
    max_iterations: int = 35
    transformation_epsilon: float = 1e-4
    min_points_per_voxel: int = 6
    eig_mult: float = 0.01  # min_covar_eigvalue_mult_
    neighborhood: str = "direct7"  # "direct1" | "direct7" | "direct27" | "kdtree"
    voxel_capacity: int = 8192
    # dense lookup-table cells; scenes whose occupied bounding box exceeds
    # this wrap (collisions verify against the key and read as misses)
    table_size: int = 1 << 21
    # coarse-to-fine schedule (`ndt_align_multires`): a short pass on a
    # `coarse_scale`x-resolution map, then a capped fine pass
    coarse_scale: float = 2.0
    coarse_iterations: int = 4
    coarse_neighborhood: str = "direct1"
    fine_iterations: int = 8


class VoxelGaussianMap(NamedTuple):
    keys: torch.Tensor  # (V,) sorted int32 voxel keys (padding = sentinel)
    means: torch.Tensor  # (V, 3)
    inv_covs: torch.Tensor  # (V, 3, 3)
    valid: torch.Tensor  # (V,)
    origin: torch.Tensor  # (3,) grid origin shared by the queries
    table: torch.Tensor  # (T+1,) int32 voxel index per linear cell, -1 = empty
    table_dims: torch.Tensor  # (2,) int32 [dy, dz] linearisation strides, on the device
    # per voxel [mu (3), c00, c01, c02, c11, c12, c22, key_hi, key_lo, 0...]
    packed: torch.Tensor  # (V, 16)


def _point_ijk(xyz, resolution, origin):
    ijk = torch.floor((xyz - origin) / resolution).to(torch.int32)
    return torch.clamp(ijk, 1, (1 << VOXEL_BITS) - 2)  # 1-voxel margin for the neighbours


def _linear_cell(ijk, table_dims, table_size):
    """The table cell of voxel `ijk` (int32); floor-mod keeps it in
    [0, table_size)."""
    dy, dz = table_dims[0], table_dims[1]
    return torch.remainder((ijk[..., 0] * dy + ijk[..., 1]) * dz + ijk[..., 2], table_size)


def _voxel_table(keys_sorted, valid_sorted, table_size):
    """Dense table over the occupied bounding box: voxel index per linear
    cell, -1 empty, invalid voxels dumped in slot `table_size`. Where two
    voxels share a cell the larger index wins (`amax`: deterministic, and
    XLA's scatter keeps the last write), and the loser reads as a miss
    through the key check. Returns (table, table_dims)."""
    take = keys_sorted.shape[0]
    mask10 = (1 << VOXEL_BITS) - 1
    ki = keys_sorted >> (2 * VOXEL_BITS)
    kj = (keys_sorted >> VOXEL_BITS) & mask10
    kk = keys_sorted & mask10
    zero = torch.zeros_like(kj)
    dy = torch.amax(torch.where(valid_sorted, kj, zero)) + 2
    dz = torch.amax(torch.where(valid_sorted, kk, zero)) + 2
    dims = torch.stack([dy, dz])
    lin = _linear_cell(torch.stack([ki, kj, kk], -1), dims, table_size)
    slot = torch.where(valid_sorted, lin, torch.full_like(lin, table_size)).long()
    table = torch.full((table_size + 1,), -1, dtype=torch.int32, device=keys_sorted.device)
    idx = torch.arange(take, dtype=torch.int32, device=keys_sorted.device)
    return table.scatter_reduce_(0, slot, idx, "amax", include_self=True), dims


def _voxel_runs(cloud: PointCloud, resolution, origin):
    """Sort the points by voxel key: (order, segment ids, segment bounds,
    the sorted mask as weights, per-segment counts, per-segment keys)."""
    n = cloud.capacity
    ijk = _point_ijk(cloud.xyz, resolution, origin)
    sentinel = torch.full_like(cloud.mask, VOXEL_SENTINEL, dtype=torch.int32)
    key = torch.where(cloud.mask, pack_voxel_key(ijk), sentinel)
    order, key_s, seg, bounds = segment_runs(key)
    mask_s = cloud.mask[order]
    w = mask_s.to(cloud.xyz.dtype)
    cnt = segment_sum(w, bounds)
    head_key = segment_reduce(torch.where(mask_s, key_s, torch.full_like(key_s, VOXEL_SENTINEL)),
                              seg, n, "amin", VOXEL_SENTINEL)
    return order, seg, bounds, w, cnt, head_key


def _sorted_voxels(head_key, valid, take):
    """Keep the first `take` segments, valid ones sorted by key (stable):
    (order2, sorted keys, sorted valid)."""
    keys_out = torch.where(valid, head_key, torch.full_like(head_key, VOXEL_SENTINEL))[:take]
    order2 = torch.argsort(keys_out, stable=True)
    return order2, keys_out[order2], valid[:take][order2]


def build_voxel_map(cloud: PointCloud, cfg: NDTConfig = NDTConfig()) -> VoxelGaussianMap:
    """`VoxelGridCovariance::applyFilter`: per-voxel mean and covariance
    with eigenvalue inflation and the min-point gate. Everything stays on
    the cloud's device; no host read."""
    n = cloud.capacity
    dtype, dev = cloud.xyz.dtype, cloud.xyz.device
    origin = masked_min_corner(cloud.xyz, cloud.mask, pad=2.0 * cfg.resolution)
    order, seg, bounds, w, cnt, head_key = _voxel_runs(cloud, cfg.resolution, origin)
    xyz_s = cloud.xyz[order]
    mean = segment_sum(xyz_s * w[:, None], bounds) / torch.clamp(cnt, min=1.0)[:, None]
    centered = (xyz_s - mean[seg]) * w[:, None]
    cov = segment_sum(centered[:, :, None] * centered[:, None, :], bounds)
    cov = cov / torch.clamp(cnt - 1.0, min=1.0)[:, None, None]
    valid = cnt >= cfg.min_points_per_voxel

    # eigenvalue inflation (`voxel_grid_covariance_omp_impl.hpp`), closed form
    eye = torch.eye(3, dtype=dtype, device=dev)
    evals, evecs = sym_eigh3(cov + 1e-12 * eye)
    evals_inf = torch.maximum(evals, cfg.eig_mult * evals[:, 2:3])
    cov_inf = torch.einsum("vij,vj,vkj->vik", evecs, evals_inf, evecs)
    inv_cov = inv3(cov_inf + 1e-9 * eye)

    take = min(cfg.voxel_capacity, n)
    order2, keys_sorted, valid_sorted = _sorted_voxels(head_key, valid, take)
    table, dims = _voxel_table(keys_sorted, valid_sorted, cfg.table_size)
    means_s = mean[:take][order2]
    inv_s = inv_cov[:take][order2]
    # the voxel key in two float-exact halves (< 2^15 each): verification
    # then needs only the packed-row gather
    key_chk = torch.where(valid_sorted, keys_sorted, torch.full_like(keys_sorted, VOXEL_SENTINEL))
    packed = torch.zeros((take, 16), dtype=dtype, device=dev)
    packed[:, 0:3] = means_s
    packed[:, 3:9] = torch.stack([inv_s[:, 0, 0], inv_s[:, 0, 1], inv_s[:, 0, 2],
                                  inv_s[:, 1, 1], inv_s[:, 1, 2], inv_s[:, 2, 2]], -1)
    packed[:, 9] = (key_chk >> 15).to(dtype)
    packed[:, 10] = (key_chk & 0x7FFF).to(dtype)
    return VoxelGaussianMap(keys=keys_sorted, means=means_s, inv_covs=inv_s, valid=valid_sorted,
                            origin=origin, table=table, table_dims=dims, packed=packed)


_NEIGHBOR_OFFSETS = {
    "direct1": [(0, 0, 0)],
    "direct7": [(0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1)],
    "direct27": [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
    # KDTREE mode (`ndt_omp_impl.hpp:234-235`): radius search over the voxel
    # centroids with radius = resolution; the 27 neighbours plus the
    # centroid-distance gate of `_neighbor_gate`
    "kdtree": [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
}


def _offsets(cfg, device):
    """(O, 3) int32 voxel offsets of the neighbourhood. Made once per call:
    an upload from the host waits for the card."""
    return torch.tensor(_NEIGHBOR_OFFSETS[cfg.neighborhood], dtype=torch.int32, device=device)


def _neighbor_gate(found, query_xyz, mu, cfg: NDTConfig):
    """The centroid-radius gate of the KDTREE mode; identity for DIRECT."""
    if cfg.neighborhood != "kdtree":
        return found
    d2 = torch.sum((query_xyz[:, None, :] - mu) ** 2, dim=-1)
    return found & (d2 <= cfg.resolution ** 2)


def _gauss_coeffs(cfg: NDTConfig):
    """d1, d2 from the outlier ratio and resolution (`ndt_omp_impl.hpp:55-77`),
    as float64 Python numbers."""
    gauss_c1 = 10.0 * (1.0 - cfg.outlier_ratio)
    gauss_c2 = cfg.outlier_ratio / (cfg.resolution ** 3)
    gauss_d3 = -math.log(gauss_c2)
    d1 = -math.log(gauss_c1 + gauss_c2) - gauss_d3
    d2 = -2.0 * math.log((-math.log(gauss_c1 * math.exp(-0.5) + gauss_c2) - gauss_d3) / d1)
    return d1, d2


def _lookup(vmap_keys, query_keys):
    """Sorted-key exact lookup (binary search): (idx, found)."""
    pos = torch.searchsorted(vmap_keys, query_keys)
    pos = torch.clamp(pos, 0, vmap_keys.shape[0] - 1)
    return pos, vmap_keys[pos] == query_keys


def _table_lookup(keys, table, table_dims, table_size, ijk):
    """One-gather voxel lookup through the dense table; collisions and
    out-of-box cells verify against `keys` and read as misses. ijk (..., 3)
    int32 -> (idx (...) int64, found)."""
    idx = table[_linear_cell(ijk, table_dims, table_size).long()].long()
    found = idx >= 0
    idx = torch.where(found, idx, torch.zeros_like(idx))
    return idx, found & (keys[idx] == pack_voxel_key(ijk))


def ndt_score(source: PointCloud, vmap: VoxelGaussianMap, T, cfg: NDTConfig = NDTConfig(),
              offsets=None):
    """Summed NDT score (negated likelihood; lower is better) of `source`
    under the target map at pose T."""
    d1, d2 = _gauss_coeffs(cfg)
    moved = _transform(source.xyz, T)[0]
    ijk = _point_ijk(moved, cfg.resolution, vmap.origin)
    if offsets is None:
        offsets = _offsets(cfg, moved.device)
    idx, found = _table_lookup(vmap.keys, vmap.table, vmap.table_dims, cfg.table_size,
                               ijk[:, None, :] + offsets[None])
    found = found & vmap.valid[idx] & source.mask[:, None]
    mu = vmap.means[idx].to(moved.dtype)
    found = _neighbor_gate(found, moved, mu, cfg)
    diff = moved[:, None, :] - mu  # (N, O, 3)
    md2 = torch.einsum("noi,noij,noj->no", diff, vmap.inv_covs[idx].to(moved.dtype), diff)
    score = d1 * torch.exp(-0.5 * d2 * md2)
    return torch.sum(torch.where(found, score, torch.zeros_like(score)))


def _unpack(P):
    """Packed rows -> (mu (..., 3), C (..., 3, 3))."""
    c00, c01, c02, c11, c12, c22 = (P[..., k] for k in range(3, 9))
    C = torch.stack([torch.stack([c00, c01, c02], -1), torch.stack([c01, c11, c12], -1),
                     torch.stack([c02, c12, c22], -1)], -2)
    return P[..., 0:3], C


def _unpack6(P):
    """Packed rows -> (mu (..., 3), inverse-covariance components (xx, yy,
    zz, xy, xz, yz))."""
    return P[..., 0:3], (P[..., 3], P[..., 6], P[..., 8], P[..., 4], P[..., 5], P[..., 7])


def _gather_correspondences(source, vmap, T, cfg, offsets=None):
    """Neighbour-voxel gather at pose T: (found, mu, c6), each (N, O, ...),
    in the dtype of the moved points. Two random gathers per
    correspondence: the table cell and the packed row (whose key halves
    verify the match)."""
    moved = _transform(source.xyz, T)[0]
    if offsets is None:
        offsets = _offsets(cfg, moved.device)
    ijk = _point_ijk(moved, cfg.resolution, vmap.origin)[:, None, :] + offsets[None]
    key = pack_voxel_key(ijk)
    idx = vmap.table[_linear_cell(ijk, vmap.table_dims, cfg.table_size).long()].long()
    found = idx >= 0
    P = vmap.packed[torch.where(found, idx, torch.zeros_like(idx))]  # (N, O, 16)
    found = found & (P[..., 9] == (key >> 15).to(P.dtype)) & \
        (P[..., 10] == (key & 0x7FFF).to(P.dtype))
    found = found & source.mask[:, None]
    P = P.to(moved.dtype)
    mu, c6 = _unpack6(P)
    return _neighbor_gate(found, moved, mu, cfg), mu, c6


def _md2_comp(moved, mu, c):
    """Mahalanobis x^T C x in component form; moved ([K,] N, 3) broadcasts
    over the neighbour axis of mu / c (N, O, ...)."""
    e0 = moved[..., :, None, 0] - mu[..., 0]
    e1 = moved[..., :, None, 1] - mu[..., 1]
    e2 = moved[..., :, None, 2] - mu[..., 2]
    xx, yy, zz, xy, xz, yz = c
    q0 = xx * e0 + xy * e1 + xz * e2
    q1 = xy * e0 + yy * e1 + yz * e2
    q2 = xz * e0 + yz * e1 + zz * e2
    return e0 * q0 + e1 * q1 + e2 * q2, (e0, e1, e2), (q0, q1, q2)


def _score_cached(source, found, mu, c6, d1, d2, T):
    """Frozen-correspondence score at T, or at each of K poses T (K, 4, 4)
    -> (K,)."""
    md2, _, _ = _md2_comp(_transform(source.xyz, T)[0], mu, c6)
    s = d1 * torch.exp(-0.5 * d2 * md2)
    return torch.sum(torch.where(found, s, torch.zeros_like(s)), dim=(-2, -1))


_UU = [[0, 1, 2, 3, 4, 5], [1, 6, 7, 8, 9, 10], [2, 7, 11, 12, 13, 14],
       [3, 8, 12, 15, 16, 17], [4, 9, 13, 16, 18, 19], [5, 10, 14, 17, 19, 20]]


def _derivatives(xyz, found, mu, c6, T, d1, d2, iu):
    """Score, g (6,) and H (6, 6) of the summed score at T (left-multiplied
    delta), in closed component form: 48 columns over (N, O) reduced by one
    matrix-vector product (`ndt.py:364-439` of the JAX package; the
    rotation-curvature term is dropped, Gauss-Newton flavour). `iu` is
    `_UU` on the device."""
    moved = _transform(xyz, T)[0]
    md2, _, (q0, q1, q2) = _md2_comp(moved, mu, c6)
    e = torch.exp(-0.5 * d2 * md2)
    zero = torch.zeros_like(e)
    coef = torch.where(found, -d2 * d1 * e, zero)  # > 0 per matched pair
    score = torch.sum(torch.where(found, d1 * e, zero))
    m0, m1, m2 = moved[:, None, 0], moved[:, None, 1], moved[:, None, 2]
    xx, yy, zz, xy, xz, yz = c6
    # u = J^T C x with J = [-hat(m) | I]: u_rot = m x q, u_t = q
    u = (m1 * q2 - m2 * q1, m2 * q0 - m0 * q2, m0 * q1 - m1 * q0, q0, q1, q2)

    def crossc(a0, a1, a2):
        return (m1 * a2 - m2 * a1, m2 * a0 - m0 * a2, m0 * a1 - m1 * a0)

    W0, W1, W2 = crossc(xx, xy, xz), crossc(xy, yy, yz), crossc(xz, yz, zz)

    def rr_col(i):
        return (-m2 * W1[i] + m1 * W2[i], m2 * W0[i] - m0 * W2[i], -m1 * W0[i] + m0 * W1[i])

    r0, r1, r2 = rr_col(0), rr_col(1), rr_col(2)
    cols = torch.stack(
        [r0[0], r1[1], r2[2], r1[0], r2[0], r2[1],
         W0[0], W1[0], W2[0], W0[1], W1[1], W2[1], W0[2], W1[2], W2[2],
         xx, yy, zz, xy, xz, yz, *u]
        + [u[i] * u[j] for i in range(6) for j in range(i, 6)],
        dim=0,
    )  # (48, N, O)
    s = cols.reshape(48, -1) @ coef.reshape(-1)
    rr_m = torch.stack([torch.stack([s[0], s[3], s[4]]), torch.stack([s[3], s[1], s[5]]),
                        torch.stack([s[4], s[5], s[2]])])
    rt_m = s[6:15].reshape(3, 3)
    tt_m = torch.stack([torch.stack([s[15], s[18], s[19]]), torch.stack([s[18], s[16], s[20]]),
                        torch.stack([s[19], s[20], s[17]])])
    uu = s[27:48][iu]
    H = torch.cat([torch.cat([rr_m, rt_m], 1), torch.cat([rt_m.T, tt_m], 1)], 0) - d2 * uu
    return score, s[21:27], H


def _solve6(A, b):
    """A^-1 b; a singular system gives a non-finite result, as XLA's LU
    does (the step search then rejects it), where `linalg.solve` raises."""
    x, info = torch.linalg.solve_ex(A, b)
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def _newton_step(source, src_ls, found, mu, c6, ls, Ti, any_improved, last_norm, consts):
    """One frozen-correspondence Newton step of `ndt_align_with_map`;
    acceptance on the full frozen objective. Returns (T, any improved,
    largest applied update norm, score)."""
    d1, d2, iu, alphas, eye6, zero = consts
    found_ls, mu_ls, c6_ls = ls
    score_now, g, H = _derivatives(source.xyz, found, mu, c6, Ti, d1, d2, iu)
    absH, diag = torch.abs(H), torch.diagonal(H)
    # modified Newton: damp by a Gershgorin lower bound
    gersh_lo = torch.amin(diag - (torch.sum(absH, dim=1) - torch.abs(diag)))
    floor = 1e-4 * torch.clamp(torch.amax(torch.abs(diag)), min=1.0)
    shift = torch.maximum(floor, floor - gersh_lo)
    d = -_solve6(H + shift * eye6, g)
    d_norm = torch.linalg.norm(d)
    d_capped = torch.where(d_norm > 1.0, d / torch.clamp(d_norm, min=1e-12), d)
    g_dir = -g / torch.clamp(torch.linalg.norm(g), min=1e-12)
    cand = torch.cat([alphas[:, None] * d_capped[None], alphas[:4, None] * g_dir[None]])
    scores_ls = _score_cached(src_ls, found_ls, mu_ls, c6_ls, d1, d2,
                              lie.se3_exp_split(cand) @ Ti)
    best = cand.index_select(0, torch.argmin(scores_ls).reshape(1))[0]
    T_best = lie.se3_exp_split(best) @ Ti
    score_best = _score_cached(source, found, mu, c6, d1, d2, T_best)
    improved = score_best < score_now
    # the norm of the applied update (0 when rejected) feeds the
    # `delta_p_norm < transformation_epsilon` stop (`ndt_omp_impl.hpp:173`)
    step_norm = torch.where(improved, torch.linalg.norm(best), zero)
    return (torch.where(improved, T_best, Ti), any_improved | improved,
            torch.maximum(last_norm, step_norm), torch.where(improved, score_best, score_now))


_LS_STRIDE = 4  # step candidates are only ranked: a strided quarter suffices


def _newton_setup(cfg, dtype, dev):
    """The constants of `_newton_step`."""
    d1, d2 = _gauss_coeffs(cfg)
    # the NDT Hessian goes indefinite inside the basin: the ladder reaches
    # down to 3e-3, the batched analogue of More-Thuente's contraction
    alphas = torch.tensor([1.0, 0.5, 0.25, 0.1, 0.03, 0.01, 0.003], dtype=dtype, device=dev)
    return (d1, d2, torch.tensor(_UU, device=dev), alphas,
            torch.eye(6, dtype=dtype, device=dev), torch.zeros((), dtype=dtype, device=dev))


def ndt_align_with_map(source: PointCloud, vmap_t: VoxelGaussianMap, init_T,
                       cfg: NDTConfig = NDTConfig()) -> LMResult:
    """Newton iterations on the NDT score with a parallel step-length search
    against a prebuilt map (`computeTransformation` / `computeDerivatives`
    + `computeStepLengthMT`, `ndt_omp_impl.hpp:130-320,773-860`).

    Returns the JAX package's `LMResult` contract: `converged` is always
    true and `error` is the final (negative) score; `iterations` counts
    outer iterations (gathers). A source with a leading batch axis (xyz
    (B, N, 3)) aligns B sources against the one map (`_align_batch`)."""
    if source.xyz.dim() == 3:
        return _align_batch(source, vmap_t, init_T, cfg)
    dtype = torch.promote_types(init_T.dtype, source.xyz.dtype)
    dev = init_T.device
    T = init_T.to(dtype)
    consts = _newton_setup(cfg, dtype, dev)
    src_ls = PointCloud(*(x[::_LS_STRIDE] for x in source))
    offsets = _offsets(cfg, dev)

    score = ndt_score(source, vmap_t, T, cfg, offsets)
    it, done = 0, False
    while it < cfg.max_iterations and not done:
        found, mu, c6 = _gather_correspondences(source, vmap_t, T, cfg, offsets)
        ls = (found[::_LS_STRIDE], mu[::_LS_STRIDE], tuple(c[::_LS_STRIDE] for c in c6))
        any_imp, max_norm = torch.zeros((), dtype=torch.bool, device=dev), consts[-1]
        for _ in range(3):
            T, any_imp, max_norm, score = _newton_step(source, src_ls, found, mu, c6, ls, T,
                                                       any_imp, max_norm, consts)
        # stop when no inner step improved, or every applied update of the
        # block fell below transformation_epsilon (`ndt_omp_impl.hpp:159`)
        done = bool((~any_imp) | (max_norm < cfg.transformation_epsilon))
        it += 1
    found, mu, c6 = _gather_correspondences(source, vmap_t, T, cfg, offsets)
    _, _, H = _derivatives(source.xyz, found, mu, c6, T, consts[0], consts[1], consts[2])
    return LMResult(T=T, H=H, error=score, converged=torch.tensor(True),
                    iterations=torch.tensor(it))


def _align_batch(source: PointCloud, vmap_t: VoxelGaussianMap, init_T,
                 cfg: NDTConfig) -> LMResult:
    """`ndt_align_with_map` of B sources (B, N, ...) against one map, the
    counterpart of a `jax.vmap`ped align: init_T (B, 4, 4) or one pose for
    all. Each lane keeps its own stop flag and iteration count and a lane
    that has stopped keeps its state, as the lanes of a vmapped
    `lax.while_loop` do; the per-lane work runs batched (`torch.func.vmap`
    of the single align's steps). The host reads one flag per outer
    iteration for the whole batch. Returns an LMResult with per-lane
    fields (iterations on the CPU)."""
    B = source.xyz.shape[0]
    dtype = torch.promote_types(init_T.dtype, source.xyz.dtype)
    dev = init_T.device
    T = init_T.to(dtype).expand(B, 4, 4)
    consts = _newton_setup(cfg, dtype, dev)
    d1, d2, iu = consts[:3]
    offsets = _offsets(cfg, dev)
    src_ls = PointCloud(*(x[:, ::_LS_STRIDE] for x in source))
    gather = torch.func.vmap(lambda s, Ti: _gather_correspondences(s, vmap_t, Ti, cfg, offsets))
    step = torch.func.vmap(lambda *a: _newton_step(*a, consts))

    score = torch.func.vmap(lambda s, Ti: ndt_score(s, vmap_t, Ti, cfg, offsets))(source, T)
    iters = torch.zeros(B, dtype=torch.int64, device=dev)
    running = torch.ones(B, dtype=torch.bool, device=dev)
    outer, any_running = 0, B > 0
    while outer < cfg.max_iterations and any_running:
        found, mu, c6 = gather(source, T)
        ls = (found[:, ::_LS_STRIDE], mu[:, ::_LS_STRIDE], tuple(c[:, ::_LS_STRIDE] for c in c6))
        T_new, score_new = T, score
        any_imp = torch.zeros(B, dtype=torch.bool, device=dev)
        max_norm = torch.zeros(B, dtype=dtype, device=dev)
        for _ in range(3):
            T_new, any_imp, max_norm, score_new = step(source, src_ls, found, mu, c6, ls, T_new,
                                                       any_imp, max_norm)
        T = torch.where(running[:, None, None], T_new, T)
        score = torch.where(running, score_new, score)
        iters = iters + running.to(iters.dtype)
        running = running & any_imp & (max_norm >= cfg.transformation_epsilon)
        any_running = bool(running.any())
        outer += 1
    found, mu, c6 = gather(source, T)
    H = torch.func.vmap(lambda *a: _derivatives(*a, d1, d2, iu)[2])(source.xyz, found, mu, c6, T)
    return LMResult(T=T, H=H, error=score, converged=torch.ones(B, dtype=torch.bool),
                    iterations=iters.cpu())


def ndt_align(source: PointCloud, target: PointCloud, init_T=None,
              cfg: NDTConfig = NDTConfig()) -> LMResult:
    """Build the target map (on every call) and align."""
    if init_T is None:
        init_T = torch.eye(4, dtype=source.xyz.dtype, device=source.xyz.device)
    return ndt_align_with_map(source, build_voxel_map(target, cfg), init_T, cfg)


def coarse_cfg(cfg: NDTConfig) -> NDTConfig:
    """The config of `ndt_align_multires`' coarse stage."""
    return cfg._replace(resolution=cfg.resolution * cfg.coarse_scale,
                        neighborhood=cfg.coarse_neighborhood,
                        max_iterations=cfg.coarse_iterations)


def ndt_align_multires(source: PointCloud, vmap_coarse: VoxelGaussianMap,
                       vmap_fine: VoxelGaussianMap, init_T,
                       cfg: NDTConfig = NDTConfig()) -> LMResult:
    """Coarse-to-fine NDT: a few Newton iterations against the
    `coarse_scale`x map, then a fine pass capped at min(max_iterations,
    fine_iterations). Both maps come from `build_voxel_map` on the same
    target (the coarse one with `coarse_cfg(cfg)`)."""
    rc = ndt_align_with_map(source, vmap_coarse, init_T, coarse_cfg(cfg))
    rf = ndt_align_with_map(source, vmap_fine, rc.T,
                            cfg._replace(max_iterations=min(cfg.max_iterations,
                                                            cfg.fine_iterations)))
    return rf._replace(iterations=rc.iterations + rf.iterations)


def ndt_align_cf(source: PointCloud, target: PointCloud, init_T=None,
                 cfg: NDTConfig = NDTConfig()) -> LMResult:
    """One-shot coarse-to-fine: builds both maps and aligns."""
    if init_T is None:
        init_T = torch.eye(4, dtype=source.xyz.dtype, device=source.xyz.device)
    return ndt_align_multires(source, build_voxel_map(target, coarse_cfg(cfg)),
                              build_voxel_map(target, cfg), init_T, cfg)


# ---- D2D NDT (distribution-to-distribution) --------------------------------


def ndt_d2d_align_with_maps(vmap_s: VoxelGaussianMap, vmap_t: VoxelGaussianMap, init_T,
                            cfg: NDTConfig = NDTConfig()) -> LMResult:
    """Align the source voxel Gaussians to the target's (`NDTCuda` D2D,
    `ndt_compute_derivatives.cu`): each matched voxel pair scores
    x = T(mu_a) - mu_b under (C_b + R C_a R^T)^-1, frozen at the current T
    in each linearisation; Gauss-Newton H, a 14-candidate step search."""
    dtype = torch.promote_types(init_T.dtype, vmap_s.means.dtype)
    dev = init_T.device
    T = init_T.to(dtype)
    d1, d2 = _gauss_coeffs(cfg)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    means_a = vmap_s.means.to(dtype)
    cov_a = inv3(vmap_s.inv_covs.to(dtype) + 1e-12 * eye3)
    mask_a = vmap_s.valid
    offsets = _offsets(cfg, dev)
    inv_covs_t = vmap_t.inv_covs.to(dtype)
    means_t = vmap_t.means.to(dtype)

    def correspondences(T):
        moved = _transform(means_a, T)[0]
        ijk = _point_ijk(moved, cfg.resolution, vmap_t.origin)
        idx, found = _table_lookup(vmap_t.keys, vmap_t.table, vmap_t.table_dims,
                                   cfg.table_size, ijk[:, None, :] + offsets[None])
        found = found & vmap_t.valid[idx] & mask_a[:, None]
        cov_b = inv3(inv_covs_t[idx] + 1e-12 * eye3)
        R = T[:3, :3]
        M = inv3(cov_b + (R @ cov_a @ R.T)[:, None] + 1e-9 * eye3)
        return found, means_t[idx], M

    def score_at(found, mu_b, M, T):
        """At T, or at each of K poses (K, 4, 4) -> (K,)."""
        x = _transform(means_a, T)[0][..., :, None, :] - mu_b
        md2 = torch.einsum("...voi,voij,...voj->...vo", x, M, x)
        s = d1 * torch.exp(-0.5 * d2 * md2)
        return torch.sum(torch.where(found, s, torch.zeros_like(s)), dim=(-2, -1))

    def derivatives(found, mu_b, M, T):
        moved = _transform(means_a, T)[0]
        x = moved[:, None, :] - mu_b
        Mx = torch.einsum("voij,voj->voi", M, x)
        e = torch.exp(-0.5 * d2 * torch.einsum("voi,voi->vo", x, Mx))
        coef = torch.where(found, -d2 * d1 * e, torch.zeros_like(e))
        hm = lie.hat(moved)  # (V, 3, 3)
        u = torch.cat([torch.einsum("vij,voj->voi", hm, Mx), Mx], dim=-1)
        g = torch.einsum("vo,voi->i", coef, u)
        rr = torch.einsum("vij,vojk->voik", hm, torch.einsum("voij,vkj->voik", M, hm))
        rt = torch.einsum("vij,vojk->voik", hm, M)
        JTJ = torch.cat([torch.cat([rr, rt], -1), torch.cat([rt.transpose(-1, -2), M], -1)], -2)
        # PSD Gauss-Newton H only: the -d2 u u^T term makes H indefinite at
        # D2D's voxel-pair counts
        return g, torch.einsum("vo,voij->ij", coef, JTJ)

    # a wide log fan: D2D's exponential score has a voxel-scale basin
    alphas = torch.tensor([1.0, 0.3, 0.1, 0.03, 0.01, 0.003, 0.001], dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    last = score_at(*correspondences(T), T)
    it, done = 0, False
    while it < cfg.max_iterations and not done:
        found, mu_b, M = correspondences(T)
        g, H = derivatives(found, mu_b, M, T)
        lam = 1e-4 * torch.clamp(torch.amax(torch.abs(torch.diagonal(H))), min=1.0)
        d = -_solve6(H + lam * eye6, g)
        dn = torch.linalg.norm(d)
        d = torch.where(dn > 1.0, d / torch.clamp(dn, min=1e-12), d)
        g_dir = -g / torch.clamp(torch.linalg.norm(g), min=1e-12)
        cand = torch.cat([alphas[:, None] * d[None], alphas[:, None] * g_dir[None]])
        score_now = score_at(found, mu_b, M, T)
        scores = score_at(found, mu_b, M, lie.se3_exp_split(cand) @ T)
        best = torch.argmin(scores).reshape(1)
        s_best, c_best = scores.index_select(0, best)[0], cand.index_select(0, best)[0]
        improved = s_best < score_now
        step = torch.where(improved, c_best, torch.zeros_like(c_best))
        T = torch.where(improved, lie.se3_exp_split(c_best) @ T, T)
        last = torch.where(improved, s_best, last)
        done = bool((~improved) | (torch.linalg.norm(step) < cfg.transformation_epsilon))
        it += 1
    found, mu_b, M = correspondences(T)
    _, H = derivatives(found, mu_b, M, T)
    return LMResult(T=T, H=H, error=last, converged=torch.tensor(True),
                    iterations=torch.tensor(it))


def ndt_d2d_align(source: PointCloud, target: PointCloud, init_T=None,
                  cfg: NDTConfig = NDTConfig()) -> LMResult:
    """Voxelise both clouds, then D2D-align their Gaussians."""
    if init_T is None:
        init_T = torch.eye(4, dtype=source.xyz.dtype, device=source.xyz.device)
    return ndt_d2d_align_with_maps(build_voxel_map(source, cfg), build_voxel_map(target, cfg),
                                   init_T, cfg)
