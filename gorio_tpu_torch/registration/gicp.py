"""GICP-family registration: FastGICP / FastAPDGICP / point-to-point ICP.

Port of `gorio_tpu/registration/gicp.py`: kNN covariance estimation,
per-iteration 1-NN correspondences (the `nn1_select` kernel), the APD polar
measurement covariance, and the Mahalanobis residual + H/b reduction in
closed component form, feeding the LM loop in `lsq.py`.

Every function takes an optional leading batch axis, the counterpart of
`jax.vmap` over pairs (loop-closure verification): clouds (B, N, .), poses
(B, 4, 4). A batched linearize is one `nn1_select` launch at B lanes and a
batched fitness one `nn1_best` launch.

Precision follows the JAX package under x64: clouds stay in their own dtype
(float32 from the sensor), the pose decides the dtype of the linearization
(float64 host poses), and the 1-NN kernel computes in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import lie
from ..core.linalg import inv3, sym_eigh3
from ..core.pointcloud import PointCloud
from ..ops.nn import nn1_best, nn1_select
from .knn import knn, rbf_covariances
from .lsq import LMConfig, LMResult, lm_optimize, lm_optimize_batch


class GICPConfig(NamedTuple):
    k_correspondences: int = 20
    # `reg_max_correspondence_distance` (registrations.cpp:44): correspondences
    # beyond it are dropped
    max_correspondence_distance: float = 2.5
    # APD polar covariance parameters (`fast_apdgicp.hpp:116-118`)
    dist_var: float = 0.86
    azimuth_var_deg: float = 0.5
    elevation_var_deg: float = 1.0
    plane_eps: float = 1e-3  # PLANE regularization smallest eigenvalue
    lm: LMConfig = LMConfig()
    mode: str = "apdgicp"  # "gicp" | "apdgicp" | "icp"
    # neighbourhood covariance estimator: "knn" (FastGICP
    # `calculate_covariances`) or "rbf" (FastVGICPCuda GPU_RBF_KERNEL)
    covariance_method: str = "knn"
    rbf_kernel_width: float = 0.25
    rbf_max_dist: float = 3.0


def knn_covariances(xyz, mask, k: int = 20, plane_eps: float = 1e-3, block: int = 512,
                    query=None):
    """Per-point neighbourhood covariances with PLANE regularization
    (`fast_apdgicp_impl.hpp:351-411`): kNN -> covariance -> spectrum clamped
    to (eps, 1, 1) in the eigenbasis. xyz ([B,] N, 3) -> (cov ([B,] N, 3, 3),
    geo_w ([B,] N)). The kNN is blocked over queries: a block holds
    (B, block, N) distances, never (B, N, N). `query` ([B,] Q, 3), a slice
    of the cloud's rows, gives those rows' covariances (Q of them) with
    their neighbours taken among all of xyz: a shard's rows, as the whole
    cloud's call gives them."""
    idx, _ = knn(xyz if query is None else query, xyz, k, ref_mask=mask, block=block)
    neigh = _take(xyz, idx, batched=xyz.dim() == 3)  # ([B,] N, k, 3)
    centered = neigh - torch.mean(neigh, dim=-2, keepdim=True)
    cov = torch.einsum("...nki,...nkj->...nij", centered, centered) / k
    lam, V = sym_eigh3(cov)  # ascending
    values = torch.tensor([plane_eps, 1.0, 1.0], dtype=xyz.dtype, device=xyz.device)
    reg = torch.einsum("...ij,j,...kj->...ik", V, values, V)
    # geo weight: normalized smallest eigenvalue of the raw covariance
    geo_w = torch.clamp(lam[..., 0], min=0.0) / torch.clamp(lam[..., 2], min=1e-30)
    return reg, geo_w


def _take(x, idx, batched: bool):
    """x[idx] along the point axis, per lane when `batched`: x ([B,] M, ...)
    and idx ([B,] ...) -> ([B,] ..., x's trailing dims)."""
    if not batched:
        return x[idx]
    lane = torch.arange(x.shape[0], device=x.device).view(-1, *([1] * (idx.dim() - 1)))
    return x[lane, idx]


def apd_polar_cov(pts, dist_var, azimuth_var_deg, elevation_var_deg):
    """Range-dependent polar measurement covariance (the "APD" in APDGICP),
    `fast_apdgicp_impl.hpp:193-210`: scale s = (d*dist_var/400, d*sin(az),
    d*sin(el)) rotated into the ray frame by R = Rz(azimuth) Ry(elevation).
    pts (..., 3) -> (..., 3, 3)."""
    d = torch.linalg.norm(pts, dim=-1)
    s = torch.stack(
        [
            d * dist_var / 400.0,
            d * math.sin(math.radians(azimuth_var_deg)),
            d * math.sin(math.radians(elevation_var_deg)),
        ],
        dim=-1,
    )
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    elevation = torch.atan2(torch.sqrt(x * x + y * y), z)
    azimuth = torch.atan2(y, x)
    cy, sy = torch.cos(azimuth), torch.sin(azimuth)
    cp, sp = torch.cos(elevation), torch.sin(elevation)
    zero, one = torch.zeros_like(cy), torch.ones_like(cy)
    Rz = torch.stack(
        [torch.stack([cy, -sy, zero], -1), torch.stack([sy, cy, zero], -1),
         torch.stack([zero, zero, one], -1)], -2,
    )
    Ry = torch.stack(
        [torch.stack([cp, zero, sp], -1), torch.stack([zero, one, zero], -1),
         torch.stack([-sp, zero, cp], -1)], -2,
    )
    A = (Rz @ Ry) * s[..., None, :]
    return A @ A.transpose(-1, -2)


class GICPProblem(NamedTuple):
    """Precomputed per-pair state (covariances, weights, clusters)."""

    src_xyz: torch.Tensor
    src_mask: torch.Tensor
    src_cov: torch.Tensor  # ([B,] N, 3, 3)
    src_geo_w: torch.Tensor  # ([B,] N)
    src_cluster: torch.Tensor
    tgt_xyz: torch.Tensor
    tgt_mask: torch.Tensor
    tgt_cov: torch.Tensor
    tgt_cluster: torch.Tensor


def rbf_regularized_covariances(xyz, mask, kernel_width, max_dist, plane_eps):
    """RBF-kernel covariances with the PLANE regularisation the CUDA path
    applies afterwards (`covariance_regularization.cu`, called from
    `fast_vgicp_cuda.cu:205-218`). One cloud (N, 3); returns (cov (N, 3, 3),
    geo_w (N,))."""
    _, cov, _ = rbf_covariances(xyz, mask, kernel_width, max_dist)
    lam, V = sym_eigh3(cov)
    values = torch.tensor([plane_eps, 1.0, 1.0], dtype=xyz.dtype, device=xyz.device)
    reg = torch.einsum("nij,j,nkj->nik", V, values, V)
    geo_w = torch.clamp(lam[:, 0], min=0.0) / torch.clamp(lam[:, 2], min=1e-30)
    return reg, geo_w


def _covariances(cloud: PointCloud, cfg):
    """Neighbourhood covariances per the config: identity for "icp", else
    by `covariance_method`. Shared by GICP and VGICP (duck-typed over
    `GICPConfig` / `VGICPConfig`)."""
    lead = cloud.xyz.shape[:-1]
    if getattr(cfg, "mode", "gicp") == "icp":
        eye = torch.eye(3, dtype=cloud.xyz.dtype, device=cloud.xyz.device).expand(*lead, 3, 3)
        return eye, torch.zeros(lead, dtype=cloud.xyz.dtype, device=cloud.xyz.device)
    if cfg.covariance_method == "rbf":
        if cloud.xyz.dim() != 2:
            raise ValueError('covariance_method="rbf" takes one cloud, not a batch')
        return rbf_regularized_covariances(cloud.xyz, cloud.mask, cfg.rbf_kernel_width,
                                           cfg.rbf_max_dist, cfg.plane_eps)
    return knn_covariances(cloud.xyz, cloud.mask, cfg.k_correspondences, cfg.plane_eps)


def prepare_gicp(source: PointCloud, target: PointCloud, cfg: GICPConfig) -> GICPProblem:
    src_cov, src_geo = _covariances(source, cfg)
    tgt_cov, _ = _covariances(target, cfg)
    return GICPProblem(
        src_xyz=source.xyz, src_mask=source.mask, src_cov=src_cov, src_geo_w=src_geo,
        src_cluster=source.cluster, tgt_xyz=target.xyz, tgt_mask=target.mask,
        tgt_cov=tgt_cov, tgt_cluster=target.cluster,
    )


def _transform(xyz, T):
    """Points under T, in the promoted dtype of the pose and the cloud.
    xyz ([B,] N, 3), T ([B,] 4, 4). Returns (moved, T in that dtype)."""
    dtype = torch.promote_types(T.dtype, xyz.dtype)
    T = T.to(dtype)
    return xyz.to(dtype) @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3], T


def _correspondences(prob: GICPProblem, T, cfg: GICPConfig, n_total: int | None = None):
    """1-NN (`nn1_best`) + Mahalanobis; `update_correspondences`
    (`fast_apdgicp_impl.hpp:160-220`). One pair (no batch axis). `n_total`
    is the whole source capacity where `prob` holds a shard of the source
    (`parallel/sharded.py`): the cluster bonus's denominator (`_weights`)."""
    moved, T = _transform(prob.src_xyz, T)
    R = T[:3, :3]
    idx, sqd = nn1_best(moved, prob.tgt_xyz, ref_mask=prob.tgt_mask)
    idx = idx.long()
    ok = prob.src_mask & (sqd < cfg.max_correspondence_distance ** 2) & prob.tgt_mask[idx]
    cov_A = prob.src_cov.to(moved.dtype)
    cov_B = prob.tgt_cov[idx].to(moved.dtype)
    if cfg.mode == "apdgicp":
        cov_d = apd_polar_cov(moved, cfg.dist_var, cfg.azimuth_var_deg, cfg.elevation_var_deg)
        cov_A = cov_A + cov_d
        cov_B = cov_B + cov_d
    mah = inv3(cov_B + R @ cov_A @ R.T)
    w = _weights(prob, cfg, prob.tgt_cluster[idx], n_total)
    return idx, ok, mah, w, moved


def _weights(prob: GICPProblem, cfg: GICPConfig, matched_cluster, n_total: int | None = None):
    """Cost weights (`fast_apdgicp_impl.hpp:264-276`): 1 + geo + cluster
    bonus for APDGICP; plain FastGICP/ICP cost is unweighted. The bonus is
    1 / the source capacity: `n_total` where `prob` holds a shard of it."""
    if cfg.mode != "apdgicp":
        return torch.ones_like(prob.src_geo_w)
    same = (matched_cluster == prob.src_cluster) & (prob.src_cluster >= 0.0)
    n = prob.src_xyz.shape[-2] if n_total is None else n_total
    cl_w = torch.where(same, 1.0 / n, 0.0).to(prob.src_geo_w.dtype)
    return 1.0 + prob.src_geo_w + cl_w


def _error_terms(prob: GICPProblem, T, idx, ok, mah, w):
    moved, _ = _transform(prob.src_xyz, T)
    err = _take(prob.tgt_xyz, idx, T.dim() == 3).to(moved.dtype) - moved  # ([B,] N, 3)
    m_err = torch.einsum("...nij,...nj->...ni", mah, err)
    per_point = w * torch.einsum("...ni,...ni->...n", err, m_err)
    cost = torch.sum(torch.where(ok, per_point, torch.zeros_like(per_point)), dim=-1)
    return moved, err, m_err, cost


def _sym6(M):
    """(..., 3, 3) symmetric matrix -> components (xx, yy, zz, xy, xz, yz)."""
    return (M[..., 0, 0], M[..., 1, 1], M[..., 2, 2], M[..., 0, 1], M[..., 0, 2], M[..., 1, 2])


def _apd_cov6(pts, dist_var, azimuth_var_deg, elevation_var_deg):
    """`apd_polar_cov` in component form (xx, yy, zz, xy, xz, yz)."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    d = torch.sqrt(x * x + y * y + z * z)
    s1 = (d * dist_var / 400.0) ** 2
    s2 = (d * math.sin(math.radians(azimuth_var_deg))) ** 2
    s3 = (d * math.sin(math.radians(elevation_var_deg))) ** 2
    elevation = torch.atan2(torch.sqrt(x * x + y * y), z)
    azimuth = torch.atan2(y, x)
    cy, sy = torch.cos(azimuth), torch.sin(azimuth)
    cp, sp = torch.cos(elevation), torch.sin(elevation)
    cy2, sy2, cp2, sp2 = cy * cy, sy * sy, cp * cp, sp * sp
    xx = s1 * cy2 * cp2 + s2 * sy2 + s3 * cy2 * sp2
    yy = s1 * sy2 * cp2 + s2 * cy2 + s3 * sy2 * sp2
    zz = s1 * sp2 + s3 * cp2
    xy = cy * sy * (s1 * cp2 + s3 * sp2 - s2)
    xz = cy * cp * sp * (s3 - s1)
    yz = sy * cp * sp * (s3 - s1)
    return xx, yy, zz, xy, xz, yz


def _sym_inv6(c):
    """Closed-form inverse of a symmetric 3x3 given/returning 6 components."""
    a, d, f, b, cc, e = c  # xx yy zz xy xz yz
    A0 = d * f - e * e
    A1 = cc * e - b * f
    A2 = b * e - cc * d
    det = a * A0 + b * A1 + cc * A2
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))
    return (A0 * inv_det, (a * f - cc * cc) * inv_det, (a * d - b * b) * inv_det,
            A1 * inv_det, A2 * inv_det, (b * cc - a * e) * inv_det)


def _mah33(c):
    """6 components -> (..., 3, 3) symmetric matrix."""
    a, d, f, b, cc, e = c
    return torch.stack(
        [torch.stack([a, b, cc], -1), torch.stack([b, d, e], -1), torch.stack([cc, e, f], -1)],
        -2,
    )


def gicp_payload(prob: GICPProblem):
    """The `nn1_select` payload of a linearize: the target's xyz, its six
    covariance entries, cluster and mask, ([B,] M, 11) in its xyz dtype."""
    dtype = prob.tgt_xyz.dtype
    return torch.cat(
        [prob.tgt_xyz] + [c[..., None].to(dtype) for c in _sym6(prob.tgt_cov)]
        + [prob.tgt_cluster.to(dtype)[..., None], prob.tgt_mask.to(dtype)[..., None]],
        dim=-1,
    )


def make_gicp_callbacks(prob: GICPProblem, cfg: GICPConfig):
    """Build (linearize, compute_error) for `lm_optimize` (one pair) or
    `lm_optimize_batch` (a problem with a batch axis, T (B, 4, 4))
    (`FastAPDGICP::linearize` / `compute_error`, `fast_apdgicp_impl.hpp:224-346`;
    the reference weights the cost with (1+geo+cl) but not H/b).

    The linearize epilogue (APD covariance, (C_B + R C_A R^T)^-1, per-point
    H/b) is written in closed component form on ([B,] N) columns, with the
    rotation's entries as per-lane scalars broadcast over the points, and
    reduced by one (28, N) x (N,) product per lane. The target's xyz,
    covariance, cluster and mask ride in the 1-NN kernel's payload, so the
    kernel returns them for the winning target point: one `nn1_select`
    launch per linearize, at every lane of the batch."""
    scov6 = _sym6(prob.src_cov)
    gate2 = cfg.max_correspondence_distance ** 2
    payload = gicp_payload(prob)

    def linearize(T):
        moved, T = _transform(prob.src_xyz, T)

        def R(i, j):  # a rotation entry per lane, broadcast over the points
            return T[..., i, j, None]

        idx, sqd, sel = nn1_select(moved, prob.tgt_xyz, payload, ref_mask=prob.tgt_mask)
        ok = prob.src_mask & (sqd < gate2) & (sel[..., 10] > 0.5)
        okf = ok.to(moved.dtype)

        A6 = list(scov6)
        B6 = [sel[..., 3 + k] for k in range(6)]
        if cfg.mode == "apdgicp":
            cd = _apd_cov6(moved, cfg.dist_var, cfg.azimuth_var_deg, cfg.elevation_var_deg)
            A6 = [A6[k] + cd[k] for k in range(6)]
            B6 = [B6[k] + cd[k] for k in range(6)]
        w = _weights(prob, cfg, sel[..., 9])

        # RCR = B + R A R^T, unrolled over the symmetric components
        Af = [[A6[0], A6[3], A6[4]], [A6[3], A6[1], A6[5]], [A6[4], A6[5], A6[2]]]
        Bf = [[B6[0], B6[3], B6[4]], [B6[3], B6[1], B6[5]], [B6[4], B6[5], B6[2]]]
        RA = [[sum(R(i, j) * Af[j][k] for j in range(3)) for k in range(3)] for i in range(3)]

        def rcr(i, l):
            return Bf[i][l] + sum(RA[i][k] * R(l, k) for k in range(3))

        m = _sym_inv6((rcr(0, 0), rcr(1, 1), rcr(2, 2), rcr(0, 1), rcr(0, 2), rcr(1, 2)))
        m_xx, m_yy, m_zz, m_xy, m_xz, m_yz = m
        M0, M1, M2 = (m_xx, m_xy, m_xz), (m_xy, m_yy, m_yz), (m_xz, m_yz, m_zz)

        ex = sel[..., 0] - moved[..., 0]
        ey = sel[..., 1] - moved[..., 1]
        ez = sel[..., 2] - moved[..., 2]
        me = tuple(Mi[0] * ex + Mi[1] * ey + Mi[2] * ez for Mi in (M0, M1, M2))
        cost_col = w * (ex * me[0] + ey * me[1] + ez * me[2])

        px, py, pz = moved[..., 0], moved[..., 1], moved[..., 2]
        # G[i] = column i of skew(p), dotted with M's columns (M symmetric)
        G = [tuple(pz * M1[k] - py * M2[k] for k in range(3)),
             tuple(px * M2[k] - pz * M0[k] for k in range(3)),
             tuple(py * M0[k] - px * M1[k] for k in range(3))]

        def skdot(i, v):
            if i == 0:
                return pz * v[1] - py * v[2]
            if i == 1:
                return px * v[2] - pz * v[0]
            return py * v[0] - px * v[1]

        Hrr = [[skdot(i, G[j]) for j in range(3)] for i in range(3)]
        br = [skdot(i, me) for i in range(3)]
        cols = torch.stack(
            [Hrr[0][0], Hrr[1][1], Hrr[2][2], Hrr[0][1], Hrr[0][2], Hrr[1][2]]
            + [G[i][k] for i in range(3) for k in range(3)]  # -H_rt
            + [m_xx, m_yy, m_zz, m_xy, m_xz, m_yz]  # H_tt
            + br + [me[0], me[1], me[2], cost_col],
            dim=-2,
        ).to(moved.dtype)
        s = (cols @ okf[..., None])[..., 0]  # every accumulator in one reduction

        def sym3(a, b, c, d, e, f):  # components xx yy zz xy xz yz -> (.., 3, 3)
            return torch.stack([torch.stack([s[..., a], s[..., d], s[..., e]], -1),
                                torch.stack([s[..., d], s[..., b], s[..., f]], -1),
                                torch.stack([s[..., e], s[..., f], s[..., c]], -1)], -2)

        Hrr_m = sym3(0, 1, 2, 3, 4, 5)
        Hrt_m = -s[..., 6:15].reshape(*s.shape[:-1], 3, 3)
        Htt_m = sym3(15, 16, 17, 18, 19, 20)
        H = torch.cat([torch.cat([Hrr_m, Hrt_m], -1),
                       torch.cat([Hrt_m.transpose(-1, -2), Htt_m], -1)], -2)
        b = torch.cat([s[..., 21:24], -s[..., 24:27]], -1)
        aux = (idx.long(), ok, _mah33(m), w)
        return s[..., 27], H, b, aux

    def compute_error(T, aux):
        idx, ok, mah, w = aux
        return _error_terms(prob, T, idx, ok, mah, w)[3]

    return linearize, compute_error


def make_gicp_callbacks_reference(prob: GICPProblem, cfg: GICPConfig,
                                  n_total: int | None = None, reduce=None):
    """The straightforward (N, 3, 3) einsum formulation over `nn1_best`
    correspondences: the equality reference for the component form.

    With `prob` a shard of the source points, `n_total` the whole capacity
    and `reduce` a sum over the shards, it is the sharded linearization
    (`parallel/sharded.py`): cost, H and b summed in one reduction, the
    cost of `compute_error` in another."""

    def linearize(T):
        idx, ok, mah, w, _ = _correspondences(prob, T, cfg, n_total)
        moved, err, m_err, cost = _error_terms(prob, T, idx, ok, mah, w)
        # J (3x6) rows: d(err)/d[d_rot, d_trans] = [skew(moved), -I]
        sk = lie.hat(moved)
        okf = ok.to(moved.dtype)
        H_rr = torch.einsum("nji,njk,n->ik", sk, mah @ sk, okf)
        H_rt = -torch.einsum("nji,njk,n->ik", sk, mah, okf)
        H_tt = torch.einsum("nij,n->ij", mah, okf)
        H = torch.cat([torch.cat([H_rr, H_rt], 1), torch.cat([H_rt.T, H_tt], 1)], 0)
        b = torch.cat([torch.einsum("nji,nj,n->i", sk, m_err, okf),
                       -torch.einsum("ni,n->i", m_err, okf)])
        if reduce is not None:
            s = reduce(torch.cat([cost[None], H.reshape(-1), b]))
            cost, H, b = s[0], s[1:37].reshape(6, 6), s[37:]
        return cost, H, b, (idx, ok, mah, w)

    def compute_error(T, aux):
        idx, ok, mah, w = aux
        cost = _error_terms(prob, T, idx, ok, mah, w)[3]
        return cost if reduce is None else reduce(cost)

    return linearize, compute_error


def gicp_align(
    source: PointCloud,
    target: PointCloud,
    init_T=None,
    cfg: GICPConfig = GICPConfig(),
) -> LMResult:
    """Full APDGICP/GICP/ICP alignment source -> target. Returns T mapping
    source points into the target frame."""
    if cfg.mode not in ("apdgicp", "gicp", "icp"):
        raise ValueError(f"unknown GICP mode {cfg.mode!r}")
    if init_T is None:
        init_T = torch.eye(4, dtype=source.xyz.dtype, device=source.xyz.device)
    prob = prepare_gicp(source, target, cfg)
    linearize, compute_error = make_gicp_callbacks(prob, cfg)
    return lm_optimize(linearize, compute_error, init_T, cfg.lm)


def align_prepared_batch(prob: GICPProblem, init_T, cfg: GICPConfig = GICPConfig()) -> LMResult:
    """Batched LM alignment of a prepared problem with a batch axis
    (`prepare_gicp` on stacked clouds), from init_T (B, 4, 4). The
    covariances depend only on the clouds and on `cfg`'s k, plane_eps and
    mode, so one problem serves aligns that differ in their correspondence
    gate (loop verification's coarse and fine stages)."""
    linearize, compute_error = make_gicp_callbacks(prob, cfg)
    return lm_optimize_batch(linearize, compute_error, init_T, cfg.lm)


def gicp_align_batch(
    source: PointCloud,
    target: PointCloud,
    init_T,
    cfg: GICPConfig = GICPConfig(),
) -> LMResult:
    """`gicp_align` over B independent pairs at once (the counterpart of
    `jax.vmap(gicp_align)`): clouds stacked to (B, N, .), init_T (B, 4, 4).
    Each lane returns what `gicp_align` returns for its pair; each outer LM
    iteration of the batch is one `nn1_select` launch at B lanes."""
    if cfg.mode not in ("apdgicp", "gicp", "icp"):
        raise ValueError(f"unknown GICP mode {cfg.mode!r}")
    return align_prepared_batch(prepare_gicp(source, target, cfg), init_T, cfg)


def fitness_score(source: PointCloud, target: PointCloud, T, max_range: float = 1.0):
    """Mean squared NN distance of inliers (`pcl::Registration::
    getFitnessScore`, `information_matrix_calculator.cpp:55-86`), over the
    `nn1_best` kernel: one launch, batched or not. Returns (fitness,
    inlier count), per lane for clouds (B, N, .) and T (B, 4, 4)."""
    moved, _ = _transform(source.xyz, T)
    _, sqd = nn1_best(moved, target.xyz, ref_mask=target.mask)
    ok = source.mask & (sqd < max_range * max_range)
    n = torch.clamp(torch.sum(ok, dim=-1), min=1)
    return torch.sum(torch.where(ok, sqd, torch.zeros_like(sqd)), dim=-1) / n, n
