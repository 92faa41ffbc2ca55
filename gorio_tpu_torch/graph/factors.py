"""Typed pose-graph factors with batched residuals.

Port of `gorio_tpu/graph/factors.py`: the six pose-factor families, the
five plane-vertex families (`PlaneGraphData`: plane priors, plane-plane,
SE3-plane, relative altitude, UTM alignment) with the plane chart
(`plane_tangent_basis`, `retract_plane`, `transform_plane`), plus
`retract`, `huber_weight`, `empty_graph` and `empty_plane_graph`. Each
family is a NamedTuple of tensors (struct-of-arrays, padded, with a live
mask). Residuals accept any leading batch shape; the solvers take their
Jacobians per factor with `torch.func.jacfwd` under `torch.func.vmap`.

State convention: pose k is T_k; perturbations are right-multiplicative with
the [exp(rot), trans] split: T(delta) = T . [exp(d_rot), d_trans].
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..core import lie


def retract(T, delta):
    """T . [exp(d_rot), d_trans] — right-multiplicative local update."""
    return T @ lie.se3_exp_split(delta)


class BetweenFactors(NamedTuple):
    """SE3-SE3 relative pose factors (odometry, preintegration, loops):
    residual = log(meas^-1 T_i^-1 T_j) (6,)."""

    i: torch.Tensor  # (F,) int64
    j: torch.Tensor  # (F,)
    T_meas: torch.Tensor  # (F, 4, 4)
    sqrt_info: torch.Tensor  # (F, 6, 6)
    mask: torch.Tensor  # (F,) bool
    robust_delta: torch.Tensor  # (F,) Huber delta; inf = none

    @staticmethod
    def residual(T_i, T_j, T_meas):
        return lie.se3_log(lie.se3_inverse(T_meas) @ (lie.se3_inverse(T_i) @ T_j))


class PriorFactors(NamedTuple):
    """Unary SE3 priors (anchor): residual = log(meas^-1 T_i) (6,)."""

    i: torch.Tensor
    T_meas: torch.Tensor
    sqrt_info: torch.Tensor
    mask: torch.Tensor
    robust_delta: torch.Tensor

    @staticmethod
    def residual(T_i, T_meas):
        return lie.se3_log(lie.se3_inverse(T_meas) @ T_i)


class PointPriorFactors(NamedTuple):
    """Unary position priors with an axis mask (GPS XYZ / XY / Z):
    residual = (t_i - p_meas) * axis_mask (3,)."""

    i: torch.Tensor
    p_meas: torch.Tensor  # (F, 3)
    axis_mask: torch.Tensor  # (F, 3) 0/1
    sqrt_info: torch.Tensor  # (F, 3, 3)
    mask: torch.Tensor
    robust_delta: torch.Tensor

    @staticmethod
    def residual(T_i, p_meas, axis_mask):
        return (T_i[..., :3, 3] - p_meas) * axis_mask


class QuatPriorFactors(NamedTuple):
    """Unary orientation priors: residual = log(R_meas^T R_i) (3,)."""

    i: torch.Tensor
    R_meas: torch.Tensor  # (F, 3, 3)
    sqrt_info: torch.Tensor
    mask: torch.Tensor
    robust_delta: torch.Tensor

    @staticmethod
    def residual(T_i, R_meas):
        return lie.so3_log(R_meas.transpose(-1, -2) @ T_i[..., :3, :3])


class VecPriorFactors(NamedTuple):
    """Unary direction priors: residual = R_i^T dir_world - dir_meas (3,)."""

    i: torch.Tensor
    dir_world: torch.Tensor  # (F, 3)
    dir_meas: torch.Tensor  # (F, 3)
    sqrt_info: torch.Tensor
    mask: torch.Tensor
    robust_delta: torch.Tensor

    @staticmethod
    def residual(T_i, dir_world, dir_meas):
        return torch.einsum("...ji,...j->...i", T_i[..., :3, :3], dir_world) - dir_meas


class GroundPlaneFactors(NamedTuple):
    """Unary ground-plane factors with the world plane (n_w, d_w) held fixed:
    residual = [R_i^T n_w - n_meas ; (n_w . t_i + d_w) - d_meas] (4,)."""

    i: torch.Tensor
    plane_world: torch.Tensor  # (F, 4)
    plane_meas: torch.Tensor  # (F, 4)
    sqrt_info: torch.Tensor  # (F, 4, 4)
    mask: torch.Tensor
    robust_delta: torch.Tensor

    @staticmethod
    def residual(T_i, plane_world, plane_meas):
        n_w, d_w = plane_world[..., :3], plane_world[..., 3]
        r_n = torch.einsum("...ji,...j->...i", T_i[..., :3, :3], n_w) - plane_meas[..., :3]
        r_d = torch.sum(n_w * T_i[..., :3, 3], dim=-1) + d_w - plane_meas[..., 3]
        return torch.cat([r_n, r_d[..., None]], dim=-1)


class GraphData(NamedTuple):
    """All factors of a pose graph (fixed shapes; masks mark live entries)."""

    between: BetweenFactors
    priors: PriorFactors
    point_priors: PointPriorFactors
    quat_priors: QuatPriorFactors
    vec_priors: VecPriorFactors
    plane_factors: GroundPlaneFactors


# ---------------------------------------------------------------------------
# Plane-vertex factor families (g2o::VertexPlane graphs)
# ---------------------------------------------------------------------------
#
# A plane variable is a homogeneous 4-vector [n, d] with |n| = 1 (the plane
# n.x + d = 0); its local chart is 3-dof: two tangent directions of the unit
# normal plus the offset (`graph_slam.cpp:37-51`, `include/g2o/
# edge_plane_*.hpp`, `edge_se3_plane.hpp`).


def _cross(a, b):
    """a x b over the last axis (the same products as `jnp.cross`)."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _flip(x, neg):
    """x with its sign flipped where `neg` (one entry per leading index)."""
    return torch.where(neg[..., None], -x, x)


def plane_tangent_basis(n):
    """(..., 3, 2) orthonormal basis of the tangent space of S^2 at n."""
    # the seed axis least aligned with n, branch-free
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    e = torch.where((torch.abs(n[..., 2]) < 0.9)[..., None], ez, ex)
    b1 = _cross(n, e)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True), min=1e-12)
    b2 = _cross(n, b1)
    return torch.stack([b1, b2], dim=-1)


def retract_plane(plane, delta):
    """plane [n, d] (..., 4) + delta (..., 3) ->
    [normalize(n + B delta[:2]), d + delta[2]]."""
    n = plane[..., :3]
    B = plane_tangent_basis(n)
    n_new = n + B[..., 0] * delta[..., 0, None] + B[..., 1] * delta[..., 1, None]
    n_new = n_new / torch.clamp(torch.linalg.norm(n_new, dim=-1, keepdim=True), min=1e-12)
    return torch.cat([n_new, (plane[..., 3] + delta[..., 2])[..., None]], dim=-1)


def transform_plane(T, plane_world):
    """World plane [n, d] in the body frame of pose T (body->world):
    n_b = R^T n, d_b = d + n . t."""
    n, d = plane_world[..., :3], plane_world[..., 3]
    n_b = torch.einsum("...ji,...j->...i", T[..., :3, :3], n)
    return torch.cat([n_b, (d + torch.sum(n * T[..., :3, 3], dim=-1))[..., None]], dim=-1)


class PlanePriorFactors(NamedTuple):
    """Unary priors on a plane vertex: EdgePlanePriorNormal (sign-fixed
    normal - meas, 3-dof) and EdgePlanePriorDistance (distance - meas, 1-dof)
    in one 4-dim residual; the builder zeroes the sqrt_info rows of the
    unused part."""

    i: torch.Tensor  # (F,) plane index
    n_meas: torch.Tensor  # (F, 3)
    d_meas: torch.Tensor  # (F,)
    sqrt_info: torch.Tensor  # (F, 4, 4)
    mask: torch.Tensor
    robust_delta: torch.Tensor

    @staticmethod
    def residual(plane_i, n_meas, d_meas):
        n = plane_i[..., :3]
        n = _flip(n, torch.sum(n * n_meas, dim=-1) < 0)
        return torch.cat([n - n_meas, (plane_i[..., 3] - d_meas)[..., None]], dim=-1)


class PlanePlaneFactors(NamedTuple):
    """Binary plane-plane constraints, by `kind`: 0 identity (sign-fixed
    (p_j - p_i) - meas, 4-dof), 1 parallel (sign-fixed (n_j - n_i) -
    meas[:3], 3-dof), 2 perpendicular (n_i . n_j, 1-dof). All three are
    evaluated and the factor's kind selects one (the JAX `lax.switch` under
    `vmap`)."""

    i: torch.Tensor
    j: torch.Tensor
    kind: torch.Tensor  # (F,) int
    meas: torch.Tensor  # (F, 4)
    sqrt_info: torch.Tensor  # (F, 4, 4)
    mask: torch.Tensor
    robust_delta: torch.Tensor

    @staticmethod
    def residual(plane_i, plane_j, kind, meas):
        zero = torch.zeros_like(plane_i[..., :1])
        identity = _flip(plane_j, torch.sum(plane_i * plane_j, dim=-1) < 0) - plane_i - meas
        ni, nj = plane_i[..., :3], plane_j[..., :3]
        nj_s = _flip(nj, torch.sum(ni * nj, dim=-1) < 0)
        parallel = torch.cat([(nj_s - ni) - meas[..., :3], zero], dim=-1)
        ni_u = ni / torch.clamp(torch.linalg.norm(ni, dim=-1, keepdim=True), min=1e-12)
        nj_u = nj / torch.clamp(torch.linalg.norm(nj, dim=-1, keepdim=True), min=1e-12)
        perpendicular = torch.cat([torch.sum(ni_u * nj_u, dim=-1, keepdim=True), zero, zero,
                                   zero], dim=-1)
        k = torch.clamp(torch.as_tensor(kind, device=plane_i.device), 0, 2)[..., None]
        return torch.where(k == 0, identity, torch.where(k == 1, parallel, perpendicular))


class SE3PlaneFactors(NamedTuple):
    """Binary pose-plane factors: the world plane j observed from pose i
    (EdgeSE3Plane, `edge_se3_plane.hpp:40-47`): the local plane T_i^-1 plane_j
    against the body-frame measurement, as the 3-dof chart residual
    [B(n_meas)^T (n_b - n_meas), d_b - d_meas]."""

    i: torch.Tensor  # pose index
    j: torch.Tensor  # plane index
    plane_meas: torch.Tensor  # (F, 4) body-frame measurement [n, d]
    sqrt_info: torch.Tensor  # (F, 3, 3)
    mask: torch.Tensor
    robust_delta: torch.Tensor

    @staticmethod
    def residual(T_i, plane_j, plane_meas):
        local = transform_plane(T_i, plane_j)
        n_meas = plane_meas[..., :3]
        local = _flip(local, torch.sum(local[..., :3] * n_meas, dim=-1) < 0)
        B = plane_tangent_basis(n_meas)
        r_n = torch.einsum("...ij,...i->...j", B, local[..., :3] - n_meas)
        return torch.cat([r_n, (local[..., 3] - plane_meas[..., 3])[..., None]], dim=-1)


class ZBetweenFactors(NamedTuple):
    """Relative-altitude factors, EdgeSE3Z (`edge_se3_z.hpp:44-50`):
    (z_j - z_i) - meas, 1-dof."""

    i: torch.Tensor
    j: torch.Tensor
    z_meas: torch.Tensor  # (F,)
    sqrt_info: torch.Tensor  # (F, 1, 1)
    mask: torch.Tensor
    robust_delta: torch.Tensor

    @staticmethod
    def residual(T_i, T_j, z_meas):
        return (T_j[..., 2, 3] - T_i[..., 2, 3] - z_meas)[..., None]


class UTMAlignFactors(NamedTuple):
    """UTM->world alignment observations on one transform vertex,
    EdgeSE3GtUTM (`edge_se3_gt_utm.hpp:39-45`): (T_i [p_utm, 1])[:3] - p_world."""

    i: torch.Tensor
    p_utm: torch.Tensor  # (F, 3)
    p_world: torch.Tensor  # (F, 3)
    sqrt_info: torch.Tensor  # (F, 3, 3)
    mask: torch.Tensor
    robust_delta: torch.Tensor

    @staticmethod
    def residual(T_i, p_utm, p_world):
        return (torch.einsum("...ij,...j->...i", T_i[..., :3, :3], p_utm) + T_i[..., :3, 3]
                - p_world)


class PlaneGraphData(NamedTuple):
    """The factor set of graphs with plane vertices (and the 1-dof /
    alignment SE3 edges), optimized jointly with `GraphData` by
    `solver.optimize_graph_with_planes` / `sparse.optimize_graph_with_planes_sparse`."""

    plane_priors: PlanePriorFactors
    plane_plane: PlanePlaneFactors
    se3_plane: SE3PlaneFactors
    z_between: ZBetweenFactors
    utm_align: UTMAlignFactors


def huber_weight(chi2, delta):
    """IRLS weight of the Huber kernel on the whitened residual norm; factors
    with delta = inf are unweighted."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-30))
    inf = torch.isinf(delta)
    delta_safe = torch.where(inf, torch.ones_like(delta), delta)
    w = torch.where(e <= delta, torch.ones_like(e), delta_safe / e)
    return torch.where(inf, torch.ones_like(w), w)


def _tile(a, n):
    return np.tile(np.asarray(a), (n,) + (1,) * np.ndim(a))


def empty_graph(
    n_between: int,
    n_priors: int = 4,
    n_point_priors: int = 0,
    n_quat_priors: int = 0,
    n_vec_priors: int = 0,
    n_plane_factors: int = 0,
    dtype=np.float64,
) -> GraphData:
    """Host-side numpy buffers of a graph with the given capacities; the
    `PoseGraph` fills them by plain assignment and converts once (`to_tensors`)."""

    def common(n):
        return dict(
            i=np.zeros((n,), np.int64), mask=np.zeros((n,), bool),
            robust_delta=np.full((n,), math.inf, dtype),
        )

    up3 = np.asarray([0.0, 0.0, 1.0], dtype)
    up4 = np.asarray([0.0, 0.0, 1.0, 0.0], dtype)
    nb, npr = n_between, n_priors
    npp, nq, nv, npl = (max(n, 1) for n in (n_point_priors, n_quat_priors, n_vec_priors,
                                            n_plane_factors))
    return GraphData(
        between=BetweenFactors(
            j=np.zeros((nb,), np.int64), T_meas=_tile(np.eye(4, dtype=dtype), nb),
            sqrt_info=_tile(np.eye(6, dtype=dtype), nb), **common(nb)),
        priors=PriorFactors(
            T_meas=_tile(np.eye(4, dtype=dtype), npr),
            sqrt_info=_tile(np.eye(6, dtype=dtype), npr), **common(npr)),
        point_priors=PointPriorFactors(
            p_meas=np.zeros((npp, 3), dtype), axis_mask=np.ones((npp, 3), dtype),
            sqrt_info=_tile(np.eye(3, dtype=dtype), npp), **common(npp)),
        quat_priors=QuatPriorFactors(
            R_meas=_tile(np.eye(3, dtype=dtype), nq),
            sqrt_info=_tile(np.eye(3, dtype=dtype), nq), **common(nq)),
        vec_priors=VecPriorFactors(
            dir_world=_tile(up3, nv), dir_meas=_tile(up3, nv),
            sqrt_info=_tile(np.eye(3, dtype=dtype), nv), **common(nv)),
        plane_factors=GroundPlaneFactors(
            plane_world=_tile(up4, npl), plane_meas=_tile(up4, npl),
            sqrt_info=_tile(np.eye(4, dtype=dtype), npl), **common(npl)),
    )


def _empty_common(n, dtype):
    return dict(i=np.zeros((n,), np.int64), mask=np.zeros((n,), bool),
                robust_delta=np.full((n,), math.inf, dtype))


def _empty_plane_priors(n, dtype):
    return PlanePriorFactors(
        n_meas=_tile(np.asarray([0.0, 0.0, 1.0], dtype), n), d_meas=np.zeros((n,), dtype),
        sqrt_info=_tile(np.eye(4, dtype=dtype), n), **_empty_common(n, dtype))


def _empty_plane_plane(n, dtype):
    return PlanePlaneFactors(
        j=np.zeros((n,), np.int64), kind=np.zeros((n,), np.int64),
        meas=np.zeros((n, 4), dtype), sqrt_info=_tile(np.eye(4, dtype=dtype), n),
        **_empty_common(n, dtype))


def _empty_se3_plane(n, dtype):
    return SE3PlaneFactors(
        j=np.zeros((n,), np.int64), plane_meas=_tile(np.asarray([0.0, 0.0, 1.0, 0.0], dtype), n),
        sqrt_info=_tile(np.eye(3, dtype=dtype), n), **_empty_common(n, dtype))


def _empty_z_between(n, dtype):
    return ZBetweenFactors(
        j=np.zeros((n,), np.int64), z_meas=np.zeros((n,), dtype),
        sqrt_info=np.ones((n, 1, 1), dtype), **_empty_common(n, dtype))


def _empty_utm_align(n, dtype):
    return UTMAlignFactors(
        p_utm=np.zeros((n, 3), dtype), p_world=np.zeros((n, 3), dtype),
        sqrt_info=_tile(np.eye(3, dtype=dtype), n), **_empty_common(n, dtype))


def empty_plane_graph(
    n_plane_priors: int = 0,
    n_plane_plane: int = 0,
    n_se3_plane: int = 0,
    n_z_between: int = 0,
    n_utm_align: int = 0,
    dtype=np.float64,
) -> PlaneGraphData:
    """Host-side numpy buffers of the plane families (capacity >= 1 each),
    filled by `PoseGraph.freeze_planes` and converted once."""
    return PlaneGraphData(
        plane_priors=_empty_plane_priors(max(n_plane_priors, 1), dtype),
        plane_plane=_empty_plane_plane(max(n_plane_plane, 1), dtype),
        se3_plane=_empty_se3_plane(max(n_se3_plane, 1), dtype),
        z_between=_empty_z_between(max(n_z_between, 1), dtype),
        utm_align=_empty_utm_align(max(n_utm_align, 1), dtype),
    )


def to_tensors(graph, device=None):
    """numpy-filled GraphData / PlaneGraphData -> tensors on `device`
    (indices int64)."""
    return type(graph)(*[
        type(fam)(*[torch.as_tensor(np.asarray(x), device=device) for x in fam])
        for fam in graph
    ])
