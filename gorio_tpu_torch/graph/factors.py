"""Typed pose-graph factors with batched residuals.

Port of the six pose-factor families of `gorio_tpu/graph/factors.py`, plus
`retract`, `huber_weight` and `empty_graph`. Each family is a NamedTuple of
tensors (struct-of-arrays, padded, with a live mask). Residuals accept any
leading batch shape; the solver takes their Jacobians per factor with
`torch.func.jacfwd` under `torch.func.vmap`.

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


def to_tensors(graph: GraphData, device=None) -> GraphData:
    """numpy-filled GraphData -> tensors on `device` (indices int64)."""
    return GraphData(*[
        type(fam)(*[torch.as_tensor(np.asarray(x), device=device) for x in fam])
        for fam in graph
    ])
