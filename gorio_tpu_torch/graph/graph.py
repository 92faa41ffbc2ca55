"""Host-side pose-graph assembly.

Port of `PoseGraph` from `gorio_tpu/graph/graph.py` (g2o persistence, the
`--dump` surface, is not ported: ROADMAP A13): it accumulates pose and
plane vertices and factors in Python lists, then `freeze()` packs the pose
factors into fixed-capacity `GraphData` tensors and `freeze_planes()` the
plane-vertex factors into `PlaneGraphData`, for the solvers. Capacities are
bucketed to powers of two (>= 4), as in the JAX package, so graphs of
similar size share shapes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .factors import empty_graph, empty_plane_graph, to_tensors


def _pad_to(n, cap):
    if cap is None:
        return max(4, 1 << (max(n, 1) - 1).bit_length())
    return cap


def _sqrt_info(info, dim, dtype):
    """Upper-triangular square root of an information matrix (scalar,
    diagonal, or full); the sqrt of the diagonal if it is not PD."""
    info = np.asarray(info, dtype=dtype)
    if info.ndim == 0:
        info = np.eye(dim, dtype=dtype) * info
    elif info.ndim == 1:
        info = np.diag(info)
    info = 0.5 * (info + info.T)
    try:
        L = np.linalg.cholesky(info + 1e-15 * np.eye(dim))
        return L.T.astype(dtype)
    except np.linalg.LinAlgError:
        return np.diag(np.sqrt(np.maximum(np.diag(info), 0.0))).astype(dtype)


def _fill(rows):
    """Write each family's factor tuples into its numpy buffers by field
    name, marking them live."""
    for fam, entries, names in rows:
        for n, entry in enumerate(entries):
            for name, value in zip(names, entry):
                getattr(fam, name)[n] = value
            fam.mask[n] = True


@dataclass
class PoseGraph:
    """Mutable graph under assembly; freeze() -> (poses, GraphData) for `optimize_graph`."""

    dtype: type = np.float64
    poses: list = field(default_factory=list)  # list of (4,4) np arrays
    planes: list = field(default_factory=list)  # list of (4,) np arrays [n, d]
    _between: list = field(default_factory=list)
    _priors: list = field(default_factory=list)
    _point_priors: list = field(default_factory=list)
    _quat_priors: list = field(default_factory=list)
    _vec_priors: list = field(default_factory=list)
    _plane_factors: list = field(default_factory=list)
    _plane_priors: list = field(default_factory=list)
    _plane_plane: list = field(default_factory=list)
    _se3_plane: list = field(default_factory=list)
    _z_between: list = field(default_factory=list)
    _utm_align: list = field(default_factory=list)

    def add_pose(self, T) -> int:
        self.poses.append(np.asarray(T, dtype=self.dtype))
        return len(self.poses) - 1

    def add_plane(self, coeffs) -> int:
        """Plane vertex [n, d], normalized to |n| = 1 (`add_plane_node`,
        `graph_slam.cpp:96`, g2o::VertexPlane)."""
        p = np.asarray(coeffs, dtype=self.dtype)
        self.planes.append(p / max(np.linalg.norm(p[:3]), 1e-12))
        return len(self.planes) - 1

    def add_between(self, i, j, T_meas, info, robust_delta=math.inf):
        """info is the 6x6 information matrix (rot block first)."""
        self._between.append(
            (i, j, np.asarray(T_meas, self.dtype), _sqrt_info(info, 6, self.dtype), robust_delta)
        )

    def add_prior(self, i, T_meas, info, robust_delta=math.inf):
        self._priors.append(
            (i, np.asarray(T_meas, self.dtype), _sqrt_info(info, 6, self.dtype), robust_delta)
        )

    def add_point_prior(self, i, p_meas, info, axes=(1, 1, 1), robust_delta=math.inf):
        self._point_priors.append(
            (i, np.asarray(p_meas, self.dtype), np.asarray(axes, self.dtype),
             _sqrt_info(info, 3, self.dtype), robust_delta)
        )

    def add_quat_prior(self, i, R_meas, info, robust_delta=math.inf):
        self._quat_priors.append(
            (i, np.asarray(R_meas, self.dtype), _sqrt_info(info, 3, self.dtype), robust_delta)
        )

    def add_vec_prior(self, i, dir_world, dir_meas, info, robust_delta=math.inf):
        self._vec_priors.append(
            (i, np.asarray(dir_world, self.dtype), np.asarray(dir_meas, self.dtype),
             _sqrt_info(info, 3, self.dtype), robust_delta)
        )

    def add_plane_factor(self, i, plane_world, plane_meas, info, robust_delta=math.inf):
        self._plane_factors.append(
            (i, np.asarray(plane_world, self.dtype), np.asarray(plane_meas, self.dtype),
             _sqrt_info(info, 4, self.dtype), robust_delta)
        )

    # ---- plane-vertex factors (g2o edge parity, `graph_slam.cpp:170-340`) -
    def add_plane_prior_normal(self, j, n_meas, info, robust_delta=math.inf):
        """EdgePlanePriorNormal (`add_plane_normal_prior_edge`)."""
        sq = np.zeros((4, 4), self.dtype)
        sq[:3, :3] = _sqrt_info(info, 3, self.dtype)
        self._plane_priors.append((j, np.asarray(n_meas, self.dtype), 0.0, sq, robust_delta))

    def add_plane_prior_distance(self, j, d_meas, info, robust_delta=math.inf):
        """EdgePlanePriorDistance (`add_plane_distance_prior_edge`)."""
        sq = np.zeros((4, 4), self.dtype)
        sq[3, 3] = math.sqrt(float(np.asarray(info).reshape(-1)[0]))
        self._plane_priors.append(
            (j, np.array([0.0, 0.0, 1.0], self.dtype), float(d_meas), sq, robust_delta))

    def add_plane_identity(self, i, j, meas, info, robust_delta=math.inf):
        """EdgePlaneIdentity (`add_plane_identity_edge`)."""
        self._plane_plane.append(
            (i, j, 0, np.asarray(meas, self.dtype), _sqrt_info(info, 4, self.dtype), robust_delta))

    def add_plane_parallel(self, i, j, meas, info, robust_delta=math.inf):
        """EdgePlaneParallel: meas is the expected 3-dof normal difference."""
        sq = np.zeros((4, 4), self.dtype)
        sq[:3, :3] = _sqrt_info(info, 3, self.dtype)
        m = np.zeros(4, self.dtype)
        m[:3] = np.asarray(meas, self.dtype)
        self._plane_plane.append((i, j, 1, m, sq, robust_delta))

    def add_plane_perpendicular(self, i, j, info, robust_delta=math.inf):
        """EdgePlanePerpendicular: penalizes n_i . n_j."""
        sq = np.zeros((4, 4), self.dtype)
        sq[0, 0] = math.sqrt(float(np.asarray(info).reshape(-1)[0]))
        self._plane_plane.append((i, j, 2, np.zeros(4, self.dtype), sq, robust_delta))

    def add_se3_plane(self, i, j, plane_meas, info, robust_delta=math.inf):
        """Pose i observes plane j (EdgeSE3Plane, `add_se3_plane_edge`,
        `graph_slam.cpp:110`); `plane_meas` is the body-frame [n, d]."""
        pm = np.asarray(plane_meas, self.dtype)
        pm = pm / max(np.linalg.norm(pm[:3]), 1e-12)
        self._se3_plane.append((i, j, pm, _sqrt_info(info, 3, self.dtype), robust_delta))

    def add_se3_z(self, i, j, z_meas, info, robust_delta=math.inf):
        """EdgeSE3Z (`edge_se3_z.hpp`): relative altitude z_j - z_i."""
        sq = np.array([[math.sqrt(float(np.asarray(info).reshape(-1)[0]))]], self.dtype)
        self._z_between.append((i, j, float(z_meas), sq, robust_delta))

    def add_utm_align(self, i, p_utm, p_world, info, robust_delta=math.inf):
        """EdgeSE3GtUTM: pose i maps the UTM point onto the world point."""
        self._utm_align.append(
            (i, np.asarray(p_utm, self.dtype), np.asarray(p_world, self.dtype),
             _sqrt_info(info, 3, self.dtype), robust_delta))

    def freeze_planes(self, capacity=None, device=None):
        """Pack the plane-vertex factors into `PlaneGraphData` tensors on
        `device`; returns (planes (M, 4), plane graph). Without a plane
        vertex, `planes` holds one unused [0, 0, 1, 0]."""
        pg = empty_plane_graph(
            _pad_to(len(self._plane_priors), capacity),
            _pad_to(len(self._plane_plane), capacity),
            _pad_to(len(self._se3_plane), capacity),
            _pad_to(len(self._z_between), capacity),
            _pad_to(len(self._utm_align), capacity),
            dtype=self.dtype,
        )
        rows = (
            (pg.plane_priors, self._plane_priors, ("i", "n_meas", "d_meas", "sqrt_info",
                                                   "robust_delta")),
            (pg.plane_plane, self._plane_plane, ("i", "j", "kind", "meas", "sqrt_info",
                                                 "robust_delta")),
            (pg.se3_plane, self._se3_plane, ("i", "j", "plane_meas", "sqrt_info",
                                             "robust_delta")),
            (pg.z_between, self._z_between, ("i", "j", "z_meas", "sqrt_info", "robust_delta")),
            (pg.utm_align, self._utm_align, ("i", "p_utm", "p_world", "sqrt_info",
                                             "robust_delta")),
        )
        _fill(rows)
        planes = (np.stack(self.planes) if self.planes
                  else np.array([[0.0, 0.0, 1.0, 0.0]])).astype(self.dtype)
        return torch.as_tensor(planes, device=device), to_tensors(pg, device)

    def freeze(self, capacity_between=None, capacity_unary=None, device=None):
        """Pack the factors into padded `GraphData` tensors on `device`;
        returns (poses (K, 4, 4), graph)."""
        g = empty_graph(
            _pad_to(len(self._between), capacity_between),
            _pad_to(len(self._priors), capacity_unary),
            _pad_to(len(self._point_priors), capacity_unary),
            _pad_to(len(self._quat_priors), capacity_unary),
            _pad_to(len(self._vec_priors), capacity_unary),
            _pad_to(len(self._plane_factors), capacity_unary),
            dtype=self.dtype,
        )
        rows = (
            (g.between, self._between, ("i", "j", "T_meas", "sqrt_info", "robust_delta")),
            (g.priors, self._priors, ("i", "T_meas", "sqrt_info", "robust_delta")),
            (g.point_priors, self._point_priors,
             ("i", "p_meas", "axis_mask", "sqrt_info", "robust_delta")),
            (g.quat_priors, self._quat_priors, ("i", "R_meas", "sqrt_info", "robust_delta")),
            (g.vec_priors, self._vec_priors,
             ("i", "dir_world", "dir_meas", "sqrt_info", "robust_delta")),
            (g.plane_factors, self._plane_factors,
             ("i", "plane_world", "plane_meas", "sqrt_info", "robust_delta")),
        )
        _fill(rows)
        poses = torch.as_tensor(np.stack(self.poses).astype(self.dtype), device=device)
        return poses, to_tensors(g, device)
