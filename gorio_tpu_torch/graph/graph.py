"""Host-side pose-graph assembly.

Port of the pose part of `PoseGraph` from `gorio_tpu/graph/graph.py`: it
accumulates factors in Python lists, then `freeze()` packs them into
fixed-capacity `GraphData` tensors for the solver. Capacities are bucketed
to powers of two (>= 4), as in the JAX package, so graphs of similar size
share shapes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from .factors import empty_graph, to_tensors


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


@dataclass
class PoseGraph:
    """Mutable graph under assembly; freeze() -> (poses, GraphData) for `optimize_graph`."""

    dtype: type = np.float64
    poses: list = field(default_factory=list)  # list of (4,4) np arrays
    _between: list = field(default_factory=list)
    _priors: list = field(default_factory=list)
    _point_priors: list = field(default_factory=list)
    _quat_priors: list = field(default_factory=list)
    _vec_priors: list = field(default_factory=list)
    _plane_factors: list = field(default_factory=list)

    def add_pose(self, T) -> int:
        self.poses.append(np.asarray(T, dtype=self.dtype))
        return len(self.poses) - 1

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
        for fam, entries, names in rows:
            for n, entry in enumerate(entries):
                for name, value in zip(names, entry):
                    getattr(fam, name)[n] = value
                fam.mask[n] = True
        poses = torch.as_tensor(np.stack(self.poses).astype(self.dtype), device=device)
        return poses, to_tensors(g, device)
