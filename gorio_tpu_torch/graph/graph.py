"""Host-side pose-graph assembly and g2o persistence.

Port of `PoseGraph` from `gorio_tpu/graph/graph.py`: it accumulates pose
and plane vertices and factors in Python lists, then `freeze()` packs the
pose factors into fixed-capacity `GraphData` tensors and `freeze_planes()`
the plane-vertex factors into `PlaneGraphData`, for the solvers. Capacities
are bucketed to powers of two (>= 4), as in the JAX package, so graphs of
similar size share shapes. `save` / `load` write and read the JAX package's
g2o text (`GraphSLAM::save`, `graph_slam.cpp:384-391`) with its
robust-kernel sidecar (`robust_kernel_io.cpp`), so each package reads the
other's files.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..core import lie
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


# g2o orders the 6-dof error [trans, rot]; ours is [rot, trans]
_G2O_PERM = np.block([[np.zeros((3, 3)), np.eye(3)], [np.eye(3), np.zeros((3, 3))]])


def _upper(info):
    """The upper triangle of a symmetric matrix, row by row, as text."""
    d = info.shape[0]
    return " ".join(str(info[r, c]) for r in range(d) for c in range(r, d))


def _from_upper(vals, d):
    info = np.zeros((d, d))
    r, c = np.triu_indices(d)
    info[r, c] = vals
    info[c, r] = vals
    return info


def _pose_text(T):
    """g2o's `x y z qx qy qz qw` of a (4, 4) pose."""
    q = lie.mat_to_quat(torch.as_tensor(np.asarray(T[:3, :3], np.float64))).numpy()
    t = T[:3, 3]
    return f"{t[0]} {t[1]} {t[2]} {q[1]} {q[2]} {q[3]} {q[0]}"


def _pose_from(tok):
    """The pose of g2o's seven numbers `x y z qx qy qz qw`."""
    x = np.array(list(map(float, tok)))
    T = np.eye(4)
    T[:3, :3] = lie.quat_to_mat(torch.as_tensor(x[[6, 3, 4, 5]])).numpy()
    T[:3, 3] = x[:3]
    return T


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

    # ---- persistence (g2o text) -------------------------------------------
    def save(self, path, poses=None):
        """Write `VERTEX_SE3:QUAT` / `EDGE_SE3:QUAT` lines, the information
        in g2o's [trans, rot] order; SE(3) priors as `GORIO_PRIOR_SE3`
        lines, plane vertices (`VERTEX_PLANE`, ids after the poses') and
        their factors as `GORIO_*` lines, and each robust kernel as one
        `<tag> <ordinal> Huber <delta>` line of the `<path>.kernels`
        sidecar (`save_robust_kernels`, `robust_kernel_io.cpp:45-80`)."""
        ps = np.asarray(poses if poses is not None else self.poses)
        K = len(ps)
        lines, kernels = [], []
        lines += [f"VERTEX_SE3:QUAT {k} {_pose_text(T)}" for k, T in enumerate(ps)]

        def se3_info(sq):
            return _upper(_G2O_PERM @ (sq.T @ sq) @ _G2O_PERM.T)

        def write(families):
            for tag, entries, text in families:
                for ordinal, (*fields, rd) in enumerate(entries):
                    lines.append(f"{tag} {text(*fields)}")
                    if math.isfinite(rd):
                        kernels.append(f"{tag} {ordinal} Huber {rd}")

        write([
            ("EDGE_SE3:QUAT", self._between,
             lambda i, j, T, sq: f"{i} {j} {_pose_text(T)} {se3_info(sq)}"),
            ("GORIO_PRIOR_SE3", self._priors,
             lambda i, T, sq: f"{i} {_pose_text(T)} {se3_info(sq)}"),
        ])
        lines += [f"VERTEX_PLANE {K + m} {p[0]} {p[1]} {p[2]} {p[3]}"
                  for m, p in enumerate(np.asarray(self.planes).reshape(-1, 4))]
        write([
            ("GORIO_PLANE_PRIOR", self._plane_priors,
             lambda j, nm, dm, sq: f"{K + j} {nm[0]} {nm[1]} {nm[2]} {dm} {_upper(sq.T @ sq)}"),
            ("GORIO_PLANE_PLANE", self._plane_plane,
             lambda i, j, kind, m, sq: f"{K + i} {K + j} {kind} {m[0]} {m[1]} {m[2]} {m[3]} "
                                       f"{_upper(sq.T @ sq)}"),
            ("GORIO_SE3_PLANE", self._se3_plane,
             lambda i, j, pm, sq: f"{i} {K + j} {pm[0]} {pm[1]} {pm[2]} {pm[3]} "
                                  f"{_upper(sq.T @ sq)}"),
            ("GORIO_SE3_Z", self._z_between,
             lambda i, j, z, sq: f"{i} {j} {z} {float(sq[0, 0]) ** 2}"),
            ("GORIO_SE3_GT_UTM", self._utm_align,
             lambda i, pu, pw, sq: f"{i} {pu[0]} {pu[1]} {pu[2]} {pw[0]} {pw[1]} {pw[2]} "
                                   f"{_upper(sq.T @ sq)}"),
        ])
        with open(path, "w") as fh:
            fh.write("".join(line + "\n" for line in lines))
        if kernels:
            with open(str(path) + ".kernels", "w") as fh:
                fh.write("".join(line + "\n" for line in kernels))

    @classmethod
    def load(cls, path, dtype=np.float64):
        """Read what `save` writes (either package's), re-applying the robust
        kernels of the `<path>.kernels` sidecar (`load_robust_kernels`,
        `robust_kernel_io.cpp:84-128`). The graph stays on the host until
        `freeze(device=...)`."""
        g = cls(dtype=dtype)
        kernels = {}
        sidecar = Path(str(path) + ".kernels")
        if sidecar.exists():
            for line in sidecar.read_text().splitlines():
                tok = line.split()
                if len(tok) == 4:
                    kernels[(tok[0], int(tok[1]))] = float(tok[3])
        verts, plane_verts = {}, {}
        rows = {tag: [] for tag in ("EDGE_SE3:QUAT", "GORIO_PRIOR_SE3", "GORIO_PLANE_PRIOR",
                                    "GORIO_PLANE_PLANE", "GORIO_SE3_PLANE", "GORIO_SE3_Z",
                                    "GORIO_SE3_GT_UTM")}
        for line in Path(path).read_text().splitlines():
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "VERTEX_SE3:QUAT":
                verts[int(tok[1])] = _pose_from(tok[2:9])
            elif tok[0] == "VERTEX_PLANE":
                plane_verts[int(tok[1])] = np.array(list(map(float, tok[2:6])))
            elif tok[0] in rows:
                rows[tok[0]].append(tok[1:])

        def robust(tag, ordinal):
            return kernels.get((tag, ordinal), math.inf)

        def sqrt_se3(vals):
            return _sqrt_info(_G2O_PERM.T @ _from_upper(vals, 6) @ _G2O_PERM, 6, dtype)

        def sqrt_upper(vals, d):
            return _sqrt_info(_from_upper(vals, d), d, dtype)

        for k in sorted(verts):
            g.poses.append(verts[k])
        K = len(g.poses)  # plane ids follow the pose ids
        for k in sorted(plane_verts):
            g.planes.append(plane_verts[k].astype(dtype))
        for n, t in enumerate(rows["EDGE_SE3:QUAT"]):
            g._between.append((int(t[0]), int(t[1]), _pose_from(t[2:9]),
                               sqrt_se3(list(map(float, t[9:30]))), robust("EDGE_SE3:QUAT", n)))
        for n, t in enumerate(rows["GORIO_PRIOR_SE3"]):
            g._priors.append((int(t[0]), _pose_from(t[1:8]), sqrt_se3(list(map(float, t[8:29]))),
                              robust("GORIO_PRIOR_SE3", n)))
        for n, t in enumerate(rows["GORIO_PLANE_PRIOR"]):
            v = list(map(float, t[1:]))
            g._plane_priors.append((int(t[0]) - K, np.array(v[:3]), v[3], sqrt_upper(v[4:14], 4),
                                    robust("GORIO_PLANE_PRIOR", n)))
        for n, t in enumerate(rows["GORIO_PLANE_PLANE"]):
            v = list(map(float, t[3:]))
            g._plane_plane.append((int(t[0]) - K, int(t[1]) - K, int(t[2]), np.array(v[:4]),
                                   sqrt_upper(v[4:14], 4), robust("GORIO_PLANE_PLANE", n)))
        for n, t in enumerate(rows["GORIO_SE3_PLANE"]):
            v = list(map(float, t[2:]))
            g._se3_plane.append((int(t[0]), int(t[1]) - K, np.array(v[:4]), sqrt_upper(v[4:10], 3),
                                 robust("GORIO_SE3_PLANE", n)))
        for n, t in enumerate(rows["GORIO_SE3_Z"]):
            g._z_between.append((int(t[0]), int(t[1]), float(t[2]),
                                 np.array([[math.sqrt(float(t[3]))]], dtype),
                                 robust("GORIO_SE3_Z", n)))
        for n, t in enumerate(rows["GORIO_SE3_GT_UTM"]):
            v = list(map(float, t[1:]))
            g._utm_align.append((int(t[0]), np.array(v[:3]), np.array(v[3:6]),
                                 sqrt_upper(v[6:12], 3), robust("GORIO_SE3_GT_UTM", n)))
        return g
