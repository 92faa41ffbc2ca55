"""Trajectory export (TUM format) and ATE/RTE metrics.

The port's own copy of `gorio_tpu/io/tum.py` (numpy and scipy only), so the
port imports nothing of the JAX package: `save_tum` / `load_tum` write and
read `timestamp tx ty tz qx qy qz qw` lines, `ate_rmse` is the absolute
trajectory error after stamp association and SE(3) Umeyama alignment, `rte`
the relative translation error over fixed-length segments.
"""

from __future__ import annotations

import numpy as np


def save_tum(path, stamps, poses):
    """poses (T, 4, 4)."""
    from scipy.spatial.transform import Rotation

    with open(path, "w") as fh:
        for t, T in zip(np.asarray(stamps), np.asarray(poses)):
            q = Rotation.from_matrix(T[:3, :3]).as_quat()  # x y z w
            p = T[:3, 3]
            fh.write(f"{t} {p[0]} {p[1]} {p[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")


def load_tum(path):
    from scipy.spatial.transform import Rotation

    stamps, poses = [], []
    with open(path) as fh:
        for line in fh:
            tok = line.split()
            if len(tok) != 8:
                continue
            stamps.append(float(tok[0]))
            p = np.array(list(map(float, tok[1:4])))
            q = np.array(list(map(float, tok[4:8])))
            T = np.eye(4)
            T[:3, :3] = Rotation.from_quat(q).as_matrix()
            T[:3, 3] = p
            poses.append(T)
    return np.asarray(stamps), np.stack(poses)


def umeyama_alignment(src, dst, with_scale=False):
    """Least-squares similarity transform src -> dst ((N,3) each)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    C = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(C)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / src.shape[0]
        c = (D * np.diag(S)).sum() / var_s
    else:
        c = 1.0
    t = mu_d - c * R @ mu_s
    return c, R, t


def _associate(est_stamps, gt_stamps):
    """Index of the first ground-truth stamp at or after each estimate's."""
    return np.clip(
        np.searchsorted(np.asarray(gt_stamps), np.asarray(est_stamps)), 0, len(gt_stamps) - 1
    )


def ate_rmse(est_stamps, est_poses, gt_stamps, gt_poses, align=True):
    """Absolute trajectory error RMSE after stamp association (+ SE(3)
    alignment, the standard TUM evaluation)."""
    est_p = np.asarray(est_poses)[:, :3, 3]
    gt_p = np.asarray(gt_poses)[_associate(est_stamps, gt_stamps)][:, :3, 3]
    if align:
        c, R, t = umeyama_alignment(est_p, gt_p)
        est_p = (c * (R @ est_p.T)).T + t
    err = np.linalg.norm(est_p - gt_p, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def rte(est_stamps, est_poses, gt_stamps, gt_poses, delta=10):
    """Relative trajectory error over `delta`-frame segments (RMSE of the
    relative-pose translation error)."""
    est = np.asarray(est_poses)
    gt = np.asarray(gt_poses)[_associate(est_stamps, gt_stamps)]
    errs = []
    for i in range(0, est.shape[0] - delta):
        rel_e = np.linalg.inv(est[i]) @ est[i + delta]
        rel_g = np.linalg.inv(gt[i]) @ gt[i + delta]
        d = np.linalg.inv(rel_g) @ rel_e
        errs.append(np.linalg.norm(d[:3, 3]))
    return float(np.sqrt(np.mean(np.square(errs)))) if errs else 0.0
