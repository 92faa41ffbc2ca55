"""Plain SE(3) / SO(3) helpers of the benchmark's references, in torch.

Written from the textbook formulas, not from the program: Rodrigues'
exponential, the rotation log by atan2 of (sin, cos), and the full SE(3)
log with the closed-form V^-1. Work in any float dtype and batch over
leading axes; autograd differentiates them.
"""

from __future__ import annotations

import torch


def hat(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def vee(M):
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], -1)


def so3_exp(r):
    """Rodrigues: I + sin(t)/t K + (1 - cos t)/t^2 K^2, by series below
    t = 1e-3 (the series' first dropped terms are under 1e-19 there)."""
    t2 = (r * r).sum(-1)
    small = t2 < 1e-6
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0 + t2 * t2 / 120.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0 + t2 * t2 / 720.0, (1.0 - torch.cos(t)) / t2s)
    K = hat(r)
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R):
    """Rotation vector of R: angle atan2(|w|/2, (tr - 1)/2) about w = vee(R - R^T)
    (valid away from an angle of pi, which no residual here comes near)."""
    w = vee(R - R.transpose(-1, -2))
    s = 0.5 * torch.sqrt((w * w).sum(-1) + torch.finfo(R.dtype).tiny)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    theta = torch.atan2(s, c)
    small = s < 1e-6
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * torch.where(small,
                        torch.ones_like(s), s)))
    return scale[..., None] * w


def se3_log(T):
    """[rotation vector, V^-1 t] of T (..., 4, 4)."""
    r = so3_log(T[..., :3, :3])
    t2 = (r * r).sum(-1)
    small = t2 < 1e-6
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    c = torch.where(small, 1.0 / 12.0 + t2 / 720.0,
                    1.0 / t2s - (1.0 + torch.cos(t)) / (2.0 * t * torch.sin(t)))
    K = hat(r)
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = eye - 0.5 * K + c[..., None, None] * (K @ K)
    return torch.cat([r, (Vinv @ T[..., :3, 3:4])[..., 0]], -1)


def _se3(R, t):
    """4x4 from R (..., 3, 3) and t (..., 3), out of place (vmap-safe)."""
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom = torch.cat([bottom[..., :3], torch.ones_like(bottom[..., 3:])], -1)
    return torch.cat([top, bottom], -2)


def inverse(T):
    R = T[..., :3, :3].transpose(-1, -2)
    return _se3(R, -(R @ T[..., :3, 3:4])[..., 0])


def exp_split(d):
    """[exp(d_rot), d_trans] as a 4x4: the chart of the pose updates."""
    return _se3(so3_exp(d[..., :3]), d[..., 3:])
