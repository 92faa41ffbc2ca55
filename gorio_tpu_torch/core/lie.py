"""Batched SO(3)/SE(3) Lie-group math on tensors.

Port of `gorio_tpu/core/lie.py`. Every op works on arbitrarily batched inputs
`(..., 3)` / `(..., 3, 3)` and is safe under `torch.func.jacfwd`/`vmap`:
Taylor fallbacks near the identity are selected with `torch.where` over
branches whose denominators are clamped, so no branch produces inf/NaN.

Conventions: rotation vectors are axis*angle ("rotvec"), rotations act on
column vectors, SE(3) is stored as 4x4 homogeneous matrices.
"""

from __future__ import annotations

import math

import torch

# Below this squared-angle, use Taylor expansions (safe for f32 and f64).
_EPS = 1e-8


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def hat(v):
    """Skew-symmetric matrix of (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(M):
    """Inverse of `hat`: (..., 3, 3) -> (..., 3)."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2):
    """(sin t/t, (1-cos t)/t^2, (t - sin t)/t^3) with Taylor fallbacks for
    small angles; denominators use the clamped theta2 so the unselected
    branch stays finite."""
    t2 = torch.clamp(theta2, min=_EPS)
    theta = torch.sqrt(t2)
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (t2 * theta))
    return a, b, c


def so3_exp(r):
    """SO(3) exponential map, (..., 3) -> (..., 3, 3). Rodrigues formula."""
    theta2 = torch.sum(r * r, dim=-1)
    a, b, _ = _sinc_coeffs(theta2)
    K = hat(r)
    KK = K @ K
    return _eye(3, r) + a[..., None, None] * K + b[..., None, None] * KK


def _log_margins(dtype):
    """(clip margin for cos(theta), near-pi sin threshold) for `dtype`.

    The margin keeps arccos strictly inside (-1, 1), where its derivative is
    finite, and must be representable in the input dtype: in float32,
    1 - 1e-14 rounds back to 1. float64/float32 use the JAX package's values
    (1e-14 / 1e-6); narrower types scale the f32 margin with their epsilon.
    The near-pi threshold must exceed sin(theta) at the clipped saturation
    angle sqrt(2 * margin)."""
    if dtype == torch.float64:
        return 1e-14, 1e-4
    if dtype == torch.float32:
        return 1e-6, 3e-3
    margin = max(1e-6, 8.0 * torch.finfo(dtype).eps)
    return margin, 2.0 * math.sqrt(2.0 * margin)


def so3_log(R):
    """SO(3) logarithm, (..., 3, 3) -> (..., 3) rotation vector.

    Robust around the identity and near angle pi (the axis is recovered from
    the largest diagonal of (R + R^T)/4 + I/2 when sin(theta) ~ 0)."""
    margin, near_pi_sin = _log_margins(R.dtype)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0 + margin, 1.0 - margin)
    theta = torch.arccos(cos_t)
    w = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    sin_t = torch.sin(theta)
    generic_scale = torch.where(
        sin_t > 1e-6, theta / torch.clamp(2.0 * sin_t, min=1e-30), torch.full_like(theta, 0.5)
    )
    r_generic = generic_scale[..., None] * w

    B = 0.25 * (R + R.transpose(-1, -2)) + 0.5 * _eye(3, R)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis2 = torch.clamp((diag + 1.0) * 0.5, min=0.0)
    k = torch.argmax(axis2, dim=-1, keepdim=True)  # (..., 1)
    ax = torch.sqrt(torch.clamp(torch.gather(axis2, -1, k)[..., 0], min=1e-30))
    rowk = torch.gather(B, -2, k[..., None].expand(*k.shape, 3))[..., 0, :]
    axis_pi = rowk / torch.where(ax > 0, ax, torch.ones_like(ax))[..., None]
    axis_pi = axis_pi / torch.clamp(torch.linalg.norm(axis_pi, dim=-1, keepdim=True), min=1e-30)
    sgn = torch.where(torch.sum(axis_pi * w, dim=-1) < 0, -1.0, 1.0).to(R.dtype)
    r_pi = (theta * sgn)[..., None] * axis_pi

    near_pi = sin_t <= near_pi_sin
    big_angle = theta > 1.0  # only trust the pi-branch for genuinely large angles
    return torch.where((near_pi & big_angle)[..., None], r_pi, r_generic)


def so3_right_jacobian(r):
    """Right Jacobian J_r of the SO(3) exp map, (..., 3) -> (..., 3, 3)."""
    theta2 = torch.sum(r * r, dim=-1)
    _, b, c = _sinc_coeffs(theta2)
    K = hat(r)
    KK = K @ K
    return _eye(3, r) - b[..., None, None] * K + c[..., None, None] * KK


def _cot_term(theta2):
    """1/t^2 - (1+cos t)/(2 t sin t), with its Taylor fallback."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < _EPS
    return torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / torch.clamp(theta2, min=_EPS)
        - (1.0 + torch.cos(theta)) / torch.clamp(2.0 * theta * torch.sin(theta), min=1e-30),
    )


def so3_right_jacobian_inv(r):
    """Inverse right Jacobian, (..., 3) -> (..., 3, 3)."""
    K = hat(r)
    KK = K @ K
    cot = _cot_term(torch.sum(r * r, dim=-1))
    return _eye(3, r) + 0.5 * K + cot[..., None, None] * KK


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_normalize(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-30)


def quat_to_mat(q):
    """Unit quaternion (..., 4) [w,x,y,z] -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        dim=-2,
    )


def mat_to_quat(R):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [w,x,y,z].

    Branch-free Shepperd's method (selects the numerically best of 4 forms)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    mags = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1
    )
    best = torch.argmax(mags, dim=-1, keepdim=True)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    q = torch.gather(cands, -2, best[..., None].expand(*best.shape, 4))[..., 0, :]
    q = q / (2.0 * torch.sqrt(torch.clamp(torch.gather(mags, -1, best), min=1e-30)))
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_slerp(q0, q1, alpha):
    """Spherical interpolation between unit quaternions (batched)."""
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    dot = torch.clamp(torch.abs(dot), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_t = torch.sin(theta)
    use_lerp = sin_t < 1e-6
    safe = torch.where(use_lerp, torch.ones_like(sin_t), sin_t)
    w0 = torch.where(use_lerp, 1.0 - alpha, torch.sin((1.0 - alpha) * theta) / safe)
    w1 = torch.where(use_lerp, alpha * torch.ones_like(sin_t), torch.sin(alpha * theta) / safe)
    return quat_normalize(w0 * q0 + w1 * q1)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def se3_matrix(R, t):
    """(R (...,3,3), t (...,3)) -> homogeneous (..., 4, 4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(*batch, 3, 3)
    t = t.expand(*batch, 3)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = _eye(4, R)[3].expand(*batch, 4)[..., None, :]  # no host copy: capturable
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T):
    """Invert (..., 4, 4) homogeneous transforms."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return se3_matrix(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def se3_apply(T, p):
    """Apply (..., 4, 4) to points (..., N, 3) (or (N, 3))."""
    p = p if p.dim() >= 2 else p[None]
    return torch.einsum("...ij,...nj->...ni", T[..., :3, :3], p) + T[..., None, :3, 3]


def se3_exp(xi):
    """se(3) exp: (..., 6) [rot, trans] -> (..., 4, 4)."""
    r = xi[..., :3]
    v = xi[..., 3:]
    _, b, c = _sinc_coeffs(torch.sum(r * r, dim=-1))
    K = hat(r)
    V = _eye(3, xi) + b[..., None, None] * K + c[..., None, None] * (K @ K)
    return se3_matrix(so3_exp(r), torch.einsum("...ij,...j->...i", V, v))


def se3_exp_split(xi):
    """Rotation-exp + raw translation update used by the LM step:
    delta = [exp(d_rot), d_trans]."""
    return se3_matrix(so3_exp(xi[..., :3]), xi[..., 3:])


def se3_log(T):
    """(..., 4, 4) -> (..., 6) [rot, trans] full SE(3) log."""
    r = so3_log(T[..., :3, :3])
    cot = _cot_term(torch.sum(r * r, dim=-1))
    K = hat(r)
    Vinv = _eye(3, T) - 0.5 * K + cot[..., None, None] * (K @ K)
    v = torch.einsum("...ij,...j->...i", Vinv, T[..., :3, 3])
    return torch.cat([r, v], dim=-1)


def rpy_to_mat(roll, pitch, yaw):
    """ZYX euler angles to rotation matrix (parity with ros tf)."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


def mat_to_ypr(R):
    """Rotation matrix -> (yaw, pitch, roll)."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    pitch = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return yaw, pitch, roll


def rotation_geodesic_angle(Ra, Rb):
    """Angle of Ra^T Rb in radians (batched)."""
    M = Ra.transpose(-1, -2) @ Rb
    tr = M[..., 0, 0] + M[..., 1, 1] + M[..., 2, 2]
    return torch.arccos(torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0))
