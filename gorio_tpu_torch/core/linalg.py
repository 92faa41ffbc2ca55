"""Closed-form small-matrix linear algebra, batched.

Port of `gorio_tpu/core/linalg.py`: the analytic (trigonometric) eigenvalues
of symmetric 3x3 matrices plus cross-product eigenvectors, with guarded
fallbacks for (near-)degenerate spectra, and the adjugate 3x3 inverse. Kept
closed-form (not `torch.linalg.eigh`) so the port computes the same basis as
the JAX package on degenerate spectra.
"""

from __future__ import annotations

import math

import torch


def inv3(M):
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, torch.full_like(det, 1e-30))
    adj = torch.stack(
        [
            torch.stack([A, -(b * i - c * h), (b * f - c * e)], -1),
            torch.stack([B, (a * i - c * g), -(a * f - c * d)], -1),
            torch.stack([C, -(a * h - b * g), (a * e - b * d)], -1),
        ],
        -2,
    )
    return adj * inv_det[..., None, None]


def sym_eigvals3(A):
    """Eigenvalues of symmetric (..., 3, 3), ascending (..., 3) (Smith's
    trigonometric method)."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-1, -2)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detB = (
        B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
        - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
        + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0])
    )
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    big = q + 2.0 * p * torch.cos(phi)
    small = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    mid = 3.0 * q - big - small
    iso = p2 < 1e-24
    return torch.stack(
        [torch.where(iso, q, small), torch.where(iso, q, mid), torch.where(iso, q, big)], dim=-1
    )


def _eigvec_for(A, lam_a, lam_b, scale):
    """Eigenvector of symmetric A orthogonal to the eigenspaces of lam_a and
    lam_b: the columns of (A - lam_a I)(A - lam_b I) span it; pick the
    largest. The validity threshold is relative to the spectral `scale`."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = (A - lam_a[..., None, None] * eye) @ (A - lam_b[..., None, None] * eye)
    norms = torch.linalg.norm(M, dim=-2)  # column norms (..., 3)
    best = torch.argmax(norms, dim=-1, keepdim=True)
    v = torch.gather(M, -1, best[..., None, :].expand(*best.shape[:-1], 3, 1))[..., 0]
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    ok = n[..., 0] > 1e-6 * scale * scale
    v = torch.where(ok[..., None], v / torch.clamp(n, min=1e-30), torch.zeros_like(v))
    return v, ok


def _perp(v):
    """Any unit vector orthogonal to unit v (branch-free)."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device).expand_as(v)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=v.dtype, device=v.device).expand_as(v)
    a = torch.linalg.cross(v, ex)
    an = torch.linalg.norm(a, dim=-1, keepdim=True)
    b = torch.linalg.cross(v, ey)
    bn = torch.linalg.norm(b, dim=-1, keepdim=True)
    return torch.where(an > 0.1, a / torch.clamp(an, min=1e-30), b / torch.clamp(bn, min=1e-30))


def sym_eigh3(A):
    """Symmetric 3x3 eigendecomposition: (evals ascending (..., 3), evecs
    (..., 3, 3) with evecs[..., :, k] the k-th eigenvector). A repeated
    eigenvalue pair collapses one cross-product eigenvector; the basis is then
    completed from the well-defined one."""
    lam = sym_eigvals3(A)
    l0, l1, l2 = lam[..., 0], lam[..., 1], lam[..., 2]
    scale = torch.clamp(torch.amax(torch.abs(lam), dim=-1), min=1e-30)
    v2c, ok2 = _eigvec_for(A, l0, l1, scale)  # largest; fails when l1 ~ l2
    v0c, ok0 = _eigvec_for(A, l1, l2, scale)  # smallest; fails when l0 ~ l1
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=A.dtype, device=A.device).expand_as(v2c)
    v2 = torch.where(ok2[..., None], v2c, torch.where(ok0[..., None], _perp(v0c), ez))
    v0 = torch.where(ok0[..., None], v0c, _perp(v2))
    v0 = v0 - torch.sum(v0 * v2, dim=-1, keepdim=True) * v2
    n0 = torch.linalg.norm(v0, dim=-1, keepdim=True)
    v0 = torch.where(n0 > 1e-6, v0 / torch.clamp(n0, min=1e-30), _perp(v2))
    v1 = torch.linalg.cross(v2, v0)
    return lam, torch.stack([v0, v1, v2], dim=-1)
