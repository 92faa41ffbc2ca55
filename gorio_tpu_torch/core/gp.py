"""Squared-exponential GP kernel, its analytic time-integrals, the GP
Cholesky fits, and piecewise-linear interpolation.

Port of `gorio_tpu/core/gp.py` (`VelInt/math_utils.h:102-186,378`:
seKernel / seKernelIntegral / seKernelIntegralDt / seKernelIntegral2 /
kssInt). The kernels broadcast: `x1 (..., N)`, `x2 (..., M)` ->
`(..., N, M)`; `torch.special.erf` stands in for `jax.scipy.special.erf`.
They carry UGPM preintegration: the velocity / rotation-rate states live at
`state_time`, and the integrated quantities (rotation vector, position) are
linear functionals of the GP through these integrals.
"""

from __future__ import annotations

import math

import torch
from torch.special import erf

_SQRT2 = math.sqrt(2.0)
_SQRTPI = math.sqrt(math.pi)


def _sqrt(x):
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def se_kernel(x1, x2, l2, sf2):
    """k(x1, x2) = sf2 * exp(-(x1-x2)^2 / (2 l2)). Output (..., N, M)."""
    d = x1[..., :, None] - x2[..., None, :]
    return sf2 * torch.exp(d * d * (-0.5 / l2))


def se_kernel_integral(a, b, x2, l2, sf2):
    """Integral of the SE kernel in its first argument from `a` to `b[i]`:
    alpha * (erf(c (b_i - x2_j)) - erf(c (a - x2_j))), c = sqrt(1/(2 l2)).
    Output (..., N, M). `math_utils.h:114`."""
    inv_l = _sqrt(1.0 / l2)
    alpha = _SQRT2 * sf2 * _SQRTPI / (2.0 * inv_l)
    c = _SQRT2 * inv_l / 2.0
    upper = erf(c * (b[..., :, None] - x2[..., None, :]))
    lower = erf(c * (a - x2))[..., None, :]
    return alpha * (upper - lower)


def se_kernel_integral_dt(a, b, x2, l2, sf2):
    """d/db of the double-argument integral (time-shift Jacobians):
    sf2 (exp(-(b_i - x2_j)^2/(2 l2)) - exp(-(a - x2_j)^2/(2 l2))).
    `math_utils.h:130`."""
    up = sf2 * torch.exp(-((b[..., :, None] - x2[..., None, :]) ** 2) / (2.0 * l2))
    lo = sf2 * torch.exp(-((a - x2) ** 2) / (2.0 * l2))[..., None, :]
    return up - lo


def se_kernel_integral2(a, b, x2, l2, sf2):
    """Double integral \\int_a^{b_i} \\int_a^{s} k(u, x2_j) du ds
    (`math_utils.h:145`, seKernelIntegral2)."""
    inv_l = _sqrt(1.0 / l2)
    alpha = _SQRT2 * sf2 * _SQRTPI / (2.0 * inv_l)
    c = _SQRT2 * inv_l / 2.0
    a_x2 = a - x2  # (..., M)
    a_x2_erf = erf(c * a_x2)
    const = (_SQRT2 * torch.exp(-(a_x2 ** 2) / (2.0 * l2)) / (_SQRTPI * inv_l)
             + a_x2_erf * a_x2)[..., None, :]
    b_x2 = b[..., :, None] - x2[..., None, :]
    A = (
        a_x2_erf[..., None, :] * (a - b)[..., :, None]
        + erf(c * b_x2) * b_x2
        + _SQRT2 * torch.exp(-(b_x2 ** 2) / (2.0 * l2)) / (_SQRTPI * inv_l)
    )
    return alpha * (A - const)


def kss_int(a, b, l2, sf2):
    """Variance of the integrated GP, \\int_a^b \\int_a^b k(s, s') ds ds'
    (`math_utils.h:378`, kssInt); broadcasts."""
    d = a - b
    inv_l = _sqrt(1.0 / l2)
    return (
        2.0 * l2 * sf2 * torch.exp(-(d ** 2) / (2.0 * l2))
        - 2.0 * l2 * sf2
        + _SQRT2 * sf2 * _SQRTPI * erf(_SQRT2 * d * inv_l / 2.0) * d / inv_l
    )


def gp_fit_cholesky(K, sz2):
    """Lower Cholesky factor of (K + sz2 I) (no host check of the
    factorization: a matrix that is not positive definite gives a partial
    factor, where JAX's gives NaN; K + sz2 I with sz2 > 0 always is)."""
    n = K.shape[-1]
    return torch.linalg.cholesky_ex(K + sz2 * torch.eye(n, dtype=K.dtype, device=K.device))[0]


def cho_solve_lower(L, b):
    """Solve (L L^T) x = b for batched lower-triangular L."""
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


def gp_inv(K, sz2):
    """(K + sz2 I)^-1 through its Cholesky factor (batched). `preint.h:836-837`
    forms the explicit inverse too: UGPM reuses it against many right-hand
    sides and query rows."""
    n = K.shape[-1]
    L = gp_fit_cholesky(K, sz2)
    eye = torch.eye(n, dtype=K.dtype, device=K.device).expand(L.shape)
    return cho_solve_lower(L, eye)


def linear_interp(query_t, data_t, data, extrapolate=True):
    """Piecewise-linear interpolation of irregularly sampled streams.
    query_t (..., Q), data_t (N,) sorted, data (N, D) or (N,) ->
    (..., Q, D) / (..., Q). Extrapolates with the boundary segments."""
    squeeze = data.dim() == 1
    if squeeze:
        data = data[:, None]
    n = data_t.shape[0]
    idx = torch.clamp(torch.searchsorted(data_t, query_t.contiguous(), right=True) - 1, 0, n - 2)
    t0 = data_t[idx]
    t1 = data_t[idx + 1]
    d0 = data[idx]
    d1 = data[idx + 1]
    w = ((query_t - t0) / torch.clamp(t1 - t0, min=1e-30))[..., None]
    if not extrapolate:
        w = torch.clamp(w, 0.0, 1.0)
    out = d0 + w * (d1 - d0)
    return out[..., 0] if squeeze else out
