"""Piecewise-linear interpolation of irregularly sampled streams.

Port of `linear_interp` from `gorio_tpu/core/gp.py` (the only function of
that module on the LPM path; the SE-kernel integrals belong to UGPM).
"""

from __future__ import annotations

import torch


def linear_interp(query_t, data_t, data, extrapolate=True):
    """query_t (..., Q), data_t (N,) sorted, data (N, D) or (N,) ->
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
