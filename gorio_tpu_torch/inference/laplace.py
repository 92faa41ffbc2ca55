"""Laplace posterior over the factor graph and the graph log-density.

Port of `gorio_tpu/inference/laplace.py`: `graph_logprob` (the density HMC
and SMC sample, with a leading batch axis of chains or particles),
`whitened_logprob` (the Laplace-whitened density, its Cholesky on the host
in float64) and `laplace_sample` (draws from N(0, H^-1), the standard
normals passed in or drawn from a `torch.Generator`).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..graph.factors import GraphData, retract
from ..graph.solver import SolveResult, f32_matmuls, graph_chi2, laplace_covariance, live_graph


def graph_logprob(poses0, graph: GraphData) -> Callable:
    """log p(delta) = -0.5 chi2(poses0 ⊞ delta) over stacked local
    coordinates: delta (..., 6K) -> (...), one density value per chain or
    particle of the leading axes.

    Evaluated with TF32 off (full float32 matmuls on the card), the
    counterpart of the JAX package's `default_matmul_precision("float32")`:
    the leapfrog integrates the gradient, and ~3-digit noise in the tiny 4x4
    SE(3) products collapses HMC acceptance. The padding factors are cut
    once here (`live_graph`)."""
    K = poses0.shape[0]
    live = live_graph(graph)

    def logprob(delta):
        with f32_matmuls():
            poses = retract(poses0, delta.reshape(*delta.shape[:-1], K, 6))
            return -0.5 * graph_chi2(poses, live)

    return logprob


def whitened_logprob(lp, H, jitter: float = 1e-6):
    """Laplace-whitened density: returns (lp_y, L) with y = L^T x and
    L = chol(H + jitter I), so the posterior curvature at the mode is ~I in
    y, the preconditioning HMC needs on pose-graph posteriors (a diagonal
    inverse mass cannot undo a chain graph's cross-pose correlations). The
    Cholesky runs on the host in float64; `L` goes back to H's device and
    dtype. Map samples back with `unwhiten(L, y)`."""
    Hn = H.detach().cpu().to(torch.float64).numpy()
    Ln = np.linalg.cholesky(Hn + jitter * np.eye(Hn.shape[0]))
    L = torch.as_tensor(Ln, dtype=H.dtype, device=H.device)

    def lp_y(y):
        return lp(unwhiten(L, y))

    return lp_y, L


def unwhiten(L, y):
    """x with L^T x = y, for y (..., D): one triangular solve with every
    leading row as a right-hand side (TF32 off)."""
    D = y.shape[-1]
    with f32_matmuls():
        x = torch.linalg.solve_triangular(L.mT, y.reshape(-1, D).mT, upper=True)
    return x.mT.reshape(y.shape)


def laplace_sample(result: SolveResult, n_samples: int, generator=None, z=None):
    """Pose-perturbation samples (n_samples, 6K) from N(0, H^-1); `z`
    (n_samples, 6K) is the standard-normal draw, else drawn from
    `generator` on H's device."""
    cov = laplace_covariance(result)
    n = cov.shape[0]
    L = torch.linalg.cholesky(cov + 1e-12 * torch.eye(n, dtype=cov.dtype, device=cov.device))
    if z is None:
        z = torch.randn((n_samples, n), generator=generator, dtype=cov.dtype, device=cov.device)
    return z @ L.T
