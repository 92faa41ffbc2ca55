"""Levenberg-Marquardt SE(3) least squares.

Port of `LMConfig`, `LMResult` and `lm_optimize` from
`gorio_tpu/registration/lsq.py`: the adaptive-lambda LM with inner retry
iterations and rot/trans epsilon convergence, left-multiplicative update with
the [exp(d_rot), d_trans] delta. The JAX `lax.while_loop`s become Python
loops with the same bounds, the same accept/reject bookkeeping and the same
iteration count. The host reads one small flag vector per inner iteration;
the inner loop nearly always accepts its first step, so that is one read per
outer iteration.

The cost callbacks follow the reference split:
  linearize(T)          -> (y0, H, b, aux)   # rebuilds correspondences
  compute_error(T, aux) -> y                 # reuses aux
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..core import lie


class LMConfig(NamedTuple):
    """Defaults mirror `lsq_registration_impl.hpp:11-22`."""

    max_iterations: int = 64
    lm_max_iterations: int = 10
    rotation_epsilon: float = 2e-3
    transformation_epsilon: float = 5e-4
    lm_init_lambda_factor: float = 1e-9


class LMResult(NamedTuple):
    T: torch.Tensor  # (4, 4) final transform
    H: torch.Tensor  # (6, 6) final Hessian (J^T W J)
    error: torch.Tensor  # () cost at the last linearization
    converged: torch.Tensor  # () bool, on the CPU
    iterations: torch.Tensor  # () int, on the CPU: outer LM iterations


def _is_converged(delta_T, cfg: LMConfig):
    """Parity with `lsq_registration_impl.hpp:83-92`."""
    R = delta_T[:3, :3] - torch.eye(3, dtype=delta_T.dtype, device=delta_T.device)
    r_delta = torch.max(torch.abs(R)) / cfg.rotation_epsilon
    t_delta = torch.max(torch.abs(delta_T[:3, 3])) / cfg.transformation_epsilon
    return torch.maximum(r_delta, t_delta) < 1.0


def lm_optimize(
    linearize: Callable,
    compute_error: Callable,
    T0,
    cfg: LMConfig = LMConfig(),
) -> LMResult:
    dtype, device = T0.dtype, T0.device
    eye6 = torch.eye(6, dtype=dtype, device=device)
    T = T0
    lam = None  # initialised from the first Hessian's diagonal
    H_final = eye6
    err = torch.tensor(float("inf"), dtype=dtype, device=device)
    iters, conv, failed = 0, False, False
    while iters < cfg.max_iterations and not conv and not failed:
        y0, H, b, aux = linearize(T)
        if lam is None:
            lam = cfg.lm_init_lambda_factor * torch.max(torch.abs(torch.diagonal(H)))
        nu = 2.0
        accepted = conv_rej = delta_conv = False
        for _ in range(cfg.lm_max_iterations):
            d = torch.linalg.solve(H + lam * eye6, -b)
            delta_T = lie.se3_exp_split(d)
            T_new = delta_T @ T
            yi = compute_error(T_new, aux)
            rho = (y0 - yi) / (d @ (lam * d - b))
            accept = rho >= 0.0
            small = _is_converged(delta_T, cfg)
            # a rejected-but-tiny step means we are at the optimum
            # (`lsq_registration_impl.hpp:156-159` returns success there)
            lam = torch.where(
                accept,
                lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                lam * nu,
            )
            accept_h, small_h = torch.stack([accept, small]).tolist()
            if accept_h:
                T, accepted, delta_conv = T_new, True, small_h
                break
            if small_h:
                conv_rej = True
                break
            nu *= 2.0
        if accepted or conv_rej:
            H_final = H
        err = y0
        conv = (accepted and delta_conv) or conv_rej
        failed = not (accepted or conv_rej)
        iters += 1
    return LMResult(
        T=T, H=H_final, error=err,
        converged=torch.tensor(conv), iterations=torch.tensor(iters),
    )
