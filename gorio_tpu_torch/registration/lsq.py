"""Levenberg-Marquardt SE(3) least squares.

Port of `LMConfig`, `LMResult`, `lm_optimize` and `gn_optimize` from
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
            # a singular system (no correspondence: H = 0, so lam = 0) gives a
            # non-finite step, as XLA's LU does, which the accept test rejects
            d, info = torch.linalg.solve_ex(H + lam * eye6, -b)
            d = torch.where(info == 0, d, torch.full_like(d, float("nan")))
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


def gn_optimize(linearize: Callable, T0, iterations: int = 8) -> LMResult:
    """Plain Gauss-Newton (`lsq_registration_impl.hpp:107-123`) with a fixed
    iteration count and no host read: `iterations` linearizations, each
    step d = -(H + 1e-9 I)^-1 b applied as se3_exp_split(d) @ T. The
    fastest choice when the prior is good (scan-to-scan with the
    ego-velocity motion guess)."""
    eye6 = torch.eye(6, dtype=T0.dtype, device=T0.device)
    T, y0, H = T0, None, None
    for _ in range(iterations):
        y0, H, b, _aux = linearize(T)
        d = torch.linalg.solve_ex(H + 1e-9 * eye6, -b)[0]
        T = lie.se3_exp_split(d) @ T
    return LMResult(T=T, H=H, error=y0, converged=torch.tensor(True),
                    iterations=torch.tensor(iterations))


def _is_converged_batch(delta_T, cfg: LMConfig):
    """`_is_converged` per lane: (B, 4, 4) -> (B,) bool."""
    R = delta_T[:, :3, :3] - torch.eye(3, dtype=delta_T.dtype, device=delta_T.device)
    r_delta = torch.amax(torch.abs(R), dim=(-2, -1)) / cfg.rotation_epsilon
    t_delta = torch.amax(torch.abs(delta_T[:, :3, 3]), dim=-1) / cfg.transformation_epsilon
    return torch.maximum(r_delta, t_delta) < 1.0


def lm_optimize_batch(
    linearize: Callable,
    compute_error: Callable,
    T0,
    cfg: LMConfig = LMConfig(),
) -> LMResult:
    """`lm_optimize` over B independent lanes at once: the counterpart of a
    `jax.vmap`ped `lm_optimize`. T0 (B, 4, 4); the callbacks take and return
    batched tensors (linearize(T (B, 4, 4)) -> (y0 (B,), H (B, 6, 6),
    b (B, 6), aux)).

    Each lane keeps its own lambda, nu, accepted / converged-on-reject /
    failed flags and iteration count, and a lane that has stopped keeps its
    state exactly, as the lanes of a vmapped `lax.while_loop` do: every lane
    returns what a single-lane run returns. One linearize (one batched 1-NN
    launch) per outer iteration of the batch, while any lane is running.
    The host reads one small flag tensor per inner iteration, never one per
    lane. Returns an LMResult with per-lane fields (converged and
    iterations on the CPU)."""
    B = T0.shape[0]
    dtype, device = T0.dtype, T0.device
    eye6 = torch.eye(6, dtype=dtype, device=device)
    T = T0
    lam = torch.full((B,), -1.0, dtype=dtype, device=device)
    H_final = eye6.expand(B, 6, 6).clone()
    err = torch.full((B,), float("inf"), dtype=dtype, device=device)
    iters = torch.zeros(B, dtype=torch.int64, device=device)
    conv = torch.zeros(B, dtype=torch.bool, device=device)
    failed = torch.zeros(B, dtype=torch.bool, device=device)
    running = torch.ones(B, dtype=torch.bool, device=device)
    any_running = B > 0
    outer = 0
    while outer < cfg.max_iterations and any_running:
        y0, H, b, aux = linearize(T)
        lam_i = torch.where(
            lam < 0.0, cfg.lm_init_lambda_factor * torch.amax(torch.abs(torch.diagonal(
                H, dim1=-2, dim2=-1)), dim=-1), lam)
        nu = torch.full((B,), 2.0, dtype=dtype, device=device)
        done = ~running  # lanes that stopped take no inner step
        T_acc, delta_acc = T, torch.eye(4, dtype=dtype, device=device).expand(B, 4, 4)
        accepted = torch.zeros(B, dtype=torch.bool, device=device)
        conv_rej = torch.zeros(B, dtype=torch.bool, device=device)
        for _ in range(cfg.lm_max_iterations):
            d = torch.linalg.solve_ex(H + lam_i[:, None, None] * eye6, -b)[0]
            delta_T = lie.se3_exp_split(d)
            T_new = delta_T @ T
            yi = compute_error(T_new, aux)
            rho = (y0 - yi) / torch.sum(d * (lam_i[:, None] * d - b), dim=-1)
            accept = rho >= 0.0
            conv_on_reject = ~accept & _is_converged_batch(delta_T, cfg)
            step = ~done
            lam_i = torch.where(step, torch.where(
                accept, lam_i * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                lam_i * nu), lam_i)
            nu = torch.where(step, torch.where(accept, 2.0, nu * 2.0), nu)
            take = step & accept
            T_acc = torch.where(take[:, None, None], T_new, T_acc)
            delta_acc = torch.where(take[:, None, None], delta_T, delta_acc)
            accepted = accepted | take
            conv_rej = conv_rej | (step & conv_on_reject)
            done = done | (step & (accept | conv_on_reject))
            # the outer state the inner loop leaves if it stops here, so that
            # one host read decides both loops
            ok = accepted | conv_rej
            conv_out = torch.where(
                running, (accepted & _is_converged_batch(delta_acc, cfg)) | conv_rej, conv)
            failed_out = torch.where(running, ~ok, failed)
            running_out = ~conv_out & ~failed_out & (iters + running < cfg.max_iterations)
            inner_done, any_running = torch.stack([done.all(), running_out.any()]).tolist()
            if inner_done:
                break
        H_final = torch.where((running & ok)[:, None, None], H, H_final)
        lam = torch.where(running, lam_i, lam)
        T = torch.where(running[:, None, None], T_acc, T)
        err = torch.where(running, y0, err)
        conv, failed = conv_out, failed_out
        iters = iters + running.to(iters.dtype)
        running = running_out
        outer += 1
    return LMResult(T=T, H=H_final, error=err, converged=conv.cpu(), iterations=iters.cpu())
