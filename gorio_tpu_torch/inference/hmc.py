"""Hamiltonian Monte Carlo over trajectory posteriors.

Port of `gorio_tpu/inference/hmc.py`: `hmc_step` (one Metropolis-adjusted
leapfrog trajectory), Nesterov dual averaging, `run_hmc`,
`multinomial_hmc_step` (a static budget of 2^max_depth leapfrog steps with a
uniformly placed start and a Gumbel-max pick), `chain_ess` and
`potential_scale_reduction`.

Every function takes positions with a leading chain axis, (C, D), or a
single chain (D,): one call runs all chains, each with its own step size
under dual averaging. The gradient is `torch.autograd.grad` of the summed
log-density over the batched position: the chains are independent, so the
sum's gradient is each chain's own, and one forward and one backward pass
serve all chains (a natively batched density, `laplace.graph_logprob`, needs
no `vmap`). Accept decisions, divergences and the Gumbel-max pick are
`torch.where` over chain masks: nothing in the warmup, sampling or leapfrog
loops reads the device from the host.

On the card `run_hmc` evaluates the density and its gradient through a
captured CUDA graph (`CudaGraphed`): the same kernels, launched as one.

Traced (`utils.profiling.span`, on while a torch.profiler session records),
`run_hmc` keeps the spans `hmc.run` (the call, with the counts `chains`,
`warmup_draws`, `draws`, `leapfrog_steps`, `density_replays`,
`density_eager` and `captures`), `hmc.capture`, `hmc.init`, `hmc.loop`
(its warm-up and sampling iterations) and in it an `hmc.trajectory` around
each draw's trajectory, and `CudaGraphed` an `hmc.replay` around each
replay; on the card `hmc.run`, `hmc.loop`, `hmc.trajectory` and
`hmc.replay` carry CUDA event pairs. Tracing changes no kernel and no draw.

Randomness: `jax.random` cannot be reproduced, so each random draw enters
as a tensor (`z`, `log_u`, ...); the public functions draw them from an
explicit `torch.Generator` on the chains' device when they are not given.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..graph.solver import f32_matmuls
from ..utils import profiling


class HMCState(NamedTuple):
    position: torch.Tensor  # (..., D)
    log_prob: torch.Tensor  # (...)
    grad: torch.Tensor  # (..., D)


class HMCInfo(NamedTuple):
    accept_prob: torch.Tensor
    accepted: torch.Tensor
    energy: torch.Tensor


def value_and_grad(logprob_fn: Callable, q):
    """(log p(q), d log p / dq) for q (..., D), each chain's own; TF32 off
    for the backward pass as for the forward. A `CudaGraphed` density
    replays its captured graph, at its captured shape only."""
    if isinstance(logprob_fn, CudaGraphed):
        return logprob_fn.value_and_grad(q)
    profiling.count("density_eager")
    return _eager_value_and_grad(logprob_fn, q)


def _eager_value_and_grad(logprob_fn: Callable, q):
    with torch.enable_grad(), f32_matmuls():
        q = q.detach().requires_grad_(True)
        lp = logprob_fn(q)
        (g,) = torch.autograd.grad(lp.sum(), q)
    return lp.detach(), g


class CudaGraphed:
    """`logprob_fn` whose value and gradient at positions shaped like `like`
    (a CUDA tensor) are one captured CUDA graph, replayed per evaluation.
    Eager, a density evaluation over a pose graph is ~820 small kernels,
    each launched from the host; the replay launches them all at once."""

    def __init__(self, logprob_fn: Callable, like):
        self.q = like.detach().clone()
        side = torch.cuda.Stream(like.device)
        side.wait_stream(torch.cuda.current_stream(like.device))
        with torch.cuda.stream(side):  # warm-up: workspaces, handles, the allocator
            for _ in range(2):
                value_and_grad(logprob_fn, self.q)
        torch.cuda.current_stream(like.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.lp, self.g = _eager_value_and_grad(logprob_fn, self.q)
        profiling.count("captures")

    def value_and_grad(self, q):
        if q.shape != self.q.shape:
            raise ValueError(f"CudaGraphed: captured at {tuple(self.q.shape)}, called at "
                             f"{tuple(q.shape)}")
        self.q.copy_(q)
        with profiling.span("hmc.replay", self.q.device):
            self.graph.replay()
        profiling.count("density_replays")
        return self.lp.clone(), self.g.clone()


def _per_chain(x, like):
    """A step size (a float, () or (...) per chain) shaped to broadcast over
    `like` (..., D)."""
    x = torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x[..., None] if x.dim() else x


def hmc_init(logprob_fn: Callable, position) -> HMCState:
    lp, g = value_and_grad(logprob_fn, position)
    return HMCState(position=position, log_prob=lp, grad=g)


def _leapfrog(logprob_fn, q, p, grad, step_size, n_steps, inv_mass):
    eps = _per_chain(step_size, q)
    lp = None
    for _ in range(n_steps):
        p = p + 0.5 * eps * grad
        q = q + eps * (inv_mass * p)
        lp, grad = value_and_grad(logprob_fn, q)
        p = p + 0.5 * eps * grad
    profiling.count("leapfrog_steps", n_steps)
    return q, p, grad, lp


def hmc_step(state: HMCState, logprob_fn: Callable, step_size, n_leapfrog: int = 16,
             inv_mass=None, *, generator=None, z=None, log_u=None):
    """One Metropolis-adjusted leapfrog trajectory per chain. `z` (..., D)
    is the momentum's standard normal and `log_u` (...) the log of the
    accept uniform; both are drawn from `generator` when not given."""
    pos = state.position
    like = dict(dtype=pos.dtype, device=pos.device)
    if inv_mass is None:
        inv_mass = torch.ones(pos.shape[-1], **like)
    if z is None:
        z = torch.randn(pos.shape, generator=generator, **like)
    if log_u is None:
        log_u = torch.log(torch.rand(pos.shape[:-1], generator=generator, **like))
    p0 = z / torch.sqrt(inv_mass)
    q, p, grad, lp = _leapfrog(logprob_fn, pos, p0, state.grad, step_size, n_leapfrog, inv_mass)
    h0 = -state.log_prob + 0.5 * torch.sum(inv_mass * p0 * p0, dim=-1)
    h1 = -lp + 0.5 * torch.sum(inv_mass * p * p, dim=-1)
    # a divergent trajectory (non-finite energy) gets acceptance exactly 0,
    # not NaN, which would poison every average of it
    delta_h = h0 - h1
    log_accept = torch.where(torch.isfinite(delta_h), torch.clamp(delta_h, max=0.0),
                             torch.full_like(delta_h, -math.inf))
    accept = log_u < log_accept
    a = accept[..., None]
    new_state = HMCState(
        position=torch.where(a, q, pos),
        log_prob=torch.where(accept, lp, state.log_prob),
        grad=torch.where(a, grad, state.grad),
    )
    return new_state, HMCInfo(accept_prob=torch.exp(log_accept), accepted=accept, energy=h1)


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_bar: torch.Tensor
    t: torch.Tensor
    mu: torch.Tensor  # fixed shrinkage point log(10 * eps0)


def dual_averaging_init(step_size: float, shape=(), dtype=torch.float64, device=None):
    """One state per chain of `shape`."""
    ls = torch.full(shape, math.log(step_size), dtype=dtype, device=device)
    zero = torch.zeros(shape, dtype=dtype, device=device)
    return DualAveragingState(log_step=ls, log_step_avg=ls, h_bar=zero, t=zero,
                              mu=math.log(10.0) + ls)


def dual_averaging_update(da: DualAveragingState, accept_prob, target=0.8, gamma=0.05, t0=10.0,
                          kappa=0.75):
    """Nesterov dual averaging (Hoffman & Gelman 2014, Sec. 3.2) with the
    shrinkage point `mu` fixed at log(10 * eps0)."""
    t = da.t + 1.0
    h_bar = (1.0 - 1.0 / (t + t0)) * da.h_bar + (target - accept_prob) / (t + t0)
    log_step = da.mu - torch.sqrt(t) / gamma * h_bar
    eta = t ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * da.log_step_avg
    return DualAveragingState(log_step=log_step, log_step_avg=log_step_avg, h_bar=h_bar, t=t,
                              mu=da.mu)


def _n_warmup(n_samples, adapt, n_warmup):
    if n_warmup is None:
        n_warmup = n_samples // 2 if adapt else 0
    return n_warmup if adapt else 0


def run_hmc(logprob_fn: Callable, position0, n_samples: int = 100, step_size: float = 0.05,
            n_leapfrog: int = 16, adapt: bool = True, inv_mass=None, n_warmup: int | None = None,
            generator=None, *, draws=None):
    """All chains of `position0` (C, D) (or one chain, (D,)) in one call:
    returns samples (C, n_samples, D) and accept probabilities
    (C, n_samples).

    With `adapt=True`, `n_warmup` (default n_samples // 2) dual-averaging
    iterations run first, then the step size freezes at exp(log_step_avg)
    for the returned draws; warmup draws are discarded. `inv_mass` (D,) is
    a diagonal inverse mass. The draws come from `generator` on the chains'
    device, or as `draws` = (z_momenta (S, C, D), log_u (S, C)): per
    iteration (warmup first) the momenta's standard normals and the log of
    the accept uniforms."""
    if draws is None:
        S = _n_warmup(n_samples, adapt, n_warmup) + n_samples
        like = dict(dtype=position0.dtype, device=position0.device)
        draws = (torch.randn((S, *position0.shape), generator=generator, **like),
                 torch.log(torch.rand((S, *position0.shape[:-1]), generator=generator, **like)))
    return _run_hmc_core(logprob_fn, position0, n_samples, step_size, n_leapfrog, adapt,
                         inv_mass, n_warmup, *draws)


def _run_hmc_core(logprob_fn, position0, n_samples, step_size, n_leapfrog, adapt, inv_mass,
                  n_warmup, z_momenta, log_u):
    """`run_hmc` on given draws: z_momenta (S, C, D), log_u (S, C), S the
    warmup iterations followed by the sampling ones."""
    n_warm = _n_warmup(n_samples, adapt, n_warmup)
    dev = position0.device
    chains = math.prod(position0.shape[:-1])
    with profiling.span("hmc.run", dev, chains=chains, warmup_draws=n_warm, draws=n_samples):
        if position0.is_cuda:
            with profiling.span("hmc.capture"):
                logprob_fn = CudaGraphed(logprob_fn, position0)
        with profiling.span("hmc.init"):
            state = hmc_init(logprob_fn, position0)
        with profiling.span("hmc.loop", dev):
            return _iterate(logprob_fn, state, n_warm, n_samples, step_size, n_leapfrog,
                            inv_mass, z_momenta, log_u)


def _iterate(logprob_fn, state, n_warm, n_samples, step_size, n_leapfrog, inv_mass, z_momenta,
             log_u):
    """`run_hmc`'s warm-up and sampling iterations from `state`."""
    position0 = state.position
    dev = position0.device
    if n_warm > 0:
        da = dual_averaging_init(step_size, position0.shape[:-1], position0.dtype,
                                 position0.device)
        for s in range(n_warm):
            with profiling.span("hmc.trajectory", dev):
                state, info = hmc_step(state, logprob_fn, torch.exp(da.log_step), n_leapfrog,
                                       inv_mass, z=z_momenta[s], log_u=log_u[s])
            # a divergence counts as acceptance 0 for adaptation (Stan's rule)
            astat = torch.where(torch.isfinite(info.accept_prob), info.accept_prob,
                                torch.zeros_like(info.accept_prob))
            da = dual_averaging_update(da, astat)
        eps = torch.exp(da.log_step_avg)
    else:
        eps = torch.as_tensor(step_size, dtype=position0.dtype, device=position0.device)
    samples, accepts = [], []
    for s in range(n_warm, n_warm + n_samples):
        with profiling.span("hmc.trajectory", dev):
            state, info = hmc_step(state, logprob_fn, eps, n_leapfrog, inv_mass, z=z_momenta[s],
                                   log_u=log_u[s])
        samples.append(state.position)
        accepts.append(info.accept_prob)
    return torch.stack(samples, dim=-2), torch.stack(accepts, dim=-1)


def chain_ess(chains):
    """Multi-chain Markov-chain ESS over (n_chains, n_samples, dim) -> (dim,)
    numpy: per-chain FFT autocovariances pooled with the between-chain
    variance, truncated by Geyer's initial monotone positive pair sequence
    (BDA3 §11.5). Host numpy, a diagnostic read once per run."""
    x = np.asarray(chains.cpu() if isinstance(chains, torch.Tensor) else chains, np.float64)
    m, n, d = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    nfft = 1 << int(2 * n - 1).bit_length()
    f = np.fft.rfft(xc, nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), nfft, axis=1)[:, :n] / n  # (m,n,d)
    W = x.var(axis=1, ddof=1).mean(axis=0)  # within-chain (d,)
    B_over_n = x.mean(axis=1).var(axis=0, ddof=1) if m > 1 else np.zeros(d)
    var_plus = W * (n - 1) / n + B_over_n
    var_plus = np.maximum(var_plus, 1e-300)
    rho = 1.0 - (W[None, :] - acov.mean(axis=0)) / var_plus  # (n,d)
    # Geyer pairs P_t = rho_{2t} + rho_{2t+1}: monotone non-increasing, >= 0
    n_pair = (n - 1) // 2
    P = rho[0: 2 * n_pair: 2] + rho[1: 2 * n_pair + 1: 2]  # (n_pair,d)
    P = np.minimum.accumulate(P, axis=0)
    P = np.where(P > 0.0, P, 0.0)
    tau = np.maximum(-1.0 + 2.0 * P.sum(axis=0), 1.0 / (m * n))
    return np.minimum(m * n / tau, m * n * 1.0)


def potential_scale_reduction(chains):
    """Split R-hat over (n_chains, n_samples, dim) -> (dim,)."""
    chains = torch.as_tensor(chains)
    m, n, d = chains.shape
    half = n // 2
    split = chains[:, : 2 * half].reshape(2 * m, half, d)
    means = torch.mean(split, dim=1)
    vars_ = torch.var(split, dim=1, correction=1)
    W = torch.mean(vars_, dim=0)
    B = half * torch.var(means, dim=0, correction=1)
    var_hat = (half - 1) / half * W + B / half
    return torch.sqrt(var_hat / torch.clamp(W, min=1e-30))


def _gumbel(u):
    return -torch.log(-torch.log(u + 1e-30) + 1e-30)


def multinomial_hmc_step(state: HMCState, logprob_fn: Callable, step_size, max_depth: int = 6,
                         *, generator=None, z=None, n_fwd=None, u_gumbel=None, u_g0=None):
    """One multinomial-HMC transition per chain with a static budget of
    N = 2^max_depth leapfrog steps (Betancourt, arXiv:1701.02434, App. A.2):
    momentum p0; n_fwd ~ U{0..N} steps forward from (q0, p0) and N - n_fwd
    backward; one of the N + 1 states picked with probability ∝ exp(-H) by
    Gumbel-max (strict `>`: the earliest of equal scores wins). The draws:
    `z` (..., D) the momentum, `n_fwd` (...) int, `u_gumbel` (..., N) and
    `u_g0` (...) the Gumbel uniforms of the trajectory and of the start."""
    pos = state.position
    lead = pos.shape[:-1]
    like = dict(dtype=pos.dtype, device=pos.device)
    n_steps = 2 ** max_depth
    if z is None:
        z = torch.randn(pos.shape, generator=generator, **like)
    if n_fwd is None:
        n_fwd = torch.randint(0, n_steps + 1, lead, generator=generator, device=pos.device)
    if u_gumbel is None:
        u_gumbel = torch.rand((*lead, n_steps), generator=generator, **like)
    if u_g0 is None:
        u_g0 = torch.rand(lead, generator=generator, **like)
    n_fwd = torch.as_tensor(n_fwd, device=pos.device)
    p0 = z
    h0 = -state.log_prob + 0.5 * torch.sum(p0 * p0, dim=-1)
    gumbels = _gumbel(u_gumbel)
    step = torch.as_tensor(step_size, **like)
    q, p, grad = pos, p0, state.grad
    best_q, best_lp, best_grad, best_score = pos, state.log_prob, state.grad, _gumbel(u_g0)
    for i in range(n_steps):
        # at step n_fwd the integration restarts from (q0, p0) going backward
        restart = (n_fwd == i)[..., None]
        q = torch.where(restart, pos, q)
        p = torch.where(restart, p0, p)
        grad = torch.where(restart, state.grad, grad)
        eps = torch.where(n_fwd > i, step, -step)[..., None]
        p_half = p + 0.5 * eps * grad
        q = q + eps * p_half
        lp, grad = value_and_grad(logprob_fn, q)
        p = p_half + 0.5 * eps * grad
        h = -lp + 0.5 * torch.sum(p * p, dim=-1)
        score = h0 - h + gumbels[..., i]
        take = score > best_score
        t = take[..., None]
        best_q = torch.where(t, q, best_q)
        best_lp = torch.where(take, lp, best_lp)
        best_grad = torch.where(t, grad, best_grad)
        best_score = torch.where(take, score, best_score)
    return HMCState(position=best_q, log_prob=best_lp, grad=best_grad)
