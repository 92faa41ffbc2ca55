"""Sequential Monte Carlo over trajectory posteriors.

Port of `gorio_tpu/inference/smc.py`: `smc_init`, the particle-weight
`effective_sample_size`, `systematic_resample`, `smc_step` (reweight ->
conditional resample -> jitter move), `smc_estimate`, and
`sharded_smc_step` as one shard: its arithmetic is the JAX package's sharded
form (weights normalised globally, log weights -log N after a resample),
on one card. Its mesh form belongs to ROADMAP A15.

`log_target` takes particles (N, D) and returns (N,). Every random draw
enters as a tensor (`z`, `u`) or comes from an explicit `torch.Generator`
on the particles' device; the resample decision is a `torch.where`, so no
step reads the device from the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

MESH_REFUSED = ("a device mesh is not ported yet (ROADMAP A15): pass mesh=None to run "
                "on one card")


class SMCState(NamedTuple):
    particles: torch.Tensor  # (N, D)
    log_weights: torch.Tensor  # (N,)


def _normal(shape, like, generator, z):
    if z is None:
        z = torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)
    return z


def _uniform(like, generator, u):
    if u is None:
        u = torch.rand((), generator=generator, dtype=like.dtype, device=like.device)
    return u


def smc_init(n_particles, mean, cov_diag, *, generator=None, z=None):
    """Particles mean + z * sqrt(cov_diag) with equal weights; `z` is
    (n_particles, D)."""
    noise = _normal((n_particles, mean.shape[0]), mean, generator, z)
    particles = mean[None, :] + noise * torch.sqrt(cov_diag)[None, :]
    return SMCState(particles=particles,
                    log_weights=torch.zeros(n_particles, dtype=mean.dtype, device=mean.device))


def effective_sample_size(log_weights):
    lw = log_weights - torch.logsumexp(log_weights, dim=0)
    return 1.0 / torch.sum(torch.exp(2.0 * lw))


def parents(cum, u, n):
    """Systematic resampling's parent indices against the cumulative
    weights `cum` (n,): the comb u / n + k / n, k < n."""
    us = u / n + torch.arange(n, dtype=cum.dtype, device=cum.device) / n
    return torch.clamp(torch.searchsorted(cum, us), 0, n - 1)


def systematic_resample(log_weights, n, *, generator=None, u=None):
    """Parent indices (n,); `u` is the uniform of the comb's offset."""
    lw = log_weights - torch.logsumexp(log_weights, dim=0)
    cum = torch.cumsum(torch.exp(lw), dim=0)
    return parents(cum, _uniform(lw, generator, u), n)


def smc_step(state: SMCState, log_target: Callable, proposal_std, ess_threshold: float = 0.5,
             *, generator=None, u=None, z=None):
    """One reweight -> (conditional) resample -> jitter move; returns
    (state, ess). `u` is the resampling uniform, `z` (N, D) the jitter's
    standard normals."""
    n = state.particles.shape[0]
    u = _uniform(state.particles, generator, u)
    noise = _normal(state.particles.shape, state.particles, generator, z)
    lw = state.log_weights + log_target(state.particles)
    ess = effective_sample_size(lw)
    do_resample = ess < ess_threshold * n
    idx = systematic_resample(lw, n, u=u)
    particles_rs = torch.where(do_resample, state.particles[idx], state.particles)
    lw_rs = torch.where(do_resample, torch.zeros_like(lw), lw)
    return SMCState(particles=particles_rs + noise * proposal_std, log_weights=lw_rs), ess


def smc_estimate(state: SMCState):
    w = torch.exp(state.log_weights - torch.logsumexp(state.log_weights, dim=0))
    return torch.sum(state.particles * w[:, None], dim=0)


def normalise(lw):
    """(log weights normalised over all particles, log of their sum), with
    the max shifted out first, as the sharded forms do across shards."""
    m = torch.max(lw)
    log_sum = m + torch.log(torch.sum(torch.exp(lw - m)))
    return lw - log_sum, log_sum


def sharded_smc_step(mesh, log_target: Callable, ess_threshold: float = 0.5):
    """The JAX package's sharded SMC step on one card (`mesh=None`): returns
    step(particles, log_weights, proposal_std, *, generator=None, u=None,
    z=None) -> (particles, log_weights, ess). Weights are normalised over
    all particles and the parents drawn against their global cumulative
    weights; after a resample the log weights are -log N."""
    if mesh is not None:
        raise NotImplementedError(MESH_REFUSED)

    def step(particles, log_weights, proposal_std, *, generator=None, u=None, z=None):
        n = particles.shape[0]
        u = _uniform(particles, generator, u)
        noise = _normal(particles.shape, particles, generator, z)
        lw_norm, _ = normalise(log_weights + log_target(particles))
        ess = 1.0 / torch.sum(torch.exp(2.0 * lw_norm))
        do_resample = ess < ess_threshold * n
        idx = parents(torch.cumsum(torch.exp(lw_norm), dim=0), u, n)
        particles_rs = torch.where(do_resample, particles[idx], particles)
        lw_rs = torch.where(do_resample, torch.full_like(lw_norm, -math.log(n)), lw_norm)
        return particles_rs + noise * proposal_std, lw_rs, ess

    return step
