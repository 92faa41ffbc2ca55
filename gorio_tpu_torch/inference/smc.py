"""Sequential Monte Carlo over trajectory posteriors.

Port of `gorio_tpu/inference/smc.py`: `smc_init`, the particle-weight
`effective_sample_size`, `systematic_resample`, `smc_step` (reweight ->
conditional resample -> jitter move), `smc_estimate`, and
`sharded_smc_step`: the particles split over the `dp` axis of a
`parallel.Mesh` of ranks, weights normalised globally (pmax / psum), the
parents drawn against the global cumulative weights (`cumsum_rows`), log weights
-log N after a resample; with `mesh=None` the same arithmetic on one card.

`log_target` takes particles (N, D) and returns (N,). Every random draw
enters as a tensor (`z`, `u`) or comes from an explicit `torch.Generator`
on the particles' device; the resample decision is a `torch.where`, so no
step reads the device from the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..parallel.mesh import cumsum_rows, gather_rows, pmax, psum, shard_rows


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


def parents(cum, u, n, rows: slice | None = None):
    """Systematic resampling's parent indices against the cumulative
    weights `cum` (n,): the comb u / n + k / n, for k < n or k in `rows`
    (a shard's particles)."""
    rows = rows or slice(0, n)
    k = torch.arange(rows.start, rows.stop, dtype=cum.dtype, device=cum.device)
    return torch.clamp(torch.searchsorted(cum, u / n + k / n), 0, n - 1)


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


def normalise(lw, mesh=None, axis: str = "dp"):
    """(log weights normalised over all particles, log of their sum), with
    the max shifted out first: over every shard of `axis` (pmax / psum),
    or over `lw` alone for `mesh=None`."""
    m = pmax(mesh, torch.max(lw), axis)
    log_sum = m + torch.log(psum(mesh, torch.sum(torch.exp(lw - m)), axis))
    return lw - log_sum, log_sum


def _weigh(mesh, log_target, particles, log_weights, u, axis):
    """The step's weighing of this rank's rows: (rows, their log weights
    normalised over all particles, the global ESS, the global cumulative
    weights, the parents of its rows)."""
    n = particles.shape[0]
    rows = shard_rows(mesh, n, axis)
    lw_norm, _ = normalise(log_weights[rows] + log_target(particles[rows]), mesh, axis)
    ess = 1.0 / psum(mesh, torch.sum(torch.exp(2.0 * lw_norm)), axis)
    cum = cumsum_rows(mesh, torch.exp(lw_norm), axis)
    return rows, lw_norm, ess, cum, parents(cum, u, n, rows)


def sharded_parents(mesh, log_target: Callable, particles, log_weights, u):
    """The parents of all particles that `sharded_smc_step` takes when it
    resamples (gathered), and the cumulative weights they are drawn
    against: for holding one mesh's step to another's, where a comb point
    within round-off of a cumulative weight may pick its neighbour."""
    _, _, _, cum, idx = _weigh(mesh, log_target, particles, log_weights, u, "dp")
    return gather_rows(mesh, idx, "dp"), cum


def sharded_smc_step(mesh, log_target: Callable, ess_threshold: float = 0.5):
    """The JAX package's sharded SMC step: returns step(particles,
    log_weights, proposal_std, *, generator=None, u=None, z=None) ->
    (particles, log_weights, ess).

    Every rank of `mesh` gives the global particles (N, D) and log weights
    (N,), the replicated uniform `u` and the global normals `z` (N, D) (or
    the same `generator` state), and weighs, resamples and moves its own
    rows (N must divide by the axis size): the weights normalised over all
    particles (pmax / psum), the ESS global, the parents taken against the
    global cumulative weights, the same bits on every rank; after a resample the log weights are
    -log N. The new particles and log weights are gathered: every rank
    returns the global ones, and the same ESS. `mesh=None` runs it on one
    card."""
    axis = "dp"

    def step(particles, log_weights, proposal_std, *, generator=None, u=None, z=None):
        n = particles.shape[0]
        u = _uniform(particles, generator, u)
        noise = _normal(particles.shape, particles, generator, z)
        rows, lw_norm, ess, _, idx = _weigh(mesh, log_target, particles, log_weights, u, axis)
        do_resample = ess < ess_threshold * n
        particles_rs = torch.where(do_resample, particles[idx], particles[rows])
        lw_rs = torch.where(do_resample, torch.full_like(lw_norm, -math.log(n)), lw_norm)
        return (gather_rows(mesh, particles_rs + noise[rows] * proposal_std, axis),
                gather_rows(mesh, lw_rs, axis), ess)

    return step
