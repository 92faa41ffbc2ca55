"""Annealed-SMC trajectory smoother with loop-closure global relaxation.

Port of `gorio_tpu/inference/smoother.py` (BASELINE.json config 5): the
trajectory posterior

  pi_beta(delta) ∝ exp(-0.5 [ chi2_base(delta) + beta * chi2_loops(delta) ])

is tempered from the odometry-only posterior (beta = 0) to the full one over
a fixed beta ladder; each stage reweights by the incremental loop
likelihood, resamples systematically against the global cumulative weights
when the ESS falls below its threshold, and moves every particle by
preconditioned MALA. The result carries the posterior mean trajectory and
the annealed-SMC estimate of log Z, the evidence for the loop closures
(`loop_evidence_gate`).

The particles live on the card as (N, 6K), each density pass over all of
them at once (10,240 particles over a 361-pose circuit peak at ~15 GiB).
One card runs the whole particle set (`mesh=None`), or the particles are
split over the `dp` axis of a `parallel.Mesh` of ranks: the normalisation,
the ESS, the evidence, the resampling ancestry, the posterior mean and the
acceptance then go through the axis's collectives.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..graph.factors import GraphData, retract
from ..graph.solver import _flatten_H, build_normal_equations, f32_matmuls, graph_chi2, live_graph
from ..parallel.mesh import cumsum_rows, gather_rows, psum, shard_rows
from .hmc import value_and_grad
from .smc import normalise, parents


class SmootherResult(NamedTuple):
    particles: torch.Tensor  # (N, 6K) final perturbations around poses0
    log_weights: torch.Tensor  # (N,) final (normalized) log weights
    mean_delta: torch.Tensor  # (6K,) posterior-mean perturbation
    poses_mean: torch.Tensor  # (K, 4, 4) posterior-mean trajectory
    log_evidence: torch.Tensor  # () log Z estimate for the tempered-in factors
    ess_per_stage: torch.Tensor  # (S,) effective sample size after each stage
    accept_rate: torch.Tensor  # () mean MALA acceptance


def _split_graphs(graph: GraphData, loop_mask):
    """(base graph: every factor but the loops, loop-only graph: the loops'
    between factors and no unary family)."""
    bw = graph.between
    loop_mask = torch.as_tensor(loop_mask, device=bw.mask.device)
    base = graph._replace(between=bw._replace(mask=bw.mask & ~loop_mask))
    loop_only = GraphData(bw._replace(mask=bw.mask & loop_mask),
                          *(fam._replace(mask=torch.zeros_like(fam.mask)) for fam in graph[1:]))
    return base, loop_only


def split_loop_chi2(poses0, graph: GraphData, loop_mask) -> Callable:
    """chi2_fn(delta (..., 6K)) -> (chi2_base (...), chi2_loop (...)).
    `loop_mask` (F,) bool over the between slots marks the loop closures,
    the factors beta tempers; unary families belong to the base."""
    K = poses0.shape[0]
    base, loop_only = (live_graph(g) for g in _split_graphs(graph, loop_mask))

    def chi2_fn(delta):
        with f32_matmuls():
            poses = retract(poses0, delta.reshape(*delta.shape[:-1], K, 6))
            return graph_chi2(poses, base), graph_chi2(poses, loop_only)

    return chi2_fn


def _mala_move(delta, chi2_fn, beta, step, mass, *, z, log_u):
    """One preconditioned MALA step per particle targeting pi_beta, the
    proposal covariance step^2 diag(mass); `z` (N, D) and `log_u` (N,) are
    its draws. Returns (delta', accepted (N,))."""

    def logp(d):
        c_base, c_loop = chi2_fn(d)
        return -0.5 * (c_base + beta * c_loop)

    lp, g = value_and_grad(logp, delta)
    prop = delta + 0.5 * step ** 2 * mass * g + step * torch.sqrt(mass) * z
    lp_p, g_p = value_and_grad(logp, prop)
    # q(x|x') / q(x'|x) under N(mean, step^2 M)
    fwd = -0.5 * torch.sum((prop - delta - 0.5 * step ** 2 * mass * g) ** 2 / mass,
                           dim=-1) / step ** 2
    bwd = -0.5 * torch.sum((delta - prop - 0.5 * step ** 2 * mass * g_p) ** 2 / mass,
                           dim=-1) / step ** 2
    log_alpha = lp_p - lp + bwd - fwd
    accept = log_u < log_alpha
    return torch.where(accept[:, None], prop, delta), accept


def smc_loop_relaxation(mesh, poses0, graph: GraphData, loop_mask, *, n_particles: int,
                        n_stages: int = 8, n_moves: int = 2, init_std: float = 1.0,
                        mala_step: float = 0.5, ess_threshold: float = 0.5,
                        axis: str = "dp"):
    """Build the relaxation: returns run(generator=None) -> SmootherResult.

    log Z accumulates each stage's log-sum of the incremental weights (the
    annealed-SMC evidence estimator, Del Moral et al. 2006). `init_std` and
    `mala_step` are in mass-normalised units: the initial cloud and the MALA
    proposal are both shaped by mass = 1 / (diag H_base + 1), the base
    graph's Gauss-Newton diagonal at delta = 0 (the anchor and odometry
    directions are orders of magnitude stiffer than the loop-error ones).

    The draws, made from `generator` on the poses' device: the initial
    cloud's normals (N, 6K), one resampling uniform per stage, and per stage
    and move the MALA proposals' normals (N, 6K) and the accept uniforms
    (N,).

    With a `mesh`, every rank runs `run` with the same arguments (the
    global draws, or the same generator state) on the same inputs, and
    moves its own rows of the particles (N must divide by the axis size):
    the normalisation, the ESS and log Z over all of them (pmax / psum),
    the parents against the global cumulative weights (`cumsum_rows`; the particles
    are gathered at a stage that resamples: the host reads the replicated
    decision), the posterior mean and the acceptance all-reduced. Every
    rank returns the whole result: the particles and log weights gathered,
    the rest replicated. On the same draws it is the one-card run up to the
    order of the reductions."""
    K = poses0.shape[0]
    D = K * 6
    like = dict(dtype=poses0.dtype, device=poses0.device)
    N = n_particles
    rows = shard_rows(mesh, N, axis)
    n_dev = 1 if mesh is None else mesh.shape[axis]
    chi2_fn = split_loop_chi2(poses0, graph, loop_mask)
    betas = torch.linspace(0.0, 1.0, n_stages + 1, **like)
    # diagonal GN preconditioner of the base graph at delta = 0: the initial
    # cloud must approximate pi_0, not the loop-relaxed posterior
    Hb, _, _ = build_normal_equations(poses0, _split_graphs(graph, loop_mask)[0])
    mass = 1.0 / (torch.diagonal(_flatten_H(Hb)) + 1.0)

    def core(init_z, u0, move_z, log_u) -> SmootherResult:
        particles = (init_std * torch.sqrt(mass))[None, :] * init_z[rows]
        log_w = torch.full((rows.stop - rows.start,), -math.log(1.0 * N), **like)
        log_z = torch.zeros((), **like)
        ess_hist, acc_hist = [], []
        for s in range(n_stages):
            # reweight by the incremental loop likelihood
            c_loop = chi2_fn(particles)[1]
            lw = log_w + -0.5 * (betas[s + 1] - betas[s]) * c_loop
            lw_norm, log_sum = normalise(lw, mesh, axis)
            log_z = log_z + log_sum  # the previous weights sum to 1
            ess = 1.0 / psum(mesh, torch.sum(torch.exp(2.0 * lw_norm)), axis)
            # systematic resampling against the global cumulative weights
            do_rs = ess < ess_threshold * N
            idx = parents(cumsum_rows(mesh, torch.exp(lw_norm), axis), u0[s], N, rows)
            if mesh is None:
                particles = torch.where(do_rs, particles[idx], particles)
            elif bool(do_rs):  # replicated: every rank takes the same branch
                particles = gather_rows(mesh, particles, axis)[idx]
            log_w = torch.where(do_rs, torch.full_like(lw_norm, -math.log(1.0 * N)), lw_norm)
            # MALA moves at the new temperature
            acc = torch.zeros((), **like)
            for m in range(n_moves):
                particles, accepted = _mala_move(particles, chi2_fn, betas[s + 1], mala_step,
                                                 mass, z=move_z[s, m][rows],
                                                 log_u=log_u[s, m][rows])
                acc = acc + torch.mean(accepted.to(poses0.dtype))
            ess_hist.append(ess)
            acc_hist.append(acc / n_moves)
        mean = psum(mesh, torch.sum(particles * torch.exp(log_w)[:, None], dim=0), axis)
        return SmootherResult(
            particles=gather_rows(mesh, particles, axis),
            log_weights=gather_rows(mesh, log_w, axis), mean_delta=mean,
            poses_mean=retract(poses0, mean.reshape(K, 6)), log_evidence=log_z,
            ess_per_stage=torch.stack(ess_hist),
            accept_rate=psum(mesh, torch.mean(torch.stack(acc_hist)), axis) / n_dev)

    def run(generator=None, *, draws=None) -> SmootherResult:
        """`draws` = (init_z (N, 6K), u0 (S,), move_z (S, n_moves, N, 6K),
        log_u (S, n_moves, N)), else drawn from `generator`."""
        if draws is None:
            draws = (torch.randn((N, D), generator=generator, **like),
                     torch.rand((n_stages,), generator=generator, **like),
                     torch.randn((n_stages, n_moves, N, D), generator=generator, **like),
                     torch.log(torch.rand((n_stages, n_moves, N), generator=generator, **like)))
        return core(*draws)

    return run


def loop_evidence_gate(result: SmootherResult, reject_below: float = -50.0) -> bool:
    """Evidence-based loop acceptance: log Z far below 0 means the loop
    factors are wildly inconsistent with the odometry posterior."""
    return bool(result.log_evidence > reject_below)
