"""The sparse pose-graph solve split into assembly and linear solve:
`scripts/profile_graph_solve.py` on the port.

On the script's graphs at K = 256 and 1,024 (a noisy chain, the anchor
prior, K / 20 Huber loops, seed 5: `bench.make_solve_graph`, the same
draws), in float64 (the port's LM does not run float32 graphs; see
`bench.py`), it times:

* `build` — `build_block_normal_equations`: the block normal equations;
* `solve_cg` — PCG (`graph/solver.py` `pcg`, `jax.scipy.sparse.linalg.cg`'s
  rule) on the damped system at 20 and 100 iterations, preconditioned by
  the block tridiagonal's block-Thomas factors (`block_tridiag_factor` /
  `block_tridiag_solve`, factored inside the timed call as in the
  script), with its relative residual |A x + b| / |b| (`rel_residual`);
* `block_tridiag_factor` and `block_tridiag_solve` alone;
* the full `optimize_graph_sparse(SolveConfig(max_iterations=15,
  cg_iters=100, solver="cg"))` once, warm, with its LM iterations and chi2.
  (Its CG is preconditioned by `tridiag_preconditioner`, SPIKE where K is a
  multiple of 32.)

Each reading is host and device ms per call (`timing.split`: `REPS` calls
back to back between CUDA events, `CG_REPS` for the PCG solves, whose
sequential preconditioner makes one call seconds long, then under
torch.profiler). What this does not repeat: `graph/solve_timing.py` times whole LM solves per
iteration, with their device activities, on graphs shaped like the slam
back end's (the circuit's 512 padded poses, the slice's 128).

    python -m gorio_tpu_torch.evaluation.profile_graph_solve [--device cuda] [--out J.json]
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import timing
from .sequence import card_name, device_of

KS = (256, 1024)
CG_ITERS = (20, 100)
REPS = 20  # the script's, for the build, the factor and the solve
CG_REPS = 3  # the script's 20 cut: one cg(100) at K = 1,024 takes 9-20 s on an H100
LAM = 1e-6
FULL_CFG = dict(max_iterations=15, cg_iters=100, solver="cg")


def graph(K, device):
    """(poses0, graph) of the script's K-pose problem on `device`, float64."""
    from ..bench import make_solve_graph

    return make_solve_graph(K, dtype=np.float64).freeze(device=device)


def build(poses, graph):
    """(Hdiag, Hoff, b, chi2) of the block normal equations."""
    from ..graph.sparse import build_block_normal_equations

    return build_block_normal_equations(poses, graph)


def damped_blocks(Hdiag, Hoff, graph):
    """(A, C): the damped diagonal blocks and the chain's upper blocks."""
    from ..graph.sparse import _chain_upper_blocks, _damped

    f = graph.between
    A = _damped(Hdiag, torch.tensor(LAM, dtype=Hdiag.dtype, device=Hdiag.device))
    return A, _chain_upper_blocks(Hoff, f.i, f.j, Hdiag.shape[0], Hdiag.dtype)


def matvec(A, Hoff, graph):
    """x (K, 6) -> H x with the damped diagonal: the script's `mv`."""
    f = graph.between

    def mv(x):
        y = torch.einsum("kij,kj->ki", A, x)
        y = y.index_add(0, f.i, torch.einsum("eij,ej->ei", Hoff, x[f.j]))
        return y.index_add(0, f.j, torch.einsum("eji,ej->ei", Hoff, x[f.i]))

    return mv


def solve_cg(Hdiag, Hoff, b, graph, iters):
    """x of (H + damping) x = -b by PCG, `iters` steps at most, with the
    block tridiagonal's block-Thomas factors as preconditioner."""
    from ..graph.solver import pcg
    from ..graph.sparse import block_tridiag_factor, block_tridiag_solve

    A, C = damped_blocks(Hdiag, Hoff, graph)
    Dinv = block_tridiag_factor(A, C)
    mv = matvec(A, Hoff, graph)
    return pcg(lambda v: (mv(v[0]),), (-b,),
               lambda v: (block_tridiag_solve(Dinv, C, v[0][..., None])[..., 0],), iters)[0]


def rel_residual(Hdiag, Hoff, b, graph, x):
    """|(H + damping) x + b| / |b|."""
    A, _ = damped_blocks(Hdiag, Hoff, graph)
    return torch.linalg.norm(matvec(A, Hoff, graph)(x) + b) / torch.linalg.norm(b)


def full_solve(poses, graph):
    """The full CG-solver LM of the script (`FULL_CFG`)."""
    from ..graph.solver import SolveConfig
    from ..graph.sparse import optimize_graph_sparse

    return optimize_graph_sparse(poses, graph, SolveConfig(**FULL_CFG))


def _call(fn):
    """`fn` as a chain step that ignores its carry."""
    return lambda _: fn()


def main(device="cuda", ks=KS, reps=REPS, cg_reps=CG_REPS, log=print) -> dict:
    from ..graph.sparse import block_tridiag_factor, block_tridiag_solve

    device = device_of(device)
    card = card_name(device)
    out = {"card": card, "dtype": "torch.float64", "reps": reps, "cg_reps": cg_reps, "K": {}}
    for K in ks:
        poses0, g = graph(K, device)
        Hdiag, Hoff, b, chi2 = build(poses0, g)
        row = {"build": timing.split(_call(lambda: build(poses0, g)), None, reps, 1, device)}
        for iters in CG_ITERS:
            row[f"cg{iters}"] = timing.split(_call(lambda: solve_cg(Hdiag, Hoff, b, g, iters)),
                                             None, cg_reps, 1, device)
            x = solve_cg(Hdiag, Hoff, b, g, iters)
            row[f"cg{iters}"]["rel_residual"] = float(rel_residual(Hdiag, Hoff, b, g, x))
            log(f"[profile_graph_solve] {card}: K={K}: build {row['build']['host_ms']:.2f} ms | "
                f"cg({iters}) {row[f'cg{iters}']['host_ms']:.2f} ms rel-residual "
                f"{row[f'cg{iters}']['rel_residual']:.2e}")
        A, C = damped_blocks(Hdiag, Hoff, g)
        Dinv = block_tridiag_factor(A, C)
        row["tridiag_factor"] = timing.split(_call(lambda: block_tridiag_factor(A, C)), None,
                                             reps, 1, device)
        row["tridiag_solve"] = timing.split(
            _call(lambda: block_tridiag_solve(Dinv, C, b[..., None])), None, reps, 1, device)
        full_solve(poses0, g)  # warm-up
        t0 = time.perf_counter()
        rs = full_solve(poses0, g)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        row["full_solve"] = {"ms": 1e3 * (time.perf_counter() - t0),
                             "iterations": int(rs.iterations), "chi2": float(rs.chi2)}
        for name in ("build", "cg20", "cg100", "tridiag_factor", "tridiag_solve"):
            log(f"[profile_graph_solve] {card}: K={K}: {timing.fmt(name, row[name], 16)}")
        log(f"[profile_graph_solve] {card}: K={K}: full solve {row['full_solve']['ms']:.1f} ms, "
            f"iters {row['full_solve']['iterations']}, chi2 {row['full_solve']['chi2']:.4g}")
        out["K"][str(K)] = row
    return out


if __name__ == "__main__":
    timing.profiler_cli(__doc__, main)
