"""NDT DIRECT7 align split by component: `scripts/profile_ndt.py` on the
port.

The pair is the `bench` subcommand's (`bench.bench_pair`: the ndt_omp
reference PCDs where `NDT_OMP_DATA` holds them, else `synth_pair`), both
clouds downsampled at 0.1 m and padded to the next power of two, float32,
against the target's DIRECT7 map at 1.0 m (`voxel_capacity=32768`; the
same inputs as `bench.ndt_inputs`). Components, as the script's:

* `full_align` — `ndt_align_with_map` from the identity (it reads the
  host once per outer iteration, so its chain synchronises);
* `gather_pass` — `_gather_correspondences`: the neighbour-voxel gather;
* `frozen_score` — `_score_cached` on the identity's frozen
  correspondences;
* `line_search_sweep` — the 11-candidate score sweep on every 4th point;
* `deriv_reduction` — the script's 27-column derivative reduction
  (`_md2_comp` and `_gauss_coeffs`; the port's `_derivatives` reduces 48
  columns, with the Hessian's rotation terms).

NDT reaches neither 1-NN kernel. Each component is timed as host and
device ms per call (`timing.split`): chained `n_inner` times (the
script's: 10 for the align, 20 for the rest), 3 times.

    python -m gorio_tpu_torch.evaluation.profile_ndt [--device cuda] [--out J.json]
"""

from __future__ import annotations

import torch

from . import timing
from .sequence import card_name, device_of

LS_STRIDE = 4
N_CAND = 11


def inputs(device, pair=None, dtype=torch.float32):
    """`bench.ndt_inputs` of `pair` ((target xyz, source xyz, what), default
    `bench.bench_pair()`): (NDTInputs, what)."""
    from ..bench import bench_pair, ndt_inputs

    tgt, src, what = pair if pair is not None else bench_pair()
    return ndt_inputs(tgt, src, device, dtype), what


def full_align(inp, T0):
    """`ndt_align_with_map` of the source from T0: its LMResult."""
    from ..registration.ndt import ndt_align_with_map

    return ndt_align_with_map(inp.source, inp.vmap_t, T0, inp.cfg)


def gather_pass(inp, T):
    """(found, mu, c6) of the neighbour-voxel gather at T."""
    from ..registration.ndt import _gather_correspondences

    return _gather_correspondences(inp.source, inp.vmap_t, T, inp.cfg)


def frozen_score(inp, frozen, T):
    """The full objective at T on frozen correspondences."""
    from ..registration.ndt import _gauss_coeffs, _score_cached

    d1, d2 = _gauss_coeffs(inp.cfg)
    return _score_cached(inp.source, *frozen, d1, d2, T)


def candidates(dtype, device):
    """The script's (11, 6) sweep: steps 0.001-0.01 on every axis."""
    return (torch.linspace(0.001, 0.01, N_CAND, dtype=dtype, device=device)[:, None]
            * torch.ones((N_CAND, 6), dtype=dtype, device=device))


def line_search_sweep(inp, frozen, T, cand):
    """(11,) scores of exp(cand) @ T on every `LS_STRIDE`-th point."""
    from ..core import lie
    from ..core.pointcloud import PointCloud
    from ..registration.ndt import _gauss_coeffs, _score_cached

    d1, d2 = _gauss_coeffs(inp.cfg)
    found, mu, c6 = frozen
    src_ls = PointCloud(*(x[::LS_STRIDE] for x in inp.source))
    return _score_cached(src_ls, found[::LS_STRIDE], mu[::LS_STRIDE],
                         tuple(c[::LS_STRIDE] for c in c6), d1, d2,
                         lie.se3_exp_split(cand) @ T)


def deriv_reduction(inp, frozen, T):
    """(27,) the script's derivative columns (u, then u_i u_j for i <= j)
    reduced against the score coefficients by one matrix-vector product."""
    from ..registration.ndt import _gauss_coeffs, _md2_comp

    d1, d2 = _gauss_coeffs(inp.cfg)
    found, mu, c6 = frozen
    moved = inp.source.xyz @ T[:3, :3].T + T[:3, 3]
    md2, _, (q0, q1, q2) = _md2_comp(moved, mu, c6)
    e = torch.exp(-0.5 * d2 * md2)
    coef = torch.where(found, -d2 * d1 * e, torch.zeros_like(e))
    m0, m1, m2 = moved[:, None, 0], moved[:, None, 1], moved[:, None, 2]
    u = (m1 * q2 - m2 * q1, m2 * q0 - m0 * q2, m0 * q1 - m1 * q0, q0, q1, q2)
    cols = torch.stack(list(u) + [u[i] * u[j] for i in range(6) for j in range(i, 6)], dim=0)
    return cols.reshape(cols.shape[0], -1) @ coef.reshape(-1)


def chain_ms(make_step, x0, n_inner=10, reps=3, device="cuda"):
    """The script's `chain_ms`: host and device ms per call of
    `x = make_step(x)` chained n_inner times (`timing.split`)."""
    return timing.split(make_step, x0, n_inner, reps, device_of(device))


def main(device="cuda", reps=3, log=print) -> dict:
    device = device_of(device)
    card = card_name(device)
    inp, what = inputs(device)
    src = inp.source
    log(f"[profile_ndt] {what}: target {int(inp.target.mask.sum())} source "
        f"{int(src.mask.sum())} points, capacity {src.xyz.shape[0]}")
    T0 = torch.eye(4, dtype=src.xyz.dtype, device=device)
    r = full_align(inp, T0)
    frozen = gather_pass(inp, T0)
    cand = candidates(src.xyz.dtype, device)
    steps = {
        "full align": (lambda T: full_align(inp, T0 * (1.0 + 0.0 * T[0, 0])).T, 10),
        "gather pass": (lambda T: T + 0.0 * torch.sum(gather_pass(inp, T)[1][:2, :2, 0]), 20),
        "frozen full score": (lambda T: T + 0.0 * frozen_score(inp, frozen, T), 20),
        "line-search sweep (11)": (
            lambda T: T + 0.0 * torch.min(line_search_sweep(inp, frozen, T, cand
                                                            * (1.0 + 0.0 * T[0, 0]))), 20),
        "deriv reduction (27 cols)": (lambda T: T + 0.0 * deriv_reduction(inp, frozen, T)[0], 20),
    }
    rows = {name: chain_ms(fn, T0, n, reps, device) for name, (fn, n) in steps.items()}
    log(f"[profile_ndt] {card}: align iters={int(r.iterations)} score={float(r.error):.1f}")
    for name, row in rows.items():
        log(f"[profile_ndt] {card}: {timing.fmt(name, row)}")
    return {"card": card, "pair": what, "capacity": src.xyz.shape[0],
            "points": [int(inp.target.mask.sum()), int(src.mask.sum())],
            "align_iterations": int(r.iterations), "align_score": float(r.error),
            "reps": reps, "components": rows}


if __name__ == "__main__":
    timing.profiler_cli(__doc__, main)
