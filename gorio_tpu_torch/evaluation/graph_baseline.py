"""Measured host sparse-LM baseline for the pose-graph solve, against the
port's solver on the card: `scripts/graph_baseline.py` on the port.

On the graphs of the `bench` subcommand (`bench.make_solve_graph`: a chain
+ 5% robustified loop edges, noisy initial poses; identical to the root
`bench.py`'s) it measures:

* a from-scratch numpy/scipy sparse LM with the residual conventions of
  `graph/` (between: log(meas^-1 Ti^-1 Tj) with the full SE(3) log,
  right-multiplicative [exp(rot), trans] retraction, IRLS-Huber weights,
  Marquardt scaled damping and the accept rule), SuperLU on the 6K x 6K
  normal equations: the CPU sparse-direct class that g2o occupies.
  Per-stage times are kept so that its finite-difference Jacobians do not
  inflate the baseline (copied from the script: the same numbers on the
  same host);
* the port's `optimize_graph_sparse` on `--device` at the LM caps 10 / 20
  / 40 / 80: chi2 and the iterations used. The port's LM does not run
  float32 graphs (forward-mode AD promotes a tensor divided by a Python
  float to float64), so it runs in float64, and the key names the device
  and dtype (`repo_solver_<device>_f64_chi2_by_cap`), where the script ran
  the JAX package's float32 solver on the CPU;
* the port's 10-iteration solve on `--device`, ms per LM iteration (the
  host clock around back-to-back solves, ending in a synchronise), beside
  the host baseline's analytic-Jacobian lower bound.

    python -m gorio_tpu_torch.evaluation.graph_baseline [--device cuda]
        [--update --out GRAPH_BASELINE_PORT.json]

The JAX package's `GRAPH_BASELINE.json` is never written.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch
from scipy.spatial.transform import Rotation

from .sequence import card_name, device_of

GRAPH_KS = (256, 1024)
CAPS = (10, 20, 40, 80)


# ---- SE(3) helpers (numpy, float64; conventions = core/lie.py) ----

def so3_exp(r):
    return Rotation.from_rotvec(r).as_matrix()


def se3_log(T):
    """(F,4,4) -> (F,6) [rot, V^{-1} t] — matches `lie.se3_log`."""
    T = np.asarray(T)
    r = Rotation.from_matrix(T[..., :3, :3]).as_rotvec()
    theta2 = np.sum(r * r, axis=-1)
    theta = np.sqrt(np.maximum(theta2, 1e-30))
    small = theta2 < 1e-12
    with np.errstate(invalid="ignore", divide="ignore"):
        cot_term = np.where(
            small,
            1.0 / 12.0 + theta2 / 720.0,
            1.0 / np.maximum(theta2, 1e-30)
            - (1.0 + np.cos(theta)) / np.maximum(2.0 * theta * np.sin(theta), 1e-30),
        )
    K = np.zeros(T.shape[:-2] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -r[..., 2], r[..., 1]
    K[..., 1, 0], K[..., 1, 2] = r[..., 2], -r[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -r[..., 1], r[..., 0]
    Vinv = (
        np.eye(3) - 0.5 * K + cot_term[..., None, None] * (K @ K)
    )
    t = np.einsum("...ij,...j->...i", Vinv, T[..., :3, 3])
    return np.concatenate([r, t], axis=-1)


def se3_inv(T):
    out = np.zeros_like(T)
    Rt = np.swapaxes(T[..., :3, :3], -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -np.einsum("...ij,...j->...i", Rt, T[..., :3, 3])
    out[..., 3, 3] = 1.0
    return out


def retract(T, delta):
    """T . [exp(d_rot), d_trans] (split retraction, `factors.retract`)."""
    D = np.zeros(T.shape[:-2] + (4, 4))
    D[..., :3, :3] = so3_exp(delta[..., :3])
    D[..., :3, 3] = delta[..., 3:]
    D[..., 3, 3] = 1.0
    return T @ D


def huber_w(chi2, delta):
    e = np.sqrt(np.maximum(chi2, 1e-30))
    w = np.where(e <= delta, 1.0, np.where(np.isinf(delta), 1.0, delta) / e)
    return np.where(np.isinf(delta), 1.0, w)


# ---- host sparse LM ---------------------------------------------------------

class HostGraph:
    """Between + SE3-prior factors lifted from a `PoseGraph` (float64)."""

    def __init__(self, gg):
        self.poses0 = np.stack([np.asarray(p, np.float64) for p in gg.poses])
        b = gg._between
        self.bi = np.asarray([f[0] for f in b], np.int64)
        self.bj = np.asarray([f[1] for f in b], np.int64)
        self.bT = np.stack([f[2] for f in b]).astype(np.float64)
        self.bTinv = se3_inv(self.bT)
        self.bsq = np.stack([f[3] for f in b]).astype(np.float64)
        self.bdelta = np.asarray([f[4] for f in b], np.float64)
        p = gg._priors
        self.pi = np.asarray([f[0] for f in p], np.int64)
        self.pTinv = se3_inv(np.stack([f[1] for f in p]).astype(np.float64))
        self.psq = np.stack([f[2] for f in p]).astype(np.float64)
        self.pdelta = np.asarray([f[3] for f in p], np.float64)

    def residuals(self, poses):
        rb = se3_log(self.bTinv @ se3_inv(poses[self.bi]) @ poses[self.bj])
        rp = se3_log(self.pTinv @ poses[self.pi])
        return rb, rp

    def chi2(self, poses):
        """Same robustified total as `solver._weighted`: sum w * |sqrt_info r|^2."""
        rb, rp = self.residuals(poses)
        rwb = np.einsum("fij,fj->fi", self.bsq, rb)
        c2b = np.sum(rwb * rwb, axis=-1)
        rwp = np.einsum("fij,fj->fi", self.psq, rp)
        c2p = np.sum(rwp * rwp, axis=-1)
        return float(
            np.sum(huber_w(c2b, self.bdelta) * c2b)
            + np.sum(huber_w(c2p, self.pdelta) * c2p)
        )

    def linearize(self, poses, h=1e-6):
        """Residuals + central-difference Jacobians, vectorized over factors.

        Returns (rb, Jb (F,6,12), rp, Jp (P,6,6)). FD instead of analytic —
        exact to ~1e-9 in float64; its cost is timed SEPARATELY so the
        baseline's factor+solve number is not polluted by it."""
        Ti, Tj = poses[self.bi], poses[self.bj]
        rb = se3_log(self.bTinv @ se3_inv(Ti) @ Tj)
        F = rb.shape[0]
        Jb = np.zeros((F, 6, 12))
        eye6 = np.eye(6) * h
        for d in range(6):
            dv = eye6[d]
            rp1 = se3_log(self.bTinv @ se3_inv(retract(Ti, dv)) @ Tj)
            rm1 = se3_log(self.bTinv @ se3_inv(retract(Ti, -dv)) @ Tj)
            Jb[:, :, d] = (rp1 - rm1) / (2 * h)
            rp2 = se3_log(self.bTinv @ se3_inv(Ti) @ retract(Tj, dv))
            rm2 = se3_log(self.bTinv @ se3_inv(Ti) @ retract(Tj, -dv))
            Jb[:, :, 6 + d] = (rp2 - rm2) / (2 * h)
        Tp = poses[self.pi]
        rp = se3_log(self.pTinv @ Tp)
        P = rp.shape[0]
        Jp = np.zeros((P, 6, 6))
        for d in range(6):
            dv = eye6[d]
            Jp[:, :, d] = (
                se3_log(self.pTinv @ retract(Tp, dv))
                - se3_log(self.pTinv @ retract(Tp, -dv))
            ) / (2 * h)
        return rb, Jb, rp, Jp


def assemble(hg, rb, Jb, rp, Jp, K):
    """Sparse normal equations H (6K,6K CSC), b (6K,), robustified chi2."""
    rwb = np.einsum("fij,fj->fi", hg.bsq, rb)
    c2b = np.sum(rwb * rwb, axis=-1)
    wb = huber_w(c2b, hg.bdelta)
    Jwb = np.einsum("fij,fjk->fik", hg.bsq, Jb)  # (F,6,12)
    Hf = np.einsum("fki,fkj,f->fij", Jwb, Jwb, wb)  # (F,12,12)
    bf = np.einsum("fki,fk,f->fi", Jwb, rwb, wb)  # (F,12)

    rwp = np.einsum("fij,fj->fi", hg.psq, rp)
    c2p = np.sum(rwp * rwp, axis=-1)
    wp = huber_w(c2p, hg.pdelta)
    Jwp = np.einsum("fij,fjk->fik", hg.psq, Jp)
    Hp = np.einsum("fki,fkj,f->fij", Jwp, Jwp, wp)
    bp = np.einsum("fki,fk,f->fi", Jwp, rwp, wp)

    # scatter block indices
    F = rb.shape[0]
    off = np.arange(6)
    vidx = np.concatenate(
        [hg.bi[:, None] * 6 + off[None, :], hg.bj[:, None] * 6 + off[None, :]],
        axis=1,
    )  # (F,12) flat variable index per block column
    rows = np.repeat(vidx, 12, axis=1).ravel()
    cols = np.tile(vidx, (1, 12)).ravel()
    vals = Hf.ravel()
    pv = hg.pi[:, None] * 6 + off[None, :]
    prows = np.repeat(pv, 6, axis=1).ravel()
    pcols = np.tile(pv, (1, 6)).ravel()
    H = sp.coo_matrix(
        (np.concatenate([vals, Hp.ravel()]),
         (np.concatenate([rows, prows]), np.concatenate([cols, pcols]))),
        shape=(6 * K, 6 * K),
    ).tocsc()
    b = np.zeros(6 * K)
    np.add.at(b, vidx.ravel(), bf.ravel())
    np.add.at(b, pv.ravel(), bp.ravel())
    chi2 = float(np.sum(wb * c2b) + np.sum(wp * c2p))
    return H, b, chi2


def host_lm(hg, max_iterations, lam0=1e-6, lam_factor=10.0, rel_tol=1e-9,
            collect=None):
    """LM with the exact accept/damping policy of `solver.optimize_graph`.

    Returns (poses, chi2, iters, stage_times) — stage_times accumulates
    {jacobian, assemble, factor_solve, chi2_eval} seconds."""
    poses = hg.poses0.copy()
    K = poses.shape[0]
    lam = lam0
    chi2_prev = np.inf
    st = {"jacobian": 0.0, "assemble": 0.0, "factor_solve": 0.0, "chi2_eval": 0.0}
    it = 0
    for it in range(1, max_iterations + 1):
        t0 = time.perf_counter()
        rb, Jb, rp, Jp = hg.linearize(poses)
        t1 = time.perf_counter()
        H, b, chi2 = assemble(hg, rb, Jb, rp, Jp, K)
        t2 = time.perf_counter()
        # Marquardt scaled damping, identical to `_solve_dense`
        dscale = np.maximum(H.diagonal(), 1.0)
        A = (H + sp.diags(lam * dscale)).tocsc()
        delta = spla.splu(A).solve(-b)
        t3 = time.perf_counter()
        poses_new = retract(poses, delta.reshape(K, 6))
        chi2_new = hg.chi2(poses_new)
        t4 = time.perf_counter()
        st["jacobian"] += t1 - t0
        st["assemble"] += t2 - t1
        st["factor_solve"] += t3 - t2
        st["chi2_eval"] += t4 - t3
        accept = chi2_new < chi2
        if accept:
            poses = poses_new
            lam /= lam_factor
        else:
            lam *= lam_factor
        chi2_cur = chi2_new if accept else chi2
        if collect is not None:
            collect.append(chi2_cur)
        if accept and abs(chi2 - chi2_new) / max(chi2, 1e-30) < rel_tol:
            break
        chi2_prev = chi2_cur
    return poses, chi2_cur, it, st


def _sig(x):
    return float(f"{x:.4g}")


def bench_host(Kg, n_timed=3):
    from ..bench import make_solve_graph

    hg = HostGraph(make_solve_graph(Kg))
    # convergence reference: LM to the floor. The bench measurements are
    # noise-free (only the INITIALIZATION is corrupted), so the true optimum
    # has chi2 ~ 0; "at the floor" is judged in absolute terms relative to
    # the initial chi2 (floor*1.01 alone is degenerate when floor ~ 1e-20).
    chi2_init = hg.chi2(hg.poses0)
    trace = []
    _, chi2_floor, iters_floor, _ = host_lm(hg, 100, collect=trace)
    thresh = max(chi2_floor * 1.01, 1e-9 * chi2_init)
    it_to_floor = next(
        (k + 1 for k, c in enumerate(trace) if c <= thresh), iters_floor
    )
    # timed: the 10-iteration solve of the `bench` subcommand (graph_solve_k*)
    times = []
    st = None
    for _ in range(n_timed):
        t0 = time.perf_counter()
        _, chi2_10, _, st = host_lm(hg, 10)
        times.append(time.perf_counter() - t0)
    ms10 = float(np.median(times)) * 1e3
    stage = {k: round(v / 10 * 1e3, 3) for k, v in st.items()}
    return {
        "n_poses": Kg,
        "n_between": int(hg.bi.shape[0]),
        "chi2_initial": _sig(chi2_init),
        "host_lm10_ms": round(ms10, 2),
        "host_lm10_chi2": _sig(chi2_10),
        "host_ms_per_iteration": round(ms10 / 10, 3),
        "host_stage_ms_per_iteration": stage,
        # generous-to-the-baseline estimate of an analytic-Jacobian (g2o
        # style) iteration: drop the FD-Jacobian stage entirely
        "g2o_class_ms_per_iteration_lower_bound": round(
            stage["assemble"] + stage["factor_solve"] + stage["chi2_eval"], 3
        ),
        "chi2_floor": _sig(chi2_floor),
        "iterations_to_floor": int(it_to_floor),
    }



def solver_caps(Kg, caps=CAPS, device="cuda"):
    """{cap: (chi2, iterations used)} of the port's `optimize_graph_sparse`
    (the exact tridiagonal + Woodbury solve) on `make_solve_graph(Kg)` in
    float64 on `device`, unrounded."""
    from ..bench import make_solve_graph
    from ..graph.solver import SolveConfig
    from ..graph.sparse import optimize_graph_sparse

    poses, graph = make_solve_graph(Kg, dtype=np.float64).freeze(device=device_of(device))
    out = {}
    for cap in caps:
        cfg = SolveConfig(max_iterations=cap, solver="direct", loop_capacity=64)
        rs = optimize_graph_sparse(poses, graph, cfg)
        out[cap] = (float(rs.chi2), int(rs.iterations))
    return out


def repo_solver_convergence(Kg, caps=CAPS, device="cuda"):
    """The port's sparse direct solver (float64) at increasing LM caps, as
    the script's JSON has it (chi2 to 4 significant digits)."""
    return {str(cap): {"chi2": _sig(chi2), "iterations_used": it}
            for cap, (chi2, it) in solver_caps(Kg, caps, device).items()}


def device_ms_per_iteration(Kg, device="cuda", n_timed=3):
    """ms per LM iteration of the port's 10-iteration float64 solve on
    `device`: one warm-up solve, then the host clock around `n_timed`
    solves back to back, ending in a synchronise."""
    from ..bench import make_solve_graph, mean_s
    from ..graph.solver import SolveConfig
    from ..graph.sparse import optimize_graph_sparse

    device = device_of(device)
    poses, graph = make_solve_graph(Kg, dtype=np.float64).freeze(device=device)
    cfg = SolveConfig(max_iterations=10, solver="direct", loop_capacity=64)
    rs = optimize_graph_sparse(poses, graph, cfg)
    s = mean_s(lambda: optimize_graph_sparse(poses, graph, cfg), n_timed, device)
    return round(1e3 * s / max(int(rs.iterations), 1), 3)


def _host_cpu() -> str:
    """The host CPU's model name (Linux), else ""."""
    info = Path("/proc/cpuinfo")
    lines = info.read_text().splitlines() if info.exists() else []
    return next((ln.split(":", 1)[1].strip() for ln in lines if ln.startswith("model name")), "")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--update", action="store_true", help="write the results to --out")
    ap.add_argument("--out", default=None, help="the port's graph baseline record (JSON)")
    ap.add_argument("--ks", default=",".join(map(str, GRAPH_KS)),
                    help="comma-separated pose counts")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.update and not args.out:
        ap.error("--update needs --out (the JAX package's GRAPH_BASELINE.json is not written)")
    device = device_of(args.device)
    tag = f"repo_solver_{device.type}_f64_chi2_by_cap"
    ks = [int(k) for k in args.ks.split(",") if k]
    res = {
        "method": (
            "host: from-scratch numpy/scipy sparse LM on the graphs of the bench "
            "subcommand (bench.make_solve_graph; same residual conventions, Huber IRLS, "
            "Marquardt damping, accept rule as the port's graph/); SuperLU sparse direct "
            "(scipy.sparse.linalg.splu) on the 6Kx6K normal equations; Jacobians by "
            "vectorized central differences, their cost reported apart "
            f"(host_stage_ms_per_iteration). {tag}: the port's optimize_graph_sparse in "
            "float64 at rising iteration caps. device_ms_per_iteration: its 10-iteration "
            "solve, the host clock around back-to-back solves ending in a synchronise."
        ),
        "host_cpu": _host_cpu(),
        "device": card_name(device),
    }
    for Kg in ks:
        print(f"== host LM K={Kg} ==", file=sys.stderr)
        res[f"k{Kg}"] = bench_host(Kg)
        print(json.dumps(res[f"k{Kg}"]), file=sys.stderr)
    for Kg in ks:
        print(f"== the port's sparse solver ({device}, float64) K={Kg} ==", file=sys.stderr)
        k = res[f"k{Kg}"]
        k[tag] = repo_solver_convergence(Kg, device=device)
        k["device_ms_per_iteration"] = device_ms_per_iteration(Kg, device)
        k["per_iteration_speedup_vs_host_lower_bound"] = round(
            k["g2o_class_ms_per_iteration_lower_bound"] / k["device_ms_per_iteration"], 2)
        print(json.dumps({tag: k[tag], "device_ms_per_iteration": k["device_ms_per_iteration"]}),
              file=sys.stderr)
    print(json.dumps(res, indent=2))
    if args.update:
        Path(args.out).write_text(json.dumps(res, indent=2) + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    return res


if __name__ == "__main__":
    main()
