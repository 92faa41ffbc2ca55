"""Multi-rank dry run of the sharded programs.

Port of `__graft_entry__.dryrun_multichip`: `dryrun_multichip(mesh)` runs
the sharded flagship programs on a (dp, mp) mesh of ranks, at small but real
sizes, in order:

  1. UGPM preintegration over W windows split over `dp`;
  2. the APDGICP align of a synthetic pair, its source points split over
     `mp` (the `gorio_nn1` kernel on each rank's points on the card);
  3. the pose-graph solve with its factors split over `dp`, its between
     factors built from the UGPM deltas: a preintegrate -> graph pipeline;
  4. an SMC step with collective resampling over the flat mesh of all ranks.

The sizes are fixed (WINDOWS, POINTS, PARTICLES; the JAX function scales
them with the mesh), so every mesh runs the same problem: a world of 1, 2,
4 or 8 ranks, whose axes divide them.

    python -m gorio_tpu_torch.parallel.dryrun --nproc N [--device cpu] [--backend gloo]
    torchrun --nproc-per-node N -m gorio_tpu_torch.parallel.dryrun [--device cpu]

spawn N ranks (or run as one of torchrun's) on the card, NCCL with one rank
per card; `--backend gloo` puts N ranks on one card; `--device cpu` runs
them on the CPU over gloo. Rank 0 prints one JSON line of what each program
gave. At 4 ranks or more, an even count, the mesh is (dp, mp) = (n / 2, 2),
as the JAX function lays it out, else (n, 1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..core.pointcloud import make_cloud
from ..graph.graph import PoseGraph
from ..graph.solver import SolveConfig
from ..inference.smc import sharded_smc_step
from ..io.synthetic import sample_imu, simulate_trajectory
from ..preintegration.ugpm import UGPMConfig
from ..registration.gicp import GICPConfig
from ..registration.lsq import LMConfig
from .mesh import (CUBLAS_WORKSPACE, Mesh, data_parallel_mesh, initialize_distributed,
                   make_mesh, spawn)
from .sharded import sharded_gicp_align, sharded_optimize_graph, sharded_ugpm_windows

UGPM_CFG = UGPMConfig(state_freq=20.0, overlap=4, window_duration=0.2, lm_iters=5,
                      init_grid_n=64)
G, V = 48, 10  # gyro and velocity samples per window
WINDOWS, POINTS, PARTICLES = 4, 512, 64  # split over dp, mp and all the ranks
SMC_DIM = 12


def mesh_layout(n: int):
    """The JAX function's (dp, mp) for n ranks."""
    return (n // 2, 2) if n % 2 == 0 and n >= 4 else (n, 1)


def ugpm_windows(W: int):
    """The dry run's W windows of a 2.5 s synthetic drive, as numpy arrays
    (gyr_t, gyr, vel_t, vel, starts, queries), and its IMU variances."""
    imu = sample_imu(simulate_trajectory(seed=0, duration=2.5), gyr_rate=100.0, vel_rate=20.0,
                     gyr_std=0.01, vel_std=0.03, seed=1)
    starts = np.linspace(0.3, 1.8, W)
    packs = []
    for t0 in starts:
        i_g = np.searchsorted(imu.gyr_t, t0 - 0.1)
        i_v = np.searchsorted(imu.vel_t, t0 - 0.1)
        packs.append((imu.gyr_t[i_g:i_g + G], imu.gyr[i_g:i_g + G],
                      imu.vel_t[i_v:i_v + V], imu.vel[i_v:i_v + V]))
    arrays = [np.stack([p[k] for p in packs]) for k in range(4)]
    return (*arrays, starts, (starts + 0.2)[:, None]), imu.gyr_var, imu.vel_var


def dryrun_multichip(mesh: Mesh) -> dict:
    """Run the four programs on `mesh` (axes dp and mp), the SMC step on a
    flat "dp" mesh of all its ranks; every rank calls it alike. Returns
    {"ugpm": PreintMeas over the WINDOWS windows,
    "gicp": LMResult, "graph": SolveResult, "smc": (particles, log weights,
    ess)}, every rank holding all of it. Raises on a non-finite result."""
    dev = mesh.device

    # 1) dp-sharded batched UGPM over W windows
    W = WINDOWS
    (gyr_t, gyr, vel_t, vel, starts, queries), gyr_var, vel_var = ugpm_windows(W)
    preint = sharded_ugpm_windows(mesh, "dp")(gyr_t, gyr, vel_t, vel, starts, queries,
                                              gyr_var, vel_var, UGPM_CFG)

    # 2) mp-sharded APDGICP with all-reduced normal equations
    n_pts = POINTS
    rng = np.random.default_rng(0)
    tgt_np = rng.normal(scale=3.0, size=(n_pts, 3)).astype(np.float32)
    ang = 0.03
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]],
                  np.float32)
    src_np = (tgt_np - np.array([0.1, -0.05, 0.02], np.float32)) @ Rz
    align = sharded_gicp_align(mesh, GICPConfig(mode="apdgicp", lm=LMConfig(max_iterations=6)),
                               "mp")
    res = align(make_cloud(src_np, capacity=n_pts, device=dev),
                make_cloud(tgt_np, capacity=n_pts, device=dev))

    # 3) dp-sharded pose-graph solve over the UGPM deltas
    dR = preint.delta_R[:, 0].cpu().numpy()
    dpv = preint.delta_p[:, 0].cpu().numpy()
    cov = preint.cov[:, 0].cpu().numpy()
    g = PoseGraph(dtype=np.float64)
    T = np.eye(4)
    g.add_pose(T)
    steps = []
    for k in range(W):
        d = np.eye(4)
        d[:3, :3], d[:3, 3] = dR[k], dpv[k]
        steps.append(d)
        T = T @ d
        g.add_pose(T)
    g.add_prior(0, np.eye(4), info=np.eye(6) * 1e6)
    for k, d in enumerate(steps):
        g.add_between(k, k + 1, d, info=np.diag(1.0 / np.clip(np.diag(cov[k]), 1e-8, None)))
    poses0, graph = g.freeze(device=dev)
    sol = sharded_optimize_graph(mesh, SolveConfig(max_iterations=8), "dp")(poses0, graph)

    # 4) an SMC step with collective resampling over the flat mesh
    flat = data_parallel_mesh(mesh.size, dev)
    n_part = PARTICLES
    step = sharded_smc_step(flat, lambda x: -0.5 * torch.sum(x * x, dim=-1))
    x0 = torch.as_tensor(rng.normal(size=(n_part, SMC_DIM)).astype(np.float32), device=dev)
    smc = step(x0, torch.zeros(n_part, dtype=torch.float32, device=dev), 0.05,
               generator=torch.Generator(device=dev).manual_seed(0))

    out = {"ugpm": preint, "gicp": res, "graph": sol, "smc": smc}
    for name, value in out.items():
        for t in value:
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise RuntimeError(f"dry run: {name} gave a non-finite result")
    return out


def run_rank(device: str) -> dict:
    """One rank of the CLI's dry run (the process group is up): the result,
    this rank's `gorio_nn1` launches, its wall and peak card memory."""
    from ..ops import nn as K

    _, world = initialize_distributed(device=device)
    mesh = make_mesh(mesh_layout(world), ("dp", "mp"), device)
    K.reset_launch_counts()
    if mesh.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = dryrun_multichip(mesh)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if mesh.device.type == "cuda" else 0
    return {"result": out,
            "mesh": mesh.shape, "backend": mesh.backend, "device": str(mesh.device),
            "nn1_launches": K.launch_counts["nn1"], "wall_s": wall, "peak_bytes": peak}


def summary(ranks: list) -> dict:
    """What rank 0's result gave, and whether every rank's equals it to the
    bit."""
    r0 = ranks[0]["result"]
    same = all(torch.equal(a, b) for r in ranks[1:] for k in r0
               for a, b in zip(r["result"][k], r0[k]))
    return {
        "world": len(ranks), "mesh": ranks[0]["mesh"], "backend": ranks[0]["backend"],
        "device": ranks[0]["device"],
        "ugpm_delta_p": r0["ugpm"].delta_p[:, 0].tolist(),
        "gicp_T": r0["gicp"].T.tolist(), "gicp_iterations": int(r0["gicp"].iterations),
        "graph_chi2": float(r0["graph"].chi2), "graph_iterations": int(r0["graph"].iterations),
        "smc_ess": float(r0["smc"][2]),
        "nn1_launches_per_rank": [r["nn1_launches"] for r in ranks],
        "wall_s_per_rank": [round(r["wall_s"], 3) for r in ranks],
        "peak_bytes_per_rank": [r["peak_bytes"] for r in ranks],
        "ranks_equal_to_the_bit": same,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m gorio_tpu_torch.parallel.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=None,
                    help="ranks to spawn (not under torchrun; default: the card count)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="gloo with --device cuda puts every rank on one card")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the ranks on the CPU")
    device = "cuda:0" if args.device == "cuda" and args.backend == "gloo" else args.device
    if "RANK" in os.environ:  # one of torchrun's ranks
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
        initialize_distributed(device=device, backend=args.backend)
        mine = run_rank(device)
        # to the CPU: all_gather_object would unpickle each rank's tensors on its card
        mine["result"] = {k: type(v)(*(t.cpu() for t in v)) if hasattr(v, "_fields")
                          else tuple(t.cpu() for t in v) for k, v in mine["result"].items()}
        ranks = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(ranks, mine)
        if torch.distributed.get_rank() == 0:
            print(json.dumps(summary(ranks)), flush=True)
        torch.distributed.destroy_process_group()
        return
    n = args.nproc or (torch.cuda.device_count() if args.device == "cuda" else 1)
    if device == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"NCCL takes one rank per card: {n} ranks, "
                         f"{torch.cuda.device_count()} cards (--backend gloo shares one)")
    if args.device == "cuda":
        from ..ops import nn as K

        K.build_library()  # once, here: the ranks only load it
    ranks = spawn(run_rank, n, device, device=device, backend=args.backend)
    print(json.dumps(summary(ranks)), flush=True)


if __name__ == "__main__":
    sys.exit(main())
