"""Time the pose-graph solvers of whichever `gorio_tpu_torch` is first on
the path, so that two trees compare in turns on one card:

    PYTHONPATH=OTHER_TREE python gorio_tpu_torch/graph/solve_timing.py
    PYTHONPATH=.          python gorio_tpu_torch/graph/solve_timing.py

Two graphs shaped like the slam back end's (a chain of odometry and
preintegration between factors around a 30 m circle with noise, the anchor
prior, Huber loop closures between the first and the last third, unit-prior
dummies up to the padded pose count): the circuit's last solve (361 poses,
13 loops, padded to 512: the block-sparse solver with 16 loop slots) and
the 98-frame slice's (80 poses, no loop, padded to 128: the dense solver).
For each it prints the LM iterations, ms per LM iteration (CUDA events
around a whole solve, median of 3 after a warm-up solve) and the device
activities and device time per LM iteration (torch.profiler, the first
three LM iterations of one solve).
One JSON line, with the card's `nvidia-smi` name and power limit. Needs a
CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch


def chain_graph(n_real, n_pad, n_loops, seed=0):
    """(poses0, GraphData) on the card, shaped like `RadarGraphSLAM.optimize`'s."""
    from gorio_tpu_torch.graph.graph import PoseGraph

    rng = np.random.default_rng(seed)
    truth = []
    for k in range(n_real):
        a = 2 * np.pi * k / n_real
        T = np.eye(4)
        T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        T[:3, 3] = [30 * np.cos(a), 30 * np.sin(a), 0.0]
        truth.append(T)
    g = PoseGraph()
    cur = truth[0]
    g.add_pose(cur)
    g.add_prior(0, truth[0], info=np.eye(6) * 1e6)
    for k in range(1, n_real):
        rel = np.linalg.inv(truth[k - 1]) @ truth[k]
        noisy = rel.copy()
        noisy[:3, 3] += rng.normal(scale=0.03, size=3)
        cur = cur @ noisy
        g.add_pose(cur)
        g.add_between(k - 1, k, noisy, info=np.eye(6) * 50.0)  # odometry
        g.add_between(k - 1, k, rel, info=np.eye(6) * 20.0)  # preintegration
    for _ in range(n_loops):
        i, j = int(rng.integers(0, n_real // 3)), int(rng.integers(2 * n_real // 3, n_real))
        g.add_between(i, j, np.linalg.inv(truth[i]) @ truth[j], info=np.eye(6) * 30.0,
                      robust_delta=1.0)
    for _ in range(n_pad - n_real):
        g.add_prior(g.add_pose(np.eye(4)), np.eye(4), info=1.0)
    return g.freeze(device=torch.device("cuda"))


def _time(solve, poses0, graph, cfg):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    iters = int(solve(poses0, graph, cfg).iterations)  # warm-up
    times = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        solve(poses0, graph, cfg)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    # three LM iterations under the profiler: its host-side event list grows
    # with every kernel
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled = int(solve(poses0, graph, cfg._replace(max_iterations=3)).iterations)
        torch.cuda.synchronize()
    acts = [e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"K": poses0.shape[0], "lm_iterations": iters,
            "ms_per_iteration": statistics.median(times) / iters,
            "device_activities_per_iteration": len(acts) / profiled,
            "device_ms_per_iteration": sum(acts) / 1e3 / profiled}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("solve_timing needs a CUDA device")
    from gorio_tpu_torch.graph import solver, sparse

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    cfg = solver.SolveConfig(max_iterations=30)
    out = {"tree": str(Path(sparse.__file__).resolve().parents[2]), "card": card,
           "sparse": _time(sparse.optimize_graph_sparse, *chain_graph(361, 512, 13),
                           cfg._replace(solver="direct", loop_capacity=16)),
           "dense": _time(solver.optimize_graph, *chain_graph(80, 128, 0), cfg)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
