"""Time the slam back end of whichever `gorio_tpu_torch` is first on the
path (its pose-graph solvers, or with `--ugpm` its UGPM preintegration), so
that two trees compare in turns on one card:

    PYTHONPATH=OTHER_TREE python gorio_tpu_torch/graph/solve_timing.py [--ugpm]
    PYTHONPATH=.          python gorio_tpu_torch/graph/solve_timing.py [--ugpm]

Solvers: two graphs shaped like the slam back end's (a chain of odometry and
preintegration between factors around a 30 m circle with noise, the anchor
prior, Huber loop closures between the first and the last third, unit-prior
dummies up to the padded pose count): the circuit's last solve (361 poses,
13 loops, padded to 512: the block-sparse solver with 16 loop slots) and
the 98-frame slice's (80 poses, no loop, padded to 128: the dense solver).
For each it prints the LM iterations, ms per LM iteration (CUDA events
around a whole solve, median of 3 after a warm-up solve) and the device
activities and device time per LM iteration (torch.profiler, the first
three LM iterations of one solve).

UGPM (`--ugpm`): one keyframe window as `RadarGraphSLAM._preintegrate`
builds it (a 0.8 s window of the synthetic IMU streams, read from 0.2 s
before its start, padded to 256 gyro and 64 velocity samples; 66 GP states,
30 LM iterations, float64, `with_jacobians=False`). It prints the ms of one
call (host clock around a call that ends in `torch.cuda.synchronize()`,
median of 5 after a warm-up), the same split by stage (the card
synchronised around each: the LPM warm start with its unwrap scan, the
stage-1 LM, the query; the rest is the kernel set-up, the velocity kriging
and the state covariance), the device activities and device ms of one call
(torch.profiler), and the host us of one tiny launch (1000 in-place adds on
a one-element tensor).

One JSON line, with the card's `nvidia-smi` name and power limit. Needs a
CUDA device.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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


def time_solves(card):
    from gorio_tpu_torch.graph import solver, sparse

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = solver.SolveConfig(max_iterations=30)
    return {"tree": str(Path(sparse.__file__).resolve().parents[2]), "card": card,
            "sparse": _time(sparse.optimize_graph_sparse, *chain_graph(361, 512, 13),
                            cfg._replace(solver="direct", loop_capacity=16)),
            "dense": _time(solver.optimize_graph, *chain_graph(80, 128, 0), cfg)}


def slam_window(t0=0.9013, t1=1.7013, n_gyr=256, n_vel=64):
    """The back end's padded UGPM window over the synthetic IMU streams."""
    from gorio_tpu_torch.io.synthetic import sample_imu, simulate_trajectory

    imu = sample_imu(simulate_trajectory(seed=3, duration=3.0), gyr_rate=200.0, vel_rate=30.0,
                     gyr_std=0.01, vel_std=0.03, seed=4)
    out = []
    for t, x, n in ((imu.gyr_t, imu.gyr, n_gyr), (imu.vel_t, imu.vel, n_vel)):
        sel = np.nonzero((t >= t0 - 0.2) & (t <= t1 + 0.2))[0][:n]
        pad = n - sel.size
        out += [np.concatenate([t[sel], np.full(pad, t[sel[-1]])]),
                np.concatenate([x[sel], np.repeat(x[sel[-1:]], pad, axis=0)])]
    dev = torch.device("cuda")
    return ([torch.as_tensor(a, device=dev) for a in out], t0,
            torch.tensor([t1], dtype=torch.float64, device=dev), float(imu.gyr_var),
            float(imu.vel_var))


def _synced(fn, into, name):
    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        into[name] = into.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
        return out
    return timed


def time_ugpm(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gorio_tpu_torch.preintegration import ugpm

    arrays, t0, q, gyr_var, vel_var = slam_window()

    def call():
        return ugpm.ugpm_preintegrate(*arrays, t0, q, gyr_var, vel_var, ugpm.UGPMConfig(),
                                      with_jacobians=False)

    call()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        start = time.perf_counter()
        call()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - start))

    stages, orig = {}, {n: getattr(ugpm, n) for n in ("_init_states", "_lm_solve", "ugpm_query")}
    for n, fn in orig.items():
        setattr(ugpm, n, _synced(fn, stages, n))
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        call()
        torch.cuda.synchronize()
        total = 1e3 * (time.perf_counter() - start)
    finally:
        for n, fn in orig.items():
            setattr(ugpm, n, fn)
    stages["rest"] = total - sum(stages.values())

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    acts = [e.device_time_total for e in prof.events() if e.device_type == DeviceType.CUDA]

    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(1000):
        x.add_(1.0)
    torch.cuda.synchronize()
    launch_us = 1e3 * (time.perf_counter() - start)
    return {"tree": str(Path(ugpm.__file__).resolve().parents[2]), "card": card,
            "ms_per_call": statistics.median(times), "calls_ms": times,
            "stages_ms": stages, "device_activities_per_call": len(acts),
            "device_ms_per_call": sum(acts) / 1e3, "host_us_per_tiny_launch": launch_us}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("solve_timing needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(time_ugpm(card) if "--ugpm" in sys.argv[1:] else time_solves(card)))


if __name__ == "__main__":
    main()
