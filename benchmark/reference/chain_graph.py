"""Frozen copy of `gorio_tpu_torch/graph/solve_timing.chain_graph`, as plain
data: the pose graph shaped like the slam back end's on a 30 m circle
(odometry and preintegration between factors, the anchor prior, Huber loop
closures between the first and the last third, no padding poses).

Returns numpy arrays that both the program's `PoseGraph` and the plain
reference are built from. The draws are the original's, in its order.
"""

from __future__ import annotations

import math

import numpy as np


def chain_graph(n_real: int, n_loops: int, seed: int, radius: float = 30.0,
                odo_noise: float = 0.03, odo_info: float = 50.0, preint_info: float = 20.0,
                loop_info: float = 30.0, loop_delta: float = 1.0, anchor_info: float = 1e6):
    """(poses0 (K, 4, 4), between [(i, j, T (4, 4), info (6, 6), delta)],
    priors [(i, T, info)])."""
    rng = np.random.default_rng(seed)
    truth = []
    for k in range(n_real):
        a = 2 * np.pi * k / n_real
        T = np.eye(4)
        T[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        T[:3, 3] = [radius * np.cos(a), radius * np.sin(a), 0.0]
        truth.append(T)
    poses = [truth[0]]
    priors = [(0, truth[0], np.eye(6) * anchor_info)]
    between = []
    cur = truth[0]
    for k in range(1, n_real):
        rel = np.linalg.inv(truth[k - 1]) @ truth[k]
        noisy = rel.copy()
        noisy[:3, 3] += rng.normal(scale=odo_noise, size=3)
        cur = cur @ noisy
        poses.append(cur)
        between.append((k - 1, k, noisy, np.eye(6) * odo_info, math.inf))
        between.append((k - 1, k, rel, np.eye(6) * preint_info, math.inf))
    for _ in range(n_loops):
        i, j = int(rng.integers(0, n_real // 3)), int(rng.integers(2 * n_real // 3, n_real))
        between.append((i, j, np.linalg.inv(truth[i]) @ truth[j], np.eye(6) * loop_info,
                        loop_delta))
    return np.stack(poses), between, priors
