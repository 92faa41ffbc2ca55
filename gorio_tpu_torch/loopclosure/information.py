"""Edge information matrices from registration fitness.

Port of `gorio_tpu/loopclosure/information.py` (`InformationMatrixCalculator`,
`information_matrix_calculator.cpp`): fitness = mean squared NN residual of
inliers (one `nn1_best` kernel launch, at any batch size), then a
sigmoid-weighted interpolation between min/max stddevs.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.pointcloud import PointCloud
from ..registration.gicp import fitness_score


class InformationConfig(NamedTuple):
    use_const_inf_matrix: bool = False
    const_stddev_x: float = 0.5
    const_stddev_q: float = 0.1
    var_gain_a: float = 20.0
    min_stddev_x: float = 0.1
    max_stddev_x: float = 5.0
    min_stddev_q: float = 0.05
    max_stddev_q: float = 0.2
    fitness_score_thresh: float = 2.5
    fitness_max_range: float = 1.0  # `calc_fitness_score` default max_range^2


def _weight(a, max_x, min_y, max_y, x):
    """Sigmoid ramp (`information_matrix_calculator.cpp:29-41`)."""
    y = (1.0 - torch.exp(-a * x)) / (1.0 - math.exp(-a * max_x))
    return min_y + (max_y - min_y) * y


def calc_information_matrix(
    source: PointCloud, target: PointCloud, T, cfg: InformationConfig = InformationConfig()
):
    """6x6 information with [rot, trans] ordering; returns (info, fitness).
    Batched like `fitness_score`: clouds (B, N, .) and T (B, 4, 4) give info
    (B, 6, 6) and fitness (B,) from one `nn1_best` launch."""
    dtype, device = T.dtype, T.device
    lead = T.shape[:-2]
    eye3 = torch.eye(3, dtype=dtype, device=device)
    if cfg.use_const_inf_matrix:
        inf = torch.zeros((*lead, 6, 6), dtype=dtype, device=device)
        inf[..., :3, :3] = eye3 / cfg.const_stddev_q ** 2
        inf[..., 3:, 3:] = eye3 / cfg.const_stddev_x ** 2
        return inf, torch.zeros(lead, dtype=dtype, device=device)
    fitness, _ = fitness_score(source, target, T, max_range=cfg.fitness_max_range)
    x = torch.clamp(fitness, max=cfg.fitness_score_thresh)
    a, thresh = cfg.var_gain_a, cfg.fitness_score_thresh
    w_x = _weight(a, thresh, cfg.min_stddev_x ** 2, cfg.max_stddev_x ** 2, x)
    w_q = _weight(a, thresh, cfg.min_stddev_q ** 2, cfg.max_stddev_q ** 2, x)
    inf = torch.zeros((*lead, 6, 6), dtype=dtype, device=device)
    inf[..., :3, :3] = eye3 / w_q[..., None, None]
    inf[..., 3:, 3:] = eye3 / w_x[..., None, None]
    return inf, fitness
