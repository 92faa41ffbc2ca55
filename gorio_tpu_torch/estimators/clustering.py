"""DBSCAN clustering with distance-ranked cluster ids.

Port of `gorio_tpu/estimators/clustering.py` (`DBSCANKdtreeCluster` and the
ranking loop of `preprocessing_nodelet_ntu.cpp:520-568`): the kd-tree range
queries become one batched self-kNN (distance-masked), the BFS cluster
expansion an iterative min-label propagation over the core-point graph, and
"rank the clusters by centroid distance, write rank + 1" a segment sum plus
a stable sort.

The propagation is the JAX `lax.while_loop` (at most `max_label_iters`
rounds, stopping once no label changes): here it runs in blocks of
`_CHECK_EVERY` rounds with one host read of the on-device `changed` flag per
block. A round after convergence changes nothing, so the labels are the
same as the JAX package's, with at most `_CHECK_EVERY - 1` extra rounds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.pointcloud import PointCloud, segment_sum_by_id
from ..registration.knn import knn

_CHECK_EVERY = 8  # propagation rounds per host read of the `changed` flag


class DBSCANConfig(NamedTuple):
    """Defaults mirror `preprocessing_nodelet_ntu.cpp:527-530`."""

    eps: float = 0.9
    core_min_pts: int = 10
    min_cluster_size: int = 20
    max_cluster_size: int = 25000
    k_neighbors: int = 32  # neighbour candidates per point (>= core_min_pts)
    max_label_iters: int = 50
    adaptive_eps: bool = False  # eps_i = |r - 1| / 50 + eps (`DBSCAN_simple.h:36-40`)


def dbscan_cluster(cloud: PointCloud, cfg: DBSCANConfig = DBSCANConfig()) -> PointCloud:
    """Label the clusters and write distance-rank ids into `cluster` (rank + 1;
    0 = unclustered), the reference's normal_x convention."""
    n = cloud.capacity
    dtype, device = cloud.xyz.dtype, cloud.xyz.device
    idx, sqd = knn(cloud.xyz, cloud.xyz, cfg.k_neighbors, ref_mask=cloud.mask)
    if cfg.adaptive_eps:
        eps = torch.abs(torch.linalg.norm(cloud.xyz, dim=-1) - 1.0) / 50.0 + cfg.eps
    else:
        eps = torch.full((n,), cfg.eps, dtype=dtype, device=device)
    within = (sqd <= eps[:, None] ** 2) & cloud.mask[:, None] & cloud.mask[idx]
    core = cloud.mask & (torch.sum(within, dim=1) >= cfg.core_min_pts)

    # min-label propagation over core-core edges; border points attach after
    none = torch.tensor(n, dtype=torch.int64, device=device)
    labels = torch.where(core, torch.arange(n, device=device), none)
    link = within & core[idx]
    rounds = 0
    while rounds < cfg.max_label_iters:
        changed = torch.zeros((), dtype=torch.bool, device=device)
        for _ in range(min(_CHECK_EVERY, cfg.max_label_iters - rounds)):
            neigh = torch.where(link, labels[idx], none)
            new = torch.where(core, torch.minimum(labels, torch.min(neigh, dim=1).values), labels)
            changed = changed | torch.any(new != labels)
            labels = new
            rounds += 1
        if not bool(changed):
            break

    # border points: the label of any core neighbour within eps
    border = torch.min(torch.where(link, labels[idx], none), dim=1).values
    labels = torch.where(core, labels, torch.where(cloud.mask, border, none))

    # cluster sizes and gating
    live = labels < n
    sizes = torch.zeros(n + 1, dtype=torch.int64, device=device).index_add_(
        0, labels, live.long())[:-1]
    ok_size = (sizes >= cfg.min_cluster_size) & (sizes <= cfg.max_cluster_size)
    labels = torch.where(live & ok_size[torch.clamp(labels, 0, n - 1)], labels, none)

    # centroid distance per cluster -> rank (`:538-566`); a stable sort puts
    # the lower cluster id first among equal distances, as XLA's does
    w = (labels < n).to(dtype)
    cent = segment_sum_by_id(cloud.xyz * w[:, None], labels, n)
    cnt = segment_sum_by_id(w, labels, n)
    dist = torch.linalg.norm(cent / torch.clamp(cnt, min=1.0)[:, None], dim=-1)
    dist = torch.where(cnt > 0, dist, torch.full_like(dist, float("inf")))
    order = torch.sort(dist, stable=True).indices
    rank_of = torch.zeros(n + 1, dtype=torch.int64, device=device)
    rank_of[order] = torch.arange(1, n + 1, device=device)
    cluster_id = torch.where(labels < n, rank_of[torch.clamp(labels, 0, n - 1)],
                             torch.zeros_like(labels))
    return cloud._replace(cluster=cluster_id.to(dtype))
