"""Sharded forms of the flagship programs over a `Mesh` of ranks.

Port of `gorio_tpu/parallel/sharded.py`:

1. `sharded_ugpm_windows` — data-parallel batched UGPM: the window axis
   split over `dp`, each rank running the batched `ugpm_preintegrate`
   (`torch.func.vmap` of one window) on its windows.
2. `sharded_gicp_align` — APDGICP / GICP with the source points split over
   `mp` and the target on every rank: each rank runs the correspondence
   search (the `gorio_nn1` kernel, its queries against the whole target)
   and the Mahalanobis linearization of its points, cost / H / b are
   all-reduced, and the LM driver (`lm_optimize`) runs on every rank alike.
3. `sharded_optimize_graph` — the pose-graph LM with every factor family's
   factor axis split over `dp`: each rank builds the normal equations of its
   factors, H / b / chi2 are all-reduced, and the dense or CG solve runs on
   every rank alike.

Each returned `call` takes the global inputs on every rank, as the JAX
`call`s do with `device_put`, and returns what they return: the global
window axis for UGPM (gathered on every rank), a replicated result for the
align and the graph solve. The replicated values are computed from
all-reduced ones by the same operations on every rank, so the ranks agree
to the bit; against the one-card programs they differ by the order of the
reductions.
"""

from __future__ import annotations

import torch

from ..core.pointcloud import PointCloud
from ..graph.factors import GraphData
from ..graph.solver import (SolveConfig, SolveResult, build_normal_equations, f32_matmuls,
                            graph_chi2, lm_graph)
from ..preintegration.types import PreintMeas
from ..preintegration.ugpm import UGPMConfig, ugpm_preintegrate
from ..registration.gicp import (GICPConfig, GICPProblem, _covariances, knn_covariances,
                                 make_gicp_callbacks_reference)
from ..registration.lsq import LMResult, lm_optimize
from .mesh import Mesh, gather_rows, psum, shard_rows

# ---------------------------------------------------------------------------
# 1) data-parallel batched UGPM over windows
# ---------------------------------------------------------------------------


def sharded_ugpm_windows(mesh: Mesh, axis: str = "dp"):
    """Returns call(gyr_t (W, G), gyr (W, G, 3), vel_t (W, V), vel (W, V, 3),
    starts (W,), queries (W, Q), gyr_var, vel_var, cfg) -> PreintMeas with
    the global window axis W, whose windows are split over `axis`. W must
    divide by the axis size."""

    def call(gyr_t, gyr, vel_t, vel, starts, queries, gyr_var, vel_var,
             cfg: UGPMConfig = UGPMConfig()) -> PreintMeas:
        rows = shard_rows(mesh, len(starts), axis)
        local = [torch.as_tensor(x)[rows].to(mesh.device).contiguous()
                 for x in (gyr_t, gyr, vel_t, vel, starts, queries)]
        meas = ugpm_preintegrate(*local, float(gyr_var), float(vel_var), cfg)
        return PreintMeas(*(gather_rows(mesh, f, axis) for f in meas))

    return call


# ---------------------------------------------------------------------------
# 2) tensor-parallel GICP / APDGICP (points sharded, all-reduced normal equations)
# ---------------------------------------------------------------------------


def _covariance_rows(cloud: PointCloud, cfg: GICPConfig, rows: slice):
    """(cov, geo_w) of the cloud's `rows`, with the neighbourhoods the whole
    cloud's `prepare_gicp` gives them: the kNN of those rows among all the
    points (the RBF covariances are computed whole, then sliced)."""
    if cfg.mode != "icp" and cfg.covariance_method == "knn":
        return knn_covariances(cloud.xyz, cloud.mask, cfg.k_correspondences, cfg.plane_eps,
                               query=cloud.xyz[rows])
    cov, geo_w = _covariances(cloud, cfg)
    return cov[rows], geo_w[rows]


def _prepare_shard(source: PointCloud, target: PointCloud, cfg: GICPConfig, mesh: Mesh,
                   axis: str) -> GICPProblem:
    """The problem of this rank's source points against the whole target,
    whose covariances every rank computes, as the replicated target of the
    JAX program."""
    rows = shard_rows(mesh, source.xyz.shape[0], axis)
    src_cov, src_geo = _covariance_rows(source, cfg, rows)
    return GICPProblem(
        src_xyz=source.xyz[rows].contiguous(), src_mask=source.mask[rows],
        src_cov=src_cov, src_geo_w=src_geo, src_cluster=source.cluster[rows],
        tgt_xyz=target.xyz, tgt_mask=target.mask, tgt_cov=_covariances(target, cfg)[0],
        tgt_cluster=target.cluster,
    )


def sharded_gicp_align(mesh: Mesh, cfg: GICPConfig = GICPConfig(), axis: str = "mp"):
    """Returns call(source, target, init_T=None) -> LMResult: the APDGICP /
    GICP / ICP align with the source point axis split over `axis` and the
    target on every rank. The source capacity must divide by the axis
    size. Each linearize is one `nn1_best` (`gorio_nn1`) launch per rank, on
    its contiguous slice of the moved source."""
    if cfg.mode not in ("apdgicp", "gicp", "icp"):
        raise ValueError(f"unknown GICP mode {cfg.mode!r}")

    def call(source: PointCloud, target: PointCloud, init_T=None) -> LMResult:
        n_total = source.xyz.shape[0]
        shard_rows(mesh, n_total, axis)  # raises unless it divides
        source = PointCloud(*(t.to(mesh.device) for t in source))
        target = PointCloud(*(t.to(mesh.device) for t in target))
        if init_T is None:
            init_T = torch.eye(4, dtype=source.xyz.dtype, device=mesh.device)
        prob = _prepare_shard(source, target, cfg, mesh, axis)
        linearize, compute_error = make_gicp_callbacks_reference(
            prob, cfg, n_total=n_total, reduce=lambda x: psum(mesh, x, axis))
        return lm_optimize(linearize, compute_error, init_T.to(mesh.device), cfg.lm)

    return call


# ---------------------------------------------------------------------------
# 3) pose-graph LM with the factor axis sharded + all-reduced H / b
# ---------------------------------------------------------------------------


def _pad_family(fam, m: int):
    """Pad every per-factor tensor of a factor family to a multiple of m
    rows. Padding rows: mask 0 (they contribute nothing), indices 0,
    robust_delta inf, the rest 0."""
    pad = -fam.mask.shape[0] % m
    if pad == 0:
        return fam
    return type(fam)(**{
        name: torch.cat([t, torch.full((pad, *t.shape[1:]),
                                       float("inf") if name == "robust_delta" else 0,
                                       dtype=t.dtype, device=t.device)])
        for name, t in fam._asdict().items()})


def pad_graph_for(graph: GraphData, n_devices: int) -> GraphData:
    """Pad every factor family's factor axis to a multiple of n_devices so
    the graph splits evenly."""
    return GraphData(*(_pad_family(f, n_devices) for f in graph))


def sharded_optimize_graph(mesh: Mesh, cfg: SolveConfig = SolveConfig(), axis: str = "dp"):
    """Returns call(poses0 (K, 4, 4), graph) -> SolveResult: `optimize_graph`
    with every factor family split over `axis` (padded to a multiple of its
    size). Each rank assembles the normal equations of its factors with
    `build_normal_equations`; H, b and chi2 are all-reduced in one
    reduction, the chi2 of a trial step in another, and the LM loop and the
    dense / CG solve (`cfg.solver`) run on every rank alike. The host reads
    the stop flag once per iteration, as `optimize_graph` does."""

    def call(poses0, graph: GraphData) -> SolveResult:
        poses0 = torch.as_tensor(poses0).to(mesh.device)
        graph = pad_graph_for(GraphData(*(type(f)(*(torch.as_tensor(t).to(mesh.device)
                                                    for t in f)) for f in graph)),
                              mesh.shape[axis])
        local = GraphData(*(type(f)(*(t[shard_rows(mesh, t.shape[0], axis)].contiguous()
                                      for t in f)) for f in graph))
        K = poses0.shape[0]

        def normal_equations(poses):
            Hb, bb, chi2 = build_normal_equations(poses, local)
            s = psum(mesh, torch.cat([Hb.reshape(-1), bb.reshape(-1), chi2[None]]), axis)
            return s[:K * K * 36].reshape(K, K, 6, 6), s[K * K * 36:-1].reshape(K, 6), s[-1]

        with f32_matmuls():
            return lm_graph(poses0, normal_equations,
                            lambda poses: psum(mesh, graph_chi2(poses, local), axis), cfg)

    return call
