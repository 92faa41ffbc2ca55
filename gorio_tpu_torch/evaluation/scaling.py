"""Weak scaling of the sharded programs over ranks: `scripts/bench_scaling.py`
on the port.

The script measured the `shard_map` / `pjit` programs on n in {1, 2, 4, 8}
virtual CPU devices, holding the work per device constant. Here a device
is a rank of `parallel/mesh.py` `spawn`: world 1 runs over NCCL, worlds
2-8 as gloo ranks that share `cuda:0` (NCCL refuses two ranks on one
card; gloo copies through the host), with `--device cpu` gloo ranks on the
CPU. Every rank sets `CUBLAS_WORKSPACE_CONFIG` before its first CUDA call.
The work per rank and the repetitions are the script's:

* `smc_step`: 4,096 particles of D = 60 per rank (numpy seed 0), 20 reps,
  `inference/smc.py` `sharded_smc_step`;
* `ugpm_fit`: 16 windows per rank (G = 128, V = 32,
  `UGPMConfig(window_duration=0.6, lm_iters=10)`), 20 reps, the batched
  `ugpm_fit` of each rank's shard of the windows, in float64 (the port's
  UGPM does not run float32);
* `apdgicp_pairs_dp`: 2 pairs of 2,048-point clouds per rank, 8 LM
  iterations, 5 reps, `gicp_align_batch` on each rank's pairs (one
  `gorio_nn1_select` launch per LM iteration);
* `apdgicp_mp_strong`: a fixed 8,192-point pair, the source split over an
  `mp` mesh, 5 reps, `parallel/sharded.py` `sharded_gicp_align` (one
  `gorio_nn1` launch per rank and linearize);
* `graph_solve`: K = 48 poses and 128 random between factors per rank, 8
  LM iterations, 5 reps, `sharded_optimize_graph`, in float64 (the port's
  LM does not run float32 graphs).

The post-processing and the JSON keys are the script's; rank 0's clock
(the host clock around the reps, ending in a synchronise) gives a row.
Every rate keeps two decimals (the script rounds windows, particle steps
and factors per second to whole numbers, and a rate below 0.5 / s read 0),
and the post-processing takes each row's rate by its key, where the
script took the first nonzero one.
`--update` writes `--out`, never the JAX package's `SCALING.json`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .sequence import card_name, device_of

NS = (1, 2, 4, 8)
REPS = {"smc_step": 20, "ugpm_fit": 20, "apdgicp_pairs_dp": 5, "apdgicp_mp_strong": 5,
        "graph_solve": 5}
SHIFT = (0.1, -0.05, 0.02)


class Sizes(NamedTuple):
    """The work per rank; the defaults are the script's."""
    ppd: int = 4096  # SMC particles per rank
    d: int = 60  # their dimensions
    wpd: int = 16  # UGPM windows per rank
    g: int = 128  # gyro samples per window
    v: int = 32  # velocity samples per window
    pairs: int = 2  # APDGICP pairs per rank
    npts: int = 2048  # points per pair's cloud
    npts_s: int = 8192  # points of the strong-scaling pair
    graph_k: int = 48  # poses of the graph
    fpd: int = 128  # between factors per rank


METHOD = (
    "gorio_tpu_torch/evaluation/scaling.py (scripts/bench_scaling.py on the port) over n = "
    "1/2/4/8 ranks of torch.distributed on ONE card ({card}): n = 1 is one NCCL rank, n > 1 "
    "are gloo ranks that all put their tensors on cuda:0 (NCCL takes one rank per card, and "
    "this machine has {cards}), so each collective goes through the host. The rows therefore "
    "measure the sharded programs' overhead and the card's and host's contention, not "
    "scaling across cards: every rank shares one H100 and the host's {cores} cores. "
    "Weak-scaling rows hold the work per rank constant (smc particles, ugpm windows, graph "
    "factors, apdgicp PAIRS per rank); host_ideal_efficiency is min(1, {cores}/n), the bound "
    "the ranks' host threads set, and on one card the card itself is shared too. "
    "apdgicp_mp_strong is a STRONG-scaling row (a fixed 8192-point pair, the point axis split "
    "over the ranks, one 1-NN launch per rank and linearize): speedup_vs_1dev and "
    "host_ideal_speedup. The random clouds come from torch.Generators (core/pointcloud.py "
    "random_cloud), not jax.random, so they are not the JAX script's clouds; the SMC "
    "population, UGPM streams, 8192-point pair and graph are the script's numpy draws. UGPM "
    "and the graph solve run in float64, the rest in float32."
)


def bench(fn, *args, reps=20, device):
    """Seconds per call: one warm-up call, then `reps` calls back to back,
    the host clock ending in a synchronise of `device` (`bench.mean_s`)."""
    from ..bench import mean_s

    return mean_s(lambda: fn(*args), reps, torch.device(device))


def _smc(mesh, n, rng, reps, sz):
    from ..inference.smc import sharded_smc_step

    NP = sz.ppd * n
    dev = mesh.device
    particles = torch.as_tensor(rng.normal(size=(NP, sz.d)), dtype=torch.float32, device=dev)
    logw = torch.zeros((NP,), dtype=torch.float32, device=dev)
    std = torch.tensor(0.1, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)  # the same draws on every rank
    step = sharded_smc_step(mesh, lambda x: -0.5 * torch.sum(x * x, dim=-1))
    dt = bench(lambda: step(particles, logw, std, generator=gen), reps=reps, device=dev)
    return {"workload": "smc_step", "n_devices": n, "particles": NP,
            "steps_per_s": round(1.0 / dt, 2), "particle_steps_per_s": round(NP / dt, 2)}


def _ugpm(mesh, n, rng, reps, sz):
    from ..parallel.mesh import shard_rows
    from ..preintegration.ugpm import UGPMConfig, ugpm_fit

    W, G, V = sz.wpd * n, sz.g, sz.v
    dev = mesh.device
    gyr = rng.normal(scale=0.2, size=(W, G, 3))
    vel = rng.normal(scale=1.0, size=(W, V, 3))
    rows = shard_rows(mesh, W, "dp")
    args = [torch.as_tensor(x[rows], dtype=torch.float64, device=dev) for x in (
        np.linspace(0, 1.0, G)[None].repeat(W, 0), gyr,
        np.linspace(0, 1.0, V)[None].repeat(W, 0), vel, np.full(W, 0.2))]
    cfg = UGPMConfig(window_duration=0.6, lm_iters=10)
    dt = bench(lambda: ugpm_fit(*args, 1e-4, 1e-3, cfg).alpha, reps=reps, device=dev)
    return {"workload": "ugpm_fit", "n_devices": n, "windows": W,
            "windows_per_s": round(W / dt, 2)}


def _gicp_cfg():
    from ..registration.gicp import GICPConfig

    return GICPConfig(mode="apdgicp", lm=GICPConfig().lm._replace(max_iterations=8))


def _pairs_dp(mesh, n, reps, sz):
    from ..core.pointcloud import PointCloud, random_cloud
    from ..parallel.mesh import shard_rows
    from ..registration.gicp import gicp_align_batch

    B, NPTS = sz.pairs * n, sz.npts
    dev = mesh.device
    gen = torch.Generator().manual_seed(4)  # every rank draws the global batch
    tgts = [random_cloud(gen, NPTS, capacity=NPTS) for _ in range(B)]
    rows = shard_rows(mesh, B, "dp")
    tgts = PointCloud(*(torch.stack(x)[rows].to(dev) for x in zip(*tgts)))
    srcs = tgts._replace(xyz=tgts.xyz + torch.tensor(SHIFT, device=dev))
    eye = torch.eye(4, device=dev).expand(tgts.xyz.shape[0], 4, 4)
    cfg = _gicp_cfg()
    dt = bench(lambda: gicp_align_batch(srcs, tgts, eye, cfg).T, reps=reps, device=dev)
    return {"workload": "apdgicp_pairs_dp", "n_devices": n, "pairs": B,
            "points_per_pair": NPTS, "pairs_per_s": round(B / dt, 2)}


def _mp_strong(mesh_mp, n, rng, reps, sz):
    from ..core.pointcloud import make_cloud
    from ..parallel.sharded import sharded_gicp_align

    dev, NPTS_S = mesh_mp.device, sz.npts_s
    tgt_np = rng.normal(scale=3.0, size=(NPTS_S, 3)).astype(np.float32)
    src_np = tgt_np + np.array(SHIFT, np.float32)
    src = make_cloud(torch.as_tensor(src_np), capacity=NPTS_S, device=dev)
    tgt = make_cloud(torch.as_tensor(tgt_np), capacity=NPTS_S, device=dev)
    align = sharded_gicp_align(mesh_mp, _gicp_cfg(), "mp")
    dt = bench(lambda: align(src, tgt).T, reps=reps, device=dev)
    return {"workload": "apdgicp_mp_strong", "n_devices": n, "points_total": NPTS_S,
            "align_ms": round(dt * 1e3, 2)}


def _graph(mesh, n, rng, reps, sz):
    from ..graph.graph import PoseGraph
    from ..graph.solver import SolveConfig
    from ..parallel.sharded import sharded_optimize_graph

    F, GRAPH_K = sz.fpd * n, sz.graph_k
    g = PoseGraph(dtype=np.float64)
    Ts = [np.eye(4)]
    for _ in range(GRAPH_K - 1):
        d = np.eye(4)
        d[:3, 3] = [1.0, 0.0, 0.0]
        Ts.append(Ts[-1] @ d)
    for T in Ts:
        g.add_pose(T)
    g.add_prior(0, Ts[0], info=np.eye(6) * 1e4)
    for a, b in rng.integers(0, GRAPH_K - 1, size=(F, 2)):
        i, j = (int(a), int(b)) if a != b else (int(a), (int(a) + 1) % GRAPH_K)
        g.add_between(i, j, np.linalg.inv(Ts[i]) @ Ts[j], info=np.eye(6) * 25.0)
    poses0, graph = g.freeze(device=mesh.device)
    solve = sharded_optimize_graph(mesh, SolveConfig(max_iterations=8), "dp")
    dt = bench(lambda: solve(poses0, graph).poses, reps=reps, device=mesh.device)
    return {"workload": "graph_solve", "n_devices": n, "factors": F,
            "factors_per_s": round(F / dt, 2)}


def rank_rows(n, device, reps, sizes=Sizes()):
    """One rank of a world of n: the five workloads on flat "dp" and "mp"
    meshes, in the script's order and with its numpy draws. Returns the
    rows (rank 0's clock is the one reported) and the rank's launches."""
    from ..ops import nn as K
    from ..parallel.mesh import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dp, mp = make_mesh((n,), ("dp",), device), make_mesh((n,), ("mp",), device)
    K.reset_launch_counts()
    rng = np.random.default_rng(0)
    rows = [_smc(dp, n, rng, reps["smc_step"], sizes),
            _ugpm(dp, n, rng, reps["ugpm_fit"], sizes),
            _pairs_dp(dp, n, reps["apdgicp_pairs_dp"], sizes),
            _mp_strong(mp, n, rng, reps["apdgicp_mp_strong"], sizes),
            _graph(dp, n, rng, reps["graph_solve"], sizes)]
    return {"rows": rows, "launches": dict(K.launch_counts), "device": str(dp.device),
            "backend": dp.backend}


RATES = ("particle_steps_per_s", "windows_per_s", "pairs_per_s", "factors_per_s")


def postprocess(results, cores):
    """The script's: each weak row's throughput per device over n = 1's
    (`weak_scaling_efficiency`) beside min(1, cores / n); each strong row's
    speedup over n = 1's beside min(cores, n)."""
    base, strong_base = {}, {}
    for r in results:
        k = r["workload"]
        if "align_ms" in r:  # strong-scaling row: speedup, not efficiency
            if r["n_devices"] == 1:
                strong_base[k] = r["align_ms"]
            r["speedup_vs_1dev"] = round(strong_base[k] / r["align_ms"], 3)
            r["host_ideal_speedup"] = round(min(cores, r["n_devices"]), 3)
        else:
            per_dev = next(r[key] for key in RATES if key in r) / r["n_devices"]
            if r["n_devices"] == 1:
                base[k] = per_dev
            r["weak_scaling_efficiency"] = round(per_dev / base[k], 3)
            r["host_ideal_efficiency"] = round(min(1.0, cores / r["n_devices"]), 3)
    return results


def main(ns=NS, device="cuda", reps=None, sizes=Sizes(), log=print):
    """Every world of `ns` in turn; returns (rows, cores, what) with `what`
    the card, the launches by world and each world's wall seconds."""
    from ..parallel.mesh import spawn

    device = device_of(device)
    reps = {**REPS, **(reps or {})}
    card = card_name(device)
    if device.type == "cuda":
        from ..ops import nn as K

        K.load_library()  # built once here; the ranks load it
    results, what = [], {"card": card, "launches": {}, "wall_s": {}, "backend": {}}
    for n in ns:
        if device.type == "cuda":
            where, backend = ("cuda", None) if n == 1 else ("cuda:0", "gloo")
        else:
            where, backend = "cpu", "gloo"
        t0 = time.perf_counter()
        ranks = spawn(rank_rows, n, n, where, reps, sizes, device=where, backend=backend)
        what["wall_s"][n] = time.perf_counter() - t0
        what["backend"][n] = f"{ranks[0]['backend']} on {ranks[0]['device']}"
        what["launches"][n] = {k: sum(r["launches"][k] for r in ranks)
                               for k in ranks[0]["launches"]}
        results += ranks[0]["rows"]
        log(f"# scaling: world {n} ({what['backend'][n]}) in {what['wall_s'][n]:.1f} s, "
            f"launches {what['launches'][n]}", file=sys.stderr)
    cores = os.cpu_count() or 1
    for r in postprocess(results, cores):
        log(f"[scaling] {card}: {json.dumps(r)}")
    return results, cores, what


def north_star(bench_json: dict | None) -> dict:
    """The north-star section: BASELINE.md's definition and, from a line of
    the port's `python -m gorio_tpu_torch.cli bench`, its `hmc_*` keys."""
    ns = {
        "definition": "BASELINE.md: >= 1000x the reference's trajectory samples/s; read here "
        "from the port's `cli bench` line on one card",
        "reference_equivalent": (
            "the reference has NO sampling primitive: g2o returns one MAP point estimate per "
            "optimization tick (graph_slam.cpp:353-382). There is no defensible samples-per-"
            "second figure to assign to it, so no numeric x-factor is claimed against it. The "
            "rate quoted is the quality-normalized one below: independent EFFECTIVE draws/s "
            "from the 300-dof trajectory posterior on one card."
        ),
    }
    if bench_json:
        for k in ("hmc_samples_per_s", "hmc_ess_min_per_s", "hmc_ess_median_per_s",
                  "hmc_rhat_max", "hmc_accept_mean"):
            if k in bench_json:
                ns[k] = bench_json[k]
        ns["quality_note"] = (
            "ESS via the multi-chain Geyer estimator (gorio_tpu_torch.inference.hmc.chain_ess), "
            "split R-hat, acceptance from the same run (`cli bench`, 16 chains x 512 draws, "
            "overdispersed inits). ESS/s, not raw samples/s, is the rate to quote; raw "
            "samples/s is reported for continuity."
        )
    return ns


def main_cli(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--update", action="store_true", help="write the record to --out")
    ap.add_argument("--out", default=None, help="the record's path (never SCALING.json)")
    ap.add_argument("--bench", default=None,
                    help="a `python -m gorio_tpu_torch.cli bench` output line (JSON) to source "
                    "the north-star section's hmc ESS / R-hat numbers")
    args = ap.parse_args(argv)
    if args.update and not args.out:
        ap.error("--update writes to --out: name the file")
    results, cores, what = main(device=args.device,
                                log=lambda *a, **k: print(*a, flush=True, **k))
    bench_json = json.loads(Path(args.bench).read_text()) if args.bench else None
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    out = {
        "method": METHOD.format(card=what["card"], cores=cores,
                                cards=f"{n_cards} card{'s' if n_cards != 1 else ''}"),
        "north_star": north_star(bench_json),
        "weak_scaling": [r for r in results if "align_ms" not in r],
        "strong_scaling_mp": [r for r in results if "align_ms" in r],
        "launches_by_world": what["launches"],
    }
    if args.update:
        Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main_cli()
