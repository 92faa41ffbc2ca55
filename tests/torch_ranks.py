"""Rank targets of the mesh tests (`test_torch_parallel*.py`), spawned
through `gorio_tpu_torch.parallel.mesh.spawn`.

A spawned rank re-imports the module of its target, and every `test_*.py`
imports JAX, so the targets live here, in a module that imports none of it.
Each target blocks `jax`, `jaxlib` and `gorio_tpu` with the import hook of
`test_torch_no_jax.py::test_port_runs_without_jax` and returns, beside its
results (`spawn` hands them back on the CPU), the names of any such module
its process holds."""

import sys

BLOCKED = ("jax", "jaxlib", "gorio_tpu")


class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")


def _block():
    import torch

    sys.meta_path.insert(0, NoJax())
    torch.set_num_threads(1)


def _leaked():
    return sorted(m for m, v in sys.modules.items()
                  if v is not None and m.split(".")[0] in BLOCKED)


def programs(inputs):
    """World 4: the sharded align (gicp and apdgicp, "mp"), graph solve and
    UGPM windows ("dp") on the tests' inputs, and `dryrun_multichip` on the
    (dp, mp) = (2, 2) mesh."""
    _block()
    from gorio_tpu_torch.graph.solver import SolveConfig
    from gorio_tpu_torch.parallel.dryrun import dryrun_multichip
    from gorio_tpu_torch.parallel.mesh import make_mesh
    from gorio_tpu_torch.parallel.sharded import (sharded_gicp_align, sharded_optimize_graph,
                                                  sharded_ugpm_windows)
    from gorio_tpu_torch.registration.gicp import GICPConfig

    mp = make_mesh((4,), ("mp",), "cpu")
    dp = make_mesh((4,), ("dp",), "cpu")
    out = {mode: sharded_gicp_align(mp, GICPConfig(mode=mode), "mp")(*inputs["clouds"])
           for mode in ("gicp", "apdgicp")}
    out["graph"] = sharded_optimize_graph(dp, SolveConfig(max_iterations=32), "dp")(
        *inputs["graph"])
    out["ugpm"] = sharded_ugpm_windows(dp, "dp")(*inputs["ugpm"])
    out["dryrun"] = dryrun_multichip(make_mesh((2, 2), ("dp", "mp"), "cpu"))
    out["leaked"] = _leaked()
    return out


def inference(inputs):
    """World 4 on a flat "dp" mesh: `sharded_smc_step` over the given steps
    (and each step's parents, gathered, and cumulative weights), and `smc_loop_relaxation` on the
    given graph and global draws."""
    _block()
    import torch

    from gorio_tpu_torch.inference import smc, smoother
    from gorio_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((4,), ("dp",), "cpu")
    mean, var = inputs["target"]

    def log_target(x):
        return -0.5 * torch.sum((x - mean) ** 2 / var, dim=-1)

    step = smc.sharded_smc_step(mesh, log_target)
    p, lw = inputs["smc_init"]
    steps, cums = [], []
    for u, z in inputs["smc_draws"]:
        parents, cum = smc.sharded_parents(mesh, log_target, p, lw, u)
        p, lw, ess = step(p, lw, 0.05, u=u, z=z)
        steps.append((p, lw, ess, parents))
        cums.append(cum)
    poses0, graph, loop_mask, kw, draws = inputs["smoother"]
    res = smoother.smc_loop_relaxation(mesh, poses0, graph, loop_mask, **kw)(draws=draws)
    return {"smc": steps, "smc_cum": cums, "smoother": res, "leaked": _leaked()}


def card_align(inputs):
    """Ranks sharing one card over gloo: the sharded APDGICP align, its
    `gorio_nn1` launches on this rank."""
    import torch

    from gorio_tpu_torch.ops import nn as K
    from gorio_tpu_torch.parallel.mesh import make_mesh
    from gorio_tpu_torch.parallel.sharded import sharded_gicp_align
    from gorio_tpu_torch.registration.gicp import GICPConfig

    K.reset_launch_counts()
    mesh = make_mesh((torch.distributed.get_world_size(),), ("mp",), "cuda:0")
    res = sharded_gicp_align(mesh, GICPConfig(mode="apdgicp"), "mp")(*inputs)
    torch.cuda.synchronize()
    return {"align": res, "nn1": K.launch_counts["nn1"]}


def fails_on_rank1():
    """Rank 1 raises; rank 0 waits in a collective for it."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails")
    dist.barrier()
