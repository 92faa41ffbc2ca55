"""Named axes over `torch.distributed` ranks, and the collectives over them.

Port of `gorio_tpu/parallel/mesh.py`. The JAX package scales with a
`jax.sharding.Mesh` over devices; here a `Mesh` names the axes of a grid of
ranks, one shard per rank, row-major (rank = the raveled coordinates):

  dp — data parallel: windows / chains / particle blocks
  mp — model parallel: the point / factor axis of one big reduction

The body of a JAX `shard_map` becomes the function each rank runs on its own
slice, and its collectives map onto process groups, one per line of the grid
along each axis: `psum` -> all_reduce(SUM), `pmax` -> all_reduce(MAX),
`all_gather` -> a gather over the axis group, `axis_index` / `axis_size` ->
the rank's coordinate and the axis size; `cumsum_rows` is the cumulative
sum of the gathered rows that every rank holds to the same bits.

Backends (`initialize_distributed`): NCCL on the card, one rank per card;
gloo on the CPU; gloo with CUDA tensors only when asked for, for several
ranks that share one card (gloo copies them through the host). A mesh of
one rank made without a process group runs its collectives as identities.

`spawn` starts the ranks of one program on this host (tests, `chip_smoke.py`
and `python -m gorio_tpu_torch.parallel.dryrun`).
"""

from __future__ import annotations

import math
import os
import tempfile
import time
import traceback
from pathlib import Path
from typing import Sequence

import torch
import torch.distributed as dist

GRACE_S = 20.0  # how long `spawn` lets the other ranks end after one failed
# cuBLAS's fixed workspace, under which its routines repeat their bits with
# several streams active (NVIDIA's reproducibility note); a rank's process
# sets it before its first CUDA call, so that the work every rank repeats
# gives every rank the same bits
CUBLAS_WORKSPACE = ":4096:8"


class Mesh:
    """A grid of ranks with named axes: `shape` maps each name to its size,
    `coords` this rank's coordinate along each, `device` where its shards
    live. Build it with `make_mesh` or `data_parallel_mesh`."""

    def __init__(self, axis_sizes, axis_names, device, groups, coords, backend):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, axis_sizes))
        self.device = device
        self.groups = groups  # axis -> process group of this rank's line, or None
        self.coords = dict(zip(self.axis_names, coords))
        self.backend = backend  # None without a process group

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def _device(device) -> torch.device:
    """The rank's device: `device` as given, "cuda" meaning the current card.
    Raises without a card: a mesh on the card never falls back to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' for a mesh on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str] = ("dp", "mp"),
              device="cuda") -> Mesh:
    """A mesh over every rank of the default process group (or over this
    process alone, if there is none and the sizes multiply to 1). Every rank
    calls it with the same arguments: it creates one process group per line
    along each axis, collectively."""
    sizes = tuple(int(s) for s in axis_sizes)
    if len(sizes) != len(axis_names):
        raise ValueError(f"axis sizes {sizes} and names {tuple(axis_names)} differ in length")
    n = math.prod(sizes)
    device = _device(device)
    if not dist.is_initialized():
        if n != 1:
            raise RuntimeError(f"a mesh of {n} ranks needs torch.distributed initialized "
                               f"(initialize_distributed)")
        return Mesh(sizes, axis_names, device, {a: None for a in axis_names},
                    (0,) * len(sizes), None)
    rank, world = dist.get_rank(), dist.get_world_size()
    if n != world:
        raise ValueError(f"mesh {dict(zip(axis_names, sizes))} holds {n} ranks, the world "
                         f"{world}")
    grid = torch.arange(n).reshape(sizes)
    coords = tuple(int(c) for c in torch.nonzero(grid == rank)[0])
    groups = {}
    for a, name in enumerate(axis_names):
        lines = grid.movedim(a, -1).reshape(-1, sizes[a])
        for line in lines.tolist():  # every rank creates every group, in one order
            group = dist.new_group(line)
            if rank in line:
                groups[name] = group
    return Mesh(sizes, axis_names, device, groups, coords, dist.get_backend())


def data_parallel_mesh(n: int | None = None, device="cuda") -> Mesh:
    """A flat ("dp",) mesh over the world's n ranks (default: all)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh((n or world,), ("dp",), device)


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def axis_index(mesh: Mesh, axis: str) -> int:
    return mesh.coords[axis]


def shard_rows(mesh: Mesh | None, n: int, axis: str) -> slice:
    """This rank's rows of a leading axis of n rows split evenly over `axis`
    (all of them for `mesh=None`, one card). Raises where n does not divide
    by the axis size, as the JAX package's programs do."""
    if mesh is None:
        return slice(0, n)
    k = mesh.shape[axis]
    if n % k:
        raise ValueError(f"{n} rows do not divide by mesh axis {axis!r} of size {k}")
    c = mesh.coords[axis]
    return slice(c * (n // k), (c + 1) * (n // k))


def shard_batch(mesh: Mesh, x, axis_name: str = "dp"):
    """This rank's rows of dim 0 of the global `x`, contiguous, on its device."""
    x = torch.as_tensor(x)
    return x[shard_rows(mesh, x.shape[0], axis_name)].to(mesh.device).contiguous()


def replicate(mesh: Mesh, x):
    """The global `x` on this rank's device (every rank holds all of it)."""
    return torch.as_tensor(x).to(mesh.device)


# The collectives take `mesh=None` for one card, where they are identities.


def _reduce(mesh, x, axis, op):
    group = None if mesh is None else mesh.groups[axis]
    if group is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


def psum(mesh: Mesh | None, x, axis: str):
    """Sum of `x` over the ranks of this rank's line along `axis`."""
    return _reduce(mesh, x, axis, dist.ReduceOp.SUM)


def pmax(mesh: Mesh | None, x, axis: str):
    """Elementwise maximum of `x` over this rank's line along `axis`."""
    return _reduce(mesh, x, axis, dist.ReduceOp.MAX)


def all_gather(mesh: Mesh | None, x, axis: str):
    """Every rank's `x` along `axis`, stacked: (axis size, *x.shape), as
    `jax.lax.all_gather`."""
    group = None if mesh is None else mesh.groups[axis]
    if group is None:
        return x[None]
    out = torch.empty((mesh.shape[axis], *x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous()[None], group=group)
    return out


def gather_rows(mesh: Mesh | None, x, axis: str):
    """The global leading axis of a tensor sharded by rows over `axis`:
    `all_gather` with the rank axis folded into dim 0."""
    return all_gather(mesh, x, axis).flatten(0, 1)


def cumsum_rows(mesh: Mesh | None, x, axis: str):
    """The inclusive cumulative sum of a 1-D tensor sharded by rows over
    `axis`, over its global length, on every rank: each rank scans its own
    rows, and the gathered scans are offset by the totals of the shards
    before them. Every value is written by one rank, so the ranks hold the
    same bits: a card's `cumsum` may order its additions differently from
    one call to the next, so ranks scanning the whole would not agree."""
    group = None if mesh is None else mesh.groups[axis]
    if group is None:
        return torch.cumsum(x, dim=0)
    scans = all_gather(mesh, torch.cumsum(x, dim=0), axis)  # (k, rows)
    k = scans.shape[0]
    before = torch.tril(scans[:, -1].expand(k, k), diagonal=-1).sum(dim=1)
    return (scans + before[:, None]).flatten()


# ---------------------------------------------------------------------------
# Bring-up
# ---------------------------------------------------------------------------


def initialize_distributed(coordinator: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, *, device="cuda",
                           backend: str | None = None):
    """Join the default process group; returns (rank, world).

    With no argument it reads torchrun's RANK / WORLD_SIZE / MASTER_ADDR /
    MASTER_PORT, and without them it is one process (0, 1) with no group.
    `coordinator` is "host:port" (TCP) or an init URL ("tcp://...",
    "file://..."). The backend is NCCL on the card, one rank per card
    (LOCAL_RANK, else the rank modulo the card count), and gloo on the CPU;
    `backend="gloo"` with a CUDA device puts every rank on that card (ranks
    sharing one card). A no-op where the group exists already. A failed
    init raises."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if coordinator is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return 0, 1
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(
            os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        init_method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        world, rank = int(num_processes), int(process_id)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
        if backend == "nccl":
            if device.index is not None and world > 1:
                raise ValueError("NCCL takes one rank per card: pass device='cuda', or "
                                 "backend='gloo' for ranks that share a card")
            device = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
        else:
            device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            device_id=device if backend == "nccl" else None)
    return dist.get_rank(), dist.get_world_size()


def _rank_main(fn, rank, world, init_method, device, backend, out_dir, args):
    """One spawned rank: join the group, run fn(*args), save its result (or
    its traceback) under out_dir."""
    out = Path(out_dir)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    try:
        initialize_distributed(init_method, world, rank, device=device, backend=backend)
        result = fn(*args)
        part = out / f".rank{rank}.pt"
        torch.save(result, part)
        os.replace(part, out / f"rank{rank}.pt")
    except BaseException:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, device="cuda", backend: str | None = None,
          timeout: float = 900.0):
    """Run fn(*args) on `world` ranks of this host and return their results,
    by rank. Each rank is a process of the `spawn` start method (never a
    fork) that joins one group through a `file://` rendezvous in a fresh
    temporary directory, so concurrent programs cannot meet on a port.
    `fn` must be importable (a module-level function) and its result
    picklable; it comes back on the CPU.

    Raises if a rank fails: every rank's exit code is collected, a rank
    still running GRACE_S after another failed, or at `timeout`, is
    killed and counted as a failure."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="gorio_mesh_") as tmp:
        init = f"file://{Path(tmp) / 'rendezvous'}"
        procs = [ctx.Process(target=_rank_main, name=f"gorio-rank{r}",
                             args=(fn, r, world, init, device, backend, tmp, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline, killed = time.monotonic() + timeout, set()
        try:
            while any(p.is_alive() for p in procs):
                failed = any(p.exitcode not in (None, 0) for p in procs)
                if failed:
                    deadline = min(deadline, time.monotonic() + GRACE_S)
                if time.monotonic() > deadline:
                    for r, p in enumerate(procs):
                        if p.is_alive():
                            p.kill()
                            killed.add(r)
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)
        codes = [p.exitcode for p in procs]
        bad = [r for r in range(world) if codes[r] != 0 or r in killed]
        if bad:
            errs = [f"rank {r}: exit code {codes[r]}"
                    + (" (killed: still running)" if r in killed else "")
                    + (f"\n{(Path(tmp) / f'rank{r}.err').read_text()}"
                       if (Path(tmp) / f"rank{r}.err").exists() else "")
                    for r in range(world)]
            raise RuntimeError(f"{len(bad)} of {world} ranks failed:\n" + "\n".join(errs))
        return [torch.load(Path(tmp) / f"rank{r}.pt", map_location="cpu", weights_only=False)
                for r in range(world)]
