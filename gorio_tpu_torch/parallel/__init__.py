"""The device mesh and the sharded programs over `torch.distributed`.

Port of `gorio_tpu/parallel/`: `mesh` (named axes over ranks, their
collectives, bring-up and `spawn`), `sharded` (the sharded UGPM windows,
APDGICP / GICP align and pose-graph solve) and `dryrun` (all of them, and
the SMC step, on one mesh: `python -m gorio_tpu_torch.parallel.dryrun`).
"""

from .mesh import (Mesh, all_gather, axis_index, axis_size, data_parallel_mesh,  # noqa: F401
                   gather_rows, initialize_distributed, make_mesh, pmax, psum, replicate,
                   shard_batch, shard_rows, spawn)
