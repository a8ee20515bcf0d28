"""Multi-process initialisation and data placement (counterpart of
`alphafold2_tpu/parallel/multihost.py`).

- `initialize()`: `torch.distributed.init_process_group` for a
  multi-process run (a no-op returning False for one process, as the
  JAX wrapper is), from explicit arguments or a launcher's environment
  (`torchrun` sets RANK, WORLD_SIZE and MASTER_ADDR/MASTER_PORT);
- `global_mesh()`: the (pipe, data, i, j) mesh over every rank;
- `host_local_batch_to_global()`: each rank passes its own rows of the
  ``data`` axis and gets back the global batch, whole on every rank
  (the model's `shard_*` placements then shard it over ``data``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from alphafold2_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, make_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Initialise the process group; True when the run is distributed.
    `coordinator_address` is an init method (``tcp://host:port`` or
    ``file:///path``); None reads the launcher's environment. Safe to
    call unconditionally: one process (and an initialised group) skip."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=coordinator_address or "env://",
        world_size=num_processes, rank=process_id)
    return True


def global_mesh(data: int = 1, i: int = 1, j: int = 1,
                pipe: int = 1) -> Mesh:
    """Mesh over every rank of the process group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = pipe * data * i * j
    if need != world:
        raise ValueError(f"mesh {pipe}x{data}x{i}x{j}={need} != global "
                         f"device count {world}")
    return make_mesh(data, i, j, pipe=pipe)


def host_local_batch_to_global(batch, mesh: Mesh):
    """Per-rank batch rows -> the global batch on every rank, rows in
    ``data`` coordinate order. Each rank passes only its portion (the
    same shapes on every rank); leaves without a batch axis pass
    through."""
    group = mesh.group(DATA_AXIS)
    n = mesh.shape.get(DATA_AXIS, 1)

    def place(x):
        x = torch.as_tensor(x).to(mesh.device)
        if n <= 1 or x.ndim == 0:
            return x
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    return {k: place(v) for k, v in batch.items()}


def parse_mesh(text: str) -> tuple:
    """A ``--mesh`` flag, "data,i,j" or "pipe,data,i,j", as (pipe, data,
    i, j); three values leave ``pipe`` at 1."""
    vals = [int(v) for v in text.split(",")]
    if len(vals) == 3:
        vals = [1] + vals
    if len(vals) != 4:
        raise ValueError(f"--mesh takes data,i,j or pipe,data,i,j; got "
                         f"{text!r}")
    return tuple(vals)
