"""Device meshes over `torch.distributed` (counterpart of
`alphafold2_tpu/parallel/mesh.py`).

A mesh is one process per device in a process group: NCCL for CUDA
tensors, gloo on the CPU. `Mesh` keeps the JAX vocabulary, a grid of
ranks with named axes and `shape` a name -> size mapping over every
axis, and adds what an SPMD program in PyTorch needs: this rank's
coordinate on each axis, the neighbour ranks along an axis, and a
`DeviceMesh` for DTensor placements.

The `DeviceMesh` spans only the axes of size > 1 (a one-device mesh
gets a one-dimensional `DeviceMesh` of size 1 over its first axis).
A DTensor on a four-dimensional `DeviceMesh` whose leading axes have
size 1 hung in a matmul with a replicated operand on gloo, while the
same product on the two-dimensional mesh of the sized axes finished;
an axis of size 1 places nothing, so leaving it out loses nothing.

Axis vocabulary (`AXIS_NAMES`, in this order):
- ``pipe``: pipeline stages (parallel/pipeline.py);
- ``data``: batch parallelism (and ZeRO placement of optimizer state);
- ``i``, ``j``: the two residue axes of the pair representation, the
  2-D sharding of the long-context mode.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
PAIR_I_AXIS = "i"
PAIR_J_AXIS = "j"
PIPE_AXIS = "pipe"

AXIS_NAMES = (PIPE_AXIS, DATA_AXIS, PAIR_I_AXIS, PAIR_J_AXIS)


def _ensure_group():
    """A one-process group (in-memory store) when none is initialised:
    a one-device mesh needs no launcher. NCCL where a card is visible,
    else gloo."""
    if dist.is_initialized():
        return
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


class Mesh:
    """A grid of global ranks with named axes. Every rank of the
    process group builds the same mesh (the `DeviceMesh` under it
    creates one subgroup per sized axis, a collective call); a rank
    outside the grid holds no coordinate and takes no part."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        _ensure_group()
        from torch.distributed.device_mesh import DeviceMesh

        self.devices = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d rank grid for axes "
                             f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))
        # the group's backend decides: NCCL ranks hold cards
        self.device_type = "cuda" if dist.get_backend() == "nccl" \
            else "cpu"
        self.rank = dist.get_rank()
        where = np.argwhere(self.devices == self.rank)
        self._coord = None if len(where) == 0 else \
            dict(zip(self.axis_names, (int(c) for c in where[0])))
        self.mesh_axes = tuple(a for a in self.axis_names
                               if self.shape[a] > 1) or self.axis_names[:1]
        keep = [self.axis_names.index(a) for a in self.mesh_axes]
        grid = self.devices.transpose(
            keep + [d for d in range(self.devices.ndim) if d not in keep])
        grid = grid.reshape([self.shape[a] for a in self.mesh_axes] + [-1])
        # the axes of size 1 sit last with one entry: drop them
        grid = grid[..., 0]
        self.device_mesh = DeviceMesh(self.device_type,
                                      torch.as_tensor(grid),
                                      mesh_dim_names=self.mesh_axes)

    @property
    def device(self) -> torch.device:
        """This rank's torch device."""
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def coord(self, axis: str) -> int:
        """This rank's index along `axis` (0 for an axis the mesh lacks)."""
        if axis not in self.shape:
            return 0
        if self._coord is None:
            raise ValueError(f"rank {self.rank} is not on this mesh")
        return self._coord[axis]

    def neighbour(self, axis: str, offset: int,
                  cyclic: bool = True) -> Optional[int]:
        """Global rank `offset` steps along `axis` from this rank; None
        off the end of a non-cyclic axis."""
        n = self.shape[axis]
        at = self.coord(axis) + offset
        if not cyclic and not 0 <= at < n:
            return None
        index = [self._coord[a] for a in self.axis_names]
        index[self.axis_names.index(axis)] = at % n
        return int(self.devices[tuple(index)])

    def group(self, axis: str):
        """The process group of `axis` (None for an axis of size 1)."""
        if self.shape.get(axis, 1) <= 1:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self):
        sizes = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"Mesh({sizes}; {self.device_type})"


def make_mesh(data: int = 1, i: int = 1, j: int = 1,
              devices: Optional[Sequence[int]] = None, *,
              pipe: int = 1) -> Mesh:
    """Build a (pipe, data, i, j) mesh over the given global ranks (all
    ranks of the process group when None). The sizes must multiply out
    to the number of ranks, as the JAX mesh's must to the device count.
    On cards, place the ``i`` x ``j`` face within one NVLink domain:
    the ring's K/V rotation and the pair's gathers ride it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    devices = list(devices if devices is not None else range(world))
    need = pipe * data * i * j
    if need != len(devices):
        raise ValueError(
            f"mesh {pipe}x{data}x{i}x{j}={need} != #devices "
            f"{len(devices)}")
    arr = np.asarray(devices).reshape(pipe, data, i, j)
    return Mesh(arr, AXIS_NAMES)


def single_device_mesh() -> Mesh:
    """The (1, 1, 1, 1) mesh of global rank 0, as the JAX one takes the
    first device (every rank builds it; a one-process group is made when
    none is initialised)."""
    _ensure_group()
    return make_mesh(1, 1, 1, devices=[0])
