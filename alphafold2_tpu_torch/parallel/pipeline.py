"""GPipe pipeline parallelism over a ``pipe`` mesh axis (counterpart of
`alphafold2_tpu/parallel/pipeline.py`).

Layers are grouped into S stages; stage s's parameters are used only on
the ranks at ``pipe`` coordinate s, and activations hop stage to stage
with one point-to-point exchange per tick (`ring.shift`, not cyclic).

Schedule (classic GPipe, M microbatches, S stages, T = M + S - 1 ticks):

  tick t: the rank of stage s runs its stage on microbatch m = t - s
          when 0 <= m < M (a bubble slot computes nothing), then hands
          its output to stage s + 1; stage 0 takes microbatch t + 1 in;
          stage S - 1 banks microbatch t - (S - 1).

The results are broadcast from the last stage, so every rank holds them.
Every tick's hop is an autograd node on every rank (a bubble passes a
zero that stays in the graph), so the backward runs the same inverse
hops in the same order on every rank, and the pipeline trains under
`backward()` as the JAX one does under `jax.grad`.

Helpers:
- `stack_stage_params`: S per-stage trees -> one tree with a leading
  stage axis;
- `microbatch` / `unmicrobatch`: split a batch axis into (M, b/M, ...).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from alphafold2_tpu_torch.parallel.mesh import (DATA_AXIS, PIPE_AXIS, Mesh,
                                                _ensure_group)
from alphafold2_tpu_torch.parallel.ring import shift
from alphafold2_tpu_torch.parallel.sharding import (P, clean_spec,
                                                    is_dtensor, local_part,
                                                    placements, to_spec)


def make_pipeline_mesh(pipe: int, data: int = 1,
                       devices: Optional[Sequence[int]] = None) -> Mesh:
    """A (pipe, data) mesh over the given global ranks (all when None).
    On cards, lay ``pipe`` along NVLink neighbours: each tick's hop is
    one point-to-point exchange."""
    _ensure_group()
    devices = list(devices if devices is not None
                   else range(dist.get_world_size()))
    if pipe * data != len(devices):
        raise ValueError(f"mesh {pipe}x{data} != #devices {len(devices)}")
    return Mesh(np.asarray(devices).reshape(pipe, data),
                (PIPE_AXIS, DATA_AXIS))


def stack_stage_params(param_trees: Sequence[Any]):
    """[tree_0, ..., tree_{S-1}] (same structure) -> one tree whose
    leaves have a leading stage axis of size S."""
    flat = [pytree.tree_flatten(t) for t in param_trees]
    spec = flat[0][1]
    return pytree.tree_unflatten(
        [torch.stack(leaves) for leaves in zip(*(f[0] for f in flat))],
        spec)


def microbatch(x: torch.Tensor, n: int) -> torch.Tensor:
    b = x.shape[0]
    assert b % n == 0, f"batch {b} not divisible into {n} microbatches"
    return x.reshape(n, b // n, *x.shape[1:])


def unmicrobatch(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


class _FromLast(torch.autograd.Function):
    """Broadcast from the last stage of `axis`. Every rank then computes
    on the same values; the backward keeps the last stage's own gradient
    (the replicated-output convention) and gives the others zeros."""

    @staticmethod
    def forward(ctx, mesh, axis, *tensors):
        src = mesh.neighbour(axis, mesh.shape[axis] - 1 - mesh.coord(axis))
        ctx.is_src = src == mesh.rank
        outs = []
        for t in tensors:
            out = t.contiguous().clone()
            dist.broadcast(out, src, group=mesh.group(axis))
            outs.append(out)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        if ctx.is_src:
            return (None, None) + grads
        return (None, None) + tuple(
            None if g is None else torch.zeros_like(g) for g in grads)


def gpipe(stage_fn: Callable, params_local: Any, xs: Any, mesh: Mesh,
          axis_name: str = PIPE_AXIS, anchors: Sequence = ()):
    """The GPipe schedule on this rank's local tensors.

    stage_fn: (stage params, activation tree, microbatch index) ->
      activation tree of the same structure and shapes.
    xs: tree of local tensors with a leading microbatch axis M.
    anchors: the stage's tensors that a backward may ask gradients for
      (its parameters); the tensors of `params_local` and `xs` count too.
    Returns the output tree (M, ...), the same on every stage."""
    s_count = mesh.shape[axis_name]
    s = mesh.coord(axis_name)
    leaves, spec = pytree.tree_flatten(xs)
    m_count = leaves[0].shape[0]
    ticks = m_count + s_count - 1

    def take(mb):
        return [x[mb] for x in leaves]

    # a stage's first hops carry zeros; under gradients they are leaves
    # that need one, so every rank records every hop as an autograd node
    grad = torch.is_grad_enabled()
    zeros = [torch.zeros_like(x[0]).requires_grad_(grad) for x in leaves]
    state = take(0) if s == 0 else zeros
    # a bubble's zero depends on the stage's own leaves: a backward that
    # asks gradients only for those (`torch.autograd.grad(loss, params)`)
    # still runs every hop on this rank, as its neighbours' hops expect
    tie = sum((t.reshape(-1)[:1] * 0).sum()
              for t in list(anchors) + pytree.tree_leaves(params_local)
              + leaves
              if isinstance(t, torch.Tensor) and t.requires_grad and grad)
    banked = [None] * m_count
    y = state
    for t in range(ticks):
        mb = t - s
        if 0 <= mb < m_count:
            y = pytree.tree_flatten(stage_fn(
                params_local, pytree.tree_unflatten(state, spec), mb))[0]
            if s == s_count - 1:
                banked[mb] = y
        else:
            # a bubble slot: nothing to compute, a zero kept in the graph
            y = [v * 0 + tie for v in state]
        if t == ticks - 1:
            break
        shifted = shift(mesh, axis_name, *y, cyclic=False)
        if s == 0:
            nxt = take(t + 1) if t + 1 < m_count else zeros
            state = [a + 0 * b for a, b in zip(nxt, shifted)]
        else:
            state = list(shifted)
    if s == s_count - 1:
        outs = [torch.stack([banked[mb][k] for mb in range(m_count)])
                for k in range(len(leaves))]
    else:
        outs = [torch.zeros_like(x) + 0 * v[None]
                for x, v in zip(leaves, y)]
    if s_count > 1:
        outs = list(_FromLast.apply(mesh, axis_name, *outs))
    return pytree.tree_unflatten(outs, spec)


def stage_input(x, mesh: Mesh, axis_name: str = PIPE_AXIS):
    """A DTensor input's local block for the pipeline: only stage 0
    reads it, so its gradient is partial over `axis_name` (summed back
    onto every stage's copy)."""
    from torch.distributed.tensor import Partial
    grad_pl = [Partial() if axis == axis_name else pl
               for axis, pl in zip(mesh.mesh_axes, x.placements)]
    return x.to_local(grad_placements=grad_pl)


def sync_stage_grads(grads: list, params: list, mesh: Mesh,
                     axis_name: str = PIPE_AXIS) -> list:
    """Sum per-stage gradients over `axis_name` (one all-reduce): a
    stage's parameters get their gradient only on that stage's ranks.
    None on every rank stays None; a None beside another rank's
    gradient is a zero."""
    group = mesh.group(axis_name)
    if group is None or not grads:
        return grads
    have = torch.tensor([g is not None for g in grads], dtype=torch.int32,
                        device=params[0].device)
    dist.all_reduce(have, group=group)
    live = [at for at, h in enumerate(have.tolist()) if h]
    if not live:
        return grads
    flat = torch.cat([(torch.zeros_like(params[at]) if grads[at] is None
                       else grads[at]).reshape(-1) for at in live])
    dist.all_reduce(flat, group=group)
    out = [None] * len(grads)
    offset = 0
    for at in live:
        n = params[at].numel()
        out[at] = flat[offset:offset + n].view_as(params[at])
        offset += n
    return out


def pipeline_apply(stage_fn: Callable[[Any, Any], Any], stacked_params: Any,
                   xs: Any, mesh: Mesh, *, axis_name: str = PIPE_AXIS,
                   data_axis: Optional[str] = None) -> Any:
    """Run `stage_fn` as an S-stage pipeline over microbatched inputs.

    stage_fn: (stage_params, activation_tree) -> activation_tree, the
      same function for every stage (stage identity lives in the
      params); activations keep their shapes across stages.
    stacked_params: tree with a leading stage axis S == mesh.shape[axis]:
      plain tensors (rank s reads slice s, and its gradient lands in
      slice s there) or DTensors placed Shard(0) over `axis_name`.
    xs: activation tree with a leading microbatch axis M (global values,
      plain or DTensor).
    data_axis: optional mesh axis to shard each microbatch's batch dim
      (leaf axis 1) over, pp x dp; a leaf whose batch dim does not tile
      stays whole.
    Returns the output tree (M, ...) as DTensors placed like the inputs
    (the batch dim over `data_axis`, replicated elsewhere)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    s = mesh.coord(axis_name)

    def x_spec(leaf):
        return P(*clean_spec(mesh, P(None, data_axis), leaf.shape))

    def local_x(leaf):
        spec = x_spec(leaf)
        if is_dtensor(leaf) or leaf.requires_grad:
            return stage_input(to_spec(leaf, mesh, spec), mesh, axis_name)
        return local_part(leaf, mesh, spec)

    data_sharded = data_axis is not None and \
        mesh.shape.get(data_axis, 1) > 1

    def local_param(leaf):
        if not is_dtensor(leaf):
            return leaf[s]
        grad_pl = []
        for axis in mesh.mesh_axes:
            if axis == axis_name:
                grad_pl.append(Shard(0))
            elif axis == data_axis and data_sharded:
                grad_pl.append(Partial())
            else:
                grad_pl.append(Replicate())
        return leaf.to_local(grad_placements=grad_pl)[0]

    params_local = pytree.tree_map(local_param, stacked_params)
    xs_local = pytree.tree_map(local_x, xs)
    specs = pytree.tree_map(x_spec, xs)
    out = gpipe(lambda p, act, mb: stage_fn(p, act), params_local,
                xs_local, mesh, axis_name)
    return pytree.tree_map(
        lambda o, spec: DTensor.from_local(
            o, mesh.device_mesh, placements(mesh, spec), run_check=False),
        out, specs)
