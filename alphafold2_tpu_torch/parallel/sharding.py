"""Sharding rules and in-model constraints over DTensor (counterpart of
`alphafold2_tpu/parallel/sharding.py`).

The model calls `shard_pair` / `shard_msa` / `shard_seq` where the JAX
model does. Under an active mesh (`use_mesh`) they turn the activation
into a DTensor placed by the spec (`DTensor.redistribute` is
`with_sharding_constraint`); outside a mesh they return their input.
Between two constraints the DTensor's own sharding rules carry the
placements through LayerNorm, Linear, einsum and the elementwise ops,
as GSPMD does between annotations. A spec is a `PartitionSpec` of mesh
axis names; a rule drops an axis that the mesh lacks, that is manual in
the enclosing region (`use_mesh(manual_axes=...)`), or that does not
divide the dimension.

Conventions of the SPMD program:
- a plain tensor under a mesh is the global value, whole and equal on
  every rank (inputs, masks, the batch). `use_mesh` enters DTensor's
  implicit replication, so such a tensor meets a DTensor as a
  replicated operand;
- parameters stay plain `nn.Parameter`s. A Linear or LayerNorm that
  meets a DTensor runs on the rank's block with its parameters as
  replicated operands (`feature_call`); the backward of that wrap sums
  the partial gradients over the ranks that hold different rows (the
  data-parallel and pair-parallel reductions), so every rank ends the
  backward with the full gradient;
- a hand-written kernel never receives a DTensor: `local_call` hands it
  the rank's local block, redistributed so that the attended axis is
  whole (`AxialAttention`'s meshed path);
- the ZeRO and tensor-parallel rules place the train state's Adam
  moments (and any tree of tensors they are given); the compute
  parameters stay whole on each rank (ZeRO stage 1). The JAX package
  places the parameters too.

Tensor contracts (axes -> PartitionSpec):
- pair  (b, i, j, d)      -> P(data, i, j, None)
- msa   (b, m, n, d)      -> P(data, None, i, None)
- seq   (b, n, d)         -> P(data, None, None)
"""

from __future__ import annotations

import contextlib
import threading
import warnings
from dataclasses import dataclass
from typing import Any, Optional

import torch

from alphafold2_tpu_torch.parallel.mesh import (DATA_AXIS, PAIR_I_AXIS,
                                                PAIR_J_AXIS, Mesh)

_state = threading.local()


class PartitionSpec(tuple):
    """One mesh axis name (or None) per tensor dimension."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the counterpart of jax.sharding.NamedSharding)."""

    mesh: Mesh
    spec: PartitionSpec


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def is_dtensor(x) -> bool:
    return isinstance(x, _dtensor())


def active_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


def manual_axes() -> frozenset:
    return getattr(_state, "manual", frozenset())


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh], manual_axes: frozenset = frozenset()):
    """Activate a mesh for the model's sharding constraints (thread
    local), with DTensor's implicit replication of plain tensors.
    `manual_axes` names axes the enclosing code drives by hand, as a JAX
    `shard_map` body does: constraints inside leave them out."""
    prev = getattr(_state, "mesh", None)
    prev_manual = getattr(_state, "manual", frozenset())
    _state.mesh = mesh
    _state.manual = frozenset(manual_axes)
    try:
        if mesh is None:
            yield mesh
        else:
            with _implicit_replication():
                yield mesh
    finally:
        _state.mesh = prev
        _state.manual = prev_manual


@contextlib.contextmanager
def _implicit_replication():
    """DTensor's `implicit_replication`, re-entrant: it restores the
    setting it found (the library's context manager clears it on exit,
    which would end an enclosing one)."""
    dispatcher = _dtensor()._op_dispatcher
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def keep_mesh(fn):
    """`fn` bound to the mesh active now: a recompute that runs in the
    backward (activation checkpointing, the reversible trunk), possibly
    on the autograd engine's device thread, sees the mesh of its
    forward."""
    mesh, manual = active_mesh(), manual_axes()
    if mesh is None:
        return fn

    def run(*args, **kwargs):
        with use_mesh(mesh, manual):
            return fn(*args, **kwargs)

    return run


def clean_spec(mesh: Mesh, spec, shape, manual=frozenset()) -> list:
    """The spec padded to the rank of `shape`, with every axis the mesh
    lacks, that is manual, or that does not divide its dim, dropped."""
    cleaned = []
    for dim, axis in zip(shape, tuple(spec)):
        if axis is None or axis not in mesh.shape or axis in manual \
                or dim % mesh.shape[axis] != 0:
            cleaned.append(None)
        else:
            cleaned.append(axis)
    return cleaned + [None] * (len(shape) - len(cleaned))


def placements(mesh: Mesh, spec) -> list:
    """DTensor placements (one per `mesh.device_mesh` dim) of a spec."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_axes)
    for dim, axis in enumerate(spec):
        if axis is not None and axis in mesh.mesh_axes:
            out[mesh.mesh_axes.index(axis)] = Shard(dim)
    return out


def replicate_on(x: torch.Tensor, device_mesh):
    """A plain tensor (the global value, equal on every rank) as a
    DTensor replicated over `device_mesh`; differentiable (its backward
    sums partial gradients into the full one)."""
    from torch.distributed.tensor import Replicate
    return _dtensor().from_local(
        x, device_mesh, [Replicate()] * device_mesh.ndim, run_check=False)


def to_spec(x, mesh: Mesh, spec):
    """`x` (plain global value or DTensor) as a DTensor placed by `spec`."""
    pl = placements(mesh, spec)
    if not is_dtensor(x):
        x = replicate_on(x, mesh.device_mesh)
    if tuple(x.placements) == tuple(pl):
        return x
    return x.redistribute(mesh.device_mesh, pl)


def _constraint(x, spec):
    mesh = active_mesh()
    if mesh is None or x is None:
        return x
    cleaned = clean_spec(mesh, spec, x.shape, manual_axes())
    if all(a is None for a in cleaned):
        return x
    return to_spec(x, mesh, cleaned)


def pair_spec() -> PartitionSpec:
    return P(DATA_AXIS, PAIR_I_AXIS, PAIR_J_AXIS, None)


def msa_spec() -> PartitionSpec:
    return P(DATA_AXIS, None, PAIR_I_AXIS, None)


def seq_spec() -> PartitionSpec:
    return P(DATA_AXIS, None, None)


def shard_pair(x):
    """(b, i, j, d) pair activations: 2-D shard the residue axes."""
    return _constraint(x, pair_spec())


def shard_msa(x):
    """(b, m, n, d) MSA activations: shard the sequence axis."""
    return _constraint(x, msa_spec())


def shard_seq(x):
    """(b, n, d) single-track activations: data-parallel only."""
    return _constraint(x, seq_spec())


def spec_of(x, mesh: Mesh) -> list:
    """A DTensor's placement as one mesh axis (or None) per tensor dim;
    a dim sharded over two axes reads as None."""
    axes = [None] * x.ndim
    twice = set()
    for axis, pl in zip(mesh.mesh_axes, x.placements):
        if pl.is_shard():
            if axes[pl.dim] is not None:
                twice.add(pl.dim)
            axes[pl.dim] = axis
    return [None if d in twice else a for d, a in enumerate(axes)]


def unshard(x):
    """A DTensor's full value as a plain tensor on every rank
    (differentiable); anything else as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def like(t, ref):
    """`t` as a replicated DTensor on `ref`'s mesh when `ref` is a
    DTensor and `t` is plain, else `t`: the differentiable way for a
    plain activation to meet a DTensor."""
    if t is None or not is_dtensor(ref) or is_dtensor(t):
        return t
    return replicate_on(t, ref.device_mesh)


def local_part(t: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """This rank's block of a plain global tensor under a (cleaned)
    spec, by slicing; no communication."""
    for dim, axis in enumerate(spec):
        if axis is not None and mesh.shape.get(axis, 1) > 1:
            t = t.chunk(mesh.shape[axis], dim=dim)[mesh.coord(axis)]
    return t


def local_call(fn, mesh: Mesh, args, specs, out_spec):
    """`shard_map` for one region: each DTensor or plain argument is
    placed by its spec and handed to `fn` as the rank's local block;
    the local result comes back as a DTensor placed by `out_spec`. A
    None spec passes the argument through untouched."""
    from torch.distributed.tensor import Partial
    out_axes = {a for a in out_spec if a is not None}
    local = []
    for a, s in zip(args, specs):
        if a is None or s is None:
            local.append(a)
        elif is_dtensor(a) or a.requires_grad:
            placed = to_spec(a, mesh, s)
            # an argument whole along an axis that shards the result
            # gets a partial gradient from each rank of that axis
            in_axes = {x for x in s if x is not None}
            grad_pl = [Partial() if axis in out_axes - in_axes else pl
                       for axis, pl in zip(mesh.mesh_axes,
                                           placed.placements)]
            local.append(placed.to_local(grad_placements=grad_pl))
        else:
            local.append(local_part(a, mesh, s))
    out = fn(*local)
    return _dtensor().from_local(out, mesh.device_mesh,
                                 placements(mesh, out_spec),
                                 run_check=False)


def feature_call(fn, x, *params):
    """`fn(x, *params)` for an op over the last (feature) dim of a
    DTensor `x` (Linear, LayerNorm): it runs on the rank's local block,
    the feature dim whole, with the plain parameters as replicated
    operands whose gradients are summed over the ranks holding other
    rows. DTensor's own Linear flattens the leading dims, which its rules
    refuse for a map sharded on more than the first of them (torch
    2.11)."""
    mesh = active_mesh()
    spec = spec_of(x, mesh)
    spec[-1] = None
    return local_call(fn, mesh, (x,) + params,
                      (spec,) + (P(),) * len(params), spec)


def replicated_call(fn, *args):
    """Run `fn` on the full values of its DTensor arguments (gathered on
    every rank) and return its tensor outputs as replicated DTensors on
    the same mesh: the path of a module without a sharded rule (the
    efficient-attention menu, the conv blocks) under a mesh."""
    ref = next((a for a in args if is_dtensor(a)), None)
    out = fn(*(unshard(a) for a in args))
    if ref is None:
        return out
    if isinstance(out, tuple):
        return tuple(like(o, ref) for o in out)
    return like(out, ref)


def fold_input_specs() -> dict:
    """PartitionSpecs for a serving fold's inputs: seq/mask replicated,
    the MSA tokens and mask sharded on their sequence axis over ``i``.

    - seq      (b, n)    -> P()
    - mask     (b, n)    -> P()
    - msa      (b, m, n) -> P(None, None, i)
    - msa_mask (b, m, n) -> P(None, None, i)
    """
    return {"seq": P(), "mask": P(),
            "msa": P(None, None, PAIR_I_AXIS),
            "msa_mask": P(None, None, PAIR_I_AXIS)}


def fold_input_shardings(mesh: Mesh, batch: dict) -> dict:
    """NamedShardings for one assembled batch on `mesh`; an axis that
    cannot divide the dim (or that the mesh lacks) degrades to
    replication for that tensor."""
    out = {}
    for name, spec in fold_input_specs().items():
        x = batch.get(name)
        if x is None:
            out[name] = None
            continue
        # as long as the spec itself, as the JAX rule gives it
        cleaned = clean_spec(mesh, spec, x.shape)[:len(spec)]
        out[name] = NamedSharding(mesh, P(*cleaned))
    return out


# ---------------------------------------------------------------------------
# ZeRO and tensor-parallel placement
# ---------------------------------------------------------------------------


def _named_leaves(tree, prefix=""):
    """(name, leaf) pairs of a dict / list / tuple tree, names joined
    with '.'; an nn.Module gives its named parameters."""
    if isinstance(tree, torch.nn.Module):
        yield from tree.named_parameters()
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)) and \
            not isinstance(tree, PartitionSpec):
        for k, v in enumerate(tree):
            yield from _named_leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _rebuild(tree, leaves, prefix=""):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}{k}.")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and \
            not isinstance(tree, PartitionSpec):
        return type(tree)(_rebuild(v, leaves, f"{prefix}{k}.")
                          for k, v in enumerate(tree))
    return leaves[prefix[:-1]]


def _zero_spec(shape, n: int, axis: str) -> PartitionSpec:
    """The largest dim that `n` divides, ties to the last: for a Linear
    weight (out, in) this is the dim JAX's rule picks on the flax kernel
    (in, out), whose ties go to the first."""
    best = None
    for d, s in enumerate(shape):
        if s % n == 0 and s >= n and (best is None or s >= shape[best]):
            best = d
    if best is None or n <= 1:
        return P()
    spec = [None] * len(shape)
    spec[best] = axis
    return P(*spec)


def zero_param_specs(params, mesh: Mesh, axis: str = DATA_AXIS):
    """PartitionSpec tree for ZeRO-style sharding: each leaf's largest
    mesh-divisible dimension is sharded over `axis`; leaves with no
    divisible dimension (scalars, odd shapes) stay replicated."""
    n = mesh.shape.get(axis, 1)
    specs = {name: _zero_spec(tuple(getattr(leaf, "shape", ())), n, axis)
             for name, leaf in _named_leaves(params)}
    return specs if isinstance(params, torch.nn.Module) else \
        _rebuild(params, specs)


# the JAX suffixes (`to_q/kernel`, `ff/Dense_0/kernel`, ...) in the port's
# names; a Linear weight is (out, in), so a column-parallel weight shards
# dim 0 and a row-parallel one dim 1
_TP_COL = ("to_q.weight", "to_kv.weight", "gating.weight",
           "left_proj.weight", "right_proj.weight", "ff.proj_in.weight")
_TP_ROW = ("to_out.weight", "outer_mean.proj_out.weight",
           "ff.proj_out.weight", "_conv.proj_out.weight")
_TP_COL_BIAS = ("gating.bias", "left_proj.bias", "right_proj.bias",
                "ff.proj_in.bias")


def tp_param_specs(params, mesh: Mesh, axis: str = PAIR_J_AXIS):
    """Megatron-style tensor-parallel PartitionSpecs keyed by parameter
    name (the JAX rule's suffix table in the port's names).
    Column-parallel (the output features): attention to_q/to_kv/gating,
    the first FF projection, the triangle and outer-mean left/right
    projections. Row-parallel (the input features): to_out, the second
    FF projection, the outer-mean and conv-block proj_out. Everything
    else replicates. Warns when nothing matches."""
    n = mesh.shape.get(axis, 1)

    def spec_for(name, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if n > 1 and shape:
            if name.endswith(_TP_COL) and len(shape) == 2 and \
                    shape[0] % n == 0:
                return P(axis, None)
            if name.endswith(_TP_ROW) and len(shape) == 2 and \
                    shape[1] % n == 0:
                return P(None, axis)
            if name.endswith(_TP_COL_BIAS) and shape[-1] % n == 0:
                return P(*([None] * (len(shape) - 1) + [axis]))
        return P()

    specs = {name: spec_for(name, leaf)
             for name, leaf in _named_leaves(params)}
    if n > 1 and all(s == P() for s in specs.values()):
        warnings.warn(
            "tp_param_specs matched no parameters — the suffix table "
            "no longer lines up with the model's module names, so "
            "tensor parallelism silently degrades to replication",
            stacklevel=2)
    return specs if isinstance(params, torch.nn.Module) else \
        _rebuild(params, specs)


def place(x: torch.Tensor, mesh: Mesh, spec):
    """A plain tensor (equal on every rank) as a DTensor placed by
    `spec`: each rank keeps its block, by slicing."""
    from torch.distributed.tensor import DTensor
    cleaned = clean_spec(mesh, spec, x.shape)
    return DTensor.from_local(local_part(x.detach(), mesh, cleaned).clone(),
                              mesh.device_mesh, placements(mesh, cleaned),
                              run_check=False)


def _place_tree(tree, mesh: Mesh, specs_fn):
    from alphafold2_tpu_torch.train.state import TrainState
    if isinstance(tree, TrainState):
        names = [n for n, _ in tree.model.named_parameters()]
        params = dict(zip(names, tree.params))
        specs = specs_fn(params)
        tree.optimizer.place(mesh, [specs[n] for n in names])
        return tree
    specs = dict(_named_leaves(specs_fn(tree)))
    leaves = {name: place(leaf, mesh, specs[name])
              if isinstance(leaf, torch.Tensor) else leaf
              for name, leaf in _named_leaves(tree)}
    return _rebuild(tree, leaves)


def shard_pytree_zero(tree, mesh: Mesh, axis: str = DATA_AXIS):
    """Place a tree of tensors with ZeRO sharding; a TrainState's Adam
    moments (and accumulator) take their parameter's placement, so each
    rank keeps and updates 1/n of the optimizer state."""
    return _place_tree(tree, mesh,
                       lambda t: zero_param_specs(t, mesh, axis))


def shard_pytree_tp(params, mesh: Mesh, axis: str = PAIR_J_AXIS):
    """Place a tree of tensors (or a TrainState's optimizer state) with
    `tp_param_specs` placements."""
    return _place_tree(params, mesh,
                       lambda t: tp_param_specs(t, mesh, axis))


def tp_zero_specs(tree, mesh: Mesh, tp_axis: str = PAIR_J_AXIS,
                  zero_axis: str = DATA_AXIS):
    """Tensor-parallel specs where they apply, ZeRO over `zero_axis` for
    every other leaf."""
    tp = dict(_named_leaves(tp_param_specs(tree, mesh, tp_axis)))
    zero = dict(_named_leaves(zero_param_specs(tree, mesh, zero_axis)))
    merged = {n: tp[n] if tp[n] != P() else zero[n] for n in tp}
    return merged if isinstance(tree, torch.nn.Module) else \
        _rebuild(tree, merged)


def shard_pytree_tp_zero(tree, mesh: Mesh, tp_axis: str = PAIR_J_AXIS,
                         zero_axis: str = DATA_AXIS):
    """Combined placement: tensor-parallel specs where they apply, ZeRO
    over the data axis for every other leaf. On a TrainState it places
    the optimizer state."""
    return _place_tree(tree, mesh,
                       lambda t: tp_zero_specs(t, mesh, tp_axis, zero_axis))


def _local_bytes(t: Any) -> int:
    if is_dtensor(t):
        t = t.to_local()
    if not isinstance(t, torch.Tensor):
        return 0
    return t.numel() * t.element_size()


def pytree_bytes_per_device(tree) -> int:
    """Bytes this rank holds of `tree`'s tensors: a placed leaf counts
    its local block, a plain one counts fully. A TrainState counts its
    parameters and its optimizer state."""
    from alphafold2_tpu_torch.train.state import TrainState
    if isinstance(tree, TrainState):
        return sum(_local_bytes(t) for t in
                   list(tree.params) + tree.optimizer.tensors())
    return sum(_local_bytes(leaf) for _, leaf in _named_leaves(tree))
