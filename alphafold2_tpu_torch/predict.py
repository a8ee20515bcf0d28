"""Inference API: fold sequences with recycling and confidence
(counterpart of `alphafold2_tpu/predict.py`).

`fold` runs the first pass and `num_recycles` recycling passes;
`fold_init` / `fold_step` split the same loop into steps a scheduler can
own, and `fold_init_rows` re-initialises chosen batch rows. Every entry
point runs one function per pass (`_one_pass`), under
`torch.inference_mode()` (`torch.no_grad()` under an active mesh), on the
CUDA card unless `device` names another
(the model must already live there).

`**extra` are the model's other inputs (templates, template angles, the
extra MSA, pretrained embeddings, `seq_index`), passed to every pass as
the JAX package's entry points pass them; `_prepare` moves them onto
the model's device, float features in fp32, masks as bool, token and
index arrays as long.

`kernel` (an `ops.block_sparse.KernelSpec`) runs every pass under
`kernel_context`: the residue-axis self-attention of the bucket's length
goes through the block-sparse kernel. `plan` is the spec's plan on the
device; the serving executor passes the one it holds per key, and an
entry point given none uploads one per call.

`snapshot_step_state` / `restore_step_state` take a host copy of a
step-loop carry and put it back byte-equal, on the device each leaf came
from (or through the placement of a leaf held elsewhere).
`fold_and_write` folds a batch and writes one PDB per element, memoised
in a `cache.FoldCache` whose keys equal the JAX package's, with one
request-scoped `obs.Tracer` trace per call.
"""

from __future__ import annotations

import contextlib
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.model.alphafold2 import Recyclables
from alphafold2_tpu_torch.ops.block_sparse import (BlockPlan, KernelSpec,
                                                   kernel_context)


class FoldResult(NamedTuple):
    coords: torch.Tensor          # (b, n, 3)
    confidence: torch.Tensor      # (b, n) in [0, 1]
    distogram: torch.Tensor       # (b, n, n, buckets)
    recyclables: Recyclables


class FoldStepState(NamedTuple):
    """One recycle iteration's output, the carry of a step loop. After
    the last step the state is the fold result; `recyclables` is the only
    part the next step reads."""

    coords: torch.Tensor
    confidence: torch.Tensor
    distogram: torch.Tensor
    recyclables: Recyclables


# the one source of the recycling default
DEFAULT_NUM_RECYCLES = 3


# the model inputs an entry point takes through **extra, with the type
# each is moved in
_EXTRA_DTYPES = {
    "templates_feats": torch.float32, "templates_angles": torch.float32,
    "seq_embed": torch.float32, "msa_embed": torch.float32,
    "embedds": torch.float32, "templates_mask": torch.bool,
    "extra_msa_mask": torch.bool, "extra_msa": torch.long,
    "seq_index": torch.long}



def _grad_off():
    """`torch.inference_mode()`, or `torch.no_grad()` under an active
    mesh: DTensor's autograd functions (the wrap of a parameter as a
    replicated DTensor) detach their outputs in place under inference
    mode, which DTensor has no rule for."""
    from alphafold2_tpu_torch.parallel.sharding import active_mesh
    return torch.no_grad() if active_mesh() is not None \
        else torch.inference_mode()

def _prepare(model, device, seq, msa, mask, msa_mask, kernel, plan, extra):
    """Check the call, move the inputs onto the model's device and make
    the kernel's device plan when none was given."""
    unknown = sorted(set(extra) - set(_EXTRA_DTYPES))
    if unknown:
        raise TypeError(f"fold got unexpected model inputs {unknown}; it "
                        f"takes {sorted(_EXTRA_DTYPES)}")
    if not model.predict_coords:
        raise ValueError("folding needs a model built with "
                         "predict_coords=True")
    if kernel is not None and not isinstance(kernel, KernelSpec):
        raise TypeError(f"kernel must be a KernelSpec, got {type(kernel)}")
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"the model lives on {model.device}, the fold was "
                         f"asked to run on {device}")
    if kernel is not None and kernel.backend == "auto" and plan is None:
        plan = kernel.device_plan(device)

    def put(t, dtype):
        return None if t is None else torch.as_tensor(
            t, device=device).to(dtype)

    extra = {name: put(value, _EXTRA_DTYPES[name])
             for name, value in extra.items() if value is not None}
    return (put(seq, torch.long), put(msa, torch.long),
            put(mask, torch.bool), put(msa_mask, torch.bool), plan, extra)


def _one_pass(model, seq, msa, mask, msa_mask, recyclables, extra,
              kernel=None, plan: Optional[BlockPlan] = None):
    """One trunk + structure pass: what fold's loop and the step-mode
    entry points all run, under the kernel's context when one is given."""
    ctx = kernel_context(kernel, plan) if kernel is not None \
        else contextlib.nullcontext()
    with ctx:
        return model(seq, msa=msa, mask=mask, msa_mask=msa_mask,
                     recyclables=recyclables, return_aux_logits=True,
                     return_recyclables=True, **extra)


def _step_state(coords, ret) -> FoldStepState:
    conf = torch.sigmoid(ret.confidence[..., 0].float())
    return FoldStepState(coords, conf, ret.distance, ret.recyclables)


def fold(model, seq, msa=None, mask=None, msa_mask=None,
         num_recycles: int = DEFAULT_NUM_RECYCLES, device=None,
         kernel: Optional[KernelSpec] = None,
         plan: Optional[BlockPlan] = None, **extra) -> FoldResult:
    """Run the model with `num_recycles` recycling iterations."""
    seq, msa, mask, msa_mask, plan, extra = _prepare(
        model, device, seq, msa, mask, msa_mask, kernel, plan, extra)
    with _grad_off():
        coords, ret = _one_pass(model, seq, msa, mask, msa_mask, None,
                                extra, kernel, plan)
        for _ in range(num_recycles):
            coords, ret = _one_pass(model, seq, msa, mask, msa_mask,
                                    ret.recyclables, extra, kernel, plan)
        return FoldResult(*_step_state(coords, ret))


def fold_init(model, seq, msa=None, mask=None, msa_mask=None, device=None,
              kernel: Optional[KernelSpec] = None,
              plan: Optional[BlockPlan] = None, **extra) -> FoldStepState:
    """The first pass of step-mode folding: fold(..., num_recycles=0) as
    a FoldStepState whose `recyclables` seed `fold_step`. fold_init then
    R x fold_step computes what fold(..., num_recycles=R) does."""
    seq, msa, mask, msa_mask, plan, extra = _prepare(
        model, device, seq, msa, mask, msa_mask, kernel, plan, extra)
    with _grad_off():
        return _step_state(*_one_pass(model, seq, msa, mask, msa_mask,
                                      None, extra, kernel, plan))


def fold_step(model, seq, recyclables: Recyclables, msa=None, mask=None,
              msa_mask=None, device=None,
              kernel: Optional[KernelSpec] = None,
              plan: Optional[BlockPlan] = None, **extra) -> FoldStepState:
    """One recycle iteration, fed the previous state's `recyclables`."""
    seq, msa, mask, msa_mask, plan, extra = _prepare(
        model, device, seq, msa, mask, msa_mask, kernel, plan, extra)
    with _grad_off():
        return _step_state(*_one_pass(model, seq, msa, mask, msa_mask,
                                      recyclables, extra, kernel, plan))


def _select_rows(row_mask, new, old):
    if isinstance(new, tuple):
        return type(new)(*(_select_rows(row_mask, a, b)
                           for a, b in zip(new, old)))
    m = row_mask.reshape(row_mask.shape + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def fold_init_rows(model, seq, row_mask, state: FoldStepState, msa=None,
                   mask=None, msa_mask=None, device=None,
                   kernel: Optional[KernelSpec] = None,
                   plan: Optional[BlockPlan] = None,
                   **extra) -> FoldStepState:
    """Row-masked init: rows where `row_mask` (b,) is True restart from
    the current batch tensors (fold_init's pass); the other rows keep the
    carried `state` unchanged."""
    fresh = fold_init(model, seq, msa=msa, mask=mask, msa_mask=msa_mask,
                      device=device, kernel=kernel, plan=plan, **extra)
    row_mask = torch.as_tensor(row_mask, device=fresh.coords.device).bool()
    with _grad_off():
        return _select_rows(row_mask, fresh, state)


# -- step-state snapshots -----------------------------------------------------

_LEAF = object()


def tree_flatten(tree):
    """(leaves, treedef) in the JAX package's `tree_flatten` order:
    NamedTuple fields and tuple/list items in order, dict values by
    sorted key, None an empty subtree (dropped); anything else is a
    leaf. So a `FoldStepState` flattens as coords, confidence,
    distogram, then the Recyclables' coords, single_msa_repr_row,
    pairwise_repr, the order a checkpoint written by either package
    keeps."""
    leaves = []

    def walk(node):
        if node is None:
            return None
        if isinstance(node, (tuple, list)):
            return (type(node), [walk(x) for x in node])
        if isinstance(node, dict):
            keys = sorted(node)
            return (dict, keys, [walk(node[k]) for k in keys])
        leaves.append(node)
        return _LEAF

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    """Inverse of `tree_flatten`."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if node is _LEAF:
            return next(it)
        if node[0] is dict:
            return {k: build(c) for k, c in zip(node[1], node[2])}
        kind, children = node
        items = [build(c) for c in children]
        return kind(*items) if hasattr(kind, "_fields") else kind(items)

    return build(treedef)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor's bytes as a numpy array of its dtype (bf16
    through ml_dtypes' bfloat16, the dtype the JAX package's host copies
    have). Always a copy: a CPU tensor's `.numpy()` would share memory
    that the step loop may later write in place."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    arr = np.ascontiguousarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr.copy()).to(device)


def _live_device(device) -> torch.device:
    """`device` if this process still has it, else the default device
    (the card, or a raise without one: never the CPU in silence)."""
    if device is not None:
        device = torch.device(device)
        if device.type == "cpu":
            return device
        if device.type == "cuda" and torch.cuda.is_available() and (
                device.index is None
                or device.index < torch.cuda.device_count()):
            return resolve_device(device)
    return resolve_device(None)


def snapshot_step_state(state):
    """Host copy of a step-loop carry: (treedef, entries), one entry per
    leaf in `tree_flatten` order — ("dev", numpy copy, placement) for a
    tensor, ("ref", leaf, None) for anything else (kept by reference).
    A tensor's placement is its torch.device. A leaf held by other
    processes (one with `fetch()` and `place`, as a slice group's
    `serve.slices.RemoteTensor`) is fetched whole, and its placement is
    its `place`, which puts the copy back. Nothing in it refers to the
    model or an executor."""
    leaves, treedef = tree_flatten(state)
    snap = []
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            snap.append(("dev", _to_host(leaf), leaf.device))
        elif hasattr(leaf, "fetch") and hasattr(leaf, "place"):
            snap.append(("dev", _to_host(leaf.fetch()), leaf.place))
        else:
            snap.append(("ref", leaf, None))
    return treedef, snap


def restore_step_state(snapshot):
    """Put a `snapshot_step_state` copy back: each tensor leaf on the
    device it was taken from (where this process no longer has that
    device, the default device: the card, or a raise), a leaf whose
    placement has `put(array)` through it, reference leaves as they
    are. The restored carry is byte-equal to the snapshotted one."""
    treedef, snap = snapshot
    leaves = [val if kind != "dev" else place.put(val)
              if hasattr(place, "put") else
              _to_device(val, _live_device(place))
              for kind, val, place in snap]
    return tree_unflatten(treedef, leaves)


# -- fold to PDB -------------------------------------------------------------

# keyword arguments that never enter a cache key: those JAX leaves out,
# and the port's kernel device plan (`device` is a named parameter)
_NOT_KEYED = ("msa", "mask", "msa_mask", "num_recycles", "plan")


def fold_and_write(model, seq, out_path: str, cache=None,
                   model_tag: str = "", tracer=None, device=None,
                   **kwargs) -> list:
    """fold() + PDB output of the CA trace (`data.pdb_io.coords2pdb`).

    Folds the whole (b, n) batch in one forward pass and writes one PDB
    per batch element: `out_path` for a batch of 1, `<stem>_k<ext>` for
    element k otherwise. Returns the written paths. `mask` trims each
    element's padding from the written trace. `kwargs` are fold's
    (`msa`, `mask`, `msa_mask`, `num_recycles`, `kernel`, `plan`, the
    model's extra inputs); `device` is where the fold runs (the card
    unless the caller names another).

    cache: optional `cache.FoldCache`. Keys cover each element's
    unpadded (seq, msa, msa_mask, num_recycles), `model_tag` and any
    scalar extra model input, exactly as the JAX package's
    `fold_and_write` keys them, so one cache directory serves both
    packages (`device` and `plan` never enter a key). A call with an
    array-valued or unhashable extra (a `KernelSpec`, batched
    conditioning) folds uncached. The forward pass is skipped only when
    every element hits; a partial hit folds the batch and refreshes the
    store.

    tracer: optional `obs.Tracer`: the call gets one trace
    (cache_lookup / fold / write spans, cache hit/miss events, source
    "cache" when the forward pass was skipped) in the JAX package's
    JSONL schema. The fold span ends with the copy of the coordinates
    to the host, so it times the card's work, not only its launches.
    """
    from alphafold2_tpu_torch.obs.trace import NULL_TRACER

    trace = (tracer or NULL_TRACER).start_trace(out_path)
    try:
        return _fold_and_write_traced(model, seq, out_path, cache,
                                      model_tag, trace, device, **kwargs)
    except BaseException as exc:
        # every trace reaches exactly one terminal state, failures too
        trace.finish("error", error=repr(exc))
        raise


def _fold_and_write_traced(model, seq, out_path, cache, model_tag, trace,
                           device, **kwargs) -> list:
    from alphafold2_tpu_torch.data.pdb_io import coords2pdb
    from alphafold2_tpu_torch.utils.hashing import as_numpy

    def host(name):
        value = kwargs.get(name)
        return None if value is None else as_numpy(value)

    seq_np = as_numpy(seq)
    mask_np, msa_np, msa_mask_np = host("mask"), host("msa"), \
        host("msa_mask")
    b = seq_np.shape[0]

    def trim(k):
        return (slice(None) if mask_np is None
                else np.flatnonzero(mask_np[k]))

    keys = cached = None
    if cache is not None:
        from alphafold2_tpu_torch.cache.keys import fold_key
        num_recycles = kwargs.get("num_recycles", DEFAULT_NUM_RECYCLES)
        # every model input beyond the keyed ones must reach the key:
        # only scalar extras are keyable; an array-valued or unhashable
        # one disables caching for the call. No extras and an all-True
        # msa_mask key as the serving path does (extras=None).
        extra = tuple(sorted(
            (k, v) for k, v in kwargs.items() if k not in _NOT_KEYED))
        scalar_ok = all(
            v is None or isinstance(v, (str, bytes, bool, int, float,
                                        np.integer, np.floating))
            for _, v in extra)
        if scalar_ok:
            try:
                with trace.span("cache_lookup", batch=b):
                    keys, cached = [], []
                    for k in range(b):
                        idx = trim(k)
                        mm = (None if msa_mask_np is None
                              else msa_mask_np[k][:, idx])
                        if mm is not None and mm.all():
                            mm = None
                        extras = None if not extra and mm is None \
                            else (extra, mm)
                        keys.append(fold_key(
                            seq_np[k][idx],
                            None if msa_np is None else msa_np[k][:, idx],
                            num_recycles=num_recycles,
                            model_tag=model_tag, extras=extras))
                        cached.append(cache.get(keys[k], trace=trace))
            except TypeError:
                # an extra that cannot be content-hashed: fold uncached
                keys = cached = None

    coords_np = confidence_np = None
    all_hit = cached is not None and all(c is not None for c in cached)
    if not all_hit:
        with trace.span("fold", batch=b):
            result = fold(model, seq, device=device, **kwargs)
            coords_np = result.coords.float().cpu().numpy()
            confidence_np = result.confidence.float().cpu().numpy()

    stem, ext = os.path.splitext(out_path)
    ext = ext or ".pdb"
    paths = []
    with trace.span("write", batch=b):
        for k in range(b):
            path = out_path if b == 1 else f"{stem}_{k}{ext}"
            idx = trim(k)
            if cached is not None and cached[k] is not None:
                coords_k = cached[k].coords
            else:
                coords_k = coords_np[k][idx]
                if keys is not None:
                    cache.put(keys[k], coords_k, confidence_np[k][idx])
            paths.append(coords2pdb(seq_np[k][idx], coords_k, name=path))
    trace.finish("ok", source="cache" if all_hit else "fold")
    return paths
