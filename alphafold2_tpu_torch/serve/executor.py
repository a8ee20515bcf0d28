"""Program cache around `predict.fold` (counterpart of
`alphafold2_tpu/serve/executor.py:87-589`).

One program per (bucket_len, batch_size, msa_depth, num_recycles,
mesh_shape, model_tag, variant, kernel) key, in an LRU of `max_entries`.
A program is the variant's callable over `predict.fold*` ("fold" runs
every recycle, "init" / "step" are the two halves of a scheduler-owned
recycle loop, "init_rows" the row-masked admission init), its KernelSpec
("dense" in the key when None, else the spec's label) and, for a spec
with the "auto" backend, the spec's plan on the device: the column list
of kernel K2, uploaded once when the key is built and freed with the key
when it is evicted. init/step/init_rows keys pin num_recycles to 0: one
step program serves every recycle depth.

The model holds its weights; the executor runs it eagerly on its own
device, or, given a one-device slice (`devices=[d]`), on a copy made once
per (device, model_tag). A slice of several devices runs on a
`serve.slices.SliceGroup`: one rank process per device under
`make_mesh(1, i, j)` (the pair 2-D sharded, FastFold's DAP), started
once per (slice, mesh shape, model_tag) and driven from here. Groups are
keyed by the slice's device names, so a CPU pool that repeats one device
gives slices of one shape one group, whose commands run one at a time.
`mesh_shape` defaults to the slice's `meshpolicy.slice_face`.
Every run synchronises the device before it returns, so a caller's
latency measurement is honest. `stats()` exposes hits, misses (programs
built) and evictions. `trace=` takes the span API of
`obs.trace.NULL_TRACE`: `compile` when a key is built, `fold`,
`recycle` or `admit` for the run (tagged with the mesh label on a
slice), `shard` once per batch and slice for the inputs' placement.
`faults` takes a chaos plan with `on_executor_run(batch, variant=,
recycle=)` and `mutate_result(batch, result)` hooks; they run in this
process, before the command goes to a slice's ranks and after the reply
lands.

Not ported yet (ROADMAP.md): CUDA-graph capture per key (queue 2,
item 8).
"""

from __future__ import annotations

import copy
import itertools
import threading
from collections import OrderedDict
from typing import Iterable, Optional, Sequence, Tuple

import torch

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.obs.trace import NULL_TRACE
from alphafold2_tpu_torch.ops.block_sparse import KernelSpec
from alphafold2_tpu_torch.predict import (FoldResult, FoldStepState, fold,
                                          fold_init, fold_init_rows,
                                          fold_step)
from alphafold2_tpu_torch.serve.bucketing import msa_depth_of
from alphafold2_tpu_torch.serve.meshpolicy import slice_face
from alphafold2_tpu_torch.serve.slices import SliceGroup

MeshShape = Tuple[int, int]
# (bucket_len, batch_size, msa_depth, num_recycles, mesh_shape,
#  model_tag, variant, kernel)
ExecKey = Tuple[int, int, int, int, MeshShape, str, str, str]

VARIANTS = ("fold", "init", "step", "init_rows")
_SINGLE: MeshShape = (1, 1)
_DENSE = "dense"
_BATCH_INPUTS = ("seq", "mask", "msa", "msa_mask")
# one id per placed batch: a slice group's ranks keep a batch's inputs
# under it for the steps of a loop
_batch_ids = itertools.count(1)


def mesh_label(mesh_shape: MeshShape) -> str:
    return f"{mesh_shape[0]}x{mesh_shape[1]}"


class Program:
    """One key's program: the variant's callable over `predict.fold*`,
    its KernelSpec, and the spec's plan on the model's device."""

    def __init__(self, model, variant: str, num_recycles: int,
                 kernel: Optional[KernelSpec] = None):
        if variant not in VARIANTS:
            raise ValueError(f"unknown executable variant {variant!r}")
        self.model = model
        self.variant = variant
        self.num_recycles = int(num_recycles)
        self.kernel = kernel
        self.plan = None
        if kernel is not None and kernel.backend == "auto":
            self.plan = kernel.device_plan(model.device)

    def __call__(self, seq, mask, msa, msa_mask, *extra):
        kw = dict(msa=msa, mask=mask, msa_mask=msa_mask,
                  device=self.model.device, kernel=self.kernel,
                  plan=self.plan)
        if self.variant == "fold":
            return fold(self.model, seq, num_recycles=self.num_recycles,
                        **kw)
        if self.variant == "init":
            return fold_init(self.model, seq, **kw)
        if self.variant == "init_rows":
            row_mask, state = extra
            return fold_init_rows(self.model, seq, row_mask, state, **kw)
        (recyclables,) = extra
        return fold_step(self.model, seq, recyclables, **kw)

    def sync(self):
        if self.model.device.type == "cuda":
            torch.cuda.synchronize(self.model.device)


class SliceProgram:
    """One key's program on a slice group: the ranks build their own
    `Program` for the key on its first run there."""

    def __init__(self, key: tuple, variant: str, num_recycles: int,
                 kernel: Optional[KernelSpec] = None):
        if variant not in VARIANTS:
            raise ValueError(f"unknown executable variant {variant!r}")
        self.key = key
        self.variant = variant
        self.num_recycles = int(num_recycles)
        self.kernel = kernel

    def run(self, group: SliceGroup, placed, extra):
        batch_id, inputs = placed
        coords, confidence, distogram, recyclables = group.run(
            self.variant, self.num_recycles, self.key, self.kernel,
            batch_id, inputs, extra)
        kind = FoldResult if self.variant == "fold" else FoldStepState
        return kind(coords, confidence, distogram, recyclables)


class FoldExecutor:
    """LRU cache of fold programs, keyed by shape signature.

    model: the port's `Alphafold2` (predict_coords=True), holding its
        weights, on the device the executor runs on.
    model_tag: weight identity baked into every ExecKey; reassigning it
        makes every earlier program unreachable and drops the model
        copies and slice groups placed under other tags.
    faults: optional chaos plan (see module doc); None costs nothing.
    """

    def __init__(self, model, max_entries: int = 8, faults=None,
                 model_tag: str = ""):
        if not model.predict_coords:
            raise ValueError("serving needs predict_coords=True")
        self.model = model
        self.max_entries = max(1, int(max_entries))
        self.faults = faults
        self._cache: "OrderedDict[tuple, Program]" = OrderedDict()
        # (device, model_tag) -> the model copied onto that device
        self._placed: dict = {}
        # (device names, mesh shape, model_tag) -> its SliceGroup
        self._groups: dict = {}
        self._lock = threading.Lock()
        self._group_lock = threading.Lock()
        self.model_tag = model_tag
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    @property
    def model_tag(self) -> str:
        return self._model_tag

    @model_tag.setter
    def model_tag(self, tag: str):
        """Re-key every future ExecKey, drop the model copies placed
        under any other tag and close their slice groups now."""
        self._model_tag = tag
        with self._lock:
            for k in [k for k in self._placed if k[1] != tag]:
                del self._placed[k]
        with self._group_lock:
            stale = [k for k in self._groups if k[2] != tag]
            groups = [self._groups.pop(k) for k in stale]
        for group in groups:
            group.close()

    def rebuild(self) -> "FoldExecutor":
        """Fresh executor over the same model: empty cache, zeroed
        counters. This executor's slice groups are killed (a group that
        served a hung call is not trusted); the new one starts its own."""
        self.kill()
        return FoldExecutor(self.model, max_entries=self.max_entries,
                            faults=self.faults, model_tag=self.model_tag)

    def groups(self) -> list:
        with self._group_lock:
            return [g for g in self._groups.values() if g.alive]

    def close(self):
        """Close every slice group (their ranks exit); a later run on a
        slice starts a fresh group."""
        with self._group_lock:
            groups, self._groups = list(self._groups.values()), {}
        for group in groups:
            group.close()

    def kill(self):
        """SIGKILL every slice group's ranks."""
        with self._group_lock:
            groups, self._groups = list(self._groups.values()), {}
        for group in groups:
            group.kill()

    # -- keys ------------------------------------------------------------

    def key_for(self, batch: dict, num_recycles: int,
                mesh_shape: Optional[MeshShape] = None,
                variant: str = "fold", kernel=None) -> ExecKey:
        b, n = batch["seq"].shape
        shape = _SINGLE if mesh_shape is None \
            else tuple(int(x) for x in mesh_shape)
        recycles = int(num_recycles) if variant == "fold" else 0
        return (int(n), int(b), msa_depth_of(batch), recycles,
                shape, self.model_tag, variant,
                _DENSE if kernel is None else kernel.label)

    def _normalize_key(self, key) -> ExecKey:
        """Accept 4-tuple (len, batch, msa_depth, recycles), 5-tuple
        (+ mesh_shape), 6-tuple (+ model_tag) and 7-tuple (+ variant)
        keys alongside the full 8-tuple."""
        key = tuple(key)
        if len(key) == 4:
            return key + (_SINGLE, self.model_tag, "fold", _DENSE)
        if len(key) == 5:
            return key[:4] + (tuple(key[4]), self.model_tag, "fold",
                              _DENSE)
        if len(key) == 6:
            return key[:4] + (tuple(key[4]), key[5], "fold", _DENSE)
        if len(key) == 7:
            return key[:4] + (tuple(key[4]),) + tuple(key[5:7]) \
                + (_DENSE,)
        return key[:4] + (tuple(key[4]),) + tuple(key[5:8])

    # -- cache -----------------------------------------------------------

    def _lookup(self, cache_key: tuple):
        with self._lock:
            fn = self._cache.get(cache_key)
            if fn is not None:
                self.hits += 1
                self._cache.move_to_end(cache_key)
            return fn

    def _compile(self, cache_key: tuple, model, variant: str,
                 num_recycles: int, kernel=None):
        """Build the key's program outside the lock (the plan's upload
        happens here) and insert it; the least recently used key goes
        when the cache is full. `model` None builds a slice's program."""
        if model is None:
            program = SliceProgram(cache_key[:8], variant, num_recycles,
                                   kernel)
        else:
            program = Program(model, variant, num_recycles, kernel)
        with self._lock:
            self.misses += 1
            existing = self._cache.get(cache_key)
            if existing is not None:
                self._cache.move_to_end(cache_key)
                return existing
            self._cache[cache_key] = program
            while len(self._cache) > self.max_entries:
                self._cache.popitem(last=False)
                self.evictions += 1
        return program

    # -- device slices ---------------------------------------------------

    def _slice(self, devices, mesh_shape):
        """(model or SliceGroup, its cache-key element, mesh shape) of a
        slice. A one-device slice runs in this process, on a copy of the
        model made once per (device, model_tag); a larger one runs on
        the slice's SliceGroup, started once per (device names, mesh
        shape, model_tag)."""
        devices = [resolve_device(d) for d in devices]
        mesh_shape = slice_face(len(devices), devices) \
            if mesh_shape is None else tuple(int(x) for x in mesh_shape)
        dev_ids = tuple(str(d) for d in devices)
        if len(devices) > 1 or mesh_shape != _SINGLE:
            return self._group(devices, dev_ids, mesh_shape), dev_ids, \
                mesh_shape
        dev = devices[0]
        if dev == self.model.device:
            return self.model, dev_ids, mesh_shape
        cache_k = (str(dev), self.model_tag)
        with self._lock:
            placed = self._placed.get(cache_k)
        if placed is None:
            placed = copy.deepcopy(self.model).to(dev)
            with self._lock:
                placed = self._placed.setdefault(cache_k, placed)
        return placed, dev_ids, mesh_shape

    def _group(self, devices, dev_ids, mesh_shape) -> SliceGroup:
        """The slice's group, spawned here when it has none (or a dead
        one); the first command waits for its ranks to be ready."""
        key = (dev_ids, mesh_shape, self.model_tag)
        with self._group_lock:
            group = self._groups.get(key)
            if group is None or not group.alive:
                group = self._groups[key] = SliceGroup(
                    self.model, devices, mesh_shape, self.model_tag,
                    max_entries=self.max_entries)
            return group

    def prestart(self, devices: Sequence,
                 mesh_shape: Optional[MeshShape] = None):
        """Start a slice's group without waiting for it, so the groups
        of several slices start at once (a one-device slice has
        none)."""
        self._slice(devices, mesh_shape)

    # -- execution -------------------------------------------------------

    def run(self, batch: dict, num_recycles: int,
            trace=NULL_TRACE, devices: Optional[Sequence] = None,
            mesh_shape: Optional[MeshShape] = None,
            kernel=None) -> FoldResult:
        """Fold one assembled batch with `num_recycles` recycles; returns
        once the device is done. Spans: `compile` when the key is built,
        `fold` for the run (tagged with the kernel label), `shard` for a
        slice's placement. `kernel` (a KernelSpec, or None for dense) is
        part of the key. On a slice of several devices the result's
        distogram and recyclables are `serve.slices.RemoteTensor`s."""
        return self._execute("fold", batch, num_recycles, (), trace,
                             devices, mesh_shape, "fold", {}, kernel)

    def run_init(self, batch: dict, trace=NULL_TRACE,
                 devices: Optional[Sequence] = None,
                 mesh_shape: Optional[MeshShape] = None,
                 kernel=None) -> FoldStepState:
        """The first pass of the scheduler-owned recycle loop. Span:
        `fold`."""
        return self._execute("init", batch, 0, (), trace, devices,
                             mesh_shape, "fold", {}, kernel)

    def run_init_rows(self, batch: dict, state: FoldStepState,
                      row_mask, trace=NULL_TRACE,
                      devices: Optional[Sequence] = None,
                      mesh_shape: Optional[MeshShape] = None,
                      kernel=None,
                      span_attrs: Optional[dict] = None) -> FoldStepState:
        """Row-masked admission init: rows where `row_mask` is True
        restart from the batch tensors, the others keep `state`. Span:
        `admit`."""
        mask_arr = torch.as_tensor(row_mask, dtype=torch.bool)
        attrs = {"rows": int(mask_arr.sum())}
        if span_attrs:
            attrs.update(span_attrs)
        return self._execute("init_rows", batch, 0, (mask_arr, state),
                             trace, devices, mesh_shape, "admit", attrs,
                             kernel)

    def run_step(self, batch: dict, state: FoldStepState,
                 recycle_index: int, trace=NULL_TRACE,
                 devices: Optional[Sequence] = None,
                 mesh_shape: Optional[MeshShape] = None,
                 span_attrs: Optional[dict] = None,
                 kernel=None) -> FoldStepState:
        """One recycle iteration fed `state.recyclables`. Span:
        `recycle`, tagged with the iteration index."""
        attrs = {"recycle": int(recycle_index)}
        if span_attrs:
            attrs.update(span_attrs)
        return self._execute("step", batch, 0, (state.recyclables,),
                             trace, devices, mesh_shape, "recycle", attrs,
                             kernel)

    def _execute(self, variant: str, batch: dict, num_recycles: int,
                 extra_args, trace, devices, mesh_shape, span: str,
                 attrs: dict, kernel):
        if kernel is not None:
            attrs = dict(attrs, kernel=kernel.label)
        inputs = tuple(batch[k] for k in _BATCH_INPUTS)
        group = None
        if devices:
            target, dev_ids, mesh_shape = self._slice(devices, mesh_shape)
            label = mesh_label(mesh_shape)
            attrs = dict(attrs, mesh=label)
            key = self.key_for(batch, num_recycles, mesh_shape=mesh_shape,
                               variant=variant, kernel=kernel)
            cache_key = key + (dev_ids,)
            if isinstance(target, SliceGroup):
                group, model = target, None
            else:
                model = target
            # the batch's inputs are placed once per slice and kept on
            # the batch dict: a step loop's iterations share them (a
            # slice group's ranks keep them under the batch's id)
            place_key = ("_placed", dev_ids) if group is None \
                else ("_placed_ranks", dev_ids)
            placed = batch.get(place_key)
            if placed is None:
                with trace.span("shard", mesh=label, devices=len(dev_ids)):
                    if group is None:
                        placed = tuple(
                            None if t is None else
                            torch.as_tensor(t, device=model.device)
                            for t in inputs)
                    else:
                        placed = (next(_batch_ids), tuple(
                            None if t is None else
                            torch.as_tensor(t).detach().cpu()
                            for t in inputs))
                batch[place_key] = placed
            inputs = placed
        else:
            model = self.model
            key = self.key_for(batch, num_recycles, variant=variant,
                               kernel=kernel)
            cache_key = key + ((),)
        fn = self._lookup(cache_key)
        if fn is None:
            tags = {k: attrs[k] for k in ("mesh", "kernel") if k in attrs}
            if variant == "fold":
                tags["num_recycles"] = key[3]
            else:
                tags["variant"] = variant
            with trace.span("compile", bucket_len=key[0], batch_size=key[1],
                            msa_depth=key[2], **tags):
                fn = self._compile(cache_key, model, variant, key[3],
                                   kernel)
        if group is not None:
            def call():
                return fn.run(group, inputs, tuple(extra_args))
        else:
            def call():
                result = fn(*(inputs + tuple(extra_args)))
                fn.sync()
                return result
        with trace.span(span, bucket_len=key[0], **attrs):
            return self._invoke(call, batch, variant=variant,
                                recycle=attrs.get("recycle"))

    def _invoke(self, call, batch, variant: str = "fold", recycle=None):
        if self.faults is not None:
            # injected exceptions and latency fire before the device call
            self.faults.on_executor_run(batch, variant=variant,
                                        recycle=recycle)
        result = call()
        if self.faults is not None:
            result = self.faults.mutate_result(batch, result)
        return result

    def warmup(self, keys: Iterable,
               timer=None, devices: Optional[Sequence] = None,
               mesh_shape: Optional[MeshShape] = None,
               step_mode: bool = False,
               continuous: bool = False,
               kernel=None) -> int:
        """Build (and run once, on a zero batch with every position
        masked) each key's program. Keys may be 4-tuples (len, batch,
        msa_depth, recycles) or full ExecKeys. `step_mode` warms the
        init+step pair instead of the fold program, `continuous` also
        the init_rows program. `kernel` warms the keys of its own bucket
        length under it (the others dense). With `devices`, a slice of
        several devices starts its SliceGroup here. Returns the number
        of fresh builds; `timer` (with a `measure()` context) times each
        key."""
        if devices:
            target = self._slice(devices, mesh_shape)[0]
            device = torch.device("cpu") if isinstance(target, SliceGroup) \
                else target.device
        else:
            device = self.model.device
        fresh = 0
        for key in keys:
            bucket_len, batch_size, msa_depth, num_recycles = \
                self._normalize_key(key)[:4]
            before = self.misses
            batch = {
                "seq": torch.zeros((batch_size, bucket_len),
                                   dtype=torch.long, device=device),
                "mask": torch.zeros((batch_size, bucket_len),
                                    dtype=torch.bool, device=device),
                "msa": None, "msa_mask": None,
            }
            if msa_depth:
                batch["msa"] = torch.zeros(
                    (batch_size, msa_depth, bucket_len), dtype=torch.long,
                    device=device)
                batch["msa_mask"] = torch.zeros(
                    (batch_size, msa_depth, bucket_len), dtype=torch.bool,
                    device=device)
            k_spec = kernel if (kernel is not None
                                and kernel.covers(bucket_len)) else None

            def _one():
                if step_mode:
                    state = self.run_init(batch, devices=devices,
                                          mesh_shape=mesh_shape,
                                          kernel=k_spec)
                    if continuous:
                        mask0 = torch.zeros((batch_size,), dtype=torch.bool)
                        state = self.run_init_rows(
                            batch, state, mask0, devices=devices,
                            mesh_shape=mesh_shape, kernel=k_spec)
                    self.run_step(batch, state, 0, devices=devices,
                                  mesh_shape=mesh_shape, kernel=k_spec)
                else:
                    self.run(batch, num_recycles, devices=devices,
                             mesh_shape=mesh_shape, kernel=k_spec)

            if timer is not None:
                with timer.measure():
                    _one()
            else:
                _one()
            fresh += self.misses - before
        return fresh

    def stats(self) -> dict:
        with self._lock:
            out = {"hits": self.hits, "misses": self.misses,
                   "evictions": self.evictions,
                   "resident": len(self._cache),
                   "max_entries": self.max_entries,
                   "keys": [k[:-1] for k in self._cache.keys()]}
            placed = len(self._placed)
        out["placed_param_slices"] = placed + len(self.groups())
        return out
