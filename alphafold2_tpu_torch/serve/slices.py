"""Multi-device slices of the serving executor: one rank process per
device, driven from the executor's process (the multi-device path of
`alphafold2_tpu/serve/executor.py:267-302, 344-374, 434-492`).

In JAX one process drives every chip of a slice. In PyTorch a mesh is
one process per device (`parallel/`), so a `SliceGroup` serves one
(slice, mesh shape (i, j), model_tag) from `chips` rank processes that
the executor starts and commands:

- start: the ranks are spawned (never forked: the parent process may
  hold a CUDA context). Rank r pins the slice's r-th card and joins one NCCL
  group (gloo when the slice's devices are the CPU) over a `FileStore`
  in the group's own temporary directory, so disjoint slices never
  share a collective. Each rank rebuilds the model from its constructor
  arguments (`Alphafold2.init_kwargs`) and loads the weights from one
  state dict the parent process wrote, whole: the port's meshed model
  computes with whole parameters on every rank (where JAX places them
  by `shard_pytree_tp`, its compiler computes on the blocks). Each rank
  runs as many intra-op threads as the parent process. The CUDA
  kernels are built once in the parent process before the spawn.
- commands: a fold command names the variant, the recycles, the
  `KernelSpec`, the batch (by id: its inputs travel once, with the
  first command that names it, and each rank keeps them on its device,
  whole: a plain tensor under a mesh is the global value, and the
  model's first `shard_msa` keeps the rank's block of the MSA, the
  placement JAX gives the inputs by `fold_input_shardings`) and the
  step state. Each
  rank runs `predict.fold` / `fold_init` / `fold_step` /
  `fold_init_rows` under `use_mesh` through its own `Program` (the
  spec's device plan lives there).
- replies: rank 0 answers through `torch.multiprocessing` queues, so
  CPU tensors travel through shared memory. A reply carries the
  coordinates and the confidence. The distogram and the recyclables
  stay on the ranks (every rank holds the same whole values) behind
  `RemoteTensor` handles; `np.asarray` of a handle, or `fetch`, brings
  the value over, which is how the scheduler reads a distogram only
  where it needs one. A handle that the parent process drops is freed
  on the ranks with the next command.
- errors: an exception on any rank is raised in the parent process as
  the same exception (with the rank's traceback as a note), so
  `serve.cuda_errors` classifies it as it would in process: a CUDA OOM
  on a rank is still an OOM to `RetryPolicy`. A rank that dies raises
  `SliceRankLost`. A group whose ranks may be stuck in a collective
  is killed; the executor starts a fresh one on its next call.
- shutdown: `close()` ends the ranks (`destroy_process_group`, then a
  join); `kill()` sends SIGKILL, because a rank hung in a collective
  never returns. Every live group is killed at interpreter exit, and a
  rank exits on its own when its parent is gone.

Run on the CPU (gloo) by giving the executor a pool of CPU devices;
on cards each rank holds one card.
"""

from __future__ import annotations

import atexit
import itertools
import os
import pickle
import queue
import shutil
import signal
import tempfile
import threading
import time
import traceback
import weakref
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

# batches whose inputs each rank keeps placed (a step loop names one
# batch for every step; a repack or an admission mints a new one)
BATCH_SLOTS = 8
# seconds the parent process waits for the other ranks once one rank
# failed, before it takes them for stuck in a collective and kills the
# group
ERROR_GRACE_S = 10.0

_ids = itertools.count(1)
_live: "weakref.WeakSet[SliceGroup]" = weakref.WeakSet()


class SliceRankLost(RuntimeError):
    """A rank process of a slice group exited or was killed."""


class RankError(RuntimeError):
    """A rank's exception that could not travel as itself: its type name
    and message, so the payload classifies as the original would."""


class RemoteTensor:
    """A tensor held by the ranks of a slice group (the same whole value
    on every rank), by handle. `fetch()` copies it to the host;
    `np.asarray` does the same (bf16 widened to fp32)."""

    __slots__ = ("group", "handle", "shape", "dtype", "__weakref__")

    def __init__(self, group: "SliceGroup", handle: int, shape, dtype):
        self.group = group
        self.handle = handle
        self.shape = torch.Size(shape)
        self.dtype = dtype
        weakref.finalize(self, _release, weakref.ref(group), handle)

    def fetch(self) -> torch.Tensor:
        return self.group.fetch([self])[0]

    @property
    def place(self) -> "SlicePlace":
        """Where a host copy goes back (`predict.restore_step_state`)."""
        return SlicePlace(self.group)

    def __array__(self, dtype=None, copy=None):
        t = self.fetch()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.numpy()
        return arr if dtype is None else arr.astype(dtype)

    def __repr__(self):
        return (f"RemoteTensor({tuple(self.shape)}, {self.dtype}, "
                f"{self.group.label})")


def _release(group_ref, handle: int):
    group = group_ref()
    if group is not None:
        group.release(handle)


class SlicePlace:
    """Where a snapshotted leaf lived: a slice group, by reference, and
    the slice's devices (the fallback when the group is gone)."""

    def __init__(self, group: "SliceGroup"):
        self._group = weakref.ref(group)
        self.devices = list(group.devices)

    @property
    def group(self) -> Optional["SliceGroup"]:
        group = self._group()
        return group if group is not None and group.alive else None

    def put(self, arr: np.ndarray):
        """A host copy back on the group's ranks while the group lives;
        else on the slice's first device (the default device where this
        process lacks it), from where the next run on the slice sends
        it to the ranks."""
        from alphafold2_tpu_torch.predict import _live_device, _to_device
        group = self.group
        if group is None:
            return _to_device(arr, _live_device(self.devices[0]))
        return group.put([_to_device(arr, torch.device("cpu"))])[0]

    def __repr__(self):
        return f"SlicePlace({[str(d) for d in self.devices]})"


def is_remote(x) -> bool:
    return isinstance(x, RemoteTensor)


def to_local(tree):
    """`tree` (a FoldStepState, Recyclables, tuple or tensor) with every
    RemoteTensor fetched to the host; other leaves as they are."""
    from alphafold2_tpu_torch.predict import tree_flatten, tree_unflatten
    leaves, treedef = tree_flatten(tree)
    remote = [x for x in leaves if is_remote(x)]
    if not remote:
        return tree
    fetched = iter(fetch_all(remote))
    return tree_unflatten(treedef, [next(fetched) if is_remote(x) else x
                                    for x in leaves])


def fetch_all(tensors: Sequence[RemoteTensor]) -> List[torch.Tensor]:
    """Host copies of handles, one command per group."""
    out = [None] * len(tensors)
    by_group = {}
    for at, t in enumerate(tensors):
        by_group.setdefault(id(t.group), (t.group, []))[1].append(at)
    for group, ats in by_group.values():
        for at, val in zip(ats, group.fetch([tensors[a] for a in ats])):
            out[at] = val
    return out


class SliceGroup:
    """The rank processes serving one (slice, mesh shape, model_tag).

    model: the executor's model (its `init_kwargs` and weights seed the
        ranks; it is not sent).
    devices: the slice's devices, one rank each (CPU devices: gloo).
    mesh_shape: the (i, j) face of `make_mesh(1, i, j)`.
    max_entries: programs each rank keeps (the executor's LRU size).

    The constructor returns once the ranks are spawned; the first
    command (or `wait_ready`) waits for them, so several groups start
    at once.
    """

    def __init__(self, model, devices: Sequence, mesh_shape: Tuple[int, int],
                 model_tag: str = "", max_entries: int = 8):
        import torch.multiprocessing as mp

        self.devices = [torch.device(d) for d in devices]
        self.mesh_shape = tuple(int(x) for x in mesh_shape)
        self.model_tag = model_tag
        if self.mesh_shape[0] * self.mesh_shape[1] != len(self.devices):
            raise ValueError(f"mesh {self.mesh_shape} over "
                             f"{len(self.devices)} devices")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
            raise ValueError(f"a slice is all CPU or all cards, got "
                             f"{[str(d) for d in self.devices]}")
        self.cuda = kinds == {"cuda"}
        if self.cuda and len({d.index for d in self.devices}) \
                != len(self.devices):
            raise ValueError("a card holds one rank of a slice")
        self.label = (f"{self.mesh_shape[0]}x{self.mesh_shape[1]}"
                      f"[{','.join(str(d) for d in self.devices)}]")
        self.alive = False
        self._lock = threading.RLock()
        self._free_lock = threading.Lock()
        self._to_free: List[int] = []
        self._seq = 0
        self._batches: "OrderedDict[int, None]" = OrderedDict()
        self.commands = 0
        self.reply_bytes = 0
        self.last_reply_bytes = 0
        self.last_transfer_s = 0.0
        self.last_rank_s = 0.0

        self._t0 = time.monotonic()
        if self.cuda:
            # one build in the parent process, not one per rank
            from alphafold2_tpu_torch.ops import build
            build.build()
        self._dir = tempfile.mkdtemp(prefix="af2-slice-")
        weights = os.path.join(self._dir, "weights.pt")
        torch.save({k: v.detach().cpu() for k, v in
                    model.state_dict().items()}, weights)
        ctx = mp.get_context("spawn")
        self._replies = ctx.Queue()
        self._commands = [ctx.Queue() for _ in self.devices]
        spec = dict(devices=[str(d) for d in self.devices],
                    mesh_shape=self.mesh_shape,
                    store=os.path.join(self._dir, "store"),
                    weights=weights, model_kwargs=model.init_kwargs,
                    training=model.training,
                    threads=torch.get_num_threads(),
                    max_entries=max(1, int(max_entries)),
                    parent=os.getpid())
        self._procs = [ctx.Process(target=_rank_main, daemon=True,
                                   args=(r, spec, self._commands[r],
                                         self._replies),
                                   name=f"af2-slice-rank{r}")
                       for r in range(len(self.devices))]
        for p in self._procs:
            p.start()
        self.alive = True
        self._ready = False
        self.startup_s = None
        self.rank_startup: List[dict] = []
        _live.add(self)

    def wait_ready(self):
        """Block until every rank has built its model (once); a rank
        that failed to start raises here and the group is killed."""
        with self._lock:
            if self._ready:
                return
            if not self.alive:
                raise SliceRankLost(f"slice group {self.label} is closed")
            try:
                ready = self._collect(0)
            except BaseException:
                self.kill()
                raise
            # from the spawn to the last rank's ready message
            self.startup_s = max(r["ready_at"] for r in ready) - self._t0
            self.rank_startup = [
                {k: r[k] for k in ("group_s", "model_s")}
                for r in ready]
            self._ready = True

    # -- the command channel ---------------------------------------------

    def _send(self, op: str, **payload) -> list:
        """One command to every rank; the replies of all ranks, in rank
        order (raises the first rank's error)."""
        with self._lock:
            self.wait_ready()
            if not self.alive:
                raise SliceRankLost(f"slice group {self.label} is closed")
            self._seq += 1
            with self._free_lock:
                free, self._to_free = self._to_free, []
            msg = (op, self._seq, free, payload)
            for q in self._commands:
                q.put(msg)
            self.commands += 1
            return self._collect(self._seq)

    def _collect(self, seq: int, deadline: Optional[float] = None) -> list:
        n = len(self._procs)
        got = [None] * n
        errors = {}
        received = 0
        while received < n:
            try:
                r_seq, rank, ok, payload, sent_at = \
                    self._replies.get(timeout=0.5)
            except (OSError, ValueError):
                if self.alive:
                    raise
                # killed from another thread (an executor's rebuild)
                raise SliceRankLost(f"slice group {self.label} is closed")
            except queue.Empty:
                lost = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and got[r] is None
                        and r not in errors]
                if lost:
                    codes = [self._procs[r].exitcode for r in lost]
                    self.kill()
                    if errors:
                        break
                    raise SliceRankLost(
                        f"slice rank {lost[0]} of {self.label} exited "
                        f"with code {codes[0]}")
                if errors and time.monotonic() > deadline:
                    # the other ranks wait in a collective for the one
                    # that failed: the group cannot go on
                    self.kill()
                    break
                continue
            if r_seq != seq:
                continue        # a reply to a command given up on
            received += 1
            if ok:
                got[rank] = payload
                if rank == 0:
                    self.last_transfer_s = time.monotonic() - sent_at
            else:
                errors[rank] = payload
                if deadline is None or len(errors) == 1:
                    deadline = time.monotonic() + ERROR_GRACE_S
        if errors:
            raise _rank_exception(errors[min(errors)], min(errors),
                                  self.label)
        return got

    def release(self, handle: int):
        """Free a handle on the ranks with the next command."""
        with self._free_lock:
            self._to_free.append(handle)

    # -- commands ----------------------------------------------------------

    def run(self, variant: str, num_recycles: int, key: tuple, kernel,
            batch_id: int, inputs: tuple, extra: tuple):
        """Run one program on the ranks: (coords, confidence, distogram
        handle, Recyclables of handles). `inputs` (host tensors) travel
        only when the ranks do not hold batch `batch_id` yet; `extra` is
        the step's recyclables or init_rows' (row_mask, state)."""
        from alphafold2_tpu_torch.model.alphafold2 import Recyclables
        with self._lock:
            drop = []
            if batch_id in self._batches:
                self._batches.move_to_end(batch_id)
                inputs = None
            else:
                self._batches[batch_id] = None
                while len(self._batches) > BATCH_SLOTS:
                    drop.append(self._batches.popitem(last=False)[0])
            out_ids = [next(_ids) for _ in range(4)]
            replies = self._send(
                "run", variant=variant, num_recycles=int(num_recycles),
                key=key, kernel=kernel, batch_id=batch_id, inputs=inputs,
                drop=drop, extra=self._encode(extra), out_ids=out_ids)
            head = replies[0]
            self.last_rank_s = head["seconds"]
            self.last_reply_bytes = head["bytes"]
            self.reply_bytes += head["bytes"]
        remote = [RemoteTensor(self, h, shape, dtype)
                  for h, (shape, dtype) in zip(out_ids, head["remote"])]
        return (head["coords"], head["confidence"], remote[0],
                Recyclables(*remote[1:]))

    def fetch(self, tensors: Sequence[RemoteTensor]) -> List[torch.Tensor]:
        for t in tensors:
            if t.group is not self:
                raise ValueError(f"{t} is not held by {self.label}")
        return self._send("fetch", ids=[t.handle for t in tensors])[0]

    def put(self, tensors: Sequence[torch.Tensor]) -> List[RemoteTensor]:
        """Place host tensors on every rank; their handles."""
        ids = [next(_ids) for _ in tensors]
        self._send("put", ids=ids,
                   tensors=[t.detach().cpu() for t in tensors])
        return [RemoteTensor(self, h, t.shape, t.dtype)
                for h, t in zip(ids, tensors)]

    def rank_stats(self, reset: bool = False) -> List[dict]:
        """Per rank: K1 and K2 launches since the last reset, peak
        device memory (cards), held handles and placed batches."""
        return self._send("stats", reset=bool(reset))

    def _encode(self, tree):
        """A step state (or tuple of them) for the ranks: a handle of
        this group by id, any other tensor as a host tensor, tuples and
        NamedTuples by their type."""
        if is_remote(tree):
            return ("h", tree.handle) if tree.group is self \
                else ("t", tree.fetch())
        if isinstance(tree, torch.Tensor):
            return ("t", tree.detach().cpu())
        if isinstance(tree, tuple):
            return ("tuple", type(tree), [self._encode(x) for x in tree])
        return ("v", tree)

    # -- lifetime ------------------------------------------------------------

    def close(self, timeout_s: float = 30.0):
        """End the ranks: each destroys its process group and exits;
        a rank that does not end in `timeout_s` is killed."""
        if not self.alive:
            return
        try:
            with self._lock:
                self._seq += 1
                for q in self._commands:
                    q.put(("close", self._seq, [], {}))
        except Exception:
            pass
        deadline = time.monotonic() + timeout_s
        for p in self._procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        self.kill()

    def kill(self):
        """SIGKILL every rank (a rank stuck in a collective never
        returns) and remove the group's directory."""
        self.alive = False
        for p in self._procs:
            if p.is_alive():
                try:
                    os.kill(p.pid, signal.SIGKILL)
                except OSError:
                    pass
        for p in self._procs:
            p.join(timeout=10)
        for q in self._commands + [self._replies]:
            q.cancel_join_thread()
            q.close()
        shutil.rmtree(self._dir, ignore_errors=True)
        _live.discard(self)

    def __enter__(self) -> "SliceGroup":
        return self

    def __exit__(self, *exc):
        self.close()

    def stats(self) -> dict:
        return {"label": self.label, "alive": self.alive,
                "startup_s": self.startup_s,
                "rank_startup": list(self.rank_startup),
                "commands": self.commands,
                "reply_bytes": self.reply_bytes,
                "last_reply_bytes": self.last_reply_bytes,
                "last_transfer_s": self.last_transfer_s,
                "last_rank_s": self.last_rank_s}


@atexit.register
def _kill_live_groups():
    for group in list(_live):
        group.kill()


def _rank_exception(payload, rank: int, label: str) -> BaseException:
    exc, text = payload
    if exc is None:
        exc = RankError(text.strip().splitlines()[-1] if text else
                        "unknown error")
    try:
        exc.add_note(f"raised on slice rank {rank} of {label}:\n{text}")
    except Exception:
        pass
    return exc


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------


def _watch_parent(parent: int):
    """Exit when the parent process is gone, even from inside a
    collective."""
    while True:
        time.sleep(1.0)
        if os.getppid() != parent:
            os._exit(1)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _rank_main(rank: int, spec: dict, commands, replies):
    threading.Thread(target=_watch_parent, args=(spec["parent"],),
                     daemon=True).start()
    try:
        server = _RankServer(rank, spec)
    except BaseException as exc:
        replies.put((0, rank, False, _error_payload(exc), time.monotonic()))
        return
    replies.put((0, rank, True, {"ready_at": time.monotonic(),
                                 **server.startup}, time.monotonic()))
    server.serve(commands, replies)


def _error_payload(exc: BaseException):
    text = "".join(traceback.format_exception(exc))
    try:
        pickle.loads(pickle.dumps(exc))
        travels = exc
    except Exception:
        travels = None
        text = f"{text}\n{type(exc).__name__}: {exc}"
    return travels, text


class _RankServer:
    """One rank: its process group, mesh, model, programs, placed batches
    and held tensors."""

    def __init__(self, rank: int, spec: dict):
        import torch.distributed as dist

        from alphafold2_tpu_torch.model.alphafold2 import Alphafold2
        from alphafold2_tpu_torch.parallel import make_mesh

        torch.set_num_threads(int(spec["threads"]))
        t0 = time.perf_counter()
        self.rank = rank
        self.device = torch.device(spec["devices"][rank])
        world = len(spec["devices"])
        kw = {}
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
            kw["device_id"] = self.device
        dist.init_process_group(
            "nccl" if self.device.type == "cuda" else "gloo",
            store=dist.FileStore(spec["store"], world), rank=rank,
            world_size=world, **kw)
        i, j = spec["mesh_shape"]
        self.mesh = make_mesh(1, i, j)
        t1 = time.perf_counter()
        # built on the meta device (nothing drawn), then allocated here
        # and filled from the parent's weights
        self.model = Alphafold2(**spec["model_kwargs"], device="meta")
        self.model.to_empty(device=self.device)
        self.model.train(spec["training"])
        with torch.no_grad():
            self.model.load_state_dict(
                torch.load(spec["weights"], map_location=self.device))
        # seconds of the start-up: process group and mesh; the model's
        # build and its weights' load
        self.startup = {"group_s": t1 - t0,
                        "model_s": time.perf_counter() - t1}
        self.max_entries = spec["max_entries"]
        self.programs: "OrderedDict[tuple, object]" = OrderedDict()
        self.batches = {}
        self.held = {}

    def serve(self, commands, replies):
        import torch.distributed as dist
        while True:
            op, seq, free, payload = commands.get()
            for h in free:
                self.held.pop(h, None)
            if op == "close":
                break
            try:
                out = getattr(self, "op_" + op)(**payload)
                replies.put((seq, self.rank, True, out, time.monotonic()))
            except BaseException as exc:
                replies.put((seq, self.rank, False, _error_payload(exc),
                             time.monotonic()))
        try:
            dist.destroy_process_group()
        except Exception:
            pass

    def _place(self, inputs):
        """The batch's inputs on this rank's device, whole (module
        doc)."""
        return tuple(None if t is None else t.to(self.device)
                     for t in inputs)

    def _decode(self, enc):
        kind, *rest = enc
        if kind == "h":
            return self.held[rest[0]]
        if kind == "t":
            return rest[0].to(self.device)
        if kind == "tuple":
            cls, items = rest
            items = [self._decode(x) for x in items]
            return cls(*items) if hasattr(cls, "_fields") else cls(items)
        return rest[0]

    def op_run(self, variant, num_recycles, key, kernel, batch_id, inputs,
               drop, extra, out_ids):
        from alphafold2_tpu_torch.parallel import use_mesh
        from alphafold2_tpu_torch.serve.executor import Program
        for b in drop:
            self.batches.pop(b, None)
        if inputs is not None:
            self.batches[batch_id] = self._place(inputs)
        args = self.batches[batch_id] + tuple(self._decode(extra))
        program = self.programs.get(key)
        if program is None:
            program = self.programs[key] = Program(
                self.model, variant, num_recycles, kernel)
            while len(self.programs) > self.max_entries:
                self.programs.popitem(last=False)
        else:
            self.programs.move_to_end(key)
        t0 = time.perf_counter()
        with use_mesh(self.mesh):
            result = program(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        remote = (result.distogram,) + tuple(result.recyclables)
        for h, t in zip(out_ids, remote):
            self.held[h] = t
        if self.rank != 0:
            return None
        coords = result.coords.detach().cpu()
        confidence = result.confidence.detach().cpu()
        return {"coords": coords, "confidence": confidence,
                "remote": [(tuple(t.shape), t.dtype) for t in remote],
                "bytes": _nbytes(coords, confidence), "seconds": seconds}

    def op_fetch(self, ids):
        if self.rank != 0:
            return None
        return [self.held[h].detach().cpu() for h in ids]

    def op_put(self, ids, tensors):
        for h, t in zip(ids, tensors):
            self.held[h] = t.to(self.device)

    def op_stats(self, reset):
        from alphafold2_tpu_torch.ops import attention, block_sparse
        out = {"k1": attention.launch_count.value,
               "k2": block_sparse.launch_count.value,
               "held": len(self.held), "batches": len(self.batches),
               "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                              if self.device.type == "cuda" else 0)}
        if reset:
            attention.launch_count.reset()
            block_sparse.launch_count.reset()
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
        return out
