"""Durable step-loop checkpoints: the migratable-fold store (counterpart
of `alphafold2_tpu/cache/checkpoints.py`; the payload is the JAX
package's, so a checkpoint written by either package decodes in the
other with equal arrays).

One npz payload per batch row carries what a resuming process needs to
continue that fold mid-loop:

- the row's slice of the step carry (`predict.snapshot_step_state`
  leaves, sliced on the batch axis, each with a placement spec);
- the row's host inputs (unpadded seq + msa tokens);
- the recycle age the carry was captured at.

`CheckpointStore` rests on `cache/bytestore.py` (atomic disk writes,
TTL, quarantine, `keys()`/`scan()`) and is keyed by
`(fold_key, model_tag, age)`: `checkpoint_key` digests fold_key +
model_tag into a group prefix and appends the age, so `latest()` is a
prefix scan and boot discovery (`survivors()`) a full scan. A payload
whose tag differs from the store's is discarded, never resumed. Older
ages are pruned after each newer spill.

Tiers: local disk is authoritative; an optional
`fleet.object_store.ObjectStoreBackend` mirror (one object per fold
group) and an optional peer tier (duck-typed
`fetch_checkpoint(group, tag) -> bytes | None`) let another process
resume a fold. Every tier carries the same bytes and validates with
`decode_checkpoint`. Counters go to `fold_checkpoint_events_total`, the
JAX package's name.

Placement: a leaf on one device has no spec and restores through
`predict.restore_step_state`. A leaf placed on a mesh (a DTensor, or a
`parallel.NamedSharding`) carries a "named" spec, the JAX package's
descriptor; restoring it rebuilds the mesh over this process group's
first ranks and places the leaf there as a DTensor, or, where the group
has too few ranks, takes default placement, as the JAX restore does.

The treedef is not on the wire: a resuming process rebuilds the row
through its own init pass and overwrites the row's leaves with the
decoded carry (leaf order is `predict.tree_flatten`'s, the JAX
package's); a leaf-count or shape mismatch is a validation failure.
"""

from __future__ import annotations

import io
import json
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from alphafold2_tpu_torch.cache.bytestore import ByteStore
from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry
from alphafold2_tpu_torch.obs.trace import NULL_TRACE
from alphafold2_tpu_torch.utils.hashing import stable_digest

# bump when the payload's fields or meaning change: old spills must
# MISS (and be discarded), never resume into the wrong semantics
CHECKPOINT_SCHEMA = "ckpt-v1"

# orphan manifest: the JSON record a preempted replica publishes next to
# its spilled checkpoints so a controller can re-home every in-flight
# fold. Same versioning discipline as the checkpoint payload.
MANIFEST_SCHEMA = "orphans-v1"

# JSON-able reference-leaf types the wire can carry; anything else
# makes the row unspillable (counted, skipped — never a torn payload)
_REF_TYPES = (bool, int, float, str, type(None))


def checkpoint_group(fold_key: str, model_tag: str = "") -> str:
    """Prefix shared by every age of one fold's checkpoints."""
    return stable_digest(CHECKPOINT_SCHEMA, fold_key, model_tag)


def checkpoint_key(fold_key: str, model_tag: str = "",
                   age: int = 0) -> str:
    """(fold_key, model_tag, age) -> store key. Zero-padded age keeps
    lexicographic order == age order within a group's prefix scan."""
    return f"{checkpoint_group(fold_key, model_tag)}-a{int(age):08d}"


def key_age(key: str) -> int:
    """Age component of a `checkpoint_key` (raises on malformed)."""
    return int(key.rsplit("-a", 1)[1])


def manifest_key(replica_id: str) -> str:
    """Object-store key of one replica's orphan manifest. Digested so
    arbitrary replica ids stay filesystem-safe under the same backend
    the checkpoint mirrors live in, with a distinct prefix space from
    `checkpoint_group` (different schema string digests apart)."""
    return stable_digest(MANIFEST_SCHEMA, str(replica_id))


def read_manifest(backend, replica_id: str) -> Optional[dict]:
    """Decode one replica's published orphan manifest from the shared
    backend; None on miss or anything malformed (a torn/alien payload
    must read as 'no manifest', never crash a controller tick)."""
    if backend is None:
        return None
    try:
        data = backend.get(manifest_key(replica_id))
        if data is None:
            return None
        manifest = json.loads(data.decode("utf-8"))
    except Exception:
        return None
    if not isinstance(manifest, dict) \
            or manifest.get("schema") != MANIFEST_SCHEMA \
            or not isinstance(manifest.get("orphans"), list):
        return None
    return manifest


def clear_manifest(backend, replica_id: str) -> bool:
    """Drop a replica's manifest after its orphans were adopted (the
    controller's ack — re-reading on the next tick must find nothing,
    so adoption is idempotent across reconcile rounds)."""
    if backend is None:
        return False
    try:
        backend.delete(manifest_key(replica_id))
        return True
    except Exception:
        return False


# -- sharding specs --------------------------------------------------------


def sharding_spec(sharding) -> Optional[dict]:
    """Portable descriptor of a leaf's placement: a "named" spec for a
    `parallel.NamedSharding` or a DTensor (axes, sizes and the spec, as
    the JAX package writes it), None for anything else (a device)."""
    from alphafold2_tpu_torch.parallel.sharding import (NamedSharding,
                                                        active_mesh,
                                                        is_dtensor, spec_of)
    if is_dtensor(sharding):
        mesh = active_mesh()
        if mesh is None or mesh.device_mesh != sharding.device_mesh:
            return None
        sharding = NamedSharding(mesh, tuple(spec_of(sharding, mesh)))
    if not isinstance(sharding, NamedSharding):
        return None
    mesh = sharding.mesh
    return {"kind": "named", "axes": list(mesh.shape),
            "sizes": [int(v) for v in mesh.shape.values()],
            "spec": [list(p) if isinstance(p, (tuple, list)) else p
                     for p in tuple(sharding.spec)]}


def sharding_from_spec(desc: Optional[dict]):
    """A `parallel.NamedSharding` for a "named" spec, on a mesh over
    this process group's first ranks (every rank of the group calls
    this); None when the spec is absent or the group has too few ranks
    (default placement)."""
    if not desc or desc.get("kind") != "named":
        return None
    import torch.distributed as dist

    from alphafold2_tpu_torch.parallel.mesh import Mesh
    from alphafold2_tpu_torch.parallel.sharding import (NamedSharding,
                                                        PartitionSpec)
    sizes = [int(v) for v in desc["sizes"]]
    need = int(np.prod(sizes)) if sizes else 1
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < need:
        return None
    mesh = Mesh(np.arange(need).reshape(sizes), tuple(desc["axes"]))
    parts = [tuple(p) if isinstance(p, list) else p for p in desc["spec"]]
    return NamedSharding(mesh, PartitionSpec(*parts))


# -- the payload -----------------------------------------------------------


@dataclass
class RowCheckpoint:
    """One fold's mid-loop state: everything a resuming process needs
    to continue this row at `age` recycles, detached from the batch it
    was sharing. `leaves` holds the row's slice of the flattened step
    carry in `snapshot_step_state` order — ("dev", (1, ...) np array,
    placement spec) or ("ref", json-able scalar, None)."""

    fold_key: str
    model_tag: str
    age: int
    seq: np.ndarray                       # (L,) int32, unpadded
    msa: Optional[np.ndarray] = None      # (m, L) int32 or None
    leaves: List[tuple] = field(default_factory=list)
    created_s: float = 0.0

    @property
    def nbytes(self) -> int:
        n = self.seq.nbytes + (0 if self.msa is None else self.msa.nbytes)
        for kind, val, _spec in self.leaves:
            if kind == "dev":
                n += val.nbytes
        return n

    def state_entries(self, device=None) -> List[tuple]:
        """`restore_step_state`-shaped entries (kind, value, placement):
        each device leaf placed on `device` (None: the default device,
        the card), or on the `parallel.NamedSharding` its mesh spec
        gives (`sharding_from_spec`)."""
        return [(kind, val, sharding_from_spec(spec) or device
                 if kind == "dev" else None)
                for kind, val, spec in self.leaves]

    def restore_leaves(self, device=None) -> list:
        """Decoded leaves as tensors on `device` (None: the card, or a
        raise without one), through `predict.restore_step_state` over a
        flat list; a leaf with a mesh spec that fits this process group
        comes back as a DTensor placed by it; references pass through."""
        from alphafold2_tpu_torch import predict
        from alphafold2_tpu_torch.parallel.sharding import (NamedSharding,
                                                            place)
        entries = self.state_entries(device)
        named = {at: e[2] for at, e in enumerate(entries)
                 if isinstance(e[2], NamedSharding)}
        entries = [(k, v, named[at].mesh.device if at in named else d)
                   for at, (k, v, d) in enumerate(entries)]
        treedef = predict.tree_flatten([0] * len(entries))[1]
        leaves = list(predict.restore_step_state((treedef, entries)))
        for at, sharding in named.items():
            leaves[at] = place(leaves[at], sharding.mesh, sharding.spec)
        return leaves


def row_checkpoint(snapshot, row: int, *, fold_key: str,
                   model_tag: str, age: int, seq: np.ndarray,
                   msa: Optional[np.ndarray] = None,
                   clock=time.time) -> RowCheckpoint:
    """Slice row `row` out of a full-batch `snapshot_step_state`
    result. Raises ValueError when the carry is not row-sliceable (a
    dev leaf without a batch axis, or an opaque reference leaf the
    wire cannot carry) — the caller counts and skips the spill, it
    never writes a partial payload."""
    _treedef, entries = snapshot
    leaves: List[tuple] = []
    for kind, val, sharding in entries:
        if kind == "dev":
            arr = val
            if arr.ndim < 1 or arr.shape[0] <= row:
                raise ValueError(
                    f"carry leaf shape {arr.shape} has no row {row}")
            leaves.append(("dev", np.ascontiguousarray(arr[row:row + 1]),
                           sharding_spec(sharding)))
        else:
            if not isinstance(val, _REF_TYPES):
                raise ValueError(
                    f"opaque reference leaf {type(val).__name__} is "
                    f"not wire-able")
            leaves.append(("ref", val, None))
    return RowCheckpoint(
        fold_key=fold_key, model_tag=model_tag, age=int(age),
        seq=np.asarray(seq, np.int32),
        msa=None if msa is None else np.asarray(msa, np.int32),
        leaves=leaves, created_s=float(clock()))


# -- wire format -----------------------------------------------------------


def encode_checkpoint(key: str, ckpt: RowCheckpoint) -> bytes:
    """Self-identifying npz bytes — the disk tier, the peer
    `kind=checkpoint` route, and object-store mirrors all carry
    exactly these; every tier validates with `decode_checkpoint`."""
    meta = {"schema": CHECKPOINT_SCHEMA, "key": key,
            "fold_key": ckpt.fold_key, "model_tag": ckpt.model_tag,
            "age": int(ckpt.age), "created_s": float(ckpt.created_s),
            "msa": ckpt.msa is not None,
            "kinds": [kind for kind, _v, _s in ckpt.leaves],
            "shardings": [spec for kind, _v, spec in ckpt.leaves],
            "refs": {str(i): val
                     for i, (kind, val, _s) in enumerate(ckpt.leaves)
                     if kind == "ref"},
            "dtypes": [str(v.dtype) if kind == "dev" else None
                       for kind, v, _s in ckpt.leaves]}
    arrays = {"meta": np.frombuffer(
        json.dumps(meta).encode("utf-8"), np.uint8), "seq": ckpt.seq}
    if ckpt.msa is not None:
        arrays["msa"] = ckpt.msa
    for i, (kind, val, _spec) in enumerate(ckpt.leaves):
        if kind == "dev":
            arrays[f"leaf_{i:05d}"] = val
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode_checkpoint(key: str, data: bytes) -> RowCheckpoint:
    """Parse + validate `encode_checkpoint` bytes. Raises on anything
    wrong (unreadable, schema drift, key mismatch, leaf bookkeeping
    nonsense); callers translate into miss + quarantine. Model-tag
    POLICY (discard vs serve) stays with `CheckpointStore` — the codec
    only guarantees the payload says what it is."""
    with np.load(io.BytesIO(data)) as z:
        meta = json.loads(bytes(z["meta"]).decode("utf-8"))
        if meta.get("schema") != CHECKPOINT_SCHEMA:
            raise ValueError(f"checkpoint {key}: schema "
                             f"{meta.get('schema')!r}")
        if meta.get("key") != key:
            raise ValueError(f"checkpoint {key}: embedded key mismatch")
        kinds = list(meta["kinds"])
        shardings = list(meta["shardings"])
        refs = dict(meta.get("refs", {}))
        dtypes = list(meta.get("dtypes") or [None] * len(kinds))
        if len(shardings) != len(kinds):
            raise ValueError(f"checkpoint {key}: leaf bookkeeping "
                             f"mismatch")
        leaves: List[tuple] = []
        for i, kind in enumerate(kinds):
            if kind == "dev":
                arr = np.asarray(z[f"leaf_{i:05d}"])
                if dtypes[i] and str(arr.dtype) != dtypes[i]:
                    # npz round-trips extension dtypes (ml_dtypes
                    # bfloat16) as opaque void bytes — re-view through
                    # the recorded dtype string, byte-identical
                    arr = arr.view(_host_dtype(dtypes[i]))
                if arr.ndim < 1 or arr.shape[0] != 1:
                    raise ValueError(
                        f"checkpoint {key}: leaf {i} is not one row")
                leaves.append(("dev", arr, shardings[i]))
            elif kind == "ref":
                if str(i) not in refs:
                    raise ValueError(
                        f"checkpoint {key}: ref leaf {i} missing")
                leaves.append(("ref", refs[str(i)], None))
            else:
                raise ValueError(
                    f"checkpoint {key}: unknown leaf kind {kind!r}")
        ckpt = RowCheckpoint(
            fold_key=str(meta["fold_key"]),
            model_tag=str(meta["model_tag"]),
            age=int(meta["age"]),
            seq=np.asarray(z["seq"], np.int32),
            msa=(np.asarray(z["msa"], np.int32)
                 if meta.get("msa") else None),
            leaves=leaves, created_s=float(meta.get("created_s", 0.0)))
    if ckpt.age < 0 or ckpt.seq.ndim != 1:
        raise ValueError(f"checkpoint {key} fails validation")
    return ckpt


# -- the store -------------------------------------------------------------


class CheckpointStats:
    """Thread-safe outcome counters, mirrored into the registry as
    `fold_checkpoint_events_total{event=...}` (minted only when a
    store is constructed — a spill-off scheduler's metric-name set is
    untouched)."""

    FIELDS = ("spills", "spill_errors", "hits", "misses", "discards",
              "stale_tag_discards", "expirations", "disk_errors",
              "peer_hits", "backend_hits")

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)
        self._m_events = (registry or get_registry()).counter(
            "fold_checkpoint_events_total",
            "durable step-checkpoint store outcomes", ("event",))

    def bump(self, field: str, n: int = 1):
        with self._lock:
            setattr(self, field, getattr(self, field) + n)
        self._m_events.inc(n, event=field)

    def event(self, event: str, n: int = 1):
        """Registry-only event, no snapshot field: occasional lifecycle
        events (orphan sweeps) ride the same metric family without
        widening FIELDS — snapshot()'s schema is pinned."""
        self._m_events.inc(n, event=event)

    def snapshot(self) -> dict:
        with self._lock:
            return {f: getattr(self, f) for f in self.FIELDS}


class CheckpointStore:
    """Durable (fold_key, model_tag, age)-keyed row checkpoints over a
    ByteStore disk tier, with optional object-store mirror and peer
    fallback.

    disk_dir: the spill directory (the `RetryPolicy(checkpoint_spill=)`
        knob's value). Required — a memory-only durable store is a
        contradiction.
    model_tag: the serving model identity; `latest`/`survivors` DISCARD
        any decoded payload whose tag differs (counted
        `stale_tag_discards`) — a rolled-out model never continues an
        old model's carry.
    ttl_s: disk TTL; swept on scan as well as get, so boot discovery
        never resurrects a fold nobody has asked about for ttl_s.
    backend: optional `fleet.object_store.ObjectStoreBackend` mirror —
        one object per fold GROUP (latest age wins), so a shared
        volume serves fail-over resume with zero peer servers.
    peer: optional duck-typed `fetch_checkpoint(group, model_tag) ->
        bytes | None` consulted on local + backend miss.
    """

    def __init__(self, disk_dir: str, *, model_tag: str = "",
                 ttl_s: Optional[float] = None,
                 backend=None, peer=None,
                 registry: Optional[MetricsRegistry] = None,
                 clock=time.time):
        if not disk_dir:
            raise ValueError("CheckpointStore needs a disk_dir")
        self.model_tag = str(model_tag)
        self.backend = backend
        self.peer = peer
        self.stats = CheckpointStats(registry)
        self._clock = clock
        self.orphan_sweeps = 0         # groups GC'd by sweep_orphans
        self.store = ByteStore(
            encode=encode_checkpoint, decode=decode_checkpoint,
            max_bytes=0, max_entries=0,      # durable tier only
            ttl_s=ttl_s, disk_dir=disk_dir, clock=clock,
            on_event=self._on_store_event,
            quarantine_event="checkpoint_quarantine")

    def _on_store_event(self, fld: str, n: int = 1):
        if fld in ("expirations", "disk_errors"):
            self.stats.bump(fld, n)

    # -- keys --------------------------------------------------------------

    def group(self, fold_key: str) -> str:
        return checkpoint_group(fold_key, self.model_tag)

    # -- spill -------------------------------------------------------------

    def put_row(self, ckpt: RowCheckpoint) -> Optional[str]:
        """Spill one row checkpoint; prunes the group's older ages so
        the tier holds exactly the latest. Returns the store key, or
        None on failure (counted — a spill error must never fail the
        step loop it rode along with)."""
        try:
            key = checkpoint_key(ckpt.fold_key, self.model_tag,
                                 ckpt.age)
            self.store.disk_put(key, ckpt)
            prefix = self.group(ckpt.fold_key)
            for old in self.store.keys(prefix):
                if old != key:
                    self._remove(old)
            if self.backend is not None:
                try:
                    self.backend.put(prefix,
                                     encode_checkpoint(key, ckpt))
                except Exception:
                    pass               # mirror is best-effort
            self.stats.bump("spills")
            return key
        except Exception:
            self.stats.bump("spill_errors")
            return None

    # -- resume lookups ----------------------------------------------------

    def latest(self, fold_key: str,
               trace=NULL_TRACE) -> Optional[RowCheckpoint]:
        """Newest-age checkpoint for `fold_key` under THIS store's
        model tag: local disk, then the object-store mirror, then the
        peer tier. Stale-tag payloads (possible through mirror/peer
        bytes, impossible through local keys) are discarded."""
        prefix = self.group(fold_key)
        keys = self.store.keys(prefix)
        if keys:
            key = max(keys, key=key_age)
            hit = self.store.disk_get(key, trace)
            if hit is not None:
                ckpt, _expires = hit
                if self._tag_ok(ckpt):
                    self.stats.bump("hits")
                    return ckpt
                self._remove(key)
        for source, fetch in (("backend", self._backend_fetch),
                              ("peer", self._peer_fetch)):
            ckpt = fetch(fold_key, prefix, trace)
            if ckpt is not None:
                self.stats.bump(f"{source}_hits")
                self.stats.bump("hits")
                # promote: a migrated fold's next spill/discard is local
                self.put_row(ckpt)
                return ckpt
        self.stats.bump("misses")
        return None

    def _backend_fetch(self, fold_key: str, prefix: str,
                       trace) -> Optional[RowCheckpoint]:
        if self.backend is None:
            return None
        try:
            data = self.backend.get(prefix)
            if data is None:
                return None
            ckpt = decode_checkpoint(
                checkpoint_key(fold_key, self.model_tag,
                               _peek_age(data)), data)
        except Exception:
            # shared-store quarantine analogue: a corrupt object costs
            # every replica a failed parse until someone deletes it
            try:
                self.backend.delete(prefix)
            except Exception:
                pass
            self.stats.bump("disk_errors")
            return None
        if not self._tag_ok(ckpt) or ckpt.fold_key != fold_key:
            try:
                self.backend.delete(prefix)
            except Exception:
                pass
            return None
        trace.event("peer_fetch", peer="object_store", outcome="hit")
        return ckpt

    def _peer_fetch(self, fold_key: str, prefix: str,
                    trace) -> Optional[RowCheckpoint]:
        if self.peer is None:
            return None
        try:
            data = self.peer.fetch_checkpoint(prefix, self.model_tag)
            if data is None:
                return None
            ckpt = decode_checkpoint(
                checkpoint_key(fold_key, self.model_tag,
                               _peek_age(data)), data)
        except Exception:
            return None
        if not self._tag_ok(ckpt) or ckpt.fold_key != fold_key:
            return None
        return ckpt

    def latest_raw(self, group: str) -> Optional[bytes]:
        """Raw wire bytes of a group's newest checkpoint — the peer
        server's read path (`kind=checkpoint`), mirroring
        `FoldCache.read_raw`: the serving side never decodes."""
        keys = self.store.keys(group)
        if not keys:
            return None
        try:
            with open(self.store.path(max(keys, key=key_age)),
                      "rb") as fh:
                return fh.read()
        except OSError:
            return None

    # -- lifecycle ---------------------------------------------------------

    def discard(self, fold_key: str):
        """Drop every age of one fold (resolved, cancelled, or
        poisoned: the checkpoint must not outlive the work)."""
        prefix = self.group(fold_key)
        removed = 0
        for key in self.store.keys(prefix):
            removed += self._remove(key)
        if self.backend is not None:
            try:
                self.backend.delete(prefix)
            except Exception:
                pass
        if removed:
            self.stats.bump("discards", removed)

    def sweep_orphans(self, terminal_fold_keys) -> int:
        """GC beyond TTL: drop every checkpoint group whose
        fold key is in `terminal_fold_keys` — folds the ledger or the
        quarantine already recorded as finished for good (served,
        poisoned, permanently failed). TTL alone can strand these for
        hours: a bulk campaign's served fold has no reason to keep its
        mid-loop carry on disk until the clock runs out, and a
        quarantined key's checkpoint would only ever resume into
        another poisoning. Returns the number of GROUPS swept; counted
        as `fold_checkpoint_events_total{event="orphan_sweep"}` (the
        removed files themselves land in the ordinary `discards`
        counter via discard())."""
        swept = 0
        for fold_key in terminal_fold_keys:
            if not self.store.keys(self.group(fold_key)):
                continue
            self.discard(fold_key)
            swept += 1
        if swept:
            self.orphan_sweeps += swept
            self.stats.event("orphan_sweep", swept)
        return swept

    def survivors(self, trace=NULL_TRACE
                  ) -> Iterator[Tuple[str, RowCheckpoint]]:
        """Boot-time discovery: every (store_key, checkpoint) the disk
        tier holds under THIS model tag, newest age per group. Expired
        entries are swept by the scan itself; decoded payloads whose
        tag mismatches (an old tag's leftovers after a rollout) are
        discarded + counted, never yielded — a restarted replica can
        trust every survivor it sees."""
        newest: dict = {}
        for key in self.store.keys():
            group = key.rsplit("-a", 1)[0]
            prev = newest.get(group)
            if prev is None or key_age(key) > key_age(prev):
                newest[group] = key
        for group in sorted(newest):
            key = newest[group]
            hit = self.store.disk_get(key, trace)
            if hit is None:
                continue
            ckpt, _expires = hit
            if not self._tag_ok(ckpt):
                for stale in self.store.keys(group):
                    self._remove(stale)
                continue
            yield key, ckpt

    # -- orphan manifest -------------------------------------------------

    def publish_manifest(self, replica_id: str) -> Optional[dict]:
        """Preemption hand-off: enumerate every resumable survivor this
        store holds (newest age per group, current tag), make sure each
        is mirrored to the shared backend, and publish one JSON
        manifest under `manifest_key(replica_id)` so the controller can
        assign the orphans to a live survivor. Also written as a
        sibling disk file next to the checkpoints (debuggability: the
        spill directory is self-describing post-mortem). Returns the
        manifest dict, or None when there is nothing to hand off —
        publishing an empty manifest would only make every controller
        tick pay a read for a replica that owed nobody anything."""
        orphans = []
        for key, ckpt in self.survivors():
            group = key.rsplit("-a", 1)[0]
            if self.backend is not None:
                # spills mirror on put_row, but the backend may have
                # been attached after early spills — re-mirror so the
                # adopter's backend fetch cannot miss what we advertise
                try:
                    self.backend.put(group, encode_checkpoint(key, ckpt))
                except Exception:
                    pass
            orphans.append({"group": group,
                            "fold_key": ckpt.fold_key,
                            "age": int(ckpt.age),
                            "model_tag": ckpt.model_tag})
        if not orphans:
            return None
        manifest = {"schema": MANIFEST_SCHEMA,
                    "replica_id": str(replica_id),
                    "model_tag": self.model_tag,
                    "published_s": float(self._clock()),
                    "orphans": orphans}
        data = json.dumps(manifest).encode("utf-8")
        if self.backend is not None:
            try:
                self.backend.put(manifest_key(replica_id), data)
            except Exception:
                self.stats.bump("disk_errors")
        try:
            import os
            path = os.path.join(self.store.disk_dir,
                                f"orphans-{manifest_key(replica_id)}.json")
            tmp = path + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(data)
            os.replace(tmp, path)
        except OSError:
            pass                  # the sibling copy is best-effort
        self.stats.event("manifest_published")
        return manifest

    # -- plumbing ----------------------------------------------------------

    def _tag_ok(self, ckpt: RowCheckpoint) -> bool:
        if ckpt.model_tag == self.model_tag:
            return True
        self.stats.bump("stale_tag_discards")
        return False

    def _remove(self, key: str) -> int:
        import os
        try:
            os.remove(self.store.path(key))
            return 1
        except OSError:
            return 0

    def snapshot(self) -> dict:
        out = {"model_tag": self.model_tag,
               "disk_dir": self.store.disk_dir,
               "resident_keys": len(self.store.keys()),
               "stats": self.stats.snapshot()}
        if self.orphan_sweeps:
            # only after a sweep: a GC-less store's snapshot keeps its
            # keys
            out["orphan_sweeps"] = self.orphan_sweeps
        return out


def _host_dtype(name: str) -> np.dtype:
    """numpy dtype of a recorded dtype string; "bfloat16" comes from
    ml_dtypes (numpy has none)."""
    if name == "bfloat16":
        import ml_dtypes
        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(name)


def _peek_age(data: bytes) -> int:
    """Age embedded in wire bytes (needed to reconstruct the exact
    store key a mirrored/peer payload was encoded under, so the codec's
    embedded-key check still bites on those tiers)."""
    with np.load(io.BytesIO(data)) as z:
        return int(json.loads(bytes(z["meta"]).decode("utf-8"))["age"])
