"""Fold result store: in-memory LRU over optional disk and peer tiers
(counterpart of `alphafold2_tpu/cache/store.py`; the `.npz` entries of
`encode_fold` are the JAX package's, so a directory written by either
package reads as hits in the other).

The memory tier is a byte-budgeted LRU. The disk tier is one `.npz` per
key under a 2-hex-char fan-out, written atomically (tmp file +
`os.replace`). Anything wrong with a disk entry — unreadable npz,
missing fields, key mismatch, shape nonsense — is a miss and the file is
quarantined (renamed `*.quarantined`), never re-read and never raised:
a corrupt cache costs a recompute, not an outage. Quarantine also drops
any resident copy of the key with its `bytes_resident` accounting.

`peer` mounts a third tier below disk (memory -> disk -> peer): any
object with `get(key, trace=) -> Optional[CachedFold]`, such as
`fleet.object_store.ObjectStorePeer` over a shared volume. A peer hit is
validated by `decode_fold` and promoted into the local memory and disk
tiers; `peer_write_through=True` also pushes local puts to
`peer.put()`. Off by default.

Expiry is TTL-based (wall clock at put time, both tiers) plus
max-entries / max-bytes LRU eviction in memory. `CacheStats` counts
every outcome into `fold_cache_events_total{event=...}`, the JAX
package's metric name; `snapshot()` is the JSON-ready health view.
"""

from __future__ import annotations

import io
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from alphafold2_tpu_torch.cache.bytestore import ByteStore
from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry
from alphafold2_tpu_torch.obs.trace import NULL_TRACE


@dataclass
class CachedFold:
    """One stored result: exact-length (unpadded) arrays, always copies."""

    coords: np.ndarray       # (n, 3) float32
    confidence: np.ndarray   # (n,) float32

    @property
    def nbytes(self) -> int:
        return int(self.coords.nbytes + self.confidence.nbytes)


def encode_fold(key: str, value: CachedFold) -> bytes:
    """One cached fold as self-identifying npz bytes — THE wire/disk
    format: the disk tier, the peer HTTP protocol, and object-store
    backends all carry exactly these bytes, so every tier validates
    with the same `decode_fold`."""
    buf = io.BytesIO()
    np.savez(buf, coords=value.coords, confidence=value.confidence,
             key=np.frombuffer(key.encode("utf-8"), np.uint8))
    return buf.getvalue()


def decode_fold(key: str, data: bytes) -> CachedFold:
    """Parse + validate `encode_fold` bytes. Raises on anything wrong
    (unreadable, key mismatch, shape nonsense); callers translate that
    into their tier's miss/quarantine semantics."""
    with np.load(io.BytesIO(data)) as z:
        stored_key = bytes(z["key"]).decode("utf-8")
        value = CachedFold(
            coords=np.asarray(z["coords"], np.float32),
            confidence=np.asarray(z["confidence"], np.float32))
    if (stored_key != key or value.coords.ndim != 2
            or value.coords.shape[1] != 3
            or value.confidence.shape != (value.coords.shape[0],)):
        raise ValueError(f"cache entry {key} fails validation")
    return value


class CacheStats:
    """Thread-safe counters for every cache outcome.

    Every bump is mirrored into the process-wide metrics registry
    (`fold_cache_events_total{event=...}`), so all FoldCache instances
    in a process add up under one Prometheus series while each
    instance's `snapshot()` stays its own."""

    FIELDS = ("hits", "misses", "puts", "evictions", "expirations",
              "disk_hits", "disk_errors", "peer_hits", "peer_errors")

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)
        self._m_events = (registry or get_registry()).counter(
            "fold_cache_events_total",
            "result-store outcomes across all FoldCache instances",
            ("event",))

    def bump(self, field: str, n: int = 1):
        with self._lock:
            setattr(self, field, getattr(self, field) + n)
        self._m_events.inc(n, event=field)

    @property
    def hit_ratio(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            out = {f: getattr(self, f) for f in self.FIELDS}
        total = out["hits"] + out["misses"]
        out["hit_ratio"] = out["hits"] / total if total else 0.0
        return out


class FoldCache:
    """Content-addressed fold cache (memory LRU + optional disk + peer).

    The memory/disk/quarantine machinery is `cache.bytestore.ByteStore`
    parameterized on `encode_fold`/`decode_fold` (shared with
    `cache.features.FeatureCache`); this class owns what a fold store
    adds — hit/miss stats into `fold_cache_events_total`,
    registry residency gauges, the peer tier, the fault-injection hook,
    and the peer-serving `read_raw`.

    max_bytes / max_entries bound the memory tier only; the disk tier
    is bounded by TTL (and by whoever owns the directory). ttl_s=None
    disables expiry. `clock` is injectable for tests.

    peer: optional third tier consulted after a disk miss — any object
        with `get(key, trace=) -> Optional[CachedFold]` that never lets
        an exception escape as anything but a miss (fleet.PeerCacheClient,
        fleet.ObjectStorePeer). A peer hit is promoted into memory and
        disk with a fresh TTL (the peer already refuses entries expired
        on ITS clock, so a value's total lifetime is bounded by one TTL
        per tier hop, not unbounded bouncing).
    peer_write_through: also push local puts to `peer.put(key, value)`
        when the peer supports it (shared-volume object stores).
    """

    def __init__(self, max_bytes: int = 256 << 20, max_entries: int = 4096,
                 ttl_s: Optional[float] = None,
                 disk_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.time,
                 registry: Optional[MetricsRegistry] = None,
                 peer=None, peer_write_through: bool = False,
                 faults=None):
        self.peer = peer
        self.peer_write_through = bool(peer_write_through)
        # optional fault plan with `corrupt_cache_bytes(key, data)`:
        # corrupts disk bytes BEFORE validation, so injected corruption
        # exercises exactly the quarantine path a real bit-rotted entry
        # would
        self.faults = faults
        reg = registry or get_registry()
        self.stats = CacheStats(registry=reg)
        self._m_bytes = reg.gauge(
            "fold_cache_bytes_resident",
            "memory-tier resident bytes (last-reporting store)")
        self._m_entries = reg.gauge(
            "fold_cache_entries_resident",
            "memory-tier resident entries (last-reporting store)")

        def _resize(nbytes, entries):
            self._m_bytes.set(nbytes)
            self._m_entries.set(entries)

        self._store = ByteStore(
            encode=encode_fold, decode=decode_fold,
            max_bytes=max_bytes, max_entries=max_entries, ttl_s=ttl_s,
            disk_dir=disk_dir, clock=clock,
            on_event=self.stats.bump, on_resize=_resize,
            # read self.faults at call time: the plan may be armed or
            # swapped after construction
            corrupt=lambda key, data: (
                data if self.faults is None
                else self.faults.corrupt_cache_bytes(key, data)),
            quarantine_event="cache_quarantine")

    # sizing/config views delegate to the one store
    @property
    def max_bytes(self) -> int:
        return self._store.max_bytes

    @property
    def max_entries(self) -> int:
        return self._store.max_entries

    @property
    def ttl_s(self) -> Optional[float]:
        return self._store.ttl_s

    @property
    def disk_dir(self) -> Optional[str]:
        return self._store.disk_dir

    # -- tier internals (delegated; the names remain because tests and
    # -- operational tooling reach for them directly) ---------------------

    def _mem_get(self, key: str) -> Optional[CachedFold]:
        return self._store.mem_get(key)

    def _mem_put(self, key: str, value: CachedFold,
                 expires_at: Optional[float] = None):
        self._store.mem_put(key, value, expires_at=expires_at)

    def _mem_drop(self, key: str) -> bool:
        return self._store.mem_drop(key)

    def _path(self, key: str) -> str:
        return self._store.path(key)

    def _quarantine(self, path: str, key: Optional[str] = None,
                    trace=NULL_TRACE):
        self._store.quarantine(path, key, trace)

    def _disk_get(self, key: str, trace=NULL_TRACE):
        """Returns (value, expires_at) or None."""
        return self._store.disk_get(key, trace)

    def _disk_put(self, key: str, value: CachedFold):
        self._store.disk_put(key, value)

    # -- public API ------------------------------------------------------

    def get(self, key: str, trace=NULL_TRACE,
            peer: bool = True) -> Optional[CachedFold]:
        """Lookup; never raises. Tier order memory -> disk -> peer;
        lower-tier hits are promoted upward (a peer hit lands in memory
        AND disk, so the fleet converges instead of re-fetching).
        `peer=False` skips the network tier — the scheduler passes it
        for keys it is about to FORWARD to their owner (the owner's
        cache answers at the forwarded submit; a guaranteed-miss HTTP
        round trip first, worst case a full peer timeout when the
        owner is down, would only delay the hop). `trace` (obs.Trace;
        zero-cost NULL_TRACE default) receives cache_hit / cache_miss /
        cache_quarantine events plus a `peer_fetch` span so a request
        trace shows where its result came from."""
        hit = self._store.lookup(key, trace)
        value = tier = None
        if hit is not None:
            value, tier = hit
            if tier == "disk":
                self.stats.bump("disk_hits")
        if value is None and peer and self.peer is not None:
            value = self._peer_get(key, trace)
            if value is not None:
                tier = "peer"
        if value is None:
            self.stats.bump("misses")
            trace.event("cache_miss")
            return None
        self.stats.bump("hits")
        trace.event("cache_hit", tier=tier)
        return value

    def _peer_get(self, key: str, trace=NULL_TRACE) -> Optional[CachedFold]:
        """Consult the peer tier; any trouble degrades to a miss (a
        partitioned fleet must cost recomputes, never outages)."""
        try:
            with trace.span("peer_fetch"):
                value = self.peer.get(key, trace=trace)
        except Exception:
            self.stats.bump("peer_errors")
            return None
        if value is None:
            return None
        self.stats.bump("peer_hits")
        self._mem_put(key, value)
        if self.disk_dir:
            self._disk_put(key, value)
        return value

    def put(self, key: str, coords, confidence) -> CachedFold:
        """Store one result (copies taken; never raises past stats)."""
        value = CachedFold(
            coords=np.array(coords, np.float32, copy=True),
            confidence=np.array(confidence, np.float32, copy=True))
        self.stats.bump("puts")
        self._mem_put(key, value)
        if self.disk_dir:
            self._disk_put(key, value)
        if self.peer_write_through and self.peer is not None \
                and hasattr(self.peer, "put"):
            try:
                self.peer.put(key, value)
            except Exception:
                self.stats.bump("peer_errors")
        return value

    def read_raw(self, key: str) -> Optional[bytes]:
        """The key's entry as `encode_fold` bytes, or None — what a
        `fleet.PeerCacheServer` sends to a fetching peer. Serves from
        memory when resident (no disk round-trip on the hot set);
        otherwise reads and VALIDATES the disk file before shipping it
        (a corrupt entry is quarantined — including dropping any
        memory-resident copy with its bytes accounting — never sent:
        the peer protocol's trust model starts at the sender). Does not
        consult this cache's own peer tier (peers answer for what THEY
        hold; fan-out chains would re-introduce unbounded forwarding).
        TTL semantics match `get`."""
        value = self._mem_get(key)
        if value is not None:
            return encode_fold(key, value)
        if not self.disk_dir:
            return None
        hit = self._disk_get(key)
        if hit is None:
            return None
        value, expires_at = hit
        self._mem_put(key, value, expires_at=expires_at)
        return encode_fold(key, value)

    def invalidate(self, key: str) -> bool:
        """Drop `key` from the local tiers (memory accounting included;
        the disk file is removed, not quarantined — invalidation is
        policy, not corruption). Returns True when anything was held."""
        dropped = self._mem_drop(key)
        if self.disk_dir:
            try:
                os.remove(self._path(key))
                dropped = True
            except OSError:
                pass
        return dropped

    # -- views -----------------------------------------------------------

    @property
    def bytes_resident(self) -> int:
        return self._store.bytes_resident

    def __len__(self) -> int:
        return len(self._store)

    def snapshot(self) -> dict:
        out = self.stats.snapshot()
        out["entries_resident"] = len(self._store)
        out["bytes_resident"] = self._store.bytes_resident
        out["max_bytes"] = self.max_bytes
        out["max_entries"] = self.max_entries
        out["ttl_s"] = self.ttl_s
        out["disk_dir"] = self.disk_dir
        out["peer"] = (None if self.peer is None
                       else type(self.peer).__name__)
        return out
