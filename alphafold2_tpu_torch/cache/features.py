"""Feature store: the cache tier upstream of the fold cache (counterpart
of `alphafold2_tpu/cache/features.py`; same entries on disk).

The host-side feature work (tokenize, MSA prep) is pure in the raw
input: the same sequence + raw MSA featurizes to the same arrays no
matter which fold config, model tag or recycle count consumes them. So
features get their own content-addressed tier keyed by
`cache.keys.feature_key`, and feature traffic dedups independently of
fold traffic.

The same architecture and trust model as the fold-result store: both
rest on `cache.bytestore.ByteStore`, here parameterized on
`encode_features`/`decode_features`; anything wrong with a disk entry is
a miss and the file is quarantined. No peer tier. Outcomes count into
`feature_cache_events_total{event=...}`, the JAX package's name.
"""

from __future__ import annotations

import io
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from alphafold2_tpu_torch.cache.bytestore import ByteStore
from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry
from alphafold2_tpu_torch.obs.trace import NULL_TRACE


@dataclass
class FeaturizedInput:
    """One featurized raw job: the arrays `serve.FoldRequest` consumes.
    Always exact-length (unpadded) copies — padding/bucketing stays the
    fold scheduler's job."""

    seq: np.ndarray                       # (n,) int32 tokens
    msa: Optional[np.ndarray] = None      # (m, n) int32 tokens

    @property
    def nbytes(self) -> int:
        return int(self.seq.nbytes
                   + (0 if self.msa is None else self.msa.nbytes))


def encode_features(key: str, value: FeaturizedInput) -> bytes:
    """One featurized input as self-identifying npz bytes — the disk
    format, validated on read with the same `decode_features` every
    tier shares (mirrors cache.store.encode_fold)."""
    buf = io.BytesIO()
    arrays = {"seq": np.asarray(value.seq, np.int32),
              "key": np.frombuffer(key.encode("utf-8"), np.uint8)}
    if value.msa is not None:
        arrays["msa"] = np.asarray(value.msa, np.int32)
    np.savez(buf, **arrays)
    return buf.getvalue()


def decode_features(key: str, data: bytes) -> FeaturizedInput:
    """Parse + validate `encode_features` bytes. Raises on anything
    wrong (unreadable, key mismatch, shape nonsense); callers translate
    that into miss/quarantine semantics."""
    with np.load(io.BytesIO(data)) as z:
        stored_key = bytes(z["key"]).decode("utf-8")
        value = FeaturizedInput(
            seq=np.asarray(z["seq"], np.int32),
            msa=(np.asarray(z["msa"], np.int32)
                 if "msa" in z.files else None))
    if (stored_key != key or value.seq.ndim != 1
            or value.seq.shape[0] == 0
            or (value.msa is not None
                and (value.msa.ndim != 2
                     or value.msa.shape[1] != value.seq.shape[0]))):
        raise ValueError(f"feature entry {key} fails validation")
    return value


class FeatureCache:
    """Content-addressed featurized-input cache (memory LRU + disk).

    The memory/disk/quarantine machinery is `cache.bytestore.ByteStore`
    parameterized on `encode_features`/`decode_features` (shared with
    `cache.store.FoldCache`); this class owns the feature-specific
    counters and trace events.

    max_bytes / max_entries bound the memory tier; the disk tier is
    bounded by TTL (and the directory's owner). ttl_s=None disables
    expiry. `clock` is injectable for tests. Outcome counters mirror
    into the process registry as `feature_cache_events_total{event=}` —
    a distinct series from the fold store's `fold_cache_events_total`,
    because the two tiers' hit ratios answer different capacity
    questions (feature-pool sizing vs accelerator sizing).
    """

    def __init__(self, max_bytes: int = 64 << 20, max_entries: int = 8192,
                 ttl_s: Optional[float] = None,
                 disk_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.time,
                 registry: Optional[MetricsRegistry] = None):
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.expirations = 0
        self.disk_hits = 0
        self.disk_errors = 0
        self._m_events = (registry or get_registry()).counter(
            "feature_cache_events_total",
            "feature-store outcomes across all FeatureCache instances",
            ("event",))
        self._store = ByteStore(
            encode=encode_features, decode=decode_features,
            max_bytes=max_bytes, max_entries=max_entries, ttl_s=ttl_s,
            disk_dir=disk_dir, clock=clock, on_event=self._bump,
            quarantine_event="feature_quarantine")

    def _bump(self, field: str, n: int = 1):
        with self._lock:
            setattr(self, field, getattr(self, field) + n)
        self._m_events.inc(n, event=field)

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

    # -- tier internals (delegated; names kept for tests/tooling) --------

    def _mem_get(self, key: str) -> Optional[FeaturizedInput]:
        return self._store.mem_get(key)

    def _mem_put(self, key: str, value: FeaturizedInput,
                 expires_at: Optional[float] = None):
        self._store.mem_put(key, value, expires_at=expires_at)

    def _path(self, key: str) -> str:
        return self._store.path(key)

    def _quarantine(self, path: str, key: str, trace=NULL_TRACE):
        self._store.quarantine(path, key, trace)

    def _disk_get(self, key: str, trace=NULL_TRACE):
        """Returns (value, expires_at) or None."""
        return self._store.disk_get(key, trace)

    def _disk_put(self, key: str, value: FeaturizedInput):
        self._store.disk_put(key, value)

    # -- public API ------------------------------------------------------

    def get(self, key: str, trace=NULL_TRACE) -> Optional[FeaturizedInput]:
        """Lookup; never raises. memory -> disk, disk hits promoted."""
        hit = self._store.lookup(key, trace)
        if hit is None:
            self._bump("misses")
            trace.event("feature_miss")
            return None
        value, tier = hit
        if tier == "disk":
            self._bump("disk_hits")
        self._bump("hits")
        trace.event("feature_hit", tier=tier)
        return value

    def put(self, key: str, seq, msa=None) -> FeaturizedInput:
        """Store one featurized input (copies taken; never raises past
        the disk-error counter)."""
        value = FeaturizedInput(
            seq=np.array(seq, np.int32, copy=True),
            msa=None if msa is None else np.array(msa, np.int32,
                                                  copy=True))
        self._bump("puts")
        self._mem_put(key, value)
        if self.disk_dir:
            self._disk_put(key, value)
        return value

    # -- views -----------------------------------------------------------

    @property
    def bytes_resident(self) -> int:
        return self._store.bytes_resident

    def __len__(self) -> int:
        return len(self._store)

    @property
    def hit_ratio(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            out = {f: getattr(self, f)
                   for f in ("hits", "misses", "puts", "evictions",
                             "expirations", "disk_hits", "disk_errors")}
        out["entries_resident"] = len(self._store)
        out["bytes_resident"] = self._store.bytes_resident
        total = out["hits"] + out["misses"]
        out["hit_ratio"] = out["hits"] / total if total else 0.0
        out["max_bytes"] = self.max_bytes
        out["max_entries"] = self.max_entries
        out["ttl_s"] = self.ttl_s
        out["disk_dir"] = self.disk_dir
        return out
