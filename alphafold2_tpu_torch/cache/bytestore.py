"""The generic byte-budgeted store under every cache tier (counterpart
of `alphafold2_tpu/cache/bytestore.py`; the disk layout is the JAX
package's, so one directory serves both packages).

A byte-budgeted in-memory LRU with TTL expiry over an optional
atomic-write on-disk `.npz` tier whose corrupt entries are quarantined
(`*.quarantined`), never re-read, and never raised into the caller.
Parameterized on what the tiers differ in:

- `encode(key, value) -> bytes` / `decode(key, data) -> value`: the
  self-identifying npz wire format and its validation (decode raises on
  anything wrong; the store translates that into miss + quarantine);
- `value.nbytes`: the memory budget unit;
- `on_event(field, n)`: counter fan-out ("expirations", "evictions",
  "disk_errors") into the owner's stats;
- `on_resize(bytes, entries)`: gauge fan-out after any memory-tier
  mutation;
- `corrupt(key, data) -> data`: optional fault-injection hook applied to
  disk bytes before validation;
- `quarantine_event`: the trace event name ("cache_quarantine" /
  "feature_quarantine" / "checkpoint_quarantine").

Hit/miss accounting and any peer tier stay with the owner, which
composes `lookup()` (memory -> disk with promotion) with whatever sits
below. LRU by max_entries and max_bytes, a 0 budget disables the memory
tier, TTL measured from write time with disk promotions carrying the
original expiry, atomic disk writes via tmp + `os.replace`, quarantine
reconciling any memory-resident copy with its byte accounting.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional, Tuple

from alphafold2_tpu_torch.obs.trace import NULL_TRACE

QUARANTINE_SUFFIX = ".quarantined"


class _Entry:
    __slots__ = ("value", "expires_at")

    def __init__(self, value, expires_at: Optional[float]):
        self.value = value
        self.expires_at = expires_at


def _noop_event(field: str, n: int = 1):
    pass


def _noop_resize(nbytes: int, entries: int):
    pass


class ByteStore:
    """Byte-budgeted memory LRU + TTL over an optional atomic-write
    disk tier with quarantine. See the module docstring; thread-safe.
    Values must expose `.nbytes`."""

    def __init__(self, *, encode: Callable[[str, object], bytes],
                 decode: Callable[[str, bytes], object],
                 max_bytes: int, max_entries: int,
                 ttl_s: Optional[float] = None,
                 disk_dir: Optional[str] = None,
                 clock: Callable[[], float] = time.time,
                 on_event: Optional[Callable] = None,
                 on_resize: Optional[Callable] = None,
                 corrupt: Optional[Callable] = None,
                 quarantine_event: str = "cache_quarantine"):
        if max_bytes < 0 or max_entries < 0:
            raise ValueError("max_bytes and max_entries must be >= 0")
        self.encode = encode
        self.decode = decode
        self.max_bytes = int(max_bytes)
        self.max_entries = int(max_entries)
        self.ttl_s = ttl_s
        self.disk_dir = disk_dir
        self._clock = clock
        self._on_event = on_event or _noop_event
        self._on_resize = on_resize or _noop_resize
        self._corrupt = corrupt
        self._quarantine_event = quarantine_event
        self._lock = threading.Lock()
        self._mem: "OrderedDict[str, _Entry]" = OrderedDict()
        self._bytes = 0
        if disk_dir:
            os.makedirs(disk_dir, exist_ok=True)

    # -- memory tier -----------------------------------------------------

    def mem_get(self, key: str):
        now = self._clock()
        with self._lock:
            entry = self._mem.get(key)
            if entry is None:
                return None
            if entry.expires_at is not None and now >= entry.expires_at:
                del self._mem[key]
                self._bytes -= entry.value.nbytes
                self._on_event("expirations")
                self._on_resize(self._bytes, len(self._mem))
                return None
            self._mem.move_to_end(key)
            return entry.value

    def mem_put(self, key: str, value, expires_at: Optional[float] = None):
        """expires_at overrides the fresh-write TTL — disk promotions
        pass the ORIGINAL write time's expiry so a value can never live
        past write_time + ttl_s by bouncing between tiers."""
        if self.max_entries == 0 or self.max_bytes == 0:
            return
        if expires_at is None:
            expires_at = (None if self.ttl_s is None
                          else self._clock() + self.ttl_s)
        with self._lock:
            old = self._mem.pop(key, None)
            if old is not None:
                self._bytes -= old.value.nbytes
            self._mem[key] = _Entry(value, expires_at)
            self._bytes += value.nbytes
            while self._mem and (len(self._mem) > self.max_entries
                                 or self._bytes > self.max_bytes):
                _, evicted = self._mem.popitem(last=False)
                self._bytes -= evicted.value.nbytes
                self._on_event("evictions")
            self._on_resize(self._bytes, len(self._mem))

    def mem_drop(self, key: str) -> bool:
        """Remove a memory-resident entry WITH its byte accounting.
        Every invalidation path (quarantine, explicit invalidate) must
        come through here: popping from `_mem` without the byte
        decrement leaks resident-byte accounting until restart."""
        with self._lock:
            entry = self._mem.pop(key, None)
            if entry is None:
                return False
            self._bytes -= entry.value.nbytes
            self._on_resize(self._bytes, len(self._mem))
            return True

    # -- disk tier -------------------------------------------------------

    def path(self, key: str) -> str:
        return os.path.join(self.disk_dir, key[:2], f"{key}.npz")

    def quarantine(self, path: str, key: Optional[str] = None,
                   trace=NULL_TRACE):
        self._on_event("disk_errors")
        trace.event(self._quarantine_event)
        if key is not None:
            # the durable copy of `key` failed validation: drop any
            # memory-resident copy too (reconciling resident bytes) so
            # a poisoned key costs one clean recompute, not a tier that
            # keeps serving while its backing entry is quarantined
            self.mem_drop(key)
        try:
            os.replace(path, path + QUARANTINE_SUFFIX)
        except OSError:
            pass                       # racing quarantiners: either wins

    def disk_get(self, key: str, trace=NULL_TRACE
                 ) -> Optional[Tuple[object, Optional[float]]]:
        """Returns (value, expires_at) or None."""
        path = self.path(key)
        try:
            if not os.path.exists(path):
                return None
            expires_at = None
            if self.ttl_s is not None:
                expires_at = os.path.getmtime(path) + self.ttl_s
                if self._clock() >= expires_at:
                    self._on_event("expirations")
                    try:
                        os.remove(path)
                    except OSError:
                        pass
                    return None
        except OSError:
            return None
        try:
            with open(path, "rb") as fh:
                data = fh.read()
            if self._corrupt is not None:
                data = self._corrupt(key, data)
            value = self.decode(key, data)
        except Exception:              # unreadable/garbage/wrong entry
            self.quarantine(path, key, trace)
            return None
        return value, expires_at

    def disk_put(self, key: str, value):
        path = self.path(key)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(tmp, "wb") as fh:
                fh.write(self.encode(key, value))
            os.replace(tmp, path)      # atomic: readers see old or new
        except Exception:
            self._on_event("disk_errors")
            try:
                os.remove(tmp)
            except OSError:
                pass

    # -- disk iteration ---------------------------------------------------

    def keys(self, prefix: str = ""):
        """Keys present in the DISK tier (sorted), optionally filtered
        by prefix (boot-time discovery: a restarted replica enumerates
        what survived it). Expired entries are swept here, not just
        skipped, so a scan cannot resurrect a stale key; quarantined
        files never enumerate."""
        if not self.disk_dir:
            return []
        now = self._clock()
        out = []
        # fan-out dirs are key[:2]; a prefix >= 2 chars pins the dir
        subdirs = ([prefix[:2]] if len(prefix) >= 2
                   else sorted(d for d in self._listdir(self.disk_dir)
                               if len(d) == 2))
        for sub in subdirs:
            root = os.path.join(self.disk_dir, sub)
            for name in sorted(self._listdir(root)):
                if not name.endswith(".npz"):
                    continue           # quarantined / tmp leftovers
                key = name[:-len(".npz")]
                if prefix and not key.startswith(prefix):
                    continue
                path = os.path.join(root, name)
                if self.ttl_s is not None:
                    try:
                        if now >= os.path.getmtime(path) + self.ttl_s:
                            self._on_event("expirations")
                            try:
                                os.remove(path)
                            except OSError:
                                pass
                            continue
                    except OSError:
                        continue       # raced a concurrent sweep
                out.append(key)
        return out

    def scan(self, prefix: str = "", trace=NULL_TRACE):
        """Iterate (key, value) over the disk tier, optionally
        prefix-filtered. Rides `keys()` so expired entries are swept,
        and `disk_get` so corrupt entries quarantine to a miss instead
        of raising into the caller's boot path."""
        for key in self.keys(prefix):
            hit = self.disk_get(key, trace)
            if hit is None:
                continue
            value, _expires_at = hit
            yield key, value

    @staticmethod
    def _listdir(path: str):
        try:
            return os.listdir(path)
        except OSError:
            return []

    # -- composed lookup -------------------------------------------------

    def lookup(self, key: str, trace=NULL_TRACE):
        """memory -> disk with upward promotion. Returns (value, tier)
        with tier in ("memory", "disk"), or None. The OWNER layers
        hit/miss stats and any lower tier (peer/object store) on top."""
        value = self.mem_get(key)
        if value is not None:
            return value, "memory"
        if not self.disk_dir:
            return None
        hit = self.disk_get(key, trace)
        if hit is None:
            return None
        value, expires_at = hit
        self.mem_put(key, value, expires_at=expires_at)
        return value, "disk"

    # -- views -----------------------------------------------------------

    @property
    def bytes_resident(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._mem)
