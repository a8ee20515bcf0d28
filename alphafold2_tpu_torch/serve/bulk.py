"""The bulk tier: proteome-scale sweep folding as a background QoS
class.

ParaFold folded 19,704 proteins in one batch campaign. Serving that
kind of backfill on the same fleet as latency-bound traffic needs a
QoS class that is structurally incapable of hurting the online
classes, not one that merely sorts behind them in a shared queue:

- **Own queue, own bound.** `qos="bulk"` submissions land in a
  `BulkQueue`, never in the scheduler's `_incoming`/`_pending`: bulk
  backlog cannot push the online queue into its full policy, cannot
  trip queue-depth alerts, and is bounded by `BulkPolicy.max_pending`
  on its own.
- **Work-stealing admission only.** Bulk folds ride freed batch rows
  through the continuous-admission front, taken ONLY after
  every online candidate (same-bucket and cross-bucket) came up
  empty. A bulk batch may be FOUNDED only when no online work is
  pending anywhere — an all-bulk fleet folds at full throughput, a
  busy one contributes exactly its idle row-steps.
- **Burn-rate throttling.** The SLO engine's own report gates
  the tier: when any online class's latency burn rate crosses
  `BulkPolicy.max_burn`, new bulk admits stop, and in-flight bulk
  rows checkpoint-and-yield at the next admission gap — spill to the
  durable `cache.checkpoints.CheckpointStore` and requeue as
  resumable (`Scheduler._yield_bulk_rows`), freeing their rows for
  the online work that is burning budget. Without a spill store
  (`RetryPolicy(checkpoint_spill=)` off) a yield would refold from
  zero, so bulk rows run to completion instead and only NEW admits
  gate.

Campaign tooling (`tools/bulk_submit.py`) layers the durable ledger
and idempotent re-runs on top; this module is just the queue and the
policy knobs. The queue stores scheduler entries opaquely — it never
imports the scheduler.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class BulkPolicy:
    """Knobs for the bulk tier (Scheduler(bulk=...)).

    max_burn: online latency burn-rate ceiling — above it, bulk
        admission gates and in-flight bulk rows checkpoint-and-yield.
        1.0 means "gating starts exactly when any online class starts
        spending error budget faster than it accrues". Only
        meaningful with an SLOEngine attached (no engine, no burn
        signal, no gating).
    max_pending: bulk queue bound; submits past it raise
        QueueFullError (campaign submitters throttle on it).
    check_interval_s: how long one SLO report's burn verdict is
        cached — report() walks registry histograms, so the steal
        path must not pay it per freed row.
    """

    max_burn: float = 1.0
    max_pending: int = 10000
    check_interval_s: float = 1.0

    def __post_init__(self):
        if self.max_burn <= 0:
            raise ValueError("max_burn must be > 0")
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if self.check_interval_s < 0:
            raise ValueError("check_interval_s must be >= 0")


class BulkQueue:
    """Thread-safe per-bucket FIFO of bulk entries. Items are opaque
    (the scheduler stores its `_Entry`s); ordering is FIFO per bucket
    with `push_front` for yielded loops — a resumable fold goes back
    to the head so its spilled checkpoint is consumed before it ages
    out, not behind the whole campaign."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: Dict[int, deque] = {}
        self._n = 0

    def push(self, bucket_len: int, item) -> None:
        with self._lock:
            self._pending.setdefault(int(bucket_len), deque()).append(item)
            self._n += 1

    def push_front(self, bucket_len: int, item) -> None:
        with self._lock:
            self._pending.setdefault(int(bucket_len),
                                     deque()).appendleft(item)
            self._n += 1

    def take(self, bucket_len: int):
        """Pop the bucket's head, or None."""
        with self._lock:
            q = self._pending.get(int(bucket_len))
            if not q:
                return None
            self._n -= 1
            return q.popleft()

    def buckets(self) -> List[int]:
        """Non-empty buckets, oldest head first (insertion order is
        FIFO, so the head of each deque is its oldest) — founding
        drains the longest-waiting campaign slice first. Ties and
        opaque items degrade to bucket order."""
        with self._lock:
            entries = [(b, q[0]) for b, q in self._pending.items() if q]

        def age_key(pair):
            b, head = pair
            return (getattr(head, "enqueued_at", 0.0), b)

        return [b for b, _ in sorted(entries, key=age_key)]

    def pending_for(self, bucket_len: int) -> int:
        with self._lock:
            q = self._pending.get(int(bucket_len))
            return len(q) if q else 0

    def drain(self) -> list:
        """Remove and return everything (stop/crash paths: every
        ticket still owed a terminal state)."""
        with self._lock:
            out = []
            for q in self._pending.values():
                out.extend(q)
                q.clear()
            self._n = 0
            return out

    def snapshot(self) -> dict:
        with self._lock:
            return {"pending": self._n,
                    "buckets": {b: len(q)
                                for b, q in sorted(self._pending.items())
                                if q}}

    def __len__(self) -> int:
        with self._lock:
            return self._n
