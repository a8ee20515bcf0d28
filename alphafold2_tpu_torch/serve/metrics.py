"""Serving metrics: counters, queue depth, padding waste, latency tails.

Latency reservoirs are `obs.registry.Histogram` objects (per bucket),
so p50/p90/p99 here come from the same histogram + single
`utils.profiling.percentile` quantile path as every other stat in the
repo — and every recording is mirrored into the process-wide
`MetricsRegistry` (serve_* counters, gauges, and a bucket-labeled
latency histogram) so a Prometheus scrape (obs/export.py) sees this
server next to the cache and the train loop. Reuses
`utils.logging.MetricsLogger` for the JSONL sink (one record per
executed batch — queue depth, padding waste, and the current per-bucket
p50/p90/p99 latency). `snapshot()` is the health-check view: O(1)-ish,
lock-consistent, JSON-serializable.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from alphafold2_tpu_torch.obs.registry import (DEFAULT_LATENCY_BUCKETS,
                                               Histogram, MetricsRegistry,
                                               get_registry)
from alphafold2_tpu_torch.utils.logging import MetricsLogger


class ServeMetrics:
    """Thread-safe serving counters + JSONL emission + registry mirror.

    registry: obs.MetricsRegistry to report into (None = the process
        default). Instance counters/latencies answer `snapshot()` for
        THIS server; the registry carries the process-wide cumulative
        view across all servers for exporters.
    """

    def __init__(self, jsonl_path: Optional[str] = None,
                 stdout: bool = False, max_latencies_per_bucket: int = 4096,
                 registry: Optional[MetricsRegistry] = None):
        self._logger = MetricsLogger(jsonl_path, stdout=stdout) \
            if (jsonl_path or stdout) else None
        self._lock = threading.Lock()
        self._max_lat = max_latencies_per_bucket
        self.enqueued = 0
        self.served = 0
        self.shed = 0
        self.errors = 0
        self.cancelled = 0
        self.rejected = 0           # backpressure: submit refused
        # preemption reclaim terminals (zero — and absent
        # from snapshot() — unless a reclaim actually happened)
        self.preempted = 0
        # resilience outcomes (all zero without a RetryPolicy)
        self.degraded = 0           # fast-shed while the breaker is open
        self.poisoned = 0           # quarantined poison terminal states
        self.retried = 0            # re-enqueues after transient failures
        # HBM admission guard (zero without a mesh policy)
        self.too_large = 0          # rejected: exceeds largest mesh slice
        self.batches = 0
        self.queue_depth = 0
        # cumulative wall seconds the executor spent inside batch
        # executions (sum of batch latencies). 1 - busy/wall is the
        # executor idle fraction — the number the feature pipeline
        # exists to drive down (the accelerator must never
        # idle waiting on features); serve_loadtest reports it
        self.exec_busy_s = 0.0
        # result-cache outcomes at submit (all zero when caching is off)
        self.cache_hits = 0         # served straight from the store
        self.cache_misses = 0       # key looked up, not found
        self.coalesced = 0          # parked behind an in-flight leader
        self._real_tokens = 0
        self._padded_tokens = 0
        # admission-aware occupancy-weighted padding: the
        # formation-time accounting above prices the grid ONCE at
        # assemble ("founders only"); these price
        # what each executed recycle step actually carried, so row
        # admissions (and the padding a cross-bucket admit accepts)
        # move the number instead of being invisible
        self._step_real_tokens = 0
        self._step_grid_tokens = 0
        self.row_admits = 0          # rows admitted mid-loop (all kinds)
        # per-bucket latency reservoirs (seconds, request-level) —
        # instance-scoped Histograms answering this server's snapshot()
        self._latencies: Dict[int, Histogram] = {}
        # process-wide mirror every recording also lands in
        reg = registry or get_registry()
        self._m_enqueued = reg.counter(
            "serve_enqueued_total", "requests accepted into the queue")
        self._m_outcomes = reg.counter(
            "serve_requests_total",
            "terminal request outcomes by state", ("outcome",))
        self._m_cache = reg.counter(
            "serve_cache_events_total",
            "submit-side result-cache outcomes", ("event",))
        self._m_batches = reg.counter(
            "serve_batches_total", "executed batches")
        self._m_tokens = reg.counter(
            "serve_tokens_total",
            "token grid accounting per executed batch", ("kind",))
        self._m_queue_depth = reg.gauge(
            "serve_queue_depth", "queued + pending requests")
        self._m_latency = reg.histogram(
            "serve_request_latency_seconds",
            "submit-to-resolve latency of served requests",
            ("bucket_len",), reservoir=max_latencies_per_bucket)
        self._m_admit_pad = reg.histogram(
            "serve_admit_pad_fraction",
            "per-admission pad fraction at the host bucket edge "
            "(1 - length/host_edge) of rows admitted mid-loop",
            buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0))
        # instance-scoped mirror answering this server's snapshot()
        self._admit_pad_hist = Histogram(
            "serve_admit_pad_fraction", "per-admit pad fraction",
            buckets=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
            reservoir=max_latencies_per_bucket)

    def _bucket_hist(self, bucket_len: int) -> Histogram:
        """Caller holds self._lock."""
        h = self._latencies.get(bucket_len)
        if h is None:
            h = self._latencies[bucket_len] = Histogram(
                "serve_request_latency_seconds", "per-bucket latency",
                buckets=DEFAULT_LATENCY_BUCKETS, reservoir=self._max_lat)
        return h

    # -- recording -------------------------------------------------------

    def record_enqueued(self, queue_depth: int):
        with self._lock:
            self.enqueued += 1
            self.queue_depth = queue_depth
        self._m_enqueued.inc()
        self._m_queue_depth.set(queue_depth)

    def record_rejected(self):
        with self._lock:
            self.rejected += 1
        self._m_outcomes.inc(outcome="rejected")

    def record_shed(self, n: int = 1):
        with self._lock:
            self.shed += n
        self._m_outcomes.inc(n, outcome="shed")

    def record_error(self, n: int = 1):
        with self._lock:
            self.errors += n
        self._m_outcomes.inc(n, outcome="error")

    def record_cancelled(self, n: int = 1):
        with self._lock:
            self.cancelled += n
        self._m_outcomes.inc(n, outcome="cancelled")

    def record_preempted(self, n: int = 1):
        """Requests resolved "preempted": the replica was reclaimed
        mid-work; checkpoints (where spillable) were handed off for
        adoption and the caller retries elsewhere. The outcome label
        is minted on first use, so a never-preempted server's registry
        stays byte-identical."""
        with self._lock:
            self.preempted += n
        self._m_outcomes.inc(n, outcome="preempted")

    def record_degraded(self, n: int = 1):
        with self._lock:
            self.degraded += n
        self._m_outcomes.inc(n, outcome="degraded")

    def record_poisoned(self, n: int = 1):
        with self._lock:
            self.poisoned += n
        self._m_outcomes.inc(n, outcome="poisoned")

    def record_too_large(self, n: int = 1):
        with self._lock:
            self.too_large += n
        self._m_outcomes.inc(n, outcome="too_large")

    def record_retried(self, n: int = 1):
        """Requests re-enqueued after a transient batch failure (NOT a
        terminal outcome — the same request later lands in served/
        errors/shed as usual)."""
        with self._lock:
            self.retried += n

    def record_admit(self, pad_fraction: float):
        """One row admitted mid-loop (continuous batching): observe
        its pad fraction at the host bucket edge. Cross-bucket admits
        populate the high bins — the distribution IS the
        padding-vs-dead-row trade being taken."""
        pad_fraction = min(max(float(pad_fraction), 0.0), 1.0)
        with self._lock:
            self.row_admits += 1
            self._admit_pad_hist.observe(pad_fraction)
        self._m_admit_pad.observe(pad_fraction)

    def record_step_occupancy(self, real_tokens: int, grid_tokens: int):
        """One executed recycle step's token accounting: live rows'
        real residues vs the full (B, L) grid the step paid for.
        `padding_waste_admitted` in snapshot() is 1 - sum/sum over
        every recorded step — the occupancy-weighted padding fraction
        the continuous/cross-bucket batcher actually served at (the
        formation-time `padding_waste` cannot see admissions)."""
        with self._lock:
            self._step_real_tokens += int(real_tokens)
            self._step_grid_tokens += int(grid_tokens)

    def record_cache_hit(self):
        with self._lock:
            self.cache_hits += 1
        self._m_cache.inc(event="hit")

    def record_cache_miss(self):
        with self._lock:
            self.cache_misses += 1
        self._m_cache.inc(event="miss")

    def record_coalesced(self):
        with self._lock:
            self.coalesced += 1
        self._m_cache.inc(event="coalesced")

    def _cache_view(self) -> dict:
        """Caller holds self._lock."""
        total = self.cache_hits + self.cache_misses
        return {"hits": self.cache_hits, "misses": self.cache_misses,
                "coalesced": self.coalesced,
                "hit_ratio": self.cache_hits / total if total else 0.0}

    def record_served(self, bucket_len: int, latency_s: float):
        with self._lock:
            self.served += 1
            self._bucket_hist(bucket_len).observe(latency_s)
        self._m_outcomes.inc(outcome="served")
        self._m_latency.observe(latency_s, bucket_len=bucket_len)

    def record_batch(self, bucket_len: int, batch_size: int, n_real: int,
                     real_tokens: int, padding_waste: float,
                     batch_latency_s: float, queue_depth: int,
                     cache_store: Optional[dict] = None):
        """One executed batch; emits the JSONL record. `cache_store` is
        the FoldCache.snapshot() of the scheduler's result store (None
        when caching is off): the JSONL cache section combines the
        submit-side counters here with the store's resident bytes and
        evictions so one record answers "is the cache working"."""
        with self._lock:
            self.batches += 1
            self.queue_depth = queue_depth
            self.exec_busy_s += float(batch_latency_s)
            self._real_tokens += real_tokens
            self._padded_tokens += batch_size * bucket_len
            lat = self._bucket_hist(bucket_len)
            record = dict(
                bucket_len=bucket_len,
                batch_size=batch_size,
                n_real=n_real,
                queue_depth=queue_depth,
                padding_waste=padding_waste,
                batch_latency_s=batch_latency_s,
                p50_latency_s=lat.percentile(50),
                p90_latency_s=lat.percentile(90),
                p99_latency_s=lat.percentile(99),
            )
            if cache_store is not None:
                cache = self._cache_view()
                cache["bytes_resident"] = cache_store.get(
                    "bytes_resident", 0)
                cache["evictions"] = cache_store.get("evictions", 0)
                record["cache"] = cache
            step = self.batches
            logger = self._logger
        self._m_batches.inc()
        self._m_tokens.inc(real_tokens, kind="real")
        self._m_tokens.inc(batch_size * bucket_len - real_tokens,
                           kind="padding")
        self._m_queue_depth.set(queue_depth)
        if logger is not None:
            try:
                logger.log(step=step, **record)
            except Exception:
                # the JSONL sink is observability, not serving: a full
                # disk under the metrics file must not lose the counter
                # updates above or propagate into the serving worker
                pass

    # -- views -----------------------------------------------------------

    def padding_waste_fraction(self) -> float:
        with self._lock:
            if self._padded_tokens == 0:
                return 0.0
            return 1.0 - self._real_tokens / float(self._padded_tokens)

    def snapshot(self) -> dict:
        """Health-check view: counters + per-bucket latency tails."""
        with self._lock:
            per_bucket = {
                str(b): {"count": h.count(),
                         "p50_s": h.percentile(50),
                         "p90_s": h.percentile(90),
                         "p99_s": h.percentile(99)}
                for b, h in sorted(self._latencies.items())
            }
            padded = self._padded_tokens
            waste = (1.0 - self._real_tokens / float(padded)) if padded \
                else 0.0
            grid = self._step_grid_tokens
            waste_admitted = (1.0 - self._step_real_tokens / float(grid)) \
                if grid else 0.0
            admit_pad = {
                "count": self._admit_pad_hist.count(),
                "p50": self._admit_pad_hist.percentile(50),
                "p99": self._admit_pad_hist.percentile(99),
            }
            out = {
                "enqueued": self.enqueued,
                "served": self.served,
                "shed": self.shed,
                "errors": self.errors,
                "cancelled": self.cancelled,
                "rejected": self.rejected,
                "degraded": self.degraded,
                "poisoned": self.poisoned,
                "retried": self.retried,
                "too_large": self.too_large,
                "batches": self.batches,
                "queue_depth": self.queue_depth,
                "exec_busy_s": self.exec_busy_s,
                "padding_waste": waste,
                # occupancy-weighted over executed recycle steps
                # (0.0 when the step loop never ran)
                "padding_waste_admitted": waste_admitted,
                "row_admits": self.row_admits,
                "admit_pad_fraction": admit_pad,
                "latency_by_bucket": per_bucket,
                "cache": self._cache_view(),
            }
            if self.preempted:
                # only after a reclaim: the never-preempted snapshot
                # stays byte-identical (the identity pin reads it)
                out["preempted"] = self.preempted
            return out

    def close(self):
        if self._logger is not None:
            self._logger.close()


class KeyFrequencyLog:
    """Served-traffic key frequencies as a cache_warm profile.

    Every ingress submit (forwarded hops excluded — each user request
    counts once, at the replica that received it) is aggregated by its
    (seq, msa) content digest and periodically flushed as JSONL in
    EXACTLY the profile format `tools/cache_warm.py` reads:

        {"seq": [tokens...], "count": n}
        {"seq": [tokens...], "msa": [[tokens...]], "count": n}

    so telemetry-driven warming is the same code path as offline
    warming — the controller (or `cache_warm --from-serve-log`) tails
    these files and folds the head into the ring owners' caches.
    Flushes are atomic full rewrites (tmp + os.replace): a reader never
    sees a torn file, and counts are cumulative per unique key, not
    append-per-request — the file stays O(unique keys).

    Off by default everywhere: nothing constructs one unless asked
    (`Scheduler(key_log=)`, ProcFleet `key_log=True`), so the no-log
    serving path is byte-identical.
    """

    def __init__(self, path: str, flush_every: int = 16):
        self.path = path
        self.flush_every = max(1, int(flush_every))
        self.observed = 0
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = {}   # digest -> profile record

    def observe(self, seq, msa=None):
        import hashlib

        import numpy as np

        try:
            seq_arr = np.asarray(seq)
            h = hashlib.blake2b(digest_size=16)
            h.update(seq_arr.astype(np.int64, copy=False).tobytes())
            msa_arr = None
            if msa is not None:
                msa_arr = np.asarray(msa)
                h.update(b"|msa|")
                h.update(msa_arr.astype(np.int64, copy=False).tobytes())
            digest = h.hexdigest()
        except Exception:
            return             # unkeyable traffic is never worth a crash
        with self._lock:
            ent = self._entries.get(digest)
            if ent is None:
                rec = {"seq": seq_arr.tolist(), "count": 1}
                if msa_arr is not None:
                    rec["msa"] = msa_arr.tolist()
                self._entries[digest] = rec
            else:
                ent["count"] += 1
            self.observed += 1
            due = self.observed % self.flush_every == 0
        if due:
            self.flush()

    def flush(self):
        """Atomic full rewrite, hottest keys first."""
        import json
        import os

        with self._lock:
            records = sorted(self._entries.values(),
                             key=lambda r: -r["count"])
            records = [dict(r) for r in records]
        try:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                for rec in records:
                    fh.write(json.dumps(rec) + "\n")
            os.replace(tmp, self.path)
        except OSError:
            pass               # telemetry is best-effort, serving wins

    def snapshot(self) -> dict:
        with self._lock:
            return {"path": self.path,
                    "observed": self.observed,
                    "unique": len(self._entries)}
