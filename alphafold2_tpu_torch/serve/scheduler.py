"""Thread-based dynamic batcher: the serving front door (counterpart of
`alphafold2_tpu/serve/scheduler.py`; every batch tensor is built on the
executor's device, and every result is fetched to the host, explicitly,
never through a thread's current device).

Requests enqueue from any thread; one worker drains them into per-bucket
batches under a `max_batch_size` / `max_wait_ms` policy (ParaFold-style:
throughput comes from scheduling, not the model). Three QoS behaviors:

- deadline shedding: a request whose deadline expires while queued is
  resolved `status="shed"` without touching the accelerator — folding
  dead work is the most expensive way to miss a deadline;
- bounded-queue backpressure: `queue_limit` caps in-flight requests;
  `full_policy="reject"` raises QueueFullError at submit (shed at the
  door), `"block"` makes submit wait for capacity;
- priority: when a backlog exceeds one batch, higher-priority requests
  fold first (FIFO within a priority level).

With a `cache` (alphafold2_tpu_torch.cache.FoldCache — OFF by default),
submit() never enqueues redundant work: a content-addressed key over
(seq, effective MSA, fold config, model_tag) is checked against the
result store (hit → the ticket resolves immediately, source="cache"),
then against the in-flight registry (duplicate of a queued/running
fold → the ticket parks as a FOLLOWER of that leader, source=
"coalesced"). Only a genuinely novel fold enqueues. Every terminal
leader state — ok, executor error, deadline shed, cancellation, worker
crash — fans out to its followers, so coalesced tickets can never
deadlock; on success the store is populated before followers settle,
closing the attach/settle race. Parked followers count against
`queue_limit` at attach time, so a duplicate storm is bounded like
unique traffic (worst-case transient residency is < 2x queue_limit:
a leader gates its own enqueue on queue depth alone — counting its own
parked followers there would be a circular wait).

With a `router` (fleet.ConsistentHashRouter — OFF by default), a novel
fold whose key hashes to another healthy replica takes one bounded
forwarding hop to that owner at submit, so duplicate traffic coalesces
fleet-wide on one leader instead of once per process; any forwarding
trouble falls back to folding locally. A leader that is shed (or
rejected at submit) no longer sheds its parked followers: the
tightest-deadline survivor is PROMOTED to leader and enqueued, the
rest stay parked behind it (`coalesce_leader_promotions_total`).

Unlike a leader, a parked follower DOES get its own deadline enforced:
if it expires while waiting on the leader, the follower is shed with
its own terminal state (`status="shed"`, reason
`follower_deadline_exceeded`) instead of inheriting the leader's
timing — a tight-deadline duplicate must not silently wait out a
slow leader.

With a `tracer` (alphafold2_tpu_torch.obs.Tracer — NULL_TRACER by default,
zero-cost no-ops), every submission carries a request-scoped trace
from submit to its terminal state: `submit` (cache lookup, coalescing,
backpressure wait), `queue`, `batch_form`, executor `compile`/`fold`
(batch-level spans fanned out to each member), and `writeback` spans,
plus cache hit/miss/quarantine and coalescing events; followers link
to their leader's trace. Completed traces emit as JSONL and the K
slowest are exposed via `serve_stats()["traces"]`
(tools/obs_report.py renders the waterfall).

With a `retry` (serve.resilience.RetryPolicy — OFF by default, and
with it off this scheduler behaves exactly as before the resilience
layer existed), failure becomes a first-class domain instead of a
single error path: batches failed by TRANSIENT executor trouble are
re-enqueued with bounded exponential backoff instead of error-resolving
their whole cohort; a batch that fails DETERMINISTICALLY is bisected —
split in half, each half retried as its own isolation group — so one
poison input is cornered in <= log2(batch) extra executions and
quarantined (status "poisoned"; its key fails fast forever, covering
coalesced followers and future duplicates); non-finite coords or
confidence never leave as "ok" (`nonfinite_output`, counting toward
poison detection); an optional per-batch WATCHDOG deadline bounds
executor.run, rebuilding the executor on expiry; and an optional
CIRCUIT BREAKER flips the scheduler into degraded mode after
consecutive systemic failures — novel submits fast-shed with status
"degraded" while cache/coalesce hits keep serving, then a half-open
probe batch closes the breaker when the device recovers.

With a `mesh_policy` (serve.meshpolicy.MeshPolicy — OFF by default,
and with it off this scheduler is byte-for-byte the single-chip
behavior), serving becomes mesh-aware end to end: each bucket maps to
a device-slice shape (1 chip for short buckets, a 2/4/8-chip
pair-sharded mesh for long ones, chosen by an analytic HBM model), a
DeviceSliceAllocator hands each formed batch a DISJOINT slice so short
traffic no longer queues behind a flagship fold (batches on different
slices execute concurrently on a small pool of dispatch threads; a
multi-device slice runs on one rank process per card, which warm-up
starts and stop() closes), and submits whose analytic
footprint exceeds even the largest configured slice resolve status "too_large"
(`serve_too_large_total`) instead of dying in a CUDA OOM mid-batch.
`serve_stats()["mesh"]` reports the policy, per-shape fold counts, and
allocator occupancy; fold spans are tagged with their mesh label and a
`shard` span prices params/input placement in the waterfall.

With a `recycle_policy` (serve.recycle.RecyclePolicy — OFF by default,
and with it off this scheduler is byte-for-byte the opaque-fold
behavior), the SCHEDULER owns the recycle loop instead of
`predict.fold`: each batch runs the embed+first-pass program then one
single-recycle step program per iteration (`FoldExecutor.run_init`/
`run_step` — the opaque fold's pass as its own program, so
full-recycle numerics match the opaque path exactly), and between
steps the scheduler retires converged elements early (per-element
coordinate/confidence delta below `converge_tol`; the survivor batch is
re-packed and a fully converged batch skips its remaining recycles —
`serve_recycles_skipped_total`), lets tight-deadline pending work PREEMPT the
gap (`serve_preemptions_total`), and streams per-recycle progressive results to
each FoldTicket (`RecyclePolicy(stream=True)`). A result-affecting policy
(converge_tol > 0) keys the cache under distinct `fold_key` extras, so an
early-exited result is never served to a caller demanding fixed full recycles.

Cache-aware admission (`SchedulerConfig.parked_bytes_budget` > 0): an
in-flight duplicate costs ~0 — it parks as a follower and never
touches the accelerator — so submit() admits coalescing followers PAST
a "full" queue, bounded by the budget on their parked request bytes
(`serve_parked_admits_total`). Novel work still honors `queue_limit`
exactly as before; the budget only widens the door for work that is
already being done.

Batches are always padded to `max_batch_size` (bucketing.assemble), so
the shape set is closed: one program per (bucket, num_recycles), never
one per observed batch size.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from alphafold2_tpu_torch.cache import FoldCache, InflightRegistry, fold_key
from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry
from alphafold2_tpu_torch.obs.trace import (MultiTrace, NULL_TRACE,
                                            NULL_TRACER, Tracer)
from alphafold2_tpu_torch.serve.bucketing import BucketPolicy
from alphafold2_tpu_torch.serve.confidence import (
    distogram_entropy as _distogram_entropy, score_response)
from alphafold2_tpu_torch.serve.executor import FoldExecutor
from alphafold2_tpu_torch.serve.meshpolicy import (AdmissionPricer,
                                                   MeshPolicy, SliceLease,
                                                   chips_of)
from alphafold2_tpu_torch.serve.metrics import ServeMetrics
from alphafold2_tpu_torch.serve.recycle import (RecyclePolicy,
                                                element_deltas,
                                                repack_batch, repack_rows,
                                                steps_saved)
from alphafold2_tpu_torch.serve.request import (FoldProgress, FoldRequest,
                                                FoldResponse, FoldTicket)
from alphafold2_tpu_torch.serve.resilience import (CircuitBreaker,
                                                   Quarantine, RetryPolicy,
                                                   WatchdogTimeout,
                                                   run_with_watchdog)


def _host(x) -> np.ndarray:
    """A host copy of a result tensor (bf16 widened to fp32) or of an
    array; a copy, so later in-place work on the tensor cannot reach
    it."""
    if not isinstance(x, torch.Tensor):
        return np.array(x)
    x = x.detach()
    if x.dtype == torch.bfloat16:
        x = x.float()
    return x.cpu().numpy() if x.device.type != "cpu" else x.numpy().copy()


class QueueFullError(RuntimeError):
    """submit() refused: queue at queue_limit and full_policy='reject'."""


class DrainingError(QueueFullError):
    """submit() refused: the scheduler is draining (graceful shutdown —
    in-flight work finishes, new work must go to another replica).
    Subclasses QueueFullError so callers that already handle the
    rejected-at-the-door case treat a draining replica the same way:
    retry elsewhere, nothing was lost."""


@dataclass
class SchedulerConfig:
    max_batch_size: int = 4
    max_wait_ms: float = 50.0      # oldest request age that forces a batch
    queue_limit: int = 256         # in-flight cap (queued, not yet folded)
    num_recycles: int = 1
    full_policy: str = "reject"    # "reject" | "block"
    poll_ms: float = 5.0           # worker wakeup granularity
    # Serving MSA depth. None = per-batch max over members — ONLY safe
    # when every request carries the same depth; ragged-depth traffic
    # then mints one compiled shape per observed depth and defeats the
    # closed-shape guarantee. Pin it (bucketing.assemble semantics:
    # pad shallow, keep the first msa_depth rows of deeper MSAs) for
    # production traffic; 0 serves MSA-free.
    msa_depth: Optional[int] = None
    # Cache-aware admission: bytes of parked duplicate-request arrays
    # submit() may admit as coalescing followers PAST a full queue
    # (an in-flight duplicate costs ~0 to serve). 0 (default) = off:
    # duplicates respect queue_limit exactly like novel work.
    parked_bytes_budget: int = 0
    # Summarize the distogram head at batch finish: each ok
    # response carries its mean normalized distogram entropy
    # (FoldResponse.distogram_entropy) so a cascade confidence gate can
    # read global uncertainty, not just pointwise pLDDT. Opaque-fold
    # path only (the step loop discards per-step distograms); off by
    # default — responses stay byte-identical.
    confidence_summary: bool = False

    def __post_init__(self):
        if self.full_policy not in ("reject", "block"):
            raise ValueError(f"full_policy must be 'reject' or 'block', "
                             f"got {self.full_policy!r}")
        if self.max_batch_size < 1 or self.queue_limit < 1:
            raise ValueError("max_batch_size and queue_limit must be >= 1")
        if self.parked_bytes_budget < 0:
            raise ValueError("parked_bytes_budget must be >= 0")


class _Entry:
    __slots__ = ("request", "ticket", "bucket_len", "enqueued_at",
                 "deadline", "cache_key", "store_key", "trace", "route",
                 "attempts", "not_before", "group",
                 "parked_admit_bytes", "cross_refused")

    def __init__(self, request: FoldRequest, bucket_len: int):
        self.request = request
        self.ticket = FoldTicket(request.request_id)
        self.bucket_len = bucket_len
        self.cache_key: Optional[str] = None   # set only on cache leaders
        # set when the key is known but the entry is NOT a leader (the
        # saturated block-mode fall-through): its successful fold still
        # populates the store, it just has no followers to settle
        self.store_key: Optional[str] = None
        self.trace = NULL_TRACE                # set by submit()
        self.route = None       # fleet RouteDecision, computed at most once
        self.attempts = 0       # executor batch executions participated in
        self.not_before = 0.0   # retry backoff gate (monotonic)
        # bisection isolation group: entries sharing a group id batch
        # ONLY with each other, so a failing cohort stays cornered
        self.group: Optional[int] = None
        # bytes this entry holds of the cache-aware admission budget
        # (nonzero only for followers admitted past a full queue)
        self.parked_admit_bytes = 0
        # the cross-bucket pricer refused this entry at least once
        #: the inline admission gate then treats it as
        # admission-can't-serve-it, so the loop drains and normal
        # batch formation takes over — max_wait stays a bounded
        # fallback even under pricer refusals
        self.cross_refused = False
        self.mark_enqueued()

    def resolve(self, response: FoldResponse):
        """THE terminal seam: resolve the caller's ticket and finish the
        request trace in one place, so every terminal path — ok, cache
        hit, coalesced, shed, error, cancelled, crash — yields exactly
        one completed trace. Trace.finish is idempotent; racing
        resolvers can't double-emit."""
        self.ticket._resolve(response)
        self.trace.finish(status=response.status, source=response.source,
                          error=response.error)

    def mark_enqueued(self):
        """(Re)start the latency/deadline clock — called again right
        before the entry actually enters the queue so time blocked on a
        full queue (full_policy='block') doesn't eat the deadline."""
        self.enqueued_at = time.monotonic()
        self.deadline = (None if self.request.deadline_s is None
                         else self.enqueued_at + self.request.deadline_s)


class _StepCheckpoint:
    """Host-side snapshot of a running step loop: the
    FoldStepState carry (predict.snapshot_step_state form), a COPY of
    the batch tensors' host mirror, and the loop membership (entries +
    position->row map + per-row ages) at loop step `step`. Everything
    is host memory owned by this object alone — it survives executor
    rebuilds and later admission rounds mutating the live mirror — so
    a transient failure or watchdog fire can re-upload it and resume
    the survivors at their checkpointed ages instead of requeueing the
    loop to recycle 0."""

    __slots__ = ("state", "host", "rows", "ages", "active", "step",
                 "kernel")

    def __init__(self, state, host, rows, ages, active, step, kernel):
        self.state = state
        self.host = host
        self.rows = rows
        self.ages = ages
        self.active = active
        self.step = step
        self.kernel = kernel


class Scheduler:
    """Dynamic batching fold server over one FoldExecutor.

    cache: optional FoldCache enabling result caching AND in-flight
        coalescing (both off when None — the default). model_tag
        namespaces cache keys by model identity; REQUIRED to be
        meaningful whenever the cache outlives one (model, params),
        e.g. any disk-backed store shared across restarts. Reassigning
        `model_tag` (a weight rollout — fleet.RolloutState subscribers
        do this) atomically re-keys every subsequent submit; old-tag
        entries become unreachable by construction.
    tracer: optional obs.Tracer for request-scoped traces (None — the
        default — is the zero-cost NULL_TRACER).
    registry: obs.MetricsRegistry the coalescing/follower-deadline
        counters report into (None = process default).
    router: optional fleet.ConsistentHashRouter (OFF when None — the
        default). When set, a request whose fold_key hashes to another
        healthy replica is FORWARDED there (one hop, bounded by
        FoldRequest.forwarded) so duplicate traffic coalesces fleet-wide
        on the key's owner; any forwarding trouble — owner down, no
        transport, remote backpressure — falls back to folding locally
        (fleet state can cost efficiency, never availability). The
        remote result resolves the local ticket via a done-callback and
        populates the local store on the way, so repeat traffic for the
        key turns into local cache hits.
    retry: optional serve.resilience.RetryPolicy (OFF when None — the
        default, which byte-for-byte preserves pre-resilience
        behavior). Enables transient-batch retry with backoff, poison
        isolation by bisection + keyed quarantine, non-finite output
        validation, the executor watchdog (retry.watchdog_s) and the
        degraded-mode circuit breaker (retry.breaker_threshold).
    executor_factory: zero-arg callable building a replacement executor
        after a watchdog fire; None falls back to `executor.rebuild()`
        when the executor provides it (FoldExecutor does), else the
        hung executor is kept (better a slow server than none).
    quarantine_path: optional JSONL file persisting the poison
        quarantine across restarts (only meaningful with `retry=`):
        keys quarantined in a previous process fail fast as
        "poisoned" from the first submit — a restarted replica never
        re-pays the bisection executions for a known poison. Put it
        next to the cache dir; the keys are the same content digests.
    mesh_policy: optional serve.meshpolicy.MeshPolicy (OFF when None —
        the default, which byte-for-byte preserves single-chip
        behavior). Requires a mesh-capable executor (FoldExecutor is).
        Buckets route to their policy slice, disjoint slices fold
        concurrently, and the analytic HBM admission guard rejects
        folds no configured slice can hold (status "too_large").
    recycle_policy: optional serve.recycle.RecyclePolicy (OFF when
        None — the default, which byte-for-byte preserves the opaque
        fold behavior). Requires a step-capable executor
        (FoldExecutor is; an executor without run_init/run_step keeps
        the opaque path). The scheduler then drives the recycle loop
        one step at a time: early-exit on convergence, preemption
        between recycles, progressive results — see the module
        docstring and serve/recycle.py.
    kernel_policy: optional serve.kernelpolicy.KernelPolicy (OFF when
        None — the default, byte-for-byte the dense-only serving
        path). Per-bucket attention-kernel routing: short
        buckets compile the dense path, long buckets the block-sparse
        Pallas kernel with a static banded+global mask; with
        `contact_priors=True` under a recycle policy, each batch
        re-plans its mask from its own recycle-1 distogram and the
        remaining recycles run the re-lowered step executable. The
        kernel choice is an ExecKey element, so a policy flip can
        never serve a stale executable, and warmup() pre-compiles each
        bucket's chosen kernel.
    slo: optional obs.slo.SLOEngine (OFF when None — the default,
        which keeps serve_stats() keys and the registry metric-name
        set byte-identical). Declarative per-QoS-class objectives
        (latency percentile targets per bucket, availability over
        terminal statuses) computed as windowed error budgets + burn
        rates from the registry's own histograms/counters;
        serve_stats()["slo"] carries the report and slo_* gauges ride
        every /metrics scrape.
    cascade: optional serve.cascade.CascadePolicy (OFF when None — the
        default, byte-for-byte the cascade-off behavior pinned by
        scrubbed-stats and metric-name-set identity tests). Interactive
        submits fold on the policy's DRAFT scheduler first; a confidence gate
        (serve/confidence.py) accepts the draft result (tier="draft")
        or escalates to this flagship through the ordinary submit seam
        (tier="flagship", escalated=True) with a priority boost and
        the remaining deadline. The two tiers share a FoldCache under
        distinct model_tags; a key collision is counted in
        serve_cascade_cross_tier_hits_total (pinned to 0) and
        escalated instead of served.
    """

    def __init__(self, executor: FoldExecutor, buckets: BucketPolicy,
                 config: Optional[SchedulerConfig] = None,
                 metrics: Optional[ServeMetrics] = None,
                 cache: Optional[FoldCache] = None,
                 model_tag: str = "",
                 tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 router=None,
                 retry: Optional[RetryPolicy] = None,
                 executor_factory: Optional[Callable[[], object]] = None,
                 quarantine_path: Optional[str] = None,
                 mesh_policy: Optional[MeshPolicy] = None,
                 recycle_policy: Optional[RecyclePolicy] = None,
                 feature_pool=None,
                 kernel_policy=None,
                 slo=None,
                 key_log=None,
                 bulk=None,
                 cascade=None):
        self.executor = executor
        # optional serve.metrics.KeyFrequencyLog (OFF when None — the
        # default, byte-identical): ingress submits (forwarded hops
        # excluded) are aggregated into a cache_warm-format profile so
        # the control plane can warm from SERVED traffic
        self.key_log = key_log
        # optional obs.slo.SLOEngine (OFF when None — the default,
        # which keeps serve_stats() and the registry's metric-name set
        # byte-identical): declarative per-QoS-class latency/
        # availability objectives computed over the registry's own
        # histograms/counters, reported as serve_stats()["slo"] and
        # exported as slo_* gauges — the signal surface the future
        # autoscaler (and /metrics scrapes) consume
        self.slo = slo
        # two-stage pipeline front (serve.features.FeaturePool — OFF
        # when None, the default, which keeps submit_raw featurizing
        # inline and serve_stats() byte-for-byte today's)
        self.feature_pool = feature_pool
        self.buckets = buckets
        self.config = config or SchedulerConfig()
        self.metrics = metrics or ServeMetrics()
        self.cache = cache
        self.model_tag = model_tag
        self.router = router
        self.retry = retry
        self.executor_factory = executor_factory
        self.tracer = tracer or NULL_TRACER
        reg = registry or get_registry()
        self._c_follower_deadline = reg.counter(
            "serve_follower_deadline_exceeded_total",
            "parked followers shed on their own expired deadline")
        self._quarantine: Optional[Quarantine] = None
        self._breaker: Optional[CircuitBreaker] = None
        # lifetime resilience counters (worker-thread writes; racy reads
        # from serve_stats are fine for a health view)
        self._n_retries = 0
        self._n_bisections = 0
        self._n_watchdog_fires = 0
        self._n_rebuilds = 0
        self._n_nonfinite = 0
        self._n_failovers = 0
        self._n_drains = 0
        if retry is not None:
            self._quarantine = Quarantine(registry=registry,
                                          path=quarantine_path)
            # worker-owned jitter stream: a RetryPolicy shared across
            # schedulers must not race N workers on one RNG. Callers
            # that fan one policy out across replicas give each copy
            # its own seed (fleet.InProcessFleet does) so replicas
            # don't back off in lockstep after a correlated transient
            # episode — identical streams would defeat the
            # thundering-herd jitter
            self._retry_rng = random.Random(retry.seed)
            if retry.breaker_threshold:
                self._breaker = CircuitBreaker(
                    retry.breaker_threshold, retry.breaker_cooldown_s,
                    registry=registry)
            self._group_counter = itertools.count(1)
            self._c_retries = reg.counter(
                "serve_retries_total",
                "requests re-enqueued after a transient batch failure")
            self._c_bisections = reg.counter(
                "serve_poison_bisections_total",
                "failing batches split for poison isolation")
            self._c_watchdog = reg.counter(
                "serve_watchdog_fires_total",
                "batches killed by the executor watchdog deadline")
            self._c_rebuilds = reg.counter(
                "serve_executor_rebuilds_total",
                "executors rebuilt after a watchdog fire")
            self._c_nonfinite = reg.counter(
                "serve_nonfinite_outputs_total",
                "fold outputs rejected by non-finite validation")
        # step-loop fault domains: carry checkpointing +
        # per-row poison isolation. Counters minted only when a knob is
        # on, so `retry=` without them stays byte-for-byte the plain
        # retry path — including the registry's metric-name set
        self._n_checkpoints = 0
        self._n_ckpt_resumes = 0
        self._n_recycles_lost = 0
        self._n_row_isolations = 0
        if retry is not None and (getattr(retry, "checkpoint_every", 0)
                                  or getattr(retry, "row_isolation",
                                             False)):
            self._c_ckpt_resumes = reg.counter(
                "serve_checkpoint_resumes_total",
                "step loops resumed at their checkpointed ages after a "
                "transient failure or watchdog fire")
            self._c_recycles_lost = reg.counter(
                "serve_recycles_lost_total",
                "recycle steps re-executed because they landed between "
                "the last checkpoint and a failure (the bounded "
                "progress loss of checkpoint recovery)")
            self._c_row_isolations = reg.counter(
                "serve_row_poison_isolations_total",
                "batch rows retired alone by per-row poison isolation "
                "(non-finite scan or row-attributed deterministic "
                "failure) while their batch mates kept folding")
        # durable checkpoint spill: per-row mid-loop
        # checkpoints outlive the process in a cache.checkpoints
        # CheckpointStore so a restarted replica (or a failover peer
        # reached through the store's backend/peer tiers) resumes
        # survivors at their checkpointed ages instead of refolding.
        # OFF unless RetryPolicy.checkpoint_spill names a directory —
        # the store (and its counters) is never built otherwise,
        # keeping scrubbed serve_stats() and the registry metric-name
        # set byte-identical
        self._ckpt_store = None
        self._n_spill_resumes = 0
        self._boot_survivors = 0
        spill_dir = "" if retry is None else getattr(
            retry, "checkpoint_spill", "")
        if spill_dir:
            from alphafold2_tpu_torch.cache.checkpoints import CheckpointStore
            self._ckpt_store = CheckpointStore(
                spill_dir, model_tag=model_tag, registry=registry)
            self._c_spill_resumes = reg.counter(
                "serve_spill_resumes_total",
                "fold rows resumed mid-loop from a durable spilled "
                "checkpoint (local disk, object store, or peer)")
            try:
                self._boot_survivors = sum(
                    1 for _ in self._ckpt_store.survivors())
            except Exception:
                self._boot_survivors = 0
        # bulk tier: lowest-QoS sweep work admitted only by
        # work-stealing through the continuous-admission front, gated
        # by online burn rate. OFF when None — byte-identical stats
        self.bulk = bulk
        self._bulk_queue = None
        self._n_bulk_admits = 0
        self._n_bulk_yields = 0
        self._n_bulk_rejected = 0
        self._bulk_gated_flag = False
        self._bulk_last_check = 0.0
        if bulk is not None:
            from alphafold2_tpu_torch.serve.bulk import BulkQueue
            self._bulk_queue = BulkQueue()
            self._c_bulk_admits = reg.counter(
                "serve_bulk_admits_total",
                "bulk-QoS requests admitted into fold batches (stolen "
                "freed rows or idle-founded batches)")
            self._c_bulk_yields = reg.counter(
                "serve_bulk_yields_total",
                "in-flight bulk rows that checkpointed-and-yielded at "
                "an admission gap because online burn crossed "
                "BulkPolicy.max_burn")
            self._g_bulk_gated = reg.gauge(
                "serve_bulk_gated",
                "1 while bulk admission is gated by online burn rate")
        # speculative cascade: draft-first folding with a
        # confidence gate, escalation through this very submit seam.
        # OFF when None — the default, byte-identical stats and
        # registry metric-name set (the identity tests pin it)
        self.cascade = cascade
        self._n_draft_accepted = 0
        self._n_escalated = 0
        self._n_draft_errors = 0
        self._n_cross_tier_hits = 0
        self._confidence_sum = 0.0        # over gate-scored drafts
        self._confidence_n = 0
        if cascade is not None:
            if getattr(cascade.draft, "model_tag", "") == model_tag:
                raise ValueError(
                    f"cascade draft model_tag {model_tag!r} collides "
                    f"with the flagship's — the shared FoldCache keys "
                    f"tiers apart by tag, so they MUST differ")
            self._c_cascade = reg.counter(
                "serve_cascade_requests_total",
                "cascaded submits by tier and gate outcome",
                ("tier", "outcome"))
            self._c_cross_tier = reg.counter(
                "serve_cascade_cross_tier_hits_total",
                "cascaded submits whose draft and flagship cache keys "
                "collided (MUST stay 0: fold_key embeds model_tag; a "
                "nonzero value means a keying regression could serve "
                "draft structures to flagship callers)")
        # express QoS lane: counters minted LAZILY on the
        # first express submit so a scheduler that never sees express
        # traffic keeps the registry metric-name set byte-identical
        self._registry = reg
        self._c_express = None
        self._h_express = None
        self._express_counts: Dict[str, int] = {}
        # step-mode recycle scheduling (before the mesh block: the LRU
        # autosizing below must know whether each (bucket, slice) needs
        # one executable or the init+step pair)
        self.recycle_policy = recycle_policy
        self._step_capable = hasattr(executor, "run_init") \
            and hasattr(executor, "run_step")
        self._n_recycles_exec = 0       # batch-level step executions
        self._n_recycles_skipped = 0    # batch-level steps early-exited
        self._n_preemptions = 0
        self._n_preempt_hbm_refusals = 0   # leased yields refused: the
        #   urgent batch + the suspended loop's resident carry would
        #   exceed per-device HBM (memory-aware preemption admission)
        self._n_retired_early = 0       # elements resolved before the
        self._n_parked_admits = 0       # last configured recycle
        # continuous batching: row-level occupancy ledger.
        # live/total accumulate per executed step; their ratio is the
        # rows-occupied fraction the smoke gates on; dead steps are the
        # padded row-steps continuous admission exists to eliminate
        self._n_row_admissions = 0
        self._n_rows_dead_steps = 0
        self._row_steps_live = 0
        self._row_steps_total = 0
        # cross-bucket admission: freed rows serving shorter
        # buckets' pending work at the host shape, priced per admit
        self._n_cross_admissions = 0
        self._n_cross_refusals = 0
        # per-bucket EWMA of measured step-executable seconds — what
        # the AdmissionPricer converts loop extension into wall time
        # with (worker/pool-thread writes, racy reads are fine for a
        # pricing heuristic)
        self._step_ewma: Dict[int, float] = {}
        # "a preemptor never preempts": per-thread reentrancy guard for
        # the between-recycles preemption window
        self._preempting = threading.local()
        if recycle_policy is not None:
            self._c_recycles = reg.counter(
                "serve_recycles_total",
                "recycle step executions by the step-mode scheduler")
            self._c_recycles_skipped = reg.counter(
                "serve_recycles_skipped_total",
                "recycle steps skipped because every batch element "
                "converged early")
            self._c_preemptions = reg.counter(
                "serve_preemptions_total",
                "batches preempted between recycles by tighter-deadline "
                "pending work")
            self._c_preempt_hbm_refusals = reg.counter(
                "serve_preempt_hbm_refusals_total",
                "leased preemption yields refused because the urgent "
                "batch plus the suspended loop's HBM-resident carry "
                "would exceed the per-device budget")
            self._c_row_admissions = reg.counter(
                "serve_row_admissions_total",
                "pending requests admitted into freed batch rows "
                "mid-recycle by the continuous batcher")
            self._c_rows_dead_steps = reg.counter(
                "serve_rows_dead_steps_total",
                "row-steps executed on dead (unoccupied) batch rows — "
                "the padding waste continuous admission eliminates")
            self._g_rows_occupied = reg.gauge(
                "serve_rows_occupied_fraction",
                "live rows / batch rows of the step executed last, "
                "sampled per recycle step")
            self._c_cross_admissions = reg.counter(
                "serve_cross_bucket_admissions_total",
                "pending requests from a shorter bucket admitted into "
                "a longer host batch's freed rows at the host shape "
                "(cross-bucket continuous batching)",
                ("host_bucket", "native_bucket"))
            # step mode needs TWO executables per (bucket, slice) —
            # init + step (THREE with continuous batching: + the
            # row-masked init_rows admission program); grow the LRU so
            # warmup's set is not self-evicting (the mesh block below
            # multiplies its own sizing the same way)
            per_bucket = 3 if recycle_policy.continuous else 2
            if self._step_capable and hasattr(executor, "max_entries"):
                executor.max_entries = max(
                    executor.max_entries,
                    per_bucket * len(self.buckets.edges))
        # per-bucket attention-kernel routing — nothing below
        # touches the serving path when the policy is None
        self.kernel_policy = kernel_policy
        self._kernel_served: Dict[Tuple[str, int], int] = {}
        self._kernel_batches: Dict[Tuple[str, int], int] = {}
        if kernel_policy is not None:
            self._c_kernel_folds = reg.counter(
                "serve_kernel_folds_total",
                "requests served, by attention kernel and bucket",
                ("kernel", "bucket"))
            self._c_kernel_replans = reg.counter(
                "serve_kernel_contact_replans_total",
                "step loops whose block mask was re-planned from "
                "recycle-1 contact priors (re-lowered step executable)")
        if self.config.parked_bytes_budget > 0 or cache is not None:
            self._c_parked_admits = reg.counter(
                "serve_parked_admits_total",
                "coalescing followers admitted past a full queue under "
                "the parked-bytes budget")
        self._parked_admit_bytes = 0     # guarded by _cond
        # best-effort preemption signal for leased step loops: the
        # tightest deadline currently pending, refreshed by the worker
        # each loop pass (pool threads read it under _cond)
        self._pending_tightest: Optional[float] = None
        self._pending_tightest_chips: Optional[int] = None
        self._pending_tightest_bucket: Optional[int] = None
        self._pending_tightest_msa: Optional[int] = None
        self.mesh_policy = mesh_policy
        self._allocator = None
        self._mesh_pool: Optional[ThreadPoolExecutor] = None
        self._inflight_execs = 0        # guarded by _cond (mesh only)
        self._mesh_batches: Dict[str, int] = {}   # label -> batch count
        self._mesh_served: Dict[str, int] = {}    # label -> served reqs
        if mesh_policy is not None:
            self._allocator = mesh_policy.allocator()
            # read-busy + set-gauge must be one atomic step: two pool
            # threads releasing concurrently could otherwise publish a
            # stale nonzero occupancy that sticks until the next lease
            self._gauge_lock = threading.Lock()
            # one executable per (bucket, aligned slice) must fit the
            # LRU or warmup evicts its own work and serving pays the
            # cold mid-batch compile anyway — the scheduler knows the
            # policy and the allocator, so the sizing lives here, not
            # in every caller
            if hasattr(executor, "max_entries"):
                needed = sum(
                    len(self._allocator.slices(
                        mesh_policy.shape_for(edge)))
                    for edge in self.buckets.edges)
                if recycle_policy is not None and self._step_capable:
                    # init + step pair per slice (+ init_rows when the
                    # continuous batcher admits rows mid-loop)
                    needed *= 3 if recycle_policy.continuous else 2
                executor.max_entries = max(executor.max_entries, needed)
            self._c_mesh_folds = reg.counter(
                "serve_mesh_folds_total",
                "fold batches executed, by mesh shape", ("mesh",))
            self._g_mesh_busy = reg.gauge(
                "serve_mesh_busy_devices",
                "devices currently leased to in-flight fold batches")
            self._c_too_large = reg.counter(
                "serve_too_large_total",
                "folds rejected by the HBM admission guard: footprint "
                "exceeds the largest configured mesh slice")
        # cross-bucket admission pricer: built after the
        # mesh block so it shares the HBM model's pair/MSA cost terms
        # when one is configured; None whenever the policy never asks
        # for cross-bucket admission
        self._admission_pricer: Optional[AdmissionPricer] = None
        if recycle_policy is not None and recycle_policy.cross_bucket:
            self._admission_pricer = AdmissionPricer(
                memory=(None if mesh_policy is None
                        else mesh_policy.memory),
                max_pad_frac=recycle_policy.cross_bucket_max_pad_frac)
        self._c_drains = reg.counter(
            "serve_drains_total", "graceful drains started")
        self._c_failovers = reg.counter(
            "fleet_failovers_total",
            "forwarded tickets whose owner's transport died, "
            "re-folded locally")
        self._inflight = InflightRegistry(registry=registry)
        self._cond = threading.Condition()
        self._incoming: deque = deque()
        self._pending: Dict[int, List[_Entry]] = {}
        self._depth = 0            # incoming + pending, guarded by _cond
        self._running = False
        self._drain = True
        self._draining = False     # graceful drain: admitting stopped
        # preemption reclaim: a spot notice flips the
        # scheduler into reclaim mode — a drain variant that stops
        # founding batches and admitting rows, and spills in-flight
        # loops whose remaining recycles cannot fit the grace window.
        # Counters are minted LAZILY on the first notice so a
        # never-preempted scheduler's registry metric-name set and
        # scrubbed stats stay byte-identical (the identity pin).
        self._reclaiming = False
        self._reclaim_deadline: Optional[float] = None
        self._reclaim_source = ""
        self._n_preempt_notices = 0
        self._n_preempt_spills = 0
        self._c_preempt_notices = None
        self._c_preempt_spills = None
        self._outstanding_forwards = 0   # guarded by _cond
        self._worker: Optional[threading.Thread] = None

    # -- model identity ---------------------------------------------------

    @property
    def model_tag(self) -> str:
        return self._model_tag

    @model_tag.setter
    def model_tag(self, tag: str):
        """Reassigning the tag (a weight rollout — fleet.RolloutState
        subscribers do exactly this) re-keys every subsequent cache
        submit AND re-tags the executor, whose ExecKeys carry the tag:
        a rolled scheduler can never serve an executable compiled under
        the previous weights' identity (staleness fix)."""
        self._model_tag = tag
        ex = getattr(self, "executor", None)
        if ex is not None and hasattr(ex, "model_tag"):
            ex.model_tag = tag
        # re-tag the checkpoint spill store too: a rolled scheduler
        # must never resume a carry computed under the previous
        # weights' identity (the store discards stale-tag survivors)
        cs = getattr(self, "_ckpt_store", None)
        if cs is not None:
            cs.model_tag = tag

    @property
    def checkpoint_store(self):
        """The durable checkpoint spill store, or None when the
        `RetryPolicy(checkpoint_spill=)` knob is off. Harnesses wire
        its fleet tiers post-construction (`.peer`, `.backend`) and
        hand it to `fleet.PeerCacheServer.checkpoint_source` so peers
        can fetch this replica's spilled carries."""
        return self._ckpt_store

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "Scheduler":
        with self._cond:
            if self._running:
                return self
            self._running = True
            self._drain = True
            self._draining = False
        # the cascade is one serving unit: the draft tier comes up with
        # the flagship (unless its lifecycle is owned elsewhere)
        if self.cascade is not None and self.cascade.manage_draft:
            self.cascade.draft.start()
        if self._allocator is not None and self._mesh_pool is None:
            self._mesh_pool = ThreadPoolExecutor(
                max_workers=max(1, self._allocator.total_devices),
                thread_name_prefix="serve-mesh")
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="serve-scheduler")
        self._worker.start()
        return self

    def stop(self, drain: bool = True):
        """Stop the worker. drain=True folds everything already queued
        (expired deadlines still shed); drain=False resolves queued
        requests as status='cancelled'."""
        with self._cond:
            self._running = False
            self._drain = drain
            self._cond.notify_all()
        if self._worker is not None:
            self._worker.join()
            self._worker = None
        # stop the draft AFTER the flagship worker: in-flight cascade
        # callbacks may still escalate into (or resolve off) the draft
        # until the flagship queue drained
        if self.cascade is not None and self.cascade.manage_draft:
            self.cascade.draft.stop(drain=drain)
        if self.key_log is not None:
            self.key_log.flush()   # profile durable across restarts
        if self._mesh_pool is not None:
            # the worker already waited out in-flight mesh executions,
            # so this is a fast thread teardown; start() re-creates it
            self._mesh_pool.shutdown(wait=True)
            self._mesh_pool = None
            # the slice groups' ranks exit; a later run starts them anew
            close = getattr(self.executor, "close", None)
            if close is not None:
                close()

    def drain(self, timeout_s: float = 30.0,
              grace_s: Optional[float] = None) -> bool:
        """Graceful drain — THE process-level shutdown path (wire it to
        SIGTERM): stop admitting (new submits raise DrainingError — a
        fleet front door maps that to 503 so callers retry elsewhere),
        wait for outstanding FORWARDED tickets to resolve or fail over
        (bounded by timeout_s; the transport's own poll budget
        guarantees they terminate), then fold everything queued
        (expired deadlines still shed) and fan terminal states out to
        parked followers via the normal settlement machinery. Every
        entry pending at drain start carries a `drain` span from drain
        start to its terminal state, so the waterfall prices what a
        rolling restart costs requests. Returns True when the drain
        fully completed (False = the forwarded-ticket wait timed out;
        local work still resolved). Idempotent; safe from a signal-
        handler-fed thread.

        grace_s: GRACE-BUDGETED drain for a preemption
        reclaim — the process dies in `grace_s` seconds no matter
        what, so finishing folds is conditional: in-flight step loops
        whose remaining recycles FIT the window run to completion;
        loops that cannot fit checkpoint-spill every row at the next
        gap and resolve them "preempted" (the checkpoint survives for
        adoption — see `CheckpointStore.publish_manifest`); queued
        work that never founded resolves "preempted" immediately
        instead of being folded. None (the default) is byte-for-byte
        the finish-everything drain above."""
        if grace_s is None:
            with self._cond:
                if not self._running and not self._draining:
                    return True        # never started / already stopped
                first = not self._draining
                self._draining = True
                if first:
                    for e in itertools.chain(self._incoming,
                                             *self._pending.values()):
                        e.trace.begin("drain")
                    # wake submitters blocked on a full queue NOW: they
                    # must raise DrainingError immediately, not wait out
                    # the forwarded-ticket grace below
                    self._cond.notify_all()
            if first:
                self._n_drains += 1
                self._c_drains.inc()
            complete = True
            deadline = time.monotonic() + timeout_s
            with self._cond:
                while self._outstanding_forwards > 0:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        complete = False
                        break
                    self._cond.wait(timeout=remaining)
            self.stop(drain=True)
            return complete
        # grace-budgeted reclaim drain
        with self._cond:
            if not self._running and not self._draining:
                return True
        self.preempt_notice(grace_s)
        complete = True
        deadline = self._reclaim_deadline or \
            (time.monotonic() + float(grace_s))
        with self._cond:
            while self._outstanding_forwards > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    complete = False
                    break
                self._cond.wait(timeout=remaining)
        # stop WITHOUT the finish-everything drain: queued entries
        # resolve "preempted" via _cancel_remaining (the reclaim flag
        # switches its status), in-flight loops exit through the gap
        # fit-test (finish when it fits, spill when it cannot) before
        # the worker join / mesh-pool shutdown below return
        self.stop(drain=False)
        return complete

    def preempt_notice(self, grace_s: float, source: str = ""):
        """Reclaim mode: this process has `grace_s` seconds
        to live. Stops founding batches and admitting rows (bulk
        included), 503s new submits (`_draining` — the front door
        advertises `preempting` so clients mark this replica down
        immediately), makes every recycle gap checkpoint, and arms the
        gap-time fit test that spills loops the window cannot finish.
        Idempotent — a later duplicate notice only tightens the
        deadline, never extends it. Safe from any thread (the
        PreemptionWatcher's poll thread calls it). Does NOT stop the
        scheduler: the caller owns the actual drain
        (`drain(grace_s=)`) and exit."""
        now = time.monotonic()
        deadline = now + float(grace_s)
        with self._cond:
            first = not self._reclaiming
            self._reclaiming = True
            if self._reclaim_deadline is None \
                    or deadline < self._reclaim_deadline:
                self._reclaim_deadline = deadline
            if source:
                self._reclaim_source = source
            if first:
                self._draining = True
                for e in itertools.chain(self._incoming,
                                         *self._pending.values()):
                    e.trace.begin("preempt")
                self._cond.notify_all()
        if first:
            self._n_preempt_notices += 1
            if self._c_preempt_notices is None:
                # lazy mint: the first notice ever is when the metric
                # family appears (identity discipline)
                self._c_preempt_notices = self._registry.counter(
                    "serve_preempt_notices_total",
                    "preemption notices that flipped the scheduler "
                    "into reclaim mode")
                self._c_preempt_spills = self._registry.counter(
                    "serve_preempt_drain_spills_total",
                    "in-flight step-loop rows checkpoint-spilled by a "
                    "grace-budgeted reclaim drain (resolved "
                    "'preempted' for controller adoption)")
            self._c_preempt_notices.inc()

    @property
    def preempting(self) -> bool:
        """True once a preemption notice flipped this scheduler into
        reclaim mode — the health/503 payloads advertise it so peers
        and clients mark the replica down without a count-up."""
        return self._reclaiming

    def health(self) -> dict:
        """The one health payload every probe shares (the front door's
        /healthz, the peer cache server's, the router's health walk):
        liveness, drain state, queue depth, breaker state. A replica
        with `breaker == "open"` is up but NOT serving novel folds —
        recovery probes must treat it as still-down."""
        with self._cond:
            depth = self._depth
            running = self._running
            draining = self._draining
            reclaiming = self._reclaiming
        payload = {"running": running,
                   "draining": draining,
                   "queue_depth": depth,
                   "breaker": (None if self._breaker is None
                               else self._breaker.state),
                   "model_tag": self.model_tag}
        if reclaiming:
            # only under reclaim: the healthy payload stays
            # byte-identical, and probes treat `preempting` as an
            # immediate mark-down (no consecutive-failure count-up)
            payload["preempting"] = True
        if self._allocator is not None:
            # mesh occupancy rides the one health payload every probe
            # shares, so the fleet front door / peer probes see it free
            payload["mesh"] = self._allocator.snapshot()
        return payload

    def __enter__(self) -> "Scheduler":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def warmup(self, msa_depth: Optional[int] = None) -> int:
        """Precompile every bucket at the serving signature so the first
        real request pays queueing, not a program build. Returns fresh
        builds.
        Defaults to the config's pinned msa_depth; the guarantee only
        holds when serving shapes are pinned to match (config.msa_depth,
        or uniform-depth traffic equal to this depth). With a mesh
        policy, each bucket warms on EVERY aligned slice of its shape:
        executables are bound to concrete devices, so a batch dispatched
        to a cold slice would pay a fresh program build mid-serving —
        exactly the unlucky-first-request cost warmup exists to
        pre-pay. (Run warmup before start(); it touches slices without
        leasing them.)"""
        if msa_depth is None:
            msa_depth = self.config.msa_depth or 0
        keys = [(edge, self.config.max_batch_size, msa_depth,
                 self.config.num_recycles) for edge in self.buckets.edges]
        # with a recycle policy the serving path runs the init+step
        # executable pair (plus the row-masked init_rows admission
        # program when continuous), never the opaque fold — warm what
        # will run so a mid-loop row admission never compiles mid-serve
        step_mode = self._use_step_loop()
        continuous = self._use_continuous()
        if self._allocator is None:
            if self.kernel_policy is None:
                return self.executor.warmup(keys, step_mode=step_mode,
                                            continuous=continuous)
            # per-bucket kernel routing: warm the executable
            # each bucket will ACTUALLY serve — a sparse-routed bucket
            # compiled dense here would still pay its kernel compile on
            # the first real request
            return sum(self.executor.warmup(
                [key], step_mode=step_mode, continuous=continuous,
                kernel=self._kernel_spec_for(key[0])) for key in keys)
        # the guard rejects a bucket that does not fit at submit;
        # compiling it would be the OOM it prevents
        keys = [key for key in keys if self.mesh_policy.admits(
            key[0], key[1], key[2], carry_recyclables=step_mode,
            continuous=continuous)]
        prestart = getattr(self.executor, "prestart", None)
        if prestart is not None:
            # every slice group starts now, side by side; each bucket's
            # warm-up below waits only for its own
            for key in keys:
                shape = self.mesh_policy.shape_for(key[0])
                for devices in self._allocator.slices(shape):
                    prestart(devices, shape)
        fresh = 0
        for key in keys:
            shape = self.mesh_policy.shape_for(key[0])
            k_kw = {} if self.kernel_policy is None else \
                {"kernel": self._kernel_spec_for(key[0])}
            for devices in self._allocator.slices(shape):
                fresh += self.executor.warmup(
                    [key], devices=devices, mesh_shape=shape,
                    step_mode=step_mode, continuous=continuous, **k_kw)
        return fresh

    def _use_step_loop(self) -> bool:
        return self.recycle_policy is not None and self._step_capable

    def _use_continuous(self) -> bool:
        """True when the step loop will ADMIT rows mid-recycle
        (continuous batching): a step-capable executor that
        also speaks the row-masked init variant, under a policy that
        asked for it."""
        return self._use_step_loop() and self.recycle_policy.continuous \
            and hasattr(self.executor, "run_init_rows")

    def _use_cross_bucket(self) -> bool:
        """True when freed rows may additionally admit pending work
        from SHORTER buckets at the host shape (cross-bucket continuous
        batching) — the continuous machinery plus a policy
        that asked for it (the pricer exists iff it did)."""
        return self._use_continuous() and self.recycle_policy.cross_bucket

    def _eager_form_on(self) -> bool:
        """Admission-aware batch formation: form an
        under-filled batch immediately instead of waiting out max_wait,
        counting on mid-loop row admission to top it up. Only
        meaningful when admission can actually run."""
        return self._use_continuous() and self.recycle_policy.eager_form

    # -- kernel selection -------------------------------------

    def _kernel_spec_for(self, bucket_len: int):
        """The static first-pass KernelSpec this bucket serves under
        the kernel policy (None = dense / policy off)."""
        if self.kernel_policy is None:
            return None
        return self.kernel_policy.spec_for(bucket_len)

    def _record_kernel_batch(self, bucket_len: int, spec, n_served: int,
                             contact: bool = False):
        """Per-(kernel, bucket) accounting for one executed batch.
        No-op without a policy — `serve_stats()` stays byte-identical."""
        if self.kernel_policy is None:
            return
        kind = "dense" if spec is None else "blocksparse"
        if contact:
            kind += "-contact"
        key = (kind, bucket_len)
        with self._cond:
            self._kernel_served[key] = \
                self._kernel_served.get(key, 0) + n_served
            self._kernel_batches[key] = \
                self._kernel_batches.get(key, 0) + 1
        self._c_kernel_folds.inc(n_served, kernel=kind,
                                 bucket=str(bucket_len))

    # -- submission ------------------------------------------------------

    def _raise_unless_running(self, entry: _Entry):
        """Lifecycle gate for submit()'s early-exit paths (quarantine,
        cache/forward, breaker): a stopped/unstarted scheduler raises
        for every request — lifecycle wins over content and breaker
        state, it never tells the caller to wait out a recovery that
        will never come."""
        with self._cond:
            if not self._running:
                entry.trace.finish("error", error="submit before start")
                raise RuntimeError("Scheduler.submit() before start()")

    def submit(self, request: FoldRequest,
               trace=None, _escalation: bool = False) -> FoldTicket:
        """trace: an already-started obs.Trace to continue instead of
        minting a fresh one — the feature pool passes the raw job's
        trace so its `featurize` span and the fold stages land in ONE
        record. None (the default, every pre-pipeline caller) is
        byte-for-byte the old behavior.

        _escalation (private): this submit IS a cascade escalation —
        skip the cascade branch and ride the ordinary flagship path,
        so an escalated request can never recurse into a second draft
        attempt."""
        bucket_len = self.buckets.bucket_for(request.length)  # fail fast
        entry = _Entry(request, bucket_len)
        entry.trace = (trace if trace is not None
                       else self.tracer.start_trace(request.request_id))
        entry.trace.begin("submit")
        # express lane accounting: every terminal outcome of
        # an express-QoS request lands in its own metric class, armed
        # here so each of submit()'s many terminal paths is covered
        # uniformly. Lazy mint: no express traffic, no express metrics.
        if getattr(request, "qos", "online") == "express" \
                and not _escalation:
            self._arm_express(entry)
        # draining beats everything, cache hits included: a replica
        # being rolled must shrink to empty, and its caller must take
        # the work to a peer that will still be alive to serve it
        if self._draining:
            entry.trace.finish("rejected", error="draining")
            raise DrainingError(
                "Scheduler draining: not admitting new requests")
        # key-frequency telemetry at INGRESS only: a forwarded hop is
        # the same user request already counted where it arrived
        if self.key_log is not None and not request.forwarded:
            self.key_log.observe(request.seq, request.msa)
        # HBM admission guard: a fold whose analytic footprint exceeds
        # even the largest configured mesh slice would die in a CUDA
        # OOM mid-batch, taking its whole cohort with it — reject it at
        # the door instead. An unpinned msa_depth (None) prices the
        # REQUEST's own depth: assemble pads the batch to its members'
        # max, so each member is priced at (at least) what it brings.
        # A store hit still serves (mirroring degraded mode — a cached
        # result costs no device memory); only coalescing/forwarding is
        # pointless for work this process can never execute.
        if self.mesh_policy is not None:
            guard_msa = self.config.msa_depth
            if guard_msa is None:
                guard_msa = 0 if request.msa is None \
                    else int(request.msa.shape[0])
            if not self.mesh_policy.admits(
                    bucket_len, self.config.max_batch_size, guard_msa,
                    carry_recyclables=self._use_step_loop(),
                    continuous=self._use_continuous()):
                self._raise_unless_running(entry)
                if not self._serve_too_large_from_cache(entry):
                    self._too_large_shed(entry)
                return entry.ticket
        # quarantined poison fails fast BEFORE cache/coalesce/forward:
        # a known-bad key must not re-fold, park followers, or burn a
        # forwarding hop
        if self._quarantine is not None and len(self._quarantine):
            self._raise_unless_running(entry)
            if self._fail_fast_quarantined(entry):
                return entry.ticket
        # bulk tier: lowest-QoS sweep work takes its own
        # queue. A store hit still serves (campaign re-runs are
        # idempotent), but bulk never coalesces or forwards — a bulk
        # LEADER could park online duplicates behind work the burn
        # gate may starve indefinitely, and a forwarded hop would
        # spend an online transport slot on background work
        if self.bulk is not None and \
                getattr(request, "qos", "online") == "bulk":
            self._raise_unless_running(entry)
            if self._serve_bulk_from_cache(entry):
                return entry.ticket
            if self._breaker is not None \
                    and not self._breaker.allow_submit():
                self._degraded_shed(entry)
                return entry.ticket
            return self._submit_bulk(entry)
        # speculative cascade: interactive classes fold on
        # the draft tier first; the confidence gate accepts or
        # escalates back through this seam (_escalation=True). This
        # sits BEFORE the cache/coalesce block: a cascaded entry must
        # not become a flagship coalescing LEADER — a draft-accepted
        # leader would settle its flagship-keyed followers with a
        # draft result. Bulk never cascades (background work has no
        # latency to speculate for, and a draft+flagship double fold
        # would cost MORE accelerator-seconds, the one thing bulk
        # optimizes).
        if self.cascade is not None and not _escalation \
                and getattr(request, "qos", "online") != "bulk":
            self._raise_unless_running(entry)
            return self._submit_cascade(entry)
        if self.cache is not None or self.router is not None:
            self._raise_unless_running(entry)
            if self.cache is not None \
                    and self._serve_from_cache_or_coalesce(entry):
                return entry.ticket
            if self._maybe_forward(entry):
                return entry.ticket
        # degraded mode: the breaker is open, so a NOVEL fold would only
        # queue behind a failing executor — fast-shed it. Cache hits and
        # coalesce attaches were already served above; forwarding to a
        # healthy owner also beats shedding, so this sits after both.
        if self._breaker is not None and not self._breaker.allow_submit():
            self._raise_unless_running(entry)
            self._degraded_shed(entry)
            return entry.ticket
        try:
            with self._cond:
                if not self._running:
                    raise RuntimeError("Scheduler.submit() before start()")
                # queued entries AND parked followers occupy the bound
                # (waiting() is 0 with no cache); follower settlement
                # notifies _cond so block-mode waiters see the shrink.
                # A LEADER gates on depth alone: its own parked
                # followers can only settle after it enqueues and
                # folds, so counting them here would be a circular
                # wait — leader parked forever on capacity that only
                # its own settlement frees. Follower growth is bounded
                # at attach time instead.
                while self._depth + (
                        self._inflight.waiting()
                        if entry.cache_key is None else 0) \
                        >= self.config.queue_limit:
                    if self.config.full_policy == "reject":
                        self.metrics.record_rejected()
                        raise QueueFullError(
                            f"queue at limit {self.config.queue_limit}")
                    self._cond.wait()
                    if not self._running:
                        raise RuntimeError("Scheduler stopped while "
                                           "blocked on a full queue")
                    if self._draining:
                        raise DrainingError(
                            "Scheduler started draining while blocked "
                            "on a full queue")
                entry.mark_enqueued()
                entry.trace.end("submit")
                entry.trace.begin("queue")
                self._incoming.append(entry)
                self._depth += 1
                depth = self._depth
                self._cond.notify_all()
        except BaseException as exc:
            # a leader that never made it into the queue still owes its
            # followers an exit: on a queue-full rejection, promote the
            # tightest-deadline survivor to leader (its siblings stay
            # parked behind it) — a rejected leader must not turn N
            # viable duplicates into N errors; on anything else (the
            # scheduler stopped mid-submit) error out the group
            rejected = isinstance(exc, QueueFullError)
            entry.trace.finish("rejected" if rejected else "error",
                               error=str(exc))
            if not (rejected and self._promote_follower(entry)):
                self._settle_followers(entry, FoldResponse(
                    request_id=request.request_id, status="error",
                    bucket_len=bucket_len,
                    error="coalescing leader rejected at submit "
                          "(queue full or scheduler stopped)"))
            raise
        self.metrics.record_enqueued(depth)
        return entry.ticket

    def submit_raw(self, raw, trace=None) -> FoldTicket:
        """Accept one RAW job (serve.features.RawFoldRequest: an AA
        string or untokenized array plus raw MSA). With a
        `feature_pool` attached, featurization runs off the hot path on
        the pool's workers — feature cache, in-flight featurize
        coalescing, feature-key routing and the `featurize` trace span
        all apply (the two-stage pipeline). Without one
        (the default), featurize runs inline right here and the result
        goes through the ordinary submit() — exactly what callers
        hand-rolled before this method existed, so the off switch is
        byte-for-byte today's behavior. Returns the same FoldTicket
        either way.

        trace: an already-started obs.Trace to continue (the front
        door passes a remote hop's continued trace); None —
        the default — mints one exactly as before."""
        from alphafold2_tpu_torch.serve.features import featurize_raw
        if self.feature_pool is not None:
            return self.feature_pool.submit_raw(raw, self, trace=trace)
        if getattr(raw, "qos", "online") == "express":
            # the express lane IS the MSA-bypass featurizer — without a
            # FeaturePool carrying one, "express" would silently serve
            # the full prep path under an express deadline it can't meet
            raise ValueError(
                "qos='express' needs a FeaturePool with an express "
                "featurizer (Scheduler(feature_pool=FeaturePool("
                "express=...)))")
        feats = featurize_raw(raw)
        return self.submit(FoldRequest(
            seq=feats.seq, msa=feats.msa, request_id=raw.request_id,
            priority=raw.priority, deadline_s=raw.deadline_s,
            forwarded=raw.forwarded,
            qos=getattr(raw, "qos", "online")), trace=trace)

    # -- cache / coalescing ----------------------------------------------

    def _cache_key_for(self, request: FoldRequest) -> str:
        # a result-affecting recycle policy (converge_tol > 0 can serve
        # an early-exited fold) keys under distinct extras; tol-0 /
        # policy-off schedulers keep the bare key and stay
        # cache-compatible with each other and with offline
        # fold_and_write callers — an early-exited result must NEVER be
        # served to a caller demanding fixed full recycles
        extras = None
        if self.recycle_policy is not None:
            extras = self.recycle_policy.key_extras()
        return fold_key(request.seq, request.msa,
                        msa_depth=self.config.msa_depth,
                        num_recycles=self.config.num_recycles,
                        model_tag=self.model_tag, extras=extras)

    def _serve_from_cache_or_coalesce(self, entry: _Entry) -> bool:
        """submit() fast path: True when the entry was fully handled
        (resolved from the store, or parked behind the in-flight
        leader). Cache trouble of any kind degrades to a miss — a
        broken cache must cost a recompute, never fail a submit."""
        try:
            # store_key holds the digest when the quarantine check
            # already paid for it this submit
            key = entry.store_key or self._cache_key_for(entry.request)
            # route BEFORE the cache lookup: a key this replica is
            # about to forward must not pay a guaranteed-miss peer
            # fetch to the very owner the request is going to (worst
            # case a full peer timeout when the owner is down, ahead
            # of a forward that would also fail) — the memory/disk
            # tiers still answer, only the network tier is skipped
            will_forward = self._route(entry, key)
            cached = self.cache.get(key, trace=entry.trace,
                                    peer=not will_forward)
        except Exception:                     # get() never raises; keying
            self.metrics.record_cache_miss()  # trouble degrades to a miss
            return False
        if cached is not None:
            self.metrics.record_cache_hit()
            entry.resolve(FoldResponse(
                request_id=entry.request.request_id, status="ok",
                coords=cached.coords.copy(),
                confidence=cached.confidence.copy(),
                bucket_len=entry.bucket_len,
                latency_s=time.monotonic() - entry.enqueued_at,
                source="cache"))
            return True
        self.metrics.record_cache_miss()
        # parked followers hold real memory (their request arrays), so
        # the bounded-queue invariant must cover them too: a duplicate
        # storm on one hot key must not grow the registry unboundedly
        # where pre-cache behavior would have hit queue_limit. Check
        # and attach under ONE lock — a window between them would let
        # concurrent duplicates all pass the check and overshoot the
        # limit. (Lock order _cond -> registry lock; no path takes them
        # in the other order.)
        def _trace_parked(leader):
            # runs under the registry lock: settlement cannot have
            # resolved (and emitted) this trace yet, so the leader
            # link is guaranteed to make it into the record
            if leader is not None:
                entry.trace.link(leader.trace.trace_id)
            entry.trace.event("coalesced")
            entry.trace.end("submit")
            entry.trace.begin("parked")

        with self._cond:
            if (self._depth + self._inflight.waiting()
                    >= self.config.queue_limit):
                # cache-aware admission: an in-flight
                # duplicate costs ~0 — it parks behind the leader and
                # never touches the accelerator — so a "full" queue may
                # still admit it as a FOLLOWER, bounded by the
                # parked-bytes budget on its request arrays. Only an
                # EXISTING leader qualifies (attach_follower refuses
                # otherwise): a novel key would enqueue exactly the
                # real work the bound just refused.
                budget = self.config.parked_bytes_budget
                if budget > 0:
                    nbytes = entry.request.seq.nbytes + (
                        0 if entry.request.msa is None
                        else entry.request.msa.nbytes)

                    def _trace_parked_admit(leader):
                        entry.trace.event("parked_admit", bytes=nbytes)
                        _trace_parked(leader)

                    if self._parked_admit_bytes + nbytes <= budget \
                            and self._inflight.attach_follower(
                                key, entry,
                                on_follower=_trace_parked_admit):
                        entry.parked_admit_bytes = nbytes
                        self._parked_admit_bytes += nbytes
                        self._n_parked_admits += 1
                        self._c_parked_admits.inc()
                        self.metrics.record_coalesced()
                        return True
                if self.config.full_policy == "reject":
                    self.metrics.record_rejected()
                    entry.trace.finish("rejected",
                                       error="queue + followers at limit")
                    raise QueueFullError(
                        f"queue + coalesced followers at limit "
                        f"{self.config.queue_limit}")
                # "block": fall through to the normal enqueue path,
                # which waits for capacity and folds this duplicate —
                # bounded beats deduped when the queue is saturated
                # (the fold still populates the store via store_key)
                entry.store_key = key
                return False
            is_leader, _ = self._inflight.attach_with_leader(
                key, entry, on_follower=_trace_parked)
        if not is_leader:
            self.metrics.record_coalesced()
            return True                       # follower: leader settles us
        entry.cache_key = key                 # leader: enqueue + settle
        return False

    # -- resilience: submit side -----------------------------------------

    def _entry_key(self, entry: _Entry) -> Optional[str]:
        """Best-effort content key for quarantine bookkeeping. Works
        without a cache attached (fold_key needs no store); keying
        trouble returns None — an unkeyable request can neither be
        quarantined nor fail fast, it just folds. The computed digest is
        memoized on the entry (store_key) so the cache/coalesce path
        never hashes the same seq+MSA twice."""
        if entry.cache_key is not None:
            return entry.cache_key
        if entry.store_key is not None:
            return entry.store_key
        try:
            entry.store_key = self._cache_key_for(entry.request)
            return entry.store_key
        except Exception:
            return None

    def _fail_fast_quarantined(self, entry: _Entry) -> bool:
        """True when the entry's key is quarantined poison: resolved
        status "poisoned" without touching queue, cache, or fleet."""
        key = self._entry_key(entry)
        if key is None or key not in self._quarantine:
            return False
        self.metrics.record_poisoned()
        entry.trace.event("quarantine_fastfail")
        entry.resolve(FoldResponse(
            request_id=entry.request.request_id, status="poisoned",
            bucket_len=entry.bucket_len,
            latency_s=time.monotonic() - entry.enqueued_at,
            error=f"request key quarantined as poison "
                  f"({self._quarantine.reason(key)}); failing fast"))
        return True

    def _serve_too_large_from_cache(self, entry: _Entry) -> bool:
        """Store-only lookup for a fold the admission guard would
        reject: a result computed elsewhere (a peer with bigger slices,
        an offline warm, this replica before a policy change) serves at
        zero device cost. No coalescing — there is no in-flight leader
        to park behind for work this process can never execute."""
        if self.cache is None:
            return False
        try:
            key = self._entry_key(entry)
            if key is None:
                return False
            cached = self.cache.get(key, trace=entry.trace)
        except Exception:
            return False
        if cached is None:
            return False
        self.metrics.record_cache_hit()
        entry.resolve(FoldResponse(
            request_id=entry.request.request_id, status="ok",
            coords=cached.coords.copy(),
            confidence=cached.confidence.copy(),
            bucket_len=entry.bucket_len,
            latency_s=time.monotonic() - entry.enqueued_at,
            source="cache"))
        return True

    def _too_large_shed(self, entry: _Entry):
        """HBM admission guard fast path: resolve a fold no configured
        mesh slice can hold as status "too_large" without enqueueing."""
        self.metrics.record_too_large()
        self._c_too_large.inc()
        entry.trace.event("too_large")
        chips = self.mesh_policy.chips_for(entry.bucket_len)
        entry.resolve(FoldResponse(
            request_id=entry.request.request_id, status="too_large",
            bucket_len=entry.bucket_len,
            latency_s=time.monotonic() - entry.enqueued_at,
            error=f"analytic HBM footprint of bucket {entry.bucket_len} "
                  f"exceeds the largest configured mesh slice "
                  f"({chips} chips); rejected by the admission guard"))

    def _degraded_shed(self, entry: _Entry):
        """Breaker-open fast path: resolve a novel submit as
        status "degraded" without enqueueing."""
        self.metrics.record_degraded()
        entry.trace.event("degraded_shed")
        resp = FoldResponse(
            request_id=entry.request.request_id, status="degraded",
            bucket_len=entry.bucket_len,
            latency_s=time.monotonic() - entry.enqueued_at,
            error="circuit breaker open: scheduler in degraded mode, "
                  "novel folds shed at the door")
        entry.resolve(resp)
        # followers that attached in the window between this entry
        # becoming leader and the breaker check inherit the same state
        # (no-op for non-leaders)
        self._settle_followers(entry, resp)

    # -- speculative cascade + express lane --------------------

    def _arm_express(self, entry: _Entry):
        """Route every terminal outcome of an express-QoS request into
        the express metric class (counter by outcome, latency histogram
        by bucket) via a ticket done-callback — one hook covers all of
        submit()'s terminal paths uniformly. Metrics are minted on the
        FIRST express submit: a scheduler that never sees express
        traffic keeps the registry metric-name set byte-identical."""
        if self._c_express is None:
            self._c_express = self._registry.counter(
                "serve_express_requests_total",
                "terminal outcomes of express-QoS requests",
                ("outcome",))
            self._h_express = self._registry.histogram(
                "serve_express_latency_seconds",
                "submit-to-resolve latency of served express requests",
                ("bucket_len",))

        def _done(resp, entry=entry):
            outcome = "served" if resp.ok else resp.status
            self._express_counts[outcome] = \
                self._express_counts.get(outcome, 0) + 1
            self._c_express.inc(outcome=outcome)
            if resp.ok and resp.latency_s is not None:
                self._h_express.observe(
                    resp.latency_s,
                    bucket_len=(resp.bucket_len
                                if resp.bucket_len is not None
                                else entry.bucket_len))

        entry.ticket.add_done_callback(_done)

    def _submit_cascade(self, entry: _Entry) -> FoldTicket:
        """Draft-first fold: speculate on the cheap tier, gate on its
        own confidence, escalate losers to the flagship through the
        ordinary submit seam. The caller's ticket resolves exactly once
        on every path (accept, escalate, draft refusal, expired
        deadline, gate crash)."""
        policy = self.cascade
        request = entry.request
        entry.trace.event("cascade")
        # a flagship store hit short-circuits the draft: the
        # full-quality result is free, speculating would only add a
        # draft fold on top of it
        flagship_key = None
        cached = None
        if self.cache is not None:
            try:
                flagship_key = self._cache_key_for(request)
                cached = self.cache.get(flagship_key, trace=entry.trace)
            except Exception:
                flagship_key, cached = None, None
        if cached is not None:
            self.metrics.record_cache_hit()
            self._c_cascade.inc(tier="flagship", outcome="cache_hit")
            entry.resolve(FoldResponse(
                request_id=request.request_id, status="ok",
                coords=cached.coords.copy(),
                confidence=cached.confidence.copy(),
                bucket_len=entry.bucket_len,
                latency_s=time.monotonic() - entry.enqueued_at,
                source="cache", tier="flagship"))
            return entry.ticket
        # cross-tier tripwire: the shared FoldCache keys tiers apart by
        # model_tag ALONE, so equal keys mean a keying regression that
        # could serve draft structures under a flagship key. Never
        # speculate across it — escalate straight to the flagship.
        if flagship_key is not None:
            try:
                draft_key = policy.draft._cache_key_for(request)
            except Exception:
                draft_key = None
            if draft_key is not None and draft_key == flagship_key:
                self._n_cross_tier_hits += 1
                self._c_cross_tier.inc()
                entry.trace.event("cascade_cross_tier_key")
                self._escalate_cascade(entry, None, "cross_tier_key")
                return entry.ticket
        remaining = None if entry.deadline is None else \
            max(entry.deadline - time.monotonic(), 0.0)
        draft_req = FoldRequest(
            seq=request.seq, msa=request.msa,
            request_id=request.request_id, priority=request.priority,
            deadline_s=policy.draft_deadline(remaining))
        entry.trace.begin("draft")
        try:
            inner = policy.draft.submit(draft_req)
        except Exception as exc:
            # a refusing draft (full queue, draining, stopped) costs
            # the caller nothing but this failed speculation — the
            # flagship still owes the fold
            self._n_draft_errors += 1
            self._c_cascade.inc(tier="draft", outcome="refused")
            entry.trace.end("draft")
            entry.trace.event("draft_refused", error=repr(exc))
            self._escalate_cascade(entry, None, "draft_refused")
            return entry.ticket

        def _on_draft(resp, entry=entry):
            # runs on the draft's resolving thread; done-callbacks
            # swallow exceptions, so everything that can throw is
            # guarded — the caller's ticket must terminate regardless
            try:
                entry.trace.end("draft")
                if not resp.ok:
                    self._n_draft_errors += 1
                    self._c_cascade.inc(tier="draft", outcome=resp.status)
                    self._escalate_cascade(entry, None,
                                           f"draft_{resp.status}")
                    return
                score = score_response(resp)
                self._confidence_sum += score.score
                self._confidence_n += 1
                if not policy.gate.accepts(score):
                    self._c_cascade.inc(tier="draft", outcome="rejected")
                    self._escalate_cascade(entry, score,
                                           "low_confidence")
                    return
                self._n_draft_accepted += 1
                self._c_cascade.inc(tier="draft", outcome="accepted")
                latency = time.monotonic() - entry.enqueued_at
                self.metrics.record_served(entry.bucket_len, latency)
                entry.trace.event("draft_accepted",
                                  confidence=round(score.score, 4))
                entry.resolve(FoldResponse(
                    request_id=entry.request.request_id, status="ok",
                    coords=resp.coords, confidence=resp.confidence,
                    bucket_len=entry.bucket_len, latency_s=latency,
                    source=resp.source, attempts=resp.attempts,
                    recycles=resp.recycles, tier="draft",
                    confidence_score=score.score,
                    distogram_entropy=resp.distogram_entropy))
            except Exception as exc:
                try:
                    self.metrics.record_error()
                    entry.resolve(FoldResponse(
                        request_id=entry.request.request_id,
                        status="error", bucket_len=entry.bucket_len,
                        error=f"cascade gate failed: {exc!r}",
                        tier="draft"))
                except Exception:
                    pass

        inner.add_progress_callback(entry.ticket._publish_progress)
        inner.add_done_callback(_on_draft)
        return entry.ticket

    def _escalate_cascade(self, entry: _Entry, score, reason: str):
        """Hand a cascaded entry to the flagship tier: re-enter
        submit() with the escalation flag, priority boosted, deadline
        re-anchored to what remains of the CALLER's budget (the draft
        attempt already spent some of it). Called from submit()'s
        thread (cross-tier / draft-refused) or the draft's resolving
        thread (gate reject, draft error) — never raises; every
        failure resolves the caller's ticket."""
        self._n_escalated += 1
        self._c_cascade.inc(tier="flagship", outcome="escalated")
        entry.trace.event("escalated", reason=reason)
        request = entry.request
        remaining = None
        if entry.deadline is not None:
            remaining = entry.deadline - time.monotonic()
            if remaining <= 0:
                # the draft ate the whole budget: shed, exactly as the
                # queue would have — folding dead work helps nobody
                self.metrics.record_shed()
                entry.resolve(FoldResponse(
                    request_id=request.request_id, status="shed",
                    bucket_len=entry.bucket_len,
                    latency_s=time.monotonic() - entry.enqueued_at,
                    error=f"deadline exhausted before escalation "
                          f"({reason})",
                    tier="flagship", escalated=True,
                    confidence_score=(None if score is None
                                      else score.score)))
                return
        esc = FoldRequest(
            seq=request.seq, msa=request.msa,
            request_id=request.request_id,
            priority=request.priority + self.cascade.escalation_priority,
            deadline_s=remaining, forwarded=request.forwarded,
            qos=request.qos)
        try:
            inner = self.submit(esc, trace=entry.trace, _escalation=True)
        except Exception as exc:
            # the inner submit already finished the (shared) trace and
            # recorded its rejection; the outer ticket still owes the
            # caller a terminal state
            self.metrics.record_error()
            entry.resolve(FoldResponse(
                request_id=request.request_id, status="error",
                bucket_len=entry.bucket_len,
                latency_s=time.monotonic() - entry.enqueued_at,
                error=f"escalation refused: {exc!r}",
                tier="flagship", escalated=True))
            return

        def _on_flagship(resp, entry=entry, score=score):
            try:
                entry.resolve(dataclasses.replace(
                    resp,
                    latency_s=time.monotonic() - entry.enqueued_at,
                    tier="flagship", escalated=True,
                    confidence_score=(None if score is None
                                      else score.score)))
            except Exception:
                try:
                    entry.resolve(resp)
                except Exception:
                    pass

        inner.add_progress_callback(entry.ticket._publish_progress)
        inner.add_done_callback(_on_flagship)

    # -- bulk tier --------------------------------------------

    def _serve_bulk_from_cache(self, entry: _Entry) -> bool:
        """Store-only lookup for a bulk submit (no coalescing — see
        submit()); sets store_key either way so the eventual fold
        writes back and the NEXT campaign run hits."""
        if self.cache is None:
            return False
        key = self._entry_key(entry)
        if key is None:
            return False
        try:
            cached = self.cache.get(key, trace=entry.trace)
        except Exception:
            return False
        if cached is None:
            self.metrics.record_cache_miss()
            return False
        self.metrics.record_cache_hit()
        entry.resolve(FoldResponse(
            request_id=entry.request.request_id, status="ok",
            coords=cached.coords.copy(),
            confidence=cached.confidence.copy(),
            bucket_len=entry.bucket_len,
            latency_s=time.monotonic() - entry.enqueued_at,
            source="cache"))
        return True

    def _submit_bulk(self, entry: _Entry) -> FoldTicket:
        """Enqueue into the bulk queue — its own bound, kept OUT of
        `_depth` so background backlog can never push the online queue
        into its full policy."""
        q = self._bulk_queue
        if len(q) >= self.bulk.max_pending:
            self._n_bulk_rejected += 1
            self.metrics.record_rejected()
            entry.trace.finish(
                "rejected", error="bulk queue at limit")
            raise QueueFullError(
                f"bulk queue at limit {self.bulk.max_pending}")
        entry.mark_enqueued()
        entry.trace.end("submit")
        entry.trace.begin("bulk")
        with self._cond:
            q.push(entry.bucket_len, entry)
            self._cond.notify_all()
        return entry.ticket

    def _bulk_gated(self) -> bool:
        """True while online burn rate exceeds BulkPolicy.max_burn —
        the SLO engine's own report throttles the bulk tier. The
        report is cached for check_interval_s (it walks registry
        histograms); racy reads of the cached flag are fine. Without
        an SLO engine there is no burn signal and bulk is never
        gated."""
        if self.bulk is None or self.slo is None:
            return False
        now = time.monotonic()
        if now - self._bulk_last_check < self.bulk.check_interval_s:
            return self._bulk_gated_flag
        self._bulk_last_check = now
        burn = 0.0
        try:
            report = self.slo.report()
            for cls in report.get("classes", {}).values():
                b = (cls.get("latency") or {}).get("burn_rate")
                if b is not None:
                    burn = max(burn, float(b))
        except Exception:
            burn = 0.0             # a broken report must not gate bulk
        gated = burn > self.bulk.max_burn
        if gated != self._bulk_gated_flag:
            self._bulk_gated_flag = gated
            self._g_bulk_gated.set(1 if gated else 0)
        return gated

    def _take_bulk_candidate(self, bucket_len: int,
                             batch_msa_depth: int) -> Optional[_Entry]:
        """Work-stealing admission: one bulk entry for a freed row of
        `bucket_len`'s host batch — called only after every online
        take (same-bucket and cross-bucket) came up empty, and only
        while the burn gate is open. Expired deadlines shed here, at
        take time (bulk entries never ride the online shed sweep);
        an unpinned-msa_depth head deeper than the running batch's
        compiled depth goes back to the head (same rule as online
        admission — truncating it would serve different content)."""
        q = self._bulk_queue
        if q is None or not len(q) or self._bulk_gated():
            return None
        now = time.monotonic()
        while True:
            e = q.take(bucket_len)
            if e is None:
                return None
            if e.deadline is not None and now >= e.deadline:
                self._shed_bulk(e)
                continue
            if self.config.msa_depth is None \
                    and e.request.msa is not None \
                    and int(e.request.msa.shape[0]) > batch_msa_depth:
                q.push_front(bucket_len, e)
                return None
            e.trace.end("bulk")
            e.trace.event("bulk_stolen", bucket=bucket_len)
            self._count_bulk_admits(1)
            return e

    def _form_bulk_batch(self, stopping: bool):
        """Idle founding: bulk work founds a batch ONLY when no online
        work is pending anywhere (the caller checked, under _cond) —
        and even then not while the burn gate is closed, except during
        a draining stop, where terminal resolution beats throttling."""
        q = self._bulk_queue
        if q is None or not len(q):
            return None
        if not stopping and self._bulk_gated():
            return None
        now = time.monotonic()
        for bucket_len in q.buckets():
            if self._allocator is not None and not self._allocator \
                    .can_allocate(self.mesh_policy.shape_for(bucket_len)):
                continue
            take: List[_Entry] = []
            while len(take) < self.config.max_batch_size:
                e = q.take(bucket_len)
                if e is None:
                    break
                if e.deadline is not None and now >= e.deadline:
                    self._shed_bulk(e)
                    continue
                e.trace.end("bulk")
                take.append(e)
            if take:
                self._count_bulk_admits(len(take))
                return bucket_len, take
        return None

    def _count_bulk_admits(self, n: int):
        self._n_bulk_admits += n
        self._c_bulk_admits.inc(n)

    def _shed_bulk(self, e: _Entry):
        self.metrics.record_shed()
        e.trace.event("deadline_shed")
        self._resolve_entry(e, FoldResponse(
            request_id=e.request.request_id, status="shed",
            bucket_len=e.bucket_len,
            latency_s=time.monotonic() - e.enqueued_at,
            error="deadline expired while queued (bulk)"))

    def _yield_bulk_rows(self, state, active, rows, ages,
                         all_members) -> int:
        """Checkpoint-and-yield: under online burn, spill
        every bulk row's carry to the durable store and requeue its
        entry as resumable — the freed rows go to online admission at
        this very gap. Requires the spill store: without one a yield
        would refold from zero, so bulk rows run to completion
        instead. Returns the number of rows freed."""
        store = self._ckpt_store
        if store is None or self._bulk_queue is None:
            return 0
        idx = [i for i, e in enumerate(active)
               if getattr(e.request, "qos", "online") == "bulk"]
        if not idx:
            return 0
        from alphafold2_tpu_torch.cache.checkpoints import row_checkpoint
        from alphafold2_tpu_torch.predict import snapshot_step_state
        try:
            snap = snapshot_step_state(state)
        except Exception:
            return 0
        yielded = []
        for i in idx:
            e = active[i]
            key = self._entry_key(e)
            if key is None:
                continue
            try:
                ck = row_checkpoint(
                    snap, rows[i], fold_key=key,
                    model_tag=self.model_tag, age=ages[i],
                    seq=e.request.seq, msa=e.request.msa)
            except ValueError:
                continue       # unspillable carry: the row keeps folding
            if store.put_row(ck) is None:
                continue
            yielded.append(i)
        if not yielded:
            return 0
        gone = set(yielded)
        requeued = [active[i] for i in yielded]
        active[:] = [e for i, e in enumerate(active) if i not in gone]
        rows[:] = [r for i, r in enumerate(rows) if i not in gone]
        ages[:] = [a for i, a in enumerate(ages) if i not in gone]
        # a yielded entry now lives in the bulk queue, not this loop:
        # it must leave the batch's failure/orphan bookkeeping too, or
        # a later batch failure would double-resolve it
        gone_ids = {id(e) for e in requeued}
        all_members[:] = [e for e in all_members
                          if id(e) not in gone_ids]
        with self._cond:
            for e in requeued:
                e.trace.event("bulk_yielded")
                e.trace.begin("bulk")
                self._bulk_queue.push_front(e.bucket_len, e)
            self._n_bulk_yields += len(requeued)
            self._c_bulk_yields.inc(len(requeued))
            self._cond.notify_all()
        return len(requeued)

    # -- preemption reclaim -----------------------------------

    def _reclaim_fits(self, bucket_len: int, ages: List[int],
                      num_recycles: int) -> bool:
        """Can this loop's remaining recycles finish inside the grace
        window? Priced with the bucket's measured step-seconds EWMA at
        a 2x safety margin — the window must also pay for the final
        fetch, the manifest publish, and the process exit, and
        finishing 'probably' is not worth losing the spill. An unknown
        EWMA (no step measured yet) says NO: spilling loses at most
        `checkpoint_every` recycles, overrunning the window loses the
        whole fold."""
        deadline = self._reclaim_deadline
        if deadline is None:
            return False
        ewma = self._step_ewma.get(bucket_len)
        if ewma is None:
            return False
        remaining = max(num_recycles - a for a in ages)
        return remaining * ewma * 2.0 <= deadline - time.monotonic()

    def _preempt_spill_loop(self, bucket_len: int, state,
                            active: List[_Entry], rows: List[int],
                            ages: List[int],
                            all_members: List[_Entry]) -> int:
        """Grace-budgeted hand-off of one in-flight step loop: spill
        every row's carry to the durable store (where one is
        configured and the carry slices), then resolve EVERY row
        "preempted" — the ticket must never outlive the process, and
        the "preempted" terminal keeps its checkpoint so the adopting
        survivor resumes at this exact age. Unspillable rows (no
        store, unkeyable, unsliceable) still resolve "preempted":
        their callers re-fold from zero on a survivor — work lost,
        tickets never. Returns the number of rows spilled."""
        store = self._ckpt_store
        snap = None
        if store is not None and active:
            from alphafold2_tpu_torch.cache.checkpoints import row_checkpoint
            from alphafold2_tpu_torch.predict import snapshot_step_state
            try:
                snap = snapshot_step_state(state)
            except Exception:
                snap = None
        spilled = 0
        now = time.monotonic()
        members = list(active)
        member_rows = list(rows)
        member_ages = list(ages)
        for i, e in enumerate(members):
            wrote = False
            if snap is not None:
                key = self._entry_key(e)
                if key is not None:
                    try:
                        ck = row_checkpoint(
                            snap, member_rows[i], fold_key=key,
                            model_tag=self.model_tag,
                            age=member_ages[i],
                            seq=e.request.seq, msa=e.request.msa)
                        wrote = store.put_row(ck) is not None
                    except ValueError:
                        wrote = False
            if wrote:
                spilled += 1
            e.trace.begin("preempt")
            e.trace.event("preempt_spilled" if wrote
                          else "preempt_dropped",
                          recycle=member_ages[i])
            self.metrics.record_preempted()
            self._resolve_entry(e, FoldResponse(
                request_id=e.request.request_id, status="preempted",
                bucket_len=e.bucket_len, attempts=e.attempts,
                latency_s=now - e.enqueued_at,
                recycles=member_ages[i],
                error=("replica preempted mid-loop; checkpoint "
                       "spilled for adoption" if wrote else
                       "replica preempted mid-loop; carry not "
                       "spillable — refold on a survivor")))
        gone_ids = {id(e) for e in members}
        active[:] = []
        rows[:] = []
        ages[:] = []
        all_members[:] = [e for e in all_members
                          if id(e) not in gone_ids]
        self._n_preempt_spills += spilled
        if spilled and self._c_preempt_spills is not None:
            self._c_preempt_spills.inc(spilled)
        return spilled

    # -- fleet routing ---------------------------------------------------

    def _route(self, entry: _Entry, key: str) -> bool:
        """Compute (once) and remember the routing decision for `key`;
        True iff the plan is to forward. Routing trouble of any kind
        means 'serve locally'."""
        if self.router is None or entry.request.forwarded:
            return False
        try:
            entry.route = self.router.route(key)
        except Exception:
            return False
        return not entry.route.is_local

    def _maybe_forward(self, entry: _Entry) -> bool:
        """submit() fleet hop: True when the entry was handed to its
        consistent-hash owner (the remote ticket resolves ours via a
        done-callback). False — fold locally — when routing is off, the
        request already took its one hop, the key hashes home, or
        ANYTHING about forwarding fails: fleet state degrades to
        single-host behavior, it never degrades availability."""
        if self.router is None or entry.request.forwarded:
            return False
        key = entry.cache_key or entry.store_key
        if key is None:               # router without cache still routes
            try:
                key = self._cache_key_for(entry.request)
            except Exception:
                return False
        if entry.route is None:      # not computed by the cache fast path
            self._route(entry, key)
        decision = entry.route
        if decision is None:         # routing trouble: serve locally
            return False
        if decision.is_local:
            if decision.reason != "local_owner":
                entry.trace.event("routed", owner=decision.owner_id or "",
                                  reason=decision.reason)
            return False
        owner = decision.owner_id
        entry.trace.event("routed", owner=owner, reason=decision.reason)
        entry.trace.begin("forward")
        try:
            remote = self.router.forward(
                owner, dataclasses.replace(entry.request, forwarded=True),
                trace=entry.trace)
        except Exception:
            # owner vanished / transport error / remote backpressure:
            # local fallback (the fold is still correct, just not
            # fleet-deduplicated)
            self.router.note_fallback("forward_error")
            entry.trace.end("forward", failed=True)
            return False
        entry.trace.end("submit")
        with self._cond:
            # drain() waits on this: a forwarded ticket is in-flight
            # work this replica still owes its caller a terminal for
            self._outstanding_forwards += 1

        def _on_remote(resp: FoldResponse):
            try:
                self._handle_remote(entry, owner, resp)
            finally:
                with self._cond:
                    self._outstanding_forwards -= 1
                    self._cond.notify_all()

        remote.add_done_callback(_on_remote)
        return True

    def _handle_remote(self, entry: _Entry, owner: str,
                       resp: FoldResponse):
        """Terminal handling for one forwarded ticket: adapt the remote
        response onto the local entry — or, when the response carries
        the transport-failure marker (the owner died, partitioned, or
        restarted mid-fold; fleet.rpc.HttpTransport stamps it), FAIL
        OVER to folding locally: the work is still viable, only the
        owner is gone, and the caller must never pay for fleet
        topology with an error."""
        now = time.monotonic()
        entry.trace.end("forward", owner=owner)
        # the marker string is fleet.rpc.RPC_TRANSPORT_MARKER; spelled
        # literally here because serve must not import fleet (fleet
        # already imports serve)
        if (resp is not None and resp.status == "error" and resp.error
                and "rpc_transport" in resp.error
                and self._failover_local(entry, owner)):
            return
        try:
            local = FoldResponse(
                request_id=entry.request.request_id,
                status=resp.status,
                coords=(None if resp.coords is None
                        else np.array(resp.coords, np.float32,
                                      copy=True)),
                confidence=(None if resp.confidence is None
                            else np.array(resp.confidence, np.float32,
                                          copy=True)),
                bucket_len=(resp.bucket_len
                            if resp.bucket_len is not None
                            else entry.bucket_len),
                latency_s=now - entry.enqueued_at,
                # "forwarded", not the remote's source: THIS replica
                # did not fold it, and the trace checker's
                # fold-span-required rule keys off source == "fold"
                error=resp.error, source="forwarded",
                # the owner's retry/bisection cost travels with the
                # result (getattr: a pre-resilience peer's response
                # has no attempts field)
                attempts=getattr(resp, "attempts", 1))
        except Exception as exc:   # e.g. MemoryError on the copies
            local = FoldResponse(
                request_id=entry.request.request_id, status="error",
                bucket_len=entry.bucket_len,
                error=f"forwarded response adaptation failed: "
                      f"{exc!r}")
        try:
            # populates the local store (repeat traffic for this key
            # becomes a local hit) and settles local followers
            self._resolve_entry(entry, local)
        except Exception:
            entry.resolve(local)   # never orphan the caller's ticket

    def _failover_local(self, entry: _Entry, owner: str) -> bool:
        """Re-enqueue a transport-failed forwarded entry for a LOCAL
        fold. False when the scheduler can no longer fold (stopped) —
        the caller then resolves the transport error as terminal. The
        entry skips the submit fast paths (cache/route already ran) and
        keeps its original deadline clock: the time lost to the dead
        owner counts against the request, exactly like a retry."""
        with self._cond:
            if not self._running:
                return False
            entry.trace.event("failover_local", owner=owner)
            entry.trace.begin("queue")
            self._incoming.append(entry)
            self._depth += 1
            depth = self._depth
            self._cond.notify_all()
        self._n_failovers += 1
        self._c_failovers.inc()
        try:
            self.router.note_fallback("remote_failover")
        except Exception:
            pass
        self.metrics.record_enqueued(depth)
        return True

    def _promote_follower(self, entry: _Entry) -> bool:
        """A coalescing leader dropped out without a result (shed while
        queued, rejected at submit): crown its tightest-deadline parked
        follower as the new leader and enqueue it; the remaining
        followers stay parked behind the new leader. Returns False when
        there is nothing to promote (not a leader, no followers, or the
        scheduler is no longer running — the caller then settles the
        group with the old leader's terminal state)."""
        if entry.cache_key is None:
            return False

        def _tightest(followers: List[_Entry]) -> _Entry:
            # min absolute deadline first; deadline-free followers have
            # infinite slack and go last
            return min(followers,
                       key=lambda f: (f.deadline is None,
                                      f.deadline if f.deadline is not None
                                      else 0.0))

        with self._cond:
            if not self._running:
                return False
            # lock order _cond -> registry lock, same as the attach path
            promoted = self._inflight.promote(entry.cache_key, _tightest)
            if promoted is None:
                return False
            promoted.cache_key = entry.cache_key
            promoted.trace.event("leader_promoted",
                                 from_trace=entry.trace.trace_id)
            # a budget-admitted follower that becomes leader now
            # occupies real queue depth, not parked-budget bytes
            nbytes, promoted.parked_admit_bytes = \
                promoted.parked_admit_bytes, 0
            self._parked_admit_bytes -= nbytes
            promoted.trace.end("parked")
            promoted.trace.begin("queue")
            # parked -> queued conversion: waiting() shrank by one as
            # _depth grows by one, so the bounded-queue invariant
            # (depth + waiting <= limit) is preserved, not re-checked
            self._incoming.append(promoted)
            self._depth += 1
            depth = self._depth
            self._cond.notify_all()
        self.metrics.record_enqueued(depth)
        return True

    def _release_parked_admit(self, entry: _Entry):
        """Return a budget-admitted follower's bytes to the parked
        admission budget. Called from every path a follower leaves the
        registry (settle fan-out, own-deadline eviction, promotion);
        no-op for normally admitted entries."""
        nbytes = entry.parked_admit_bytes
        if not nbytes:
            return
        entry.parked_admit_bytes = 0
        with self._cond:
            self._parked_admit_bytes -= nbytes
            self._cond.notify_all()

    def _settle_followers(self, entry: _Entry, response: FoldResponse):
        """Fan the leader's terminal response out to its followers.
        Called from EVERY path that resolves a leader ticket, success or
        failure, so a coalesced ticket can never be left hanging."""
        if entry.cache_key is None:
            return
        followers: List[_Entry] = self._inflight.settle(entry.cache_key)
        for f in followers:
            self._release_parked_admit(f)
        if followers:
            # parked followers counted against queue_limit: their
            # release frees capacity block-mode submitters wait on
            with self._cond:
                self._cond.notify_all()
        now = time.monotonic()
        for f in followers:
            if response.status == "ok":
                try:
                    resp = FoldResponse(
                        request_id=f.request.request_id, status="ok",
                        coords=response.coords.copy(),
                        confidence=response.confidence.copy(),
                        bucket_len=response.bucket_len,
                        latency_s=now - f.enqueued_at, source="coalesced")
                except Exception as exc:  # e.g. MemoryError on the copy:
                    resp = FoldResponse(  # never orphan the remaining fan-out
                        request_id=f.request.request_id, status="error",
                        bucket_len=f.bucket_len, source="coalesced",
                        error=f"coalesced fan-out failed: {exc!r}")
                f.resolve(resp)
            else:
                f.resolve(FoldResponse(
                    request_id=f.request.request_id,
                    status=response.status, bucket_len=f.bucket_len,
                    latency_s=now - f.enqueued_at, source="coalesced",
                    error=f"coalesced onto leader "
                          f"{response.request_id}: "
                          f"{response.error or response.status}"))

    def _resolve_entry(self, entry: _Entry, response: FoldResponse):
        """Terminal state for one queued entry: populate the store (ok
        only, BEFORE followers settle so late duplicates hit the cache),
        resolve the leader ticket, fan out to followers — except a SHED
        leader, whose surviving followers get a promoted leader instead
        of inheriting the shed (the group's work is still viable; only
        this request's deadline died)."""
        put_key = entry.cache_key or entry.store_key
        if response.status == "ok" and self.cache is not None \
                and put_key is not None:
            with entry.trace.span("writeback"):
                try:
                    self.cache.put(put_key, response.coords,
                                   response.confidence)
                except Exception:
                    pass              # a full/broken store never blocks
        entry.resolve(response)
        # a terminal state means the spilled checkpoint must not
        # outlive the work: resumable survivors exist only
        # for folds some ticket still waits on. Requeue/bisection/
        # resume paths never come through here, so their checkpoints
        # survive for the retry to consume. "preempted" is the one
        # terminal that KEEPS its checkpoint: the fold is
        # not done, it is migrating — the orphan manifest hands it to
        # an adopting survivor that resumes from exactly these bytes.
        if self._ckpt_store is not None \
                and response.status != "preempted":
            key = self._entry_key(entry)
            if key is not None:
                try:
                    self._ckpt_store.discard(key)
                except Exception:
                    pass
        if response.status == "shed" and self._promote_follower(entry):
            return
        self._settle_followers(entry, response)

    def serve_stats(self) -> dict:
        """Health-check snapshot: serving counters + executor cache +
        result-cache section ("cache": submit-side counters always;
        "store"/"inflight" sub-views only when a cache is attached)."""
        stats = self.metrics.snapshot()
        stats["executor"] = self.executor.stats()
        stats["bucket_edges"] = list(self.buckets.edges)
        # slowest completed request traces (empty without a tracer)
        stats["traces"] = self.tracer.slowest()
        if self.cache is not None:
            stats["cache"]["store"] = self.cache.snapshot()
            stats["cache"]["inflight"] = self._inflight.snapshot()
            stats["cache"]["parked_admits"] = self._n_parked_admits
            with self._cond:
                stats["cache"]["parked_admit_bytes"] = \
                    self._parked_admit_bytes
        if self.router is not None:
            stats["router"] = self.router.snapshot()
        if self.retry is not None:
            stats["resilience"] = {
                "retries": self._n_retries,
                "bisections": self._n_bisections,
                "watchdog_fires": self._n_watchdog_fires,
                "executor_rebuilds": self._n_rebuilds,
                "nonfinite_outputs": self._n_nonfinite,
                "quarantine": self._quarantine.snapshot(),
                "breaker": (None if self._breaker is None
                            else self._breaker.snapshot()),
                "watchdog_s": self.retry.watchdog_s,
                "max_attempts": self.retry.max_attempts,
            }
            # step-loop fault-domain keys appear only when a knob is
            # on: `retry=` without them keeps the plain retry path's
            # resilience section byte-identical
            if getattr(self.retry, "checkpoint_every", 0) \
                    or getattr(self.retry, "row_isolation", False):
                stats["resilience"].update({
                    "checkpoint_every":
                        getattr(self.retry, "checkpoint_every", 0),
                    "row_isolation":
                        bool(getattr(self.retry, "row_isolation",
                                     False)),
                    "checkpoints": self._n_checkpoints,
                    "checkpoint_resumes": self._n_ckpt_resumes,
                    "recycles_lost": self._n_recycles_lost,
                    "row_poison_isolations": self._n_row_isolations,
                })
            # durable spill: keys appear only when the
            # checkpoint_spill knob names a directory — same identity
            # discipline as the step-loop block above
            if self._ckpt_store is not None:
                stats["resilience"]["checkpoint_spill"] = dict(
                    self._ckpt_store.snapshot(),
                    spill_resumes=self._n_spill_resumes,
                    survivors_at_boot=self._boot_survivors)
        if self.bulk is not None:
            stats["bulk"] = {
                "pending": len(self._bulk_queue),
                "admits": self._n_bulk_admits,
                "yields": self._n_bulk_yields,
                "rejected": self._n_bulk_rejected,
                "gated": self._bulk_gated_flag,
                "max_burn": self.bulk.max_burn,
            }
        if self.cascade is not None:
            decided = self._n_draft_accepted + self._n_escalated
            stats["cascade"] = {
                "draft_tag": getattr(self.cascade.draft, "model_tag",
                                     ""),
                "draft_accepted": self._n_draft_accepted,
                "escalated": self._n_escalated,
                "draft_errors": self._n_draft_errors,
                "cross_tier_hits": self._n_cross_tier_hits,
                "accept_rate": (self._n_draft_accepted / decided
                                if decided else 0.0),
                "mean_confidence": (self._confidence_sum
                                    / self._confidence_n
                                    if self._confidence_n else None),
                "accept_plddt": self.cascade.gate.accept_plddt,
                "max_entropy": self.cascade.gate.max_entropy,
            }
            draft_stats = getattr(self.cascade.draft, "serve_stats",
                                  None)
            if draft_stats is not None:
                try:
                    d = draft_stats()
                    stats["cascade"]["draft"] = {
                        "served": d.get("served", 0),
                        "errors": d.get("errors", 0),
                        "shed": d.get("shed", 0),
                        "queue_depth": d.get("queue_depth", 0),
                        "batches": d.get("batches", 0),
                    }
                except Exception:
                    pass       # obs must never fail stats
        # express section only once express traffic minted its metrics
        # (keeps the no-express snapshot byte-identical)
        if self._c_express is not None:
            stats["express"] = dict(self._express_counts)
        if self.mesh_policy is not None:
            with self._cond:
                folds = {label: {"batches": self._mesh_batches[label],
                                 "served": self._mesh_served.get(label, 0)}
                         for label in sorted(self._mesh_batches)}
                inflight = self._inflight_execs
            stats["mesh"] = dict(self.mesh_policy.snapshot(),
                                 allocator=self._allocator.snapshot(),
                                 inflight_batches=inflight,
                                 folds=folds)
        if self.recycle_policy is not None:
            row_steps = self._row_steps_total
            stats["recycle"] = dict(
                self.recycle_policy.snapshot(),
                step_mode=self._use_step_loop(),
                recycles_executed=self._n_recycles_exec,
                recycles_skipped=self._n_recycles_skipped,
                preemptions=self._n_preemptions,
                preempt_hbm_refusals=self._n_preempt_hbm_refusals,
                retired_early=self._n_retired_early,
                # row-level occupancy over every executed step: the
                # number continuous batching exists to drive to 1.0
                # (identical keys with continuous off, so the loadtest
                # baseline comparison reads the same stat)
                row_admissions=self._n_row_admissions,
                rows_dead_steps=self._n_rows_dead_steps,
                rows_occupied_fraction=(
                    self._row_steps_live / row_steps if row_steps
                    else 0.0),
                # cross-bucket admission (zero/off keys kept
                # when the feature is off so baselines compare)
                cross_bucket_admissions=self._n_cross_admissions,
                cross_bucket_refusals=self._n_cross_refusals)
        if self.kernel_policy is not None:
            with self._cond:
                folds = {f"{kind}:{bucket}":
                         {"batches": self._kernel_batches.get(
                             (kind, bucket), 0),
                          "served": served}
                         for (kind, bucket), served
                         in sorted(self._kernel_served.items())}
            stats["kernel"] = dict(self.kernel_policy.snapshot(),
                                   folds=folds)
        if self.feature_pool is not None:
            stats["featurize"] = self.feature_pool.snapshot()
        if self.key_log is not None:
            stats["key_log"] = self.key_log.snapshot()
        if self.slo is not None:
            # report() also refreshes the slo_* gauges, so a stats
            # poll and a Prometheus scrape read the same window
            try:
                stats["slo"] = self.slo.report()
            except Exception as exc:      # obs must never fail stats
                stats["slo"] = {"error": repr(exc)}
        with self._cond:
            stats["running"] = self._running
            stats["draining"] = self._draining
            stats["outstanding_forwards"] = self._outstanding_forwards
        stats["failovers"] = self._n_failovers
        stats["drains"] = self._n_drains
        if self._n_preempt_notices:
            # preemption reclaim: key absent until a notice
            # lands, so scrubbed stats stay identical with the feature
            # unexercised
            with self._cond:
                deadline = self._reclaim_deadline
                stats["preemption"] = {
                    "reclaiming": self._reclaiming,
                    "source": self._reclaim_source,
                    "notices": self._n_preempt_notices,
                    "drain_spills": self._n_preempt_spills,
                    "grace_remaining_s": (
                        max(0.0, deadline - time.monotonic())
                        if deadline is not None else 0.0),
                }
        return stats

    # -- worker ----------------------------------------------------------

    def _run(self):
        try:
            self._run_inner()
        except Exception as exc:   # worker must never die silently:
            self._fail_outstanding(repr(exc))
            return
        if not self._drain:
            self._cancel_remaining()

    def _run_inner(self):
        poll_s = self.config.poll_ms / 1000.0
        just_executed = False   # a ready batch may already be waiting
        while True:
            with self._cond:
                if not just_executed and not self._incoming \
                        and self._running:
                    # timed wait only while entries pend (max_wait_ms /
                    # deadline bookkeeping needs the clock); a fully
                    # idle scheduler parks until submit()/stop() notify.
                    # Pending BULK work also forces the timed wait: the
                    # burn gate reopens on its own (no notify), so a
                    # parked worker would never found the gated backlog
                    if any(self._pending.values()) \
                            or (self._bulk_queue is not None
                                and len(self._bulk_queue)):
                        self._cond.wait(timeout=poll_s)
                    else:
                        self._cond.wait()
                while self._incoming:
                    entry = self._incoming.popleft()
                    self._pending.setdefault(entry.bucket_len,
                                             []).append(entry)
                if self.recycle_policy is not None \
                        and self.recycle_policy.preempt \
                        and self._allocator is not None:
                    # the ONLY reader is the leased preemption path,
                    # so the scan is skipped entirely when no pool
                    # thread could ever consult it. Eligibility is
                    # _urgent_eligible — the same predicate the
                    # preemption take uses, so the worker never
                    # advertises a deadline the take would refuse.
                    # The tightest entry's slice size rides along so
                    # a leased loop can tell whether yielding even
                    # COULD place it.
                    now_p = time.monotonic()
                    tightest, t_bucket, t_entry = None, None, None
                    for b_len, pend in self._pending.items():
                        for e in pend:
                            if not self._urgent_eligible(e, now_p):
                                continue
                            if tightest is None or e.deadline < tightest:
                                tightest, t_bucket, t_entry = \
                                    e.deadline, b_len, e
                    self._pending_tightest = tightest
                    self._pending_tightest_bucket = (
                        None if tightest is None else t_bucket)
                    # the entry's OWN MSA depth rides along: with an
                    # unpinned config (msa_depth=None) the HBM pricing
                    # of a preemption yield must cover what this batch
                    # will actually carry, not a zero-depth lowball
                    self._pending_tightest_msa = (
                        None if t_entry is None
                        or t_entry.request.msa is None
                        else int(t_entry.request.msa.shape[0]))
                    self._pending_tightest_chips = (
                        None if tightest is None
                        or self.mesh_policy is None
                        else chips_of(
                            self.mesh_policy.shape_for(t_bucket)))
                stopping = not self._running
                drain = self._drain
            if stopping and not drain:
                break
            self._shed_expired()
            batch = self._form_batch(stopping)
            just_executed = batch is not None
            if batch is not None:
                self._dispatch(*batch)
                continue
            if stopping:
                with self._cond:
                    if self._incoming or any(self._pending.values()) \
                            or (self._bulk_queue is not None
                                and len(self._bulk_queue)):
                        if self._allocator is not None:
                            # every eligible slice is busy: wait for a
                            # completion to free one, don't hot-spin
                            self._cond.wait(timeout=poll_s)
                        continue
                    if self._inflight_execs > 0:
                        # mesh batches still running on the dispatch
                        # pool: a drained stop means every ticket
                        # resolved, so wait them out (they may also
                        # requeue retries — re-check from the top)
                        self._cond.wait(timeout=poll_s)
                        continue
                break

    def _resolve_removed(self, entries: List[_Entry]):
        """Entries left the queue: update depth, wake blocked submitters."""
        if not entries:
            return
        with self._cond:
            self._depth -= len(entries)
            self._cond.notify_all()

    def _shed_expired(self):
        now = time.monotonic()
        shed: List[_Entry] = []
        # under _cond: continuous row admission takes from _pending on
        # dispatch-pool threads, so every _pending mutation
        # is lock-guarded now (the Condition's RLock nests fine)
        with self._cond:
            for bucket_len, entries in self._pending.items():
                keep = []
                for e in entries:
                    if e.deadline is not None and now > e.deadline:
                        shed.append(e)
                    else:
                        keep.append(e)
                self._pending[bucket_len] = keep
        self._resolve_removed(shed)
        for e in shed:
            self.metrics.record_shed()
            self._resolve_entry(e, FoldResponse(
                request_id=e.request.request_id, status="shed",
                bucket_len=e.bucket_len,
                latency_s=now - e.enqueued_at,
                attempts=e.attempts or 1,   # deadline may die mid-backoff
                error="deadline expired before folding"))
        self._shed_expired_followers(now)

    def _shed_expired_followers(self, now: float):
        """Enforce parked followers' OWN deadlines: a coalesced follower
        whose deadline passes while waiting on its leader is shed with
        its own terminal state instead of inheriting the leader's
        timing. The leader keeps folding — only the waiter gives up."""
        if self.cache is None:
            return
        expired = self._inflight.evict_followers(
            lambda f: f.deadline is not None and now > f.deadline)
        if not expired:
            return
        for f in expired:
            self._release_parked_admit(f)
        with self._cond:
            self._cond.notify_all()   # waiting() shrank: wake blocked
        for f in expired:             # submitters before resolving
            self.metrics.record_shed()
            self._c_follower_deadline.inc()
            f.trace.event("follower_deadline_exceeded")
            f.resolve(FoldResponse(
                request_id=f.request.request_id, status="shed",
                bucket_len=f.bucket_len,
                latency_s=now - f.enqueued_at, source="coalesced",
                error="follower deadline expired while parked on an "
                      "in-flight leader (follower_deadline_exceeded)"))

    def _form_batch(self, stopping: bool):
        """Pick the bucket whose oldest entry has waited longest, if any
        bucket is ready (full batch, max_wait exceeded, or draining).
        With a retry policy: backoff-gated entries are not ready yet,
        bisection isolation groups batch only with each other, and an
        open circuit breaker pauses execution entirely (drain on stop
        still executes — a stopping scheduler owes every ticket a
        terminal state and retries are disabled while stopping)."""
        cfg = self.config
        now = time.monotonic()
        if self._reclaiming:
            # reclaim mode: a preempted process must never
            # FOUND a batch — work it starts now it cannot finish, and
            # queued entries resolve "preempted" at stop so their
            # callers re-fold on a survivor instead
            return None
        if not stopping and self._breaker is not None \
                and not self._breaker.allow_execute():
            return None
        best = None                      # (oldest, bucket_len, take)
        # under _cond: continuous row admission (pool threads) also
        # takes from _pending, so candidate selection + removal must be
        # one atomic step against it
        with self._cond:
            for bucket_len, entries in self._pending.items():
                if not entries:
                    continue
                # mesh: a bucket whose slice shape has no free devices
                # is not ready — forming its batch would just park it;
                # other buckets' slices may be free right now
                if self._allocator is not None and not \
                        self._allocator.can_allocate(
                            self.mesh_policy.shape_for(bucket_len)):
                    continue
                cand = self._bucket_candidate(entries, stopping, now)
                if cand is not None and (best is None
                                         or cand[0] < best[0]):
                    best = (cand[0], bucket_len, cand[1])
            if best is None:
                # bulk founding is legal only when NO online
                # work is pending anywhere — checked under the same
                # lock that admits online work, so a racing submit
                # either lands before this check (and wins the batch)
                # or after (and waits exactly one bulk loop, the same
                # as any work behind a running batch)
                online_idle = (self._bulk_queue is not None
                               and not self._incoming
                               and not any(self._pending.values()))
            else:
                # selection + removal stay ONE atomic step against
                # pool-thread row admission takes
                _, bucket_len, take = best
                taken = {id(e) for e in take}
                self._pending[bucket_len] = [
                    e for e in self._pending[bucket_len]
                    if id(e) not in taken]
        if best is None:
            if online_idle:
                return self._form_bulk_batch(stopping)
            return None
        if self._breaker is not None:
            self._breaker.begin_probe()  # no-op unless half-open
        self._resolve_removed(take)
        return bucket_len, take

    def _bucket_candidate(self, entries: List[_Entry], stopping: bool,
                          now: float) -> Optional[Tuple[float,
                                                        List[_Entry]]]:
        """One bucket's best executable batch as (oldest_enqueued_at,
        entries), or None when nothing is ready."""
        if self.retry is None:
            return self._ready_take(entries, stopping, now)
        # retry-aware: backoff gates eligibility (ignored while
        # stopping — drain must terminate), isolation groups jump the
        # normal ready rules (their members already waited a full
        # batch's worth; re-bisection only ever shrinks them)
        eligible = entries if stopping else \
            [e for e in entries if e.not_before <= now]
        if not eligible:
            return None
        normal: List[_Entry] = []
        group_best = None
        groups: Dict[int, List[_Entry]] = {}
        for e in eligible:
            if e.group is None:
                normal.append(e)
            else:
                groups.setdefault(e.group, []).append(e)
        for members in groups.values():
            oldest = min(e.enqueued_at for e in members)
            if group_best is None or oldest < group_best[0]:
                group_best = (oldest, members)
        if group_best is not None:
            return group_best
        # normal is non-empty here: eligible was non-empty and every
        # grouped entry returned through group_best above
        return self._ready_take(normal, stopping, now)

    def _ready_take(self, entries: List[_Entry], stopping: bool,
                    now: float) -> Optional[Tuple[float, List[_Entry]]]:
        """max_batch/max_wait readiness over one non-empty entry list:
        (oldest_enqueued_at, take) or None when not ready yet. The one
        copy of the ready rule, shared by the retry-off and retry-on
        batching paths so they cannot drift."""
        cfg = self.config
        oldest = min(e.enqueued_at for e in entries)
        # eager formation: with mid-loop admission available
        # to top an under-filled batch up, any entry at all makes the
        # bucket ready — max_wait becomes a fallback, not a floor
        ready = (len(entries) >= cfg.max_batch_size
                 or (now - oldest) * 1000.0 >= cfg.max_wait_ms
                 or stopping
                 or self._eager_form_on())
        if not ready:
            return None
        # higher priority folds first; FIFO within a priority level
        take = sorted(entries, key=lambda e: (-e.request.priority,
                                              e.enqueued_at))
        return oldest, take[:cfg.max_batch_size]

    def _dispatch(self, bucket_len: int, entries: List[_Entry]):
        """Run one formed batch: inline (the classic single-chip path,
        byte-for-byte the old behavior) or, with a mesh policy, on a
        leased device slice via the dispatch pool — so batches holding
        DISJOINT slices execute concurrently and short traffic never
        queues behind a flagship fold."""
        if self._allocator is None:
            self._execute(bucket_len, entries)
            return
        lease = self._allocator.acquire(
            self.mesh_policy.shape_for(bucket_len))
        if lease is None:
            # _form_batch checked availability and the worker is the
            # only acquirer, so this is unreachable in practice — but a
            # policy/allocator bug must degrade to a serial fold on the
            # default device, never lose the batch
            self._execute(bucket_len, entries)
            return
        # EVERYTHING between acquire and the pool handoff is guarded
        # (audit): an exception from the gauge or the inflight
        # bookkeeping would otherwise strand the slice forever — the
        # lease must be released on every path that fails to hand it to
        # _execute_on_lease's try/finally
        counted = False
        try:
            self._set_busy_gauge()
            with self._cond:
                self._inflight_execs += 1
            counted = True
            self._mesh_pool.submit(self._execute_on_lease, bucket_len,
                                   entries, lease)
        except BaseException:
            # pool unavailable (shutdown race) or bookkeeping trouble:
            # fall back inline
            self._release_lease(lease)
            if counted:
                with self._cond:
                    self._inflight_execs -= 1
                    self._cond.notify_all()
            self._execute(bucket_len, entries)

    def _execute_on_lease(self, bucket_len: int, entries: List[_Entry],
                          lease: SliceLease):
        try:
            self._execute(bucket_len, entries, lease=lease)
        finally:
            self._release_lease(lease)
            with self._cond:
                self._inflight_execs -= 1
                self._cond.notify_all()

    def _release_lease(self, lease: SliceLease):
        self._allocator.release(lease)
        self._set_busy_gauge()

    def _set_busy_gauge(self):
        with self._gauge_lock:
            self._g_mesh_busy.set(self._allocator.busy_devices)

    def _execute(self, bucket_len: int, entries: List[_Entry],
                 lease: Optional[SliceLease] = None):
        if self._use_step_loop():
            self._execute_recycle(bucket_len, entries, lease)
            return
        cfg = self.config
        t0 = time.monotonic()
        if self.tracer.enabled:
            for e in entries:
                e.trace.end("queue", bucket_len=bucket_len)
                e.trace.end("retry")   # closes a retry-wait span; no-op
            #                            on a first execution
            # batch-level spans (assemble / compile / fold) are measured
            # once and fanned out to every member's trace
            batch_trace = MultiTrace([e.trace for e in entries])
        else:
            batch_trace = NULL_TRACE
        for e in entries:
            e.attempts += 1
        # the whole assemble -> run -> device-fetch window is guarded:
        # entries already left the queue, so an unresolved exception here
        # would orphan their tickets forever (resolve as error instead)
        try:
            with batch_trace.span("batch_form", bucket_len=bucket_len,
                                  n_real=len(entries)):
                batch, waste = self.buckets.assemble(
                    [e.request for e in entries], bucket_len,
                    cfg.max_batch_size, msa_depth=cfg.msa_depth,
                    device=self._device())
            kspec = self._kernel_spec_for(bucket_len)
            result = self._run_executor(batch, batch_trace, lease,
                                        kernel=kspec)
            coords = _host(result.coords)
            confidence = _host(result.confidence)
            distogram = None
            if cfg.confidence_summary:
                dg = getattr(result, "distogram", None)
                if dg is not None:
                    distogram = _host(dg)
        except Exception as exc:  # resolve/retry, never kill the worker
            if self._handle_batch_failure(bucket_len, entries, exc, t0):
                return            # retried, bisected, or quarantined
            self.metrics.record_error(len(entries))
            for e in entries:
                self._resolve_entry(e, FoldResponse(
                    request_id=e.request.request_id, status="error",
                    bucket_len=bucket_len, error=repr(exc),
                    attempts=e.attempts))
            return
        # output validation (retry-enabled only): non-finite coords/
        # confidence never leave as "ok" — they count toward poison
        # detection for this entry's key
        finite_ok = None
        if self.retry is not None:
            finite_ok = [bool(np.isfinite(coords[i, :e.request.length])
                              .all()
                              and np.isfinite(
                                  confidence[i, :e.request.length]).all())
                         for i, e in enumerate(entries)]
        if self._breaker is not None:
            # a batch with non-finite rows is device-suspect the same
            # way a transient failure is: a systemic NaN episode must
            # OPEN the breaker, not keep resetting it batch by batch
            (self._breaker.record_success
             if finite_ok is None or all(finite_ok)
             else self._breaker.record_failure)()
        now = time.monotonic()
        real_tokens = 0
        try:
            for i, e in enumerate(entries):
                n = e.request.length
                real_tokens += n
                if finite_ok is not None and not finite_ok[i]:
                    self._resolve_nonfinite(e, bucket_len)
                    continue
                latency = now - e.enqueued_at
                self.metrics.record_served(bucket_len, latency)
                ent = None
                if distogram is not None:
                    try:
                        ent = _distogram_entropy(distogram[i, :n, :n])
                    except Exception:
                        ent = None  # a summary must never fail a serve
                self._resolve_entry(e, FoldResponse(
                    request_id=e.request.request_id, status="ok",
                    # copy: a view would pin the whole padded batch in
                    # the caller's hands for the lifetime of the response
                    coords=coords[i, :n].copy(),
                    confidence=confidence[i, :n].copy(),
                    bucket_len=bucket_len, latency_s=latency,
                    attempts=e.attempts, distogram_entropy=ent))
        except Exception as exc:
            # resolution machinery failed mid-batch (e.g. MemoryError on
            # a response copy): entries already left the queue, so
            # anything still unresolved must be error-resolved HERE or
            # its caller blocks forever — then keep serving
            for e in entries:
                if not e.ticket.done():
                    self.metrics.record_error()
                    try:
                        self._resolve_entry(e, FoldResponse(
                            request_id=e.request.request_id,
                            status="error", bucket_len=bucket_len,
                            error=f"post-fold resolution failed: "
                                  f"{exc!r}"))
                    except Exception:
                        e.resolve(FoldResponse(
                            request_id=e.request.request_id,
                            status="error", bucket_len=bucket_len,
                            error=f"post-fold resolution failed: "
                                  f"{exc!r}"))
            return
        if lease is not None:
            self._c_mesh_folds.inc(mesh=lease.label)
        self._record_kernel_batch(bucket_len, kspec, len(entries))
        with self._cond:
            if lease is not None:
                self._mesh_batches[lease.label] = \
                    self._mesh_batches.get(lease.label, 0) + 1
                self._mesh_served[lease.label] = \
                    self._mesh_served.get(lease.label, 0) + len(entries)
            depth = self._depth
        try:
            self.metrics.record_batch(
                bucket_len, cfg.max_batch_size, len(entries), real_tokens,
                waste, now - t0, depth,
                cache_store=(None if self.cache is None
                             else self.cache.snapshot()))
        except Exception:
            # last-resort worker protection (sink I/O failures are
            # already absorbed inside ServeMetrics.record_batch; this
            # additionally survives a misbehaving metrics subclass —
            # observability must never take down serving)
            pass

    # -- step-mode recycle loop --------------------------------

    def _execute_recycle(self, bucket_len: int, entries: List[_Entry],
                         lease: Optional[SliceLease] = None):
        """Run one formed batch with the SCHEDULER owning the recycle
        loop: embed+first-pass executable, then one single-recycle step
        executable per iteration. Between steps: converged elements
        retire early (their tickets resolve NOW; on single-device
        carries the survivor batch is re-packed to a dense row prefix,
        on multi-chip leases rows retire in place via the position->row
        map; a fully-converged batch skips its remaining recycles),
        tighter-deadline pending work preempts the gap, and progressive
        results stream to tickets.
        With converge_tol=0 every element runs all `num_recycles` steps
        and — because the step program IS the opaque fold's pass — the
        served numerics are identical to the opaque path.

        CONTINUOUS BATCHING (`RecyclePolicy(continuous=True)`):
        each position carries its own recycle index (`ages`),
        retirement is always in place (the position->row map frees
        physical rows instead of re-packing), and between steps freed
        rows are REFILLED with pending same-bucket requests via the
        row-masked init program (`_admit_rows` ->
        `FoldExecutor.run_init_rows`): survivors keep stepping from
        their own depth while admitted rows restart at iteration 0, so
        a saturated bucket's slice never idles a row. Convergence,
        min_recycles, full-depth retirement, progressive streaming and
        `FoldResponse.recycles` are all evaluated against each row's
        OWN age — an admitted row is never compared against a
        pre-admission prev-state (the post-admission fetch refreshes
        the prev snapshot for exactly this reason)."""
        cfg = self.config
        policy = self.recycle_policy
        continuous = self._use_continuous()
        t0 = time.monotonic()
        if self.tracer.enabled:
            for e in entries:
                e.trace.end("queue", bucket_len=bucket_len)
                e.trace.end("retry")   # closes a retry-wait span; no-op
        for e in entries:              # on a first execution
            e.attempts += 1
        devices = lease.devices if lease is not None else None
        mesh_shape = lease.shape if lease is not None else None
        num_recycles = cfg.num_recycles
        active = list(entries)         # still folding, position-ordered
        all_members = list(entries)    # + row admissions:
        #   the exception handler and batch accounting must cover every
        #   entry that ever rode this loop, not just the founders
        rows = list(range(len(entries)))   # position -> batch row
        ages = [0] * len(entries)          # position -> OWN recycle idx
        # physical repacking gathers the carried state on the batch
        # axis; on a MULTI-chip lease that is an eager op over a
        # mesh-sharded O(L^2) carry outside the step executable's
        # sharding discipline — retire rows logically there instead
        # (the rows map above) and compact only where the carry lives
        # on a single device. The continuous batcher never repacks:
        # freed physical rows are exactly where admissions land.
        can_repack = (devices is None or len(devices) == 1) \
            and not continuous
        any_nonfinite = False
        r = 0                          # loop-level step count
        # step-loop fault domains: carry checkpointing +
        # per-row poison isolation, both off unless the RetryPolicy
        # asked — with the knobs off every local below is inert and
        # the loop is byte-for-byte the plain step loop
        retry = self.retry
        ckpt_every = 0 if retry is None \
            else int(getattr(retry, "checkpoint_every", 0) or 0)
        row_isolate = retry is not None \
            and getattr(retry, "row_isolation", False)
        ckpt = None                    # last _StepCheckpoint
        resumes = 0                    # checkpoint resumes this loop
        resume_probe = False           # next successful step is the
        #                                breaker's half-open probe
        t_attempt = t0                 # start of the executor call a
        #                                watchdog span would cover
        # entries already left the queue: any unresolved exception here
        # would orphan tickets — same guard discipline as _execute
        try:
            batch_trace = (MultiTrace([e.trace for e in active])
                           if self.tracer.enabled else NULL_TRACE)
            with batch_trace.span("batch_form", bucket_len=bucket_len,
                                  n_real=len(entries)):
                batch, waste = self.buckets.assemble(
                    [e.request for e in entries], bucket_len,
                    cfg.max_batch_size, msa_depth=cfg.msa_depth,
                    device=self._device())
            # kernel routing: the init pass always runs the
            # bucket's STATIC first-pass spec (warmup pre-compiled it);
            # step_kernel is what the remaining recycles run — the
            # contact-prior flow below may re-plan it per target
            kspec = self._kernel_spec_for(bucket_len)
            init_kw = {} if kspec is None else {"kernel": kspec}
            step_kernel = kspec
            contact_planned = False
            state = None
            while active:
                try:
                    t_attempt = time.monotonic()
                    state = self._run_step_guarded(
                        lambda: self.executor.run_init(
                            batch, trace=batch_trace, devices=devices,
                            mesh_shape=mesh_shape, **init_kw))
                    break
                except Exception as exc:
                    # per-row poison isolation at the FIRST pass: a
                    # row-attributed deterministic failure retires only
                    # the offending founders; the scrubbed batch
                    # re-inits the innocents (bisection stays the
                    # fallback for unattributed failures)
                    scrubbed = self._isolate_poison_rows(
                        exc, batch, active, rows, ages)
                    if scrubbed is None:
                        raise
                    batch = scrubbed
            if state is None:
                # every founder was isolated poison: nothing to fold
                self._finish_step_batch(bucket_len, entries,
                                        all_members, lease, kspec,
                                        contact_planned, any_nonfinite,
                                        waste, t0)
                return
            # durable resume: a founder whose fold died
            # with a spilled checkpoint (this process's previous life,
            # or a dead peer reached through the store's backend/peer
            # tiers) restarts at its checkpointed age — its row's
            # just-initialized carry is overwritten with the spilled
            # one, which is exactly the checkpoint restore path per row
            if self._ckpt_store is not None and active:
                state = self._resume_from_spill(
                    state, active, rows, ages, range(len(active)))

            def _plan_contact(st, members):
                """Re-plan the step mask from the batch's OWN pair
                activations (the recycle-1 distogram st carries): the
                remaining recycles run a re-lowered step executable
                under the planned pattern — or DENSE when the plan
                degenerates to nearly-all-live. Planning trouble keeps
                the static mask (an observability loss, never a
                serving one). Per-row REAL lengths ride along (via the
                live position->row map) so dead rows — and the padding
                region of a shorter admitted fold — plan as
                dead blocks, never as garbage-live ones."""
                try:
                    row_lengths = [0] * cfg.max_batch_size
                    for pos in range(len(active)):
                        row_lengths[rows[pos]] = \
                            active[pos].request.length
                    planned = self.kernel_policy.contact_spec_for(
                        bucket_len, _host(st.distogram),
                        lengths=row_lengths)
                except Exception:
                    return kspec, False
                self._c_kernel_replans.inc()
                for e in members:
                    e.trace.event(
                        "kernel_contact_replan",
                        kernel=("dense" if planned is None
                                else planned.label),
                        live_frac=(1.0 if planned is None
                                   else round(planned.live_fraction,
                                              4)))
                return planned, True

            if self.kernel_policy is not None \
                    and self.kernel_policy.contact_priors \
                    and kspec is not None:
                step_kernel, contact_planned = _plan_contact(state,
                                                             active)
            # the per-step device-to-host fetch exists for convergence
            # deltas and streaming (and the per-step non-finite scan of
            # row isolation); a preemption-only policy needs none of
            # them, so it pays one fetch at the end like the opaque
            # path instead of copying the padded batch every recycle
            fetch_steps = policy.converge_tol > 0 or policy.stream \
                or row_isolate
            coords_np = conf_np = None
            if fetch_steps:
                coords_np = _host(state.coords)
                conf_np = _host(state.confidence)
                if row_isolate and self._scan_nonfinite_rows(
                        active, rows, ages, coords_np, conf_np):
                    any_nonfinite = True
                self._stream_progress(active, rows, coords_np, conf_np,
                                      ages)
            if ckpt_every and active:
                # checkpoint 0: a failure at the very first step already
                # resumes at the init state instead of requeueing
                ckpt = self._checkpoint_loop(state, batch, active, rows,
                                             ages, 0, step_kernel)
            # every surviving row has age < num_recycles (full-depth
            # rows retire inside the loop), so the condition only
            # gates entry: num_recycles == 0 skips straight to the
            # final retirement below, exactly like the opaque path.
            # The loop runs inside a FAULT ENVELOPE: a
            # row-attributed deterministic failure retires ONLY the
            # offending rows and retries the step; a transient
            # failure or watchdog fire resumes the survivors from the
            # last checkpoint at their checkpointed ages; anything
            # else falls through to the classic outer handler
            # (requeue-to-zero / bisection / error)
            step_done = True       # no step attempt pending yet: a
            #                        failure now lost no step progress
            while True:
                try:
                    while active and min(ages) < num_recycles:
                        if policy.preempt:
                            lease = self._maybe_preempt(active, lease,
                                                        r, bucket_len)
                        r += 1
                        step_done = False
                        prev_coords, prev_conf = coords_np, conf_np
                        step_trace = (
                            MultiTrace([e.trace for e in active])
                            if self.tracer.enabled else NULL_TRACE)
                        step_kw = dict(trace=step_trace,
                                       devices=devices,
                                       mesh_shape=mesh_shape)
                        if continuous:
                            # per-step occupancy rides the recycle span
                            # so the obs_report occupancy line can read
                            # it back (the kwarg only exists on
                            # row-admission-capable executors, which
                            # _use_continuous vetted)
                            step_kw["span_attrs"] = {
                                "rows_live": len(active),
                                "rows_total": cfg.max_batch_size}
                        if step_kernel is not None:
                            step_kw["kernel"] = step_kernel
                        t_step = time.monotonic()
                        t_attempt = t_step
                        state = self._run_step_guarded(
                            lambda st=state, rr=r, kw=step_kw:
                            self.executor.run_step(batch, st, rr, **kw))
                        step_done = True   # a failure from here on
                        #   (admission, planning) lost no step: the
                        #   recycles_lost ledger must count r, not r-1
                        if resume_probe:
                            # the resumed loop's first successful step
                            # IS the breaker's half-open probe: the
                            # device just proved it can execute again
                            resume_probe = False
                            if self._breaker is not None:
                                self._breaker.record_success()
                        # per-bucket step-seconds EWMA: what the
                        # cross-bucket AdmissionPricer converts loop
                        # extension into wall time with (and the
                        # native-delay projection's loop-drain term)
                        dt_step = time.monotonic() - t_step
                        prev_s = self._step_ewma.get(bucket_len)
                        self._step_ewma[bucket_len] = \
                            dt_step if prev_s is None \
                            else 0.5 * prev_s + 0.5 * dt_step
                        ages = [a + 1 for a in ages]
                        self._n_recycles_exec += 1
                        self._c_recycles.inc()
                        # row-occupancy ledger, sampled per executed
                        # step: a step costs the same whether a row is
                        # live or dead, which is exactly the waste
                        # continuous admission exists to eliminate
                        live = len(active)
                        self._row_steps_live += live
                        self._row_steps_total += cfg.max_batch_size
                        dead = cfg.max_batch_size - live
                        if dead > 0:
                            self._n_rows_dead_steps += dead
                            self._c_rows_dead_steps.inc(dead)
                        self._g_rows_occupied.set(
                            live / cfg.max_batch_size)
                        # occupancy-weighted TOKEN accounting
                        #: the formation-time padding_waste
                        # only prices the founders' grid; this prices
                        # what each executed step actually carried —
                        # live rows' real residues over the full (B, L)
                        # grid — so admitted rows (and the padding a
                        # cross-bucket admit accepts) are observable
                        self.metrics.record_step_occupancy(
                            sum(e.request.length for e in active),
                            cfg.max_batch_size * bucket_len)
                        if fetch_steps:
                            coords_np = _host(state.coords)
                            conf_np = _host(state.confidence)
                            if row_isolate and \
                                    self._scan_nonfinite_rows(
                                        active, rows, ages, coords_np,
                                        conf_np):
                                # per-step non-finite scan:
                                # a poisoned row retires the moment its
                                # output goes non-finite — its batch
                                # mates keep stepping and its freed row
                                # is admissible like any early exit
                                any_nonfinite = True
                                if not active:
                                    break
                            self._stream_progress(active, rows,
                                                  coords_np, conf_np,
                                                  ages)
                        else:
                            # fetchless policy: a snapshot fetched for
                            # an earlier retirement is one step stale
                            # NOW — the ripe pass below must re-fetch,
                            # never serve a surviving row its previous
                            # iteration's state
                            coords_np = conf_np = None
                        # retirement against each row's OWN age:
                        # full-depth rows are final (their state IS the
                        # fold result); converged rows past their
                        # min_recycles floor retire early. A full-depth
                        # row never counts as an early retirement even
                        # if its last delta also converged.
                        ripe = {i for i in range(len(active))
                                if ages[i] >= num_recycles}
                        conv: List[int] = []
                        if policy.converge_tol > 0 \
                                and prev_coords is not None:
                            elig = [i for i in range(len(active))
                                    if i not in ripe
                                    and ages[i] >= policy.min_recycles]
                            if elig:
                                deltas = element_deltas(
                                    prev_coords, prev_conf, coords_np,
                                    conf_np,
                                    [active[i].request.length
                                     for i in elig],
                                    rows=[rows[i] for i in elig])
                                for i, d in zip(elig, deltas):
                                    if d <= policy.converge_tol:
                                        conv.append(i)
                                        active[i].trace.event(
                                            "recycle_converged",
                                            recycle=ages[i], delta=d)
                        retired = sorted(ripe | set(conv))
                        if retired:
                            if coords_np is None:
                                # fetchless policy retiring full-depth
                                # rows: one fetch, exactly like the
                                # opaque path's end
                                coords_np = _host(state.coords)
                                conf_np = _host(state.confidence)
                            now = time.monotonic()
                            for i in retired:
                                e = active[i]
                                if i not in ripe:
                                    self._n_retired_early += 1
                                if not self._retire_entry(
                                        e, bucket_len,
                                        coords_np[rows[i]],
                                        conf_np[rows[i]],
                                        ages[i], now):
                                    any_nonfinite = True
                            gone = set(retired)
                            keep = [i for i in range(len(active))
                                    if i not in gone]
                            active = [active[i] for i in keep]
                            rows = [rows[i] for i in keep]
                            ages = [ages[i] for i in keep]
                            if not active:
                                if r < num_recycles:
                                    # fully-converged batch: remaining
                                    # steps are skipped outright
                                    skipped = steps_saved(num_recycles,
                                                          r)
                                    self._n_recycles_skipped += skipped
                                    self._c_recycles_skipped.inc(
                                        skipped)
                                break
                            if can_repack:
                                # re-pack the survivor batch: survivors
                                # become a dense row prefix of both the
                                # carried state and the batch tensors
                                # (and the executor's placement cache
                                # is dropped with the old batch dict)
                                state, idx_list = repack_rows(
                                    state, rows, cfg.max_batch_size)
                                batch = repack_batch(batch, idx_list)
                                sel = np.asarray(rows)
                                coords_np, conf_np = coords_np[sel], \
                                    conf_np[sel]
                                rows = list(range(len(active)))
                            # (not can_repack: rows retire in place —
                            # the position -> row map already shrank
                            # above)
                        # preemption reclaim: when the
                        # announced grace window cannot fit this
                        # loop's remaining recycles, spilling NOW
                        # beats finishing never — checkpoint every
                        # row, resolve "preempted" (the checkpoints
                        # survive _resolve_entry for adoption), and
                        # leave the loop
                        if active and self._reclaiming \
                                and not self._reclaim_fits(
                                    bucket_len, ages, num_recycles):
                            self._preempt_spill_loop(
                                bucket_len, state, active, rows,
                                ages, all_members)
                            if not active:
                                break
                        # bulk yield: under online burn,
                        # bulk rows checkpoint-and-yield at this gap —
                        # spill to the durable store, requeue as
                        # resumable, free the row for the online
                        # admission right below
                        if self._bulk_queue is not None and active \
                                and self._ckpt_store is not None \
                                and self._bulk_gated():
                            self._yield_bulk_rows(state, active, rows,
                                                  ages, all_members)
                        admitted = []
                        if continuous and active:
                            if lease is None:
                                # inline path: this IS the worker
                                # thread, and a continuously refilled
                                # loop would keep it here indefinitely
                                # — drain fresh submissions and run the
                                # worker's shed sweep from the gap so
                                # expired tickets (which admission
                                # skips by design) never hang behind a
                                # long-lived loop
                                with self._cond:
                                    while self._incoming:
                                        e_in = self._incoming.popleft()
                                        self._pending.setdefault(
                                            e_in.bucket_len,
                                            []).append(e_in)
                                self._shed_expired()
                            batch, state, admitted = self._admit_rows(
                                bucket_len, batch, state, active, rows,
                                ages, all_members, devices, mesh_shape,
                                inline=lease is None, gap=r,
                                kernel=kspec)
                            if admitted and contact_planned:
                                # admitted rows' first pass just landed
                                # in the distogram: re-plan so the mask
                                # covers THEIR contacts too, not just
                                # the founders'. A FAILED re-plan keeps
                                # the current contact spec (still valid
                                # for survivor rows) rather than
                                # silently widening back to the static
                                # mask while the batch stays accounted
                                # as contact-planned.
                                new_kernel, ok = _plan_contact(state,
                                                               admitted)
                                if ok:
                                    step_kernel = new_kernel
                            if admitted and fetch_steps:
                                # refresh the prev snapshot NOW: an
                                # admitted row's first delta must
                                # compare its own post-init state,
                                # never the pre-admission occupant of
                                # the same physical row
                                coords_np = _host(state.coords)
                                conf_np = _host(state.confidence)
                                self._stream_progress(
                                    admitted, rows[-len(admitted):],
                                    coords_np, conf_np,
                                    [0] * len(admitted))
                        if ckpt_every and active and \
                                (admitted or self._draining
                                 or r % ckpt_every == 0):
                            # cadence checkpoints, plus one at every
                            # admission gap: a resume must never
                            # restore a pre-admission carry out from
                            # under rows that now hold admitted work
                            # (a failed checkpoint keeps the previous
                            # one — resume then requeues the admitted
                            # entries as orphans, losing progress but
                            # never tickets). While DRAINING, every
                            # gap checkpoints: with a spill store on,
                            # drain() leaves the freshest possible
                            # resume point for whoever inherits the
                            # fold

                            ckpt = self._checkpoint_loop(
                                state, batch, active, rows, ages, r,
                                step_kernel) or ckpt
                    break     # loop drained clean: leave the envelope
                except Exception as exc:
                    scrubbed = self._isolate_poison_rows(
                        exc, batch, active, rows, ages)
                    if scrubbed is not None:
                        # the failed attempt never executed: undo its
                        # step count (unless the step had completed and
                        # a post-step site raised) and retry with the
                        # offending rows retired + scrubbed from the
                        # batch tensors. The checkpoint must follow the
                        # scrub, or a later resume would restore the
                        # poison and re-raise forever.
                        batch = scrubbed
                        r = max(0, r - (0 if step_done else 1))
                        step_done = True
                        if ckpt_every and active:
                            ckpt = self._checkpoint_loop(
                                state, batch, active, rows, ages, r,
                                step_kernel) or ckpt
                        continue
                    outcome = self._resume_or_requeue(
                        exc, ckpt, all_members, bucket_len, resumes,
                        r - (0 if step_done else 1), t_attempt)
                    if outcome is None:
                        raise     # classic handler (outer except)
                    kind, payload = outcome
                    if kind == "requeued":
                        return    # survivors re-enter via the queue
                    resumes += 1
                    resume_probe = self._breaker is not None
                    (state, batch, active, rows, ages,
                     step_kernel) = payload
                    r = ckpt.step
                    step_done = True
                    coords_np = conf_np = None
                    if fetch_steps:
                        coords_np = _host(state.coords)
                        conf_np = _host(state.confidence)
            if active:
                # only reachable at num_recycles == 0: the init state
                # is the final state for every founder row
                if coords_np is None:
                    coords_np = _host(state.coords)
                    conf_np = _host(state.confidence)
                now = time.monotonic()
                for i, e in enumerate(active):
                    if not self._retire_entry(e, bucket_len,
                                              coords_np[rows[i]],
                                              conf_np[rows[i]],
                                              ages[i], now):
                        any_nonfinite = True
        except Exception as exc:  # resolve/retry, never kill the caller
            survivors = [e for e in all_members if not e.ticket.done()]
            if not survivors:
                return            # everyone already retired
            if self._handle_batch_failure(bucket_len, survivors, exc,
                                          t0):
                return            # retried, bisected, or quarantined
            self.metrics.record_error(len(survivors))
            for e in survivors:
                self._resolve_entry(e, FoldResponse(
                    request_id=e.request.request_id, status="error",
                    bucket_len=e.bucket_len, error=repr(exc),
                    attempts=e.attempts))
            return
        self._finish_step_batch(bucket_len, entries, all_members, lease,
                                kspec, contact_planned, any_nonfinite,
                                waste, t0)

    def _finish_step_batch(self, bucket_len: int, entries: List[_Entry],
                           all_members: List[_Entry],
                           lease: Optional[SliceLease], kspec,
                           contact_planned: bool, any_nonfinite: bool,
                           waste: float, t0: float):
        """Success-path accounting for one completed step loop (breaker
        health, mesh/kernel counters, the batch JSONL record) — shared
        by the normal drain and the all-founders-isolated early exit."""
        cfg = self.config
        if self._breaker is not None:
            # same device-health semantics as the opaque path: a batch
            # with non-finite rows is suspect, a clean one is proof
            (self._breaker.record_failure if any_nonfinite
             else self._breaker.record_success)()
        if lease is not None:
            self._c_mesh_folds.inc(mesh=lease.label)
        self._record_kernel_batch(bucket_len, kspec, len(all_members),
                                  contact=contact_planned)
        with self._cond:
            if lease is not None:
                self._mesh_batches[lease.label] = \
                    self._mesh_batches.get(lease.label, 0) + 1
                self._mesh_served[lease.label] = \
                    self._mesh_served.get(lease.label, 0) \
                    + len(all_members)
            depth = self._depth
        try:
            # founders only: padding_waste is a batch-FORMATION metric
            # (real tokens vs the padded grid minted at assemble time);
            # row admissions reuse that grid over time and are
            # accounted by the rows-occupied ledger instead — counting
            # their tokens here would drive waste negative
            self.metrics.record_batch(
                bucket_len, cfg.max_batch_size, len(entries),
                sum(e.request.length for e in entries), waste,
                time.monotonic() - t0, depth,
                cache_store=(None if self.cache is None
                             else self.cache.snapshot()))
        except Exception:
            pass              # observability never takes down serving

    # -- continuous batching: mid-recycle row admission ------

    def _take_admission_candidate(self, bucket_len: int,
                                  batch_msa_depth: int
                                  ) -> Optional[_Entry]:
        """Thread-safe pop of the best same-bucket admission candidate
        from the pending queue, in deadline/priority order (tightest
        live deadline first — urgent folds claim freed rows without
        needing a preemption gap — then priority, then FIFO). Runs on
        dispatch-pool threads, which is why every `_pending` touch in
        this scheduler now holds `_cond`. Excluded: bisection isolation
        groups (cohort discipline wins), backoff-gated retries, expired
        deadlines (the worker's sweep must shed them — admission must
        never ride a dead request to an after-deadline "ok"), and —
        under an unpinned msa_depth config — requests whose own MSA is
        deeper than the running batch's compiled depth (truncating it
        here would serve different content than its own batch would
        have)."""
        now = time.monotonic()
        with self._cond:
            if not self._running and not self._drain:
                return None    # stop(drain=False) cancels the queue;
                #                admission must not race entries away
            while self._incoming:
                entry = self._incoming.popleft()
                self._pending.setdefault(entry.bucket_len,
                                         []).append(entry)
            pend = self._pending.get(bucket_len)
            if not pend:
                return None
            best = None
            for e in pend:
                if e.group is not None or e.not_before > now:
                    continue
                if e.deadline is not None and e.deadline <= now:
                    continue
                if self.config.msa_depth is None \
                        and e.request.msa is not None \
                        and int(e.request.msa.shape[0]) \
                        > batch_msa_depth:
                    continue
                k = (e.deadline is None, e.deadline or 0.0,
                     -e.request.priority, e.enqueued_at)
                if best is None or k < best[0]:
                    best = (k, e)
            if best is None:
                return None
            entry = best[1]
            pend.remove(entry)
        self._resolve_removed([entry])
        return entry

    def _readmit_pending(self, bucket_len: int, entry: _Entry):
        """Return a taken-but-not-admitted candidate to the pending
        queue (HBM refusal): deadline clock untouched, normal batch
        formation serves it."""
        with self._cond:
            self._pending.setdefault(bucket_len, []).append(entry)
            self._depth += 1
            self._cond.notify_all()

    def _native_delay_s(self, native_bucket: int, now: float,
                        inline: bool, remaining_host_steps: int,
                        host_step_s: float) -> float:
        """Caller holds `_cond`. Projected seconds until
        `native_bucket`'s pending work folds through normal batch
        formation — the latency a cross-bucket admission buys back,
        and the number the AdmissionPricer weighs padded compute
        against. Three terms, max-combined:

        - the batch-formation window: time left until the bucket's
          oldest entry ages past max_wait (zero when the bucket
          already holds a full batch, or under eager formation);
        - inline loops: only this worker forms batches and IT is held
          by the running loop, so the loop's remaining steps gate
          everything (this term is why inline cross-bucket admission
          prices favorably exactly when the native alternative would
          wait out the whole drain anyway);
        - leased loops: when no slice of the native shape is free, the
          soonest capacity we can PROVE will free is this loop's own
          slice at drain — the same remaining-steps bound (other
          leases may free sooner, but a lower bound here only makes
          the pricer conservative about stealing from a bucket that
          could form right now).
        """
        pend = self._pending.get(native_bucket) or []
        wait_left = 0.0
        if pend and len(pend) < self.config.max_batch_size \
                and not self._eager_form_on():
            oldest = min(e.enqueued_at for e in pend)
            wait_left = max(0.0, self.config.max_wait_ms / 1000.0
                            - (now - oldest))
        if inline:
            return max(wait_left, remaining_host_steps * host_step_s)
        if self._allocator is not None \
                and not self._allocator.can_allocate(
                    self.mesh_policy.shape_for(native_bucket)):
            return max(wait_left, remaining_host_steps * host_step_s)
        return wait_left

    def _cross_admissible(self, e: _Entry, host_bucket: int,
                          batch_msa_depth: int, now: float) -> bool:
        """THE cross-bucket admissibility predicate — ONE copy shared
        by the inline yield gate and `_take_cross_candidate`'s scan so
        they can never drift: an entry the take would skip (bisection
        group, backoff-gated retry, pad-frac guard, MSA deeper than
        the batch, already pricer-refused) must make the gate YIELD
        the worker, or it would starve behind a loop that keeps
        refilling past it. `cross_refused` is one-shot on purpose: a
        refusal commits the entry to the drain + native-formation
        fallback (and bounds the refusal counter at one per entry)
        rather than re-pricing it every gap."""
        return (e.group is None and e.not_before <= now
                and not e.cross_refused
                and 1.0 - e.request.length / float(host_bucket)
                <= self.recycle_policy.cross_bucket_max_pad_frac
                and not (self.config.msa_depth is None
                         and e.request.msa is not None
                         and int(e.request.msa.shape[0])
                         > batch_msa_depth))

    def _take_cross_candidate(self, host_bucket: int,
                              batch_msa_depth: int,
                              ages: List[int],
                              admitted_this_round: bool,
                              inline: bool):
        """Cross-bucket admission take: pop the best PRICED
        candidate from the SHORTER buckets' pending queues, or None.
        Candidates are considered in the same deadline/priority/FIFO
        order (and under the same eligibility rules) as the same-bucket
        take, across every bucket below the host's; each is priced by
        the AdmissionPricer against its own native-bucket delay
        projection, and refusals stay pending (normal formation — or a
        later, cheaper gap — serves them). Returns (entry, decision).
        """
        pricer = self._admission_pricer
        cfg = self.config
        now = time.monotonic()
        host_step_s = self._step_ewma.get(host_bucket, 0.0)
        num_recycles = cfg.num_recycles
        # steps the host loop still runs regardless of this admission:
        # a row admitted earlier this round restarts at age 0, so the
        # loop already owes the full depth and the candidate rides it
        # for free
        remaining = num_recycles if admitted_this_round else \
            max(0, num_recycles - (min(ages) if ages else 0))
        taken = None
        with self._cond:
            if not self._running and not self._drain:
                return None
            while self._incoming:
                entry = self._incoming.popleft()
                self._pending.setdefault(entry.bucket_len,
                                         []).append(entry)
            cands = []
            for native, pend in self._pending.items():
                if native >= host_bucket:
                    continue
                for e in pend:
                    # shared predicate with the inline yield gate
                    # (group/backoff/pad/MSA/one-shot refusal); the
                    # expired-deadline skip stays take-only — the
                    # worker's shed sweep owns those
                    if not self._cross_admissible(e, host_bucket,
                                                  batch_msa_depth, now):
                        continue
                    if e.deadline is not None and e.deadline <= now:
                        continue
                    k = (e.deadline is None, e.deadline or 0.0,
                         -e.request.priority, e.enqueued_at)
                    cands.append((k, e, native))
            cands.sort(key=lambda t: t[0])
            for _, e, native in cands:
                delay = self._native_delay_s(native, now, inline,
                                             remaining, host_step_s)
                slack = None if e.deadline is None \
                    else e.deadline - now
                decision = pricer.price(
                    native_len=native, host_len=host_bucket,
                    length=e.request.length,
                    batch_size=cfg.max_batch_size,
                    msa_depth=(cfg.msa_depth
                               if cfg.msa_depth is not None
                               else batch_msa_depth),
                    candidate_steps=num_recycles,
                    remaining_host_steps=remaining,
                    native_delay_s=delay, deadline_slack_s=slack,
                    host_step_s=host_step_s)
                if decision.admit:
                    self._pending[native].remove(e)
                    taken = (e, decision)
                    break
                e.cross_refused = True
                self._n_cross_refusals += 1
                e.trace.event("cross_bucket_refused",
                              host_bucket=host_bucket,
                              reason=decision.reason,
                              pad_frac=round(decision.pad_frac, 4))
        if taken is None:
            return None
        self._resolve_removed([taken[0]])
        return taken

    def _admitted_batch(self, batch: dict, bucket_len: int,
                        placements: List[Tuple[int, _Entry]]) -> dict:
        """Fresh batch dict with each admitted request written into its
        freed physical row — the same per-row padding/truncation
        semantics as bucketing.assemble (zero-pad, mask real residues,
        keep the first `depth` MSA rows). A fresh dict holding only the
        canonical input keys (+ the host mirror) on purpose: the
        executor's cached device placement is row-stale the moment a
        row's content changes (same discipline as repack_batch).

        The "_host" key carries the numpy mirror of the batch tensors
        across admission rounds: the FIRST admission of a loop pays one
        device->host fetch, every later one only rewrites the admitted
        rows and re-uploads — no per-gap device sync inside the hot
        step loop. Device tensors are built with `torch.tensor` (copy
        semantics), so mutating the mirror next round can never alias
        a tensor the executor still holds."""
        host = self._host_mirror(batch)
        seq, mask = host["seq"], host["mask"]
        msa, msa_mask = host["msa"], host["msa_mask"]
        for row, e in placements:
            req = e.request
            n = req.length
            seq[row] = 0
            seq[row, :n] = req.seq
            mask[row] = False
            mask[row, :n] = True
            if msa is not None:
                msa[row] = 0
                msa_mask[row] = False
                if req.msa is not None:
                    m = min(req.msa.shape[0], msa.shape[1])
                    msa[row, :m, :n] = req.msa[:m]
                    msa_mask[row, :m, :n] = True
        return self._batch_from_host(host)

    @staticmethod
    def _host_mirror(batch: dict) -> dict:
        """The numpy mirror of one assembled batch's canonical input
        keys: the cached "_host" copy when an earlier admission/scrub/
        checkpoint already paid the device fetch, else one fresh fetch
        cached onto the batch dict — cadence checkpoints of a loop
        whose batch never changes pay ONE fetch per loop, not one per
        checkpoint. Safe to cache: the device tensors are immutable
        between loop iterations (admission/scrub/repack all mint a
        FRESH batch dict), and checkpoint snapshots copy the mirror
        before storing it."""
        host = batch.get("_host")
        if host is None:
            host = {k: (None if batch[k] is None else _host(batch[k]))
                    for k in ("seq", "mask", "msa", "msa_mask")}
            batch["_host"] = host
        return host

    def _device(self):
        """The executor's device: batches are built there explicitly,
        whatever the calling thread's current device is."""
        return getattr(getattr(self.executor, "model", None), "device",
                       None)

    def _batch_from_host(self, host: dict) -> dict:
        """Fresh device batch dict from a host mirror — only the
        canonical input keys plus the mirror itself, so the executor's
        cached per-slice placement is dropped (same discipline as
        repack_batch). `torch.tensor` copies onto the executor's
        device, so later mirror mutation never aliases tensors the
        executor still holds."""
        device = self._device()

        def put(a):
            return None if a is None else torch.tensor(a, device=device)

        return {"seq": put(host["seq"]), "mask": put(host["mask"]),
                "msa": put(host["msa"]), "msa_mask": put(host["msa_mask"]),
                "_host": host}

    def _scrub_batch_rows(self, batch: dict, scrub_rows) -> dict:
        """Zero out the named physical rows (seq 0, mask False, MSA
        cleared) and rebuild the batch dict: a content-addressed
        deterministic failure (poison) cannot re-fire off a row whose
        content is gone, and a dead row is exactly what continuous
        admission refills (row isolation)."""
        host = self._host_mirror(batch)
        for row in scrub_rows:
            host["seq"][row] = 0
            host["mask"][row] = False
            if host["msa"] is not None:
                host["msa"][row] = 0
                host["msa_mask"][row] = False
        return self._batch_from_host(host)

    def _admit_rows(self, bucket_len: int, batch: dict, state,
                    active: List[_Entry], rows: List[int],
                    ages: List[int], all_members: List[_Entry],
                    devices, mesh_shape, inline: bool, gap: int,
                    kernel=None):
        """Refill free batch rows mid-recycle (continuous batching).
        Candidates come off the pending queue in deadline/
        priority order and pass the same front submit() runs: a result-
        store hit resolves immediately (source "cache") WITHOUT burning
        a row, an in-flight duplicate parks as a coalescing follower
        (never double-folds — its leader's fold populates the store
        under the policy's own `key_extras` keying and settles it), and
        the HBM admission guard prices the request before it may join
        the resident batch. Surviving candidates are written into freed
        physical rows (the position->row map — no physical repack, so
        the same code path serves single-chip and mesh-sharded
        carries) and initialized by the row-masked `init_rows`
        executable under an `admit` span while survivor rows pass
        through untouched.

        `inline` marks the classic no-lease path, where this loop runs
        ON the scheduler worker thread: sustained same-bucket traffic
        could then refill the loop forever while every other bucket
        starves behind it, so inline admission additionally yields —
        stops admitting, letting the loop drain within num_recycles
        steps — as soon as any OTHER bucket holds work past its
        max_wait window that admission itself cannot serve (under a
        cross-bucket policy a shorter bucket's overdue entry that the
        cross take will reach this gap no longer forces the yield —
        see the gate comment below). Mesh-leased loops run on pool
        threads and leave the worker free, so they never need the
        gate.

        With a CROSS-BUCKET policy, a round whose host
        queue is dry falls through to `_take_cross_candidate`:
        pending requests from SHORTER buckets may ride the freed rows
        at the host shape, priced per admit.

        Mutates active/rows/ages/all_members in place for the admitted
        entries; returns (batch, state, admitted)."""
        cfg = self.config
        if self._reclaiming:
            # reclaim mode: stop admitting rows — a row
            # admitted now restarts at recycle 0 inside a process that
            # is about to die; the pending entry is worth more resolved
            # "preempted" so its caller re-folds on a survivor
            return batch, state, []
        occupied = set(rows)
        free = [k for k in range(cfg.max_batch_size)
                if k not in occupied]
        if not free:
            return batch, state, []
        # an open circuit breaker pauses batch formation; admission
        # must honor the same pause (mirrors _maybe_preempt)
        if self._breaker is not None \
                and not self._breaker.allow_execute():
            return batch, state, []
        depth = 0 if batch.get("msa") is None \
            else int(batch["msa"].shape[1])
        if inline:
            now = time.monotonic()
            cross = self._use_cross_bucket()
            with self._cond:
                # cross-bucket admission can serve a SHORTER
                # bucket's overdue entry right here in the loop, so it
                # no longer forces the yield — but ONLY when the cross
                # take will actually reach it this gap: the host
                # bucket's own queue must be dry (same-bucket
                # candidates fill rows first — with host pending the
                # gate bails exactly like same-bucket admission, so sustained
                # same-bucket traffic can never starve other buckets)
                # and the entry must pass THE SAME `_cross_admissible`
                # predicate the take's scan applies (bisection group,
                # backoff gate, pad-frac guard, MSA depth, one-shot
                # pricer refusal) — an entry the take would skip must
                # force the yield, or it starves behind a loop that
                # keeps refilling past it. (A take-eligible entry
                # outranked gap after gap by tighter-deadline cross
                # candidates follows the system-wide deadline-first
                # discipline, same as everywhere else work queues.)
                host_pending = bool(self._pending.get(bucket_len))
                for other, pend in self._pending.items():
                    if other == bucket_len:
                        continue
                    for e in pend:
                        if (now - e.enqueued_at) * 1000.0 \
                                < cfg.max_wait_ms:
                            continue
                        servable = (cross and not host_pending
                                    and other < bucket_len
                                    and self._cross_admissible(
                                        e, bucket_len, depth, now))
                        if not servable:
                            # only this worker can serve it: stop
                            # refilling so the loop ends and the worker
                            # gets back to _form_batch
                            return batch, state, []
        placements: List[Tuple[int, _Entry]] = []
        cross_admits: List[_Entry] = []
        while free:
            decision = None
            e = self._take_admission_candidate(bucket_len, depth)
            if e is None and self._use_cross_bucket():
                # this bucket's own queue is dry but rows are still
                # free: a pending request from a SHORTER bucket may
                # ride them at the host shape — if the pricer says the
                # padding beats its native-bucket queue delay
                #
                taken = self._take_cross_candidate(
                    bucket_len, depth, ages, bool(placements), inline)
                if taken is not None:
                    e, decision = taken
            if e is None and self._bulk_queue is not None:
                # bulk work-stealing: every online take —
                # same-bucket and cross-bucket — came up empty, so a
                # freed row may carry the lowest QoS class (gated by
                # online burn rate inside the take)
                e = self._take_bulk_candidate(bucket_len, depth)
            if e is None:
                break
            # HBM guard, mirroring submit() but RE-PRICED AT THE HOST
            # SHAPE (a cross-bucket candidate joins the host batch's
            # footprint, not its native bucket's): an unpinned
            # msa_depth prices the request's own depth. The policy (or
            # its budget) may have tightened since this entry passed
            # the door — a refused candidate goes back to its NATIVE
            # pending queue (normal formation serves it) and the round
            # stops (its siblings would refuse identically).
            if self.mesh_policy is not None:
                guard_msa = cfg.msa_depth
                if guard_msa is None:
                    guard_msa = 0 if e.request.msa is None \
                        else int(e.request.msa.shape[0])
                if not self.mesh_policy.admits(
                        bucket_len, cfg.max_batch_size, guard_msa,
                        carry_recyclables=True, continuous=True):
                    e.trace.event("row_admission_refused_hbm",
                                  gap=gap, host_bucket=bucket_len)
                    self._readmit_pending(e.bucket_len, e)
                    break
            key = None
            if self.cache is not None:
                key = self._entry_key(e)
            if key is not None:
                try:
                    cached = self.cache.get(key, trace=e.trace)
                except Exception:
                    cached = None
                if cached is not None:
                    # a store hit never burns a row: another batch (or
                    # a peer) finished this key since submit
                    self.metrics.record_cache_hit()
                    e.trace.end("queue")
                    resp = FoldResponse(
                        request_id=e.request.request_id, status="ok",
                        coords=cached.coords.copy(),
                        confidence=cached.confidence.copy(),
                        # the entry's NATIVE bucket (== the loop's for
                        # same-bucket candidates; a cross-bucket one
                        # must not report the host's)
                        bucket_len=e.bucket_len,
                        latency_s=time.monotonic() - e.enqueued_at,
                        source="cache")
                    e.resolve(resp)
                    self._settle_followers(e, resp)
                    continue
                self.metrics.record_cache_miss()
                if e.cache_key is None:
                    # not a coalescing leader (the saturated block-mode
                    # fall-through, or a cache attached after submit):
                    # an in-flight duplicate must park behind its
                    # leader, never double-fold in an admitted row
                    def _trace_parked(leader, e=e):
                        if leader is not None:
                            e.trace.link(leader.trace.trace_id)
                        e.trace.event("coalesced")
                        e.trace.end("queue")
                        e.trace.begin("parked")

                    if self._inflight.attach_follower(
                            key, e, on_follower=_trace_parked):
                        self.metrics.record_coalesced()
                        continue
            placements.append((free.pop(0), e))
            if decision is not None:
                cross_admits.append(e)
                e.trace.event("cross_bucket_admitted",
                              native_bucket=e.bucket_len,
                              host_bucket=bucket_len,
                              reason=decision.reason,
                              pad_frac=round(decision.pad_frac, 4))
        if not placements:
            return batch, state, []
        admitted = [e for _, e in placements]
        if self.tracer.enabled:
            for e in admitted:
                e.trace.end("queue", bucket_len=bucket_len)
                e.trace.end("retry")   # no-op on a first execution
        for e in admitted:
            e.attempts += 1
        # bookkeeping BEFORE the executor call: if init_rows fails, the
        # batch-failure handler must already own these tickets
        for row, e in placements:
            active.append(e)
            rows.append(row)
            ages.append(0)
            e.trace.event("row_admitted", gap=gap, row=row,
                          native_bucket=e.bucket_len)
            # per-admit pad fraction at the host edge: the padding an
            # admission accepted in exchange for a live row (
            # same-bucket admits land in the low bins, cross-bucket
            # ones are the distribution's whole point)
            self.metrics.record_admit(
                1.0 - e.request.length / float(bucket_len))
        all_members.extend(admitted)
        self._n_row_admissions += len(admitted)
        self._c_row_admissions.inc(len(admitted))
        if cross_admits:
            self._n_cross_admissions += len(cross_admits)
            for e in cross_admits:
                self._c_cross_admissions.inc(
                    host_bucket=str(bucket_len),
                    native_bucket=str(e.bucket_len))
        new_batch = self._admitted_batch(batch, bucket_len, placements)
        row_mask = np.zeros((cfg.max_batch_size,), bool)
        for row, _ in placements:
            row_mask[row] = True
        admit_trace = (MultiTrace([e.trace for e in admitted])
                       if self.tracer.enabled else NULL_TRACE)
        # admission runs the bucket's STATIC first-pass spec (the one
        # warmup pre-compiled) — a contact-planned step spec describes
        # the founders' contacts, not a newly admitted target's
        admit_kw = {} if kernel is None else {"kernel": kernel}
        if self._use_cross_bucket():
            # admit spans tagged with the admitted rows' native buckets
            # (obs): only under a cross-bucket policy, where
            # the executor is known to speak the kwarg (custom stubs
            # without it keep working under plain continuous)
            admit_kw["span_attrs"] = {
                "host_bucket": bucket_len,
                "native_bucket": ",".join(
                    str(b) for b in sorted({e.bucket_len
                                            for e in admitted}))}
        while True:
            try:
                state = self._run_step_guarded(
                    lambda: self.executor.run_init_rows(
                        new_batch, state, row_mask, trace=admit_trace,
                        devices=devices, mesh_shape=mesh_shape,
                        **admit_kw))
                break
            except Exception as exc:
                # per-row poison isolation at the ADMISSION pass
                #: a poison request admitted mid-loop fails
                # the row-masked init deterministically with its row
                # attributed — quarantine and retire exactly that row,
                # scrub it, and re-run the init for the remaining
                # admitted rows (survivor rows pass through untouched
                # either way; innocent admitted rows re-init from the
                # same deterministic first pass). Anything else
                # propagates to the loop's fault envelope.
                scrubbed = self._isolate_poison_rows(
                    exc, new_batch, active, rows, ages)
                if scrubbed is None:
                    raise
                new_batch = scrubbed
                placements = [(row, e) for row, e in placements
                              if not e.ticket.done()]
                admitted = [e for _, e in placements]
                if not placements:
                    # every admitted row was poison: the carried state
                    # is untouched — the loop continues with survivors
                    return new_batch, state, []
                row_mask = np.zeros((cfg.max_batch_size,), bool)
                for row, _ in placements:
                    row_mask[row] = True
        # durable resume: an admitted entry may be a fold
        # some dead replica (or this one's previous life, or a yielded
        # bulk loop) already carried to age N — consult the spill
        # store and continue it there instead of from the init state
        if self._ckpt_store is not None and admitted:
            adm = {id(e) for e in admitted}
            state = self._resume_from_spill(
                state, active, rows, ages,
                [i for i, e in enumerate(active) if id(e) in adm])
        return new_batch, state, admitted

    def _retire_entry(self, e: _Entry, bucket_len: int, coords_row,
                      conf_row, recycles: int, now: float) -> bool:
        """Terminal "ok" resolution for one step-loop element at
        `recycles` executed iterations (early-converged or final).
        Returns False when the output failed non-finite validation
        (the entry then went through _resolve_nonfinite instead).
        Metrics and the response report the entry's own NATIVE bucket
        (`e.bucket_len`) — identical to the loop's `bucket_len` for
        every founder and same-bucket admit, but a CROSS-bucket
        admitted fold must land in its native bucket's
        latency histogram, or the short-fold p99 the feature exists to
        improve would be invisible (filed under the host bucket)."""
        n = e.request.length
        if self.retry is not None and not (
                np.isfinite(coords_row[:n]).all()
                and np.isfinite(conf_row[:n]).all()):
            self._resolve_nonfinite(e, e.bucket_len)
            return False
        coords = coords_row[:n].copy()
        confidence = conf_row[:n].copy()
        if self.recycle_policy.stream:
            # the update that retired the element: same arrays its
            # terminal response carries, flagged converged
            try:
                e.ticket._publish_progress(FoldProgress(
                    e.request.request_id, recycles, coords.copy(),
                    confidence.copy(), converged=True))
            except Exception:
                pass
        latency = now - e.enqueued_at
        self.metrics.record_served(e.bucket_len, latency)
        self._resolve_entry(e, FoldResponse(
            request_id=e.request.request_id, status="ok",
            coords=coords, confidence=confidence,
            bucket_len=e.bucket_len, latency_s=latency,
            attempts=e.attempts, recycles=recycles))
        return True

    def _stream_progress(self, active: List[_Entry],
                         rows: List[int], coords_np, conf_np,
                         recycles):
        """Publish one per-recycle progressive update to every active
        element's ticket (RecyclePolicy(stream=True) only). `rows`
        maps each active position to its batch row; `recycles` is the
        per-position OWN recycle index list (ages — an admitted row
        streams from 0 while its batch mates stream their own depth),
        or one shared int for legacy callers."""
        if not self.recycle_policy.stream:
            return
        validate = self.retry is not None
        per_row = isinstance(recycles, (list, tuple))
        for i, e in enumerate(active):
            n = e.request.length
            try:
                coords = coords_np[rows[i], :n]
                conf = conf_np[rows[i], :n]
                if validate and not (np.isfinite(coords).all()
                                     and np.isfinite(conf).all()):
                    # the terminal path refuses to serve non-finite
                    # output as "ok"; a progressive update must not
                    # leak the same garbage to a streaming client
                    continue
                e.ticket._publish_progress(FoldProgress(
                    e.request.request_id,
                    recycles[i] if per_row else recycles,
                    coords.copy(), conf.copy()))
            except Exception:
                pass          # a broken observer never stalls the loop

    def _run_step_guarded(self, call):
        """One init/step executor call under the optional per-batch
        watchdog — each recycle step is its own watchdog window, which
        is exactly the granularity the step loop buys."""
        watchdog_s = None if self.retry is None else self.retry.watchdog_s
        if watchdog_s is None:
            return call()
        return run_with_watchdog(call, watchdog_s)

    # -- step-loop fault domains ------------------------------

    def _checkpoint_loop(self, state, batch, active, rows, ages,
                         step: int, kernel) -> Optional[_StepCheckpoint]:
        """Snapshot the running loop to host memory: the carry (with
        shardings, so a mesh-sharded state re-uploads onto its slice),
        a COPY of the batch host mirror (later admission rounds mutate
        the live one in place), and the membership/row/age triple.
        Snapshot trouble returns None — checkpointing is a recovery
        optimization and must never fail a healthy loop; the caller
        keeps the previous checkpoint."""
        from alphafold2_tpu_torch.predict import snapshot_step_state

        try:
            host = self._host_mirror(batch)
            snap_host = {k: (None if v is None else np.array(v))
                         for k, v in host.items()}
            snap_state = snapshot_step_state(state)
        except Exception:
            return None
        self._n_checkpoints += 1
        if self._ckpt_store is not None:
            self._spill_rows(snap_state, active, rows, ages)
        return _StepCheckpoint(snap_state, snap_host, list(rows),
                               list(ages), list(active), int(step),
                               kernel)

    def _spill_rows(self, snap_state, active: List[_Entry],
                    rows: List[int], ages: List[int]):
        """Durable spill: every in-memory checkpoint also
        writes each row's slice of the snapshot to the CheckpointStore
        keyed by (fold_key, model_tag, age) — one npz per row, so a
        single fold migrates without its batch mates. Rides the
        snapshot `_checkpoint_loop` already paid for; per-row trouble
        (unkeyable request, unsliceable carry, disk errors) skips that
        row, never the loop — the store counts it."""
        store = self._ckpt_store
        from alphafold2_tpu_torch.cache.checkpoints import row_checkpoint
        for i, e in enumerate(active):
            key = self._entry_key(e)
            if key is None:
                continue
            try:
                ck = row_checkpoint(
                    snap_state, rows[i], fold_key=key,
                    model_tag=self.model_tag, age=ages[i],
                    seq=e.request.seq, msa=e.request.msa)
            except ValueError:
                store.stats.bump("spill_errors")
                continue
            if store.put_row(ck) is not None:
                e.trace.event("checkpoint_spilled", recycle=ages[i])

    def _resume_from_spill(self, state, active: List[_Entry],
                           rows: List[int], ages: List[int],
                           positions):
        """Durable resume: consult the CheckpointStore for
        each just-initialized position; on a validated hit, overwrite
        that row's slice of every carry leaf with the spilled one and
        set its age — writing the stored values into the row does no
        arithmetic, so the continued loop is byte-equal to the
        uninterrupted one. ANY validation trouble (leaf count, shape,
        dtype, reference drift, a different sequence under a colliding
        key) discards the checkpoint and keeps age 0: refold-from-zero
        is always the safe fallback. Mutates ages in place; returns
        the (possibly updated) state."""
        from alphafold2_tpu_torch.predict import (tree_flatten,
                                                  tree_unflatten)
        store = self._ckpt_store
        leaves = treedef = None
        for i in positions:
            e = active[i]
            key = self._entry_key(e)
            if key is None:
                continue
            ckpt = store.latest(key, trace=e.trace)
            if ckpt is None:
                continue
            if not (ckpt.seq.shape == e.request.seq.shape
                    and bool(np.array_equal(ckpt.seq, e.request.seq))
                    and 0 < ckpt.age < self.config.num_recycles):
                store.discard(key)
                continue
            try:
                if leaves is None:
                    # a slice group's carry comes to the host; the next
                    # step sends it back to the ranks
                    from alphafold2_tpu_torch.serve.slices import to_local
                    leaves, treedef = tree_flatten(to_local(state))
                # each host leaf goes back onto the carry's device
                device = next(x.device for x in leaves
                              if isinstance(x, torch.Tensor))
                restored = ckpt.restore_leaves(device)
                if len(restored) != len(leaves):
                    raise ValueError("carry leaf count drifted")
                row = rows[i]
                new_leaves = list(leaves)
                for j, new in enumerate(restored):
                    cur = leaves[j]
                    if isinstance(cur, torch.Tensor):
                        if not isinstance(new, torch.Tensor) \
                                or new.shape[1:] != cur.shape[1:] \
                                or new.dtype != cur.dtype:
                            raise ValueError(
                                f"carry leaf {j} shape/dtype drifted")
                        upd = cur.clone()
                        upd[row] = new[0].to(cur.device)
                        new_leaves[j] = upd
                    elif new != cur:
                        raise ValueError(
                            f"reference leaf {j} drifted")
                leaves = new_leaves
            except Exception:
                store.discard(key)
                continue
            ages[i] = int(ckpt.age)
            self._n_spill_resumes += 1
            self._c_spill_resumes.inc()
            e.trace.event("spill_resume", recycle=ckpt.age)
        if leaves is not None:
            state = tree_unflatten(treedef, leaves)
        return state

    def _scan_nonfinite_rows(self, active: List[_Entry],
                             rows: List[int], ages: List[int],
                             coords_np, conf_np) -> int:
        """Per-step non-finite scan (RetryPolicy(row_isolation)): any
        active row whose real residues carry non-finite coords or
        confidence is retired NOW through the existing poison-strike
        machinery (`_resolve_nonfinite` — quarantine at the policy
        threshold) while its batch mates keep stepping. Mutates
        active/rows/ages in place; returns the number of rows
        isolated. Without the knob this never runs and detection stays
        at retirement time, exactly the whole-cohort behavior."""
        bad = []
        for i in range(len(active)):
            n = active[i].request.length
            if not (np.isfinite(coords_np[rows[i], :n]).all()
                    and np.isfinite(conf_np[rows[i], :n]).all()):
                bad.append(i)
        if not bad:
            return 0
        for i in bad:
            e = active[i]
            self._n_row_isolations += 1
            self._c_row_isolations.inc()
            e.trace.event("row_poison_isolated", kind="nonfinite",
                          row=rows[i], recycle=ages[i])
            self._resolve_nonfinite(e, e.bucket_len)
        gone = set(bad)
        keep = [i for i in range(len(active)) if i not in gone]
        active[:] = [active[i] for i in keep]
        rows[:] = [rows[i] for i in keep]
        ages[:] = [ages[i] for i in keep]
        return len(bad)

    def _isolate_poison_rows(self, exc: Exception, batch: dict,
                             active: List[_Entry], rows: List[int],
                             ages: List[int]) -> Optional[dict]:
        """Per-row poison isolation for a row-attributed DETERMINISTIC
        failure: when the exception names the batch rows it
        came from (`exc.rows` — content-addressed chaos does; real CUDA
        payloads go through the `serve.cuda_errors` attribution parser,
        and fall back to bisection only when the message
        names no row), quarantine exactly
        those entries (a deterministic single-row attribution IS the
        proof — same standard as the batch-of-1 bisection terminal),
        resolve them "poisoned", scrub their rows from the batch
        tensors, and return the scrubbed batch for the caller to retry
        the step with — the survivors never leave the loop. Returns
        None when not applicable (knob off, transient, unattributed,
        or the rows don't map to live entries)."""
        retry = self.retry
        if retry is None or not getattr(retry, "row_isolation", False):
            return None
        bad_rows = getattr(exc, "rows", None)
        if not bad_rows and getattr(retry, "xla_classify", False):
            # real CUDA payloads carry no .rows — fall back to parsing
            # the message for a named batch position; ()
            # keeps the legacy bisection path
            from alphafold2_tpu_torch.serve.cuda_errors import \
                attributed_rows
            bad_rows = attributed_rows(repr(exc)) or None
        if not bad_rows or retry.is_transient(exc):
            return None
        bad = {int(x) for x in bad_rows}
        positions = [i for i in range(len(active)) if rows[i] in bad]
        if not positions:
            return None
        now = time.monotonic()
        for i in positions:
            e = active[i]
            key = self._entry_key(e)
            if key is not None:
                self._quarantine.add(key, reason="poison_input")
            self._n_row_isolations += 1
            self._c_row_isolations.inc()
            self.metrics.record_poisoned()
            e.trace.event("row_poison_isolated", kind="raise",
                          row=rows[i], recycle=ages[i])
            self._resolve_entry(e, FoldResponse(
                request_id=e.request.request_id, status="poisoned",
                bucket_len=e.bucket_len, attempts=e.attempts,
                latency_s=now - e.enqueued_at,
                error=f"poison_input: row-attributed deterministic "
                      f"failure isolated to batch row {rows[i]}, key "
                      f"quarantined: {exc!r}"))
        scrub = [rows[i] for i in positions]
        gone = set(positions)
        keep = [i for i in range(len(active)) if i not in gone]
        active[:] = [active[i] for i in keep]
        rows[:] = [rows[i] for i in keep]
        ages[:] = [ages[i] for i in keep]
        if self._breaker is not None:
            # deterministic failure: the device RAN the batch — proof
            # of health, same semantics as the bisection path
            self._breaker.record_success()
        return self._scrub_batch_rows(batch, scrub)

    def _note_watchdog(self, entries: List[_Entry], t_run: float,
                       now: float):
        """Watchdog-fire bookkeeping shared by the classic batch
        handler and the checkpoint-resume path: count it, span it,
        rebuild the executor (a hung device call's compiled state is
        not trustworthy)."""
        self._n_watchdog_fires += 1
        self._c_watchdog.inc()
        if self.tracer.enabled:
            for e in entries:
                e.trace.add_span("watchdog", t_run, now,
                                 timeout_s=self.retry.watchdog_s)
                e.trace.event("watchdog_fired")
        self._rebuild_executor()

    def _resume_or_requeue(self, exc: Exception,
                           ckpt: Optional[_StepCheckpoint],
                           all_members: List[_Entry], bucket_len: int,
                           resumes: int, completed: int,
                           t_attempt: float):
        """Recovery decision for one TRANSIENT step-loop failure under
        carry checkpointing. Three outcomes:

        - None: not applicable (knob off, no checkpoint yet,
          deterministic failure, resume budget spent, stopping, or the
          breaker is already open) — the caller re-raises into the
          classic handler, byte-for-byte the classic recovery;
        - ("resumed", (state, batch, active, rows, ages, kernel)): the
          checkpoint re-uploaded; survivors continue at their
          checkpointed ages (bounded progress loss — the steps between
          checkpoint and failure, counted in
          `serve_recycles_lost_total`). Entries that joined the loop
          AFTER the checkpoint (admission raced the failure) re-enter
          via the queue so no ticket is ever lost. On a watchdog fire
          the executor was rebuilt first.
        - ("requeued", None): the checkpoint could not be restored (or
          the rebuilt executor lost step mode) — survivors took the
          classic requeue-to-zero path right here; the caller just
          returns.
        """
        retry = self.retry
        if retry is None or ckpt is None \
                or not getattr(retry, "checkpoint_every", 0):
            return None
        if not retry.is_transient(exc):
            return None
        if resumes + 1 >= retry.max_attempts:
            return None          # budget spent: classic handler
        with self._cond:
            if not self._running:
                return None      # stopping: every ticket resolves now
        if self._breaker is not None \
                and not self._breaker.allow_execute():
            return None          # open breaker: honor the pause via
        #                          the requeue path's formation gate
        keep = [i for i in range(len(ckpt.active))
                if not ckpt.active[i].ticket.done()]
        if not keep:
            return None
        survivors = [ckpt.active[i] for i in keep]
        now = time.monotonic()
        fired = isinstance(exc, WatchdogTimeout)
        # `completed` = step iterations that finished before the
        # failure (the caller subtracts the in-flight attempt when the
        # step itself raised); everything past the checkpoint re-runs
        lost = max(0, int(completed) - ckpt.step)
        if fired:
            # a hung device call's compiled state is not trustworthy —
            # rebuild BEFORE the restore below touches the device:
            # uploading the checkpoint through the wedged client would
            # re-create the very hang the watchdog just recovered from,
            # this time outside its guard (restore_step_state's
            # default-device fallback expects the post-rebuild world)
            self._note_watchdog(survivors, t_attempt, now)
            if not self._step_capable:
                # the rebuilt executor lost step mode (custom factory):
                # requeue-to-zero over EVERY unresolved member — with
                # the classic path's exhaustion split, since
                # _handle_batch_failure can't run (it would rebuild and
                # count this watchdog a second time)
                if self._breaker is not None:
                    self._breaker.record_failure()
                self._requeue_or_exhaust(
                    bucket_len,
                    [e for e in all_members if not e.ticket.done()],
                    exc, now)
                return ("requeued", None)
        from alphafold2_tpu_torch.predict import restore_step_state
        try:
            res_trace = (MultiTrace([e.trace for e in survivors])
                         if self.tracer.enabled else NULL_TRACE)
            with res_trace.span("resume", recycle=ckpt.step, lost=lost,
                                attempt=resumes + 1):
                state = restore_step_state(ckpt.state)
                host = {k: (None if v is None else np.array(v))
                        for k, v in ckpt.host.items()}
                batch = self._batch_from_host(host)
        except Exception:
            if fired:
                # the watchdog is already counted and the executor
                # rebuilt: the classic handler would do both a second
                # time, so the requeue-to-zero fallback runs here
                if self._breaker is not None:
                    self._breaker.record_failure()
                self._requeue_or_exhaust(
                    bucket_len,
                    [e for e in all_members if not e.ticket.done()],
                    exc, now)
                return ("requeued", None)
            # restore trouble with nothing counted yet: hand the
            # UNTOUCHED exception to the classic handler — it owns the
            # breaker/exhaustion bookkeeping of the requeue-to-zero
            # path, and nothing double-counts
            return None
        # committed: the classic handler will never see this failure,
        # so the breaker must learn about it HERE — a resume recovers
        # progress, it must not blind degraded-mode detection (same
        # transient-indicts / deterministic-never semantics as
        # _handle_batch_failure; the resumed loop's first successful
        # step records the offsetting success)
        if self._breaker is not None:
            self._breaker.record_failure()
        # entries that joined after the checkpoint (a raced admission)
        # are not in the restored membership: requeue them — progress
        # lost, tickets never — and DROP them from the loop membership,
        # so a later failure of this same loop can never requeue them a
        # second time (a double queue reference would double-serve one
        # ticket)
        ids = {id(e) for e in survivors}
        orphans = [e for e in all_members
                   if not e.ticket.done() and id(e) not in ids]
        if orphans:
            gone = {id(e) for e in orphans}
            for e in orphans:
                e.trace.event("resume_orphan_requeued")
            self._requeue(orphans, bucket_len, now)
            all_members[:] = [e for e in all_members
                              if id(e) not in gone]
        for e in survivors:
            e.attempts += 1
            e.trace.event("checkpoint_resume", recycle=ckpt.step,
                          lost=lost, error=repr(exc))
        self._n_ckpt_resumes += 1
        self._c_ckpt_resumes.inc()
        if lost:
            self._n_recycles_lost += lost
            self._c_recycles_lost.inc(lost)
        self.metrics.record_retried(len(survivors))
        if self._breaker is not None:
            self._breaker.begin_probe()   # no-op unless half-open: the
        #                                   resumed loop IS the probe
        delay = retry.delay_s(resumes + 1, rng=self._retry_rng)
        if delay > 0:
            # known trade: on a leased slice this backoff idles the
            # held chips for up to backoff_max_s — still strictly
            # cheaper than the classic path's full restart-from-zero,
            # and bounded by the per-loop resume budget
            time.sleep(delay)
        return ("resumed", (state, batch, survivors,
                            [ckpt.rows[i] for i in keep],
                            [ckpt.ages[i] for i in keep], ckpt.kernel))

    def _maybe_preempt(self, active: List[_Entry],
                       lease: Optional[SliceLease], gap: int,
                       bucket_len: Optional[int] = None):
        """Between-recycles preemption window. Inline (no lease): this
        IS the worker thread, so it forms and executes tighter-deadline
        pending batches directly — the deadline fold lands between the
        long batch's recycles instead of behind its last one. On a
        leased slice (dispatch-pool thread): when tighter-deadline work
        is pending and the device pool is saturated, release the slice
        for one gap so the worker can place the urgent batch, then
        blocking-re-acquire the SAME span (the carried state and the
        compiled executables are bound to those exact devices).
        A preemptor never preempts (per-thread guard) and each gap
        admits AT MOST ONE urgent batch, so preemption is bounded in
        both depth and breadth — sustained deadline traffic interleaves
        gap by gap instead of starving the running batch. Returns the
        (possibly re-acquired) lease.

        The yield frees SCHEDULING capacity, not device memory — the
        suspended loop's carried state stays HBM-resident, so an
        urgent batch on the freed chips is a concurrent per-device
        peak. `_preempt_hbm_admits` (memory-aware preemption
        admission) prices urgent footprint + suspended carry
        against the budget and REFUSES the yield when they cannot
        co-reside (`serve_preempt_hbm_refusals_total`) — near-limit
        flagship configs keep their headroom automatically. Known
        limit: a leased yield for an urgent entry still inside its
        max_wait window can go unplaced for that window (bounded by
        max_wait_ms — the worker's batch formation does not jump the
        window the way the inline take does)."""
        if getattr(self._preempting, "flag", False):
            return lease
        # an open circuit breaker pauses batch formation; a preemption
        # gap must honor the same pause, not hammer the suspect
        # executor with urgent batches during its recovery window
        if self._breaker is not None and not self._breaker.allow_execute():
            return lease
        deadlines = [e.deadline for e in active if e.deadline is not None]
        tighter_than = min(deadlines) if deadlines else None
        if lease is None:
            # ONE urgent batch per gap (same bound as the leased path's
            # one-gap yield): each recycle step opens another gap, so a
            # burst of deadline traffic interleaves with the running
            # batch instead of starving it outright — sustained urgent
            # arrivals must not pin a half-executed batch at one gap
            # while its callers' result timeouts expire
            cand = self._take_urgent(tighter_than)
            if cand is None:
                return lease
            bucket2, take2 = cand
            self._n_preemptions += 1
            self._c_preemptions.inc()
            for e in active:
                e.trace.event("preempted", gap=gap,
                              by_bucket=bucket2)
            for e in take2:
                e.trace.event("preempting", gap=gap)
            self._preempting.flag = True
            try:
                self._execute(bucket2, take2)
            finally:
                self._preempting.flag = False
            return lease
        with self._cond:
            urgent = self._pending_tightest
            needed = self._pending_tightest_chips
            urgent_bucket = self._pending_tightest_bucket
            urgent_msa = self._pending_tightest_msa
        if urgent is None or (tighter_than is not None
                              and urgent >= tighter_than):
            return lease
        if self._allocator.can_allocate((1, 1)):
            return lease      # free chips exist; nothing is starved
        if needed is not None:
            free = (self._allocator.total_devices
                    - self._allocator.busy_devices)
            if free + chips_of(lease.shape) < needed:
                # yielding our slice still cannot place the urgent
                # batch (it needs a wider slice than would free):
                # don't pay the yield latency or count a preemption
                # that admits nothing
                return lease
        if not self._preempt_hbm_admits(bucket_len, urgent_bucket,
                                        urgent_msa):
            # memory-aware preemption admission: the yield frees
            # SCHEDULING capacity, not HBM — this loop's carried
            # Recyclables stay resident on these exact devices while the urgent
            # batch runs, so the pair is a concurrent per-device peak. When
            # urgent footprint + suspended carry exceeds the budget, refuse the
            # yield: the urgent batch waits out the remaining recycles instead
            # of OOMing both workloads.
            self._n_preempt_hbm_refusals += 1
            self._c_preempt_hbm_refusals.inc()
            for e in active:
                e.trace.event("preempt_hbm_refused", gap=gap)
            return lease
        self._n_preemptions += 1
        self._c_preemptions.inc()
        for e in active:
            e.trace.event("preempted", gap=gap)
        self._release_lease(lease)
        # one gap's window for the worker to place the urgent batch
        time.sleep(max(self.config.poll_ms / 1000.0 * 2, 0.01))
        lease = self._allocator.acquire_span(lease)
        self._set_busy_gauge()
        return lease

    def _preempt_hbm_admits(self, running_bucket: Optional[int],
                            urgent_bucket: Optional[int],
                            urgent_msa: Optional[int] = None) -> bool:
        """Memory-aware preemption admission: may the urgent bucket's
        batch run on devices still holding this suspended loop's
        carried state? Prices the urgent batch's full analytic
        footprint (step-mode, since the preempting batch runs under the
        same policy) PLUS the suspended carry's per-device bytes
        (`FoldMemoryModel.carry_bytes`) against the per-device budget.
        Conservative: assumes the urgent slice overlaps this lease's
        devices (the freed chips are exactly where the worker will
        place it under saturation — the only condition a yield fires
        in). True when no memory model is configured (the guard is
        opt-in, like the too_large guard it extends)."""
        mp = self.mesh_policy
        if mp is None or mp.memory is None or urgent_bucket is None \
                or running_bucket is None:
            return True
        cfg = self.config
        # MSA pricing mirrors the submit-time guard: a pinned
        # config.msa_depth wins; unpinned (None) prices the urgent
        # entry's OWN depth (advertised by the worker alongside its
        # bucket) — pricing zero there would lowball deep-MSA traffic
        # into exactly the concurrent-peak OOM this guard prevents
        guard_msa = cfg.msa_depth
        if guard_msa is None:
            guard_msa = urgent_msa or 0
        urgent_bytes = mp.memory.fold_bytes(
            urgent_bucket, cfg.max_batch_size, guard_msa,
            shape=mp.shape_for(urgent_bucket),
            carry_recyclables=self._use_step_loop(),
            continuous=self._use_continuous())
        carry = mp.memory.carry_bytes(
            running_bucket, cfg.max_batch_size,
            chips=mp.chips_for(running_bucket))
        return urgent_bytes + carry <= mp.memory.hbm_bytes_per_device

    @staticmethod
    def _urgent_eligible(e: _Entry, now: float) -> bool:
        """THE preemption-eligibility predicate: carries a live
        (unexpired) deadline, is not backoff-gated, and is not part of
        a bisection isolation group (cohort discipline wins). One copy,
        shared by the urgent take and the worker's tightest-deadline
        advertisement so they can never drift."""
        return (e.deadline is not None and e.deadline > now
                and e.group is None and e.not_before <= now)

    def _take_urgent(self, tighter_than: Optional[float]):
        """Worker-thread only (the inline preemption path): pick the
        pending bucket holding the tightest not-yet-expired deadline
        beating `tighter_than` (any deadline qualifies when the running
        batch has none) and take up to max_batch_size of its entries,
        tightest deadlines first. Bisection isolation groups never ride
        a preemption batch — their cohort discipline wins."""
        now = time.monotonic()
        # one _cond hold end to end: continuous row admission (pool
        # threads) takes from _pending too, so scan + removal must be
        # atomic against it
        with self._cond:
            while self._incoming:
                entry = self._incoming.popleft()
                self._pending.setdefault(entry.bucket_len,
                                         []).append(entry)
            best = None
            for bucket_len, pend in self._pending.items():
                for e in pend:
                    if not self._urgent_eligible(e, now):
                        continue
                    if tighter_than is not None \
                            and e.deadline >= tighter_than:
                        continue
                    if best is None or e.deadline < best[0]:
                        best = (e.deadline, bucket_len)
            if best is None:
                return None
            _, bucket_len = best
            # batch fill excludes expired deadlines too: a dead request
            # must resolve "shed" via the worker's sweep, never ride a
            # preemption batch to an after-deadline "ok" (deadline-free
            # fill entries are fine — they just serve sooner)
            pend = [e for e in self._pending[bucket_len]
                    if e.group is None and e.not_before <= now
                    and not (e.deadline is not None and e.deadline <= now)]
            take = sorted(pend, key=lambda e: (e.deadline is None,
                                               e.deadline or 0.0,
                                               -e.request.priority,
                                               e.enqueued_at))
            take = take[:self.config.max_batch_size]
            taken = {id(e) for e in take}
            self._pending[bucket_len] = [
                e for e in self._pending[bucket_len]
                if id(e) not in taken]
        self._resolve_removed(take)
        return bucket_len, take

    # -- resilience: worker side -----------------------------------------

    def _run_executor(self, batch: dict, batch_trace,
                      lease: Optional[SliceLease] = None, kernel=None):
        """executor.run with the optional per-batch watchdog deadline.
        The trace/devices/kernel kwargs are only passed when in use, so
        alternate executors (tests) needn't know about obs, meshes, or
        kernel policies; `self.executor` is read inside the closure so
        a rebuild between batches takes effect immediately."""
        kw = {}
        if batch_trace is not NULL_TRACE:
            kw["trace"] = batch_trace
        if lease is not None:
            kw["devices"] = lease.devices
            kw["mesh_shape"] = lease.shape
        if kernel is not None:
            kw["kernel"] = kernel
        if kw:
            call = lambda: self.executor.run(  # noqa: E731
                batch, self.config.num_recycles, **kw)
        else:
            call = lambda: self.executor.run(  # noqa: E731
                batch, self.config.num_recycles)
        watchdog_s = None if self.retry is None else self.retry.watchdog_s
        if watchdog_s is None:
            return call()
        return run_with_watchdog(call, watchdog_s)

    def _requeue_or_exhaust(self, bucket_len: int,
                            entries: List[_Entry], exc: Exception,
                            now: float):
        """The transient requeue-to-zero tail shared by the classic
        handler and the checkpoint-resume fallback: entries past their
        retry budget error-resolve with `retry_exhausted`, the rest
        re-enqueue with backoff and the usual retry bookkeeping."""
        retry = self.retry
        survivors = [e for e in entries
                     if e.attempts < retry.max_attempts]
        for e in entries:
            if e.attempts >= retry.max_attempts:
                self.metrics.record_error()
                self._resolve_entry(e, FoldResponse(
                    request_id=e.request.request_id, status="error",
                    bucket_len=bucket_len, attempts=e.attempts,
                    error=f"retry_exhausted after {e.attempts} "
                          f"attempts: {exc!r}"))
        if survivors:
            delay = retry.delay_s(max(e.attempts for e in survivors),
                                  rng=self._retry_rng)
            self._n_retries += len(survivors)
            self._c_retries.inc(len(survivors))
            self.metrics.record_retried(len(survivors))
            for e in survivors:
                e.trace.event("retry_scheduled", delay_s=delay,
                              attempts=e.attempts, error=repr(exc))
            self._requeue(survivors, bucket_len, now + delay)

    def _handle_batch_failure(self, bucket_len: int,
                              entries: List[_Entry], exc: Exception,
                              t_run: float) -> bool:
        """Failure-domain triage for one failed batch execution. True =
        handled (entries retried, bisected, or quarantined); False =
        the caller error-resolves everyone, exactly the pre-resilience
        path. Never called with entries still in the queue."""
        retry = self.retry
        if retry is None:
            return False
        now = time.monotonic()
        fired = isinstance(exc, WatchdogTimeout)
        if fired:
            self._note_watchdog(entries, t_run, now)
        transient = retry.is_transient(exc)
        if self._breaker is not None:
            # a deterministic failure proves the device RAN the batch:
            # only transient/watchdog failures indict the executor
            (self._breaker.record_failure if transient
             else self._breaker.record_success)()
        with self._cond:
            if not self._running:
                return False     # stopping: every ticket resolves NOW
        if transient:
            exhausted = [e for e in entries
                         if e.attempts >= retry.max_attempts]
            if exhausted and retry.bisect and len(entries) > 1:
                # a batch that keeps failing "transiently" is
                # indistinguishable from poison — corner it, but KEEP
                # the backoff: if the device really is struggling,
                # bisection must not turn into a zero-delay hammer
                delay = retry.delay_s(max(e.attempts for e in entries),
                                      rng=self._retry_rng)
                self._bisect(bucket_len, entries,
                             not_before=now + delay)
                return True
            self._requeue_or_exhaust(bucket_len, entries, exc, now)
            return True
        # deterministic failure: isolate the poison
        if not retry.bisect:
            return False
        if len(entries) == 1:
            e = entries[0]
            key = self._entry_key(e)
            if key is None:
                return False     # unkeyable: plain terminal error
            self._quarantine.add(key, reason="poison_input")
            self.metrics.record_poisoned()
            e.trace.event("poison_quarantined")
            self._resolve_entry(e, FoldResponse(
                request_id=e.request.request_id, status="poisoned",
                bucket_len=bucket_len, attempts=e.attempts,
                latency_s=now - e.enqueued_at,
                error=f"poison_input: failed deterministically as a "
                      f"batch of 1, key quarantined: {exc!r}"))
            return True
        self._bisect(bucket_len, entries)
        return True

    def _bisect(self, bucket_len: int, entries: List[_Entry],
                not_before: Optional[float] = None):
        """Split a failing batch into two isolation groups and re-run
        each alone: the innocent half succeeds immediately, the poison
        half keeps splitting — a single poison request is cornered and
        quarantined in <= log2(batch) extra executions. Default no
        backoff (a deterministic failure is not load); the transient-
        exhausted path passes `not_before` to keep its backoff."""
        self._n_bisections += 1
        self._c_bisections.inc()
        if not_before is None:
            not_before = time.monotonic()
        mid = len(entries) // 2
        for half in (entries[:mid], entries[mid:]):
            if not half:
                continue
            gid = next(self._group_counter)
            for e in half:
                e.group = gid
                e.trace.event("bisect", group=gid, size=len(half))
            self._requeue(half, bucket_len, not_before)

    def _requeue(self, entries: List[_Entry], bucket_len: int,
                 not_before: float):
        """Put failed entries back in pending for another execution.
        Deadlines and enqueued_at are NOT reset — the caller's clock
        kept running through the failure, and an entry whose deadline
        expires mid-backoff is shed like any other."""
        tracing = self.tracer.enabled
        for e in entries:
            e.not_before = not_before
            if tracing:
                e.trace.begin("retry")
        # through _incoming, NOT _pending: with a mesh policy this runs
        # on a dispatch-pool thread while the worker owns _pending; the
        # worker moves incoming entries into their bucket under _cond,
        # so the requeue is race-free on both paths
        with self._cond:
            self._incoming.extend(entries)
            self._depth += len(entries)
            self._cond.notify_all()

    def _rebuild_executor(self):
        """Watchdog fired: swap the executor for a fresh one. The hung
        call's thread still references the old instance, so its late
        result (if the device ever answers) lands in garbage, never in
        the serving path."""
        try:
            if self.executor_factory is not None:
                self.executor = self.executor_factory()
                if hasattr(self.executor, "model_tag"):
                    self.executor.model_tag = self._model_tag
            elif hasattr(self.executor, "rebuild"):
                self.executor = self.executor.rebuild()
            else:
                return           # nothing to rebuild with: keep serving
        except Exception:
            return               # a failed rebuild keeps the old one —
        #                          better a suspect executor than none
        # a swapped-in executor may not speak step mode (custom
        # executor_factory): recompute so the recycle loop degrades to
        # the opaque path instead of AttributeError-ing mid-batch
        self._step_capable = hasattr(self.executor, "run_init") \
            and hasattr(self.executor, "run_step")
        self._n_rebuilds += 1
        self._c_rebuilds.inc()

    def _resolve_nonfinite(self, e: _Entry, bucket_len: int):
        """A fold came back with non-finite coords/confidence: never
        serve it as "ok". The entry's key takes a poison strike; at the
        policy threshold it is quarantined (status "poisoned"),
        otherwise it error-resolves with `nonfinite_output`."""
        self._n_nonfinite += 1
        self._c_nonfinite.inc()
        e.trace.event("nonfinite_output")
        key = self._entry_key(e)
        quarantined = key is not None and self._quarantine.strike(
            key, self.retry.nan_poison_threshold)
        now = time.monotonic()
        if quarantined:
            self.metrics.record_poisoned()
            self._resolve_entry(e, FoldResponse(
                request_id=e.request.request_id, status="poisoned",
                bucket_len=bucket_len, attempts=e.attempts,
                latency_s=now - e.enqueued_at,
                error="nonfinite_output: fold produced non-finite "
                      "coords/confidence; key quarantined"))
        else:
            self.metrics.record_error()
            self._resolve_entry(e, FoldResponse(
                request_id=e.request.request_id, status="error",
                bucket_len=bucket_len, attempts=e.attempts,
                latency_s=now - e.enqueued_at,
                error="nonfinite_output: fold produced non-finite "
                      "coords/confidence"))

    def _drain_all_entries(self) -> List[_Entry]:
        with self._cond:
            leftovers = list(self._incoming)
            self._incoming.clear()
            for entries in self._pending.values():
                leftovers.extend(entries)
            self._pending.clear()
            self._depth -= len(leftovers)
            self._cond.notify_all()
        # bulk entries live outside _depth: drain them AFTER the depth
        # adjustment so the online accounting stays exact
        if self._bulk_queue is not None:
            leftovers.extend(self._bulk_queue.drain())
        return leftovers

    def _cancel_remaining(self):
        leftovers = self._drain_all_entries()
        if self._reclaiming:
            # reclaim stop: queued work that never founded
            # resolves "preempted" — a RETRIABLE terminal the fleet
            # client fails over on immediately, and whose spilled
            # checkpoint (for requeued mid-loop yields) survives for
            # the adopting replica to resume
            self.metrics.record_preempted(len(leftovers))
            for e in leftovers:
                self._resolve_entry(e, FoldResponse(
                    request_id=e.request.request_id, status="preempted",
                    bucket_len=e.bucket_len, attempts=e.attempts or 1,
                    error="replica preempted before folding"))
            return
        self.metrics.record_cancelled(len(leftovers))
        for e in leftovers:
            self._resolve_entry(e, FoldResponse(
                request_id=e.request.request_id, status="cancelled",
                bucket_len=e.bucket_len, attempts=e.attempts or 1,
                error="scheduler stopped without draining"))

    def _fail_outstanding(self, error: str):
        """Worker crashed outside executor.run (e.g. the metrics sink):
        stop accepting work and resolve every outstanding ticket as an
        error instead of leaving callers blocked forever."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        leftovers = self._drain_all_entries()
        self.metrics.record_error(len(leftovers))
        for e in leftovers:
            self._resolve_entry(e, FoldResponse(
                request_id=e.request.request_id, status="error",
                bucket_len=e.bucket_len, attempts=e.attempts or 1,
                error=f"scheduler worker crashed: {error}"))
