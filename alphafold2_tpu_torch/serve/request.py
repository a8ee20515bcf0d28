"""Serving request/response types.

The unit of work for `serve.Scheduler` is one sequence (plus optional
MSA), not a padded batch: batching, padding, and shape selection are the
server's job (bucketing.py / scheduler.py), so callers submit ragged
requests and get back exact-length results. Deadlines are wall-relative
at submit time and enforced by the scheduler (expired requests are shed,
not folded — ParaFold-style load shedding beats folding dead work).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_req_counter = itertools.count()


def _next_request_id() -> str:
    return f"req-{next(_req_counter)}"


@dataclass
class FoldRequest:
    """One fold job: a token sequence, optional MSA, QoS knobs.

    seq: (n,) int tokens (featurize.tokenize output).
    msa: optional (m, n) int tokens; rows beyond the scheduler's view are
        padded/masked per batch, never truncated.
    priority: higher folds first when a batch is formed from a backlog.
    deadline_s: wall-clock budget from submit; past it the request is
        shed with status "shed" instead of occupying accelerator time.
    forwarded: this request already took its one fleet-routing hop
        (fleet.ConsistentHashRouter); the receiving scheduler serves it
        locally regardless of its own ring view, so divergent membership
        views can bounce a request once, never loop it.
    qos: "online" (the default — every pre-bulk caller, byte-for-byte
        the old behavior), "bulk" (lowest-QoS sweep work that rides
        the scheduler's BulkQueue, admitted only by work-stealing and
        throttled by online burn rate; ignored by schedulers
        constructed without a BulkPolicy), or "express" (interactive
        single-sequence traffic: rides the online queue —
        same admission, same shedding — but is tallied under its own
        metric/SLO class so tight-deadline traffic is observable and
        burn-rate-gated separately; the MSA bypass itself lives in
        serve.features, not here).
    """

    seq: np.ndarray
    msa: Optional[np.ndarray] = None
    request_id: str = field(default_factory=_next_request_id)
    priority: int = 0
    deadline_s: Optional[float] = None
    forwarded: bool = False
    qos: str = "online"

    def __post_init__(self):
        if self.qos not in ("online", "bulk", "express"):
            raise ValueError(
                f"FoldRequest.qos must be 'online', 'bulk' or 'express', "
                f"got {self.qos!r}")
        self.seq = np.asarray(self.seq, dtype=np.int32)
        if self.seq.ndim != 1:
            raise ValueError(
                f"FoldRequest.seq must be 1-D (n,), got {self.seq.shape}; "
                "the scheduler owns batching")
        if self.msa is not None:
            self.msa = np.asarray(self.msa, dtype=np.int32)
            if self.msa.ndim != 2 or self.msa.shape[1] != self.seq.shape[0]:
                raise ValueError(
                    f"FoldRequest.msa must be (m, {self.seq.shape[0]}), "
                    f"got {self.msa.shape}")

    @property
    def length(self) -> int:
        return int(self.seq.shape[0])


@dataclass
class FoldResponse:
    """Result of one FoldRequest, unpadded back to the request length.

    status: "ok" | "shed" (deadline expired before folding) |
            "error" (executor raised, retries exhausted, or the output
            failed validation; see .error) |
            "cancelled" (scheduler stopped without draining) |
            "degraded" (circuit breaker open: novel fold fast-shed at
            submit while the scheduler recovers) |
            "poisoned" (the request's content key is quarantined as a
            poison input — it failed deterministically in isolation or
            produced non-finite output; duplicates fail fast forever) |
            "too_large" (mesh-aware scheduler only: the analytic HBM
            footprint exceeds the largest configured device slice, so
            the fold is rejected at submit instead of OOMing mid-batch) |
            "preempted" (the replica received a spot-reclaim notice and
            spilled this fold's mid-loop checkpoint instead of finishing
            it; resubmit anywhere — a survivor resumes from the spilled
            recycle, or the controller adopts it automatically).
    source: how the result was obtained — "fold" (ran on the
            accelerator), "cache" (content-addressed result store hit),
            "coalesced" (attached to an identical in-flight fold; for
            non-ok statuses this marks leader-state propagation),
            "forwarded" (routed to its fleet owner replica, which
            folded/served it; the local process never touched the
            accelerator for it).
    attempts: executor batch executions this request participated in
            (> 1 iff a RetryPolicy re-enqueued or bisected its batch;
            stays at the default 1 for results that never had to
            retry — including cache/coalesced/shed resolutions).
    """

    request_id: str
    status: str
    coords: Optional[np.ndarray] = None       # (n, 3) CA trace
    confidence: Optional[np.ndarray] = None   # (n,) in [0, 1]
    bucket_len: Optional[int] = None
    latency_s: Optional[float] = None
    error: Optional[str] = None
    source: str = "fold"
    attempts: int = 1
    # recycle iterations actually executed for this result (step-mode
    # scheduling only — serve.recycle.RecyclePolicy; None everywhere
    # else, including cache/coalesced/forwarded serves and the classic
    # opaque-fold path). With early exit this can be < the configured
    # num_recycles: the element converged and skipped the rest.
    recycles: Optional[int] = None
    # cascade provenance — defaults are the non-cascade
    # values, so every pre-cascade serving path is byte-identical.
    # tier: "" outside a cascade; "draft" when a draft-tier result was
    #       accepted by the confidence gate, "flagship" when the
    #       flagship tier produced/served it under a cascade.
    # escalated: the draft result failed the gate (or errored) and
    #       this response came from the flagship escalation.
    # confidence_score: the gate's scalar (ConfidenceScore.score) for
    #       cascade-served results; None everywhere else.
    tier: str = ""
    escalated: bool = False
    confidence_score: Optional[float] = None
    # mean normalized distogram entropy, computed at batch finish only
    # under SchedulerConfig(confidence_summary=True) — the distogram
    # itself is (n, n, bins) and never rides a response
    distogram_entropy: Optional[float] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclass
class FoldProgress:
    """One progressive (per-recycle) result published to a FoldTicket
    by the step-mode scheduler (RecyclePolicy(stream=True)): the
    element's coords + confidence after `recycle` iterations
    (0 = the embed/first pass). `converged` marks the update that
    retired the element early — its terminal FoldResponse carries the
    same arrays."""

    request_id: str
    recycle: int
    coords: np.ndarray                # (n, 3), unpadded
    confidence: np.ndarray            # (n,)
    converged: bool = False


class FoldTicket:
    """Future handed back by Scheduler.submit(); resolves to FoldResponse."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._event = threading.Event()
        self._response: Optional[FoldResponse] = None
        self._lock = threading.Lock()
        self._callbacks: list = []
        self._progress: list = []           # FoldProgress, oldest first
        self._progress_callbacks: list = []
        # optional hook fired (best-effort, once per expiry) when
        # result(timeout=) gives up on this ticket — fleet transports
        # use it to send the remote owner a cancel so a caller that
        # stopped waiting does not leave a parked result behind
        # (fleet.rpc.HttpTransport; counted fleet_remote_cancels_total)
        self._timeout_callback = None

    def _resolve(self, response: FoldResponse):
        self._response = response
        self._event.set()
        with self._lock:
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(response)
            except Exception:
                pass          # a broken observer never blocks resolution

    def add_done_callback(self, fn):
        """Run `fn(response)` when (or immediately if) this ticket
        resolves. Callbacks run on the resolving thread (the scheduler
        worker for folded requests) — keep them short and never let
        them block; exceptions are swallowed. This is the chaining seam
        fleet forwarding uses: a local ticket resolves off the remote
        replica's ticket without parking a waiter thread per request."""
        run_now = False
        with self._lock:
            if self._event.is_set():
                run_now = True
            else:
                self._callbacks.append(fn)
        if run_now:
            try:
                fn(self._response)
            except Exception:
                pass

    def _publish_progress(self, progress: FoldProgress):
        """Step-mode scheduler hook: record one per-recycle progressive
        result and fan it out to progress observers. Runs on the
        executing thread between recycles — observers must be short and
        never block; their exceptions are swallowed like done-callback
        ones."""
        with self._lock:
            self._progress.append(progress)
            callbacks = list(self._progress_callbacks)
        for cb in callbacks:
            try:
                cb(progress)
            except Exception:
                pass

    def add_progress_callback(self, fn):
        """Run `fn(FoldProgress)` for every progressive update,
        including (immediately) any already published."""
        with self._lock:
            backlog = list(self._progress)
            self._progress_callbacks.append(fn)
        for p in backlog:
            try:
                fn(p)
            except Exception:
                pass

    def progress(self) -> list:
        """All progressive updates published so far, oldest first
        (empty unless the scheduler runs RecyclePolicy(stream=True))."""
        with self._lock:
            return list(self._progress)

    def latest_progress(self) -> Optional[FoldProgress]:
        with self._lock:
            return self._progress[-1] if self._progress else None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> FoldResponse:
        if not self._event.wait(timeout):
            cb = self._timeout_callback
            if cb is not None:
                try:
                    cb()
                except Exception:
                    pass    # cancel is advisory; the timeout still raises
            raise TimeoutError(
                f"FoldTicket.result timed out for {self.request_id}")
        assert self._response is not None
        return self._response
