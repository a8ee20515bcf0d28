"""Feature-pipeline disaggregation: a CPU featurize pool feeding the
fold scheduler (counterpart of `alphafold2_tpu/serve/features.py`;
ParaFold's core result, FastFold's overlap).

The process executor's pool starts its workers with the "spawn" method,
never "fork": a forked child of a process that has initialised CUDA
inherits a CUDA context it cannot use. Its worker function
(`featurize_fn`, `featurize_raw` by default) is module-level and never
touches CUDA.

At millions-of-users scale AF2 serving time is dominated by CPU-side
feature work — tokenize, MSA prep, feature construction (and, in a full
deployment, the MSA search itself) — not the accelerator fold. Folding
them through one path couples the two: every submit pays featurization
inline, the accelerator idles while features cook, and feature work
dedups exactly never. This module splits serving into an explicit
two-stage pipeline:

    raw job --> FeaturePool (CPU workers)  --> Scheduler (accelerator)
                 |  feature cache tier           |  fold cache tier
                 |  (cache.FeatureCache,         |  (cache.FoldCache,
                 |   keyed by feature_key)       |   keyed by fold_key)
                 `- in-flight featurize          `- in-flight fold
                    coalescing                      coalescing

- `RawFoldRequest` is the raw unit of work: an AA string (or
  untokenized token array) plus an optional raw MSA (aligned strings or
  token rows), with the same QoS knobs as `FoldRequest`.
- `FeaturePool` runs featurization on a configurable worker pool OFF
  the submit hot path, with its own content-addressed cache tier
  (`cache.feature_key` keyed UPSTREAM of `fold_key` — no fold config in
  the key, so one feature entry serves every downstream fold variant)
  and in-flight featurize coalescing (duplicate raw traffic featurizes
  exactly once, independently of fold-level dedup). Completed features
  become `FoldRequest`s fed into the scheduler's existing queue; the
  caller's `FoldTicket` (returned synchronously from submit_raw)
  resolves off the fold ticket, progressive results included.
- `PipelineScheduler` is the thin two-stage front owning both.

QoS composition: a raw job's `deadline_s` covers the WHOLE pipeline —
time spent featurizing (queueing included) is deducted from the
deadline handed to the fold scheduler, and a job whose deadline expires
before its features are ready is shed without touching the queue
(`feature_deadline_exceeded`), the same
fold-dead-work-is-the-most-expensive-miss logic the scheduler applies.

Fleet composition: with a router on the scheduler, a raw job is routed
by its FEATURE key before featurizing — the ring owner featurizes
replica-side and folds (one bounded hop, `RawFoldRequest.forwarded`),
so the owner's feature cache concentrates the raw duplicate traffic the
same way its fold cache concentrates fold traffic. Any forwarding
trouble degrades to featurizing locally, never to an error.

Off by default, everywhere: a `Scheduler` without a `feature_pool` is
byte-for-byte today's behavior (`submit_raw` then featurizes inline,
which is exactly what callers hand-rolled before), and `serve_stats()`
carries a "featurize" section only when a pool is attached.

Obs: every raw job's request trace grows a `featurize` span (queue +
work in the pool; tools/obs_report.py STAGE_ORDER renders it ahead of
submit), the pool reports `serve_featurize_*` counters and a
queue-depth gauge, and featurize latency lands in a registry histogram
(`serve_featurize_seconds`).
"""

from __future__ import annotations

import functools
import multiprocessing
import threading
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Union

import numpy as np

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.cache.features import FeatureCache, FeaturizedInput
from alphafold2_tpu_torch.cache.keys import feature_key
from alphafold2_tpu_torch.data.featurize import tokenize
from alphafold2_tpu_torch.obs.registry import (DEFAULT_LATENCY_BUCKETS,
                                               Histogram, MetricsRegistry,
                                               get_registry)
from alphafold2_tpu_torch.serve.request import (FoldRequest, FoldResponse,
                                                FoldTicket, _next_request_id)
from alphafold2_tpu_torch.utils.hashing import stable_digest

def _process_pool(workers: int) -> ProcessPoolExecutor:
    """The process executor's pool: spawned workers (a fork would copy
    the parent's CUDA state into a child that cannot use it)."""
    return ProcessPoolExecutor(
        max_workers=workers, mp_context=multiprocessing.get_context("spawn"))


# bump when the featurizer's BEHAVIOR changes (token mapping, MSA prep
# convention): the config digest lands in every feature_key, so stale
# cached features miss cleanly instead of serving the old mapping
FEATURIZE_VERSION = 1


def featurizer_config_digest() -> str:
    """Digest of everything that determines tokenize/MSA-prep output
    for a given raw input — part of every `feature_key`, so a tokenizer
    or alphabet change can never serve a stale featurized form."""
    from alphafold2_tpu_torch.data.featurize import GAP_CHARS
    return stable_digest("featurizer", FEATURIZE_VERSION,
                         constants.AA_ALPHABET, GAP_CHARS)


@dataclass
class RawFoldRequest:
    """One RAW fold job: the pre-featurization unit of work.

    seq: an AA string ("MKV...") or an untokenized 1-D int array.
    msa: optional raw MSA — a sequence of aligned AA strings (query
        row first, trrosetta convention) or an (m, n) int token array.
        Depth handling (msa_depth truncation/padding) stays the fold
        scheduler's job; featurization preserves every row.
    priority / deadline_s: FoldRequest semantics; the deadline covers
        the WHOLE pipeline, featurize time included.
    forwarded: this job already took its one feature-key routing hop
        (fleet mode) — the receiver featurizes and folds locally.
    qos: FoldRequest semantics, plus the raw-path meaning of
        "express": skip MSA prep entirely — the pool's
        embedding-injection featurizer (FeaturePool(express=...))
        builds single-sequence features, and the fold rides the
        express deadline/SLO class. "online" (default) is byte-
        for-byte the pre-express path.
    """

    seq: Union[str, np.ndarray]
    msa: Optional[Union[Sequence[str], np.ndarray]] = None
    request_id: str = field(default_factory=_next_request_id)
    priority: int = 0
    deadline_s: Optional[float] = None
    forwarded: bool = False
    qos: str = "online"

    def __post_init__(self):
        if self.qos not in ("online", "bulk", "express"):
            raise ValueError(
                f"RawFoldRequest.qos must be 'online', 'bulk' or "
                f"'express', got {self.qos!r}")

    @property
    def length(self) -> int:
        return (len(self.seq.strip()) if isinstance(self.seq, str)
                else int(np.asarray(self.seq).shape[0]))


def featurize_raw(raw: RawFoldRequest) -> FeaturizedInput:
    """Tokenize + MSA-prep one raw job into the arrays `FoldRequest`
    consumes. Pure host-side numpy (data/featurize.tokenize); raises
    ValueError on malformed input — the pool maps that to an error
    terminal, the inline path to the caller."""
    seq = raw.seq
    if isinstance(seq, str):
        tokens = tokenize(seq.strip())
    else:
        tokens = np.asarray(seq, np.int32)
    if tokens.ndim != 1 or tokens.shape[0] == 0:
        raise ValueError(
            f"raw seq must featurize to a non-empty 1-D token array, "
            f"got shape {tokens.shape}")
    msa = raw.msa
    if msa is None:
        return FeaturizedInput(seq=tokens, msa=None)
    if not isinstance(msa, np.ndarray) and len(msa) > 0 \
            and all(isinstance(r, str) for r in msa):
        rows = []
        for i, r in enumerate(msa):
            row = tokenize(r.strip())
            if row.shape[0] != tokens.shape[0]:
                raise ValueError(
                    f"raw MSA row {i} has length {row.shape[0]}, "
                    f"expected aligned length {tokens.shape[0]}")
            rows.append(row)
        msa_tokens = np.stack(rows, 0).astype(np.int32)
    else:
        msa_tokens = np.asarray(msa, np.int32)
    if msa_tokens.ndim != 2 or msa_tokens.shape[1] != tokens.shape[0]:
        raise ValueError(
            f"raw MSA must featurize to (m, {tokens.shape[0]}), got "
            f"{msa_tokens.shape}")
    return FeaturizedInput(seq=tokens, msa=msa_tokens)


# -- express lane: MSA-free featurization ----------------------


class StubEmbedder:
    """Deterministic stand-in for a pretrained single-sequence embedder
    (the `embeds.py` ESM/ProtTran wrappers' `embed_batch` contract):
    per-position embeddings derived from the tokens by pure integer
    numpy, byte-stable across processes and platforms — what CPU tests
    and the loadtest need where a real language model would load
    checkpoints. dim: embedding width (kept tiny; express features
    only quantize it back down)."""

    def __init__(self, dim: int = 16):
        if dim < 1:
            raise ValueError("StubEmbedder dim must be >= 1")
        self.dim = int(dim)

    @property
    def digest(self) -> str:
        """Identity folded into express feature keys — a different
        embedder must never share cached features."""
        return f"stub-embedder-v1-d{self.dim}"

    def embed_batch(self, seq, msa=None):
        """(n,) int tokens -> ((n, dim) float32 embedding, None).
        Mirrors the reference wrappers' (seq_embed, msa_embed) return
        shape; the stub has no MSA track."""
        tokens = np.asarray(seq, dtype=np.int64).reshape(-1)
        pos = np.arange(tokens.shape[0], dtype=np.int64)[:, None]
        ch = np.arange(self.dim, dtype=np.int64)[None, :]
        # LCG-style integer mix: deterministic, alphabet-sized inputs
        # spread over the full int range before the float squash
        mixed = (tokens[:, None] * 2654435761 + pos * 40503
                 + ch * 69621 + 12345) % 2147483647
        embed = (mixed.astype(np.float32) / 2147483647.0) * 2.0 - 1.0
        return embed, None


def express_featurize(raw: RawFoldRequest, embedder) -> FeaturizedInput:
    """MSA-free express featurization: tokenize the sequence, embed it
    with the single-sequence embedder, and inject the embedding into
    the MSA track as one pseudo-row behind the query (HelixFold-
    single's trick: the MSA transformer reads a derived row instead of
    a real alignment, so the model runs at constant shallow depth with
    no search — two rows here, query-first per the bucketing
    convention). The
    pseudo-row is the embedding quantized back into the token
    alphabet — deterministic for a deterministic embedder, which is
    what the byte-determinism test pins. Any raw MSA on the request is
    IGNORED by design: express means "don't wait for alignments"."""
    seq = raw.seq
    tokens = tokenize(seq.strip()) if isinstance(seq, str) \
        else np.asarray(seq, np.int32)
    if tokens.ndim != 1 or tokens.shape[0] == 0:
        raise ValueError(
            f"express seq must featurize to a non-empty 1-D token "
            f"array, got shape {tokens.shape}")
    embed, _ = embedder.embed_batch(tokens)
    embed = np.asarray(embed)
    if embed.ndim != 2 or embed.shape[0] != tokens.shape[0]:
        raise ValueError(
            f"embedder returned shape {embed.shape}, expected "
            f"({tokens.shape[0]}, d)")
    # quantize each position's embedding into the token vocabulary:
    # scale the per-position mean into [0, 1), then index the alphabet
    vocab = len(constants.AA_ALPHABET)
    mean = embed.mean(axis=-1)
    lo, hi = float(mean.min()), float(mean.max())
    span = hi - lo
    if span <= 0:
        pseudo = np.zeros_like(tokens)
    else:
        unit = (mean - lo) / span
        pseudo = np.minimum((unit * vocab).astype(np.int32), vocab - 1)
    msa = np.stack([tokens, pseudo], 0).astype(np.int32)
    return FeaturizedInput(seq=tokens, msa=msa)


class _Waiter:
    """One raw job parked on an in-flight featurize leader."""

    __slots__ = ("raw", "ticket", "trace", "t0", "scheduler")

    def __init__(self, raw, ticket, trace, t0, scheduler):
        self.raw = raw
        self.ticket = ticket
        self.trace = trace
        self.t0 = t0
        self.scheduler = scheduler


class FeaturePool:
    """CPU featurize pool feeding a fold scheduler's queue.

    workers: featurize worker threads — ParaFold's point is that this
        scales independently of both the submit path and the
        accelerator: size it so feature throughput matches fold
        throughput (README "Feature pipeline").
    cache: optional `cache.FeatureCache` — the feature tier. A hit
        skips featurization entirely (the raw job goes straight to the
        fold scheduler). Off when None.
    latency_s: synthetic extra featurize latency per EXECUTION — the
        benchmarking knob (`serve_loadtest --feature-latency-ms`) that
        stands in for real MSA-search cost on the tiny test model; 0
        (the default) adds nothing.
    featurize_fn: override the featurize implementation
        (RawFoldRequest -> FeaturizedInput); defaults to
        `featurize_raw`. The seam real MSA pipelines plug into.
    config_digest: feature-key config namespace; defaults to
        `featurizer_config_digest()` (pass your own when overriding
        featurize_fn — different featurizers must not share keys).
    faults: optional serve.faults.FaultPlan — chaos hook fired before
        each featurize execution (injected exceptions fan out to every
        coalesced waiter exactly like a real featurize failure;
        injected latency exercises the feature-deadline path). None
        (default) costs nothing.
    executor: "thread" (default — byte-identical behavior) or
        "process": featurize COMPUTATIONS run on a shared
        ProcessPoolExecutor, sidestepping the GIL (the prerequisite
        for real jackhmmer/mmseqs featurizers whose parsing is
        CPU-bound Python). All coordination — coalescing, cache,
        deadlines, traces, fold handoff — stays on the thread pool;
        only the pure `featurize_fn(raw)` call crosses the process
        boundary, so the semantics are identical. An unpicklable
        featurize_fn/raw or a broken child degrades that job to
        in-thread featurization (counted in snapshot
        "process_fallbacks"), never to an error.
    express: optional single-sequence embedder (the `embed_batch`
        contract — StubEmbedder, or a real ESM/ProtTran wrapper)
        enabling `RawFoldRequest(qos="express")`: MSA prep is bypassed
        via `express_featurize`, keyed under the embedder's own digest
        namespace so express and online features never collide. None
        (default): express raw jobs resolve as errors.
    express_deadline_s: cap on the FOLD deadline of express jobs (the
        express lane's promise is tight tail latency — an express fold
        that can't run promptly sheds instead of queueing). None =
        no cap beyond the request's own deadline.

    Duplicate raw traffic dedups at this tier independently of fold
    traffic: an in-flight featurize of the same feature key coalesces
    (one execution, every waiter fed), a finished one hits the cache.
    Each deduped job still submits its OWN FoldRequest downstream —
    identical tokens, so the fold tier's cache/coalescing then dedups
    the folds exactly as if the callers had submitted tokens directly.
    """

    def __init__(self, workers: int = 2,
                 cache: Optional[FeatureCache] = None,
                 latency_s: float = 0.0,
                 featurize_fn: Optional[Callable] = None,
                 config_digest: Optional[str] = None,
                 faults=None,
                 registry: Optional[MetricsRegistry] = None,
                 executor: str = "thread",
                 express=None,
                 express_deadline_s: Optional[float] = None):
        if workers < 1:
            raise ValueError("FeaturePool needs at least 1 worker")
        if executor not in ("thread", "process"):
            raise ValueError(
                f"FeaturePool executor must be 'thread' or 'process', "
                f"got {executor!r}")
        if express_deadline_s is not None and express_deadline_s <= 0:
            raise ValueError("express_deadline_s must be > 0")
        self.workers = int(workers)
        self.cache = cache
        self.faults = faults
        self.latency_s = float(latency_s)
        self.featurize_fn = featurize_fn or featurize_raw
        self.config_digest = (featurizer_config_digest()
                              if config_digest is None else config_digest)
        self.executor = executor
        self.express = express
        self.express_deadline_s = express_deadline_s
        # express features key under the embedder's identity, never the
        # online featurizer's — a cached express pseudo-MSA must not
        # serve an online job for the same sequence (or vice versa)
        self._express_digest = None
        if express is not None:
            self._express_digest = stable_digest(
                "express-featurizer", FEATURIZE_VERSION,
                constants.AA_ALPHABET,
                getattr(express, "digest", type(express).__name__))
        self._proc_pool = (_process_pool(self.workers)
                           if executor == "process" else None)
        self.process_fallbacks = 0     # jobs degraded to in-thread
        self._pool = ThreadPoolExecutor(
            max_workers=self.workers, thread_name_prefix="featurize")
        self._lock = threading.Lock()
        # feature_key -> list of parked _Waiter (leader excluded: it is
        # carried by the pool work item itself)
        self._inflight: dict = {}
        self._depth = 0                # queued + running pool jobs
        self._stopped = False
        self._retired_pools: list = []  # pre-resize executors, draining
        self.resizes = 0               # in-place worker-count changes
        # lifetime counters (lock-guarded; snapshot reads are racy-ok)
        self.submissions = 0
        self.executions = 0            # featurize runs (dedup excluded)
        self.cache_hits = 0
        self.coalesced = 0
        self.errors = 0
        self.shed = 0                  # deadlines dead before features
        self.forwarded = 0             # raw jobs routed to their owner
        reg = registry or get_registry()
        self._c_total = reg.counter(
            "serve_featurize_total",
            "featurize executions by the feature pool")
        self._c_hits = reg.counter(
            "serve_featurize_cache_hits_total",
            "raw jobs served from the feature cache tier")
        self._c_coalesced = reg.counter(
            "serve_featurize_coalesced_total",
            "raw jobs coalesced onto an in-flight featurize")
        self._c_errors = reg.counter(
            "serve_featurize_errors_total",
            "raw jobs failed in featurization")
        self._g_depth = reg.gauge(
            "serve_featurize_queue_depth",
            "raw jobs queued or running in the feature pool")
        self._h_latency = reg.histogram(
            "serve_featurize_seconds",
            "featurize execution latency (work only, not queueing)",
            reservoir=4096)
        # instance-scoped reservoir answering THIS pool's snapshot()
        self._latency = Histogram("serve_featurize_seconds",
                                  "featurize latency",
                                  buckets=DEFAULT_LATENCY_BUCKETS,
                                  reservoir=4096)

    # -- lifecycle -------------------------------------------------------

    def stop(self):
        """Drain the worker pool (in-flight featurize jobs finish and
        feed their folds; nothing new is accepted)."""
        with self._lock:
            self._stopped = True
            pools = [self._pool] + self._retired_pools
            self._retired_pools = []
        for pool in pools:
            pool.shutdown(wait=True)
        # the process pool last: thread workers above may still be
        # awaiting results from it
        if self._proc_pool is not None:
            self._proc_pool.shutdown(wait=True)

    def resize(self, workers: int) -> int:
        """Resize the worker pool IN PLACE (`/admin/resize`):
        swap in a fresh executor at the new width and retire the old
        one without waiting — its queued + running jobs drain on its
        own threads, new submissions land on the new pool, and no job
        is dropped or re-run. Callers racing the swap and losing
        (submit on a just-shutdown pool) already fall back to inline
        featurize in `_enqueue_local`. Returns the new width."""
        workers = int(workers)
        if workers < 1:
            raise ValueError("FeaturePool needs at least 1 worker")
        with self._lock:
            if self._stopped:
                raise RuntimeError("feature pool stopped")
            if workers == self.workers:
                return self.workers
            old = self._pool
            self._pool = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="featurize")
            # keep a handle so stop() still waits for the stragglers
            self._retired_pools.append(old)
            self.workers = workers
            self.resizes += 1
            old_proc = self._proc_pool
            if old_proc is not None:
                self._proc_pool = _process_pool(workers)
        old.shutdown(wait=False)     # drains queued jobs, blocks nothing
        if self.executor == "process" and old_proc is not None:
            old_proc.shutdown(wait=False)
        return workers

    def __enter__(self) -> "FeaturePool":
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- submission ------------------------------------------------------

    def submit_raw(self, raw: RawFoldRequest, scheduler,
                   trace=None) -> FoldTicket:
        """Accept one raw job; returns the caller's FoldTicket NOW (the
        same ticket type Scheduler.submit returns — result(), progress
        callbacks, and done callbacks all behave identically). The
        pipeline behind it: feature cache -> in-flight coalesce ->
        worker featurize -> scheduler.submit, with the request trace
        carrying a `featurize` span for the first two stages' miss
        path. `trace`: an already-started obs.Trace to continue (a
        remote hop's continued trace); None mints one."""
        ticket = FoldTicket(raw.request_id)
        if trace is None:
            trace = scheduler.tracer.start_trace(raw.request_id)
        t0 = time.monotonic()
        with self._lock:
            self.submissions += 1
            stopped = self._stopped
        if stopped:
            self._resolve_error(ticket, trace, raw,
                                "feature pool stopped")
            return ticket
        if getattr(raw, "qos", "online") == "express" \
                and self.express is None:
            # the async seam's ValueError: an express job without an
            # embedder must fail loudly, not silently serve the full
            # prep path under an express deadline it cannot meet
            self._resolve_error(
                ticket, trace, raw,
                "qos='express' needs FeaturePool(express=...) — no "
                "embedding-injection featurizer is configured")
            return ticket
        key = None
        try:
            key = feature_key(raw.seq, raw.msa,
                              config_digest=self._digest_for(raw))
        except Exception:
            pass          # unkeyable: featurize without dedup/caching
        if self._maybe_forward_raw(raw, key, scheduler, ticket, trace,
                                   t0):
            return ticket
        self._enqueue_local(raw, key, scheduler, ticket, trace, t0)
        return ticket

    def _enqueue_local(self, raw, key, scheduler, ticket, trace, t0):
        trace.begin("featurize")
        if key is not None:
            with self._lock:
                waiting = self._inflight.get(key)
                if waiting is not None:
                    # coalesce: the in-flight leader's execution feeds
                    # this waiter too — zero duplicate featurize work
                    waiting.append(_Waiter(raw, ticket, trace, t0,
                                           scheduler))
                    self.coalesced += 1
                    self._c_coalesced.inc()
                    trace.event("featurize_coalesced")
                    return
                self._inflight[key] = []
            # cache check AFTER claiming leadership, never before: an
            # unlocked check-then-claim would race a completing leader
            # (put + settle between our miss and our claim) into a
            # SECOND featurize execution of an already-cached key.
            # Having claimed, any racing duplicate coalesces behind us
            # and is fed by whichever path we take below.
            if self.cache is not None:
                feats = self.cache.get(key, trace=trace)
                if feats is not None:
                    with self._lock:
                        self.cache_hits += 1
                    self._c_hits.inc()
                    waiters = self._settle(key)   # release the claim
                    trace.end("featurize", cached=True)
                    self._submit_fold(scheduler, raw, feats, ticket,
                                      trace, t0)
                    for w in waiters:
                        w.trace.end("featurize", coalesced=True)
                        self._submit_fold(w.scheduler, w.raw, feats,
                                          w.ticket, w.trace, w.t0)
                    return
        self._advance_depth(+1)
        try:
            self._pool.submit(self._run, key, raw, ticket, trace, t0,
                              scheduler)
        except BaseException:
            # pool shut down in the submit/enqueue race: featurize
            # inline — slower beats lost
            self._advance_depth(-1)
            self._run(key, raw, ticket, trace, t0, scheduler,
                      count_depth=False)

    def _advance_depth(self, delta: int):
        with self._lock:
            self._depth += delta
            depth = self._depth
        self._g_depth.set(depth)

    def _digest_for(self, raw) -> str:
        """Feature-key config namespace for one raw job: the express
        embedder's digest for express jobs, the featurizer's for
        everything else — the two representations must never share
        cache entries."""
        if getattr(raw, "qos", "online") == "express" \
                and self._express_digest is not None:
            return f"express:{self._express_digest}"
        return self.config_digest

    def _fn_for(self, raw) -> Callable:
        """The featurize implementation one raw job runs: the express
        embedding-injection path for express jobs, the configured
        featurize_fn otherwise. functools.partial keeps it picklable
        for the process executor."""
        if getattr(raw, "qos", "online") == "express":
            return functools.partial(express_featurize,
                                     embedder=self.express)
        return self.featurize_fn

    def _featurize_exec(self, raw, fn) -> FeaturizedInput:
        """Run the pure featurize computation on the configured
        executor. Process mode crosses the pickle boundary; anything
        that breaks the CROSSING (unpicklable fn/raw, a killed child)
        degrades to in-thread featurization — a real featurize failure
        inside fn propagates either way."""
        if self._proc_pool is None:
            return fn(raw)
        try:
            return self._proc_pool.submit(fn, raw).result()
        except Exception:
            # pickling trouble, a killed child, a shut-down pool — and
            # genuine featurize failures — all surface here; rather
            # than classify exception types, re-run in-thread: a
            # crossing problem succeeds inline, a real featurize
            # failure raises the same error with its real reason
            with self._lock:
                self.process_fallbacks += 1
            return fn(raw)

    # -- worker ----------------------------------------------------------

    def _run(self, key, raw, ticket, trace, t0, scheduler,
             count_depth: bool = True):
        try:
            t_work = time.monotonic()
            try:
                if self.faults is not None:
                    # chaos hook: an injected featurize
                    # failure takes the SAME path a real one does —
                    # _settle_error fans it to every coalesced waiter
                    self.faults.on_featurize(key)
                if self.latency_s > 0:
                    time.sleep(self.latency_s)
                feats = self._featurize_exec(raw, self._fn_for(raw))
            except Exception as exc:
                self._settle_error(key, ticket, trace, raw,
                                   f"featurize failed: {exc!r}")
                return
            dur = time.monotonic() - t_work
            with self._lock:
                self.executions += 1
            self._c_total.inc()
            self._h_latency.observe(dur)
            self._latency.observe(dur)
            if key is not None and self.cache is not None:
                try:
                    self.cache.put(key, feats.seq, feats.msa)
                except Exception:
                    pass      # a broken cache costs recomputes, never jobs
            waiters = self._settle(key)
            trace.end("featurize")
            self._submit_fold(scheduler, raw, feats, ticket, trace, t0)
            for w in waiters:
                w.trace.end("featurize", coalesced=True)
                self._submit_fold(w.scheduler, w.raw, feats, w.ticket,
                                  w.trace, w.t0)
        finally:
            if count_depth:
                self._advance_depth(-1)

    def _settle(self, key) -> list:
        if key is None:
            return []
        with self._lock:
            return self._inflight.pop(key, [])

    def _settle_error(self, key, ticket, trace, raw, error: str):
        """Featurize failed: the leader AND every coalesced waiter get
        the error terminal (a waiter that attached to a failing leader
        must see that failure, never hang)."""
        waiters = self._settle(key)
        self._resolve_error(ticket, trace, raw, error)
        for w in waiters:
            self._resolve_error(w.ticket, w.trace, w.raw, error)

    def _resolve_error(self, ticket, trace, raw, error: str):
        with self._lock:
            self.errors += 1
        self._c_errors.inc()
        trace.finish("error", error=error)
        ticket._resolve(FoldResponse(
            request_id=raw.request_id, status="error", error=error))

    # -- stage handoff ---------------------------------------------------

    def _submit_fold(self, scheduler, raw, feats: FeaturizedInput,
                     ticket, trace, t0: float):
        """Features ready: hand the job to the fold scheduler and chain
        its ticket (terminal + progressive) onto the caller's. The
        remaining deadline is re-anchored: featurize time already spent
        counts against the raw job's budget."""
        qos = getattr(raw, "qos", "online")
        deadline = raw.deadline_s
        if deadline is not None:
            deadline = deadline - (time.monotonic() - t0)
            if deadline <= 0:
                with self._lock:
                    self.shed += 1
                trace.event("feature_deadline_exceeded")
                trace.finish("shed",
                             error="deadline expired before features "
                                   "were ready (feature_deadline_"
                                   "exceeded)")
                ticket._resolve(FoldResponse(
                    request_id=raw.request_id, status="shed",
                    latency_s=time.monotonic() - t0,
                    error="deadline expired before features were ready "
                          "(feature_deadline_exceeded)"))
                return
        if qos == "express" and self.express_deadline_s is not None:
            # the express promise is tail latency: the FOLD gets at
            # most the express cap, even when the caller's own budget
            # is looser — better an honest early shed than a p99 blown
            # by queueing behind long folds
            deadline = (self.express_deadline_s if deadline is None
                        else min(deadline, self.express_deadline_s))
        try:
            request = FoldRequest(
                seq=feats.seq, msa=feats.msa,
                request_id=raw.request_id, priority=raw.priority,
                deadline_s=deadline, forwarded=raw.forwarded,
                qos=qos)
            inner = scheduler.submit(request, trace=trace)
        except Exception as exc:
            # the async seam cannot raise backpressure at the caller
            # the way a synchronous submit does: rejected/draining/
            # stopped all terminate the ticket with the scheduler's
            # reason. finish() here is idempotent cover for failures
            # BEFORE submit adopts the trace (e.g. the bucket_for
            # fail-fast on an over-length sequence) — without it that
            # request would vanish from obs with no terminal record
            with self._lock:
                self.errors += 1
            self._c_errors.inc()
            trace.finish("error",
                         error=f"fold submit rejected after "
                               f"featurize: {exc!r}")
            ticket._resolve(FoldResponse(
                request_id=raw.request_id, status="error",
                latency_s=time.monotonic() - t0,
                error=f"fold submit rejected after featurize: {exc!r}"))
            return
        inner.add_progress_callback(ticket._publish_progress)
        inner.add_done_callback(ticket._resolve)

    # -- fleet routing ---------------------------------------------------

    def _maybe_forward_raw(self, raw, key, scheduler, ticket, trace,
                           t0) -> bool:
        """Route the RAW job by its feature key: when the scheduler has
        a router and the key's ring owner is another healthy replica
        with a raw-capable transport, forward the raw job there — the
        owner featurizes replica-side, so its feature cache (and fold
        cache) concentrate the key's traffic. One bounded hop
        (raw.forwarded); ANY trouble means featurize locally."""
        router = getattr(scheduler, "router", None)
        if router is None or raw.forwarded or key is None:
            return False
        forward_raw = getattr(router, "forward_raw", None)
        if forward_raw is None:
            return False
        try:
            decision = router.route(key)
        except Exception:
            return False
        if decision is None or decision.is_local:
            return False
        owner = decision.owner_id
        trace.event("routed_raw", owner=owner, reason=decision.reason)
        trace.begin("forward")
        try:
            remote = forward_raw(
                owner,
                RawFoldRequest(seq=raw.seq, msa=raw.msa,
                               request_id=raw.request_id,
                               priority=raw.priority,
                               deadline_s=raw.deadline_s,
                               forwarded=True,
                               qos=getattr(raw, "qos", "online")),
                trace=trace)
        except Exception:
            try:
                router.note_fallback("forward_raw_error")
            except Exception:
                pass
            trace.end("forward", failed=True)
            return False
        with self._lock:
            self.forwarded += 1

        def _on_remote(resp: FoldResponse):
            trace.end("forward", owner=owner)
            if resp is None:
                # defensive: a done callback always carries a response
                # today, but a half-guarded None would otherwise raise
                # below and leave the caller's ticket unresolved forever
                trace.finish("error", source="forwarded",
                             error="raw forward returned nothing")
                ticket._resolve(FoldResponse(
                    request_id=raw.request_id, status="error",
                    latency_s=time.monotonic() - t0, source="forwarded",
                    error="raw forward returned nothing"))
                return
            # transport death is failover-eligible: the work is viable,
            # only the owner died — featurize locally (the marker
            # string is fleet.rpc.RPC_TRANSPORT_MARKER, spelled
            # literally because serve must not import fleet)
            if resp.status == "error" and resp.error \
                    and "rpc_transport" in resp.error:
                trace.event("failover_local_raw", owner=owner)
                try:
                    self._enqueue_local(raw, key, scheduler, ticket,
                                        trace, t0)
                    return
                except Exception:
                    pass      # fall through: resolve the transport error
            trace.finish(resp.status, source="forwarded",
                         error=resp.error)
            ticket._resolve(FoldResponse(
                request_id=raw.request_id,
                status=resp.status,
                coords=resp.coords, confidence=resp.confidence,
                bucket_len=resp.bucket_len,
                latency_s=time.monotonic() - t0,
                error=resp.error, source="forwarded",
                attempts=getattr(resp, "attempts", 1),
                recycles=getattr(resp, "recycles", None)))

        remote.add_done_callback(_on_remote)
        return True

    # -- views -----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            out = {"workers": self.workers,
                   "queue_depth": self._depth,
                   "submissions": self.submissions,
                   "executions": self.executions,
                   "cache_hits": self.cache_hits,
                   "coalesced": self.coalesced,
                   "errors": self.errors,
                   "shed": self.shed,
                   "forwarded": self.forwarded,
                   "latency_s_injected": self.latency_s}
        if self.resizes:
            # only after a resize: an untouched pool's snapshot stays
            # byte-identical (controller-off stats pin)
            out["resizes"] = self.resizes
        if self.executor != "thread":
            # non-default executors only: the thread-pool snapshot
            # stays byte-identical
            out["executor"] = self.executor
            out["process_fallbacks"] = self.process_fallbacks
        if self.express is not None:
            out["express"] = {
                "embedder": getattr(self.express, "digest",
                                    type(self.express).__name__),
                "deadline_s": self.express_deadline_s,
            }
        out["featurize_p50_s"] = self._latency.percentile(50)
        out["featurize_p99_s"] = self._latency.percentile(99)
        if self.cache is not None:
            out["cache"] = self.cache.snapshot()
        return out


class PipelineScheduler:
    """The two-stage serving front: one FeaturePool + one Scheduler as
    a single object with the Scheduler's surface plus `submit_raw`.

        pool = serve.FeaturePool(workers=4, cache=FeatureCache(...))
        pipe = serve.PipelineScheduler(scheduler, pool)
        with pipe:
            ticket = pipe.submit_raw(serve.RawFoldRequest("MKV...",
                                                          msa=rows))
            response = ticket.result(timeout=120)

    Construction ATTACHES the pool to the scheduler (equivalent to
    `Scheduler(..., feature_pool=pool)`), so `serve_stats()["featurize"]`
    and `Scheduler.submit_raw` work whichever handle you hold.
    Lifecycle owns both stages: stop() drains the feature pool FIRST
    (in-flight featurize jobs feed their folds), then the scheduler.
    """

    def __init__(self, scheduler, feature_pool: FeaturePool):
        self.scheduler = scheduler
        self.feature_pool = feature_pool
        scheduler.feature_pool = feature_pool

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "PipelineScheduler":
        self.scheduler.start()
        return self

    def stop(self, drain: bool = True):
        # pool first: its workers submit into the scheduler, and a
        # drained pool guarantees no featurize job races a stopping
        # queue
        self.feature_pool.stop()
        self.scheduler.stop(drain=drain)

    def __enter__(self) -> "PipelineScheduler":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- passthrough surface ---------------------------------------------

    @property
    def tracer(self):
        """The scheduler's tracer — a FrontDoorServer fronting this
        object continues inbound trace contexts through it,
        for tokenized submits exactly like raw ones."""
        return self.scheduler.tracer

    def submit(self, request: FoldRequest, trace=None) -> FoldTicket:
        return self.scheduler.submit(request, trace=trace)

    def submit_raw(self, raw: RawFoldRequest, trace=None) -> FoldTicket:
        return self.feature_pool.submit_raw(raw, self.scheduler,
                                            trace=trace)

    def warmup(self, *args, **kwargs) -> int:
        return self.scheduler.warmup(*args, **kwargs)

    def drain(self, timeout_s: float = 30.0) -> bool:
        self.feature_pool.stop()
        return self.scheduler.drain(timeout_s)

    def health(self) -> dict:
        return self.scheduler.health()

    def serve_stats(self) -> dict:
        return self.scheduler.serve_stats()
