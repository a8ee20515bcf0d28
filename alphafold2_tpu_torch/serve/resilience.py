"""Failure-domain policy for the serving stack: retry, poison
isolation, watchdog, circuit breaker (counterpart of
`alphafold2_tpu/serve/resilience.py`; the payload classifier behind
`RetryPolicy.xla_classify` is `serve.cuda_errors`).

The happy-path server (scheduler/executor/cache/fleet) treats every
executor exception the same way: error-resolve the whole batch cohort.
At fleet scale that conflates four failure classes that need four
different answers:

- TRANSIENT device trouble (preemption, RESOURCE_EXHAUSTED, a flaky
  interconnect): the work is fine, the attempt was unlucky — retry the
  batch with bounded exponential backoff + jitter (`RetryPolicy`)
  instead of erroring N innocent requests;
- POISON inputs (an outlier length that OOMs, a degenerate MSA that
  NaNs the structure module): deterministic failures that will fail on
  every retry. A failing batch is BISECTED — split in half, each half
  retried as its own isolation group — so a single poison request is
  cornered in <= log2(batch) extra executions, then quarantined
  (`Quarantine`): its key resolves status "poisoned" immediately on
  every future submit instead of re-folding garbage;
- HUNG executions (a deadlocked runtime, a wedged device): no exception
  ever comes back, so the scheduler guards `executor.run` with a
  per-batch wall-clock deadline (`run_with_watchdog`); on expiry the
  batch is retry-resolved as transient and the executor is REBUILT —
  a hung device's compiled state is not trustworthy;
- SYSTEMIC failure (every batch failing): retrying harder makes it
  worse. A `CircuitBreaker` counts consecutive transient/watchdog
  batch failures; at the threshold it OPENS and the scheduler enters
  degraded mode — new non-duplicate submits are fast-shed with status
  "degraded" (cache and coalesce hits still serve), and after a
  cooldown the breaker goes HALF-OPEN, letting one probe batch through:
  success closes it, failure re-opens it.

Everything here is policy + small thread-safe state machines; the
scheduler owns the mechanics (re-enqueueing, group batching,
settlement). All of it is OFF by default — a `Scheduler` built without
`retry=RetryPolicy(...)` behaves exactly as before this module existed.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry


class TransientExecutorError(RuntimeError):
    """An executor failure worth retrying (device hiccup, not input)."""


class WatchdogTimeout(TransientExecutorError):
    """executor.run exceeded its per-batch wall-clock deadline."""


def run_with_watchdog(fn: Callable[[], object], timeout_s: float):
    """Run `fn()` on a helper thread, bounded by `timeout_s` seconds.

    Returns fn's result or re-raises its exception. On timeout raises
    `WatchdogTimeout` and ABANDONS the helper thread (daemon): a hung
    device call cannot be cancelled from Python, only outlived — the
    caller is expected to rebuild the executor so the zombie thread's
    eventual result (if any) lands in an object nothing references.
    One thread per call is deliberate: a persistent worker would be
    wedged by the very hang this function exists to survive, and
    batches are seconds-granular so the spawn cost is noise.
    """
    outcome: dict = {}
    done = threading.Event()

    def _target():
        try:
            outcome["value"] = fn()
        except BaseException as exc:     # noqa: BLE001 — relayed below
            outcome["exc"] = exc
        finally:
            done.set()

    t = threading.Thread(target=_target, daemon=True,
                         name="serve-watchdog-call")
    t.start()
    if not done.wait(timeout_s):
        raise WatchdogTimeout(
            f"executor.run exceeded watchdog deadline {timeout_s}s")
    if "exc" in outcome:
        raise outcome["exc"]
    return outcome["value"]


@dataclass
class RetryPolicy:
    """The scheduler's whole failure-domain configuration in one knob.

    max_attempts: total executions one entry may participate in before
        a persistent TRANSIENT failure becomes terminal
        (`retry_exhausted`). Deterministic failures skip the budget and
        go straight to bisection.
    backoff_base_s / backoff_max_s / jitter: exponential backoff for
        transient re-enqueues — base * 2^(attempts-1), capped, then
        stretched by up to `jitter` fraction (seeded; thundering-herd
        protection matters even inside one process when the device is
        the shared resource).
    bisect: poison isolation by batch bisection (see module docstring).
        False = a deterministic batch failure error-resolves everyone,
        exactly the pre-resilience behavior.
    nan_poison_threshold: how many non-finite outputs a key produces
        before it is quarantined. 1 (default): NaN coords are treated
        as a deterministic property of the input under fixed weights.
    watchdog_s: per-batch deadline on executor.run; None disables the
        watchdog. On expiry the executor is rebuilt and the batch is
        handled as a transient failure.
    breaker_threshold: consecutive transient/watchdog BATCH failures
        that flip the scheduler into degraded mode; 0 disables the
        circuit breaker.
    breaker_cooldown_s: open -> half-open delay.
    checkpoint_every: step-loop carry checkpointing (only
        meaningful under a RecyclePolicy). Every N recycles — and at
        every row-admission gap, where the host fetch is already
        paid — the scheduler snapshots the FoldStepState carry plus
        each row's age to host memory; a transient step failure or
        watchdog fire mid-loop then RESUMES the survivors at their
        checkpointed ages (executor rebuilt first when the watchdog
        fired) instead of requeueing everyone to recycle 0, bounding
        progress loss at `checkpoint_every` recycles per failure. A
        resume is byte-equal to the uninterrupted loop when the
        checkpoint sits at the failure step. 0 (default) disables
        checkpointing: every failure path is byte-for-byte the
        requeue-from-zero behavior.
    checkpoint_spill: durable checkpoint spill directory (
        "" disables — the default). With a path set, every host-memory
        carry checkpoint ALSO spills per-row npz payloads through
        `cache.checkpoints.CheckpointStore` to the disk tier keyed by
        (fold_key, model_tag, age) — written at the same
        `checkpoint_every` cadence (which must therefore be >= 1),
        pruned to the newest age, and discarded when the fold
        resolves. A restarted replica (boot discovery), a re-submitted
        duplicate (submit consult), or a failover peer (the
        `kind=checkpoint` peer route) then RESUMES the fold at its
        checkpointed age instead of refolding from recycle 0 —
        resume-at-age is byte-equal to the uninterrupted loop, per
        row, through the step checkpoint's restore path.
        `Scheduler.drain()` spills every in-flight loop's current carry
        before exiting, so drain becomes checkpoint-and-hand-off (the
        preemptible/spot contract). "" keeps scrubbed serve_stats() and the
        registry metric-name set byte-identical to spill-off.
    row_isolation: per-row poison isolation in the step loop.
        A per-step non-finite scan retires ONLY the
        offending row the moment its output goes non-finite (strike
        toward `nan_poison_threshold` via the keyed Quarantine), and
        a deterministic failure that attributes itself to specific
        batch rows (`FaultInjected.rows` — content-addressed chaos
        does; real CUDA errors do not) quarantines and retires exactly
        those rows while the survivors keep stepping uninterrupted —
        the freed rows refill via continuous admission like any early
        exit. Batch bisection stays the fallback for the opaque path
        and for unattributed deterministic failures. False (default)
        keeps the whole-cohort behavior.
    transient_types / transient_markers: extra classification — any
        exception instance of a listed type, or whose repr contains a
        marker substring (case-insensitive), is treated as transient.
        `TransientExecutorError`/`WatchdogTimeout` always are.
    xla_classify: consult the `serve.cuda_errors` payload classifier
        when — and only when — the marker list has no opinion (the
        JAX package's knob name, which the scheduler and the fleet
        pass). Default-on but inert: every payload the legacy markers
        already decide keeps its exact legacy verdict; the classifier
        only adds verdicts on shapes the flat list never matched (CUDA
        OOM, illegal addresses, launch failures, the kernels' "CUDA
        error N", and the JAX classifier's XLA shapes). False restores
        the pure-marker classification.
    """

    max_attempts: int = 3
    backoff_base_s: float = 0.05
    backoff_max_s: float = 2.0
    jitter: float = 0.5
    seed: int = 0
    bisect: bool = True
    nan_poison_threshold: int = 1
    watchdog_s: Optional[float] = None
    breaker_threshold: int = 0
    breaker_cooldown_s: float = 5.0
    checkpoint_every: int = 0
    checkpoint_spill: str = ""
    row_isolation: bool = False
    transient_types: Tuple[type, ...] = ()
    transient_markers: Tuple[str, ...] = (
        "transient", "resource_exhausted", "deadline_exceeded",
        "unavailable", "connection reset")
    xla_classify: bool = True
    _rng: random.Random = field(init=False, repr=False, compare=False,
                                default=None)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0 \
                or self.jitter < 0:
            raise ValueError("backoff/jitter must be >= 0")
        if self.nan_poison_threshold < 1:
            raise ValueError("nan_poison_threshold must be >= 1")
        if self.watchdog_s is not None and self.watchdog_s <= 0:
            # catch the CLI convention "0 = off" leaking in here: a
            # 0-second deadline would fail EVERY batch instantly
            raise ValueError("watchdog_s must be > 0 (None disables)")
        if self.checkpoint_every < 0:
            raise ValueError("checkpoint_every must be >= 0 (0 disables)")
        if self.checkpoint_spill and self.checkpoint_every < 1:
            raise ValueError(
                "checkpoint_spill rides the checkpoint cadence: set "
                "checkpoint_every >= 1 (the spill directory alone "
                "never checkpoints anything)")
        self._rng = random.Random(self.seed)

    def is_transient(self, exc: BaseException) -> bool:
        if isinstance(exc, TransientExecutorError):
            return True
        if self.transient_types and isinstance(exc, self.transient_types):
            return True
        r = repr(exc).lower()
        if any(m.lower() in r for m in self.transient_markers):
            return True
        if self.xla_classify:
            # payload shapes the flat marker list never matched —
            # consulted last so legacy verdicts are untouched; no
            # opinion falls through to the legacy False
            from alphafold2_tpu_torch.serve.cuda_errors import classify
            verdict = classify(repr(exc))
            if verdict is not None:
                return verdict.transient
        return False

    def delay_s(self, attempts: int,
                rng: Optional[random.Random] = None) -> float:
        """Backoff before re-enqueueing a batch whose entries have
        executed `attempts` times. The default jitter stream assumes a
        single caller thread; when one policy object is shared across
        schedulers (fleet.InProcessFleet passes the same `retry` to
        every replica), each worker passes its OWN seeded `rng` so the
        draws stay deterministic per worker instead of racing on one
        stream."""
        base = min(self.backoff_base_s * (2.0 ** max(0, attempts - 1)),
                   self.backoff_max_s)
        if self.jitter:
            base *= 1.0 + self.jitter * (rng or self._rng).random()
        return base


class Quarantine:
    """Keyed poison set: quarantined fold keys fail fast forever.

    Keys are the same content-addressed `fold_key` digests the cache
    uses, so quarantine naturally covers coalesced followers and every
    future duplicate of a poison request — one bad input costs the
    isolation executions once, then O(1) rejections. `strike()` is the
    accumulating path (non-finite outputs count toward poisoning);
    `add()` quarantines unconditionally (a deterministic batch-of-one
    failure IS the proof).

    `path` makes the set durable: every quarantined key appends one
    JSONL line ({"key", "reason"}) and construction replays the file,
    so a RESTARTED replica fails known poison fast instead of re-paying
    the isolation executions — the bisection proof survives the
    process. Append-only by design (quarantine has no remove path);
    strikes are deliberately NOT persisted — a sub-threshold NaN count
    is suspicion, not proof, and suspicion resets with the process.
    File trouble of any kind degrades to an in-memory-only set: the
    failure domain must never take down serving over a disk error.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 path: Optional[str] = None):
        self._lock = threading.Lock()
        self._keys: dict = {}            # key -> reason
        self._strikes: dict = {}
        self._path = path
        self._m_quarantined = (registry or get_registry()).counter(
            "serve_poison_quarantined_total",
            "fold keys quarantined as poison inputs")
        self.loaded = 0                  # keys replayed from disk
        if path:
            try:
                with open(path) as fh:
                    for line in fh:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                            self._keys[rec["key"]] = rec.get(
                                "reason", "poison_input")
                        except Exception:
                            continue     # torn tail line: skip, keep rest
                self.loaded = len(self._keys)
            except OSError:
                pass                     # no file yet / unreadable: empty

    def _persist(self, key: str, reason: str):
        """Caller does NOT hold the lock (file I/O off the hot section);
        append-only JSONL, one fsync-free line per quarantined key —
        a torn tail line is skipped at load, losing at most the last
        quarantine, which the next failure re-proves."""
        if not self._path:
            return
        try:
            d = os.path.dirname(os.path.abspath(self._path))
            os.makedirs(d, exist_ok=True)
            with open(self._path, "a") as fh:
                fh.write(json.dumps({"key": key, "reason": reason})
                         + "\n")
        except OSError:
            pass

    def add(self, key: str, reason: str = "poison_input") -> bool:
        """Quarantine `key`; True when newly added."""
        with self._lock:
            if key in self._keys:
                return False
            self._keys[key] = reason
            self._strikes.pop(key, None)
        self._m_quarantined.inc()
        self._persist(key, reason)
        return True

    def strike(self, key: str, threshold: int,
               reason: str = "nonfinite_output") -> bool:
        """Count one poison signal against `key`; quarantines (and
        returns True) when the key reaches `threshold` strikes."""
        with self._lock:
            if key in self._keys:
                return True
            n = self._strikes.get(key, 0) + 1
            if n < threshold:
                self._strikes[key] = n
                return False
            self._keys[key] = reason
            self._strikes.pop(key, None)
        self._m_quarantined.inc()
        self._persist(key, reason)
        return True

    def reason(self, key: str) -> Optional[str]:
        with self._lock:
            return self._keys.get(key)

    def __contains__(self, key: str) -> bool:
        with self._lock:
            return key in self._keys

    def __len__(self) -> int:
        with self._lock:
            return len(self._keys)

    def snapshot(self) -> dict:
        with self._lock:
            return {"quarantined": len(self._keys),
                    "striked": len(self._strikes),
                    "loaded_from_disk": self.loaded,
                    "persisted": self._path is not None}


class CircuitBreaker:
    """closed -> open -> half-open -> {closed, open} batch-failure gate.

    Counts CONSECUTIVE transient/watchdog batch failures; at
    `failure_threshold` it opens (degraded mode: the scheduler fast-
    sheds novel submits and stops executing). After `cooldown_s` the
    next observation moves it to half-open, where exactly one probe
    batch may execute: success closes the breaker (full service),
    failure re-opens it for another cooldown. Deterministic failures
    and successful batches both count as proof of device health
    (`record_success`) — a poison input must not blow the breaker.

    Thread-safe; the execute-side methods are only ever called by the
    single scheduler worker, the submit-side by caller threads.
    """

    STATES = ("closed", "half_open", "open")

    def __init__(self, failure_threshold: int = 3, cooldown_s: float = 5.0,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None):
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.opens = 0
        self.closes = 0
        reg = registry or get_registry()
        self._m_state = reg.gauge(
            "serve_breaker_state",
            "scheduler circuit breaker: 0 closed, 1 half-open, 2 open")
        self._m_transitions = reg.counter(
            "serve_breaker_transitions_total",
            "breaker state transitions", ("to",))
        self._m_state.set(0)

    def _to(self, state: str):
        """Caller holds self._lock."""
        if state == self._state:
            return
        self._state = state
        self._m_state.set(self.STATES.index(state))
        self._m_transitions.inc(to=state)

    def _advance(self):
        """Caller holds self._lock: open + cooldown elapsed -> half-open."""
        if self._state == "open" \
                and self._clock() - self._opened_at >= self.cooldown_s:
            self._to("half_open")
            self._probe_inflight = False

    @property
    def state(self) -> str:
        with self._lock:
            self._advance()
            return self._state

    def allow_submit(self) -> bool:
        """False = degraded mode: fast-shed novel submits. Half-open
        admits submits — when the queue drained while open, the probe
        has to come from somewhere."""
        with self._lock:
            self._advance()
            return self._state != "open"

    def allow_execute(self) -> bool:
        """May the worker execute a batch right now? (No side effects —
        the probe slot is claimed separately via begin_probe, so a poll
        that finds nothing ready cannot leak the slot.)"""
        with self._lock:
            self._advance()
            if self._state == "closed":
                return True
            if self._state == "half_open":
                return not self._probe_inflight
            return False

    def begin_probe(self):
        """The worker committed to executing a batch while half-open."""
        with self._lock:
            if self._state == "half_open":
                self._probe_inflight = True

    def record_success(self):
        """Device proved healthy (batch completed, or failed
        deterministically — the device RAN it)."""
        with self._lock:
            self._failures = 0
            self._probe_inflight = False
            if self._state != "closed":
                self.closes += 1
                self._to("closed")

    def record_failure(self):
        """One transient/watchdog batch failure."""
        with self._lock:
            self._advance()
            self._probe_inflight = False
            if self._state == "half_open" or (
                    self._state == "closed"
                    and self._failures + 1 >= self.failure_threshold):
                self.opens += 1
                self._opened_at = self._clock()
                self._failures = 0
                self._to("open")
            elif self._state == "closed":
                self._failures += 1

    def snapshot(self) -> dict:
        with self._lock:
            self._advance()
            return {"state": self._state,
                    "consecutive_failures": self._failures,
                    "opens": self.opens, "closes": self.closes,
                    "failure_threshold": self.failure_threshold,
                    "cooldown_s": self.cooldown_s}
