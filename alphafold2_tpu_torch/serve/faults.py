"""Deterministic fault injection for the serving failure domain
(counterpart of `alphafold2_tpu/serve/faults.py`; poison rows are read
from the batch tensors on the host, and NaN-mode poison writes the
result tensor's rows on its own device).

A `FaultPlan` is the one chaos object every resilient component accepts
behind a no-op default (`FoldExecutor(faults=)`, `FoldCache(faults=)`,
`fleet.PeerCacheClient(faults=)`), so one seeded plan drives a whole
chaos run — `tools/serve_loadtest.py --chaos` and serve_smoke.sh
phase 5 — and tests/test_resilience.py replays the same failures the
resilience layer (serve/resilience.py) must absorb:

- executor exceptions: each `executor.run` raises
  `TransientExecutorError` with probability `exec_error_rate` (the
  retry path) — injected BEFORE the device call, so an injected fault
  never wastes real accelerator time. The hook is STEP-AWARE
 : the executor passes the ExecKey variant
  ("fold"/"init"/"step"/"init_rows") and, for step executions, the
  recycle index, so `step_fail_at={recycle: rate}` can hit a SPECIFIC
  recycle depth mid-loop deterministically (the carry-checkpointing
  resume path), and `snapshot()` tags injection counts by variant;
- latency spikes: probability `exec_latency_rate` of sleeping
  `exec_latency_s` inside `executor.run` (the watchdog path);
- featurize faults: `FeaturePool(faults=)` calls `on_featurize` before
  each featurize execution — probability `featurize_error_rate` of
  raising (the error must fan out to every coalesced waiter without
  wedging the pool) and `featurize_latency_rate` of sleeping
  `featurize_latency_s` (the feature-deadline path);
- poison inputs: sequences registered via `add_poison(seq)` are
  recognized IN THE ASSEMBLED BATCH by content (padded row prefix +
  mask length), so the fault follows the request through batching,
  retries, and bisection exactly like a real degenerate input. Mode
  "raise" fails the whole batch deterministically (`FaultInjected` —
  the bisection path); mode "nan" lets the batch run and overwrites
  the poison rows' coords with NaN (the output-validation path);
- peer transport failures: `on_peer_fetch` raises with probability
  `peer_error_rate` (the markdown/recovery path);
- corrupt cache bytes: `corrupt_cache_bytes` flips bytes of a disk
  entry with probability `corrupt_rate` before validation (the
  quarantine path).

Determinism: every injection site draws from its own `random.Random`
stream derived from (seed, site), so e.g. enabling peer faults does not
perturb the executor fault sequence. Sites called from one thread (the
scheduler worker drives the executor) replay exactly; multi-threaded
sites (peer fetches) are deterministic in aggregate counts per draw
sequence, not in which caller sees which fault.

Plans start DISARMED so warmup/compile traffic runs clean; call
`arm()` when the measured window starts. Injection counts are exposed
via `snapshot()` and the `serve_faults_injected_total{kind=...}`
counter, so a chaos report can prove the run actually hurt.
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry
from alphafold2_tpu_torch.serve.resilience import TransientExecutorError


def _host(x) -> np.ndarray:
    """A batch tensor (or array) as numpy on the host."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class FaultInjected(RuntimeError):
    """A deliberately injected DETERMINISTIC failure (poison input):
    never classified transient, so it exercises the bisection path.
    When the injection site can attribute the failure to specific
    batch rows it sets `.rows` (a list of batch row indices) — the
    scheduler's per-row poison isolation (RetryPolicy(row_isolation))
    reads it to retire exactly those rows; failures without row
    attribution fall back to whole-batch bisection."""

    rows = None


class FaultPlan:
    """Seeded chaos configuration threaded through serving components."""

    KINDS = ("exec_error", "exec_latency", "step_fail", "poison_raise",
             "poison_nan", "peer_error", "cache_corrupt",
             "featurize_error", "featurize_latency", "preempt_notice")

    def __init__(self, seed: int = 0,
                 exec_error_rate: float = 0.0,
                 exec_latency_rate: float = 0.0,
                 exec_latency_s: float = 0.0,
                 peer_error_rate: float = 0.0,
                 corrupt_rate: float = 0.0,
                 step_fail_at: Optional[dict] = None,
                 featurize_error_rate: float = 0.0,
                 featurize_latency_rate: float = 0.0,
                 featurize_latency_s: float = 0.0,
                 preempt_notice_rate: float = 0.0,
                 registry: Optional[MetricsRegistry] = None):
        self.step_fail_at = {int(k): float(v)
                             for k, v in (step_fail_at or {}).items()}
        for name, rate in (("exec_error_rate", exec_error_rate),
                           ("exec_latency_rate", exec_latency_rate),
                           ("peer_error_rate", peer_error_rate),
                           ("corrupt_rate", corrupt_rate),
                           ("featurize_error_rate", featurize_error_rate),
                           ("featurize_latency_rate",
                            featurize_latency_rate),
                           ("preempt_notice_rate", preempt_notice_rate),
                           *((f"step_fail_at[{k}]", v)
                             for k, v in self.step_fail_at.items())):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        self.seed = int(seed)
        self.exec_error_rate = float(exec_error_rate)
        self.exec_latency_rate = float(exec_latency_rate)
        self.exec_latency_s = float(exec_latency_s)
        self.peer_error_rate = float(peer_error_rate)
        self.corrupt_rate = float(corrupt_rate)
        self.featurize_error_rate = float(featurize_error_rate)
        self.featurize_latency_rate = float(featurize_latency_rate)
        self.featurize_latency_s = float(featurize_latency_s)
        self.preempt_notice_rate = float(preempt_notice_rate)
        self._lock = threading.Lock()
        self._armed = False
        # one independent stream per site, seeded from (seed, site) so
        # sites never perturb each other's sequences
        self._rngs = {site: random.Random(f"{self.seed}:{site}")
                      for site in ("exec", "latency", "peer", "corrupt",
                                   "step", "featurize",
                                   "featurize_lat", "preempt")}
        self._poison: List[dict] = []    # {"seq": np1d, "mode": str}
        self.injected = {k: 0 for k in self.KINDS}
        # (kind, ExecKey variant) -> count: which executable the fault
        # actually hit — a mid-loop "step" injection and a formation
        # "init" injection recover through different machinery, and
        # the chaos report must be able to tell them apart
        self.injected_by_variant: dict = {}
        self._m_injected = (registry or get_registry()).counter(
            "serve_faults_injected_total",
            "chaos-harness injections by kind", ("kind",))

    # -- lifecycle -------------------------------------------------------

    @property
    def armed(self) -> bool:
        with self._lock:
            return self._armed

    def arm(self) -> "FaultPlan":
        """Start injecting (after warmup, when the window begins)."""
        with self._lock:
            self._armed = True
        return self

    def disarm(self) -> "FaultPlan":
        with self._lock:
            self._armed = False
        return self

    def add_poison(self, seq, mode: str = "raise") -> "FaultPlan":
        """Register a poison sequence. mode="raise": any batch holding
        it fails deterministically (bisection corners it); mode="nan":
        its output rows come back non-finite (validation catches it)."""
        if mode not in ("raise", "nan"):
            raise ValueError(f"poison mode must be raise|nan, got {mode!r}")
        seq = np.asarray(seq, dtype=np.int32).reshape(-1)
        if seq.size == 0:
            raise ValueError("poison seq must be non-empty")
        with self._lock:
            self._poison.append({"seq": seq, "mode": mode})
        return self

    # -- internals -------------------------------------------------------

    def _hit(self, site: str, rate: float) -> bool:
        if rate <= 0.0:
            return False
        with self._lock:
            if not self._armed:
                return False
            return self._rngs[site].random() < rate

    def _count(self, kind: str, n: int = 1,
               variant: Optional[str] = None):
        with self._lock:
            self.injected[kind] += n
            if variant is not None:
                per = self.injected_by_variant.setdefault(variant, {})
                per[kind] = per.get(kind, 0) + n
        self._m_injected.inc(n, kind=kind)

    def _poison_rows(self, batch: dict, mode: str) -> List[int]:
        """Batch rows whose REAL content equals a registered poison
        sequence (content-addressed, so the fault follows the request
        through retries and bisection)."""
        with self._lock:
            if not self._armed or not self._poison:
                return []
            poisons = [p for p in self._poison if p["mode"] == mode]
        if not poisons:
            return []
        seqs, mask = _host(batch["seq"]), _host(batch["mask"])
        rows = []
        for i in range(seqs.shape[0]):
            n = int(mask[i].sum())
            if n == 0:
                continue                 # batch-fill row, never poison
            for p in poisons:
                pseq = p["seq"]
                if n == pseq.shape[0] \
                        and np.array_equal(seqs[i, :n], pseq):
                    rows.append(i)
                    break
        return rows

    # -- injection sites -------------------------------------------------

    def on_executor_run(self, batch: dict, variant: str = "fold",
                        recycle: Optional[int] = None):
        """Called by FoldExecutor before the device call. May sleep
        (latency spike) or raise (poison / transient fault). `variant`
        is the ExecKey variant actually executing ("fold", "init",
        "step", "init_rows" — step-mode executors pass it; legacy
        callers default to "fold") and `recycle` the step's iteration
        index, so `step_fail_at={recycle: rate}` can inject a
        transient fault at a SPECIFIC recycle depth mid-loop
        and snapshot() tags counts by variant."""
        rows = self._poison_rows(batch, "raise")
        if rows:
            self._count("poison_raise", variant=variant)
            exc = FaultInjected(
                f"poison_input: injected deterministic failure for "
                f"batch rows {rows} in {variant!r}")
            # content-addressed chaos KNOWS the rows: attribute them so
            # per-row poison isolation can retire exactly the offenders
            exc.rows = list(rows)
            raise exc
        if self.step_fail_at and variant == "step" \
                and recycle is not None \
                and self._hit("step",
                              self.step_fail_at.get(int(recycle), 0.0)):
            self._count("step_fail", variant=variant)
            raise TransientExecutorError(
                f"injected mid-loop transient fault at recycle "
                f"{recycle}")
        if self._hit("latency", self.exec_latency_rate):
            self._count("exec_latency", variant=variant)
            time.sleep(self.exec_latency_s)
        if self._hit("exec", self.exec_error_rate):
            self._count("exec_error", variant=variant)
            raise TransientExecutorError(
                "injected transient executor fault")

    def on_featurize(self, key: Optional[str] = None):
        """Called by FeaturePool workers before each featurize
        execution (the CPU stage's chaos coverage). May sleep
        (featurize latency spike — the feature-deadline path) or raise
        (featurize failure — the pool must fan it out to every coalesced
        waiter without wedging)."""
        if self._hit("featurize_lat", self.featurize_latency_rate):
            self._count("featurize_latency")
            time.sleep(self.featurize_latency_s)
        if self._hit("featurize", self.featurize_error_rate):
            self._count("featurize_error")
            raise FaultInjected(
                f"injected featurize failure"
                + (f" for key {key[:16]}..." if key else ""))

    def mutate_result(self, batch: dict, result):
        """Called by FoldExecutor.run after the device call: NaN-mode
        poison rows get non-finite coords (the result object must
        support `._replace`, i.e. a NamedTuple like FoldResult)."""
        rows = self._poison_rows(batch, "nan")
        if not rows:
            return result
        self._count("poison_nan", len(rows))
        coords = result.coords
        if isinstance(coords, torch.Tensor):
            coords = coords.detach().clone()
            coords[torch.as_tensor(rows, device=coords.device)] = \
                float("nan")
        else:
            coords = np.array(coords, np.float32, copy=True)
            coords[rows] = np.nan
        return result._replace(coords=coords)

    def on_peer_fetch(self, peer_id: str):
        """Called by PeerCacheClient before the HTTP fetch; raising
        counts as a transport failure (feeds peer markdown)."""
        if self._hit("peer", self.peer_error_rate):
            self._count("peer_error")
            raise FaultInjected(
                f"injected peer transport failure to {peer_id}")

    def on_preempt_poll(self, replica_id: str = "") -> bool:
        """Preemption-notice site: called from a
        `serve.preemption` notice source's poll round; True = a
        synthetic spot reclaim fires for this replica NOW (the caller
        builds the PreemptionNotice — this site only rolls the seeded
        dice, exactly like every other site). The draw comes from its
        own stream, so arming preemption chaos never perturbs the
        executor/peer fault sequences."""
        if not self._hit("preempt", self.preempt_notice_rate):
            return False
        self._count("preempt_notice")
        return True

    def corrupt_cache_bytes(self, key: str, data: bytes) -> bytes:
        """Called by FoldCache on disk reads before validation."""
        if not self._hit("corrupt", self.corrupt_rate):
            return data
        self._count("cache_corrupt")
        flipped = bytearray(data)
        for i in range(0, len(flipped), 97):
            flipped[i] ^= 0xFF
        return bytes(flipped)

    # -- views -----------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            return {"armed": self._armed, "seed": self.seed,
                    "rates": {"exec_error": self.exec_error_rate,
                              "exec_latency": self.exec_latency_rate,
                              "peer_error": self.peer_error_rate,
                              "corrupt": self.corrupt_rate,
                              "featurize_error":
                                  self.featurize_error_rate,
                              "featurize_latency":
                                  self.featurize_latency_rate,
                              "preempt_notice":
                                  self.preempt_notice_rate},
                    "step_fail_at": dict(self.step_fail_at),
                    "poison_registered": len(self._poison),
                    "injected": dict(self.injected),
                    "injected_by_variant": {
                        v: dict(per) for v, per in
                        sorted(self.injected_by_variant.items())}}
