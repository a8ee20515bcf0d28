"""Control-plane actuation: the fleet runs itself.

The serving stack gives the fleet a complete signal surface — per-replica `/metrics`
expositions, `/admin/stats` with windowed SLO burn rates, stitched
cross-replica traces. Every actuation, though, was still an operator
verb: spawn, drain, rollout, warm. `FleetController` closes the loop
with one reconcile cycle, run on a timer against any actuator that
duck-types the fleet verbs (`ProcFleet` does):

    observe   poll every endpoint's /healthz, /admin/stats, /metrics
    decide    fleet/scaling.py pure functions over the polled signals
    actuate   spawn / SIGTERM-drain replicas, POST /admin/resize,
              POST /admin/peers membership fan-out, /admin/rollout
              convergence, owner-routed cache warming

Per cycle, in order:

1. ENDPOINT WATCH — each endpoint the actuator lists is probed at
   /healthz; a running replica is registered (join) or heartbeated in
   the controller's own `ReplicaRegistry`; an endpoint that vanished is
   unregistered (leave). Both bump the membership epoch.
2. TTL SWEEP — `registry.sweep()` auto-downs wedged-but-listening
   members (fresh TCP accept, stale heartbeat) with an epoch bump, so
   rings rebuild around them (the registry satellite).
   With `orphan_store=` set, a dead replica — preemption
   notice seen on /healthz, endpoint gone, or TTL-swept — has its
   orphan manifest read from the shared checkpoint backend and its
   folds actively assigned to the least-loaded survivor via
   `POST /admin/adopt`, so adoption latency is reconcile-tick-bounded.
3. MEMBERSHIP FAN-OUT — joins/leaves/health flips are announced to
   every healthy replica's `POST /admin/peers`, so the DATA plane's
   per-replica registries (and therefore their consistent-hash rings)
   track runtime membership — a replica spawned mid-run starts
   receiving forwards; a swept one stops.
4. SIGNAL POLL — /admin/stats + /metrics per healthy member. The two
   must agree on identity (replica_id + incarnation boot nonce,
   mirrored between the stats "identity" block and the
   `fleet_replica_identity` series): a restarted replica's stale
   scrape is DISCARDED (neutral signals, `controller_stale_scrapes_
   total`), never acted on.
5. SCALE DECISION — `decide_scale` maps max latency burn rate, mean
   executor idle fraction, and featurize queue pressure to one of
   hold / scale_up / scale_down with hysteresis + cooldown + min/max
   bounds; scale-down drains the least-loaded replica (SIGTERM — the
   drain contract), never below quorum; a fleet observed below
   `min_replicas` is restored immediately (cooldown does not apply to
   outages).
6. FEATURE-POOL RESIZE — `decide_feature_workers` per replica, actuated
   through the new `POST /admin/resize` (in-place executor swap).
7. ROLLOUT CONVERGENCE — after `controller.rollout(tag)` (fan-out with
   per-replica retry/backoff), every cycle re-rolls stragglers and
   late joiners until the whole healthy fleet reports the tag — a
   replica spawned mid-rollout converges too.
8. TELEMETRY-DRIVEN WARMING — tails the replicas' served-key frequency
   JSONL (`Scheduler(key_log=)`) and submits the traffic head as
   low-priority folds; the data plane's own ring routing concentrates
   each key on its owner, so the warm lands exactly where forwards and
   peer fetches will look (the cache_warm contract, fed by live
   traffic instead of an offline Zipf profile).

Every cycle appends one structured record to a decisions JSONL
(`controller.decisions.jsonl`) — `tools/obs_fleet.py` renders it so a
run artifact explains WHY the fleet scaled — and runs under a
`reconcile` trace span on an origin-tagged tracer, so control-plane
latency sits in the same waterfall as the requests it shepherds.
`controller_*` counters/gauges ride the caller's registry.

Off by default everywhere: nothing constructs a controller unless
asked (`ProcFleet(controller=...)`), and a controller-less fleet is
byte-identical to one without the control plane.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Dict, List, Optional
from urllib import request as urlrequest

from alphafold2_tpu_torch.fleet.registry import ReplicaRegistry
from alphafold2_tpu_torch.fleet.scaling import (SCALE_DOWN, SCALE_UP,
                                                ReplicaSignals, ScalingPolicy,
                                                decide_feature_workers,
                                                decide_scale)
from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry

# -- plumbing -------------------------------------------------------------


def http_get_json(url: str, timeout_s: float = 2.0) -> Optional[dict]:
    try:
        with urlrequest.urlopen(url, timeout=timeout_s) as resp:
            if resp.status != 200:
                return None
            return json.loads(resp.read().decode("utf-8"))
    except Exception:
        return None


def http_get_text(url: str, timeout_s: float = 2.0) -> Optional[str]:
    try:
        with urlrequest.urlopen(url, timeout=timeout_s) as resp:
            if resp.status != 200:
                return None
            return resp.read().decode("utf-8")
    except Exception:
        return None


def http_post_json(url: str, payload: dict,
                   timeout_s: float = 2.0) -> Optional[dict]:
    req = urlrequest.Request(
        url, data=json.dumps(payload).encode("utf-8"),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urlrequest.urlopen(req, timeout=timeout_s) as resp:
            return json.loads(resp.read().decode("utf-8"))
    except Exception:
        return None


def http_probe_json(url: str, timeout_s: float = 2.0):
    """(status, body-dict) even for error statuses — a preempting
    replica answers /healthz with a 503 whose BODY carries the state
   , and the plain getter above would collapse that to
    None. (None, None) on transport failure."""
    try:
        with urlrequest.urlopen(url, timeout=timeout_s) as resp:
            return resp.status, json.loads(resp.read().decode("utf-8"))
    except Exception as exc:
        code = getattr(exc, "code", None)
        if code is None:
            return None, None
        try:
            return code, json.loads(exc.read().decode("utf-8"))
        except Exception:
            return code, None


_SERIES_RE = re.compile(
    r"^fleet_replica_identity\{([^}]*)\}\s+([0-9eE.+-]+)\s*$",
    re.MULTILINE)
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


def parse_identity(metrics_text: str) -> Optional[dict]:
    """The CURRENT identity a /metrics exposition claims: the single
    fleet_replica_identity series at value 1. None when the exposition
    carries no current identity (or an ambiguous one — more than one
    series at 1 is treated as no identity, which a polling controller
    must read as 'do not act')."""
    current = [dict(_LABEL_RE.findall(labels))
               for labels, value in _SERIES_RE.findall(metrics_text)
               if float(value) == 1.0]
    return current[0] if len(current) == 1 else None


def content_digest(seq, msa=None) -> Optional[str]:
    """Stable digest of a (seq, msa) token payload — the controller's
    dedup key for warm submissions (same construction as
    serve.metrics.KeyFrequencyLog's aggregation key)."""
    import hashlib

    import numpy as np

    try:
        h = hashlib.blake2b(digest_size=16)
        h.update(np.asarray(seq).astype(np.int64, copy=False).tobytes())
        if msa is not None:
            h.update(b"|msa|")
            h.update(np.asarray(msa).astype(np.int64,
                                            copy=False).tobytes())
        return h.hexdigest()
    except Exception:
        return None


def merge_key_profiles(paths) -> List[dict]:
    """Merge served-key frequency JSONL files (KeyFrequencyLog format)
    into one profile, hottest first. Duplicate keys across replicas
    (each ingress counts its own arrivals) SUM — fleet-wide frequency
    is what warming should rank by. Unreadable/torn lines skip."""
    merged: Dict[str, dict] = {}
    for path in paths:
        try:
            with open(path) as fh:
                lines = fh.readlines()
        except OSError:
            continue
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue                   # torn tail mid-rewrite
            digest = content_digest(rec.get("seq"), rec.get("msa"))
            if digest is None:
                continue
            ent = merged.get(digest)
            if ent is None:
                merged[digest] = {"digest": digest,
                                  "seq": rec["seq"],
                                  "msa": rec.get("msa"),
                                  "count": int(rec.get("count", 1))}
            else:
                ent["count"] += int(rec.get("count", 1))
    return sorted(merged.values(), key=lambda r: -r["count"])


# -- the controller -------------------------------------------------------

def terminal_fold_keys(ledger_paths=(), quarantine_paths=()):
    """Fold keys with a TERMINAL record — the sweep set for
    `CheckpointStore.sweep_orphans`.

    ledger_paths: bulk-campaign ledgers (tools/bulk_submit.py JSONL);
        a record contributes when it carries a `fold_key` AND its
        status is done-forever ("ok"/"poisoned"/"too_large" — the
        campaign ledger's DONE set; retryable statuses keep their
        checkpoints, a resumed campaign wants them).
    quarantine_paths: Quarantine persistence JSONL ({"key", "reason"});
        every quarantined key is terminal by definition — its
        checkpoint would only resume into another poisoning.

    Unreadable files and torn lines are skipped: GC is best-effort and
    must never take down the reconcile loop over a disk error.
    """
    done = ("ok", "poisoned", "too_large")
    keys = set()
    for path in ledger_paths:
        try:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    fk = rec.get("fold_key")
                    if fk and str(rec.get("status")) in done:
                        keys.add(str(fk))
        except OSError:
            continue
    for path in quarantine_paths:
        try:
            with open(path) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        continue
                    if rec.get("key"):
                        keys.add(str(rec["key"]))
        except OSError:
            continue
    return keys


class CheckpointGC:
    """Reconcile-wired checkpoint GC: rate-limited
    `sweep_orphans` over the terminal fold keys the campaign ledgers
    and quarantine files record. TTL already bounds checkpoint
    lifetime; this reclaims the disk EARLY for folds that provably
    finished for good — a proteome campaign's served checkpoints must
    not sit out their TTL on every replica's spill volume.

    store: `cache.CheckpointStore` (anything with sweep_orphans).
    ledger_paths / quarantine_paths: JSONL sources (static paths or a
        zero-arg callable returning paths, for actuators whose
        replica set moves).
    interval_s: minimum seconds between sweeps — the reconcile loop
        runs ~1/s and re-reading ledgers that often buys nothing.
    """

    def __init__(self, store, ledger_paths=(), quarantine_paths=(),
                 interval_s: float = 60.0, clock=time.monotonic):
        if store is None or not hasattr(store, "sweep_orphans"):
            raise ValueError(
                "CheckpointGC.store must expose sweep_orphans()")
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        self.store = store
        self.ledger_paths = ledger_paths
        self.quarantine_paths = quarantine_paths
        self.interval_s = float(interval_s)
        self._clock = clock
        self._last: Optional[float] = None
        self.sweeps = 0
        self.swept_groups = 0

    def _paths(self, spec):
        return list(spec() if callable(spec) else spec)

    def run(self, now: Optional[float] = None) -> int:
        """One rate-limited sweep; returns groups swept (0 when the
        interval has not elapsed)."""
        now = self._clock() if now is None else now
        if self._last is not None and now - self._last < self.interval_s:
            return 0
        self._last = now
        keys = terminal_fold_keys(self._paths(self.ledger_paths),
                                  self._paths(self.quarantine_paths))
        if not keys:
            return 0
        swept = int(self.store.sweep_orphans(sorted(keys)))
        self.sweeps += 1
        self.swept_groups += swept
        return swept


class FleetController:
    """One reconcile loop over an actuator exposing the fleet verbs.

    fleet: the actuator. Required surface:
        endpoints() -> {replica_id: frontdoor_base_url}   (live procs)
        scale_up() -> Optional[replica_id]                (spawn)
        scale_down(replica_id) -> bool                    (async drain)
      Optional surface:
        peer_rows() -> [{replica_id, host, frontdoor_port, peer_port}]
            enables data-plane membership fan-out (/admin/peers)
        key_log_paths() -> {replica_id: keys.jsonl path}
            enables telemetry-driven warming (with warm=True)
    policy: fleet/scaling.py knobs (default ScalingPolicy()).
    heartbeat_timeout_s: the registry TTL behind sweep auto-down. Keep
        it a small multiple of interval_s — each cycle's successful
        /healthz probe IS the heartbeat.
    decisions_path: structured JSONL, one record per reconcile (and
        one per rollout verb); obs_fleet renders it. None = no log.
    decision_log_max_bytes / decision_log_max_age_s: decision-log
        retention. Off by default (0 / None — unbounded,
        the old behavior). When set, the JSONL rotates in place
        keeping the newest records under the byte bound and dropping
        records older than the age bound; the in-memory mirror trims
        by the same age. `tools/obs_fleet.py --since` narrows reads
        the same way.
    tracer: optional obs.Tracer — each cycle runs under a `reconcile`
        span so control-plane latency sits in the fleet waterfall.
    warm / warm_top_k / warm_min_count / warm_max_inflight: telemetry-
        driven warming of the served-traffic head (needs the actuator's
        key_log_paths and replicas running `Scheduler(key_log=)`).
        Warm folds ride `qos="bulk"`: on replicas with a
        BulkPolicy they park in the bulk queue and are admitted only
        through freed batch rows, so warming NEVER competes with
        online traffic; bulk-less replicas serve them on the online
        queue at priority -1, the old behavior.
    checkpoint_gc: optional `CheckpointGC` — each reconcile runs one
        rate-limited `CheckpointStore.sweep_orphans` pass over the
        fold keys the campaign ledgers / quarantine files record as
        terminal. None (default) = no GC, byte-identical
        reconcile records.
    orphan_store: optional shared `ObjectStoreBackend` (the one the
        replicas' CheckpointStores mirror into) — enables orphan
        adoption: dead replicas' manifests are read from
        it and assigned to survivors. None (default) = no adoption,
        byte-identical records and metric-name set.
    resize: feature-pool resize actuation on/off.
    boot_grace_s: how long a spawned-but-not-yet-joined endpoint
        counts as PENDING toward quorum and the max bound. A replica
        whose boot spans many reconcile intervals (executor warm-up)
        must not be re-spawned every cycle while it comes up; one
        whose boot hangs past the grace stops counting, so quorum
        restore can try again.
    clock: injectable monotonic clock (tests drive cooldowns without
        sleeping).
    """

    def __init__(self, fleet, policy: Optional[ScalingPolicy] = None,
                 interval_s: float = 1.0,
                 heartbeat_timeout_s: float = 5.0,
                 probe_timeout_s: float = 2.0,
                 decisions_path: Optional[str] = None,
                 tracer=None,
                 registry: Optional[MetricsRegistry] = None,
                 warm: bool = False, warm_top_k: int = 4,
                 warm_min_count: int = 2, warm_max_inflight: int = 4,
                 resize: bool = True,
                 rollout_attempts: int = 5,
                 rollout_backoff_s: float = 0.2,
                 boot_grace_s: float = 180.0,
                 decision_log_max_bytes: int = 0,
                 decision_log_max_age_s: Optional[float] = None,
                 checkpoint_gc: Optional[CheckpointGC] = None,
                 orphan_store=None,
                 clock=time.monotonic):
        self.fleet = fleet
        self.policy = policy or ScalingPolicy()
        self.interval_s = float(interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.decisions_path = decisions_path
        self.tracer = tracer
        self.warm = bool(warm)
        self.warm_top_k = int(warm_top_k)
        self.warm_min_count = int(warm_min_count)
        self.warm_max_inflight = int(warm_max_inflight)
        self.resize = bool(resize)
        self.rollout_attempts = int(rollout_attempts)
        self.rollout_backoff_s = float(rollout_backoff_s)
        self.boot_grace_s = float(boot_grace_s)
        self.checkpoint_gc = checkpoint_gc
        # orphan adoption: the shared ObjectStoreBackend the
        # replicas spill checkpoints + orphan manifests into. None
        # (default) = no adoption, byte-identical reconcile records and
        # registry metric-name set.
        self.orphan_store = orphan_store
        # decision-log retention: a controller that runs
        # for weeks appends one JSONL record per reconcile — unbounded
        # by default (byte-identical to the unbounded log). When
        # either bound is set, _log rotates the file in place (newest
        # records kept under max_bytes/2 so rotation is amortized, and
        # records older than max_age_s dropped) and trims the
        # in-memory mirror by the same age cutoff.
        self.decision_log_max_bytes = int(decision_log_max_bytes)
        self.decision_log_max_age_s = (
            None if decision_log_max_age_s is None
            else float(decision_log_max_age_s))
        self._clock = clock
        reg = registry or get_registry()
        # the controller's OWN membership view — sweep() needs the TTL
        # armed; replicas keep their mark-driven registries
        self.registry = ReplicaRegistry(
            heartbeat_timeout_s=float(heartbeat_timeout_s),
            clock=clock, registry=reg)
        self._m_reconciles = reg.counter(
            "controller_reconciles_total", "reconcile cycles run")
        self._m_scale_ups = reg.counter(
            "controller_scale_ups_total", "replicas spawned by policy")
        self._m_scale_downs = reg.counter(
            "controller_scale_downs_total", "replicas drained by policy")
        self._m_resizes = reg.counter(
            "controller_resizes_total",
            "feature-pool resizes actuated via /admin/resize")
        self._m_warms = reg.counter(
            "controller_warm_submissions_total",
            "warm folds submitted from served-traffic telemetry")
        self._m_stale = reg.counter(
            "controller_stale_scrapes_total",
            "polls discarded on identity mismatch "
            "(stats vs metrics incarnation)")
        self._m_joins = reg.counter(
            "controller_membership_joins_total",
            "replicas joined via the endpoint watch")
        self._m_leaves = reg.counter(
            "controller_membership_leaves_total",
            "replicas unregistered (endpoint gone)")
        self._m_healthy = reg.gauge(
            "controller_replicas_observed",
            "healthy replicas the controller last observed")
        self._m_stragglers = reg.gauge(
            "controller_rollout_stragglers",
            "healthy replicas not yet on the rollout target tag")
        # adoption series exist only with the knob on (identity pin:
        # a controller without an orphan store mints no new names)
        self._m_adoptions = None
        self._m_adopt_latency = None
        if orphan_store is not None:
            self._m_adoptions = reg.counter(
                "fleet_orphan_adoptions_total",
                "orphaned folds assigned to survivors by the "
                "controller, by detection source", ("source",))
            self._m_adopt_latency = reg.histogram(
                "fleet_orphan_adoption_seconds",
                "manifest publish -> survivor adoption latency")
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._n = 0                       # reconcile counter
        self._last_action_s: Optional[float] = None
        self._last_health: Dict[str, dict] = {}
        self._last_poll: Dict[tuple, dict] = {}   # (rid, inc) -> sample
        self._pending_since: Dict[str, float] = {}  # rid -> first seen
        self._announced_up: set = set()   # rids the data plane knows up
        # adoption state: rids whose /healthz announced
        # preempting (first-seen stamp -> source="notice"), and rids
        # whose death still owes an adoption attempt
        self._preempting_seen: Dict[str, float] = {}
        self._pending_adoptions: set = set()
        self._rollout_tag: Optional[str] = None
        self._warmed: set = set()
        self._warm_tickets: list = []
        self._transports: Dict[str, object] = {}
        self.decisions: List[dict] = []   # in-memory mirror of the log

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "FleetController":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="fleet-controller", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None

    def _loop(self):
        while not self._stop.is_set():
            try:
                self.reconcile()
            except Exception as exc:      # the loop must never die
                self._log({"event": "reconcile_error",
                           "error": repr(exc)})
            self._stop.wait(self.interval_s)

    # -- the cycle ---------------------------------------------------------

    def reconcile(self) -> dict:
        """One observe-decide-actuate cycle; returns (and logs) its
        decision record. Safe to call inline (tests, one-shot CLIs)
        with the loop stopped."""
        self._n += 1
        self._m_reconciles.inc()
        trace = None
        if self.tracer is not None:
            trace = self.tracer.start_trace(f"reconcile-{self._n}")
            trace.begin("reconcile")
        try:
            record = self._reconcile_inner(trace)
        finally:
            if trace is not None:
                trace.end("reconcile")
                trace.finish("ok", source="controller")
        record["reconcile"] = self._n
        self._log(record)
        return record

    def _reconcile_inner(self, trace) -> dict:
        now = self._clock()
        endpoints = dict(self.fleet.endpoints())
        record: dict = {"event": "reconcile", "ts": time.time(),
                        "endpoints": sorted(endpoints)}

        # 1. endpoint watch: join / heartbeat / leave
        joined, health = [], {}
        known = set(self.registry.member_ids())
        for rid in sorted(endpoints):
            status, hz = http_probe_json(endpoints[rid] + "/healthz",
                                         self.probe_timeout_s)
            if hz is not None and hz.get("preempting"):
                # announced reclaim: the 503 body names the
                # state — remember WHEN, so the adoption that follows
                # this replica's death is source="notice" and the
                # manifest is read the tick it appears instead of
                # waiting out a TTL sweep
                self._preempting_seen.setdefault(rid, now)
                self._pending_adoptions.add(rid)
            if status != 200 or hz is None or not hz.get("running"):
                continue           # no heartbeat: the sweep judges it
            if rid not in known:
                self.registry.register(rid)
                self._m_joins.inc()
                joined.append(rid)
            self.registry.heartbeat(rid)   # revives auto-downed too
            health[rid] = hz
        left = sorted(known - set(endpoints))
        for rid in left:
            self.registry.unregister(rid)
            self._m_leaves.inc()
        self._last_health = health

        # pending = spawned endpoints that never joined (boot still in
        # flight). They hold further scaling: re-spawning every cycle
        # while one boot warms up is the runaway-restore failure mode.
        # A boot hung past the grace stops counting, so restore retries.
        known_now = set(self.registry.member_ids())
        for rid in list(self._pending_since):
            if rid in known_now or rid not in endpoints:
                del self._pending_since[rid]
        pending_ids = []
        for rid in sorted(set(endpoints) - known_now):
            first = self._pending_since.setdefault(rid, now)
            if now - first <= self.boot_grace_s:
                pending_ids.append(rid)

        # 2. TTL sweep: wedged-but-listening members go down WITH an
        # epoch bump — they stop owning keys, not just failing them
        swept = self.registry.sweep()

        # 2b. orphan adoption: a dead replica's manifest is
        # actively assigned to a least-loaded survivor THIS tick —
        # adoption latency is reconcile-bounded, never waiting on a
        # duplicate submit to stumble into a lazy peer probe
        adoptions: List[dict] = []
        if self.orphan_store is not None:
            self._pending_adoptions.update(left)
            self._pending_adoptions.update(swept)
            adoptions = self._adopt_orphans(endpoints, health)

        # 3. data-plane membership fan-out
        announced = self._announce_membership(endpoints, health)

        # 4. signal poll (identity-checked)
        signals, stale = self._poll_signals(endpoints, health)
        healthy_n = sum(1 for s in signals
                        if s.healthy and not s.draining)
        self._m_healthy.set(healthy_n)

        # 5. scale decision + actuation
        decision = decide_scale(self.policy, signals, now,
                                self._last_action_s,
                                pending=len(pending_ids))
        actions = []
        if decision.action == SCALE_UP:
            rid = None
            try:
                rid = self.fleet.scale_up()
            except Exception as exc:
                actions.append({"verb": "scale_up",
                                "error": repr(exc)})
            if rid is not None:
                self._m_scale_ups.inc()
                self._last_action_s = now
                actions.append({"verb": "scale_up", "replica": rid})
        elif decision.action == SCALE_DOWN:
            ok = False
            try:
                ok = bool(self.fleet.scale_down(decision.drain_target))
            except Exception as exc:
                actions.append({"verb": "scale_down",
                                "error": repr(exc)})
            if ok:
                self._m_scale_downs.inc()
                self._last_action_s = now
                actions.append({"verb": "scale_down",
                                "replica": decision.drain_target})

        # 6. feature-pool resize
        resized = self._actuate_resize(endpoints, signals) \
            if self.resize else {}

        # 7. rollout convergence: re-roll stragglers and late joiners
        stragglers = self._converge_rollout(endpoints, health)

        # 8. telemetry-driven warming
        warmed = self._warm_from_telemetry(endpoints, health) \
            if self.warm else 0

        # 9. checkpoint GC: reclaim spill disk for folds
        # the ledgers/quarantine prove finished for good
        gc_swept = 0
        if self.checkpoint_gc is not None:
            try:
                gc_swept = self.checkpoint_gc.run(now)
            except Exception as exc:
                # GC is best-effort; a disk error must not stop
                # scaling/rollout actuation
                record["checkpoint_gc_error"] = repr(exc)

        record.update({
            "joined": joined, "left": left, "swept": swept,
            "announced": announced,
            "healthy": healthy_n,
            "pending": pending_ids,
            "stale_scrapes": stale,
            "signals": [{"replica": s.replica_id,
                         "burn": round(s.burn_rate, 4),
                         "idle": round(s.idle_fraction, 4),
                         "queue": s.queue_depth,
                         "featurize_queue": s.featurize_queue_depth,
                         "draining": s.draining}
                        for s in signals],
            "decision": decision.to_dict(),
            "actions": actions,
            "resized": resized,
            "rollout_target": self._rollout_tag,
            "rollout_stragglers": stragglers,
            "warm_submissions": warmed,
        })
        if self.checkpoint_gc is not None:
            # only with the knob on: default reconcile records keep
            # their knob-off shape
            record["checkpoint_gc_swept"] = gc_swept
        if self.orphan_store is not None:
            # only with the knob on, same contract as checkpoint_gc
            record["orphan_adoptions"] = adoptions
        return record

    # -- orphan adoption ----------------------------------------

    def _adopt_orphans(self, endpoints, health) -> List[dict]:
        """Assign every pending dead replica's orphan manifest to a
        live survivor via POST /admin/adopt. A rid stays pending until
        its manifest is adopted (the manifest may publish a beat after
        the death is detected — the replica spends its grace window
        spilling first), or until the rid rejoins (a restart reclaims
        its own checkpoints through boot discovery)."""
        from alphafold2_tpu_torch.cache.checkpoints import (
            clear_manifest, read_manifest)
        out: List[dict] = []
        for rid in sorted(self._pending_adoptions):
            if rid in health:
                # back from the dead (restart): its own boot discovery
                # owns the checkpoints now
                self._pending_adoptions.discard(rid)
                self._preempting_seen.pop(rid, None)
                continue
            manifest = read_manifest(self.orphan_store, rid)
            if manifest is None:
                continue                # not published yet: retry
            orphans = manifest.get("orphans") or []
            source = ("notice" if rid in self._preempting_seen
                      else "sweep")
            if orphans:
                survivor = self._pick_survivor(endpoints, health, rid)
                if survivor is None:
                    continue            # no live member yet: retry
                resp = http_post_json(
                    endpoints[survivor] + "/admin/adopt",
                    {"replica_id": rid, "source": source,
                     "model_tag": manifest.get("model_tag", ""),
                     "published_s": manifest.get("published_s"),
                     "orphans": orphans},
                    self.probe_timeout_s)
                if resp is None:
                    continue            # survivor refused: retry
                adopted = int(resp.get("adopted", 0) or 0)
                if self._m_adoptions is not None and adopted:
                    self._m_adoptions.inc(adopted, source=source)
                if self._m_adopt_latency is not None:
                    try:
                        self._m_adopt_latency.observe(max(
                            0.0, time.time()
                            - float(manifest["published_s"])))
                    except (KeyError, TypeError, ValueError):
                        pass
                out.append({"replica": rid, "source": source,
                            "survivor": survivor,
                            "orphans": len(orphans),
                            "adopted": adopted})
            else:
                out.append({"replica": rid, "source": source,
                            "survivor": None, "orphans": 0,
                            "adopted": 0})
            clear_manifest(self.orphan_store, rid)
            self._pending_adoptions.discard(rid)
            self._preempting_seen.pop(rid, None)
        return out

    def _pick_survivor(self, endpoints, health,
                       dead_rid: str) -> Optional[str]:
        """Least-loaded live member to adopt onto: healthy in the
        controller's registry, responding, not draining/preempting —
        sorted by the health payload's queue depth (the same
        least-loaded notion scaling's drain-target pick uses), rid as
        the deterministic tiebreak."""
        candidates = []
        for rid in sorted(health):
            if rid == dead_rid or rid not in endpoints:
                continue
            hz = health[rid]
            if not self.registry.is_healthy(rid):
                continue
            if hz.get("draining") or hz.get("preempting"):
                continue
            candidates.append((int(hz.get("queue_depth", 0) or 0),
                               rid))
        if not candidates:
            return None
        return min(candidates)[1]

    # -- membership fan-out ------------------------------------------------

    def _peer_rows(self) -> Dict[str, dict]:
        rows = getattr(self.fleet, "peer_rows", None)
        if rows is None:
            return {}
        try:
            return {r["replica_id"]: r for r in rows()}
        except Exception:
            return {}

    def _announce_membership(self, endpoints, health) -> List[dict]:
        """Push membership deltas to every healthy replica's
        /admin/peers, so data-plane rings track runtime join/leave.
        Healthy-up set = members the controller's registry says are
        healthy right now; deltas vs the last announcement fan out as
        register+up / down verbs."""
        rows = self._peer_rows()
        if not rows:
            return []
        up_now = {rid for rid in self.registry.member_ids()
                  if self.registry.is_healthy(rid)}
        went_up = sorted(up_now - self._announced_up)
        went_down = sorted(self._announced_up - up_now)
        if not went_up and not went_down:
            return []
        out = []
        targets = [(rid, endpoints[rid]) for rid in sorted(health)
                   if rid in endpoints]
        for rid in went_up:
            row = rows.get(rid)
            if row is None:
                continue
            for target_rid, url in targets:
                if target_rid == rid:
                    continue
                resp = http_post_json(
                    url + "/admin/peers",
                    {"op": "register", "peer": row},
                    self.probe_timeout_s)
                if resp is not None:
                    http_post_json(url + "/admin/peers",
                                   {"op": "up",
                                    "peer": {"replica_id": rid}},
                                   self.probe_timeout_s)
            out.append({"op": "up", "replica": rid})
        for rid in went_down:
            for target_rid, url in targets:
                if target_rid == rid:
                    continue
                http_post_json(url + "/admin/peers",
                               {"op": "down",
                                "peer": {"replica_id": rid}},
                               self.probe_timeout_s)
            out.append({"op": "down", "replica": rid})
        self._announced_up = up_now
        return out

    # -- signal poll -------------------------------------------------------

    def _poll_signals(self, endpoints, health):
        """ReplicaSignals per healthy member. A replica whose stats and
        metrics disagree on identity (restart between the two reads, or
        a scrape of a different incarnation) contributes NEUTRAL
        signals — observed healthy, but never a reason to act."""
        signals, stale = [], 0
        for rid in sorted(health):
            url = endpoints.get(rid)
            hz = health[rid]
            s = ReplicaSignals(replica_id=rid,
                               healthy=self.registry.is_healthy(rid),
                               draining=bool(hz.get("draining")),
                               model_tag=str(hz.get("tag", "")),
                               idle_fraction=0.0)
            signals.append(s)
            if url is None or not s.healthy:
                continue
            stats = http_get_json(url + "/admin/stats",
                                  self.probe_timeout_s)
            mtext = http_get_text(url + "/metrics",
                                  self.probe_timeout_s)
            if stats is None:
                continue
            ident = stats.get("identity") or {}
            claimed = parse_identity(mtext) if mtext else None
            if (not ident or claimed is None
                    or ident.get("replica_id") != rid
                    or claimed.get("replica_id") != rid
                    or claimed.get("incarnation")
                    != ident.get("incarnation")):
                # stale scrape: a restarted replica's old incarnation
                # (or a torn poll across a restart) must never steer
                # scaling — neutral signals, counted, skipped
                stale += 1
                self._m_stale.inc()
                continue
            s.incarnation = str(ident.get("incarnation", ""))
            s.queue_depth = int(stats.get("queue_depth", 0) or 0)
            s.served = int(stats.get("served", 0) or 0)
            s.burn_rate = self._burn_from_stats(stats)
            s.idle_fraction = self._idle_fraction(
                rid, s.incarnation, stats)
            feat = stats.get("featurize") or {}
            s.featurize_queue_depth = int(feat.get("queue_depth", 0)
                                          or 0)
            s.featurize_workers = int(feat.get("workers", 1) or 1)
        return signals, stale

    @staticmethod
    def _burn_from_stats(stats: dict) -> float:
        """Max latency burn rate across the replica's SLO classes
        (0.0 when no SLO engine is attached — burn never fires)."""
        worst = 0.0
        classes = (stats.get("slo") or {}).get("classes") or {}
        for cls in classes.values():
            lat = cls.get("latency") or {}
            rate = lat.get("burn_rate")
            if rate is not None:
                try:
                    worst = max(worst, float(rate))
                except (TypeError, ValueError):
                    pass
        return worst

    def _idle_fraction(self, rid: str, incarnation: str,
                       stats: dict) -> float:
        """1 - (executor busy-seconds delta / wall delta) between this
        poll and the previous one OF THE SAME INCARNATION — a restart
        resets the busy counter, and differencing across it would
        read as instant idleness. First poll reads as busy (0.0):
        a replica must EARN a scale-down with an observed-idle window."""
        try:
            busy = float(stats.get("exec_busy_s", 0.0) or 0.0)
        except (TypeError, ValueError):
            return 0.0
        key = (rid, incarnation)
        now = self._clock()
        prev = self._last_poll.get(key)
        self._last_poll[key] = {"t": now, "busy": busy}
        if prev is None:
            return 0.0
        wall_dt = now - prev["t"]
        busy_dt = busy - prev["busy"]
        if wall_dt <= 0 or busy_dt < 0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - busy_dt / wall_dt))

    # -- resize ------------------------------------------------------------

    def _actuate_resize(self, endpoints, signals) -> Dict[str, int]:
        out = {}
        for s in signals:
            if not s.healthy or s.draining or not s.incarnation:
                continue       # unpolled/stale replicas are never resized
            url = endpoints.get(s.replica_id)
            if url is None:
                continue
            want = decide_feature_workers(self.policy, s)
            if want is None:
                continue
            resp = http_post_json(url + "/admin/resize",
                                  {"workers": want},
                                  self.probe_timeout_s)
            if resp is not None and "workers" in resp:
                self._m_resizes.inc()
                out[s.replica_id] = int(resp["workers"])
        return out

    # -- rollout -----------------------------------------------------------

    def rollout(self, tag: str) -> dict:
        """Fleet-wide rollout as ONE verb: fan out /admin/rollout to
        every endpoint with per-replica retry/backoff, then check
        convergence (every healthy replica's /healthz reports the tag).
        Non-converged replicas come back as `stragglers` — and stay a
        standing goal: every subsequent reconcile re-rolls stragglers
        and late joiners until the fleet converges (a replica spawned
        mid-rollout, or down during it, is rolled when it appears)."""
        tag = str(tag)
        with self._lock:
            self._rollout_tag = tag
        endpoints = dict(self.fleet.endpoints())
        epochs: Dict[str, Optional[int]] = {}
        for rid in sorted(endpoints):
            resp = None
            for attempt in range(self.rollout_attempts):
                resp = http_post_json(endpoints[rid] + "/admin/rollout",
                                      {"tag": tag},
                                      self.probe_timeout_s)
                if resp is not None:
                    break
                time.sleep(self.rollout_backoff_s * (2 ** attempt))
            epochs[rid] = None if resp is None else resp.get("epoch")
        stragglers = []
        for rid in sorted(endpoints):
            hz = http_get_json(endpoints[rid] + "/healthz",
                               self.probe_timeout_s)
            if hz is None or hz.get("tag") != tag:
                stragglers.append(rid)
        self._m_stragglers.set(len(stragglers))
        report = {"event": "rollout", "ts": time.time(), "tag": tag,
                  "epochs": epochs, "stragglers": stragglers,
                  "converged": not stragglers}
        self._log(report)
        return report

    def _converge_rollout(self, endpoints, health) -> List[str]:
        with self._lock:
            tag = self._rollout_tag
        if tag is None:
            return []
        stragglers = [rid for rid in sorted(health)
                      if health[rid].get("tag") != tag]
        for rid in stragglers:
            url = endpoints.get(rid)
            if url is not None:
                http_post_json(url + "/admin/rollout", {"tag": tag},
                               self.probe_timeout_s)
        self._m_stragglers.set(len(stragglers))
        return stragglers

    # -- warming -----------------------------------------------------------

    def _warm_from_telemetry(self, endpoints, health) -> int:
        """Submit the served-traffic head as low-priority folds. Any
        healthy front door works as the entry point: the data plane's
        own consistent-hash forwarding lands each key on its ring
        owner, which is exactly where future forwards and peer-cache
        fetches will look (the cache_warm --fleet contract, driven by
        live telemetry)."""
        paths_fn = getattr(self.fleet, "key_log_paths", None)
        if paths_fn is None or not health:
            return 0
        self._warm_tickets = [t for t in self._warm_tickets
                              if not t.done()]
        budget = self.warm_max_inflight - len(self._warm_tickets)
        if budget <= 0:
            return 0
        try:
            profile = merge_key_profiles(paths_fn().values())
        except Exception:
            return 0
        entry_rid = sorted(health)[0]
        url = endpoints.get(entry_rid)
        if url is None:
            return 0
        transport = self._transport(url)
        submitted = 0
        for rec in profile[:self.warm_top_k]:
            if submitted >= budget:
                break
            if rec["count"] < self.warm_min_count:
                continue
            if rec["digest"] in self._warmed:
                continue
            try:
                import numpy as np

                from alphafold2_tpu_torch.serve.request import FoldRequest
                req = FoldRequest(
                    seq=np.asarray(rec["seq"], np.int32),
                    msa=(None if rec.get("msa") is None
                         else np.asarray(rec["msa"], np.int32)),
                    request_id=f"warm-{rec['digest'][:12]}",
                    priority=-1,       # traffic always outranks warming
                    # bulk tier: on a BulkPolicy replica a
                    # warm fold is admitted only through freed rows;
                    # without one it rides online at priority -1 as
                    # before — either way warming never preempts
                    qos="bulk")
                ticket = transport.submit(req)
            except Exception:
                continue               # warm is best-effort by definition
            self._warmed.add(rec["digest"])
            self._warm_tickets.append(ticket)
            self._m_warms.inc()
            submitted += 1
        return submitted

    def _transport(self, url: str):
        t = self._transports.get(url)
        if t is None:
            from alphafold2_tpu_torch.fleet.rpc import HttpTransport
            t = HttpTransport(url, poll_budget_s=120.0)
            self._transports[url] = t
        return t

    # -- decision log ------------------------------------------------------

    def _log(self, record: dict):
        record.setdefault("ts", time.time())
        with self._lock:
            self.decisions.append(record)
            if self.decision_log_max_age_s is not None:
                # trim the in-memory mirror by the same age contract
                # as the file — snapshot() math stays over the
                # retained window, not the process lifetime
                cutoff = record["ts"] - self.decision_log_max_age_s
                while self.decisions and \
                        float(self.decisions[0].get("ts", 0)) < cutoff:
                    self.decisions.pop(0)
        if not self.decisions_path:
            return
        try:
            d = os.path.dirname(os.path.abspath(self.decisions_path))
            os.makedirs(d, exist_ok=True)
            with open(self.decisions_path, "a") as fh:
                fh.write(json.dumps(record, default=str) + "\n")
            self._maybe_rotate_log(float(record["ts"]))
        except OSError:
            pass               # the log must never break the loop

    def _maybe_rotate_log(self, now_ts: float):
        """Retention for the decision JSONL: when the file outgrows
        `decision_log_max_bytes` (or, age-only configs, once per
        max_age_s/4), rewrite it atomically keeping the NEWEST records
        — age cutoff first, then newest-first bytes down to half the
        byte bound so a rotation buys headroom instead of running
        every append. Torn lines are dropped (the rewrite is also the
        repair). OSError propagates to _log's swallow."""
        max_b = self.decision_log_max_bytes
        max_age = self.decision_log_max_age_s
        if max_b <= 0 and max_age is None:
            return
        path = self.decisions_path
        due = False
        if max_b > 0 and os.path.getsize(path) > max_b:
            due = True
        if not due and max_age is not None:
            last = getattr(self, "_last_age_rotate", 0.0)
            if now_ts - last >= max_age / 4.0:
                self._last_age_rotate = now_ts
                due = True
        if not due:
            return
        with open(path) as fh:
            lines = fh.readlines()
        kept = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if max_age is not None and \
                    float(rec.get("ts", 0)) < now_ts - max_age:
                continue
            kept.append(line + "\n")
        if max_b > 0:
            budget, tail = max_b // 2, []
            for line in reversed(kept):
                budget -= len(line)
                if budget < 0 and tail:
                    break
                tail.append(line)
            kept = list(reversed(tail))
        tmp = path + ".rotate"
        with open(tmp, "w") as fh:
            fh.writelines(kept)
        os.replace(tmp, path)

    # -- views -------------------------------------------------------------

    def snapshot(self) -> dict:
        with self._lock:
            decisions = list(self.decisions)
        actions = [a for d in decisions
                   for a in d.get("actions", [])]
        out = {
            "reconciles": self._n,
            "registry": self.registry.snapshot(),
            "scale_ups": sum(1 for a in actions
                             if a.get("verb") == "scale_up"
                             and "replica" in a),
            "scale_downs": sum(1 for a in actions
                               if a.get("verb") == "scale_down"
                               and "replica" in a),
            "rollout_target": self._rollout_tag,
            "warmed": len(self._warmed),
            "decisions": len(decisions),
        }
        if self.orphan_store is not None:
            # adoption summary — key exists only with the
            # knob on, same identity contract as the metric series
            ads = [a for d in decisions
                   for a in d.get("orphan_adoptions", ())]
            by_source: Dict[str, int] = {}
            for a in ads:
                src = str(a.get("source", "?"))
                by_source[src] = (by_source.get(src, 0)
                                  + int(a.get("adopted", 0) or 0))
            out["orphan_adoptions"] = {
                "events": len(ads),
                "adopted": sum(int(a.get("adopted", 0) or 0)
                               for a in ads),
                "by_source": by_source}
        return out
