"""Fleet membership + weight-rollout state.

Two kinds of epoch live here, deliberately separate:

- the MEMBERSHIP epoch (`ReplicaRegistry.epoch`) bumps whenever the set
  of replicas or their health marks change, so consistent-hash routers
  know to rebuild their ring — a router never scans the registry on the
  submit hot path, it compares one integer;
- the MODEL epoch (`RolloutState.epoch`) bumps on weight rollout
  (`bump(new_tag)`), atomically retagging every component that keys or
  serves cached folds. Cache keys already namespace by `model_tag`
  (cache/keys.py), so a bump makes every pre-rollout entry unreachable
  by construction; the peer protocol additionally REJECTS cross-tag
  fetches (HTTP 409) so a replica that has not rolled yet can never be
  served a stale fold by one that has, or vice versa — HelixFold's
  operational rule that the model version namespaces everything cached.

Health is mark-driven plus optional heartbeat staleness: a replica is
healthy iff it is marked up AND (when `heartbeat_timeout_s` is set) its
last heartbeat is fresh. Mark changes bump the membership epoch;
heartbeat staleness does not (routers skip unhealthy members at lookup
time, so the ring itself need not rebuild).

`sweep()` turns staleness into a real down-mark: a member
whose heartbeat aged past `heartbeat_timeout_s` is auto-marked down
with the membership epoch bumped, so rings REBUILD around it instead
of merely skipping it at lookup time — a wedged-but-listening replica
(process alive, event loop stuck) stops owning keys entirely. Auto-
downed members are distinct from administratively downed ones: a fresh
`heartbeat()` revives an auto-downed member, but never one an operator
`mark()`-ed down.

Everything is process-local state: in a real deployment this registry
is fed by whatever control plane owns membership (k8s endpoints, a
gossip layer); the serving stack only ever reads it through this
interface, so the in-process two-replica harness (fleet/local.py) and a
networked deployment exercise identical code paths.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry


class RolloutState:
    """Fleet-wide (model_tag, epoch), thread-safe, with subscribers.

    `bump(new_tag)` is THE weight-rollout switch: it advances the model
    epoch, re-tags the fleet, and notifies subscribers (schedulers
    re-key, peer servers start rejecting the old tag) before returning —
    so by the time a rollout caller sees `bump` return, no component
    will serve or fetch a stale-tag fold. Subscribers run under the
    state lock: keep them O(1) attribute writes (the in-process harness
    uses them to swap each Scheduler.model_tag).

    `persist_path` makes (tag, epoch) durable: every bump atomically
    rewrites the file (tmp + os.replace) and construction loads it —
    a replica that crashed or was drain-restarted REJOINS at the tag
    the fleet had rolled to, instead of coming back up serving (and
    peer-refusing) under its boot-time default. The persisted epoch
    wins over the constructor's `model_tag` whenever the file exists;
    file trouble degrades to the in-memory default."""

    def __init__(self, model_tag: str = "",
                 registry: Optional[MetricsRegistry] = None,
                 persist_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._tag = model_tag
        self._epoch = 0
        self._persist_path = persist_path
        self._subscribers: List[Callable[[str, int], None]] = []
        if persist_path:
            try:
                with open(persist_path) as fh:
                    rec = json.load(fh)
                self._tag = str(rec["tag"])
                self._epoch = int(rec["epoch"])
            except Exception:
                pass           # first boot / unreadable: boot default
        reg = registry or get_registry()
        self._m_epoch = reg.gauge(
            "fleet_model_epoch", "current weight-rollout epoch")
        self._m_rollouts = reg.counter(
            "fleet_rollouts_total", "model_tag epoch bumps")
        self._m_epoch.set(self._epoch)

    def _persist_locked(self):
        """Caller holds self._lock. Atomic rewrite: a crash mid-rollout
        leaves either the old or the new epoch, never a torn file."""
        if not self._persist_path:
            return
        try:
            d = os.path.dirname(os.path.abspath(self._persist_path))
            os.makedirs(d, exist_ok=True)
            tmp = f"{self._persist_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump({"tag": self._tag, "epoch": self._epoch}, fh)
            os.replace(tmp, self._persist_path)
        except OSError:
            pass               # durability is best-effort, serving wins

    @property
    def tag(self) -> str:
        with self._lock:
            return self._tag

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    def current(self) -> Tuple[str, int]:
        with self._lock:
            return self._tag, self._epoch

    def subscribe(self, fn: Callable[[str, int], None]):
        """fn(tag, epoch) runs on every bump, under the state lock."""
        with self._lock:
            self._subscribers.append(fn)

    def bump(self, new_tag: str) -> int:
        """Roll the fleet to `new_tag`. Returns the new model epoch."""
        with self._lock:
            if new_tag == self._tag:
                return self._epoch      # idempotent re-announce
            self._tag = new_tag
            self._epoch += 1
            epoch = self._epoch
            self._persist_locked()      # durable BEFORE subscribers: a
            #                             crash mid-bump rejoins rolled
            subs = list(self._subscribers)
            for fn in subs:
                try:
                    fn(new_tag, epoch)
                except Exception:
                    pass    # a broken subscriber must not block rollout
        self._m_rollouts.inc()
        self._m_epoch.set(epoch)
        return epoch


@dataclass
class ReplicaInfo:
    """One fleet member as the registry sees it.

    peer_addr: (host, port) of its PeerCacheServer, None when the
        replica exposes no peer cache tier.
    transport: forwarding transport — an object with
        `submit(request, trace=) -> FoldTicket` (fleet.rpc: a
        `LocalTransport` for in-process wiring, an `HttpTransport`
        speaking the FrontDoorServer protocol for a networked
        deployment). None + submit=None = not forwardable.
    submit: LEGACY transport — a bare callable taking a FoldRequest and
        returning a FoldTicket. Kept so pre-transport callers (and
        tests that stub `info.submit`) work unchanged; the router
        wraps it in a LocalTransport at forward time. `transport` wins
        when both are set.
    """

    replica_id: str
    peer_addr: Optional[Tuple[str, int]] = None
    submit: Optional[Callable[[Any], Any]] = None
    transport: Optional[Any] = None
    marked_up: bool = True
    last_heartbeat_s: float = field(default=0.0)
    # True when the down-mark came from a heartbeat-TTL sweep rather
    # than an operator: only these members are revivable by heartbeat.
    auto_down: bool = field(default=False)


class ReplicaRegistry:
    """Membership + health + epochs for one logical serving fleet.

    heartbeat_timeout_s: when set, a replica also needs a heartbeat
        within this window to count as healthy; None (default) makes
        health purely mark-driven — deterministic for tests and for
        control planes that push liveness instead of pulling it.
    `clock` is injectable for tests (monotonic seconds).
    """

    def __init__(self, heartbeat_timeout_s: Optional[float] = None,
                 model_tag: str = "",
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[MetricsRegistry] = None,
                 rollout_persist_path: Optional[str] = None):
        self._lock = threading.Lock()
        self._clock = clock
        self._members: Dict[str, ReplicaInfo] = {}
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.epoch = 0                 # membership epoch, lock-guarded
        reg = registry or get_registry()
        self.rollout = RolloutState(model_tag, registry=reg,
                                    persist_path=rollout_persist_path)
        self._m_healthy = reg.gauge(
            "fleet_replicas_healthy", "replicas currently routable")
        self._m_members = reg.gauge(
            "fleet_replicas_registered", "replicas in the registry")
        # minted only when the TTL feature is armed: a default registry
        # keeps its metric-name set byte-identical
        self._m_auto_downs = (reg.counter(
            "fleet_auto_downs_total",
            "members auto-marked down by heartbeat-TTL sweep")
            if heartbeat_timeout_s is not None else None)

    # -- membership ------------------------------------------------------

    def register(self, replica_id: str,
                 peer_addr: Optional[Tuple[str, int]] = None,
                 submit: Optional[Callable] = None,
                 transport: Optional[Any] = None) -> ReplicaInfo:
        """Add (or re-announce) a member; bumps the membership epoch.
        A re-announce UPDATES the existing row: fields not provided
        (peer_addr/submit/transport left None) are preserved, as is an
        administrative down-mark — a periodic control-plane re-announce
        must neither strip a live member's forwarding transport nor
        resurrect a replica an operator pulled out."""
        with self._lock:
            info = self._members.get(replica_id)
            if info is None:
                info = ReplicaInfo(replica_id, peer_addr=peer_addr,
                                   submit=submit, transport=transport,
                                   last_heartbeat_s=self._clock())
                self._members[replica_id] = info
            else:
                if peer_addr is not None:
                    info.peer_addr = peer_addr
                if submit is not None:
                    info.submit = submit
                if transport is not None:
                    info.transport = transport
                info.last_heartbeat_s = self._clock()
            self.epoch += 1
        self._report_gauges()
        return info

    def deregister(self, replica_id: str):
        with self._lock:
            if self._members.pop(replica_id, None) is not None:
                self.epoch += 1
        self._report_gauges()

    def unregister(self, replica_id: str):
        """Remove a member entirely (endpoint gone, not just unhealthy);
        bumps the membership epoch so rings rebuild without it."""
        self.deregister(replica_id)

    def get(self, replica_id: str) -> Optional[ReplicaInfo]:
        with self._lock:
            return self._members.get(replica_id)

    def members(self) -> List[ReplicaInfo]:
        """All registered members, sorted by id (healthy or not)."""
        with self._lock:
            return [self._members[k] for k in sorted(self._members)]

    def member_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._members)

    # -- health ----------------------------------------------------------

    def heartbeat(self, replica_id: str):
        """Freshness ping; does NOT bump the epoch (routers check
        staleness at lookup time, the ring does not change) — UNLESS it
        revives a sweep-auto-downed member, which is a membership change
        rings must see. An administrative down-mark is never revived."""
        revived = False
        with self._lock:
            info = self._members.get(replica_id)
            if info is not None:
                info.last_heartbeat_s = self._clock()
                if info.auto_down and not info.marked_up:
                    info.marked_up = True
                    info.auto_down = False
                    self.epoch += 1
                    revived = True
        if revived:
            self._report_gauges()

    def mark(self, replica_id: str, up: bool):
        """Administrative health mark; epoch bumps only on a change.
        An explicit mark always clears `auto_down` — the operator's
        word overrides (and un-arms) the TTL sweep's."""
        changed = False
        with self._lock:
            info = self._members.get(replica_id)
            if info is not None:
                if info.auto_down:
                    info.auto_down = False
                if info.marked_up != up:
                    info.marked_up = up
                    if up:
                        info.last_heartbeat_s = self._clock()
                    self.epoch += 1
                    changed = True
        if changed:
            self._report_gauges()

    def sweep(self) -> List[str]:
        """Auto-down every marked-up member whose heartbeat aged past
        `heartbeat_timeout_s` (no-op when the TTL is unset). Unlike the
        passive lookup-time staleness check, this BUMPS the membership
        epoch so consistent-hash rings rebuild without the wedged
        member — it stops owning keys instead of merely failing them.
        Returns the ids downed this sweep."""
        if self.heartbeat_timeout_s is None:
            return []
        downed: List[str] = []
        with self._lock:
            now = self._clock()
            for rid, info in self._members.items():
                if (info.marked_up and
                        now - info.last_heartbeat_s
                        > self.heartbeat_timeout_s):
                    info.marked_up = False
                    info.auto_down = True
                    downed.append(rid)
            if downed:
                self.epoch += 1
        if downed:
            if self._m_auto_downs is not None:
                self._m_auto_downs.inc(len(downed))
            self._report_gauges()
        return sorted(downed)

    def is_healthy(self, replica_id: str) -> bool:
        with self._lock:
            return self._healthy_locked(self._members.get(replica_id))

    def _healthy_locked(self, info: Optional[ReplicaInfo]) -> bool:
        if info is None or not info.marked_up:
            return False
        if self.heartbeat_timeout_s is None:
            return True
        return (self._clock() - info.last_heartbeat_s
                <= self.heartbeat_timeout_s)

    # -- views -----------------------------------------------------------

    def _report_gauges(self):
        with self._lock:
            healthy = sum(1 for i in self._members.values()
                          if self._healthy_locked(i))
            total = len(self._members)
        self._m_healthy.set(healthy)
        self._m_members.set(total)

    def snapshot(self) -> dict:
        tag, model_epoch = self.rollout.current()
        with self._lock:
            members = {
                rid: {"healthy": self._healthy_locked(info),
                      "marked_up": info.marked_up,
                      "peer_addr": (list(info.peer_addr)
                                    if info.peer_addr else None),
                      "forwardable": (info.transport is not None
                                      or info.submit is not None),
                      "transport": (None if info.transport is None
                                    else type(info.transport).__name__),
                      # only under an armed TTL: a default registry's
                      # snapshot stays byte-identical
                      **({"auto_down": info.auto_down}
                         if self.heartbeat_timeout_s is not None else {})}
                for rid, info in sorted(self._members.items())}
            return {"epoch": self.epoch,
                    "model_tag": tag,
                    "model_epoch": model_epoch,
                    "replicas": members,
                    "healthy": sum(1 for m in members.values()
                                   if m["healthy"])}
