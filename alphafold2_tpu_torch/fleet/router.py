"""Consistent-hash request routing: fold_key -> owner replica.

ParaFold's observation is that AlphaFold serving is embarrassingly
parallel across sequences — the fleet-level win is routing: if every
replica behind a dumb load balancer sees a uniform slice of a Zipf-head
workload, each of them folds the head sequences independently. Mapping
each `fold_key` to ONE owner replica makes the whole fleet coalesce a
hot key on a single leader (the owner's InflightRegistry) and gives its
peer cache entry a well-known home.

The ring is classic consistent hashing: `vnodes` virtual points per
replica (blake2b of "replica#i"), keys located by bisect on the sorted
point list, ownership = first point at/after the key walking clockwise.
Adding/removing one replica moves ~1/N of the keyspace; the ring is
rebuilt lazily whenever the registry's membership epoch changes and is
otherwise one integer compare on the submit hot path.

Routing is advisory, never load-bearing for correctness:

- `route()` skips unhealthy owners (walks the ring to the next healthy
  point) and falls back to LOCAL when nobody else is routable — a
  partitioned replica degrades to exactly the pre-fleet single-host
  behavior, it never errors a request because of fleet state;
- forwarding is BOUNDED to one hop: a forwarded request carries
  `FoldRequest.forwarded=True` and the receiving scheduler serves it
  locally no matter what its own ring says, so two replicas with
  momentarily divergent membership views can bounce a request at most
  once, never loop it.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

from alphafold2_tpu_torch.fleet.registry import ReplicaRegistry
from alphafold2_tpu_torch.fleet.rpc import transport_of
from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry
from alphafold2_tpu_torch.obs.trace import NULL_TRACE


def _point(s: str) -> int:
    """64-bit ring position. blake2b, not hash(): stable across
    processes so every replica computes the same ring."""
    return int.from_bytes(
        hashlib.blake2b(s.encode("utf-8"), digest_size=8).digest(), "big")


def static_owner_for(key: str, replica_ids, vnodes: int = 64
                     ) -> Optional[str]:
    """Pure consistent-hash owner over a STATIC membership list — the
    identical blake2b/vnode scheme ConsistentHashRouter builds over a
    live registry, computable client-side with no registry at all.
    Campaign submitters (tools/bulk_submit.py --fleet) use it
    to shard a manifest exactly where the data plane's ring will look
    for each fold key, so coalescing leadership, peer-cache homes, and
    checkpoint locality all line up with the submit target. Returns
    None on an empty membership list."""
    ids = list(replica_ids)
    if not ids:
        return None
    pairs = sorted((_point(f"{rid}#{i}"), rid)
                   for rid in ids for i in range(int(vnodes)))
    points = [p for p, _ in pairs]
    start = bisect.bisect_left(points, _point(key)) % len(points)
    return pairs[start][1]


@dataclass
class RouteDecision:
    """Where one key should fold and why."""

    owner_id: Optional[str]   # ring owner after health walk; None = no ring
    is_local: bool            # serve on this replica
    reason: str               # "local_owner" | "forward" | "no_peers" |
    #                           "owner_down_local_fallback" | "not_forwardable"


class ConsistentHashRouter:
    """Hash-ring view of one ReplicaRegistry, bound to one replica.

    self_id: the replica this router routes FOR (its local-fallback
        target and its notion of "is_local").
    vnodes: virtual points per replica; 64 keeps the max/min keyspace
        share within ~30% for small fleets without making rebuilds
        noticeable.
    """

    def __init__(self, registry: ReplicaRegistry, self_id: str,
                 vnodes: int = 64,
                 metrics: Optional[MetricsRegistry] = None):
        if vnodes < 1:
            raise ValueError("vnodes must be >= 1")
        self.registry = registry
        self.self_id = self_id
        self.vnodes = int(vnodes)
        self._lock = threading.Lock()
        self._ring_epoch = -1
        self._points: List[int] = []
        self._owners: List[str] = []
        reg = metrics or get_registry()
        self._m_forwards = reg.counter(
            "fleet_forwards_total",
            "requests forwarded to their ring owner", ("peer",))
        self._m_fallbacks = reg.counter(
            "fleet_forward_fallback_total",
            "routed requests served locally despite a remote owner",
            ("reason",))
        self._m_routed = reg.counter(
            "fleet_routed_total", "routing decisions", ("decision",))

    # -- ring ------------------------------------------------------------

    def _ring(self) -> Tuple[List[int], List[str]]:
        """Current (points, owners), rebuilt iff the membership epoch
        moved. The rebuild is O(members * vnodes log ...), off the hot
        path for a stable fleet."""
        epoch = self.registry.epoch
        with self._lock:
            if epoch == self._ring_epoch:
                return self._points, self._owners
        pairs = sorted(
            (_point(f"{rid}#{i}"), rid)
            for rid in self.registry.member_ids()
            for i in range(self.vnodes))
        points = [p for p, _ in pairs]
        owners = [rid for _, rid in pairs]
        with self._lock:
            self._ring_epoch = epoch
            self._points, self._owners = points, owners
            return self._points, self._owners

    def owner_for(self, key: str) -> Optional[str]:
        """Healthy ring owner of `key` (clockwise walk skipping
        unhealthy replicas); None when the ring is empty or nobody is
        healthy."""
        points, owners = self._ring()
        if not points:
            return None
        start = bisect.bisect_left(points, _point(key)) % len(points)
        seen = set()
        for i in range(len(points)):
            rid = owners[(start + i) % len(points)]
            if rid in seen:
                continue
            seen.add(rid)
            if self.registry.is_healthy(rid):
                return rid
        return None

    # -- decisions -------------------------------------------------------

    def route(self, key: str) -> RouteDecision:
        """Decide where `key` folds, from this replica's seat."""
        owner = self.owner_for(key)
        if owner is None:
            decision = RouteDecision(None, True, "no_peers")
        elif owner == self.self_id:
            decision = RouteDecision(owner, True, "local_owner")
        else:
            info = self.registry.get(owner)
            if transport_of(info) is None:
                # owner routable for peer-cache purposes but exposes no
                # forwarding transport: fold locally, its cache tier is
                # still reachable through the peer client
                decision = RouteDecision(owner, True, "not_forwardable")
            else:
                decision = RouteDecision(owner, False, "forward")
        self._m_routed.inc(decision="local" if decision.is_local
                           else "forward")
        return decision

    def forward(self, owner_id: str, request, trace=NULL_TRACE):
        """Hand `request` to its owner through its transport
        (fleet.rpc: LocalTransport in-process, HttpTransport across
        machines); returns a FoldTicket resolving to the remote result.
        Raises when the owner vanished, has no transport, or the
        transport refuses at submit time — the caller (Scheduler) then
        falls back to folding locally."""
        transport = transport_of(self.registry.get(owner_id))
        if transport is None:
            raise RuntimeError(f"replica {owner_id!r} not forwardable")
        ticket = transport.submit(request, trace=trace)
        self._m_forwards.inc(peer=owner_id)
        return ticket

    def forward_raw(self, owner_id: str, raw, trace=NULL_TRACE):
        """Hand a RAW job (serve.features.RawFoldRequest) to its
        FEATURE-key owner, which featurizes replica-side and folds
       . Raises when the owner vanished, has no transport,
        the transport has no raw path (legacy wiring), or submit is
        refused — the caller (serve.features.FeaturePool) then
        featurizes locally. The ring is key-agnostic, so the same hash
        walk that places fold keys places feature keys."""
        transport = transport_of(self.registry.get(owner_id))
        if transport is None or not hasattr(transport, "submit_raw"):
            raise RuntimeError(f"replica {owner_id!r} not raw-forwardable")
        ticket = transport.submit_raw(raw, trace=trace)
        self._m_forwards.inc(peer=owner_id)
        return ticket

    def note_fallback(self, reason: str):
        """Record a routed-remote request that folded locally anyway
        (owner down mid-forward, transport error, remote backpressure)."""
        self._m_fallbacks.inc(reason=reason)

    def snapshot(self) -> dict:
        points, owners = self._ring()
        share = {}
        for rid in set(owners):
            share[rid] = owners.count(rid)
        return {"self_id": self.self_id,
                "ring_points": len(points),
                "ring_epoch": self._ring_epoch,
                "vnode_share": share}
