"""In-process fleet: N schedulers wired into one logical server.

This is the fleet's executable spec — `tests/test_torch_fleet.py` and
`chip_smoke.py`'s fleet phase run it (counterpart of
`alphafold2_tpu/fleet/local.py`). Each
replica is a full serving stack (FoldExecutor + FoldCache +
PeerCacheServer on 127.0.0.1 + ConsistentHashRouter + Scheduler),
sharing only the ReplicaRegistry and its RolloutState; forwarding uses
a `fleet.rpc.LocalTransport` over each peer Scheduler's bound `submit`
(same thread, same ticket — the pre-transport behavior behind the new
seam), peer cache fetches go over real localhost HTTP. A networked
deployment replaces exactly two things — the transport (`HttpTransport`
against each replica's `FrontDoorServer`; `fleet/procfleet.py` is the
executable spec) and how the registry is fed — and nothing in serve/,
cache/, or fleet/ routing changes.

Rollout: `bump_model_tag(tag)` flips the fleet's RolloutState, whose
subscriber re-tags every scheduler before bump() returns — subsequent
submits key under the new tag (old entries unreachable), and the peer
protocol 409s any straggler still fetching under the old tag.

`fleet=False` builds the same replicas UNWIRED (no router, no peer
tier): the two-independent-replicas baseline a fleet run is measured
against.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Callable, List, Optional

from alphafold2_tpu_torch.cache import FoldCache
from alphafold2_tpu_torch.fleet.peer import PeerCacheClient, PeerCacheServer
from alphafold2_tpu_torch.fleet.registry import ReplicaRegistry
from alphafold2_tpu_torch.fleet.router import ConsistentHashRouter
from alphafold2_tpu_torch.fleet.rpc import LocalTransport
from alphafold2_tpu_torch.obs.registry import MetricsRegistry
from alphafold2_tpu_torch.serve.bucketing import BucketPolicy
from alphafold2_tpu_torch.serve.metrics import ServeMetrics
from alphafold2_tpu_torch.serve.scheduler import Scheduler, SchedulerConfig


class FleetReplica:
    """One member's full stack, as built by InProcessFleet."""

    def __init__(self, replica_id: str, scheduler: Scheduler,
                 cache: Optional[FoldCache],
                 peer_server: Optional[PeerCacheServer],
                 router: Optional[ConsistentHashRouter]):
        self.replica_id = replica_id
        self.scheduler = scheduler
        self.cache = cache
        self.peer_server = peer_server
        self.router = router


class InProcessFleet:
    """N in-process replicas behind one registry; context-manageable.

    make_executor: factory called once per replica (each replica owns
        its program cache, as separate processes would).
    cache_kwargs: forwarded to each replica's FoldCache (tiering knobs;
        `peer`/`registry` are wired here). cache_kwargs=None still
        builds a FoldCache per replica — a fleet without result caching
        has nothing to share.
    fleet: False builds the independent-replicas baseline (no router,
        no peer tier, registry still tracks members for bookkeeping).
    metrics_factory: per-replica ServeMetrics factory (index -> metrics),
        e.g. distinct JSONL paths; None = in-memory defaults.
    retry: optional serve.resilience.RetryPolicy applied to EVERY
        replica's scheduler (failure-domain hardening; off when None).
    faults: optional serve.faults.FaultPlan threaded into every
        replica's FoldCache and PeerCacheClient (chaos harness; the
        executor side is the caller's to wire via make_executor).
    recycle_policy: optional serve.recycle.RecyclePolicy applied to
        EVERY replica's scheduler (step-mode recycle scheduling:
        early-exit, preemption, progressive results; off when None).
    feature_pool_factory: optional per-replica serve.FeaturePool
        factory (index -> FeaturePool or None) enabling the two-stage
        feature pipeline: raw jobs submitted via
        `submit_raw` route by FEATURE key to their ring owner, which
        featurizes replica-side (each replica owns its pool + feature
        cache, as separate processes would). Off when None.
    mesh_policy_factory: optional per-replica serve.MeshPolicy factory
        (index -> MeshPolicy or None) for mesh-aware replicas. A
        FACTORY, not a shared policy: in-process replicas share one
        device pool, so each needs its own policy/allocator over its
        own device subset (separate hosts in production own their
        chips outright). The mesh section then rides each replica's
        serve_stats()/health() through the fleet stats and /healthz
        passthrough unchanged.
    kernel_policy: optional serve.KernelPolicy applied to EVERY
        replica's scheduler (per-bucket attention kernel: the long
        buckets on kernel K2; off when None, as in the JAX package's
        fleet, which takes no such knob).
    """

    def __init__(self, make_executor: Callable[[], object],
                 buckets: BucketPolicy,
                 config: Optional[SchedulerConfig] = None,
                 n_replicas: int = 2,
                 model_tag: str = "fleet",
                 cache_kwargs: Optional[dict] = None,
                 fleet: bool = True,
                 tracer=None,
                 metrics_factory: Optional[
                     Callable[[int], ServeMetrics]] = None,
                 registry: Optional[MetricsRegistry] = None,
                 retry=None,
                 faults=None,
                 mesh_policy_factory: Optional[
                     Callable[[int], object]] = None,
                 recycle_policy=None,
                 feature_pool_factory: Optional[
                     Callable[[int], object]] = None,
                 kernel_policy=None):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.fleet_enabled = bool(fleet)
        self.registry = ReplicaRegistry(model_tag=model_tag,
                                        registry=registry)
        self.replicas: List[FleetReplica] = []
        self._started = False
        self._lock = threading.Lock()
        self._rr = 0

        for i in range(n_replicas):
            rid = f"r{i}"
            kw = dict(cache_kwargs or {})
            if kw.get("disk_dir"):
                # each replica gets its own disk namespace (they are
                # separate hosts in production); shared-volume
                # deployments mount an ObjectStorePeer instead
                kw["disk_dir"] = os.path.join(kw["disk_dir"], rid)
            cache = FoldCache(registry=registry, faults=faults, **kw)
            peer_server = None
            if self.fleet_enabled:
                peer_server = PeerCacheServer(
                    cache, rollout=self.registry.rollout, replica_id=rid,
                    metrics=registry)
            self.registry.register(
                rid,
                peer_addr=peer_server.address if peer_server else None)
            router = None
            if self.fleet_enabled:
                router = ConsistentHashRouter(self.registry, rid,
                                              metrics=registry)
                cache.peer = PeerCacheClient(
                    self.registry, rid, router=router,
                    rollout=self.registry.rollout, metrics=registry,
                    faults=faults)
            # each replica gets its own policy copy with a per-replica
            # seed: identical jitter streams would make the fleet back
            # off in lockstep after a correlated transient episode,
            # defeating the thundering-herd protection
            rep_retry = (None if retry is None else
                         dataclasses.replace(retry,
                                             seed=retry.seed + i))
            if rep_retry is not None and rep_retry.checkpoint_spill:
                # per-replica spill namespace, same reasoning as the
                # cache disk_dir split above: replicas are separate
                # hosts in production, and cross-replica resume must
                # go over the peer wire, not through a shared path
                rep_retry = dataclasses.replace(
                    rep_retry,
                    checkpoint_spill=os.path.join(
                        rep_retry.checkpoint_spill, rid))
            scheduler = Scheduler(
                make_executor(), buckets, config,
                metrics=(metrics_factory(i) if metrics_factory else None),
                cache=cache, model_tag=model_tag, tracer=tracer,
                registry=registry, router=router, retry=rep_retry,
                mesh_policy=(mesh_policy_factory(i)
                             if mesh_policy_factory else None),
                recycle_policy=recycle_policy,
                feature_pool=(feature_pool_factory(i)
                              if feature_pool_factory else None),
                kernel_policy=kernel_policy)
            # the forwarding transport wraps the peer scheduler's
            # submit (LocalTransport — in-process, zero-copy); set
            # after construction so the registry row is complete
            # before any router can pick this owner. submit_raw rides
            # the same seam so feature-key routing can hand RAW jobs
            # to their owner for replica-side featurization
            info = self.registry.get(rid)
            info.transport = LocalTransport(scheduler.submit,
                                            scheduler.submit_raw)
            if peer_server is not None:
                # unified health: the peer probe payload carries the
                # same breaker/queue/drain truth the front door serves
                peer_server.health_source = scheduler.health
                # checkpoint artifact kind: spilled carries
                # become peer-fetchable, and this replica's resume
                # path can pull a dead peer's spill over the wire
                peer_server.checkpoint_source = \
                    scheduler.checkpoint_store
                if scheduler.checkpoint_store is not None:
                    scheduler.checkpoint_store.peer = cache.peer
                # served fetches emit continued trace records under
                # the requester's peer_fetch hop — the
                # in-process harness shares the one tracer, so the
                # stitched pair lands in the same JSONL
                peer_server.tracer = tracer
            self.replicas.append(
                FleetReplica(rid, scheduler, cache, peer_server, router))

        # weight rollout re-tags every scheduler inside bump(): by the
        # time bump_model_tag returns, no submit keys under the old tag
        def _retag(tag: str, epoch: int):
            for replica in self.replicas:
                replica.scheduler.model_tag = tag

        self.registry.rollout.subscribe(_retag)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "InProcessFleet":
        if self._started:
            return self
        self._started = True
        for r in self.replicas:
            if r.peer_server is not None:
                r.peer_server.start()
            r.scheduler.start()
            self.registry.heartbeat(r.replica_id)
        return self

    def stop(self, drain: bool = True):
        for r in self.replicas:
            # feature pools first: their workers submit into the
            # schedulers, and a drained pool cannot race a stopping
            # queue
            pool = getattr(r.scheduler, "feature_pool", None)
            if pool is not None:
                pool.stop()
        for r in self.replicas:
            r.scheduler.stop(drain=drain)
        for r in self.replicas:
            if r.peer_server is not None:
                r.peer_server.stop()
        self._started = False

    def __enter__(self) -> "InProcessFleet":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- serving ---------------------------------------------------------

    def warmup(self) -> int:
        return sum(r.scheduler.warmup() for r in self.replicas)

    def submit(self, request, replica: Optional[int] = None):
        """Submit through one replica's front door (round-robin when
        `replica` is None — the dumb-load-balancer model the router is
        supposed to beat)."""
        if replica is None:
            with self._lock:
                replica = self._rr
                self._rr = (self._rr + 1) % len(self.replicas)
        return self.replicas[replica].scheduler.submit(request)

    def submit_raw(self, raw, replica: Optional[int] = None):
        """Submit one RAW job through one replica's front door (same
        round-robin model as submit). The receiving replica featurizes
        — or, with feature pools wired, routes the raw job by feature
        key to its ring owner first."""
        if replica is None:
            with self._lock:
                replica = self._rr
                self._rr = (self._rr + 1) % len(self.replicas)
        return self.replicas[replica].scheduler.submit_raw(raw)

    # -- fleet ops -------------------------------------------------------

    def bump_model_tag(self, new_tag: str) -> int:
        """Weight rollout: returns the new model epoch."""
        return self.registry.rollout.bump(new_tag)

    def mark(self, replica_id: str, up: bool):
        self.registry.mark(replica_id, up)

    def stats(self) -> dict:
        per_replica = {r.replica_id: r.scheduler.serve_stats()
                       for r in self.replicas}
        agg = {"served": 0, "batches": 0, "cache_hits": 0,
               "coalesced": 0, "peer_hits": 0, "leader_promotions": 0}
        for snap in per_replica.values():
            agg["served"] += snap.get("served", 0)
            agg["batches"] += snap.get("batches", 0)
            cache = snap.get("cache", {})
            agg["cache_hits"] += cache.get("hits", 0)
            agg["coalesced"] += cache.get("coalesced", 0)
            store = cache.get("store", {})
            agg["peer_hits"] += store.get("peer_hits", 0)
            inflight = cache.get("inflight", {})
            agg["leader_promotions"] += inflight.get(
                "leader_promotions", 0)
        return {"fleet": self.registry.snapshot(),
                "aggregate": agg,
                "replicas": per_replica}
