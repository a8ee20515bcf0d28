"""alphafold2_tpu_torch.fleet — N replicas as one logical serving fleet
(counterpart of `alphafold2_tpu/fleet/`; the wire format, the hash ring
and the peer entries equal the JAX package's, so one fleet may hold
replicas of both packages).

The serve/cache layers made one process efficient (batching, result
cache, coalescing); this package makes N of them add up instead of
multiply: behind a dumb load balancer, every replica folds the Zipf
head independently — with the fleet tier, each fold_key has ONE owner
and one cached home. Pieces, each usable alone:

- registry:     ReplicaRegistry — membership + health + membership
                epochs; RolloutState — the fleet-wide (model_tag,
                epoch) that weight rollout bumps atomically
- router:       ConsistentHashRouter — fold_key -> owner replica over
                a vnode hash ring; one-hop bounded forwarding with
                local fallback (`Scheduler(router=...)`)
- peer:         PeerCacheClient/PeerCacheServer — npz-over-HTTP peer
                cache tier (`FoldCache(peer=client)`), stdlib only,
                same validation/quarantine trust model as the disk
                tier, rollout-tag checked at both ends
- object_store: ObjectStoreBackend/FilesystemObjectStore/
                ObjectStorePeer — the same peer tier over a shared
                volume instead of HTTP
- rpc:          LocalTransport/HttpTransport — the forwarding
                transport seam (FoldTicket semantics over a process
                boundary; failover marker, remote cancel)
- frontdoor:    FrontDoorServer — per-replica HTTP front door
                (submit/long-poll result/cancel/healthz/admin), the
                surface HttpTransport speaks
- local:        InProcessFleet — N fully-wired replicas in one process
                (the test harness and the deployment's executable
                spec)
- procfleet:    ProcFleet/FleetClient — N REAL replica processes with
                crash/partition/drain chaos (`python -m
                alphafold2_tpu_torch.fleet.procfleet --config <json>`)
- scaling:      ScalingPolicy + pure decision functions (decide_scale/
                decide_feature_workers/drain_target) — the control
                plane's brain, unit-testable without processes
- controlplane: FleetController — the reconcile loop that scales,
                rolls out, resizes, and warms the fleet from its own
                /metrics + /admin/stats scrapes

Everything is OFF by default: a Scheduler without `router=` and a
FoldCache without `peer=` behave exactly as before (README "Fleet
serving" / "Deployment", MIGRATING "Fleet").
"""

from alphafold2_tpu_torch.fleet.controlplane import FleetController  # noqa: F401
from alphafold2_tpu_torch.fleet.frontdoor import FrontDoorServer  # noqa: F401
from alphafold2_tpu_torch.fleet.local import FleetReplica, InProcessFleet  # noqa: F401
from alphafold2_tpu_torch.fleet.object_store import (FilesystemObjectStore,  # noqa: F401
                                               ObjectStoreBackend,
                                               ObjectStorePeer)
from alphafold2_tpu_torch.fleet.peer import PeerCacheClient, PeerCacheServer  # noqa: F401
from alphafold2_tpu_torch.fleet.registry import (ReplicaInfo, ReplicaRegistry,  # noqa: F401
                                           RolloutState)
from alphafold2_tpu_torch.fleet.router import (ConsistentHashRouter,  # noqa: F401
                                         RouteDecision)
from alphafold2_tpu_torch.fleet.rpc import (HttpTransport, LocalTransport,  # noqa: F401
                                      RPC_TRANSPORT_MARKER)
from alphafold2_tpu_torch.fleet.scaling import (HOLD, SCALE_DOWN,  # noqa: F401
                                          SCALE_UP, ReplicaSignals,
                                          ScalingDecision, ScalingPolicy,
                                          decide_feature_workers,
                                          decide_scale, drain_target)
