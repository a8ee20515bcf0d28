"""Pure scaling decisions for the fleet controller.

This module is the control plane's BRAIN with everything operational
amputated: no threads, no sockets, no clocks it didn't get handed.
`decide_scale(policy, signals, now, last_action_s)` is a pure function
from observed fleet state to one `ScalingDecision`, which makes every
policy property a unit test instead of a soak test — burn-rate
scale-up, idle scale-down, the hysteresis band between them, cooldown,
min/max bounds, quorum, least-loaded drain-target selection.

The signal vocabulary is exactly what the SLO engine already exports per
replica (`/admin/stats` + `/metrics`): the SLO engine's
`slo_latency_burn_rate` (how fast the latency error budget burns, 1.0
= exactly at budget), the executor's busy-seconds counter (differenced
into an idle fraction by the poller), and the featurize queue depth.
The controller (fleet/controlplane.py) does the polling and the
actuation; this module only ever decides.

Hysteresis is the load-bearing design point: scale-up triggers above
`up_burn_rate`, scale-down requires BOTH idleness above
`down_idle_fraction` AND burn below `down_burn_rate` — the dead band
between the two burn thresholds absorbs oscillating input so a fleet
hovering near its SLO neither flaps up/down nor thrashes the ring.
`cooldown_s` serializes actions in time on top of that: one actuation,
then silence until its effect has had time to land in the signals.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

HOLD = "hold"
SCALE_UP = "scale_up"
SCALE_DOWN = "scale_down"


@dataclass(frozen=True)
class ScalingPolicy:
    """Knobs for `decide_scale` / `decide_feature_workers`.

    min_replicas is BOTH the floor and the quorum: a scale-down that
    would leave fewer healthy members than this is refused, and a
    fleet observed below it is scaled up regardless of burn (a kill -9
    victim is replaced because membership dropped, not because latency
    already degraded).
    """

    min_replicas: int = 1
    max_replicas: int = 4
    # scale-up when any replica's latency burn exceeds this ...
    up_burn_rate: float = 1.0
    # ... or its featurize queue backs up past this many per worker
    up_queue_per_worker: float = 4.0
    # scale-down only when the fleet is this idle AND burn is below
    # down_burn_rate (the hysteresis dead band lives between
    # down_burn_rate and up_burn_rate)
    down_idle_fraction: float = 0.80
    down_burn_rate: float = 0.5
    cooldown_s: float = 30.0
    # feature-pool resize band: desired workers = ceil(queue/target),
    # resized only when outside [min, max] clamp and != current
    feature_workers_min: int = 1
    feature_workers_max: int = 8
    feature_queue_per_worker: float = 2.0

    def __post_init__(self):
        if self.min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if self.max_replicas < self.min_replicas:
            raise ValueError("max_replicas < min_replicas")
        if self.down_burn_rate > self.up_burn_rate:
            raise ValueError(
                "down_burn_rate must not exceed up_burn_rate "
                "(the hysteresis band would be inverted)")
        if self.feature_workers_max < self.feature_workers_min:
            raise ValueError("feature_workers_max < feature_workers_min")


@dataclass
class ReplicaSignals:
    """One replica's observed state, as the controller polled it."""

    replica_id: str
    healthy: bool = True
    draining: bool = False
    # announced spot reclaim: the replica is draining under
    # a grace deadline and WILL die — its burn contribution is the
    # reclaim's fault, not organic load growth
    preempting: bool = False
    queue_depth: int = 0
    served: int = 0
    burn_rate: float = 0.0        # max latency burn across SLO classes
    idle_fraction: float = 1.0    # 1 - busy-seconds delta / wall delta
    featurize_queue_depth: int = 0
    featurize_workers: int = 1
    model_tag: str = ""
    incarnation: str = ""


@dataclass
class ScalingDecision:
    action: str = HOLD            # HOLD | SCALE_UP | SCALE_DOWN
    reason: str = ""
    drain_target: Optional[str] = None   # set when action == SCALE_DOWN
    # observed inputs the decision was made from, for the JSONL log
    healthy: int = 0
    pending: int = 0              # spawned, alive, not yet joined
    fleet_burn: float = 0.0
    fleet_idle: float = 0.0

    def to_dict(self) -> dict:
        return {"action": self.action, "reason": self.reason,
                "drain_target": self.drain_target,
                "healthy": self.healthy,
                "pending": self.pending,
                "fleet_burn": round(self.fleet_burn, 4),
                "fleet_idle": round(self.fleet_idle, 4)}


def _load(s: ReplicaSignals) -> tuple:
    """Sort key for drain-target selection: least loaded first.
    Queue depth dominates (work not yet started is work another
    replica can absorb), then in-flight featurize backlog, then
    lifetime served as the tiebreak toward draining the youngest,
    then id for determinism."""
    return (s.queue_depth, s.featurize_queue_depth, s.served,
            s.replica_id)


def drain_target(signals: Sequence[ReplicaSignals]) -> Optional[str]:
    """Pick the replica to drain on scale-down: the least-loaded
    healthy, non-draining member (its queue is the cheapest to let
    empty; its ring share redistributes with the least displaced
    in-flight work). None when no member is eligible."""
    eligible = [s for s in signals if s.healthy and not s.draining]
    if not eligible:
        return None
    return min(eligible, key=_load).replica_id


def decide_scale(policy: ScalingPolicy,
                 signals: Sequence[ReplicaSignals],
                 now: float,
                 last_action_s: Optional[float] = None,
                 pending: int = 0
                 ) -> ScalingDecision:
    """One reconcile round's verdict. Pure: same inputs, same output.

    Precedence: quorum restore (membership below min) beats cooldown —
    a killed replica is replaced immediately, not after the cooldown
    from the controller's own last scale-down. Everything else
    (burn/queue scale-up, idle scale-down) honors the cooldown.

    pending: replicas spawned but not yet serving (endpoint up, never
    joined). They count toward quorum and the max bound — a replica
    whose boot takes many reconcile intervals must not be re-spawned
    every cycle while it warms up (the runaway-restore bug) — and any
    nonzero pending holds tuning actions entirely: the fleet is
    mid-change, and acting again before the spawn lands would
    double-provision (up) or fight the provisioning (down).
    """
    healthy = [s for s in signals if s.healthy and not s.draining]
    n = len(healthy)
    pending = max(0, int(pending))
    fleet_burn = max((s.burn_rate for s in healthy), default=0.0)
    if not math.isfinite(fleet_burn):
        fleet_burn = policy.up_burn_rate + 1.0   # inf burn = way over
    fleet_idle = (sum(s.idle_fraction for s in healthy) / n
                  if n else 0.0)
    d = ScalingDecision(healthy=n, pending=pending,
                        fleet_burn=fleet_burn, fleet_idle=fleet_idle)

    # quorum restore: below the floor is an outage, not a tuning call
    if n + pending < policy.min_replicas:
        d.action = SCALE_UP
        d.reason = (f"healthy {n} + pending {pending} < min_replicas "
                    f"{policy.min_replicas} (quorum restore)")
        return d

    in_cooldown = (last_action_s is not None
                   and now - last_action_s < policy.cooldown_s)
    if in_cooldown:
        d.reason = (f"cooldown ({now - last_action_s:.1f}s < "
                    f"{policy.cooldown_s:.1f}s since last action)")
        return d
    if pending:
        d.reason = (f"{pending} spawn(s) pending: waiting for the "
                    f"fleet to settle before tuning")
        return d

    # scale-up: SLO burn or featurize backlog, bounded by max
    queue_pressure = max(
        (s.featurize_queue_depth / max(1, s.featurize_workers)
         for s in healthy), default=0.0)
    if fleet_burn > policy.up_burn_rate:
        if any(getattr(s, "preempting", False) for s in signals):
            # announced reclaim in progress: the survivors'
            # burn spike is the preemption window's fault — the failover
            # wave plus the reclaimed member's lost capacity — and
            # quorum restore (above, cooldown-exempt) already replaces
            # the member once it is gone. Scaling up on this burn too
            # would double-provision, then flap back down.
            d.reason = (f"burn {fleet_burn:.2f} > "
                        f"{policy.up_burn_rate:.2f} but attributable "
                        f"to an announced preemption window: "
                        f"suppressed (quorum restore replaces the "
                        f"reclaimed member)")
            return d
        if n >= policy.max_replicas:
            d.reason = (f"burn {fleet_burn:.2f} > "
                        f"{policy.up_burn_rate:.2f} but at "
                        f"max_replicas {policy.max_replicas}")
            return d
        d.action = SCALE_UP
        d.reason = (f"burn {fleet_burn:.2f} > "
                    f"up_burn_rate {policy.up_burn_rate:.2f}")
        return d
    if queue_pressure > policy.up_queue_per_worker:
        if n >= policy.max_replicas:
            d.reason = (f"featurize queue {queue_pressure:.1f}/worker "
                        f"but at max_replicas {policy.max_replicas}")
            return d
        d.action = SCALE_UP
        d.reason = (f"featurize queue {queue_pressure:.1f}/worker > "
                    f"{policy.up_queue_per_worker:.1f}")
        return d

    # scale-down: requires idle AND burn safely below the band
    if (fleet_idle > policy.down_idle_fraction
            and fleet_burn < policy.down_burn_rate):
        if n <= policy.min_replicas:
            d.reason = (f"idle {fleet_idle:.2f} but at min_replicas "
                        f"{policy.min_replicas}")
            return d
        target = drain_target(healthy)
        if target is None:
            d.reason = "idle but no drainable target"
            return d
        d.action = SCALE_DOWN
        d.drain_target = target
        d.reason = (f"idle {fleet_idle:.2f} > "
                    f"{policy.down_idle_fraction:.2f} and burn "
                    f"{fleet_burn:.2f} < {policy.down_burn_rate:.2f}")
        return d

    d.reason = (f"in band (burn {fleet_burn:.2f}, "
                f"idle {fleet_idle:.2f})")
    return d


def decide_feature_workers(policy: ScalingPolicy,
                           s: ReplicaSignals) -> Optional[int]:
    """Desired FeaturePool worker count for one replica, or None to
    leave it alone. Sized so the queue drains at
    `feature_queue_per_worker` items per worker, clamped to the
    policy's bounds; a one-worker hysteresis margin on the way DOWN
    keeps a queue hovering at a worker boundary from resizing every
    poll (growing is immediate — backlog is latency)."""
    want = max(policy.feature_workers_min,
               min(policy.feature_workers_max,
                   math.ceil(s.featurize_queue_depth
                             / max(1e-9, policy.feature_queue_per_worker))
                   if s.featurize_queue_depth > 0
                   else policy.feature_workers_min))
    cur = max(1, s.featurize_workers)
    if want > cur:
        return want
    if want < cur - 1:            # shrink only past the hysteresis margin
        return want
    return None
