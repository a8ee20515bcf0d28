"""Speculative model cascade: a draft tier in front of the flagship.

HelixFold's tiered-efficiency results say most traffic does not need
the flagship config: a small trunk with short recycles produces an
acceptable structure for the easy majority of sequences, at a fraction
of the accelerator-seconds. The cascade makes that a SERVING property
instead of a modeling one:

1. every cascaded submit folds on the DRAFT scheduler first (its own
   small model, its own `model_tag`, its own isolated metrics);
2. a confidence gate (serve/confidence.py — mean pLDDT, optionally
   distogram entropy) judges the draft result from outputs the model
   already emits;
3. an accepted draft resolves the caller's ticket as `tier="draft"`;
   a rejected (or errored) one ESCALATES: the original request
   re-enters the flagship scheduler through the ordinary submit seam —
   priority-boosted, deadline re-anchored to what remains — and
   resolves as `tier="flagship", escalated=True`.

Tier isolation is by construction, then double-checked at runtime:
the two tiers share one `FoldCache`, but `fold_key` embeds
`model_tag`, so a draft result can never be read under a flagship key
or vice versa. The scheduler still compares the two keys per cascaded
submit and counts any collision in
`serve_cascade_cross_tier_hits_total` — the smoke test pins that
counter to 0, so a future keying regression fails loudly instead of
silently serving draft structures to flagship callers.

Everything here is data + wiring helpers; the flow itself lives in
`Scheduler._submit_cascade` (it needs the scheduler's queue/cache/
trace internals). `Scheduler(cascade=None)` — the default — is
byte-for-byte the cascade-off behavior, pinned by scrubbed-stats and
metric-name-set identity tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from alphafold2_tpu_torch.serve.confidence import ConfidenceGate

__all__ = ["CascadePolicy", "build_draft_scheduler"]


@dataclass
class CascadePolicy:
    """Knobs for the speculative cascade (Scheduler(cascade=...)).

    draft: the draft-tier scheduler — anything with the Scheduler
        submit/model_tag/start/stop surface. It MUST carry a model_tag
        distinct from the flagship's (attach raises otherwise: the
        shared FoldCache keys tiers apart by tag alone).
    gate: the accept/escalate predicate over the draft's confidence.
    escalation_priority: added to the request's own priority when it
        escalates — the flagship already made this caller wait out a
        draft fold, so the escalation must not also queue behind fresh
        arrivals of equal priority.
    draft_deadline_s: cap on the DRAFT attempt's deadline. The draft
        request carries min(remaining request deadline, this cap):
        a draft that cannot fold quickly should fail over to the
        flagship while the caller's budget still covers a real fold.
        None = the draft inherits the caller's deadline unchanged.
    manage_draft: the flagship's start()/stop() also start/stop the
        draft scheduler — one lifecycle for callers that treat the
        cascade as a unit (ProcFleet replicas do). Turn off when the
        draft's lifecycle is owned elsewhere.
    """

    draft: object = None
    gate: ConfidenceGate = field(default_factory=ConfidenceGate)
    escalation_priority: int = 10
    draft_deadline_s: Optional[float] = None
    manage_draft: bool = True

    def __post_init__(self):
        if self.draft is None or not hasattr(self.draft, "submit"):
            raise ValueError(
                "CascadePolicy.draft must be a scheduler-like object "
                "with .submit()")
        if not hasattr(self.draft, "model_tag"):
            raise ValueError(
                "CascadePolicy.draft must expose .model_tag (cross-tier "
                "cache isolation keys on it)")
        if self.escalation_priority < 0:
            raise ValueError("escalation_priority must be >= 0")
        if self.draft_deadline_s is not None and self.draft_deadline_s <= 0:
            raise ValueError("draft_deadline_s must be > 0")

    def draft_deadline(self, remaining_s: Optional[float]) -> Optional[float]:
        """Effective deadline for the draft attempt given the caller's
        remaining budget (None = unbounded)."""
        if self.draft_deadline_s is None:
            return remaining_s
        if remaining_s is None:
            return self.draft_deadline_s
        return min(remaining_s, self.draft_deadline_s)


def build_draft_scheduler(executor, buckets, config=None,
                          model_tag: str = "draft",
                          cache=None, tracer=None, **kwargs):
    """Construct a draft-tier Scheduler on an ISOLATED metrics registry.

    The draft must not share the flagship's registry: `ServeMetrics`
    mirrors into registry counters dedup'd by NAME, so a shared
    registry would silently sum draft and flagship series (latency
    histograms, outcome counters) and corrupt both the flagship's SLO
    window and the identity tests. The draft's own numbers stay
    reachable through `serve_stats()["cascade"]["draft"]`.

    cache: pass the FLAGSHIP's FoldCache to share the result store —
        the draft writes under its own model_tag, so sharing is safe
        by construction and lets a repeated draft fold hit.
    confidence_summary is forced on (unless the caller pins it) so the
    gate can read distogram entropy, not just pLDDT.
    """
    from alphafold2_tpu_torch.obs.registry import MetricsRegistry
    from alphafold2_tpu_torch.serve.metrics import ServeMetrics
    from alphafold2_tpu_torch.serve.scheduler import Scheduler, SchedulerConfig

    if config is None:
        config = SchedulerConfig(confidence_summary=True)
    reg = MetricsRegistry()
    return Scheduler(executor, buckets, config=config,
                     metrics=ServeMetrics(registry=reg),
                     cache=cache, model_tag=model_tag, tracer=tracer,
                     registry=reg, **kwargs)
