"""Confidence scoring for the speculative cascade.

The draft tier's accept/escalate decision has to come from signals the
model ALREADY emits — adding a dedicated confidence head would change
the draft architecture and its params, defeating the point of a cheap
tier. Two such signals exist in every `predict.FoldResult`:

- **predicted lDDT** — `FoldResult.confidence` is a per-residue score
  in [0, 1] (the serve path's `FoldResponse.confidence` array). Its
  mean is the classic pLDDT acceptance signal: HelixFold-style tiered
  serving accepts drafts whose own confidence clears a bar.
- **distogram entropy** — the distogram head's per-pair categorical
  over distance bins. A confident fold commits to narrow distance
  distributions; a confused one smears mass across bins. Mean
  per-pair entropy, normalized by log(bins), lands in [0, 1] where
  LOW is confident — the complement signal to pLDDT (a model can be
  pointwise confident but globally undecided).

Both scores are pure numpy over arrays the batch already produced, so
the gate costs microseconds against fold-seconds. The gate itself
(`ConfidenceGate`) is a tiny predicate object so `CascadePolicy` can
carry it as data and tests can exercise thresholds without a model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = [
    "plddt_score",
    "distogram_entropy",
    "ConfidenceScore",
    "score_response",
    "ConfidenceGate",
]


def plddt_score(confidence, mask=None) -> float:
    """Mean predicted-lDDT over real residues, in [0, 1].

    confidence: per-residue scores, any shape (the serve path hands
    (n,) for one sequence, (b, n) for a batch). mask: optional same-
    shape 0/1 validity mask — padded rows of a bucketed batch must not
    dilute the mean. Raises ValueError on empty input (an empty fold
    has no confidence, and a silent 0.0 would always escalate while a
    silent 1.0 would always accept — neither is a decision this module
    should make).
    """
    conf = np.asarray(confidence, dtype=np.float64)
    if conf.size == 0:
        raise ValueError("plddt_score: empty confidence array")
    if mask is None:
        return float(conf.mean())
    m = np.asarray(mask, dtype=np.float64)
    if m.shape != conf.shape:
        raise ValueError(
            f"plddt_score: mask shape {m.shape} != confidence {conf.shape}")
    denom = m.sum()
    if denom <= 0:
        raise ValueError("plddt_score: mask selects no residues")
    return float((conf * m).sum() / denom)


def distogram_entropy(logits, mask=None) -> float:
    """Mean per-pair distogram entropy normalized to [0, 1].

    logits: (..., bins) raw distogram logits (predict.FoldResult
    .distogram is (b, n, n, bins)). Softmax is computed here in
    float64 with the max-subtraction trick — the serve path may hand
    bf16 logits and a naive exp overflows. mask: optional (...,) pair
    validity mask matching the leading shape. Normalization by
    log(bins) makes the score bucket-layout independent: 0 = every
    pair is a delta, 1 = every pair is uniform.
    """
    lg = np.asarray(logits, dtype=np.float64)
    if lg.ndim < 1 or lg.shape[-1] < 2:
        raise ValueError(
            f"distogram_entropy: need (..., bins>=2) logits, got {lg.shape}")
    lg = lg - lg.max(axis=-1, keepdims=True)
    p = np.exp(lg)
    p /= p.sum(axis=-1, keepdims=True)
    # x*log(x) -> 0 at x=0; clip keeps log finite without biasing the sum
    ent = -(p * np.log(np.clip(p, 1e-30, None))).sum(axis=-1)
    ent /= np.log(lg.shape[-1])
    if mask is None:
        return float(ent.mean())
    m = np.asarray(mask, dtype=np.float64)
    if m.shape != ent.shape:
        raise ValueError(
            f"distogram_entropy: mask shape {m.shape} != pairs {ent.shape}")
    denom = m.sum()
    if denom <= 0:
        raise ValueError("distogram_entropy: mask selects no pairs")
    return float((ent * m).sum() / denom)


@dataclass(frozen=True)
class ConfidenceScore:
    """One draft result's gate inputs. `entropy` is None when the
    serving path did not carry the distogram summary (the scheduler
    only computes it under SchedulerConfig(confidence_summary=True) —
    the distogram is batch-sized and never rides FoldResponse
    itself)."""

    plddt: float
    entropy: Optional[float] = None

    @property
    def score(self) -> float:
        """Single scalar for reporting: pLDDT penalized by entropy
        when present. Gates threshold the components, not this."""
        if self.entropy is None:
            return self.plddt
        return self.plddt * (1.0 - self.entropy)


def score_response(response) -> ConfidenceScore:
    """Score one ok FoldResponse from the draft tier. Reads the
    per-residue `confidence` array and, when the draft scheduler ran
    with confidence_summary, the precomputed `distogram_entropy`
    scalar."""
    if response.confidence is None:
        raise ValueError("score_response: response carries no confidence")
    return ConfidenceScore(
        plddt=plddt_score(response.confidence),
        entropy=getattr(response, "distogram_entropy", None))


@dataclass(frozen=True)
class ConfidenceGate:
    """Accept/escalate predicate over a ConfidenceScore.

    accept_plddt: minimum mean pLDDT to accept a draft. The 0.70
        default tracks the common "confident" band of lDDT-Ca
        calibration.
    max_entropy: optional ceiling on normalized distogram entropy;
        only consulted when the score carries one, so gates stay
        meaningful on drafts served without the distogram summary.
    """

    accept_plddt: float = 0.70
    max_entropy: Optional[float] = None

    def __post_init__(self):
        if not 0.0 <= self.accept_plddt <= 1.0:
            raise ValueError("accept_plddt must be in [0, 1]")
        if self.max_entropy is not None and not 0.0 <= self.max_entropy <= 1.0:
            raise ValueError("max_entropy must be in [0, 1]")

    def accepts(self, score: ConfidenceScore) -> bool:
        if score.plddt < self.accept_plddt:
            return False
        if (self.max_entropy is not None and score.entropy is not None
                and score.entropy > self.max_entropy):
            return False
        return True
