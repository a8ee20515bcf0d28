"""Serving request type (counterpart of `alphafold2_tpu/serve/request.py:
27-80`).

The unit of work is one sequence (plus optional MSA), not a padded batch:
batching, padding and shape selection are the server's job
(`bucketing.py`, `executor.py`). The response, ticket and progress types
come with the scheduler (ROADMAP.md, queue 1, item 8).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

_req_counter = itertools.count()


def _next_request_id() -> str:
    return f"req-{next(_req_counter)}"


@dataclass
class FoldRequest:
    """One fold job: a token sequence, optional MSA, QoS knobs.

    seq: (n,) int tokens.
    msa: optional (m, n) int tokens.
    priority: higher folds first when a batch is formed from a backlog.
    deadline_s: wall-clock budget from submit.
    forwarded: this request already took its one fleet-routing hop.
    qos: "online" (the default), "bulk" or "express".
    """

    seq: np.ndarray
    msa: Optional[np.ndarray] = None
    request_id: str = field(default_factory=_next_request_id)
    priority: int = 0
    deadline_s: Optional[float] = None
    forwarded: bool = False
    qos: str = "online"

    def __post_init__(self):
        if self.qos not in ("online", "bulk", "express"):
            raise ValueError(
                f"FoldRequest.qos must be 'online', 'bulk' or 'express', "
                f"got {self.qos!r}")
        self.seq = np.asarray(self.seq, dtype=np.int32)
        if self.seq.ndim != 1:
            raise ValueError(
                f"FoldRequest.seq must be 1-D (n,), got {self.seq.shape}; "
                "the scheduler owns batching")
        if self.msa is not None:
            self.msa = np.asarray(self.msa, dtype=np.int32)
            if self.msa.ndim != 2 or self.msa.shape[1] != self.seq.shape[0]:
                raise ValueError(
                    f"FoldRequest.msa must be (m, {self.seq.shape[0]}), "
                    f"got {self.msa.shape}")

    @property
    def length(self) -> int:
        return int(self.seq.shape[0])
