"""Recycle-aware iteration-level scheduling policy (counterpart of
`alphafold2_tpu/serve/recycle.py`; the repack gathers rows with torch's
`index_select` where the JAX package uses `jnp.take`).

Without it a fold is an opaque unit of work: `predict.fold` runs every
recycle in one call, so a fold that converged after recycle 1
still pays for all N, and a flagship batch holds its device slice
hostage until the last recycle finishes. ParaFold's workload analysis
(PAPERS.md) makes recycle count the dominant inference-throughput lever,
and the recycling loop is a natural scheduling quantum — the same
insight iteration-level LLM servers exploit between decode tokens.

`RecyclePolicy` makes the SCHEDULER own that loop. With
`Scheduler(recycle_policy=RecyclePolicy(...))` the executor compiles an
embed+first-pass executable plus a single-recycle step executable
(`FoldExecutor.run_init` / `run_step`; `predict.fold_init` /
`fold_step` are the underlying programs, the same pass `predict.fold`
loops over, so step-loop numerics match the opaque path EXACTLY when no
early exit fires), and between steps the scheduler can:

- EARLY-EXIT converged elements: when an element's inter-recycle delta
  (max of mean-abs CA displacement over its real residues and max-abs
  confidence change) drops below `converge_tol`, its ticket resolves
  NOW with the current coords/confidence (`FoldResponse.recycles` says
  how many iterations it actually ran) and the survivor batch is
  re-packed; when every real element has converged the remaining steps
  are skipped entirely (`serve_recycles_skipped_total`);
- PREEMPT between recycles: tight-deadline traffic lands between a
  flagship batch's steps instead of behind its last recycle
  (`serve_preemptions_total`), so both traffic classes coexist on one
  fleet;
- STREAM progressive results: every step publishes a `FoldProgress`
  (coords + confidence + recycle index) to the caller's `FoldTicket`,
  and the fleet front door exposes the latest one on the existing
  long-poll (`GET /v1/result/<id>?progress=1` -> 206 + X-Recycle);
- ADMIT new work into freed rows (`continuous=True`): a row
  freed by early exit (or never filled at batch formation) is refilled
  mid-loop with a pending same-bucket request via a row-masked init
  program — the vLLM/Orca iteration-level pattern with recycles as our
  decode tokens; a saturated bucket's slice never idles a row
  (`serve_row_admissions_total`, `serve_rows_occupied_fraction`).

`converge_tol=0.0` (the default) disables early exit — every element
runs the full `num_recycles`, and because the step IS the opaque
fold's pass the served numerics are bit-identical to the opaque path. Only a
policy with `converge_tol > 0` can serve a result that differs from
the fixed-recycle fold, which is why the scheduler keys such results
under distinct cache keys (`RecyclePolicy.key_extras` feeds
`fold_key(extras=)` — an early-exited result can never be served to a
caller demanding full recycles).

`Scheduler(recycle_policy=None)` — the default — is byte-for-byte the
pre-recycle-policy behavior: one opaque fold per batch, no step
programs, identical scrubbed `serve_stats()`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class RecyclePolicy:
    """How the scheduler drives the recycle loop.

    converge_tol: per-element convergence threshold on the
        inter-recycle delta (see `element_deltas`); an element retires
        as soon as its delta <= tol after at least `min_recycles`
        steps. 0.0 = never (early exit off; numerics match the opaque
        `lax.scan` fold exactly).
    min_recycles: floor on recycle iterations before early exit may
        fire (the embed pass is iteration 0 and never counts as a
        recycle). Only meaningful with converge_tol > 0.
    preempt: allow tight-deadline pending work to execute between this
        batch's recycles (it jumps the max_wait window — the whole
        point is jumping the queue). A preempting batch cannot itself
        be preempted, so preemption depth is bounded at 1.
    stream: publish per-recycle FoldProgress updates (coords +
        confidence) to each element's FoldTicket. Costs one host copy
        of the element's rows per step; off by default.
    continuous: continuous batching — when early exit (or
        an under-filled batch) leaves rows free mid-loop, ADMIT new
        same-bucket pending requests into those rows between recycles
        via the row-masked init program (`predict.fold_init_rows` /
        `FoldExecutor.run_init_rows`) instead of padding until the
        batch's last survivor finishes: survivor rows keep stepping at
        their own recycle depth, each row carries its own iteration
        index, and a hot bucket's slice never idles a row. Admission
        pulls from the pending queue in deadline/priority order
        through the existing cache -> coalesce -> HBM-admission front
        (a store hit never burns a row; an in-flight duplicate parks
        as a coalescing follower), and it composes with preemption:
        urgent same-bucket folds claim freed rows first, without
        needing a batch gap. Off by default; continuous=False is
        byte-for-byte the plain step-loop behavior (scrubbed
        serve_stats identity regression-pinned). Row-admitted results
        are row-independent through the model, so `continuous` never
        changes what is computed and does not split cache keys.
    cross_bucket: cross-bucket continuous batching (needs
        `continuous`) — when a host batch's freed rows outnumber its
        own bucket's pending queue, admit a pending request from a
        SHORTER bucket at the host batch's shape: the candidate is
        padded to the host bucket edge (the same per-row padding masks
        that already fold mixed lengths within a bucket), runs the
        row-masked init, and retires against its own age, byte-equal
        to folding the same request alone at the host shape. Every
        cross-bucket admit is PRICED by `serve.meshpolicy.
        AdmissionPricer`: padded step cost x the loop extension it
        causes vs the candidate's projected native-bucket queue delay,
        deadline urgency as a tiebreak, `cross_bucket_max_pad_frac` as
        the hard guard, and the HBM admission guard re-prices at the
        host shape. Off by default; cross_bucket=False is byte-for-
        byte the same-bucket behavior (scrubbed serve_stats
        identity regression-pinned).
    cross_bucket_max_pad_frac: refuse a cross-bucket candidate whose
        pad fraction at the host edge (1 - length/host_edge) exceeds
        this — a 12-residue fold in a 512 host row is almost all
        padding, and no queue delay justifies it.
    eager_form: admission-aware batch formation (needs
        `continuous`) — when a bucket's queue is thin, form its batch
        IMMEDIATELY instead of waiting out max_wait_ms, counting on
        mid-loop row admission to top the under-filled batch up:
        max_wait becomes a fallback, not a latency floor. Off by
        default.
    """

    converge_tol: float = 0.0
    min_recycles: int = 0
    preempt: bool = True
    stream: bool = False
    continuous: bool = False
    cross_bucket: bool = False
    cross_bucket_max_pad_frac: float = 0.75
    eager_form: bool = False

    def __post_init__(self):
        if self.converge_tol < 0:
            raise ValueError(
                f"converge_tol must be >= 0, got {self.converge_tol}")
        if self.min_recycles < 0:
            raise ValueError(
                f"min_recycles must be >= 0, got {self.min_recycles}")
        if not 0.0 <= self.cross_bucket_max_pad_frac <= 1.0:
            raise ValueError(
                f"cross_bucket_max_pad_frac must be in [0, 1], got "
                f"{self.cross_bucket_max_pad_frac}")
        if self.cross_bucket and not self.continuous:
            raise ValueError(
                "cross_bucket admission rides the continuous batcher: "
                "RecyclePolicy(cross_bucket=True) needs continuous=True")
        if self.eager_form and not self.continuous:
            raise ValueError(
                "eager_form counts on mid-loop admission to top the "
                "under-filled batch up: RecyclePolicy(eager_form=True) "
                "needs continuous=True")

    def affects_results(self) -> bool:
        """True when this policy can serve a result that differs from
        the fixed-full-recycle fold — exactly the converge_tol > 0
        case. Preemption and streaming change WHEN work happens, never
        what is computed, so they do not split cache keys."""
        return self.converge_tol > 0.0

    def key_extras(self) -> Optional[tuple]:
        """Cache-key contribution (`cache.keys.fold_key(extras=)`).
        None when the policy cannot change results, so tol-0 /
        policy-off schedulers (and offline `fold_and_write` callers)
        keep sharing entries; a result-affecting policy keys under
        ("recycle_policy", tol, min_recycles) so an early-exited result
        is never served to a caller demanding full recycles."""
        if not self.affects_results():
            return None
        return ("recycle_policy", float(self.converge_tol),
                int(self.min_recycles))

    def snapshot(self) -> dict:
        return {"converge_tol": self.converge_tol,
                "min_recycles": self.min_recycles,
                "preempt": self.preempt,
                "stream": self.stream,
                "continuous": self.continuous,
                "cross_bucket": self.cross_bucket,
                "cross_bucket_max_pad_frac":
                    self.cross_bucket_max_pad_frac,
                "eager_form": self.eager_form}


def element_deltas(prev_coords: np.ndarray, prev_conf: np.ndarray,
                   coords: np.ndarray, conf: np.ndarray,
                   lengths: Sequence[int],
                   rows: Optional[Sequence[int]] = None) -> List[float]:
    """Per-element convergence signal between two consecutive recycle
    states: max(mean |Δcoords| over the element's real residues,
    max |Δconfidence|). Mean-abs displacement (not max) for coords so
    one flexible terminal residue cannot hold a converged core hostage;
    max for confidence because it is already per-residue bounded in
    [0, 1]. Padding rows/residues are excluded — they carry garbage
    that must not gate real elements. `rows` maps element position to
    its batch row (default: position == row — the dense-prefix case);
    the scheduler passes the live row map when retired rows stay in
    place (multi-chip leases skip physical repacking)."""
    out = []
    for i, n in enumerate(lengths):
        n = int(n)
        r = i if rows is None else int(rows[i])
        if n <= 0:
            out.append(0.0)
            continue
        dc = float(np.abs(coords[r, :n] - prev_coords[r, :n]).mean())
        df = float(np.abs(conf[r, :n] - prev_conf[r, :n]).max())
        out.append(max(dc, df))
    return out


def repack_rows(state, rows: Sequence[int], batch_size: int):
    """Gather survivor rows to the front of the carried FoldStepState
    (and return the same row order for the batch tensors): retired
    rows stop occupying live row slots, so the survivor batch stays a
    dense prefix and per-step host fetches/convergence bookkeeping
    slice `[:len(rows)]`. The batch shape is CLOSED (always padded to
    max_batch_size), so rows must be padded back to `batch_size`; the
    pad index repeats the last survivor — its output is never read.

    Device-side gather on the batch axis only (`index_select` over each
    tensor of the carry, the index built on that tensor's device)."""
    from alphafold2_tpu_torch.predict import tree_flatten, tree_unflatten

    if not rows:
        raise ValueError("repack_rows needs at least one survivor")
    idx_list = list(rows) + [rows[-1]] * (batch_size - len(rows))
    leaves, treedef = tree_flatten(state)
    return tree_unflatten(treedef, [_take_rows(x, idx_list)
                                    for x in leaves]), idx_list


def _take_rows(x, idx_list: Sequence[int]):
    """Rows `idx_list` of tensor `x` along its first axis (a copy)."""
    import torch

    idx = torch.as_tensor(np.asarray(idx_list, np.int64), device=x.device)
    return x.index_select(0, idx)


def repack_batch(batch: dict, idx_list: Sequence[int]) -> dict:
    """Re-pack the assembled batch tensors with the same row order
    `repack_rows` chose, so the step program's inputs and its carried
    state stay row-aligned. Only the canonical input keys are carried
    over — auxiliary keys (e.g. the executor's cached device placement)
    are row-stale by definition and must be dropped."""
    return {k: (None if batch[k] is None else _take_rows(batch[k], idx_list))
            for k in ("seq", "mask", "msa", "msa_mask")}


def steps_saved(num_recycles: int, executed: int) -> int:
    """Batch-level recycle steps skipped by early exit."""
    return max(0, int(num_recycles) - int(executed))
