"""Per-bucket mesh policy: match each length bucket to a device slice
(counterpart of `alphafold2_tpu/serve/meshpolicy.py`: parameter bytes
and the dtype come from the model, the device pool from the caller or
every visible card (`visible_devices`), and the memory budget from the
card's `total_memory` unless `hbm_gb` is given).

The serving insight (ParaFold: match each workload to the pool shape
that fits it; FastFold DAP: shard the O(L^2) pair representation at
inference) is that one executor topology cannot serve both ends of the
length distribution well:

- SHORT buckets saturate a single chip at batch 1 — spreading them over
  a mesh buys nothing and costs collective latency, so they stay on a
  1-chip slice (and, with several 1-chip slices free, fold CONCURRENTLY
  instead of queueing behind each other);
- LONG/flagship buckets are HBM-bound: the pair track is O(L^2) in
  activations, so past the single-chip ceiling the fold must 2-D shard
  the pair axes (`parallel.mesh` i x j) across a multi-chip slice or it
  simply cannot be served.

`MeshPolicy` is the bucket -> slice-shape map the `serve.Scheduler`
consults. Built explicitly (`MeshPolicy({64: 1, 512: 4})`) or derived
(`MeshPolicy.from_model`) from an analytic HBM footprint
(`FoldMemoryModel`) that picks the smallest power-of-two slice whose
per-device bytes fit — and marks buckets no configured slice can hold,
which the scheduler's admission guard rejects as status "too_large"
instead of dying in a CUDA OOM mid-batch.

`DeviceSliceAllocator` hands out DISJOINT aligned device groups
(`SliceLease`) so batches on different slices execute concurrently;
the scheduler holds one lease per in-flight batch.

Everything here is policy + bookkeeping: nothing runs on a device, and
a scheduler constructed with `mesh_policy=None` never touches it. A
slice wider than the pool is clamped to it as the JAX package clamps it
on a one-device host; the executor runs a multi-device slice on one
rank process per device (`serve.slices`).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

MeshShape = Tuple[int, int]          # (i, j) pair-axis factorization


def factor_chips(n: int) -> MeshShape:
    """Canonical (i, j) factorization of an n-chip slice: both powers of
    two, i <= j, i * j == n — the squarest face, so ring collectives
    over the sharded pair axes stay short on an ICI torus."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"slice size must be a power of two, got {n}")
    i = 1
    while (i * 2) * (i * 2) <= n:
        i *= 2
    return (i, n // i)


def slice_face(n: int, devices: Sequence[object] = ()) -> MeshShape:
    """The (i, j) face of an n-device slice of `devices`. On cards the
    rows stay whole, (1, n): cuBLAS picks an fp32 GEMM by its shape, so
    a rank that projects a block of the residues' rows (i > 1) rounds
    otherwise than one card, and recycling turns that rounding into
    angstroms, while a 1 x n slice folds bit-equal to one card (PERF.md
    §6). Elsewhere (a CPU pool) the JAX package's squarest face,
    `factor_chips`. An explicit (i, j) is kept as given
    (`normalize_shape`)."""
    face = factor_chips(n)      # raises unless n is a power of two
    return (1, n) if _on_cards(devices) else face


def _on_cards(devices: Sequence[object]) -> bool:
    import torch
    try:
        return bool(devices) and all(torch.device(d).type == "cuda"
                                     for d in devices)
    except (RuntimeError, TypeError):
        return False


def normalize_shape(shape: Union[int, Sequence[int]],
                    devices: Sequence[object] = ()) -> MeshShape:
    """Accept an int chip count (its `slice_face` over `devices`) or an
    explicit (i, j) pair."""
    if isinstance(shape, int):
        return slice_face(shape, devices)
    i, j = (int(x) for x in shape)
    if i < 1 or j < 1:
        raise ValueError(f"mesh shape must be positive, got {(i, j)}")
    return (i, j)


# the JAX package's per-device budget, kept only for a CPU pool, which
# has no device memory to read; a pool of cards prices each card's own
# `total_memory` (hbm_gb=None)
CPU_HBM_GB = 16.0


def visible_devices(device=None) -> list:
    """A process's device pool: every visible card, or the CPU when
    `device` is the CPU (a raise without a card otherwise, as entry
    points raise)."""
    import torch

    from alphafold2_tpu_torch.device import resolve_device
    if device is not None and torch.device(device).type == "cpu":
        return [torch.device("cpu")]
    resolve_device(None)
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def device_share(pool: Sequence[object], index: int,
                 count: int) -> list:
    """Replica `index`'s contiguous 1/`count` chunk of `pool` (the last
    chunk when the pool has fewer), so co-hosted replicas never share a
    card."""
    pool = list(pool)
    chunk = max(1, len(pool) // max(int(count), 1))
    index = int(index)
    return pool[index * chunk:(index + 1) * chunk] or pool[-chunk:]


def default_hbm_gb(device) -> Optional[float]:
    """The `hbm_gb` a pool on `device` is priced with when none is
    given: None (the card's own memory) on a card, `CPU_HBM_GB` on the
    CPU."""
    import torch
    return CPU_HBM_GB if torch.device(device).type == "cpu" else None


def mesh_label(shape: MeshShape) -> str:
    """Stable human/metric label: (2, 4) -> '2x4'."""
    return f"{shape[0]}x{shape[1]}"


def chips_of(shape: MeshShape) -> int:
    return shape[0] * shape[1]



@dataclass
class FoldMemoryModel:
    """Analytic per-device HBM footprint of one fold batch.

    Deliberately a handful of named terms, not a compiler: the point is
    a monotone, explainable admission signal (BENCH_r05 showed the real
    flagship at 15.63/16 GB on a TPU v5e — the terms below are the ones
    that put it there).

    Terms, for a (B, L, M) batch on a `chips`-device slice:

    - params: replicated per device (tensor-parallel placement shards
      some projections, but counting them full keeps the guard
      conservative);
    - pair track: B * L^2 * (dim + heads) * dtype_bytes * pair_live —
      activations plus attention logits; `pair_live` is the scan+remat
      live-set coefficient (residual + recyclables + workspace), NOT
      depth — remat keeps the live set O(1) in depth. 2-D sharded over
      the slice, so divided by `chips`;
    - msa track: B * M * L * dim * dtype_bytes * msa_live, sharded over
      the i axis ONLY (msa_spec/fold_input_specs place nothing on j),
      so it divides by the slice's i factor, not the chip count;
    - distogram head: B * L^2 * distogram_buckets * 4, counted
      replicated — it is the output the host gathers;
    - recycle carry (step-mode scheduling only, `carry_recyclables=`):
      the scheduler-owned recycle loop holds the PREVIOUS step's
      `Recyclables` (pairwise repr + single row + coords) live across
      the step program's execution — the opaque fold keeps that
      carry inside one call where the pair_live
      coefficient already prices it, but step mode double-buffers it
      at the seam (prev state alive while the next computes), so a
      step-scheduled bucket pays `recycle_carry_live` extra copies of
      the pairwise term (sharded like the pair track) plus the
      unsharded single-row/coords terms.
    """

    param_bytes: int
    dim: int
    heads: int = 8
    dtype_bytes: int = 4
    pair_live: float = 6.0
    msa_live: float = 4.0
    recycle_carry_live: float = 2.0
    distogram_buckets: int = 37
    hbm_bytes_per_device: int = 16 << 30

    @classmethod
    def from_model(cls, model, params=None, hbm_gb: Optional[float] = None,
                   **overrides) -> "FoldMemoryModel":
        """Terms from the port's model: parameter bytes of
        `model.parameters()` (or of `params`, an iterable of tensors or
        arrays, when given), activation bytes per element from the
        model's dtype. `hbm_gb=None` reads the memory of the model's
        card (`torch.cuda.get_device_properties(...).total_memory`)."""
        import torch

        leaves = model.parameters() if params is None else params
        param_bytes = sum(
            x.numel() * x.element_size() if isinstance(x, torch.Tensor)
            else int(x.size) * x.dtype.itemsize for x in leaves)
        dtype = getattr(model, "dtype", None)
        dtype_bytes = 2 if dtype in (torch.bfloat16, torch.float16) else 4
        if hbm_gb is not None:
            budget = int(hbm_gb * (1 << 30))
        elif model.device.type == "cuda":
            budget = torch.cuda.get_device_properties(
                model.device).total_memory
        else:
            raise ValueError(f"no device memory to read on "
                             f"{model.device}: pass hbm_gb")
        kwargs = dict(param_bytes=int(param_bytes), dim=int(model.dim),
                      heads=int(getattr(model, "heads", 8)),
                      dtype_bytes=dtype_bytes,
                      hbm_bytes_per_device=budget)
        kwargs.update(overrides)
        return cls(**kwargs)

    def fold_bytes(self, bucket_len: int, batch_size: int,
                   msa_depth: int, chips: int = 1,
                   shape: Optional[MeshShape] = None,
                   carry_recyclables: bool = False,
                   continuous: bool = False) -> int:
        """Estimated peak per-device bytes for one fold batch. Pass the
        actual slice `shape` when known (admits() does) — the MSA track
        divides by its i factor only; a bare `chips` count prices the
        canonical squarest factorization. `carry_recyclables` adds the
        step-mode recycle carry (the scheduler passes it iff a
        RecyclePolicy drives the loop). `continuous` (implies step
        mode) additionally prices the row-admission seam:
        `fold_init_rows` holds the full-batch fresh init output live
        alongside the old carried state while the per-row select
        builds the merged state, one extra single-buffered copy of the
        carry on top of `recycle_carry_live`'s double-buffering."""
        L, B, M = int(bucket_len), int(batch_size), int(msa_depth)
        if shape is not None:
            i = max(int(shape[0]), 1)
            chips = max(int(shape[0]) * int(shape[1]), 1)
        else:
            chips = max(int(chips), 1)
            try:
                i = factor_chips(chips)[0]
            except ValueError:
                i = 1
        pair = B * L * L * (self.dim + self.heads) * self.dtype_bytes \
            * self.pair_live
        msa = B * max(M, 1) * L * self.dim * self.dtype_bytes \
            * self.msa_live
        dist = B * L * L * self.distogram_buckets * 4
        total = self.param_bytes + dist + pair / chips + msa / i
        if carry_recyclables or continuous:
            total += self.carry_bytes(L, B, chips=chips)
        if continuous:
            # the admission seam's extra live copy (one, not the
            # carry's recycle_carry_live-many)
            total += self.carry_bytes(L, B, chips=chips) \
                / max(self.recycle_carry_live, 1.0)
        return int(total)

    def carry_bytes(self, bucket_len: int, batch_size: int,
                    chips: int = 1) -> int:
        """Per-device bytes of the step loop's carried `Recyclables`
        ALONE (pairwise repr sharded over the slice + unsharded single
        row/coords, double-buffered per `recycle_carry_live`). This is
        what a SUSPENDED step loop keeps HBM-resident across a
        preemption yield — the concurrent-peak term the memory-aware
        preemption admission prices on top of the urgent batch's
        `fold_bytes`."""
        L, B = int(bucket_len), int(batch_size)
        chips = max(int(chips), 1)
        carry_pair = B * L * L * self.dim * self.dtype_bytes / chips
        carry_rest = B * L * (self.dim + 3) * self.dtype_bytes
        return int(self.recycle_carry_live * (carry_pair + carry_rest))

    def fits(self, bucket_len: int, batch_size: int, msa_depth: int,
             chips: int = 1,
             shape: Optional[MeshShape] = None,
             carry_recyclables: bool = False,
             continuous: bool = False) -> bool:
        return self.fold_bytes(
            bucket_len, batch_size, msa_depth, chips, shape,
            carry_recyclables=carry_recyclables,
            continuous=continuous) \
            <= self.hbm_bytes_per_device


@dataclass
class AdmissionDecision:
    """One priced cross-bucket admission verdict."""

    admit: bool
    reason: str            # "pad_frac" | "deadline" | "native_imminent"
    #                        | "priced" | "padded_cost"
    pad_frac: float
    excess_s: float        # padding-share compute the admit would waste
    native_delay_s: float  # projected wait for a native-bucket fold


@dataclass
class AdmissionPricer:
    """Prices the padding-vs-dead-row trade of CROSS-BUCKET row
    admission: may a pending request from a shorter bucket
    ride a freed row of a longer host batch, padded to the host edge?

    The trade, made explicit instead of unconditional:

    - a freed row is FREE compute for as long as the host loop runs
      anyway (a step costs the same whether a row is live or dead), so
      a candidate whose remaining recycles fit inside the host loop's
      remaining steps rides at zero marginal cost — strictly better
      than a dead row plus a separate native-bucket batch formation
      (the ParaFold keep-the-accelerator-busy thesis at iteration
      level);
    - a candidate that EXTENDS the loop pays O(L_host^2) per extension
      step where a native fold would have paid O(L_native^2) — only
      the padding share of those extension steps is waste, and it is
      priced against the candidate's projected native-bucket queue
      delay (the latency it buys);
    - deadline urgency is the tiebreak: a candidate that would MISS
      its deadline waiting for a native batch admits regardless of
      cost;
    - `max_pad_frac` is the hard guard: past it, no queue delay
      justifies the padding (a 12-residue fold in a 512 host row).

    memory: optional FoldMemoryModel whose pair/MSA terms weight the
        relative step cost; None prices with representative dim/heads
        (the RATIO of host to native cost is what matters, and it is
        dominated by the O(L^2) term either way).
    max_pad_frac: see above; the scheduler threads
        `RecyclePolicy.cross_bucket_max_pad_frac` here.
    """

    memory: Optional[FoldMemoryModel] = None
    max_pad_frac: float = 0.75

    def step_cost(self, bucket_len: int, batch_size: int,
                  msa_depth: int) -> float:
        """Relative per-step compute of one (B, L, M) batch: the
        O(L^2) pair + MSA terms of the memory model as a FLOP proxy
        (the same terms the HBM guard prices — bytes and FLOPs share
        the activation shapes)."""
        dim = self.memory.dim if self.memory is not None else 64
        heads = self.memory.heads if self.memory is not None else 8
        L, B, M = int(bucket_len), int(batch_size), int(msa_depth)
        return float(B * L * L * (dim + heads)
                     + B * max(M, 1) * L * dim)

    def price(self, *, native_len: int, host_len: int, length: int,
              batch_size: int, msa_depth: int,
              candidate_steps: int, remaining_host_steps: int,
              native_delay_s: float,
              deadline_slack_s: Optional[float],
              host_step_s: float) -> AdmissionDecision:
        """Decide one candidate.

        native_len/host_len: the candidate's own bucket edge and the
            host batch's edge; `length` is its real residue count (pad
            fraction is priced at the host edge).
        candidate_steps: recycles the candidate will run after its
            row-masked init (its full depth — it enters at age 0).
        remaining_host_steps: steps the host loop runs regardless
            (max over surviving rows' remaining depth); the candidate
            rides these for free, and only the excess extends the
            loop.
        native_delay_s: the scheduler's projection of how long this
            candidate would wait for a native-bucket fold (batch
            formation window + worker/slice availability). <= 0 means
            a native batch can form RIGHT NOW — stealing its member
            for padded compute buys nothing.
        deadline_slack_s: seconds until the candidate's deadline
            (None = no deadline).
        host_step_s: measured per-step latency of the host bucket
            (EWMA; 0.0 before the first measurement prices extension
            as free, so a cold loop leans toward admitting).
        """
        pad_frac = 1.0 - float(length) / float(host_len)
        if pad_frac > self.max_pad_frac:
            return AdmissionDecision(False, "pad_frac", pad_frac,
                                     0.0, native_delay_s)
        # deadline urgency tiebreak: waiting for the native bucket
        # would miss the deadline outright — admit whatever the cost
        if deadline_slack_s is not None \
                and deadline_slack_s < native_delay_s:
            return AdmissionDecision(True, "deadline", pad_frac,
                                     0.0, native_delay_s)
        if native_delay_s <= 0.0:
            return AdmissionDecision(False, "native_imminent", pad_frac,
                                     0.0, native_delay_s)
        extension = max(0, int(candidate_steps)
                        - int(remaining_host_steps))
        cost_ratio = self.step_cost(native_len, batch_size, msa_depth) \
            / max(self.step_cost(host_len, batch_size, msa_depth), 1.0)
        excess_s = extension * max(host_step_s, 0.0) \
            * (1.0 - min(cost_ratio, 1.0))
        if excess_s <= native_delay_s:
            return AdmissionDecision(True, "priced", pad_frac,
                                     excess_s, native_delay_s)
        return AdmissionDecision(False, "padded_cost", pad_frac,
                                 excess_s, native_delay_s)

    def snapshot(self) -> dict:
        return {"max_pad_frac": self.max_pad_frac,
                "memory": self.memory is not None}


@dataclass
class SliceLease:
    """One acquired device slice; hold it for the duration of a batch.

    `held` tracks whether THIS lease currently owns its span (the
    allocator flips it on acquire/release): release() is idempotent
    against it, so an exception between a preemption yield's release
    and its re-acquire can never make a failure-path release free a
    span that another batch has since leased (— every
    failure path releases exactly what it holds, nothing more)."""

    devices: List[object]
    shape: MeshShape
    start: int                       # first device index in the pool
    held: bool = True

    @property
    def label(self) -> str:
        return mesh_label(self.shape)


class DeviceSliceAllocator:
    """Disjoint, aligned device slices over one device pool.

    Slices of size n start at multiples of n (aligned), so the same
    slice identities recur under low load and compiled executables
    (bound to concrete devices) are reused instead of re-minted per
    acquire. Thread-safe; `acquire` is non-blocking (the scheduler
    worker only forms batches it can place), `acquire_blocking` exists
    for warmup.
    """

    def __init__(self, devices: Sequence[object]):
        self.devices = list(devices)
        if not self.devices:
            raise ValueError("allocator needs at least one device")
        self._busy = [False] * len(self.devices)
        self._cond = threading.Condition()

    @property
    def total_devices(self) -> int:
        return len(self.devices)

    @property
    def busy_devices(self) -> int:
        with self._cond:
            return sum(self._busy)

    def _find(self, size: int) -> Optional[int]:
        """Caller holds self._cond: first free aligned group, or None."""
        for start in range(0, len(self.devices) - size + 1, size):
            if not any(self._busy[start:start + size]):
                return start
        return None

    def can_allocate(self, shape: MeshShape) -> bool:
        size = chips_of(shape)
        if size > len(self.devices):
            return False
        with self._cond:
            return self._find(size) is not None

    def slices(self, shape: MeshShape) -> List[List[object]]:
        """Every aligned device group this shape can ever be leased —
        the set warmup must precompile, because an executable is bound
        to its concrete devices and a batch that lands on a cold slice
        pays a fresh program build mid-serving."""
        size = chips_of(shape)
        if size > len(self.devices):
            return []
        return [self.devices[start:start + size]
                for start in range(0, len(self.devices) - size + 1,
                                   size)]

    def acquire(self, shape: MeshShape) -> Optional[SliceLease]:
        size = chips_of(shape)
        if size > len(self.devices):
            return None
        with self._cond:
            start = self._find(size)
            if start is None:
                return None
            for k in range(start, start + size):
                self._busy[k] = True
        return SliceLease(self.devices[start:start + size], shape, start)

    def acquire_blocking(self, shape: MeshShape,
                         timeout_s: Optional[float] = None) -> SliceLease:
        size = chips_of(shape)
        if size > len(self.devices):
            raise ValueError(
                f"slice of {size} devices > pool of {len(self.devices)}")
        with self._cond:
            while True:
                start = self._find(size)
                if start is not None:
                    for k in range(start, start + size):
                        self._busy[k] = True
                    return SliceLease(self.devices[start:start + size],
                                      shape, start)
                if not self._cond.wait(timeout=timeout_s):
                    raise TimeoutError(
                        f"no free {mesh_label(shape)} slice within "
                        f"{timeout_s}s")

    def acquire_span(self, lease: SliceLease) -> SliceLease:
        """Blocking re-acquire of the EXACT device span of a released
        lease (step-mode preemption: the loop's carried state and its
        compiled executables are bound to those devices, so after
        yielding the slice for a preemption gap it must come back to
        the same chips). Waits indefinitely — the holder released
        everything before waiting, so there is no cycle to deadlock
        on, and whoever borrowed the span releases it after a bounded
        batch. Returns the SAME lease object re-armed (`held` flips
        back on), so every reference a caller's finally-block holds
        releases the span that is actually leased — a new object here
        would leave the original reference pointing at a dead lease
        and strand the re-acquired span on any later failure path
       ."""
        size = chips_of(lease.shape)
        with self._cond:
            while any(self._busy[lease.start:lease.start + size]):
                self._cond.wait()
            for k in range(lease.start, lease.start + size):
                self._busy[k] = True
            lease.held = True
        return lease

    def release(self, lease: SliceLease):
        """Idempotent: releasing a lease that is not currently held
        (already released for a preemption yield, or double-released
        by racing failure paths) is a no-op — it must never free a
        span another batch has since acquired."""
        size = chips_of(lease.shape)
        with self._cond:
            if not lease.held:
                return
            lease.held = False
            for k in range(lease.start, lease.start + size):
                self._busy[k] = False
            self._cond.notify_all()

    def snapshot(self) -> dict:
        with self._cond:
            busy = sum(self._busy)
        return {"total_devices": len(self.devices), "busy_devices": busy}


class MeshPolicy:
    """bucket_len -> device-slice shape, plus the HBM admission model.

    shapes: mapping of bucket edge -> slice (an int chip count, whose
        face `slice_face` picks for the pool, or an explicit (i, j)
        pair). Buckets absent from the map default to a
        single chip. Shapes larger than the device pool are CLAMPED to
        the largest power-of-two slice the pool holds (recorded in
        `clamped` and the snapshot) so a policy written for an 8-chip
        host degrades cleanly on a 1-device CI runner.
    devices: the device pool to slice (default: every visible card,
        `visible_devices()`; a raise without one).
    memory: optional FoldMemoryModel backing `admits()`; None admits
        everything (the guard is opt-in like everything else here).
    """

    def __init__(self, shapes: Mapping[int, Union[int, Sequence[int]]],
                 devices: Optional[Sequence[object]] = None,
                 memory: Optional[FoldMemoryModel] = None):
        if devices is None:
            devices = visible_devices()
        self.devices = list(devices)
        n_dev = len(self.devices)
        cap = 1
        while cap * 2 <= n_dev:
            cap *= 2
        self.shapes: Dict[int, MeshShape] = {}
        self.clamped: Dict[int, str] = {}
        for bucket, s in shapes.items():
            shape = normalize_shape(s, self.devices)
            if chips_of(shape) > n_dev:
                self.clamped[int(bucket)] = mesh_label(shape)
                shape = slice_face(cap, self.devices)
            self.shapes[int(bucket)] = shape
        self.memory = memory

    @classmethod
    def from_model(cls, model, params, buckets: Sequence[int],
                   max_batch: int = 1, msa_depth: int = 0,
                   hbm_gb: Optional[float] = None,
                   devices: Optional[Sequence[object]] = None,
                   max_chips: Optional[int] = None,
                   carry_recyclables: bool = False,
                   continuous: bool = False,
                   **memory_overrides) -> "MeshPolicy":
        """Derive the policy analytically: for each bucket edge, the
        smallest power-of-two slice whose estimated per-device footprint
        fits `hbm_gb`. A bucket that does not fit even the largest slice
        still gets that slice in the map but fails `admits()` — the
        scheduler rejects it at submit as "too_large".

        carry_recyclables: size slices for STEP-MODE serving (a
        RecyclePolicy will drive the loop): the fitting loop then
        prices the carried Recyclables exactly like the admission
        guard will, so a bucket whose opaque fold just fits an n-chip
        slice is assigned the bigger slice it actually needs instead
        of being auto-sized into a guaranteed "too_large".
        `continuous` does the same for the continuous batcher's
        row-admission seam. The pool defaults to `visible_devices` of
        the model's device: every card, or the CPU."""
        if devices is None:
            devices = visible_devices(model.device)
        edges = getattr(buckets, "edges", buckets)
        memory = FoldMemoryModel.from_model(model, params, hbm_gb=hbm_gb,
                                            **memory_overrides)
        cap = min(max_chips or len(devices), len(devices))
        shapes: Dict[int, int] = {}
        for edge in edges:
            n = 1
            while not memory.fits(edge, max_batch, msa_depth, n,
                                  shape=slice_face(n, devices),
                                  carry_recyclables=carry_recyclables,
                                  continuous=continuous) \
                    and n * 2 <= cap:
                n *= 2
            shapes[int(edge)] = n
        return cls(shapes, devices=devices, memory=memory)

    @classmethod
    def parse(cls, spec: str, model=None, params=None, buckets=None,
              max_batch: int = 1, msa_depth: int = 0,
              hbm_gb: Optional[float] = None,
              devices: Optional[Sequence[object]] = None,
              carry_recyclables: bool = False,
              continuous: bool = False,
              **memory_overrides) -> Optional["MeshPolicy"]:
        """The ONE parser for every `--mesh-policy` surface (the
        loadtest CLI, `fleet.ProcFleet` replica configs,
        `fleet.procfleet.replica_main`): "" -> None (single-chip,
        today's behavior), "auto" -> `from_model` with the analytic
        HBM budget (requires model/params/buckets), or an explicit
        "BUCKET=CHIPS,..." map, e.g. "32=1,128=4". Raises ValueError
        on a malformed spec — a typo'd policy must fail loudly at
        boot, not silently serve single-chip."""
        spec = (spec or "").strip()
        if not spec:
            return None
        if spec == "auto":
            if model is None or buckets is None:
                raise ValueError(
                    "--mesh-policy auto needs model/buckets")
            return cls.from_model(model, params, buckets,
                                  max_batch=max_batch,
                                  msa_depth=msa_depth, hbm_gb=hbm_gb,
                                  devices=devices,
                                  carry_recyclables=carry_recyclables,
                                  continuous=continuous,
                                  **memory_overrides)
        shapes = {}
        for kv in spec.split(","):
            try:
                bucket, chips = kv.split("=")
                shapes[int(bucket)] = int(chips)
            except ValueError:
                raise ValueError(
                    f"bad --mesh-policy entry {kv!r} "
                    f"(want BUCKET=CHIPS, e.g. 32=1,128=4)")
        return cls(shapes, devices=devices)

    def shape_for(self, bucket_len: int) -> MeshShape:
        return self.shapes.get(int(bucket_len), (1, 1))

    def chips_for(self, bucket_len: int) -> int:
        return chips_of(self.shape_for(bucket_len))

    def admits(self, bucket_len: int, batch_size: int, msa_depth: int,
               carry_recyclables: bool = False,
               continuous: bool = False) -> bool:
        """False when the bucket's configured slice — already the
        largest one the policy was willing/able to assign — cannot hold
        the batch's analytic footprint. The scheduler maps False to
        status "too_large" at submit, and passes `carry_recyclables`
        iff a RecyclePolicy makes it run the step loop (whose carried
        Recyclables are extra live bytes the opaque fold never
        double-buffers) and `continuous` iff that policy also admits
        rows mid-loop (the row-masked init's select seam holds one
        more live copy of the carry — the guard must refuse a bucket
        that fits the plain step loop but would OOM on its first
        admission)."""
        if self.memory is None:
            return True
        return self.memory.fits(bucket_len, batch_size, msa_depth,
                                shape=self.shape_for(bucket_len),
                                carry_recyclables=carry_recyclables,
                                continuous=continuous)

    def allocator(self) -> DeviceSliceAllocator:
        return DeviceSliceAllocator(self.devices)

    def snapshot(self) -> dict:
        snap = {
            "devices": len(self.devices),
            "policy": {str(b): mesh_label(s)
                       for b, s in sorted(self.shapes.items())},
        }
        if self.clamped:
            snap["clamped"] = {str(b): lbl
                               for b, lbl in sorted(self.clamped.items())}
        if self.memory is not None:
            snap["hbm_bytes_per_device"] = self.memory.hbm_bytes_per_device
        return snap
