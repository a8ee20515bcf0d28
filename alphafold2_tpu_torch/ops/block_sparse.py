"""Block-skipping sparse attention for long serving buckets (counterpart
of `alphafold2_tpu/ops/block_sparse.py`).

Host half (numpy, a copy of the JAX package's): the block patterns
(`banded_block_pattern`, `contact_block_pattern`), their compression
into per-q-block column lists (`plan_block_pattern`), `KernelSpec` (one
attention-kernel choice, hashable, labelled exactly as the JAX package
labels it, so executor keys match) and the thread-local
`kernel_context` through which `predict` hands a spec to the model.

Device half: `block_sparse_attention`, the wrapper of kernel K2
(`csrc/block_sparse.cu`), and `block_sparse_reference`, its plain
version. Contract, shared by both:

    out = softmax_j(scale * q . k^T + bias, masked -> -1e9, dead -> -inf) . v

- q, k, v: (B, N, D), heads folded innermost into B, N = block * nqb.
- Only the live blocks of the (nqb, nqb) pattern are computed; a dead
  block acts as -inf. Every q-block keeps at least one live block.
- bias: optional (Bb, N, N) fp32, unrepeated: query batch row i reads
  bias row (i // (bias_repeat * heads)) * heads + i % heads.
- k_mask: optional (B // heads, N) bool; a masked key's logit is
  replaced by -1e9 after the bias add. There is no query mask: outputs
  at padded query rows are unspecified. A row whose live keys are all
  masked averages over its live keys only (the dense path averages over
  every key, so the two differ there).
- scale defaults to D^-1/2; the model passes 1.0 (q arrives pre-scaled).
- fp32 softmax and accumulators; the output has q's dtype. In bf16 the
  kernel rounds the softmax weights to bf16 before the product with v
  (the tensor cores take bf16 operands); the plain version does not.
  Forward only.

A `BlockPlan` is a pattern's column list on one device: `cols` (rows,
T) int32 and the per-row live `counts` (rows,) int32, over blocks of the
plan's `kernel_block` (below), for K2's `mma.sync` layout; and the unit
plan of its warpgroup layout (`unit_plan`): per unit of 64 query rows,
the union of its query blocks' live key blocks with an owner mask per
entry (bit w: warp w's 16 rows own that key block), the entry count, and
the units in order of entry count, heaviest first. The serving executor
uploads one per key when it builds the key, so no launch copies the plan
to the card.

Which shape takes which route on the card (`block_sparse_attention`):

- block in {16, 32, 64, 128}: K2 over the plan as it is, bf16 in the
  layout `kernel_layout` picks (the warpgroup kernel of
  `csrc/block_sparse.cu` on TMA, mbarrier rings and `wgmma`, or the
  `mma.sync` tile of `csrc/attention_tile.cuh`), fp32 on the CUDA cores;
- any other block that is a multiple of 16 (48, 80, 96, ...): K2 over
  the same live set re-planned at `kernel_block`, the largest of those
  widths that divides the block (each live block becomes a square of
  live sub-blocks); the plan holds the re-planned columns;
- any other block (8, 24, 40, ...): kernel K1 (`ops.attention`) with the
  pattern as a -1e9 additive bias on top of the caller's bias, counted
  as a K1 launch. Exact wherever a query row has an unmasked live key
  (every q-block keeps a live block). A row whose live keys are all
  masked would average over every key under that bias, so the wrapper
  overwrites such rows with the mean of v over their live keys, as the
  contract gives (`_average_shut_rows`, O(B N D) on the card);
- D outside {16, 32, 64, 128}: zero-padded along D on either kernel
  (`ops.attention.pad_head_dim`), up to the next of those widths or,
  above 128, to a multiple of 128 on the kernels' sliced path (the
  output columns split across thread blocks).

There is no plain fallback on the card.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import threading
from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.ops import build
from alphafold2_tpu_torch.ops.attention import (_DTYPE_CODES, F32,
                                                HEAD_DIMS, MASK_VALUE, TILE,
                                                WARPGROUP, LaunchCounter,
                                                check_head_dim,
                                                fused_attention,
                                                pad_head_dim)

BLOCKS = (16, 32, 64, 128)
BACKENDS = ("auto", "masked")
# query rows a unit of the warpgroup layout (one warpgroup), and its warps
UNIT_ROWS, UNIT_WARPS = 64, 4
# the most shared memory the warpgroup kernel gives a unit plan
# (kPlanBytes in csrc/block_sparse.cu)
UNIT_PLAN_BYTES = 32 * 1024
# BlockPlan's unit plan, in the order the kernel takes it
UNIT_FIELDS = ("unit_cols", "unit_owners", "unit_counts", "unit_order")

launch_count = LaunchCounter()


def banded_block_pattern(n_blocks: int, window: int = 1,
                         num_global: int = 1) -> np.ndarray:
    """(n_blocks, n_blocks) bool block pattern: attend within +-window
    blocks of the diagonal plus the first num_global global blocks."""
    bi = np.arange(n_blocks)
    local = np.abs(bi[:, None] - bi[None, :]) <= window
    glob = (bi < num_global)[:, None] | (bi < num_global)[None, :]
    return local | glob


def plan_block_pattern(pattern: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Compress a (nqb, nkb) boolean block pattern into a padded column
    plan: cols[i, t] = index of the t-th live k-block of q-block i,
    valid[i, t] = 1 where the slot is real. Every q-block must keep at
    least one live k-block (softmax over an empty row is undefined)."""
    pattern = np.asarray(pattern, dtype=bool)
    counts = pattern.sum(axis=1)
    if counts.min() < 1:
        raise ValueError("every q block needs >= 1 live k block")
    t_max = int(counts.max())
    nqb = pattern.shape[0]
    cols = np.zeros((nqb, t_max), np.int32)
    valid = np.zeros((nqb, t_max), np.int32)
    for i in range(nqb):
        live = np.nonzero(pattern[i])[0]
        cols[i, :live.size] = live
        valid[i, :live.size] = 1
    return cols, valid


def kernel_block(block: int) -> int:
    """The block K2 runs a `block`-sized pattern at: the block itself
    when K2 has that instance, else the largest instance dividing it; 0
    when none does (the pattern then runs on K1 as a bias)."""
    divisors = [b for b in BLOCKS if block % b == 0]
    return max(divisors) if divisors else 0


def kernel_layout(block: int, n: int, d: int, dtype: torch.dtype,
                  has_bias: bool) -> int:
    """The layout a K2 launch at (kernel block, N, launch head width d,
    dtype) takes (the constants of `ops.attention`), chosen from device
    times on the H100 (PERF.md): F32 for fp32 (the CUDA-core kernel);
    WARPGROUP for bf16 at d in HEAD_DIMS and a block in BLOCKS (TMA,
    mbarrier rings, `wgmma`, units of 64 query rows); TILE (the
    `mma.sync` tile) for the rest of bf16: the sliced path above d = 128,
    N below one unit's 64 rows, and a unit plan that could outgrow the
    kernel's UNIT_PLAN_BYTES of shared memory (N above ~2900 at block
    32)."""
    if dtype != torch.bfloat16:
        return F32
    units = -(-n // UNIT_ROWS)
    if d in HEAD_DIMS and block in BLOCKS and n >= UNIT_ROWS and \
            4 * units * (n // block + 2) <= UNIT_PLAN_BYTES:
        return WARPGROUP
    return TILE


def unit_plan(live: np.ndarray, block: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The warpgroup layout's units over a (nqb, nqb) live set at kernel
    block `block`: unit u is query rows 64u..64u+63 (four blocks of 16,
    two of 32, one of 64 or half of one of 128), warp w its rows
    64u+16w..64u+16w+15. Returns cols (units, T) int32, the union of the
    unit's query blocks' live key blocks in ascending order; owners
    (units, T) int32, bit w set where warp w's query block has that key
    block live (rows past N own nothing); counts (units,) int32, the
    entries of each unit; order (units,) int32, the units by count,
    heaviest first (ties in row order)."""
    live = np.asarray(live, dtype=bool)
    n = live.shape[0] * block
    units = -(-n // UNIT_ROWS)
    rows = []
    for u in range(units):
        owners = np.zeros(live.shape[1], np.int32)
        for w in range(UNIT_WARPS):
            r = u * UNIT_ROWS + 16 * w
            if r < n:
                owners |= live[r // block].astype(np.int32) << w
        rows.append(owners)
    counts = np.array([np.count_nonzero(o) for o in rows], np.int32)
    t = int(counts.max())
    cols = np.zeros((units, t), np.int32)
    owner = np.zeros((units, t), np.int32)
    for u, o in enumerate(rows):
        idx = np.nonzero(o)[0]
        cols[u, :idx.size] = idx
        owner[u, :idx.size] = o[idx]
    order = np.argsort(-counts, kind="stable").astype(np.int32)
    return cols, owner, counts, order


class BlockPlan(NamedTuple):
    """A block pattern's column list on one device (see module doc).
    `cols`/`counts` index blocks of `kernel_block` tokens (the pattern
    re-planned when its block has no K2 instance), and so do the unit
    plan's `unit_cols` (`unit_plan`, for the warpgroup layout); with
    `kernel_block` 0 the card runs K1, `bias` holds the pattern as an
    (n, n) fp32 0 / -1e9 additive bias and there is no unit plan."""

    pattern: np.ndarray        # (nqb, nqb) bool, host copy
    block: int
    cols: torch.Tensor         # (nqb * r, T) int32, r = block / kernel_block
    counts: torch.Tensor       # (nqb * r,) int32
    kernel_block: int
    bias: Optional[torch.Tensor]   # (n, n) fp32 when kernel_block is 0
    unit_cols: Optional[torch.Tensor] = None     # (units, Tu) int32
    unit_owners: Optional[torch.Tensor] = None   # (units, Tu) int32
    unit_counts: Optional[torch.Tensor] = None   # (units,) int32
    unit_order: Optional[torch.Tensor] = None    # (units,) int32

    @property
    def n(self) -> int:
        return self.block * self.pattern.shape[0]

    @classmethod
    def build(cls, pattern, block: int, device) -> "BlockPlan":
        pattern = np.asarray(pattern, dtype=bool)
        if pattern.ndim != 2 or pattern.shape[0] != pattern.shape[1]:
            raise ValueError(f"pattern must be square, got {pattern.shape}")
        block = int(block)
        kb = kernel_block(block)
        bias = None
        live = pattern
        if kb:
            r = block // kb
            live = np.kron(pattern, np.ones((r, r), bool))
        else:
            plan_block_pattern(pattern)          # validates every row
            bias = torch.as_tensor(np.where(token_mask(pattern, block),
                                            np.float32(0.0),
                                            np.float32(MASK_VALUE)),
                                   device=device)
        cols, valid = plan_block_pattern(live)
        units = [torch.as_tensor(a, device=device)
                 for a in unit_plan(live, kb)] if kb else [None] * 4
        return cls(pattern, block, torch.as_tensor(cols, device=device),
                   torch.as_tensor(valid.sum(axis=1, dtype=np.int32),
                                   device=device), kb, bias, *units)


def token_mask(pattern: np.ndarray, block: int) -> np.ndarray:
    """(n, n) bool token-level view of a block pattern."""
    return np.repeat(np.repeat(pattern, block, 0), block, 1)


@dataclass(frozen=True)
class KernelSpec:
    """One attention-kernel choice, static per executor key.

    pattern: (nqb, nkb) block pattern as a tuple of row tuples of bool
        (hashable; `pattern_array()` gives the numpy view). Every row
        keeps >= 1 live block.
    block: token block size. The spec covers attention whose attended
        axis has length n == block * nqb exactly.
    backend: "auto" (kernel K2 for CUDA tensors, its plain version for
        CPU tensors, decided by the tensor's device) or "masked" (dense
        compute through the fused attention, with the pattern as a -1e9
        additive bias: the numerics reference). The JAX package's
        "pallas" backend forces its kernel in interpret mode, which the
        port does not have; it raises.
    source: "static" (banded+global first-pass mask) or "contact"
        (planned from a first pass's distogram); observability only.
    """

    block: int
    pattern: Tuple[Tuple[bool, ...], ...]
    backend: str = "auto"
    source: str = "static"
    _label: str = field(default="", compare=False)

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"backend {self.backend!r} is not one of {BACKENDS} (the "
                f"port has no interpret mode, so no 'pallas' backend)")
        nqb = len(self.pattern)
        if nqb == 0 or any(len(r) != nqb for r in self.pattern):
            raise ValueError("pattern must be square and non-empty")
        if any(not any(r) for r in self.pattern):
            raise ValueError("every q block needs >= 1 live k block")

    @classmethod
    def from_pattern(cls, pattern, block: int, backend: str = "auto",
                     source: str = "static") -> "KernelSpec":
        arr = np.asarray(pattern, dtype=bool)
        return cls(block=int(block),
                   pattern=tuple(tuple(bool(x) for x in row)
                                 for row in arr),
                   backend=backend, source=source)

    @classmethod
    def banded(cls, n: int, block: int, window: int = 1,
               num_global: int = 1, backend: str = "auto"
               ) -> "KernelSpec":
        """The static first-pass mask (banded_block_pattern)."""
        if n % block:
            raise ValueError(f"n={n} not divisible by block={block}")
        return cls.from_pattern(
            banded_block_pattern(n // block, window, num_global),
            block, backend=backend)

    @property
    def n(self) -> int:
        return self.block * len(self.pattern)

    @property
    def live_fraction(self) -> float:
        flat = [x for row in self.pattern for x in row]
        return sum(flat) / float(len(flat))

    @property
    def label(self) -> str:
        """Short stable identifier (the ExecKey element), byte-equal to
        the JAX package's label of the same pattern, block and backend."""
        lbl = object.__getattribute__(self, "_label")
        if not lbl:
            h = hashlib.blake2b(digest_size=4)
            h.update(np.packbits(self.pattern_array()).tobytes())
            h.update(f"|{self.block}|{self.backend}".encode())
            lbl = (f"bs{self.block}x{len(self.pattern)}-"
                   f"{self.source[0]}{h.hexdigest()}")
            object.__setattr__(self, "_label", lbl)
        return lbl

    def pattern_array(self) -> np.ndarray:
        return np.asarray(self.pattern, dtype=bool)

    def token_mask(self) -> np.ndarray:
        """(n, n) bool token-level view of the block pattern (the masked
        backend's additive-mask support)."""
        return token_mask(self.pattern_array(), self.block)

    def covers(self, n: int) -> bool:
        return int(n) == self.n

    def additive_bias(self, device, n: Optional[int] = None
                      ) -> torch.Tensor:
        """(1, 1, n, n) fp32: 0 on the pattern, -1e9 off it (the masked
        backend's fill). `n` below `self.n` crops the pattern to a
        trailing partial block."""
        n = self.n if n is None else int(n)
        return torch.as_tensor(
            np.where(self.token_mask()[:n, :n], np.float32(0.0),
                     np.float32(MASK_VALUE)), device=device)[None, None]

    def device_plan(self, device) -> BlockPlan:
        return BlockPlan.build(self.pattern_array(), self.block, device)


_ACTIVE = threading.local()


def active_kernel_spec() -> Optional[KernelSpec]:
    """The KernelSpec governing the current pass, if any (thread-local)."""
    return getattr(_ACTIVE, "spec", None)


def active_kernel_plan() -> Optional[BlockPlan]:
    """The device plan that came with the active spec, if any."""
    return getattr(_ACTIVE, "plan", None)


@contextlib.contextmanager
def kernel_context(spec: Optional[KernelSpec],
                   plan: Optional[BlockPlan] = None):
    """Activate `spec` (and its device `plan`) for the enclosed calls.
    None suppresses an outer context: the MSA column attention, whose
    attended axis is alignment rows, never inherits a residue-axis
    pattern."""
    if plan is not None and (spec is None or plan.block != spec.block
                             or not np.array_equal(plan.pattern,
                                                   spec.pattern_array())):
        raise ValueError("the plan was not made from this spec")
    prev = (getattr(_ACTIVE, "spec", None), getattr(_ACTIVE, "plan", None))
    _ACTIVE.spec, _ACTIVE.plan = spec, plan
    try:
        yield
    finally:
        _ACTIVE.spec, _ACTIVE.plan = prev


# -- contact-prior mask planning (host-side, numpy) -------------------------


def contact_probs_from_distogram(distogram: np.ndarray,
                                 cutoff: float = 8.0,
                                 lengths=None) -> np.ndarray:
    """(n, n) contact probability P(d < cutoff) from distogram logits
    (softmax over the distance buckets), max-reduced over the batch axis
    when given (b, n, n, buckets): a batch shares one pattern, so it keeps
    any block any element needs. `lengths` (one per batch element) zeroes
    each element's cells beyond its real residue count before the
    reduce, so padding plans as dead blocks; a length of 0 removes the
    element. Bucket edges follow the distogram head (linspace over
    DISTOGRAM_MIN_DIST..DISTOGRAM_MAX_DIST)."""
    logits = np.asarray(distogram, np.float32)
    if logits.ndim == 3:
        logits = logits[None]
    b, n, n2, nb = logits.shape
    if lengths is not None and len(lengths) != b:
        raise ValueError(
            f"lengths has {len(lengths)} entries for batch of {b}")
    edges = np.linspace(constants.DISTOGRAM_MIN_DIST,
                        constants.DISTOGRAM_MAX_DIST, nb)
    # stable softmax over the bucket axis with one full-size temporary
    z = logits - logits.max(-1, keepdims=True)
    np.exp(z, out=z)
    close = edges <= cutoff
    probs = z[..., close].sum(-1)
    probs /= z.sum(-1)                       # (b, n, n)
    if lengths is not None:
        for i, ln in enumerate(lengths):
            ln = max(int(ln), 0)
            probs[i, ln:, :] = 0.0
            probs[i, :, ln:] = 0.0
    return probs.max(0)


def contact_block_pattern(contacts: np.ndarray, block: int, *,
                          threshold: float = 0.5,
                          live_frac: Optional[float] = None,
                          window: int = 1,
                          num_global: int = 1) -> np.ndarray:
    """Plan a (nqb, nkb) block pattern from an (n, n) contact-probability
    map: a block is live when its max cell probability clears
    `threshold`, or, with `live_frac` set, when it ranks inside the top
    live_frac of blocks. The banded window and global blocks are always
    kept and the result is symmetrised, so every row keeps its
    diagonal block."""
    c = np.asarray(contacts, np.float32)
    n = c.shape[0]
    if c.shape != (n, n):
        raise ValueError(f"contacts must be square, got {c.shape}")
    if n % block:
        raise ValueError(f"n={n} not divisible by block={block}")
    nb = n // block
    scores = c.reshape(nb, block, nb, block).max(axis=(1, 3))
    if live_frac is not None:
        live_frac = min(max(float(live_frac), 0.0), 1.0)
        k = max(1, int(round(live_frac * nb * nb)))
        cut = np.sort(scores.ravel())[::-1][k - 1]
        live = scores >= cut
    else:
        live = scores >= threshold
    live = live | banded_block_pattern(nb, window, num_global)
    return live | live.T


# -- the device half ---------------------------------------------------------


def _as_plan(plan, block, device) -> BlockPlan:
    if isinstance(plan, BlockPlan):
        if block is not None and int(block) != plan.block:
            raise ValueError(f"block={block} but the plan has block "
                             f"{plan.block}")
        return plan
    if block is None:
        raise ValueError("a raw pattern needs block=")
    return BlockPlan.build(plan, block, device)


def block_sparse_reference(q, k, v, plan, *, bias=None, bias_repeat: int = 1,
                           k_mask=None, heads: int = 1,
                           scale: Optional[float] = None,
                           block: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of the contract: dense fp32 logits, the
    replayed bias, -1e9 at masked keys, -inf at dead blocks, an fp32
    softmax and the product with v."""
    plan = _as_plan(plan, block, q.device)
    b, n, d = q.shape
    if scale is None:
        scale = float(d) ** -0.5
    logits = torch.einsum("bnd,bmd->bnm", q.float() * scale, k.float())
    if bias is not None:
        logits = logits + bias.float().reshape(
            -1, heads, n, n).repeat_interleave(
                bias_repeat, dim=0).reshape(b, n, n)
    if k_mask is not None:
        km = (k_mask > 0).repeat_interleave(heads, dim=0)[:, None, :]
        logits = logits.masked_fill(~km, MASK_VALUE)
    live = torch.as_tensor(token_mask(plan.pattern, plan.block),
                           device=q.device)
    logits = logits.masked_fill(~live, float("-inf"))
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bnm,bmd->bnd", attn, v.float()).to(q.dtype)


def _check(q, k, v, plan, bias, bias_repeat, k_mask, heads):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"block_sparse_attention kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    tensors = {"q": q, "k": k, "v": v, "bias": bias, "k_mask": k_mask,
               **{f"plan.{name}": getattr(plan, name)
                  for name in ("cols", "counts") + UNIT_FIELDS}}
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"block_sparse_attention kernel needs "
                             f"contiguous tensors; {name} is not")
    if any(t is not None and t.dtype != torch.int32
           for name, t in tensors.items() if name.startswith("plan.")):
        raise TypeError("the plan's tensors must be int32")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} must all be one (B, N, D)")
    b, n, d = q.shape
    check_head_dim(d)
    if plan.kernel_block not in BLOCKS:
        raise ValueError(f"kernel block {plan.kernel_block} not in "
                         f"{BLOCKS}")
    if n != plan.n:
        raise ValueError(f"N={n} but the plan covers {plan.n} "
                         f"({plan.pattern.shape[0]} blocks of {plan.block})")
    if b < 1 or heads < 1 or b % heads:
        raise ValueError(f"B={b} is not a multiple of heads={heads}")
    if bias is not None:
        if bias.dtype != torch.float32:
            raise TypeError(f"bias must be float32, got {bias.dtype}")
        if bias.dim() != 3 or bias.shape[1:] != (n, n) or \
                bias.shape[0] * bias_repeat != b or bias.shape[0] % heads:
            raise ValueError(
                f"bias {tuple(bias.shape)} does not fit B={b}, "
                f"bias_repeat={bias_repeat}, heads={heads}")
    if k_mask is not None:
        if k_mask.dtype != torch.bool:
            raise TypeError(f"k_mask must be bool, got {k_mask.dtype}")
        if tuple(k_mask.shape) != (b // heads, n):
            raise ValueError(f"k_mask {tuple(k_mask.shape)} != "
                             f"({b // heads}, {n})")


def _library():
    lib = build.load("block_sparse")
    fn = lib.af2_block_sparse_attention
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i,
                       ctypes.c_float, i, i, p, p, p, p, i, i, p, p]
        fn.restype = ctypes.c_int
    return fn


def block_sparse_attention(q, k, v, plan, *, bias=None,
                           bias_repeat: int = 1, k_mask=None,
                           heads: int = 1, scale: Optional[float] = None,
                           block: Optional[int] = None) -> torch.Tensor:
    """Attention over the live blocks of `plan` (a `BlockPlan` on q's
    device, or a raw (nqb, nqb) pattern with `block=`). CUDA tensors go
    through kernel K2, or K1 for a block with no K2 instance (routes in
    the module doc), float32 or bfloat16, any D; CPU tensors take the
    plain version. Any other device raises, and so does a tensor the
    kernels do not take."""
    if q.device.type == "cpu":
        return block_sparse_reference(q, k, v, plan, bias=bias,
                                      bias_repeat=bias_repeat,
                                      k_mask=k_mask, heads=heads,
                                      scale=scale, block=block)
    if q.device.type != "cuda":
        raise ValueError(f"block_sparse_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        raise RuntimeError("block_sparse_attention is forward only; run it "
                           "under torch.no_grad() or inference_mode()")
    return kernel_route(q, k, v, _as_plan(plan, block, q.device), bias=bias,
                        bias_repeat=bias_repeat, k_mask=k_mask, heads=heads,
                        scale=scale)


def kernel_route(q, k, v, plan: BlockPlan, *, bias=None,
                 bias_repeat: int = 1, k_mask=None, heads: int = 1,
                 scale: Optional[float] = None) -> torch.Tensor:
    """The card's routes (module doc): K1 with the pattern as a bias when
    the plan has no kernel block, else K2 over the plan's kernel blocks,
    either at the padded head width. The scale defaults to the caller's
    D^-1/2, taken before any padding."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if plan.kernel_block:
        return pad_head_dim(_launch, q, k, v, plan, bias=bias,
                            bias_repeat=bias_repeat, k_mask=k_mask,
                            heads=heads, scale=scale)
    if scale != 1.0:
        q = q * scale
    if bias is None:
        # the plan's one (1, n, n) bias read by every row: K1 indexes the
        # bias by `heads`, so run it with heads 1 and the mask per row
        out = fused_attention(
            q, k, v, plan.bias[None], None,
            None if k_mask is None else k_mask.repeat_interleave(heads, 0),
            bias_repeat=q.shape[0])
    else:
        out = fused_attention(q, k, v, bias + plan.bias, None, k_mask,
                              heads=heads, bias_repeat=bias_repeat)
    if k_mask is None:
        return out
    return _average_shut_rows(out, v, plan, k_mask, heads)


def _average_shut_rows(out, v, plan: BlockPlan, k_mask, heads: int):
    """K1 route: a query row whose live keys are all masked is, by the
    contract, the mean of v over its live keys (they tie at -1e9, dead
    keys are -inf). Under the -1e9 pattern bias K1 ties every key
    there, so overwrite those rows, per (mask row, q-block), with that
    mean; every other row is K1's as it came."""
    b, n, d = v.shape
    nb, block = plan.pattern.shape[0], plan.block
    live = (plan.bias[::block, ::block] == 0).float()          # (nqb, nkb)
    open_blocks = k_mask.reshape(-1, nb, block).any(-1).float()
    shut = (open_blocks @ live.T == 0).repeat_interleave(heads, 0)
    vsum = v.float().reshape(b, nb, block, d).sum(2)           # (B, nkb, D)
    mean = torch.einsum("qk,bkd->bqd", live, vsum) / (
        live.sum(1) * block)[:, None]
    return torch.where(shut[:, :, None, None], mean.to(out.dtype)[:, :, None],
                       out.reshape(b, nb, block, d)).reshape(b, n, d)


def _launch(q, k, v, plan, *, bias, bias_repeat, k_mask, heads, scale,
            layout=None):
    """One launch of K2 on the current stream, at the plan's kernel
    block, in the layout `kernel_layout` picks; `layout` forces one (TILE
    or WARPGROUP for bf16, or 0 for the C side's older rule), for timing
    the rule on the card."""
    _check(q, k, v, plan, bias, bias_repeat, k_mask, heads)
    b, n, d = q.shape
    if layout is None:
        layout = kernel_layout(plan.kernel_block, n, d, q.dtype,
                               bias is not None)
    fn = _library()
    out = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()
    units = (None,) * 4 + (0, 0, None)
    if layout == WARPGROUP:
        # the kernel reads the key mask 16 bytes at a time
        if k_mask is not None and k_mask.data_ptr() % 16:
            k_mask = k_mask.clone()
        # the unit plan, and the item counter the kernel zeroes and
        # counts its units with
        counter = torch.empty(1, dtype=torch.int32, device=q.device)
        units = (*(ptr(getattr(plan, name)) for name in UNIT_FIELDS),
                 *plan.unit_cols.shape, ptr(counter))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(k_mask),
                 ptr(plan.cols), ptr(plan.counts), ptr(out), b, n, d,
                 plan.kernel_block, int(plan.cols.shape[1]), heads,
                 bias_repeat, float(scale), _DTYPE_CODES[q.dtype], layout,
                 *units, stream)
    if err != 0:
        raise RuntimeError(f"block_sparse_attention kernel launch failed: "
                           f"CUDA error {err} (B={b}, N={n}, D={d}, "
                           f"block={plan.kernel_block}, layout {layout})")
    launch_count.value += 1
    return out
