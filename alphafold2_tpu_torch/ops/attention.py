"""Fused biased attention for the Evoformer's axial attention
(counterpart of `alphafold2_tpu/ops/attention.py`).

Contract (shared by the CUDA kernel and the plain version):

    out = softmax(q . k^T + bias, masked -> -1e9) . v

- q, k, v: (B, N, D) with heads folded innermost into B
  (B = batch * fold * heads, head fastest). q arrives pre-scaled, so
  no scale is applied here.
- bias: optional (Bb, Nq, Nk) fp32, *unrepeated*: B == Bb * bias_repeat,
  and query block i reads bias row (i // (bias_repeat*heads))*heads +
  i % heads, so the axial edge bias is never repeated over the fold.
- q_mask / k_mask: optional (B // heads, N) bool vectors; their outer AND
  decides which logits are kept. Masked logits are replaced by -1e9
  after the bias add, so a fully masked query row averages over all keys.
- Softmax runs in fp32; the output has q's dtype.

`fused_attention` takes the CUDA kernel (`csrc/fused_attention.cu`) for
CUDA tensors and the plain version for CPU tensors: bf16 runs on the
tensor cores in the layout `kernel_layout` picks (the warpgroup kernel of
`csrc/attention_wgmma.cuh` or the mma.sync tile of
`csrc/attention_tile.cuh`), fp32 on the CUDA cores. On the card there is
no fallback: a tensor the kernel does not take raises.

Head widths on the card (`kernel_head_dim`): D in {16, 32, 64, 128}
launches as it is; any other D up to 128 is zero-padded along D to the
next of those widths, launched, and sliced back (exact: zero columns add
nothing to q . k^T, and q arrives pre-scaled). D > 128 is zero-padded to
a multiple of `SLICE` (128) and takes the kernels' sliced path: the
output columns are split into slices, one thread block each, and every
block computes q . k^T over the whole D (`csrc/attention_tile.cuh`).

In bf16 the kernel rounds the softmax weights to bf16 before the product
with v, as the plain version does (`attn.to(q.dtype)`), but keeps the
logits in fp32 where the plain version rounds them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from alphafold2_tpu_torch.ops import build

# Large-negative fill for masked logits (matches model/primitives.py).
MASK_VALUE = -1e9

# head widths with an instance of their own; wider heads launch at a
# multiple of SLICE on the sliced path
HEAD_DIMS = (16, 32, 64, 128)
SLICE = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# the kernel's layouts (`dispatch_mma` in csrc/fused_attention.cu): 0 is
# the fp32 kernel's only one (and, for bf16, the C side's older rule: ROW
# for Nq <= 16, else TILE); TILE: the mma.sync tile, eight warps on 128
# queries (four on 64 at D = 128, and the sliced path); ROW: one warp per
# batch*head row of <= 16 queries; WARPGROUP: TMA, an mbarrier ring, wgmma
# and persistent blocks (csrc/attention_wgmma.cuh)
F32, TILE, ROW, WARPGROUP = 0, 1, 2, 3


def kernel_layout(nq: int, nk: int, d: int, dtype: torch.dtype,
                  has_bias: bool) -> int:
    """The layout a launch at (Nq, Nk, launch head width d, dtype) takes,
    chosen from device times on the H100 (PERF.md). WARPGROUP wherever it
    applies: bf16, d in HEAD_DIMS, Nq >= 64 (a warpgroup owns 64 query
    rows) and, with a bias, Nk a multiple of 4 (its TMA row stride must be
    a multiple of 16 bytes). ROW for Nq <= 16 (the MSA column attention
    at N = 5, the template pointwise attention's one query), where a
    64- or 128-row tile would be mostly padding; TILE for the rest (16 <
    Nq < 64, Nk not a multiple of 4 under a bias, the sliced path above
    d = 128)."""
    if dtype != torch.bfloat16:
        return F32
    if nq <= 16:
        return ROW
    if d in HEAD_DIMS and nq >= 64 and not (has_bias and nk % 4):
        return WARPGROUP
    return TILE


class LaunchCounter:
    """Counts kernel launches, so a run can show that the main path went
    through the kernel."""

    def __init__(self):
        self.value = 0

    def reset(self):
        self.value = 0


launch_count = LaunchCounter()


def attention_reference(q, k, v, bias=None, q_mask=None, k_mask=None,
                        *, heads=1, bias_repeat=1):
    """The plain PyTorch version of the contract (the CPU path, the
    kernel's backward, and what the kernel is held against)."""
    logits = torch.einsum("bnd,bmd->bnm", q, k).float()
    if bias is not None:
        logits = logits + bias.float().reshape(
            -1, heads, *bias.shape[1:]).repeat_interleave(
                bias_repeat, dim=0).reshape(logits.shape)
    valid = None
    if q_mask is not None:
        valid = (q_mask > 0)[:, :, None]
    if k_mask is not None:
        km = (k_mask > 0)[:, None, :]
        valid = km if valid is None else valid & km
    if valid is not None:
        valid = valid.expand(valid.shape[0], *logits.shape[1:])
        valid = valid.repeat_interleave(heads, dim=0)
        logits = logits.masked_fill(~valid, MASK_VALUE)
    attn = torch.softmax(logits, dim=-1)
    return torch.einsum("bnm,bmd->bnd", attn.to(q.dtype), v)


def kernel_head_dim(d: int) -> int:
    """The head width a width-`d` attention launches at: the smallest of
    HEAD_DIMS >= d, or above 128 the next multiple of SLICE (the sliced
    path)."""
    if d < 1:
        raise ValueError(f"head width {d} < 1")
    for width in HEAD_DIMS:
        if d <= width:
            return width
    return -(-d // SLICE) * SLICE


def check_head_dim(d: int):
    """Raise ValueError unless the kernels take head width `d` as it is
    (one of HEAD_DIMS, or a multiple of SLICE above them)."""
    if d not in HEAD_DIMS and (d <= SLICE or d % SLICE):
        raise ValueError(f"head width {d} is neither in {HEAD_DIMS} nor a "
                         f"multiple of {SLICE} above it")


def pad_head_dim(launch, q, k, v, *args, **kwargs):
    """`launch(q, k, v, *args, **kwargs)` at the kernel's head width:
    q, k, v zero-padded along D up to `kernel_head_dim(D)` and the output
    sliced back to D (autograd-able, so a backward through the padded
    launch still works)."""
    d = q.shape[-1]
    width = kernel_head_dim(d)
    if width == d:
        return launch(q, k, v, *args, **kwargs)
    pad = (0, width - d)
    out = launch(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), *args,
                 **kwargs)
    return out[..., :d]


def _check(q, k, v, bias, q_mask, k_mask, heads, bias_repeat):
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"fused_attention kernel takes float32 or bfloat16, "
                        f"got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    tensors = {"q": q, "k": k, "v": v, "bias": bias, "q_mask": q_mask,
               "k_mask": k_mask}
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_attention kernel needs contiguous "
                             f"tensors; {name} is not")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k, v must be (B, N, D)")
    b, nq, d = q.shape
    nk = k.shape[1]
    if k.shape != (b, nk, d) or v.shape != (b, nk, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    check_head_dim(d)
    if nq < 1 or nk < 1 or b < 1:
        raise ValueError("empty attention")
    if heads < 1 or b % heads:
        raise ValueError(f"B={b} is not a multiple of heads={heads}")
    if bias is not None:
        if bias.dtype != torch.float32:
            raise TypeError(f"bias must be float32, got {bias.dtype}")
        if bias.dim() != 3 or bias.shape[1:] != (nq, nk) or \
                bias.shape[0] * bias_repeat != b or bias.shape[0] % heads:
            raise ValueError(
                f"bias {tuple(bias.shape)} does not fit B={b}, "
                f"bias_repeat={bias_repeat}, heads={heads}")
    for name, t, n in (("q_mask", q_mask, nq), ("k_mask", k_mask, nk)):
        if t is None:
            continue
        if t.dtype != torch.bool:
            raise TypeError(f"{name} must be bool, got {t.dtype}")
        if tuple(t.shape) != (b // heads, n):
            raise ValueError(f"{name} {tuple(t.shape)} != "
                             f"({b // heads}, {n})")


def _library():
    lib = build.load("fused_attention")
    fn = lib.af2_fused_attention
    if fn.argtypes is None:
        p = ctypes.c_void_p
        i = ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, bias, q_mask, k_mask, heads, bias_repeat,
            layout=None):
    """One launch of the CUDA kernel on the current stream, in the layout
    `kernel_layout` picks; `layout` forces one (a bf16 layout of
    `dispatch_mma` in the source, or 0 for the C side's older rule), for
    timing the rule on the card."""
    _check(q, k, v, bias, q_mask, k_mask, heads, bias_repeat)
    fn = _library()
    b, nq, d = q.shape
    nk = k.shape[1]
    if layout is None:
        layout = kernel_layout(nq, nk, d, q.dtype, bias is not None)
    out = torch.empty_like(q)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(ptr(q), ptr(k), ptr(v), ptr(bias), ptr(q_mask),
                 ptr(k_mask), ptr(out), b, nq, nk, d, heads, bias_repeat,
                 _DTYPE_CODES[q.dtype], layout, stream)
    if err != 0:
        raise RuntimeError(f"fused_attention kernel launch failed: CUDA "
                           f"error {err} (B={b}, Nq={nq}, Nk={nk}, D={d}, "
                           f"layout {layout})")
    launch_count.value += 1
    return out


# the profiler range around the backward's recompute, so a trace can
# tell its kernels from the forward's
BACKWARD_RANGE = "fused_attention.backward (plain recompute)"


class _FusedAttention(torch.autograd.Function):
    """Kernel forward; the backward recomputes through
    `attention_reference` (the counterpart of `_fused_attention_vjp`)
    under the profiler range `BACKWARD_RANGE`. Masks get no gradient; the
    bias gradient sums over the fold."""

    @staticmethod
    def forward(ctx, q, k, v, bias, q_mask, k_mask, heads, bias_repeat):
        ctx.save_for_backward(q, k, v, bias, q_mask, k_mask)
        ctx.heads, ctx.bias_repeat = heads, bias_repeat
        return _launch(q, k, v, bias, q_mask, k_mask, heads, bias_repeat)

    @staticmethod
    def backward(ctx, grad):
        q, k, v, bias, q_mask, k_mask = ctx.saved_tensors
        inputs = [q, k, v] + ([] if bias is None else [bias])
        with torch.enable_grad(), \
                torch.profiler.record_function(BACKWARD_RANGE):
            leaves = [t.detach().requires_grad_() for t in inputs]
            out = attention_reference(
                *leaves[:3], bias=leaves[3] if bias is not None else None,
                q_mask=q_mask, k_mask=k_mask, heads=ctx.heads,
                bias_repeat=ctx.bias_repeat)
            grads = torch.autograd.grad(out, leaves, grad)
        dbias = grads[3] if bias is not None else None
        return grads[0], grads[1], grads[2], dbias, None, None, None, None


def fused_attention(q, k, v, bias=None, q_mask=None, k_mask=None, *,
                    heads: int = 1, bias_repeat: int = 1) -> torch.Tensor:
    """Fused bias + mask + softmax + PV attention (differentiable).

    CUDA tensors go through the CUDA kernel (any N >= 1 and any D >= 1 —
    padded as `kernel_head_dim` says — float32 or bfloat16); CPU tensors
    take the plain version. Any other device raises."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, bias=bias, q_mask=q_mask,
                                   k_mask=k_mask, heads=heads,
                                   bias_repeat=bias_repeat)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda or cpu, not "
                         f"{q.device}")
    return pad_head_dim(_FusedAttention.apply, q, k, v, bias, q_mask,
                        k_mask, heads, bias_repeat)
