"""The README-era efficient-attention menu and conv blocks in PyTorch
(counterpart of `alphafold2_tpu/model/attention_variants.py`).

- `LinearAttention`: kernelized attention with the elu+1 feature map;
- `orthogonal_random_features`, `favor_softmax_features` and
  `PerformerAttention`: FAVOR+ (Choromanski et al. 2021), its projection
  drawn from an explicit `torch.Generator` on the generator's device, or
  injected (`projection=`);
- `MemoryCompressedAttention`: K and V mean-pooled by `compress_ratio`;
- `kronecker_pool_2d` and `KroneckerAttention`: cross-attention onto the
  H + W axial means of a 2-D context, through `Attention` (kernel K1 on
  the card);
- `MultiKernelConvBlock`: the trRosetta2-style residual conv block
  (NHWC in and out, `F.conv2d` with the flax SAME padding);
- `block_sparse_block_pattern`, `block_sparse_mask` and
  `BlockSparseAttention`: the local + global block pattern as the
  serving `KernelSpec.banded`, run by kernel K2 through `Attention`'s
  spec path under `no_grad` when the length divides into blocks, else
  as the spec's -1e9 additive bias through `Attention` (K1 on the card).

The linear, Performer and compressed variants are `Attention`s (its
projections and gated output) with plain PyTorch cores, as they are
plain XLA in the JAX package. Parameter names follow the flax names
(`weights.load_jax_params`). Every tensor stays on its device: the
card runs the kernels and the CPU their plain versions.
"""

from __future__ import annotations

import functools
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from alphafold2_tpu_torch.ops.attention import MASK_VALUE
from alphafold2_tpu_torch.ops.block_sparse import (BlockPlan, KernelSpec,
                                                   banded_block_pattern,
                                                   kernel_context)
from alphafold2_tpu_torch.model.primitives import (Attention, Dense,
                                                   LayerNorm, dropout)

# the README-era defaults shared by the trunk, the reversible trunk and
# `Alphafold2` (as in the JAX package)
DEFAULT_CONV_SEQ_KERNELS = ((9, 1), (1, 9), (3, 3))
DEFAULT_CONV_MSA_KERNELS = ((1, 9), (3, 3))


class LinearAttention(Attention):
    """Kernelized linear attention with the elu+1 feature map."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 gating: bool = True, dtype=torch.float32):
        super().__init__(dim, heads, dim_head, gating=gating, dtype=dtype)

    def forward(self, x, context=None, mask=None, context_mask=None):
        q, k, v = self.split_qkv(x, context)
        q, k = F.elu(q) + 1.0, F.elu(k) + 1.0
        kmask = context_mask if context is not None else mask
        if kmask is not None:
            w = kmask[:, None, :, None].to(k.dtype)
            k, v = k * w, v * w
        kv = torch.einsum("bhnd,bhne->bhde", k, v)
        z = torch.einsum("bhnd,bhd->bhn", q, k.sum(-2))
        out = torch.einsum("bhnd,bhde->bhne", q, kv) / \
            torch.clamp(z[..., None], min=1e-6)
        return self.finish(out, x)


def orthogonal_random_features(generator: Optional[torch.Generator],
                               nb_features: int, dim: int,
                               device=None) -> torch.Tensor:
    """FAVOR+ projection (nb_features, dim) fp32: rows orthogonal within
    each dim-sized block (QR of a Gaussian), row norms redrawn chi(dim)
    (the norm of dim standard normals). Drawn from `generator` (the
    default generator when None) on the generator's device, returned on
    `device` (the generator's when None)."""
    where = generator.device if generator is not None else (
        device if device is not None else torch.device("cpu"))
    n_blocks = -(-nb_features // dim)
    blocks = []
    for _ in range(n_blocks):
        g = torch.randn((dim, dim), generator=generator, device=where)
        q, _ = torch.linalg.qr(g)
        blocks.append(q.T)
    w = torch.cat(blocks, dim=0)[:nb_features]
    norms = torch.randn((nb_features, dim), generator=generator,
                        device=where).square().sum(-1, keepdim=True).sqrt()
    out = w * norms
    return out if device is None else out.to(device)


def favor_softmax_features(x, proj, is_query: bool, eps: float = 1e-4,
                           mask=None):
    """Positive softmax-kernel features exp(Wx - |x|^2/2 - c) / sqrt(m),
    x (..., n, d) already scaled by d^-1/4. The stabiliser c is the
    per-token max for queries and the per-(batch, head) max for keys;
    `mask` (..., n) keeps padded keys out of that max, and their rows are
    pinned at c - 100 before the caller zeroes them."""
    m = proj.shape[0]
    h = x @ proj.T - (x * x).sum(-1, keepdim=True) / 2.0
    if mask is not None:
        h = torch.where(mask[..., None], h, float("-inf"))
    finite = torch.where(torch.isfinite(h), h, torch.full_like(h, -1e30))
    if is_query:
        c = finite.amax(-1, keepdim=True).detach()
    else:
        c = finite.amax(dim=(-1, -2), keepdim=True).detach()
    h = torch.where(torch.isfinite(h), h, c - 100.0)
    return (torch.exp(h - c) + eps) / (m ** 0.5)


class PerformerAttention(Attention):
    """FAVOR+ attention. The projection is `projection` when given;
    otherwise drawn, in a training forward, from `generator` (redrawn
    every step, as the JAX train loop redraws from its step key); at
    inference it is the one drawn from a CPU generator seeded `seed`,
    the same in every pass and every fold, and the same on the CPU and
    on the card."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 nb_features: int = 256, gating: bool = True, seed: int = 0,
                 dtype=torch.float32):
        super().__init__(dim, heads, dim_head, gating=gating, dtype=dtype)
        self.nb_features = nb_features
        self.seed = seed
        self.compute_dtype = dtype
        self._fixed: Dict[torch.device, torch.Tensor] = {}

    def projection_for(self, device, train: bool,
                       generator: Optional[torch.Generator]):
        if train:
            return orthogonal_random_features(
                generator, self.nb_features, self.dim_head, device=device)
        if device not in self._fixed:
            self._fixed[device] = orthogonal_random_features(
                torch.Generator().manual_seed(self.seed), self.nb_features,
                self.dim_head, device=device)
        return self._fixed[device]

    def forward(self, x, context=None, mask=None, context_mask=None,
                projection=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        q, k, v = self.split_qkv(x, context)
        scale = self.dim_head ** 0.25
        q, k = (q / scale).float(), (k / scale).float()
        proj = projection.to(x.device).float() if projection is not None \
            else self.projection_for(x.device, train, generator)

        kmask = context_mask if context is not None else mask
        kmask3 = None if kmask is None else kmask.bool()[:, None, :]
        phi_q = favor_softmax_features(q, proj, is_query=True)
        phi_k = favor_softmax_features(k, proj, is_query=False,
                                       mask=kmask3)
        v = v.float()
        if kmask is not None:
            w = kmask[:, None, :, None].float()
            phi_k, v = phi_k * w, v * w
        kv = torch.einsum("bhnm,bhne->bhme", phi_k, v)
        z = torch.einsum("bhnm,bhm->bhn", phi_q, phi_k.sum(-2))
        out = torch.einsum("bhnm,bhme->bhne", phi_q, kv) / \
            torch.clamp(z[..., None], min=1e-6)
        return self.finish(out.to(self.compute_dtype), x)


class MemoryCompressedAttention(Attention):
    """Attention over K and V mean-pooled by `compress_ratio` (masked
    keys left out of each pool's mean; a pool with no valid key is
    masked). The softmax is fp32; dropout on its weights in training."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 compress_ratio: int = 2, gating: bool = True,
                 dropout: float = 0.0, dtype=torch.float32):
        super().__init__(dim, heads, dim_head, dropout=dropout,
                         gating=gating, dtype=dtype)
        self.compress_ratio = compress_ratio

    def forward(self, x, mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        q, k, v = self.project_qkv(x)
        r = self.compress_ratio
        b, h, n, d = k.shape
        pad = (-n) % r
        m = mask.bool() if mask is not None else torch.ones(
            b, n, dtype=torch.bool, device=x.device)
        if pad:
            k = F.pad(k, (0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, pad))
            m = F.pad(m, (0, pad))
        w = m[:, None, :, None].to(k.dtype)
        k = (k * w).reshape(b, h, -1, r, d).sum(3)
        v = (v * w).reshape(b, h, -1, r, d).sum(3)
        counts = w.reshape(b, 1, -1, r, 1).sum(3)
        k = k / torch.clamp(counts, min=1.0)
        v = v / torch.clamp(counts, min=1.0)
        kmask = (counts[..., 0] > 0)[:, :, None, :]        # (b, 1, 1, nk)

        dots = torch.einsum("bhid,bhjd->bhij", q, k).float()
        dots = dots.masked_fill(~kmask, MASK_VALUE)
        if mask is not None:
            dots = dots.masked_fill(~mask.bool()[:, None, :, None],
                                    MASK_VALUE)
        attn = torch.softmax(dots, dim=-1)
        if train:
            attn = dropout(attn, self.dropout, generator)
        out = torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype), v)
        return self.finish(out, x)


def kronecker_pool_2d(context, context_mask=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, H, W, d) -> (b, H + W, d) axial means: the masked mean over
    columns (one token per row), then over rows (one per column); and
    the (b, H + W) token mask."""
    b, height, width, _ = context.shape
    if context_mask is None:
        rows, cols = context.mean(2), context.mean(1)
        token_mask = torch.ones(b, height + width, dtype=torch.bool,
                                device=context.device)
    else:
        w = context_mask[..., None].to(context.dtype)
        rows = (context * w).sum(2) / torch.clamp(w.sum(2), min=1.0)
        cols = (context * w).sum(1) / torch.clamp(w.sum(1), min=1.0)
        token_mask = torch.cat([context_mask.any(2), context_mask.any(1)],
                               dim=1)
    return torch.cat([rows, cols], dim=1), token_mask


class KroneckerAttention(nn.Module):
    """Cross-attention from a 1-D stream onto the axial-pooled (H + W
    token) 2-D context, through an inner `Attention` named `attn`."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.attn = Attention(dim, heads=heads, dim_head=dim_head,
                              dropout=dropout, dtype=dtype)

    def forward(self, x, context_2d, mask=None, context_mask=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        pooled, token_mask = kronecker_pool_2d(context_2d, context_mask)
        return self.attn(x, mask=mask, context=pooled,
                         context_mask=token_mask, train=train,
                         generator=generator)


def same_padding(kernel: int, dilation: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding at stride 1: the dilated kernel's extent
    less one, the odd one out on the high side."""
    total = (kernel - 1) * dilation
    return total // 2, total - total // 2


class MultiKernelConvBlock(nn.Module):
    """Residual conv block over a (b, H, W, dim) map: pre-LayerNorm,
    masked positions zeroed, one 2-D conv per (kernel, dilation) with
    SAME padding, their mean, gelu (tanh form), a zero-initialised output
    projection and the mask again. The caller adds the residual. Each
    branch is `conv_{kh}x{kw}_d{d}`, an `nn.Conv2d` (weight (out, in, kh,
    kw), as the bridge lays flax's (kh, kw, in, out) out); computed in
    `dtype`."""

    def __init__(self, dim: int, kernels: Sequence = ((3, 3),),
                 dilations: Sequence[int] = (1,), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(dim, dtype)
        self.branches = []
        for kh, kw in kernels:
            for d in dilations:
                name = f"conv_{kh}x{kw}_d{d}"
                setattr(self, name, nn.Conv2d(dim, dim, (int(kh), int(kw)),
                                              dilation=int(d),
                                              dtype=torch.float32))
                self.branches.append((name, int(kh), int(kw), int(d)))
        self.proj_out = Dense(dim, dim, dtype=dtype, init="zeros")

    def forward(self, x, mask=None):
        h = self.norm(x)
        if mask is not None:
            h = h * mask[..., None].to(h.dtype)
        h = h.permute(0, 3, 1, 2)                         # NHWC -> NCHW
        total = 0.0
        for name, kh, kw, d in self.branches:
            conv = getattr(self, name)
            ph, pw = same_padding(kh, d), same_padding(kw, d)
            padded = F.pad(h, (pw[0], pw[1], ph[0], ph[1]))
            total = total + F.conv2d(padded, conv.weight.to(self.dtype),
                                     conv.bias.to(self.dtype), dilation=d)
        h = F.gelu(total / len(self.branches), approximate="tanh")
        out = self.proj_out(h.permute(0, 2, 3, 1))
        if mask is not None:
            out = out * mask[..., None].to(out.dtype)
        return out


def block_sparse_block_pattern(n_blocks: int, num_global: int = 1,
                               window: int = 1) -> np.ndarray:
    """(n_blocks, n_blocks) bool: within +-`window` blocks of the
    diagonal plus the first `num_global` blocks (the one local + global
    source the serving policy shares)."""
    return banded_block_pattern(n_blocks, window=window,
                                num_global=num_global)


def block_sparse_mask(n: int, block: int = 32, num_global: int = 1,
                      window: int = 1) -> np.ndarray:
    """(n, n) bool token mask of the block pattern (a trailing partial
    block when n % block != 0)."""
    nb = -(-n // block)
    bp = block_sparse_block_pattern(nb, num_global, window)
    bi = np.arange(n) // block
    return bp[bi[:, None], bi[None, :]]


@functools.lru_cache(maxsize=32)
def banded_route(n: int, block: int, window: int, num_global: int,
                 device: torch.device
                 ) -> Tuple[KernelSpec, Optional[BlockPlan], torch.Tensor]:
    """The model-level pattern as the serving `KernelSpec` (banded over n
    rounded up to whole blocks), its device plan when n divides into
    blocks (else None), and its (1, 1, n, n) additive bias: made once
    per (n, block, window, num_global, device) and reused by every
    launch."""
    nb = -(-n // block)
    spec = KernelSpec.banded(nb * block, block, window=window,
                             num_global=num_global)
    plan = spec.device_plan(device) if spec.covers(n) else None
    return spec, plan, spec.additive_bias(device, n)


class BlockSparseAttention(nn.Module):
    """Self-attention over a fixed local + global block pattern, behind
    one parameter tree (the inner `Attention`, `attn`). Routes:

    - gradients off, n % block == 0, no active dropout: the pattern's
      `KernelSpec` and plan made active around `attn`, which runs kernel
      K2 (its plain version on the CPU), the mask on keys only;
    - otherwise (a partial last block, or under gradients, where K2,
      forward only, does not run): the spec's -1e9 additive bias through
      `attn` (K1 on the card);
    - training with attention dropout > 0: warns, as the JAX module
      does, and `attn` takes its plain dropout path.

    Outputs at masked query rows differ between the routes (K2 has no
    query mask); valid rows agree."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 block: int = 32, num_global: int = 1, window: int = 1,
                 dropout: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.block, self.num_global, self.window = block, num_global, window
        self.dropout = dropout
        self.attn = Attention(dim, heads=heads, dim_head=dim_head,
                              dropout=dropout, dtype=dtype)

    def forward(self, x, mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        spec, plan, bias = banded_route(x.shape[-2], self.block,
                                        self.window, self.num_global,
                                        x.device)
        drop = train and self.dropout > 0.0
        if plan is not None and drop:
            warnings.warn(
                "BlockSparseAttention: dropout>0 under training falls "
                "back to DENSE masked attention (the block-skipping "
                "kernel has no dropout) — the sparse FLOP savings do not "
                "apply to these steps", RuntimeWarning, stacklevel=2)
        if plan is not None and not drop and not torch.is_grad_enabled():
            with kernel_context(spec, plan):
                return self.attn(x, mask=mask)
        return self.attn(x, mask=mask, attn_bias=bias,
                         attn_bias_repeat=x.shape[0], train=train,
                         generator=generator)
