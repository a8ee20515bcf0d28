"""Reversible Evoformer trunk in PyTorch (counterpart of
`alphafold2_tpu/model/reversible.py`): activation memory that does not
grow with depth.

Each track (pair x, MSA m) is duplicated into two coupling streams; per
layer

    m1' = m1 + [MsaAttentionBlock(m2; pair=x_in) - m2]
    m2' = m2 + FeedForward(m1')
    x1' = x1 + [PairwiseAttentionBlock(x2; msa=m_out) - x2]
    x2' = x2 + FeedForward(x1')

with x_in = (x1 + x2) / 2 and m_out = (m1' + m2') / 2. The depth stack
runs under one `torch.autograd.Function` (`_ReversibleStack`): the
forward keeps only the final streams; the backward rebuilds each
layer's inputs by inverting its couplings, re-runs the layer under
`torch.enable_grad()` and back-propagates through it, layer by layer
from the top. The attentions inside go through `Attention` as in the
plain trunk, so on the card the forward, the inversion and the
re-linearisation each launch the fused attention kernel (K1), whose own
backward recomputes the plain attention.

Dropout composes with the inversion by replay, as the JAX package's key
derivation does: a training forward draws one base seed from the
caller's generator, and coupling j of layer i draws its masks from a
fresh generator seeded from (base, 4 i + j), on the caller's
generator's device, in the forward, the inversion and the
re-linearisation alike.

`use_conv` adds the conv blocks of `model.attention_variants` to the two
FF couplings (m2' = m2 + FF(m1') + conv(m1'), and likewise for x2'), as
the JAX layer does: x2' = x2 + f(x1') inverts whatever f holds.

The inversion is exact algebra but not exact arithmetic: run the trunk
in fp32 where the reconstruction matters (bf16 streams drift by ~1e-2).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from alphafold2_tpu_torch.model.attention_variants import (
    DEFAULT_CONV_MSA_KERNELS, DEFAULT_CONV_SEQ_KERNELS, MultiKernelConvBlock)
from alphafold2_tpu_torch.model.evoformer import (MsaAttentionBlock,
                                                  PairwiseAttentionBlock)
from alphafold2_tpu_torch.model.primitives import FeedForward
from alphafold2_tpu_torch.parallel.sharding import (active_mesh, manual_axes,
                                                    use_mesh)

_SEED_MIX = 0x9E3779B97F4A7C15
_SEED_RANGE = 2 ** 62


class RevEvoLayer(nn.Module):
    """The four coupling functions of one reversible Evoformer layer;
    each returns its delta (the coupling adds the residual)."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 global_column_attn: bool = False, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, use_conv: bool = False,
                 conv_seq_kernels=DEFAULT_CONV_SEQ_KERNELS,
                 conv_msa_kernels=DEFAULT_CONV_MSA_KERNELS,
                 conv_dilations=(1,), ring_attention: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.msa_attn = MsaAttentionBlock(dim, heads, dim_head,
                                          dropout=attn_dropout,
                                          ring_attention=ring_attention,
                                          dtype=dtype)
        self.msa_ff = FeedForward(dim, dropout=ff_dropout, dtype=dtype)
        self.pair_attn = PairwiseAttentionBlock(
            dim, heads, dim_head, dropout=attn_dropout,
            global_column_attn=global_column_attn,
            ring_attention=ring_attention, dtype=dtype)
        self.pair_ff = FeedForward(dim, dropout=ff_dropout, dtype=dtype)
        self.msa_conv = self.pair_conv = None
        if use_conv:
            self.msa_conv = MultiKernelConvBlock(
                dim, conv_msa_kernels, conv_dilations, dtype=dtype)
            self.pair_conv = MultiKernelConvBlock(
                dim, conv_seq_kernels, conv_dilations, dtype=dtype)

    def delta_msa(self, m2, x_ctx, msa_mask, train, generator):
        return self.msa_attn(m2, mask=msa_mask, pairwise_repr=x_ctx,
                             train=train, generator=generator) - m2

    def delta_msa_ff(self, m1, msa_mask, train, generator):
        out = self.msa_ff(m1, train=train, generator=generator)
        if self.msa_conv is not None:
            out = out + self.msa_conv(m1, mask=msa_mask)
        return out

    def delta_pair(self, x2, m_ctx, mask, msa_mask, train, generator):
        return self.pair_attn(x2, mask=mask, msa_repr=m_ctx,
                              msa_mask=msa_mask, train=train,
                              generator=generator) - x2

    def delta_pair_ff(self, x1, mask, train, generator):
        out = self.pair_ff(x1, train=train, generator=generator)
        if self.pair_conv is not None:
            out = out + self.pair_conv(x1, mask=mask)
        return out


def coupling_generators(seed: Optional[int], layer: int, device
                        ) -> List[Optional[torch.Generator]]:
    """The four couplings' dropout generators of layer `layer`, fresh
    (at their seeds' start) on every call; None without a seed."""
    if seed is None:
        return [None] * 4
    return [torch.Generator(device=device).manual_seed(
        (seed + _SEED_MIX * (4 * layer + j + 1)) % _SEED_RANGE)
        for j in range(4)]


def layer_forward(layer: RevEvoLayer, streams, mask, msa_mask,
                  train: bool = False, gens: Sequence = (None,) * 4):
    """One layer's couplings: (x1, x2, m1, m2) -> the layer's output
    streams."""
    x1, x2, m1, m2 = streams
    x_in = (x1 + x2) * 0.5
    m1 = m1 + layer.delta_msa(m2, x_in, msa_mask, train, gens[0])
    m2 = m2 + layer.delta_msa_ff(m1, msa_mask, train, gens[1])
    m_out = (m1 + m2) * 0.5
    x1 = x1 + layer.delta_pair(x2, m_out, mask, msa_mask, train, gens[2])
    x2 = x2 + layer.delta_pair_ff(x1, mask, train, gens[3])
    return x1, x2, m1, m2


def layer_inverse(layer: RevEvoLayer, streams, mask, msa_mask,
                  train: bool = False, gens: Sequence = (None,) * 4):
    """The algebraic inverse of `layer_forward` (fresh generators of the
    same seeds subtract the same dropout-realised deltas)."""
    x1, x2, m1, m2 = streams
    x2 = x2 - layer.delta_pair_ff(x1, mask, train, gens[3])
    m_out = (m1 + m2) * 0.5
    x1 = x1 - layer.delta_pair(x2, m_out, mask, msa_mask, train, gens[2])
    m2 = m2 - layer.delta_msa_ff(m1, msa_mask, train, gens[1])
    x_in = (x1 + x2) * 0.5
    m1 = m1 - layer.delta_msa(m2, x_in, msa_mask, train, gens[0])
    return x1, x2, m1, m2


def run_layers(layers, streams, mask, msa_mask, train: bool = False,
               seed: Optional[int] = None, device=None, inverse=False):
    """Every layer forward in order, or (`inverse`) every inverse from
    the top: outside `ReversibleEvoformer`'s autograd function, this is
    plain autograd through the same layers (or the reconstruction of
    the inputs from the outputs)."""
    order = range(len(layers) - 1, -1, -1) if inverse else range(len(layers))
    step = layer_inverse if inverse else layer_forward
    for i in order:
        streams = step(layers[i], streams, mask, msa_mask, train,
                       coupling_generators(seed, i, device))
    return streams


class _ReversibleStack(torch.autograd.Function):
    """The depth stack: the forward stores only its output streams; the
    backward inverts and re-linearises one layer at a time."""

    @staticmethod
    def forward(ctx, trunk, mask, msa_mask, train, seed, device, x1, x2, m1,
                m2, *params):
        out = run_layers(trunk.rev_layers, (x1, x2, m1, m2), mask, msa_mask,
                         train, seed, device)
        ctx.trunk, ctx.train, ctx.seed, ctx.device = trunk, train, seed, \
            device
        ctx.masks = (mask, msa_mask)
        # the backward re-runs the layers under the forward's mesh
        ctx.mesh = (active_mesh(), manual_axes())
        ctx.save_for_backward(*out)
        return out

    @staticmethod
    def backward(ctx, *grads):
        with use_mesh(*ctx.mesh):
            return _ReversibleStack._backward(ctx, grads)

    @staticmethod
    def _backward(ctx, grads):
        layers = ctx.trunk.rev_layers
        mask, msa_mask = ctx.masks
        streams = tuple(s.detach() for s in ctx.saved_tensors)
        grads = tuple(torch.zeros_like(s) if g is None else g
                      for s, g in zip(streams, grads))
        param_grads = []
        for i in range(len(layers) - 1, -1, -1):
            layer = layers[i]
            with torch.no_grad():
                streams = layer_inverse(
                    layer, streams, mask, msa_mask, ctx.train,
                    coupling_generators(ctx.seed, i, ctx.device))
            params = list(layer.parameters())
            live = [p for p in params if p.requires_grad]
            with torch.enable_grad():
                leaves = tuple(s.detach().requires_grad_() for s in streams)
                out = layer_forward(
                    layer, leaves, mask, msa_mask, ctx.train,
                    coupling_generators(ctx.seed, i, ctx.device))
                got = torch.autograd.grad(out, leaves + tuple(live), grads,
                                          allow_unused=True)
            grads = tuple(torch.zeros_like(s) if g is None else g
                          for s, g in zip(streams, got[:4]))
            it = iter(got[4:])
            param_grads[:0] = [next(it) if p.requires_grad else None
                               for p in params]
        return (None,) * 6 + grads + tuple(param_grads)


class ReversibleEvoformer(nn.Module):
    """The trunk with the plain `Evoformer`'s (x, m, mask, msa_mask) ->
    (x, m) contract: both tracks start as two equal streams and leave as
    their mean. Under gradients the stack runs through
    `_ReversibleStack`; without, it is the plain loop."""

    def __init__(self, dim: int, depth: int, heads: int = 8,
                 dim_head: int = 64, global_column_attn: bool = False,
                 use_conv: bool = False,
                 conv_seq_kernels=DEFAULT_CONV_SEQ_KERNELS,
                 conv_msa_kernels=DEFAULT_CONV_MSA_KERNELS,
                 conv_dilations=(1,), attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, ring_attention: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.has_dropout = attn_dropout > 0.0 or ff_dropout > 0.0
        self.rev_layers = nn.ModuleList(
            RevEvoLayer(dim, heads, dim_head,
                        global_column_attn=global_column_attn,
                        attn_dropout=attn_dropout, ff_dropout=ff_dropout,
                        ring_attention=ring_attention,
                        use_conv=use_conv, conv_seq_kernels=conv_seq_kernels,
                        conv_msa_kernels=conv_msa_kernels,
                        conv_dilations=conv_dilations, dtype=dtype)
            for _ in range(depth))

    def dropout_seed(self, train: bool,
                     generator: Optional[torch.Generator]):
        """(base seed, generator device) of one training forward's
        dropout, drawn from `generator`; (None, None) without dropout."""
        if not (train and self.has_dropout):
            return None, None
        device = torch.device("cpu") if generator is None \
            else generator.device
        seed = int(torch.randint(0, _SEED_RANGE, (1,), generator=generator,
                                 device=device).item())
        return seed, device

    def forward(self, x, m, mask=None, msa_mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        seed, device = self.dropout_seed(train, generator)
        streams = (x, x, m, m)
        if torch.is_grad_enabled():
            params = [p for layer in self.rev_layers
                      for p in layer.parameters()]
            streams = _ReversibleStack.apply(self, mask, msa_mask, train,
                                             seed, device, *streams, *params)
        else:
            streams = run_layers(self.rev_layers, streams, mask, msa_mask,
                                 train, seed, device)
        x1, x2, m1, m2 = streams
        return (x1 + x2) * 0.5, (m1 + m2) * 0.5
