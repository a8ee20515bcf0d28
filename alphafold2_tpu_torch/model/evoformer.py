"""Evoformer trunk in PyTorch (counterpart of
`alphafold2_tpu/model/evoformer.py`).

`PairwiseAttentionBlock` (outer-mean ingest, triangle multiplication out
and in, triangle attention out and in), `MsaAttentionBlock` (pair-biased
row attention, column attention), `EvoformerBlock` and `Evoformer`, a
loop over the layers. `train` and the dropout rates reach every attention
and transition; dropout draws from the `generator` the caller passes.

`use_scan=True` (the JAX default, its `nn.scan` + `nn.remat` stack) runs
each layer under `torch.utils.checkpoint` whenever gradients are on, so
the backward recomputes a layer's interior instead of storing it; with
gradients off, and with `use_scan=False`, it is the plain loop.
`reversible=True` runs the trunk as `model.reversible.ReversibleEvoformer`
(parameters under `rev.rev_layers`). The JAX package's pipeline, ring,
conv and efficient-attention options are not ported: selecting one
raises and names the ROADMAP item that will bring it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from alphafold2_tpu_torch.model.primitives import (
    AxialAttention,
    FeedForward,
    OuterMean,
    TriangleMultiplicativeModule,
    not_ported,
)


class PairwiseAttentionBlock(nn.Module):
    """Pair track: outer-mean ingest of the MSA, triangle multiplication
    out and in, triangle attention out and in, all residual.
    `with_outer_mean=False` builds the block without its `OuterMean`, as
    the template embedder is (flax creates `outer_mean` only when the
    block is called with an MSA, which the template embedder never is)."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 dropout: float = 0.0, global_column_attn: bool = False,
                 outer_mean_reference_scale: bool = False,
                 with_outer_mean: bool = True, dtype=torch.float32):
        super().__init__()
        self.outer_mean = OuterMean(
            dim, reference_scale=outer_mean_reference_scale, dtype=dtype) \
            if with_outer_mean else None
        self.triangle_multiply_outgoing = TriangleMultiplicativeModule(
            dim, mix="outgoing", dtype=dtype)
        self.triangle_multiply_ingoing = TriangleMultiplicativeModule(
            dim, mix="ingoing", dtype=dtype)
        self.triangle_attention_outgoing = AxialAttention(
            dim, heads, dim_head, row_attn=True, col_attn=False,
            accept_edges=True, dropout=dropout, dtype=dtype)
        self.triangle_attention_ingoing = AxialAttention(
            dim, heads, dim_head, row_attn=False, col_attn=True,
            accept_edges=True, global_query_attn=global_column_attn,
            dropout=dropout, dtype=dtype)

    def forward(self, x, mask=None, msa_repr=None, msa_mask=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        if msa_repr is not None:
            if self.outer_mean is None:
                raise ValueError("this pair block was built without an "
                                 "outer mean and takes no MSA")
            x = x + self.outer_mean(msa_repr, mask=msa_mask)
        x = self.triangle_multiply_outgoing(x, mask=mask) + x
        x = self.triangle_multiply_ingoing(x, mask=mask) + x
        x = self.triangle_attention_outgoing(
            x, edges=x, mask=mask, train=train, generator=generator) + x
        x = self.triangle_attention_ingoing(
            x, edges=x, mask=mask, train=train, generator=generator) + x
        return x


class MsaAttentionBlock(nn.Module):
    """MSA track: pair-biased row attention over residues, then column
    attention over alignment rows. Only the "full" row variant is
    ported."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 dropout: float = 0.0, row_variant: str = "full",
                 dtype=torch.float32):
        super().__init__()
        if row_variant != "full":
            not_ported("row_variant", row_variant, "queue 1, item 11")
        self.row_attn = AxialAttention(
            dim, heads, dim_head, row_attn=True, col_attn=False,
            accept_edges=True, dropout=dropout, dtype=dtype)
        # the column track attends alignment rows: a serving spec's
        # residue-axis pattern never applies here, even when the MSA depth
        # equals the bucket length
        self.col_attn = AxialAttention(
            dim, heads, dim_head, row_attn=False, col_attn=True,
            dropout=dropout, sparse_kernel_ok=False, dtype=dtype)

    def forward(self, x, mask=None, pairwise_repr=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.row_attn(x, mask=mask, edges=pairwise_repr, train=train,
                          generator=generator) + x
        x = self.col_attn(x, mask=mask, train=train,
                          generator=generator) + x
        return x


class EvoformerBlock(nn.Module):
    """msa attention -> msa transition -> pair block -> pair transition,
    all residual."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 global_column_attn: bool = False,
                 outer_mean_reference_scale: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.msa_attn = MsaAttentionBlock(dim, heads, dim_head,
                                          dropout=attn_dropout, dtype=dtype)
        self.msa_ff = FeedForward(dim, dropout=ff_dropout, dtype=dtype)
        self.attn = PairwiseAttentionBlock(
            dim, heads, dim_head, dropout=attn_dropout,
            global_column_attn=global_column_attn,
            outer_mean_reference_scale=outer_mean_reference_scale,
            dtype=dtype)
        self.ff = FeedForward(dim, dropout=ff_dropout, dtype=dtype)

    def forward(self, x, m, mask=None, msa_mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        m = self.msa_attn(m, mask=msa_mask, pairwise_repr=x, train=train,
                          generator=generator)
        m = self.msa_ff(m, train=train, generator=generator) + m
        x = self.attn(x, mask=mask, msa_repr=m, msa_mask=msa_mask,
                      train=train, generator=generator)
        x = self.ff(x, train=train, generator=generator) + x
        return x, m


# options of the JAX Evoformer that the port refuses, with their defaults
# and the ROADMAP item that ports them
_NOT_PORTED = {
    "ring_attention": (False, "queue 1, item 10 (parallel/ring.py)"),
    "pipeline_stages": (1, "queue 1, item 10 (parallel/pipeline.py)"),
    "use_conv": (False, "queue 1, item 11 (attention_variants.py)"),
    "conv_seq_kernels": (((9, 1), (1, 9), (3, 3)),
                         "queue 1, item 11 (attention_variants.py)"),
    "conv_msa_kernels": (((1, 9), (3, 3)),
                         "queue 1, item 11 (attention_variants.py)"),
    "conv_dilations": ((1,), "queue 1, item 11 (attention_variants.py)"),
    "sparse_self_attn": (False, "queue 1, item 11 "
                         "(attention_variants.BlockSparseAttention)"),
    "linear_attn": (False, "queue 1, item 11 (attention_variants.py)"),
    "kron_attn": (False, "queue 1, item 11 (attention_variants.py)"),
    "kv_compress_ratio": (0, "queue 1, item 11 (attention_variants.py)"),
}


def check_not_ported(options: dict):
    for name, value in options.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"Evoformer got an unexpected option {name!r}")
        default, roadmap = _NOT_PORTED[name]
        if value != default:
            not_ported(name, value, roadmap)


def _rematerialised(layer: EvoformerBlock, x, m, mask, msa_mask,
                    train: bool, generator: Optional[torch.Generator]):
    """One layer under `torch.utils.checkpoint`. The recompute in the
    backward must draw the dropout masks the forward drew: checkpoint
    replays the default generators itself, and an explicit `generator`
    is replayed here (set to its state before the layer for the
    recompute, then put back where the run had taken it)."""
    if generator is None or not train:
        return checkpoint(layer, x, m, mask, msa_mask, train, generator,
                          use_reentrant=False)
    before = generator.get_state()
    calls = []

    def run(x, m):
        if not calls:
            calls.append(True)
            return layer(x, m, mask, msa_mask, train, generator)
        after = generator.get_state()
        generator.set_state(before)
        try:
            return layer(x, m, mask, msa_mask, train, generator)
        finally:
            generator.set_state(after)

    return checkpoint(run, x, m, use_reentrant=False)


class Evoformer(nn.Module):
    """depth x EvoformerBlock; under gradients with `use_scan` each layer
    is rematerialised (checkpointed). `reversible` builds the reversible
    trunk instead."""

    def __init__(self, dim: int, depth: int, heads: int = 8,
                 dim_head: int = 64, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, global_column_attn: bool = False,
                 outer_mean_reference_scale: bool = False,
                 use_scan: bool = True, reversible: bool = False,
                 dtype=torch.float32, **options):
        super().__init__()
        if reversible:
            # the JAX package's refusals of the reversible trunk
            if options.get("pipeline_stages", 1) > 1:
                raise ValueError("pipeline_stages>1 is not supported with "
                                 "the reversible trunk")
            if outer_mean_reference_scale:
                raise ValueError("reversible trunk does not support "
                                 "outer_mean_reference_scale yet")
        check_not_ported(options)
        self.use_scan = use_scan
        self.rev = None
        if reversible:
            from alphafold2_tpu_torch.model.reversible import (
                ReversibleEvoformer)
            self.rev = ReversibleEvoformer(
                dim, depth, heads=heads, dim_head=dim_head,
                global_column_attn=global_column_attn,
                attn_dropout=attn_dropout, ff_dropout=ff_dropout,
                dtype=dtype)
            return
        self.layers = nn.ModuleList(
            EvoformerBlock(dim, heads, dim_head, attn_dropout=attn_dropout,
                           ff_dropout=ff_dropout,
                           global_column_attn=global_column_attn,
                           outer_mean_reference_scale=(
                               outer_mean_reference_scale),
                           dtype=dtype)
            for _ in range(depth))

    def forward(self, x, m, mask=None, msa_mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.rev is not None:
            return self.rev(x, m, mask=mask, msa_mask=msa_mask, train=train,
                            generator=generator)
        remat = self.use_scan and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x, m = _rematerialised(layer, x, m, mask, msa_mask, train,
                                       generator)
            else:
                x, m = layer(x, m, mask=mask, msa_mask=msa_mask,
                             train=train, generator=generator)
        return x, m
