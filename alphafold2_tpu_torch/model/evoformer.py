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
(parameters under `rev.rev_layers`). `use_conv` adds the conv blocks of
`model.attention_variants` to both tracks, and the efficient-attention
menu (`sparse_self_attn`, `linear_attn`, `kron_attn`,
`kv_compress_ratio`: a bool or int for every layer, or one entry per
layer) swaps the MSA row attention of each layer for a variant, as the
JAX `Evoformer._row_variants` resolves it.

Under an active mesh (`parallel.use_mesh`) the blocks place the pair and
MSA activations with `shard_pair` / `shard_msa` where the JAX blocks do.
`ring_attention=True` runs the two triangle attentions and the MSA row
attention ring-parallel when the mesh shards their attended axis.
`pipeline_stages=S` runs the trunk as a GPipe pipeline over the mesh's
``pipe`` axis (`_pipeline_forward`): stage s applies layers
[s * depth / S, (s + 1) * depth / S) on the ranks at pipe coordinate s,
over `pipeline_microbatches` microbatches. The menu and the conv blocks
have no sharded rule: under a mesh they run on the gathered activations.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from alphafold2_tpu_torch.model.attention_variants import (
    DEFAULT_CONV_MSA_KERNELS,
    DEFAULT_CONV_SEQ_KERNELS,
    BlockSparseAttention,
    LinearAttention,
    MemoryCompressedAttention,
    MultiKernelConvBlock,
    PerformerAttention,
    kronecker_pool_2d,
)
from alphafold2_tpu_torch.model.primitives import (
    Attention,
    AxialAttention,
    FeedForward,
    LayerNorm,
    OuterMean,
    TriangleMultiplicativeModule,
)
from alphafold2_tpu_torch.parallel.mesh import (DATA_AXIS, PAIR_I_AXIS,
                                                PAIR_J_AXIS, PIPE_AXIS)
from alphafold2_tpu_torch.parallel.sharding import (active_mesh, clean_spec,
                                                    is_dtensor, keep_mesh,
                                                    msa_spec,
                                                    pair_spec,
                                                    replicated_call,
                                                    shard_msa, shard_pair,
                                                    to_spec)

ROW_VARIANTS = ("full", "sparse", "linear", "compress", "kron")


class PairwiseAttentionBlock(nn.Module):
    """Pair track: outer-mean ingest of the MSA, triangle multiplication
    out and in, triangle attention out and in, all residual.
    `with_outer_mean=False` builds the block without its `OuterMean`, as
    the template embedder is (flax creates `outer_mean` only when the
    block is called with an MSA, which the template embedder never is)."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 dropout: float = 0.0, global_column_attn: bool = False,
                 outer_mean_reference_scale: bool = False,
                 with_outer_mean: bool = True, ring_attention: bool = False,
                 dtype=torch.float32):
        super().__init__()
        ring_axes = (PAIR_I_AXIS, PAIR_J_AXIS) if ring_attention else None
        self.outer_mean = OuterMean(
            dim, reference_scale=outer_mean_reference_scale, dtype=dtype) \
            if with_outer_mean else None
        self.triangle_multiply_outgoing = TriangleMultiplicativeModule(
            dim, mix="outgoing", dtype=dtype)
        self.triangle_multiply_ingoing = TriangleMultiplicativeModule(
            dim, mix="ingoing", dtype=dtype)
        self.triangle_attention_outgoing = AxialAttention(
            dim, heads, dim_head, row_attn=True, col_attn=False,
            accept_edges=True, dropout=dropout, ring_axes=ring_axes,
            dtype=dtype)
        self.triangle_attention_ingoing = AxialAttention(
            dim, heads, dim_head, row_attn=False, col_attn=True,
            accept_edges=True, global_query_attn=global_column_attn,
            dropout=dropout, ring_axes=ring_axes, dtype=dtype)

    def forward(self, x, mask=None, msa_repr=None, msa_mask=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        if msa_repr is not None:
            if self.outer_mean is None:
                raise ValueError("this pair block was built without an "
                                 "outer mean and takes no MSA")
            x = x + self.outer_mean(msa_repr, mask=msa_mask)
            x = shard_pair(x)
        x = self.triangle_multiply_outgoing(x, mask=mask) + x
        x = self.triangle_multiply_ingoing(x, mask=mask) + x
        x = shard_pair(x)
        x = self.triangle_attention_outgoing(
            x, edges=x, mask=mask, train=train, generator=generator) + x
        x = self.triangle_attention_ingoing(
            x, edges=x, mask=mask, train=train, generator=generator) + x
        return shard_pair(x)


class MsaAttentionBlock(nn.Module):
    """MSA track: row attention over residues, then column attention over
    alignment rows. `row_variant` "full" is the pair-biased axial row
    attention; the others fold the alignment rows into the batch behind a
    pre-LayerNorm `row_norm`, take no pair bias, and run
    `attention_variants`' "sparse" (`BlockSparseAttention`), "linear"
    (`PerformerAttention` for `linear_attn_kind` "favor", else
    `LinearAttention`), "compress" (`MemoryCompressedAttention`) or
    "kron" (cross-attention onto the pooled pair map, repeated over the
    rows). `seed` seeds the Performer's inference projection."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 dropout: float = 0.0, row_variant: str = "full",
                 sparse_block: int = 32, sparse_num_global: int = 1,
                 sparse_window: int = 1, kv_compress_ratio: int = 2,
                 linear_attn_kind: str = "favor",
                 performer_nb_features: int = 256, seed: int = 0,
                 ring_attention: bool = False, dtype=torch.float32):
        super().__init__()
        if row_variant not in ROW_VARIANTS:
            raise ValueError(f"unknown row_variant {row_variant!r}")
        self.row_variant = row_variant
        kw = dict(heads=heads, dim_head=dim_head, dtype=dtype)
        if row_variant == "full":
            self.row_attn = AxialAttention(
                dim, heads, dim_head, row_attn=True, col_attn=False,
                accept_edges=True, dropout=dropout,
                ring_axes=(None, PAIR_I_AXIS) if ring_attention else None,
                dtype=dtype)
        else:
            self.row_norm = LayerNorm(dim, dtype)
            if row_variant == "sparse":
                self.row_attn = BlockSparseAttention(
                    dim, block=sparse_block, num_global=sparse_num_global,
                    window=sparse_window, dropout=dropout, **kw)
            elif row_variant == "linear" and linear_attn_kind == "favor":
                self.row_attn = PerformerAttention(
                    dim, nb_features=performer_nb_features, seed=seed, **kw)
            elif row_variant == "linear":
                self.row_attn = LinearAttention(dim, **kw)
            elif row_variant == "compress":
                self.row_attn = MemoryCompressedAttention(
                    dim, compress_ratio=kv_compress_ratio, dropout=dropout,
                    **kw)
            else:
                self.row_attn = Attention(dim, dropout=dropout, **kw)
        # the column track attends alignment rows: a serving spec's
        # residue-axis pattern never applies here, even when the MSA depth
        # equals the bucket length
        self.col_attn = AxialAttention(
            dim, heads, dim_head, row_attn=False, col_attn=True,
            dropout=dropout, sparse_kernel_ok=False, dtype=dtype)

    def forward(self, x, mask=None, pairwise_repr=None, pair_mask=None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.row_variant == "full":
            x = self.row_attn(x, mask=mask, edges=pairwise_repr,
                              train=train, generator=generator) + x
        else:
            x = self._row_variant_attn(x, mask, pairwise_repr, pair_mask,
                                       train, generator) + x
        x = self.col_attn(x, mask=mask, train=train,
                          generator=generator) + x
        return shard_msa(x)

    def _row_variant_attn(self, x, mask, pairwise_repr, pair_mask, train,
                          generator):
        if is_dtensor(x) or is_dtensor(pairwise_repr):
            return replicated_call(
                lambda xs, pair: self._row_variant_attn(
                    xs, mask, pair, pair_mask, train, generator),
                x, pairwise_repr)
        b, rows, n, d = x.shape
        hf = self.row_norm(x).reshape(b * rows, n, d)
        mf = None if mask is None else mask.reshape(b * rows, n)
        if isinstance(self.row_attn, LinearAttention):
            out = self.row_attn(hf, mask=mf)
        elif self.row_variant != "kron":
            out = self.row_attn(hf, mask=mf, train=train,
                                generator=generator)
        else:
            if pairwise_repr is None:
                raise ValueError("row_variant='kron' needs the pair "
                                 "representation")
            pooled, tmask = kronecker_pool_2d(pairwise_repr, pair_mask)
            # one pooled context per batch item, shared by its rows
            pooled = pooled.repeat_interleave(rows, dim=0)
            tmask = tmask.repeat_interleave(rows, dim=0)
            if mf is None:
                # the key mask exists only beside a query mask: all ones,
                # so padded pooled tokens stay masked
                mf = torch.ones(b * rows, n, dtype=torch.bool,
                                device=x.device)
            out = self.row_attn(hf, mask=mf, context=pooled,
                                context_mask=tmask, train=train,
                                generator=generator)
        return out.reshape(b, rows, n, d)


class EvoformerBlock(nn.Module):
    """msa attention -> msa transition (-> msa conv) -> pair block -> pair
    transition (-> pair conv), all residual. `use_conv` adds
    `MultiKernelConvBlock`s, `conv_msa_kernels` over the (rows, n) MSA
    and `conv_seq_kernels` over the (n, n) pair, each at every one of
    `conv_dilations`."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 attn_dropout: float = 0.0, ff_dropout: float = 0.0,
                 global_column_attn: bool = False,
                 outer_mean_reference_scale: bool = False,
                 use_conv: bool = False,
                 conv_seq_kernels=DEFAULT_CONV_SEQ_KERNELS,
                 conv_msa_kernels=DEFAULT_CONV_MSA_KERNELS,
                 conv_dilations=(1,), msa_row_variant: str = "full",
                 ring_attention: bool = False, dtype=torch.float32,
                 **row_options):
        super().__init__()
        self.msa_attn = MsaAttentionBlock(dim, heads, dim_head,
                                          dropout=attn_dropout,
                                          row_variant=msa_row_variant,
                                          ring_attention=ring_attention,
                                          dtype=dtype, **row_options)
        self.msa_ff = FeedForward(dim, dropout=ff_dropout, dtype=dtype)
        self.attn = PairwiseAttentionBlock(
            dim, heads, dim_head, dropout=attn_dropout,
            global_column_attn=global_column_attn,
            outer_mean_reference_scale=outer_mean_reference_scale,
            ring_attention=ring_attention, dtype=dtype)
        self.ff = FeedForward(dim, dropout=ff_dropout, dtype=dtype)
        self.msa_conv = self.pair_conv = None
        if use_conv:
            self.msa_conv = MultiKernelConvBlock(
                dim, conv_msa_kernels, conv_dilations, dtype=dtype)
            self.pair_conv = MultiKernelConvBlock(
                dim, conv_seq_kernels, conv_dilations, dtype=dtype)

    def forward(self, x, m, mask=None, msa_mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        m = self.msa_attn(m, mask=msa_mask, pairwise_repr=x, pair_mask=mask,
                          train=train, generator=generator)
        m = self.msa_ff(m, train=train, generator=generator) + m
        if self.msa_conv is not None:
            m = replicated_call(lambda t: self.msa_conv(t, mask=msa_mask),
                                m) + m
        x = self.attn(x, mask=mask, msa_repr=m, msa_mask=msa_mask,
                      train=train, generator=generator)
        x = self.ff(x, train=train, generator=generator) + x
        if self.pair_conv is not None:
            x = replicated_call(lambda t: self.pair_conv(t, mask=mask),
                                x) + x
        return x, m


def row_variants(depth: int, sparse_self_attn=False, linear_attn=False,
                 kron_attn=False, kv_compress_ratio=0):
    """Per-layer MSA row variants and kv-pool ratios, as the JAX
    `Evoformer._row_variants` resolves the menu: each flag is one value
    for every layer or a tuple / list with one per layer; at most one
    variant per layer."""
    def flags(v, label):
        if isinstance(v, (tuple, list)):
            if len(v) != depth:
                raise ValueError(f"{label} tuple has {len(v)} entries for "
                                 f"depth {depth}")
            return tuple(bool(b) for b in v)
        return (bool(v),) * depth

    sp = flags(sparse_self_attn, "sparse_self_attn")
    li = flags(linear_attn, "linear_attn")
    kr = flags(kron_attn, "kron_attn")
    cr = kv_compress_ratio
    if isinstance(cr, (tuple, list)):
        if len(cr) != depth:
            raise ValueError(f"kv_compress_ratio tuple has {len(cr)} "
                             f"entries for depth {depth}")
        cr = tuple(int(c) for c in cr)
    else:
        cr = (int(cr),) * depth
    variants = []
    for i in range(depth):
        picks = [name for name, on in (
            ("sparse", sp[i]), ("linear", li[i]), ("kron", kr[i]),
            ("compress", cr[i] > 0)) if on]
        if len(picks) > 1:
            raise ValueError(
                f"layer {i}: conflicting attention variants {picks} — at "
                f"most one of sparse_self_attn/linear_attn/kron_attn/"
                f"kv_compress_ratio per layer")
        variants.append(picks[0] if picks else "full")
    return tuple(variants), cr


def _rematerialised(layer: EvoformerBlock, x, m, mask, msa_mask,
                    train: bool, generator: Optional[torch.Generator]):
    """One layer under `torch.utils.checkpoint`. The recompute in the
    backward must draw the dropout masks the forward drew: checkpoint
    replays the default generators itself, and an explicit `generator`
    is replayed here (set to its state before the layer for the
    recompute, then put back where the run had taken it)."""
    call = keep_mesh(layer)
    if generator is None or not train:
        return checkpoint(call, x, m, mask, msa_mask, train, generator,
                          use_reentrant=False)
    before = generator.get_state()
    calls = []

    def run(x, m):
        if not calls:
            calls.append(True)
            return call(x, m, mask, msa_mask, train, generator)
        after = generator.get_state()
        generator.set_state(before)
        try:
            return call(x, m, mask, msa_mask, train, generator)
        finally:
            generator.set_state(after)

    return checkpoint(run, x, m, use_reentrant=False)


class Evoformer(nn.Module):
    """depth x EvoformerBlock; under gradients with `use_scan` each layer
    is rematerialised (checkpointed). `reversible` builds the reversible
    trunk instead. `ring_attention` and `pipeline_stages` /
    `pipeline_microbatches` are the mesh options (module doc). The menu
    is refused beside `reversible`, `pipeline_stages > 1` or
    `ring_attention`, and the pipeline beside the reversible or an
    unscanned trunk, with the JAX messages."""

    def __init__(self, dim: int, depth: int, heads: int = 8,
                 dim_head: int = 64, attn_dropout: float = 0.0,
                 ff_dropout: float = 0.0, global_column_attn: bool = False,
                 outer_mean_reference_scale: bool = False,
                 use_scan: bool = True, reversible: bool = False,
                 use_conv: bool = False,
                 conv_seq_kernels=DEFAULT_CONV_SEQ_KERNELS,
                 conv_msa_kernels=DEFAULT_CONV_MSA_KERNELS,
                 conv_dilations=(1,), sparse_self_attn=False,
                 linear_attn=False, kron_attn=False, kv_compress_ratio=0,
                 sparse_block: int = 32, sparse_num_global: int = 1,
                 sparse_window: int = 1, linear_attn_kind: str = "favor",
                 performer_nb_features: int = 256,
                 ring_attention: bool = False, pipeline_stages: int = 1,
                 pipeline_microbatches: int = 0, dtype=torch.float32):
        super().__init__()
        variants, ratios = row_variants(depth, sparse_self_attn,
                                        linear_attn, kron_attn,
                                        kv_compress_ratio)
        if any(v != "full" for v in variants):
            if pipeline_stages > 1 or reversible:
                raise ValueError(
                    "the efficient-attention menu is not supported with "
                    "pipeline_stages>1 or reversible=True")
            if ring_attention:
                raise ValueError(
                    "the efficient-attention menu is not supported with "
                    "ring_attention=True (the variant row track is not "
                    "ring-parallel)")
        if pipeline_stages > 1:
            if reversible:
                raise ValueError("pipeline_stages>1 is not supported with "
                                 "the reversible trunk (pp regroups the "
                                 "scan-stacked params)")
            if not use_scan or depth <= 1:
                raise ValueError("pipeline_stages>1 requires use_scan=True "
                                 "and depth>1")
        if reversible and outer_mean_reference_scale:
            raise ValueError("reversible trunk does not support "
                             "outer_mean_reference_scale yet")
        self.depth = depth
        self.use_scan = use_scan
        self.pipeline_stages = pipeline_stages
        self.pipeline_microbatches = pipeline_microbatches
        self.has_dropout = attn_dropout > 0.0 or ff_dropout > 0.0
        self.rev = None
        conv = dict(use_conv=use_conv, conv_seq_kernels=conv_seq_kernels,
                    conv_msa_kernels=conv_msa_kernels,
                    conv_dilations=conv_dilations)
        if reversible:
            from alphafold2_tpu_torch.model.reversible import (
                ReversibleEvoformer)
            self.rev = ReversibleEvoformer(
                dim, depth, heads=heads, dim_head=dim_head,
                global_column_attn=global_column_attn,
                attn_dropout=attn_dropout, ff_dropout=ff_dropout,
                ring_attention=ring_attention, dtype=dtype, **conv)
            return
        self.layers = nn.ModuleList(
            EvoformerBlock(dim, heads, dim_head, attn_dropout=attn_dropout,
                           ff_dropout=ff_dropout,
                           global_column_attn=global_column_attn,
                           outer_mean_reference_scale=(
                               outer_mean_reference_scale),
                           msa_row_variant=variants[i],
                           sparse_block=sparse_block,
                           sparse_num_global=sparse_num_global,
                           sparse_window=sparse_window,
                           # a layer without compression keeps the JAX
                           # block's default ratio
                           kv_compress_ratio=ratios[i] or 2,
                           linear_attn_kind=linear_attn_kind,
                           performer_nb_features=performer_nb_features,
                           seed=i, ring_attention=ring_attention,
                           dtype=dtype, **conv)
            for i in range(depth))

    def _pipeline_ready(self):
        """The active mesh if the pipeline path applies, else None."""
        if self.pipeline_stages <= 1:
            return None
        mesh = active_mesh()
        if mesh is None or PIPE_AXIS not in mesh.shape:
            return None
        if mesh.shape[PIPE_AXIS] != self.pipeline_stages:
            raise ValueError(
                f"pipeline_stages={self.pipeline_stages} but mesh "
                f"'{PIPE_AXIS}' axis has {mesh.shape[PIPE_AXIS]} devices")
        if self.depth % self.pipeline_stages:
            raise ValueError(
                f"depth {self.depth} not divisible into "
                f"{self.pipeline_stages} pipeline stages")
        return mesh

    def pipelined_parameters(self) -> list:
        """The parameters each pipeline stage updates alone: their
        gradients are summed over ``pipe`` after the backward
        (`parallel.pipeline.sync_stage_grads`)."""
        if self.pipeline_stages <= 1 or self.rev is not None:
            return []
        return list(self.layers.parameters())

    def _pipeline_forward(self, mesh, x, m, mask, msa_mask, train,
                          generator):
        """GPipe over the layers (`parallel.pipeline.gpipe`): the rank at
        pipe coordinate s runs layers [s * depth / S, (s + 1) * depth / S)
        on each microbatch, rematerialised under gradients as the scanned
        trunk is. The pair and MSA activations hop between stages as the
        rank's local blocks of their `shard_pair` / `shard_msa`
        placements, so the pipeline composes with data parallelism (each
        rank microbatches its own rows) and with the 2-D pair sharding
        inside a stage. Dropout draws from one generator per
        (microbatch, layer), seeded from one draw of `generator`."""
        from torch.distributed.tensor import DTensor

        from alphafold2_tpu_torch.parallel.pipeline import (gpipe,
                                                            microbatch,
                                                            stage_input,
                                                            unmicrobatch)
        from alphafold2_tpu_torch.parallel.ring import _seed_of

        s_count = self.pipeline_stages
        per = self.depth // s_count
        stage = mesh.coord(PIPE_AXIS)
        b = x.shape[0]
        data_n = mesh.shape.get(DATA_AXIS, 1)
        if self.pipeline_microbatches:
            m_count = self.pipeline_microbatches
        else:
            # the most microbatches whose batch still tiles over `data`
            m_count = b // data_n if (data_n > 1 and b % data_n == 0) \
                else b
        if b % m_count:
            raise ValueError(f"batch {b} not divisible into {m_count} "
                             "microbatches")
        x_spec = clean_spec(mesh, pair_spec(), x.shape)
        m_spec = clean_spec(mesh, msa_spec(), m.shape)
        n_data = mesh.shape[DATA_AXIS] if x_spec[0] == DATA_AXIS and \
            m_spec[0] == DATA_AXIS else 1
        if (b // n_data) % m_count:
            # the rows of a rank do not split into the microbatches:
            # keep the batch whole on every rank
            x_spec[0] = m_spec[0] = None
            n_data = 1
        x_d, m_d = to_spec(x, mesh, x_spec), to_spec(m, mesh, m_spec)
        x_pl, m_pl = x_d.placements, m_d.placements
        b_local = b // n_data
        per_mb = b_local // m_count

        def rows(mb):
            return torch.tensor([d * b_local + mb * per_mb + r
                                 for d in range(n_data)
                                 for r in range(per_mb)],
                                device=x_d.to_local().device)

        seed = None
        gen_device = torch.device("cpu") if generator is None \
            else generator.device
        if train and self.has_dropout:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=gen_device).item())
        layers = self.layers[stage * per:(stage + 1) * per]
        remat = self.use_scan and torch.is_grad_enabled()

        def stage_fn(_, act, mb):
            xl, ml = act
            xi = DTensor.from_local(xl, mesh.device_mesh, x_pl,
                                    run_check=False)
            mi = DTensor.from_local(ml, mesh.device_mesh, m_pl,
                                    run_check=False)
            at = rows(mb)
            pm = None if mask is None else mask[at]
            mm = None if msa_mask is None else msa_mask[at]
            for j, layer in enumerate(layers):
                gen = None if seed is None else \
                    torch.Generator(device=gen_device).manual_seed(
                        _seed_of(seed, mb, stage * per + j))
                if remat:
                    xi, mi = _rematerialised(layer, xi, mi, pm, mm, train,
                                             gen)
                else:
                    xi, mi = layer(xi, mi, mask=pm, msa_mask=mm,
                                   train=train, generator=gen)
            return (to_spec(xi, mesh, x_spec).to_local(),
                    to_spec(mi, mesh, m_spec).to_local())

        xs = (microbatch(stage_input(x_d, mesh), m_count),
              microbatch(stage_input(m_d, mesh), m_count))
        x_out, m_out = gpipe(stage_fn, None, xs, mesh, PIPE_AXIS,
                             anchors=list(layers.parameters()))
        return (DTensor.from_local(unmicrobatch(x_out), mesh.device_mesh,
                                   x_pl, run_check=False),
                DTensor.from_local(unmicrobatch(m_out), mesh.device_mesh,
                                   m_pl, run_check=False))

    def forward(self, x, m, mask=None, msa_mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        # placement hints at the trunk's entry (no value changes): every
        # block then meets DTensors under a mesh, never a plain tensor
        # that needs a gradient
        x, m = shard_pair(x), shard_msa(m)
        if self.rev is not None:
            return self.rev(x, m, mask=mask, msa_mask=msa_mask, train=train,
                            generator=generator)
        mesh = self._pipeline_ready()
        if mesh is not None:
            return self._pipeline_forward(mesh, x, m, mask, msa_mask, train,
                                          generator)
        remat = self.use_scan and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x, m = _rematerialised(layer, x, m, mask, msa_mask, train,
                                       generator)
            else:
                x, m = layer(x, m, mask=mask, msa_mask=msa_mask,
                             train=train, generator=generator)
        return x, m
