"""Evoformer building blocks in PyTorch (counterpart of
`alphafold2_tpu/model/primitives.py`).

Parameters live in fp32; a module built with `dtype=torch.bfloat16`
computes in bf16 with its fp32 parameters cast down at each call, as the
JAX package's `Dense(dtype=bf16, param_dtype=f32)` does. Attribute names
follow the flax names (`weights.load_jax_params` maps one onto the other).

Every non-global attention, self- or cross- (the template pointwise
attention), goes through `ops.attention.fused_attention`: the CUDA
kernel for tensors on the card, its plain version for tensors on the
CPU. The global-query (`tie_dim`) branch stays
plain PyTorch, as it stays plain XLA in the JAX package. Under an active
`ops.block_sparse.kernel_context` (the serving executor's long buckets),
self-attention whose attended axis has the spec's length goes through
`ops.block_sparse.block_sparse_attention` instead, or, with the spec's
"masked" backend, through the fused attention with the pattern as an
additive bias.

Dropout (FeedForward after the GEGLU, Attention on the softmax weights)
is active only in a forward with `train=True`, and draws from the
`generator` the caller passes (the default generator when None), on the
generator's device. The fused kernel has no dropout: a training pass with
attention dropout warns and takes the plain attention path, and a
block-sparse spec with backend "auto" runs as "masked", as the JAX
package does.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from alphafold2_tpu_torch.ops.attention import MASK_VALUE, fused_attention
from alphafold2_tpu_torch.ops.block_sparse import (active_kernel_plan,
                                                   active_kernel_spec,
                                                   block_sparse_attention,
                                                   kernel_context)
from alphafold2_tpu_torch.parallel.mesh import DATA_AXIS
from alphafold2_tpu_torch.parallel.sharding import (P, active_mesh,
                                                    clean_spec, feature_call,
                                                    is_dtensor, like,
                                                    local_call, spec_of,
                                                    to_spec)


def random_uniform(shape, generator: Optional[torch.Generator],
                   like: torch.Tensor) -> torch.Tensor:
    """U[0, 1) fp32 of `shape` drawn from `generator` (the default
    generator when None) on the generator's device, returned on `like`'s
    device: one seeded CPU generator gives the same draws to a run on
    the CPU and one on the card."""
    device = like.device if generator is None else generator.device
    return torch.rand(shape, generator=generator,
                      device=device).to(like.device)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout as flax's `nn.Dropout`: keep with probability
    1 - rate and scale the kept values by 1 / (1 - rate)."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = random_uniform(x.shape, generator, x) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Dense(nn.Linear):
    """`nn.Linear` with fp32 parameters that computes in `dtype`.

    `init` names the flax initialiser this layer copies: "default"
    (normal weights, zero bias), "zeros" (zero-initialised output
    projections) or "gate" (zero weights, bias one: a sigmoid gate that
    starts as pass-through)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.float32,
                 init: str = "default"):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=torch.float32)
        self.compute_dtype = dtype
        self.init_kind = init

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if is_dtensor(x):
            return feature_call(F.linear, x.to(dt), self.weight.to(dt), bias)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with epsilon 1e-5 and fp32 parameters and statistics;
    the output is cast to `dtype`."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__(dim, eps=1e-5, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        if is_dtensor(x):
            return feature_call(self._norm, x, self.weight, self.bias)
        return self._norm(x, self.weight, self.bias)

    def _norm(self, x, weight, bias):
        return F.layer_norm(x.float(), self.normalized_shape, weight, bias,
                            self.eps).to(self.compute_dtype)


def init_weights(module: nn.Module, generator: torch.Generator):
    """Draw every parameter of `module` from `generator` the way the flax
    initialisers lay them out: normal(0, 1/sqrt(fan_in)) weights and zero
    biases for Dense and Conv2d, zero or gate layers where flax
    zero-initialises, ones/zeros for LayerNorm, normal embedding
    tables."""

    def draw(p, std):
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=generator) * std)

    for mod in module.modules():
        with torch.no_grad():
            if isinstance(mod, Dense):
                if mod.init_kind == "default":
                    draw(mod.weight, mod.in_features ** -0.5)
                else:
                    mod.weight.zero_()
                if mod.bias is not None:
                    mod.bias.fill_(1.0 if mod.init_kind == "gate" else 0.0)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.Conv2d):
                draw(mod.weight, mod.weight[0].numel() ** -0.5)
                mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                draw(mod.weight, mod.num_embeddings ** -0.5)


class GEGLU(nn.Module):
    """x, gates = split(x); x * gelu(gates), with the tanh approximation
    that `jax.nn.gelu` uses by default."""

    def forward(self, x):
        x, gates = x.chunk(2, dim=-1)
        return x * F.gelu(gates, approximate="tanh")


class FeedForward(nn.Module):
    """Transition block: pre-LN -> Linear(dim -> 2*mult*dim) -> GEGLU ->
    dropout (training only) -> zero-initialised Linear."""

    def __init__(self, dim: int, mult: int = 4, dropout: float = 0.0,
                 dtype=torch.float32):
        super().__init__()
        self.dropout = dropout
        self.norm = LayerNorm(dim, dtype)
        self.proj_in = Dense(dim, dim * mult * 2, dtype=dtype)
        self.geglu = GEGLU()
        self.proj_out = Dense(dim * mult, dim, dtype=dtype, init="zeros")

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self.geglu(self.proj_in(self.norm(x)))
        if train:
            x = dropout(x, self.dropout, generator)
        return self.proj_out(x)


class Attention(nn.Module):
    """Gated multi-head attention with an optional additive bias."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 dropout: float = 0.0, gating: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        self.dropout = dropout
        inner = heads * dim_head
        self.to_q = Dense(dim, inner, bias=False, dtype=dtype)
        self.to_kv = Dense(dim, inner * 2, bias=False, dtype=dtype)
        self.gating = Dense(dim, inner, dtype=dtype, init="gate") \
            if gating else None
        self.to_out = Dense(inner, dim, dtype=dtype, init="zeros")

    def project_qkv(self, x, kv_input=None):
        """x: (..., n, d) -> q, k, v (b, h, ..., n, dh), q pre-scaled
        (`split_qkv` scaled by dim_head^-1/2)."""
        q, k, v = self.split_qkv(x, kv_input)
        return q * (self.dim_head ** -0.5), k, v

    def split_qkv(self, x, kv_input=None):
        """x: (..., n, d) -> q, k, v (b, h, ..., n, dh), unscaled; k and
        v come from `kv_input` (x when None). k is the first half of
        to_kv's output, v the second; the inner axis splits head-major."""
        h, dh = self.heads, self.dim_head
        q = self.to_q(x)
        k, v = self.to_kv(x if kv_input is None else kv_input).chunk(
            2, dim=-1)

        def split_heads(t):
            return t.reshape(*t.shape[:-1], h, dh).movedim(-2, 1)

        return tuple(map(split_heads, (q, k, v)))

    def finish(self, out, x):
        """Merge heads (at axis 1), gate from the input, project."""
        out = out.movedim(1, -2).reshape(*x.shape[:-1],
                                         self.heads * self.dim_head)
        return self._gate_and_project(out, x)

    def _gate_and_project(self, out_merged, x):
        if self.gating is not None:
            out_merged = out_merged * torch.sigmoid(self.gating(x))
        return self.to_out(out_merged)

    def forward(self, x, mask=None, attn_bias=None, context=None,
                context_mask=None, tie_dim: Optional[int] = None,
                attn_bias_repeat: int = 1, train: bool = False,
                generator: Optional[torch.Generator] = None):
        """x (b, n, d); mask (b, n) bool; attn_bias (b // attn_bias_repeat,
        heads, n, m). With `context` (b, m, d) the keys and values come
        from it (cross-attention, the template pointwise attention) and
        `context_mask` (b, m) masks them; as in the JAX module the key
        mask exists only when `mask` does (all ones when `context_mask`
        is None), and a block-sparse spec never applies to a call with a
        context. With `train=True` and dropout > 0 the softmax weights
        are dropped out on the plain path."""
        q, k, v = self.project_qkv(x, kv_input=context)   # (b, h, n, dh)
        return self.finish(self.attend(
            q, k, v, mask=mask, attn_bias=attn_bias,
            has_context=context is not None, context_mask=context_mask,
            tie_dim=tie_dim, attn_bias_repeat=attn_bias_repeat, train=train,
            generator=generator), x)

    def attend(self, q, k, v, mask=None, attn_bias=None,
               has_context: bool = False, context_mask=None,
               tie_dim: Optional[int] = None, attn_bias_repeat: int = 1,
               train: bool = False,
               generator: Optional[torch.Generator] = None):
        """The attention of `forward` on projected heads: q (pre-scaled),
        k, v (b, h, n, dh) plain tensors -> (b, h, n, dh)."""
        h, dh = self.heads, self.dim_head
        drop = train and self.dropout > 0.0
        cmask = None
        if mask is not None:
            mask = mask.bool()
            cmask = mask
            if has_context:
                cmask = torch.ones(k.shape[0], k.shape[-2], dtype=torch.bool,
                                   device=k.device) \
                    if context_mask is None else context_mask.bool()

        if tie_dim is None:
            b_all, n_q, n_k = q.shape[0], q.shape[-2], k.shape[-2]
            spec = active_kernel_spec()
            if spec is not None and (has_context or n_q != n_k
                                     or not spec.covers(n_q)):
                spec = None
            if spec is not None and spec.backend == "auto" and not drop:
                return self._block_sparse(q, k, v, mask, attn_bias,
                                          attn_bias_repeat, spec)
            if spec is not None:
                # "masked" (or "auto" under active dropout: K2 has no
                # dropout): the pattern as a -1e9 additive bias on the
                # edge bias; the attention then replaces masked logits,
                # as the JAX package's masked backend does
                fill = spec.additive_bias(q.device)
                attn_bias = fill if attn_bias is None else \
                    attn_bias + fill.to(attn_bias.dtype)
            if drop:
                warnings.warn(
                    f"fused attention has no dropout, and attention "
                    f"dropout ({self.dropout}) is active in a training "
                    f"pass: this layer takes the plain attention path. Set "
                    f"attn_dropout=0.0 or run with train=False to keep the "
                    f"kernel.", stacklevel=2)
                return self._plain_dropout(
                    q, k, v, mask, cmask, attn_bias, attn_bias_repeat,
                    generator)
            bias = None
            if attn_bias is not None:
                # the kernel replays the (b, heads) bias over the fold by
                # index; only broadcast-shaped biases are expanded here
                bias = attn_bias.float().expand(
                    b_all // attn_bias_repeat, h, n_q, n_k).reshape(
                        -1, n_q, n_k).contiguous()
            out = fused_attention(
                q.reshape(b_all * h, n_q, dh).contiguous(),
                k.reshape(b_all * h, n_k, dh).contiguous(),
                v.reshape(b_all * h, n_k, dh).contiguous(),
                bias=bias,
                q_mask=None if mask is None else mask.contiguous(),
                k_mask=None if cmask is None else cmask.contiguous(),
                heads=h, bias_repeat=attn_bias_repeat)
            return out.reshape(b_all, h, n_q, dh)

        # global-query attention: queries averaged over the tied rows
        # (never block-sparse)
        b = q.shape[0] // tie_dim
        q = q.reshape(b, tie_dim, *q.shape[1:]).mean(dim=1)
        k = k.reshape(b, tie_dim, *k.shape[1:])
        dots = torch.einsum("bhid,brhjd->brhij", q, k)
        dots = dots.reshape(-1, *dots.shape[2:])
        if attn_bias is not None:
            if attn_bias_repeat != 1:
                attn_bias = attn_bias.repeat_interleave(attn_bias_repeat,
                                                        dim=0)
            dots = dots + attn_bias.to(dots.dtype)
        if mask is not None:
            pair_mask = mask[:, None, :, None] & cmask[:, None, None, :]
            dots = dots.masked_fill(~pair_mask, MASK_VALUE)
        attn = torch.softmax(dots, dim=-1)
        if drop:
            attn = dropout(attn, self.dropout, generator)
        return torch.einsum("bhij,bhjd->bhid", attn, v)

    def _plain_dropout(self, q, k, v, mask, cmask, attn_bias,
                       attn_bias_repeat, generator):
        """The plain attention with dropout on the softmax weights: the
        fused contract (fp32 logits and softmax, masked logits replaced by
        -1e9 after the bias add) plus dropout before the product with v."""
        dots = torch.einsum("bhid,bhjd->bhij", q, k).float()
        if attn_bias is not None:
            if attn_bias_repeat != 1:
                attn_bias = attn_bias.repeat_interleave(attn_bias_repeat,
                                                        dim=0)
            dots = dots + attn_bias.float()
        if mask is not None:
            pair_mask = mask[:, None, :, None] & cmask[:, None, None, :]
            dots = dots.masked_fill(~pair_mask, MASK_VALUE)
        attn = dropout(torch.softmax(dots, dim=-1), self.dropout, generator)
        return torch.einsum("bhij,bhjd->bhid", attn.to(v.dtype), v)

    def _block_sparse(self, q, k, v, mask, attn_bias, attn_bias_repeat,
                      spec):
        """Self-attention over the spec's live blocks (kernel K2 on the
        card, its plain version on the CPU): the bias unrepeated, the mask
        on keys only, no scale (project_qkv scaled q)."""
        h, dh = self.heads, self.dim_head
        b_all, n = q.shape[0], q.shape[-2]
        plan = active_kernel_plan()
        if plan is None or plan.cols.device != q.device:
            # the plan is made once per fold (predict) or per executor
            # key, never per launch
            raise ValueError(
                f"block-sparse spec {spec.label} is active without its "
                f"device plan on {q.device}; pass kernel_context(spec, "
                f"spec.device_plan(device))")
        bias = None
        if attn_bias is not None:
            bias = attn_bias.float().expand(
                b_all // attn_bias_repeat, h, n, n).reshape(
                    -1, n, n).contiguous()
        out = block_sparse_attention(
            q.reshape(b_all * h, n, dh).contiguous(),
            k.reshape(b_all * h, n, dh).contiguous(),
            v.reshape(b_all * h, n, dh).contiguous(),
            plan, bias=bias, bias_repeat=attn_bias_repeat,
            k_mask=None if mask is None else mask.bool().contiguous(),
            heads=h, scale=1.0)
        return out.reshape(b_all, h, n, dh)


class AxialAttention(nn.Module):
    """Row or column attention over a 2-D map x (b, H, W, d): `row_attn`
    attends along W for each of the H rows, `col_attn` along H for each
    of the W columns. `accept_edges` projects a pair representation
    (b, I, J, d) into a per-head bias, replayed over the folded axis.
    `sparse_kernel_ok=False` runs the attention outside any active
    block-sparse spec (the MSA column attention attends alignment rows,
    never residues).

    Under an active mesh (`parallel.use_mesh`):
    - long-context mode: when `ring_axes=(axis of H, axis of W)` names
      the mesh axes sharding x's two spatial dims and the attended axis
      is sharded over more than one rank, the attention runs as
      `parallel.ring.pair_row_attention_sharded`, exact blockwise
      softmax with the K/V shards rotating around the ring, through the
      same parameters (the ring reuses the inner Attention's
      projections). Global-query attention never rings; dropout runs
      inside the ring;
    - otherwise, on a DTensor input, the projections run on the DTensor
      and the attention runs on each rank's local block with the
      attended axis whole (`parallel.sharding.local_call`): kernel K1
      (or K2) gets plain local tensors."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 row_attn: bool = True, col_attn: bool = False,
                 accept_edges: bool = False,
                 global_query_attn: bool = False, dropout: float = 0.0,
                 sparse_kernel_ok: bool = True,
                 ring_axes: Optional[tuple] = None, dtype=torch.float32):
        super().__init__()
        if row_attn == col_attn:
            raise ValueError("has to be either row or column attention, "
                             "not both")
        self.row_attn = row_attn
        self.global_query_attn = global_query_attn
        self.sparse_kernel_ok = sparse_kernel_ok
        self.ring_axes = ring_axes
        self.norm = LayerNorm(dim, dtype)
        self.attn = Attention(dim, heads=heads, dim_head=dim_head,
                              dropout=dropout, dtype=dtype)
        self.edges_to_attn_bias = Dense(dim, heads, bias=False,
                                        dtype=dtype) if accept_edges \
            else None

    def _ring_mesh(self, height, width):
        """The active mesh if the ring path applies, else None. A
        ring_axes entry may be None: that spatial dim is not sharded
        (the MSA track's alignment rows)."""
        if self.ring_axes is None or self.global_query_attn:
            return None
        mesh = active_mesh()
        if mesh is None:
            return None
        ax_h, ax_w = self.ring_axes
        ax_att = ax_w if self.row_attn else ax_h
        if ax_att is None or mesh.shape.get(ax_att, 1) <= 1:
            return None
        for dim, ax in ((height, ax_h), (width, ax_w)):
            if ax is not None and ax in mesh.shape and dim % mesh.shape[ax]:
                return None
        return mesh

    def _edge_bias(self, edges):
        if self.edges_to_attn_bias is None or edges is None:
            return None
        # (b, i, j, d) -> per-head bias (b, heads, i, j)
        return self.edges_to_attn_bias(edges).permute(0, 3, 1, 2)

    def _ring_forward(self, x, edges, mask, mesh, train, generator):
        """Ring-parallel axial attention over the sharded attended axis.
        Outputs match the dense path at every valid query; the full
        (b, H, W) mask rides in as per-row key validity, so arbitrary
        (non-separable) masks hold exactly."""
        from alphafold2_tpu_torch.parallel.ring import (
            pair_row_attention_sharded)

        ax_h, ax_w = self.ring_axes
        given = spec_of(x, mesh) if is_dtensor(x) else None
        x = to_spec(x, mesh, clean_spec(mesh, P(DATA_AXIS, ax_h, ax_w),
                                        x.shape))
        attn = self.attn
        q, k, v = attn.project_qkv(x)    # (b, h, H, W, dh), q pre-scaled
        bias = self._edge_bias(like(edges, x))
        drop = {}
        if train and attn.dropout > 0.0:
            device = torch.device("cpu") if generator is None \
                else generator.device
            drop = dict(dropout_rate=attn.dropout, dropout_key=int(
                torch.randint(0, 2 ** 62, (1,), generator=generator,
                              device=device).item()))
        if self.row_attn:
            out = pair_row_attention_sharded(
                q, k, v, bias, mesh, i_axis=ax_h, j_axis=ax_w, mask=mask,
                **drop)
        else:
            swap = lambda t: t.transpose(2, 3)   # noqa: E731
            out = swap(pair_row_attention_sharded(
                swap(q), swap(k), swap(v), bias, mesh, i_axis=ax_w,
                j_axis=ax_h, mask=None if mask is None else
                mask.transpose(1, 2), **drop))
        out = attn.finish(out, x)
        return out if given is None else to_spec(out, mesh, given)

    def _local_forward(self, x, edges, mask, mesh, train, generator):
        """A DTensor input under a mesh: projections on the DTensor, the
        attention on each rank's block with the attended axis whole (and
        the folded axis whole too for global-query attention); the bias
        is whole on every rank, as the dense path needs it. A column
        attention runs as the row attention of the transposed map, so
        every matmul sees the rows in the dense path's order."""
        attn = self.attn
        if not is_dtensor(x):
            x = like(x, edges)
        given = spec_of(x, mesh)
        if not self.row_attn:
            x = x.transpose(1, 2)
            mask = None if mask is None else mask.transpose(1, 2)
        axes = spec_of(x, mesh)
        data = axes[0]
        keep = None if self.global_query_attn else axes[1]
        q_spec = P(data, None, keep, None, None)
        # the attended axis whole before the projections: a map sharded
        # on both spatial axes in the transposed order has no flattening
        # rule in DTensor
        x = to_spec(x, mesh, P(data, keep))
        q, k, v = attn.project_qkv(x)    # (b, h, rows, n, dh)
        bias = self._edge_bias(like(edges, x))

        def core(ql, kl, vl, bl, ml):
            # fold the rows into the batch: (b * rows, h, n, dh)
            folded = [t.transpose(1, 2) for t in (ql, kl, vl)]
            bsz, rows, hh, n, dh = folded[0].shape
            qf, kf, vf = (t.reshape(bsz * rows, hh, n, dh) for t in folded)
            out = attn.attend(
                qf, kf, vf,
                mask=None if ml is None else ml.reshape(bsz * rows, n),
                attn_bias=bl,
                tie_dim=rows if self.global_query_attn else None,
                attn_bias_repeat=rows if bl is not None else 1,
                train=train, generator=generator)
            return out.reshape(bsz, rows, hh, n, dh).transpose(1, 2)

        out = attn.finish(local_call(
            core, mesh, (q, k, v, bias, mask),
            (q_spec,) * 3 + (P(data), P(data, keep)), q_spec), x)
        if not self.row_attn:
            out = out.transpose(1, 2)
        # back in the input's placement: the residual add then meets two
        # operands placed alike (DTensor's add of a transposed placement
        # beside another gave wrong gradients)
        return to_spec(out, mesh, given)

    def forward(self, x, edges=None, mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        b, height, width, d = x.shape
        x = self.norm(x)
        off = not self.sparse_kernel_ok and active_kernel_spec() is not None

        ring_mesh = self._ring_mesh(height, width)
        if ring_mesh is not None:
            return self._ring_forward(x, edges, mask, ring_mesh, train,
                                      generator)
        mesh = active_mesh()
        if mesh is not None and (is_dtensor(x) or is_dtensor(edges)):
            with kernel_context(None) if off else contextlib.nullcontext():
                return self._local_forward(x, edges, mask, mesh, train,
                                           generator)

        if self.row_attn:
            axial_dim = height
            x_fold = x.reshape(b * height, width, d)
            mask_fold = None if mask is None else \
                mask.reshape(b * height, width)
        else:
            axial_dim = width
            x_fold = x.transpose(1, 2).reshape(b * width, height, d)
            mask_fold = None if mask is None else \
                mask.transpose(1, 2).reshape(b * width, height)

        attn_bias = self._edge_bias(edges)
        with kernel_context(None) if off else contextlib.nullcontext():
            out = self.attn(
                x_fold, mask=mask_fold, attn_bias=attn_bias,
                tie_dim=axial_dim if self.global_query_attn else None,
                attn_bias_repeat=axial_dim if attn_bias is not None else 1,
                train=train, generator=generator)

        if self.row_attn:
            return out.reshape(b, height, width, d)
        return out.reshape(b, width, height, d).transpose(1, 2)


class TriangleMultiplicativeModule(nn.Module):
    """Triangle multiplicative update.
    mix='outgoing': out[i,j] = sum_k left[i,k] * right[j,k]
    mix='ingoing' : out[i,j] = sum_k left[k,j] * right[k,i]"""

    def __init__(self, dim: int, hidden_dim: Optional[int] = None,
                 mix: str = "ingoing", dtype=torch.float32):
        super().__init__()
        if mix not in ("ingoing", "outgoing"):
            raise ValueError(f"mix must be 'ingoing' or 'outgoing', "
                             f"got {mix!r}")
        self.mix = mix
        hidden = hidden_dim or dim
        self.norm = LayerNorm(dim, dtype)
        self.left_proj = Dense(dim, hidden, dtype=dtype)
        self.right_proj = Dense(dim, hidden, dtype=dtype)
        self.left_gate = Dense(dim, hidden, dtype=dtype, init="gate")
        self.right_gate = Dense(dim, hidden, dtype=dtype, init="gate")
        self.out_gate = Dense(dim, hidden, dtype=dtype, init="gate")
        self.out_norm = LayerNorm(hidden, dtype)
        self.to_out = Dense(hidden, dim, dtype=dtype)

    def forward(self, x, mask=None):
        if x.shape[1] != x.shape[2]:
            raise ValueError("feature map must be square")
        if mask is not None:
            mask = mask[..., None].to(x.dtype)
        x = self.norm(x)
        left = self.left_proj(x)
        right = self.right_proj(x)
        if mask is not None:
            left = left * mask
            right = right * mask
        left = left * torch.sigmoid(self.left_gate(x))
        right = right * torch.sigmoid(self.right_gate(x))
        out_gate = torch.sigmoid(self.out_gate(x))
        outgoing = self.mix == "outgoing"

        def mix(lt, rt):
            if outgoing:
                return torch.einsum("bikd,bjkd->bijd", lt, rt)
            return torch.einsum("bkjd,bkid->bijd", lt, rt)

        if is_dtensor(left):
            # each rank contracts the whole k for its (i, j) block
            mesh = active_mesh()
            data, ai, aj, _ = spec_of(x, mesh)
            lspec, rspec = (P(data, ai), P(data, aj)) if outgoing else \
                (P(data, None, aj), P(data, None, ai))
            out = local_call(mix, mesh, (left, right), (lspec, rspec),
                             P(data, ai, aj))
        else:
            out = mix(left, right)
        out = self.out_norm(out) * out_gate
        return self.to_out(out)


class OuterMean(nn.Module):
    """MSA -> pair outer-product mean. With a mask, the default divides by
    the pair's valid-row count; `reference_scale=True` also divides by the
    row count, reproducing the reference implementation's double
    division (needed for checkpoints trained with it)."""

    def __init__(self, dim: int, hidden_dim: Optional[int] = None,
                 eps: float = 1e-5, reference_scale: bool = False,
                 dtype=torch.float32):
        super().__init__()
        hidden = hidden_dim or dim
        self.eps = eps
        self.reference_scale = reference_scale
        self.norm = LayerNorm(dim, dtype)
        self.left_proj = Dense(dim, hidden, dtype=dtype)
        self.right_proj = Dense(dim, hidden, dtype=dtype)
        self.proj_out = Dense(hidden, dim, dtype=dtype)

    def forward(self, x, mask=None):
        rows = x.shape[1]
        x = self.norm(x)
        left = self.left_proj(x)
        right = self.right_proj(x)
        if not is_dtensor(left):
            return self.proj_out(self._outer(left, right, mask, mask, rows))
        # under a mesh: each rank takes the outer products of its own
        # residues i (the MSA's sharded axis) with every residue j
        mesh = active_mesh()
        data, _, ax, _ = spec_of(left, mesh)
        outer = local_call(
            lambda lt, rt, ml, mr: self._outer(lt, rt, ml, mr, rows), mesh,
            (left, right, mask, mask),
            (P(data, None, ax, None), P(data), P(data, None, ax), P(data)),
            P(data, ax))
        return self.proj_out(outer)

    def _outer(self, left, right, mask_left, mask_right, rows):
        """(b, m, i, d) x (b, m, j, d) -> the (b, i, j, d) outer mean."""
        if mask_left is None:
            return torch.einsum("bmid,bmjd->bijd", left, right) / rows
        ml = mask_left.to(left.dtype)                  # (b, m, i)
        mr = mask_right.to(right.dtype)                # (b, m, j)
        left = left * ml[..., None]
        right = right * mr[..., None]
        outer = torch.einsum("bmid,bmjd->bijd", left, right)
        counts = torch.einsum("bmi,bmj->bij", ml, mr)[..., None]
        if self.reference_scale:
            return outer / rows / (counts + self.eps)
        return outer / (counts + self.eps)
