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


def not_ported(option: str, value, roadmap: str):
    """Raise for an option the port does not run yet, naming the ROADMAP
    item that will bring it (never run something else silently)."""
    raise NotImplementedError(
        f"{option}={value!r} is not ported to PyTorch yet "
        f"(ROADMAP.md, {roadmap})")


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
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with epsilon 1e-5 and fp32 parameters and statistics;
    the output is cast to `dtype`."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__(dim, eps=1e-5, dtype=torch.float32)
        self.compute_dtype = dtype

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.compute_dtype)


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
        h, dh = self.heads, self.dim_head
        has_context = context is not None
        q, k, v = self.project_qkv(x, kv_input=context)   # (b, h, n, dh)
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
                return self._block_sparse(q, k, v, x, mask, attn_bias,
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
                return self.finish(self._plain_dropout(
                    q, k, v, mask, cmask, attn_bias, attn_bias_repeat,
                    generator), x)
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
            return self.finish(out.reshape(b_all, h, n_q, dh), x)

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
        out = torch.einsum("bhij,bhjd->bhid", attn, v)
        return self.finish(out, x)

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

    def _block_sparse(self, q, k, v, x, mask, attn_bias, attn_bias_repeat,
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
        return self.finish(out.reshape(b_all, h, n, dh), x)


class AxialAttention(nn.Module):
    """Row or column attention over a 2-D map x (b, H, W, d): `row_attn`
    attends along W for each of the H rows, `col_attn` along H for each
    of the W columns. `accept_edges` projects a pair representation
    (b, I, J, d) into a per-head bias, replayed over the folded axis.
    `sparse_kernel_ok=False` runs the attention outside any active
    block-sparse spec (the MSA column attention attends alignment rows,
    never residues)."""

    def __init__(self, dim: int, heads: int, dim_head: int = 64,
                 row_attn: bool = True, col_attn: bool = False,
                 accept_edges: bool = False,
                 global_query_attn: bool = False, dropout: float = 0.0,
                 sparse_kernel_ok: bool = True, dtype=torch.float32):
        super().__init__()
        if row_attn == col_attn:
            raise ValueError("has to be either row or column attention, "
                             "not both")
        self.row_attn = row_attn
        self.global_query_attn = global_query_attn
        self.sparse_kernel_ok = sparse_kernel_ok
        self.norm = LayerNorm(dim, dtype)
        self.attn = Attention(dim, heads=heads, dim_head=dim_head,
                              dropout=dropout, dtype=dtype)
        self.edges_to_attn_bias = Dense(dim, heads, bias=False,
                                        dtype=dtype) if accept_edges \
            else None

    def forward(self, x, edges=None, mask=None, train: bool = False,
                generator: Optional[torch.Generator] = None):
        b, height, width, d = x.shape
        x = self.norm(x)

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

        attn_bias = None
        if self.edges_to_attn_bias is not None and edges is not None:
            # (b, i, j, d) -> per-head bias (b, heads, i, j)
            attn_bias = self.edges_to_attn_bias(edges).permute(0, 3, 1, 2)

        off = not self.sparse_kernel_ok and active_kernel_spec() is not None
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
        if self.mix == "outgoing":
            out = torch.einsum("bikd,bjkd->bijd", left, right)
        else:
            out = torch.einsum("bkjd,bkid->bijd", left, right)
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
        if mask is not None:
            m = mask.to(x.dtype)                       # (b, m, n)
            left = left * m[..., None]
            right = right * m[..., None]
            outer = torch.einsum("bmid,bmjd->bijd", left, right)
            counts = torch.einsum("bmi,bmj->bij", m, m)[..., None]
            if self.reference_scale:
                outer = outer / rows / (counts + self.eps)
            else:
                outer = outer / (counts + self.eps)
        else:
            outer = torch.einsum("bmid,bmjd->bijd", left, right) / rows
        return self.proj_out(outer)
