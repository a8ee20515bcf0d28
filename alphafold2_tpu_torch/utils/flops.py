"""FLOP accounting for the train step's TFLOP/s and MFU (counterpart of
`alphafold2_tpu/utils/flops.py`).

`train_step_flops` counts the contraction FLOPs (matmuls, batched
matmuls, convolutions) of one forward of the composite loss with
`torch.utils.flop_counter.FlopCounterMode` and charges the step

    F_step = 3 x F_forward

(each matmul's backward is two matmuls of equal cost). The count runs on
a copy of the model on the `meta` device, with the attention seam routed
to the plain attention for the count (as the JAX package disables its
kernels for the counting trace): the fused kernel is a foreign call that
the counter cannot see into, so a count taken through it would miss the
attention's products. Elementwise, softmax and LayerNorm work is excluded, and so is
rematerialised recompute (the forward is counted once): these are model
FLOPs, the MFU numerator. `evoformer_step_flops_formula` is the JAX
package's closed form, copied verbatim, as a cross-check.
"""

from __future__ import annotations

import contextlib
import copy

import torch
from torch.utils.flop_counter import FlopCounterMode


def forward_flops(fn, *args, **kwargs) -> float:
    """Contraction FLOPs that one call of fn performs."""
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


@contextlib.contextmanager
def plain_attention():
    """Route the model's attention seam to the plain attention (no
    kernel, any device) for a counting pass, and back afterwards."""
    from alphafold2_tpu_torch.model import primitives
    from alphafold2_tpu_torch.ops.attention import attention_reference
    fused = primitives.fused_attention
    primitives.fused_attention = attention_reference
    try:
        yield
    finally:
        primitives.fused_attention = fused


def train_step_flops(model, batch, train: bool = True) -> float:
    """Model FLOPs of one training step of `model` on `batch`: 3 x the
    forward contraction FLOPs of `train.loop.compute_loss`, counted on a
    meta-device copy of the model (shapes only, nothing runs). Optimizer
    update FLOPs are excluded as negligible and non-contraction."""
    from alphafold2_tpu_torch.train.loop import compute_loss

    meta = copy.deepcopy(model).to("meta")
    meta_batch = {k: torch.as_tensor(v).to("meta") for k, v in batch.items()}
    with torch.no_grad(), plain_attention():
        fwd = forward_flops(lambda: compute_loss(meta, meta_batch, None,
                                                 train=train))
    return 3.0 * fwd


def evoformer_step_flops_formula(
    dim: int, depth: int, seq_len: int, msa_depth: int,
    heads: int = 8, dim_head: int = 64, batch: int = 1,
    num_tokens: int = 21, distogram_buckets: int = 37,
) -> float:
    """Closed-form cross-check of the dominant terms of the benched
    distogram train step (documented FLOP model, fwd x3). Per Evoformer
    layer, with L = seq_len, M = msa_depth, d = dim, h*dh = inner:

      MSA row/col attention:   QKV/out projections 4*(M*L)*d*inner each
                               axis + logits/AV 2*(L + M) contractions
      Pair tri-attn row/col:   projections over L^2 cells + L^3 logits/AV
      Triangle mult out/in:    2 mixes, each ~ L^3 * d einsum + 4 L^2 d^2
                               projections
      OuterMean:               L^2 * M * d_hidden outer + projections
      FeedForwards:            MSA (M*L) and pair (L^2) * 2*(2*4d*d + 4d*d)

    This intentionally re-derives the big-O structure only to sanity-check
    `train_step_flops` (the jaxpr count is the number of record); tests
    assert agreement of the leading L^3/L^2 terms within ~15%.
    """
    L, M, d = float(seq_len), float(msa_depth), float(dim)
    inner = float(heads * dim_head)
    b = float(batch)

    def attn(tokens, ctx):
        # q,k,v,out projections + gating: 5 GEMMs of tokens*d*inner
        proj = 5 * 2.0 * tokens * d * inner
        # logits + AV: 2 * tokens * ctx * inner
        core = 2 * 2.0 * tokens * ctx * inner
        return proj + core

    msa_tokens = M * L
    pair_tokens = L * L
    layer = 0.0
    layer += attn(msa_tokens, L)          # MSA row attention
    layer += attn(msa_tokens, M)          # MSA col attention
    layer += attn(pair_tokens, L) * 2     # triangle attn out + in
    # triangle multiplicative x2: left/right/out projections (+3 gates)
    # ~6 GEMMs of L^2*d*d, plus the L^3 mix einsum (2 * L^3 * d)
    layer += 2 * (6 * 2.0 * pair_tokens * d * d + 2.0 * L ** 3 * d)
    # outer mean: hidden d_h=d//4 typical? use d (upper bound, small term)
    layer += 2.0 * L * L * M * d + 2 * 2.0 * msa_tokens * d * d
    # feedforwards (GEGLU: in proj 2*4d, out proj 4d)
    ff = lambda tokens: 2.0 * tokens * d * (2 * 4 * d) + \
        2.0 * tokens * (4 * d) * d
    layer += ff(msa_tokens) + ff(pair_tokens)

    trunk = depth * layer
    # embeds + distogram head (small)
    heads_flops = 2.0 * pair_tokens * d * distogram_buckets + \
        2.0 * (L + msa_tokens) * num_tokens * d
    return 3.0 * b * (trunk + heads_flops)
