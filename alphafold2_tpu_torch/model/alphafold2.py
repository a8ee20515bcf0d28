"""Top-level Alphafold2 model in PyTorch (counterpart of
`alphafold2_tpu/model/alphafold2.py:171-616`): the forward that
`predict.fold` runs and the training forward.

Token and relative-position embeddings, MSA-MLM noising in training, the
outer-sum pair init, the recycling embedder, the main Evoformer, the
distogram head on the symmetrised pair, the MLM loss, the single/pair
projections, the IPA structure module and the lDDT confidence head. The
trunk runs in `dtype` (bf16 by default in `ModelConfig`); the heads and
the structure module are fp32.

`train=True` noises the MSA and turns dropout on; both draw from the
`generator` passed to `forward` (the default generator when None), and
`ReturnValues.msa_mlm_loss` carries the MLM loss. Inputs and options the
port does not run yet (templates, extra MSA, pretrained embeddings, angle
heads, other structure modules, refinement) raise NotImplementedError
naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch import nn

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.model.evoformer import Evoformer
from alphafold2_tpu_torch.model.mlm import MLM
from alphafold2_tpu_torch.model.primitives import (Dense, LayerNorm,
                                                   init_weights, not_ported)
from alphafold2_tpu_torch.model.structure import StructureModule


class Recyclables(NamedTuple):
    """Inter-recycle state."""

    coords: torch.Tensor                # (b, n, 3) fp32
    single_msa_repr_row: torch.Tensor   # (b, n, dim) fp32
    pairwise_repr: torch.Tensor         # (b, n, n, dim) fp32


class ReturnValues(NamedTuple):
    distance: Optional[torch.Tensor] = None      # (b, n, n, buckets)
    recyclables: Optional[Recyclables] = None
    confidence: Optional[torch.Tensor] = None    # raw (b, n, 1)
    msa_mlm_loss: Optional[torch.Tensor] = None  # scalar, train=True only


_ITEM6 = "queue 1, item 6 (model/alphafold2.py)"
_ITEM11 = "queue 1, item 11 (model/refiners.py)"
# forward inputs of the JAX model that the port refuses
_UNPORTED_INPUTS = frozenset({
    "extra_msa", "extra_msa_mask", "seq_embed", "msa_embed",
    "templates_feats", "templates_mask", "templates_angles", "embedds"})


class Alphafold2(nn.Module):
    """Hyperparameters and defaults match the JAX `Alphafold2`. The
    module is built on `device` (CUDA unless the caller names another;
    without a card `device=None` raises) with weights drawn from
    `generator` (a fresh one seeded 0 when None)."""

    def __init__(
        self,
        dim: int,
        max_seq_len: int = 2048,
        depth: int = 6,
        heads: int = 8,
        dim_head: int = 64,
        max_rel_dist: int = 32,
        num_tokens: int = constants.NUM_AMINO_ACIDS,
        num_embedds: int = constants.NUM_EMBEDDS_TR,
        max_num_msas: int = constants.MAX_NUM_MSA,
        max_num_templates: int = constants.MAX_NUM_TEMPLATES,
        extra_msa_evoformer_layers: int = 4,
        attn_dropout: float = 0.0,
        ff_dropout: float = 0.0,
        predict_angles: bool = False,
        symmetrize_omega: bool = False,
        predict_coords: bool = False,
        structure_module_depth: int = 4,
        structure_module_heads: int = 1,
        structure_module_type: str = "ipa",
        structure_module_refinement_iters: int = 0,
        structure_module_refinement: str = "residue",
        outer_mean_reference_scale: bool = False,
        recycling_distance_buckets: int = 32,
        linear_attn_kind: str = "favor",
        performer_nb_features: int = 256,
        sparse_block: int = 32,
        sparse_num_global: int = 1,
        sparse_window: int = 1,
        pipeline_microbatches: int = 0,
        use_scan: bool = True,
        dtype: Any = torch.float32,
        device=None,
        generator: Optional[torch.Generator] = None,
        **trunk_options,
    ):
        super().__init__()
        device = resolve_device(device)
        if predict_angles:
            not_ported("predict_angles", predict_angles, _ITEM6)
        if structure_module_type != "ipa":
            not_ported("structure_module_type", structure_module_type,
                       _ITEM11)
        if structure_module_refinement_iters > 0:
            not_ported("structure_module_refinement_iters",
                       structure_module_refinement_iters, _ITEM11)
        self.dim = dim
        self.max_rel_dist = max_rel_dist
        self.predict_coords = predict_coords
        self.recycling_distance_buckets = recycling_distance_buckets
        self.dtype = dtype

        self.token_emb = nn.Embedding(num_tokens + 1, dim)
        self.to_pairwise_repr = Dense(dim, dim * 2, dtype=dtype)
        self.pos_emb = nn.Embedding(max_rel_dist * 2 + 1, dim)
        self.recycling_msa_norm = LayerNorm(dim)
        self.recycling_pairwise_norm = LayerNorm(dim)
        self.recycling_distance_embed = nn.Embedding(
            recycling_distance_buckets, dim)
        self.net = Evoformer(
            dim, depth, heads=heads, dim_head=dim_head,
            attn_dropout=attn_dropout, ff_dropout=ff_dropout,
            outer_mean_reference_scale=outer_mean_reference_scale,
            use_scan=use_scan, dtype=dtype, **trunk_options)
        self.distogram_norm = LayerNorm(dim)
        self.to_distogram_logits = Dense(dim, constants.DISTOGRAM_BUCKETS)
        if predict_coords:
            self.msa_to_single_repr_dim = Dense(dim, dim)
            self.trunk_to_pairwise_repr_dim = Dense(dim, dim)
            self.structure_module = StructureModule(
                dim, depth=structure_module_depth,
                heads=structure_module_heads)
            self.lddt_linear = Dense(dim, 1)
        # the last embedding row is the mask token
        self.mlm = MLM(dim, num_tokens, mask_id=num_tokens)

        init_weights(self, generator if generator is not None
                     else torch.Generator().manual_seed(0))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.token_emb.weight.device

    def forward(
        self,
        seq,                       # (b, n) int tokens
        msa=None,                  # (b, m, n) int tokens
        mask=None,                 # (b, n) bool
        msa_mask=None,             # (b, m, n) bool
        recyclables: Optional[Recyclables] = None,
        return_recyclables: bool = False,
        return_aux_logits: bool = False,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        **unported,
    ):
        for name, value in unported.items():
            if name not in _UNPORTED_INPUTS:
                raise TypeError(f"Alphafold2.forward got an unexpected "
                                f"argument {name!r}")
            if value is not None:
                not_ported(name, "<given>", _ITEM6 + ": templates, extra "
                           "MSA and pretrained embeddings")

        b, n = seq.shape[:2]
        device = seq.device
        if mask is None:
            mask = torch.ones(b, n, dtype=torch.bool, device=device)
        mask = mask.bool()
        # without an MSA the sequence itself is the one MSA row
        if msa is None:
            msa = seq[:, None, :]
            msa_mask = mask[:, None, :]
        if msa.shape[-1] != n:
            raise ValueError("sequence length of MSA and primary sequence "
                             "must match")
        msa_mask = torch.ones_like(msa, dtype=torch.bool) \
            if msa_mask is None else msa_mask.bool()

        # MLM noising of the MSA in training
        original_msa = msa
        replaced_msa_mask = None
        if train:
            msa, replaced_msa_mask = self.mlm.noise(msa, msa_mask, generator)

        dt = self.dtype
        x_single = self.token_emb(seq).to(dt)
        m = self.token_emb(msa).to(dt) + x_single[:, None]

        # pair representation by outer sum, plus relative positions
        x_left, x_right = self.to_pairwise_repr(x_single).chunk(2, dim=-1)
        x = x_left[:, :, None, :] + x_right[:, None, :, :]
        x_mask = mask[:, :, None] & mask[:, None, :]
        seq_index = torch.arange(n, device=device)
        rel = seq_index[:, None] - seq_index[None, :]
        rel = rel.clamp(-self.max_rel_dist, self.max_rel_dist) + \
            self.max_rel_dist
        x = x + self.pos_emb(rel)[None].to(dt)

        if recyclables is not None:
            first_row = m[:, 0] + self.recycling_msa_norm(
                recyclables.single_msa_repr_row).to(dt)
            m = torch.cat([first_row[:, None], m[:, 1:]], dim=1)
            x = x + self.recycling_pairwise_norm(
                recyclables.pairwise_repr).to(dt)
            coords = recyclables.coords
            dists = torch.sqrt(torch.clamp(
                ((coords[:, :, None] - coords[:, None, :]) ** 2).sum(-1),
                min=1e-12))
            boundaries = torch.linspace(
                constants.DISTOGRAM_MIN_DIST, constants.DISTOGRAM_MAX_DIST,
                self.recycling_distance_buckets,
                device=device)[:-1].contiguous()
            buckets = torch.searchsorted(boundaries, dists.contiguous(),
                                         right=False)
            x = x + self.recycling_distance_embed(buckets).to(dt)

        x, m = self.net(x, m, mask=x_mask, msa_mask=msa_mask, train=train,
                        generator=generator)

        # symmetrised pair -> distogram head (fp32)
        x_f32 = x.float()
        trunk_embeds = (x_f32 + x_f32.transpose(1, 2)) * 0.5
        distance = self.to_distogram_logits(
            self.distogram_norm(trunk_embeds))

        msa_mlm_loss = None
        if train:
            msa_mlm_loss = self.mlm(m[:, :original_msa.shape[1]],
                                    original_msa, replaced_msa_mask)

        if not self.predict_coords:
            return ReturnValues(distance=distance, msa_mlm_loss=msa_mlm_loss)

        # single / pair projections and the structure module (fp32)
        single_msa_repr_row = m[:, 0]
        single_repr = self.msa_to_single_repr_dim(single_msa_repr_row.float())
        pairwise_repr = self.trunk_to_pairwise_repr_dim(x_f32)
        coords, single_out = self.structure_module(single_repr,
                                                   pairwise_repr, mask=mask)
        confidence = self.lddt_linear(single_out)

        ret = ReturnValues(
            distance=distance, confidence=confidence,
            msa_mlm_loss=msa_mlm_loss,
            recyclables=Recyclables(
                coords.detach(), single_msa_repr_row.float().detach(),
                pairwise_repr.detach()) if return_recyclables else None)
        if return_aux_logits or return_recyclables:
            return coords, ret
        return coords
