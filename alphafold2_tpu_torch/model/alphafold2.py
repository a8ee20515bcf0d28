"""Top-level Alphafold2 model in PyTorch (counterpart of
`alphafold2_tpu/model/alphafold2.py:171-616`): the forward that
`predict.fold` runs and the training forward.

Token and relative-position embeddings (or pretrained embeddings through
their projectors, `seq_embed` / `msa_embed` / `embedds`), MSA-MLM noising
in training, the outer-sum pair init, the recycling embedder, the
template pair stack and its pointwise attention into the pair, the
template angle features as extra MSA rows, the extra-MSA Evoformer
(global-query ingoing triangle attention), the main Evoformer, the
distogram head on the symmetrised pair and the trRosetta angle heads,
the MLM loss, the single/pair projections, the structure module (IPA, or
an equivariant refiner from `model/refiners.py` for `structure_module_type`
egnn, en or se3), the optional refinement of its coordinates
(`structure_module_refinement_iters`: a dense EGNN over the CA trace,
"residue", or the sparse EGNN over the 14-atom covalent graph,
"egnn-atom", whose atom cloud comes back on `ReturnValues.atoms`) and the
lDDT confidence head. The trunk runs in `dtype` (bf16 by default in
`ModelConfig`), plain or reversible (`reversible=True`); the heads and
the structure module are fp32.

Every module is built whatever the inputs of a call, as the JAX
package's init-time coverage makes one params tree serve every input
combination; the angle heads, the structure module and the refiners
exist only under `predict_angles` / `predict_coords` and their options,
as in the JAX tree. Modules are
registered in the order the earlier slices registered theirs, the new
ones after them, so `init_weights` draws the earlier modules' seeded
weights unchanged.

`train=True` noises the MSA and turns dropout on; both draw from the
`generator` passed to `forward` (the default generator when None), and
`ReturnValues.msa_mlm_loss` carries the MLM loss. The README-era menu
(`use_conv` and its kernels, `sparse_self_attn`, `linear_attn`,
`kron_attn`, `kv_compress_ratio` and their knobs) reaches the main trunk
only, as in the JAX package; `ring_attention` reaches the extra-MSA stack
too, and `pipeline_stages` / `pipeline_microbatches` the main trunk.

Under an active mesh (`parallel.use_mesh`) the MSA and pair activations
are placed by `shard_msa` / `shard_pair` where the JAX model places
them; the embeddings before those points, and the heads and the
structure module after the trunk, run on whole tensors (the trunk's
outputs are gathered on every rank).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.model.evoformer import (Evoformer,
                                                  PairwiseAttentionBlock)
from alphafold2_tpu_torch.model.mlm import MLM
from alphafold2_tpu_torch.data.scn import scn_cloud_mask
from alphafold2_tpu_torch.model.primitives import (Attention, Dense,
                                                   LayerNorm, init_weights)
from alphafold2_tpu_torch.model.refiners import AtomEGNNRefiner, Refiner
from alphafold2_tpu_torch.model.structure import StructureModule
from alphafold2_tpu_torch.parallel.sharding import (like, shard_msa,
                                                    shard_pair, unshard)


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
    # angle logits (predict_angles): theta and phi from the pair before
    # symmetrisation, omega from it or (symmetrize_omega) after
    theta: Optional[torch.Tensor] = None         # (b, n, n, 25)
    phi: Optional[torch.Tensor] = None           # (b, n, n, 13)
    omega: Optional[torch.Tensor] = None         # (b, n, n, 25)
    # the refined atom cloud, structure_module_refinement="egnn-atom" only
    atoms: Optional[torch.Tensor] = None         # (b, n, 14, 3)



class Alphafold2(nn.Module):
    """Hyperparameters and defaults match the JAX `Alphafold2`. The
    module is built on `device` (CUDA unless the caller names another;
    without a card `device=None` raises) with weights drawn from
    `generator` (a fresh one seeded 0 when None); on the meta device
    nothing is drawn. `init_kwargs` keeps the constructor's arguments
    but the device and the generator."""

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
        templates_dim: int = 32,
        templates_embed_layers: int = 4,
        templates_angles_feats_dim: int = 55,
        predict_angles: bool = False,
        symmetrize_omega: bool = False,
        predict_coords: bool = False,
        structure_module_depth: int = 4,
        structure_module_heads: int = 1,
        # accepted and never read, as in the JAX package (its IPA takes
        # no head width from the model)
        structure_module_dim_head: int = 4,
        structure_module_type: str = "ipa",
        structure_module_refinement_iters: int = 0,
        structure_module_refinement: str = "residue",
        outer_mean_reference_scale: bool = False,
        disable_token_embed: bool = False,
        mlm_mask_prob: float = 0.15,
        mlm_random_replace_token_prob: float = 0.1,
        mlm_keep_token_same_prob: float = 0.1,
        mlm_exclude_token_ids: tuple = (0,),
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
        # the constructor's arguments but the device and the weights'
        # generator: what a serving rank rebuilds the model from
        init_kwargs = {k: v for k, v in locals().items()
                       if k not in ("self", "device", "generator",
                                    "trunk_options", "__class__")}
        init_kwargs.update(trunk_options)
        super().__init__()
        self.init_kwargs = init_kwargs
        device = resolve_device(device)
        refine = predict_coords and structure_module_refinement_iters > 0
        if refine and structure_module_refinement not in ("residue",
                                                          "egnn-atom"):
            raise ValueError(
                "structure_module_refinement must be 'residue' or "
                f"'egnn-atom', got {structure_module_refinement!r}")
        self.dim = dim
        self.heads = heads
        self.max_rel_dist = max_rel_dist
        self.predict_coords = predict_coords
        self.predict_angles = predict_angles
        self.symmetrize_omega = symmetrize_omega
        self.templates_embed_layers = templates_embed_layers
        self.recycling_distance_buckets = recycling_distance_buckets
        self.dtype = dtype

        self.token_emb = None if disable_token_embed else \
            nn.Embedding(num_tokens + 1, dim)
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
            use_scan=use_scan, linear_attn_kind=linear_attn_kind,
            performer_nb_features=performer_nb_features,
            sparse_block=sparse_block, sparse_num_global=sparse_num_global,
            sparse_window=sparse_window,
            pipeline_microbatches=pipeline_microbatches, dtype=dtype,
            **trunk_options)
        self.distogram_norm = LayerNorm(dim)
        self.to_distogram_logits = Dense(dim, constants.DISTOGRAM_BUCKETS)
        if predict_coords:
            self.msa_to_single_repr_dim = Dense(dim, dim)
            self.trunk_to_pairwise_repr_dim = Dense(dim, dim)
            self.structure_module = StructureModule(
                dim, depth=structure_module_depth,
                heads=structure_module_heads) \
                if structure_module_type == "ipa" else None
            self.lddt_linear = Dense(dim, 1)
        # the last embedding row is the mask token
        self.mlm = MLM(dim, num_tokens, mask_id=num_tokens,
                       mask_prob=mlm_mask_prob,
                       random_replace_token_prob=mlm_random_replace_token_prob,
                       keep_token_same_prob=mlm_keep_token_same_prob,
                       exclude_token_ids=mlm_exclude_token_ids)

        # pretrained embeddings: the embedds-only MSA, and one projector
        # per known LM width (and num_embedds) other than dim
        self.embedd_project = Dense(num_embedds, dim, dtype=dtype)
        self.embed_widths = tuple(sorted(
            {constants.MSA_EMBED_DIM, constants.PROTTRAN_EMBED_DIM,
             constants.ESM_EMBED_DIM, num_embedds} - {dim}))
        for w in self.embed_widths:
            setattr(self, f"seq_embed_project_{w}", Dense(w, dim, dtype=dtype))
            setattr(self, f"msa_embed_project_{w}", Dense(w, dim, dtype=dtype))
        # templates: one weight-shared pair block applied
        # templates_embed_layers times (no dropout, no outer mean), then
        # attention from each pair cell over its templates
        self.to_template_embed = Dense(templates_dim, dim, dtype=dtype)
        self.template_pairwise_embedder = PairwiseAttentionBlock(
            dim, heads, dim_head, with_outer_mean=False, dtype=dtype)
        self.template_pointwise_attn = Attention(
            dim, heads=heads, dim_head=dim_head, dropout=attn_dropout,
            dtype=dtype)
        self.template_angle_mlp_in = Dense(templates_angles_feats_dim, dim,
                                           dtype=dtype)
        self.template_angle_mlp_out = Dense(dim, dim, dtype=dtype)
        # the extra-MSA stack: global-query attention on its ingoing
        # triangle attention, scanned (remat under gradients) as in JAX
        self.extra_msa_evoformer = Evoformer(
            dim, extra_msa_evoformer_layers, heads=heads, dim_head=dim_head,
            attn_dropout=attn_dropout, ff_dropout=ff_dropout,
            global_column_attn=True,
            outer_mean_reference_scale=outer_mean_reference_scale,
            ring_attention=trunk_options.get("ring_attention", False),
            dtype=dtype)
        if predict_angles:
            self.to_prob_theta = Dense(dim, constants.THETA_BUCKETS)
            self.to_prob_phi = Dense(dim, constants.PHI_BUCKETS)
            self.to_prob_omega = Dense(dim, constants.OMEGA_BUCKETS)
        # the equivariant refiners (registered after the modules of the
        # earlier slices): the structure module itself for egnn / en /
        # se3, then the refinement of its coordinates
        self.structure_module_refiner = Refiner(
            dim, kind=structure_module_type, iters=structure_module_depth,
            edge_dim=dim) \
            if predict_coords and structure_module_type != "ipa" else None
        self.refinement = structure_module_refinement if refine else None
        if self.refinement == "residue":
            self.coords_refiner = Refiner(
                dim, kind="egnn", iters=structure_module_refinement_iters,
                edge_dim=dim)
        elif self.refinement == "egnn-atom":
            self.atom_refiner = AtomEGNNRefiner(
                dim, iters=structure_module_refinement_iters)

        if device.type != "meta":
            # on the meta device nothing is drawn: the caller fills the
            # weights (`to_empty`, then `load_state_dict`)
            init_weights(self, generator if generator is not None
                         else torch.Generator().manual_seed(0))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.pos_emb.weight.device

    def _embed_tokens(self, tokens):
        if self.token_emb is None:
            return 0.0
        return self.token_emb(tokens).to(self.dtype)

    def _project_embed(self, e, prefix: str):
        """A pretrained embedding in the trunk's dtype, through the
        projector of its width unless it already has `dim`."""
        e = e.to(self.dtype)
        width = e.shape[-1]
        if width == self.dim:
            return e
        if width not in self.embed_widths:
            raise ValueError(f"no {prefix} for embeddings of width {width}; "
                             f"the model projects {self.embed_widths}")
        return getattr(self, f"{prefix}_{width}")(e)

    def _pooled_templates(self, x, x_mask, feats, t_mask, train, generator):
        """The template pair stack over (b*t, n, n, dim) under the crossed
        template mask, then each pair cell's attention over its t
        templates; cells with no valid template add nothing."""
        b, t, n = feats.shape[:3]
        t_mask = t_mask.bool()
        crossed = t_mask[:, :, :, None] & t_mask[:, :, None, :]
        emb = self.to_template_embed(feats).reshape(b * t, n, n, self.dim)
        flat_mask = crossed.reshape(b * t, n, n)
        for _ in range(self.templates_embed_layers):
            emb = self.template_pairwise_embedder(
                emb, mask=flat_mask, train=train, generator=generator)
        emb = emb.reshape(b, t, n, n, self.dim)
        cells = b * n * n
        t_point = emb.permute(0, 2, 3, 1, 4).reshape(cells, t, self.dim)
        t_mask_point = crossed.permute(0, 2, 3, 1).reshape(cells, t)
        pooled = self.template_pointwise_attn(
            x.reshape(cells, 1, self.dim), mask=x_mask.reshape(cells, 1),
            context=t_point, context_mask=t_mask_point, train=train,
            generator=generator)
        has_template = (t_mask_point.sum(-1) > 0)[:, None, None]
        return (pooled * has_template).reshape(b, n, n, self.dim)

    def forward(
        self,
        seq,                       # (b, n) int tokens
        msa=None,                  # (b, m, n) int tokens
        mask=None,                 # (b, n) bool
        msa_mask=None,             # (b, m, n) bool
        extra_msa=None,            # (b, e, n) int tokens
        extra_msa_mask=None,       # (b, e, n) bool
        seq_index=None,            # (n,) int residue indices
        seq_embed=None,            # (b, n, width)
        msa_embed=None,            # (b, m, n, width)
        templates_feats=None,      # (b, t, n, n, templates_dim)
        templates_mask=None,       # (b, t, n) bool
        templates_angles=None,     # (b, t, n, templates_angles_feats_dim)
        embedds=None,              # (b, m, n, num_embedds)
        recyclables: Optional[Recyclables] = None,
        return_trunk: bool = False,
        return_confidence: bool = False,
        return_recyclables: bool = False,
        return_aux_logits: bool = False,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        if self.token_emb is None:
            if seq_embed is None:
                raise ValueError("sequence embedding must be supplied if "
                                 "token embedding disabled")
            if msa is not None and msa_embed is None:
                raise ValueError("msa embedding must be supplied if token "
                                 "embedding disabled")
        if (templates_feats is not None or templates_angles is not None) \
                and templates_mask is None:
            raise ValueError("template features need templates_mask")

        b, n = seq.shape[:2]
        device = seq.device
        if mask is None:
            mask = torch.ones(b, n, dtype=torch.bool, device=device)
        mask = mask.bool()
        # without an MSA (or embeddings) the sequence itself is the one
        # MSA row
        if msa is None and embedds is None:
            msa = seq[:, None, :]
            msa_mask = mask[:, None, :]
        if msa is not None and msa.shape[-1] != n:
            raise ValueError("sequence length of MSA and primary sequence "
                             "must match")

        dt = self.dtype
        x_single = self._embed_tokens(seq)
        if seq_embed is not None:
            x_single = x_single + self._project_embed(seq_embed,
                                                      "seq_embed_project")

        original_msa = msa
        replaced_msa_mask = None
        if msa is not None:
            msa_mask = torch.ones_like(msa, dtype=torch.bool) \
                if msa_mask is None else msa_mask.bool()
            # MLM noising of the MSA in training
            if train:
                msa, replaced_msa_mask = self.mlm.noise(msa, msa_mask,
                                                        generator)
            m = self._embed_tokens(msa)
            if msa_embed is not None:
                m = m + self._project_embed(msa_embed, "msa_embed_project")
            m = m + x_single[:, None]
        else:
            m = self.embedd_project(embedds.to(dt))
            msa_mask = torch.ones(embedds.shape[:-1], dtype=torch.bool,
                                  device=device) \
                if msa_mask is None else msa_mask.bool()
        m = shard_msa(m)

        # pair representation by outer sum, plus relative positions
        x_left, x_right = self.to_pairwise_repr(x_single).chunk(2, dim=-1)
        x = x_left[:, :, None, :] + x_right[:, None, :, :]
        x_mask = mask[:, :, None] & mask[:, None, :]
        if seq_index is None:
            seq_index = torch.arange(n, device=device)
        rel = seq_index[:, None] - seq_index[None, :]
        rel = rel.clamp(-self.max_rel_dist, self.max_rel_dist) + \
            self.max_rel_dist
        x = x + self.pos_emb(rel)[None].to(dt)
        x = shard_pair(x)

        if recyclables is not None:
            first_row = m[:, 0] + like(self.recycling_msa_norm(
                recyclables.single_msa_repr_row).to(dt), m)
            m = torch.cat([first_row[:, None], m[:, 1:]], dim=1)
            x = x + like(self.recycling_pairwise_norm(
                recyclables.pairwise_repr).to(dt), x)
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
            x = x + like(self.recycling_distance_embed(buckets).to(dt), x)

        if templates_feats is not None:
            x = x + like(self._pooled_templates(
                unshard(x), x_mask, templates_feats, templates_mask, train,
                generator), x)

        # template angle features become extra MSA rows
        if templates_angles is not None:
            feats = self.template_angle_mlp_out(F.gelu(
                self.template_angle_mlp_in(templates_angles),
                approximate="tanh"))
            m = torch.cat([m, like(feats, m)], dim=1)
            msa_mask = torch.cat([msa_mask, templates_mask.bool()], dim=1)

        # the extra-MSA stack updates the pair (no x_single on its rows)
        if extra_msa is not None:
            if self.token_emb is None:
                raise ValueError("extra_msa needs the token embedding")
            extra_mask = torch.ones_like(extra_msa, dtype=torch.bool) \
                if extra_msa_mask is None else extra_msa_mask.bool()
            x, _ = self.extra_msa_evoformer(
                x, self._embed_tokens(extra_msa), mask=x_mask,
                msa_mask=extra_mask, train=train, generator=generator)

        x, m = self.net(x, m, mask=x_mask, msa_mask=msa_mask, train=train,
                        generator=generator)
        x, m = unshard(x), unshard(m)

        # heads (fp32): theta and phi on the pair as it is, the distogram
        # (and omega under symmetrize_omega) on the symmetrised pair
        x_f32 = x.float()
        heads = {}
        if self.predict_angles:
            heads["theta"] = self.to_prob_theta(x_f32)
            heads["phi"] = self.to_prob_phi(x_f32)
        trunk_embeds = (x_f32 + x_f32.transpose(1, 2)) * 0.5
        heads["distance"] = self.to_distogram_logits(
            self.distogram_norm(trunk_embeds))
        if train and original_msa is not None:
            heads["msa_mlm_loss"] = self.mlm(
                m[:, :original_msa.shape[1]], original_msa,
                replaced_msa_mask)
        if self.predict_angles:
            heads["omega"] = self.to_prob_omega(
                trunk_embeds if self.symmetrize_omega else x_f32)

        if not self.predict_coords or return_trunk:
            return ReturnValues(**heads)

        # single / pair projections and the structure module (fp32)
        single_msa_repr_row = m[:, 0]
        single_repr = self.msa_to_single_repr_dim(single_msa_repr_row.float())
        pairwise_repr = self.trunk_to_pairwise_repr_dim(x_f32)
        if self.structure_module is not None:
            coords, single_out = self.structure_module(
                single_repr, pairwise_repr, mask=mask)
        else:
            # the refiner as the structure module: a straight chain at
            # 3.8 A spacing breaks the translational symmetry, then
            # E(n)/SE(3) updates driven by the single and pair reprs
            chain = torch.arange(n, dtype=torch.float32, device=device)
            init_coords = (chain[:, None] * torch.tensor(
                [3.8, 0.0, 0.0], device=device))[None].expand(b, n, 3)
            single_out, coords = self.structure_module_refiner(
                single_repr, init_coords, edges=pairwise_repr, mask=mask)
        if self.refinement == "egnn-atom":
            # the CA trace -> 14-atom scaffold -> sparse EGNN over the
            # covalent graph; coords take the refined CA slot, except at
            # residues without an atom cloud (unknown tokens), which keep
            # the structure module's. As in the JAX package, `mask` does
            # not enter `has_ca`: a masked residue of a standard type
            # takes its zeroed refined slot
            _, heads["atoms"] = self.atom_refiner(single_out, coords, seq,
                                                  mask=mask)
            has_ca = scn_cloud_mask(seq)[:, :, 1:2] > 0
            coords = torch.where(has_ca, heads["atoms"][:, :, 1], coords)
        elif self.refinement == "residue":
            single_out, coords = self.coords_refiner(
                single_out, coords, edges=pairwise_repr, mask=mask)
        confidence = self.lddt_linear(single_out)

        ret = ReturnValues(
            **heads, confidence=confidence,
            recyclables=Recyclables(
                coords.detach(), single_msa_repr_row.float().detach(),
                pairwise_repr.detach()) if return_recyclables else None)
        if return_aux_logits:
            return coords, ret
        if return_confidence:
            return coords, confidence
        if return_recyclables:
            return coords, ret
        return coords
