"""Equivariant coordinate refiners in PyTorch (counterpart of
`alphafold2_tpu/model/refiners.py`): EGNN, En-Transformer-style
attention, the SE3 slot, and the atom-level EGNN over the covalent-bond
graph.

- The updates read distances and relative vectors only, so rotating and
  translating the input coordinates rotates and translates the output
  ones; node features are invariant.
- All-pairs messages are dense (b, n, n) tensors; the atom-level layer
  gathers a fixed number of bonded neighbours per atom instead.
- Coordinate updates are tanh-clamped, and their projections start at
  zero, so a fresh layer leaves coordinates where they are.

Parameter names follow the flax names (`weights.load_jax_params` maps
one onto the other). Everything here is fp32 plain PyTorch: there is no
TPU kernel behind these layers.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.core.nerf import sidechain_container
from alphafold2_tpu_torch.data.graph import covalent_neighbor_table
from alphafold2_tpu_torch.data.scn import scn_atom_embedd, scn_cloud_mask
from alphafold2_tpu_torch.model.primitives import Dense, LayerNorm


def _norm2(v, eps=1e-8):
    return (v * v).sum(-1, keepdim=True) + eps


class EGNNLayer(nn.Module):
    """One E(n)-GNN layer (Satorras et al.): invariant messages from
    (h_i, h_j, |x_i - x_j|^2, e_ij), an equivariant coordinate update
    along the relative vectors, a residual node update."""

    def __init__(self, dim: int, edge_dim: int = 0,
                 hidden: Optional[int] = None, coor_clamp: float = 3.0):
        super().__init__()
        hidden = hidden or dim * 2
        self.coor_clamp = coor_clamp
        self.edge_mlp_in = Dense(2 * dim + 1 + edge_dim, hidden)
        self.edge_mlp_out = Dense(hidden, hidden)
        self.coor_mlp = Dense(hidden, 1, bias=False, init="zeros")
        self.node_mlp_in = Dense(dim + hidden, hidden)
        self.node_mlp_out = Dense(hidden, dim)

    def forward(self, h, x, edges=None, mask=None):
        """h: (b, n, d) node features; x: (b, n, 3); edges: optional
        (b, n, n, e); mask: optional (b, n) bool."""
        b, n, d = h.shape
        rel = x[:, :, None, :] - x[:, None, :, :]          # (b, n, n, 3)
        dist2 = _norm2(rel)                                # (b, n, n, 1)
        feats = [h[:, :, None, :].expand(b, n, n, d),
                 h[:, None, :, :].expand(b, n, n, d), dist2]
        if edges is not None:
            feats.append(edges)
        msg = F.silu(self.edge_mlp_in(torch.cat(feats, dim=-1)))
        msg = F.silu(self.edge_mlp_out(msg))
        if mask is not None:
            mask = mask.bool()
            msg = msg * (mask[:, :, None] & mask[:, None, :])[..., None]
        # no self-messages
        eye = torch.eye(n, dtype=msg.dtype, device=msg.device)
        msg = msg * (1.0 - eye)[None, :, :, None]

        coor_w = torch.tanh(self.coor_mlp(msg)) * self.coor_clamp
        if mask is not None:
            denom = torch.clamp(mask.to(x.dtype).sum(-1) - 1.0,
                                min=1.0)[:, None, None]
        else:
            denom = float(max(n - 1, 1))
        x = x + (rel / torch.sqrt(dist2) * coor_w).sum(2) / denom

        agg = msg.sum(2) / denom
        dh = self.node_mlp_out(F.silu(self.node_mlp_in(
            torch.cat([h, agg], dim=-1))))
        return h + dh, x


class EnAttentionLayer(nn.Module):
    """En-Transformer-style layer: attention with a distance bias (and
    an optional pair-edge bias) gives invariant messages; the
    head-averaged attention weights an equivariant coordinate update."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 edge_dim: int = 0, coor_clamp: float = 3.0):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.coor_clamp = coor_clamp
        self.norm = LayerNorm(dim)
        self.to_q = Dense(dim, inner, bias=False)
        self.to_k = Dense(dim, inner, bias=False)
        self.to_v = Dense(dim, inner, bias=False)
        self.dist_to_bias = Dense(1, heads)
        self.edge_to_bias = Dense(edge_dim, heads, bias=False) \
            if edge_dim else None
        self.to_out = Dense(inner, dim, init="zeros")
        self.coor_mlp = Dense(1, 1, bias=False, init="zeros")

    def forward(self, h, x, edges=None, mask=None):
        b, n, _ = h.shape
        nh, hd = self.heads, self.dim_head
        hn = self.norm(h)
        q, k, v = (proj(hn).reshape(b, n, nh, hd)
                   for proj in (self.to_q, self.to_k, self.to_v))
        rel = x[:, :, None, :] - x[:, None, :, :]
        dist2 = _norm2(rel)

        logits = torch.einsum("bihd,bjhd->bhij", q, k) * hd ** -0.5
        logits = logits + self.dist_to_bias(torch.log(dist2)).permute(
            0, 3, 1, 2)
        if edges is not None:
            logits = logits + self.edge_to_bias(edges).permute(0, 3, 1, 2)
        if mask is not None:
            mask = mask.bool()
            pair = mask[:, None, :, None] & mask[:, None, None, :]
            logits = torch.where(pair, logits,
                                 torch.full_like(logits, -1e9))
        attn = logits.softmax(-1)                          # (b, h, i, j)

        out = torch.einsum("bhij,bjhd->bihd", attn, v).reshape(b, n, -1)
        h = h + self.to_out(out)
        coor_w = torch.tanh(self.coor_mlp(attn.mean(1)[..., None])) * \
            self.coor_clamp
        x = x + (rel / torch.sqrt(dist2) * coor_w).sum(2) / max(n - 1, 1)
        return h, x


class Refiner(nn.Module):
    """Iterative equivariant refinement: one weight-shared layer applied
    `iters` times. `kind` egnn runs `EGNNLayer`; en and se3 run
    `EnAttentionLayer` (on point clouds with scalar features, SE(3)
    equivariance is the E(3) equivariance of this update)."""

    def __init__(self, dim: int, kind: str = "egnn", iters: int = 4,
                 edge_dim: int = 0, heads: int = 4):
        super().__init__()
        if kind == "egnn":
            self.layer = EGNNLayer(dim, edge_dim=edge_dim)
        elif kind in ("en", "se3"):
            self.layer = EnAttentionLayer(dim, heads=heads,
                                          edge_dim=edge_dim)
        else:
            raise ValueError(f"unknown refiner kind {kind!r}")
        self.iters = iters

    def forward(self, h, x, edges=None, mask=None):
        for _ in range(self.iters):
            h, x = self.layer(h, x, edges=edges, mask=mask)
        return h, x


class SparseEGNNLayer(nn.Module):
    """EGNN over a fixed-degree neighbour list: each node gathers exactly
    `max_degree` neighbour slots (masked where no bond is), so messages
    cost O(N * max_degree) instead of all pairs."""

    def __init__(self, dim: int, max_degree: int = 4,
                 hidden: Optional[int] = None, coor_clamp: float = 3.0):
        super().__init__()
        hidden = hidden or dim * 2
        self.max_degree = max_degree
        self.coor_clamp = coor_clamp
        self.edge_mlp_in = Dense(2 * dim + 1, hidden)
        self.edge_mlp_out = Dense(hidden, hidden)
        self.coor_mlp = Dense(hidden, 1, bias=False, init="zeros")
        self.node_mlp_in = Dense(dim + hidden, hidden)
        self.node_mlp_out = Dense(hidden, dim)

    def forward(self, h, x, neigh_idx, neigh_mask, mask=None):
        """h: (b, N, d); x: (b, N, 3); neigh_idx: (b, N, K) int;
        neigh_mask: (b, N, K), 1 where the slot holds a bond; mask:
        optional (b, N) node validity."""
        b, n_nodes, d = h.shape
        k = neigh_idx.shape[-1]

        def gather(t, idx):
            c = t.shape[-1]
            flat = idx.reshape(b, n_nodes * k, 1).expand(-1, -1, c)
            return torch.gather(t, 1, flat).reshape(b, n_nodes, k, c)

        h_j = gather(h, neigh_idx)
        rel = x[:, :, None, :] - gather(x, neigh_idx)      # (b, N, K, 3)
        dist2 = _norm2(rel)
        live = neigh_mask[..., None]
        if mask is not None:
            live = live * mask[:, :, None, None]
        msg_in = torch.cat([h[:, :, None, :].expand(b, n_nodes, k, d), h_j,
                            dist2], dim=-1)
        msg = F.silu(self.edge_mlp_out(F.silu(self.edge_mlp_in(msg_in))))
        msg = msg * live

        coor_w = torch.tanh(self.coor_mlp(msg)) * self.coor_clamp * live
        denom = torch.clamp(live.sum(2), min=1.0)          # (b, N, 1)
        x = x + (rel / torch.sqrt(dist2) * coor_w).sum(2) / denom

        agg = msg.sum(2) / denom
        dh = self.node_mlp_out(F.silu(self.node_mlp_in(
            torch.cat([h, agg], dim=-1))))
        if mask is not None:
            dh = dh * mask[:, :, None]
        return h + dh, x


class AtomEGNNRefiner(nn.Module):
    """Atom-level refinement: residue representation and CA trace -> the
    14-atom scaffold (`core.nerf.sidechain_container`) -> a sparse EGNN
    over the covalent bonds (`data.graph.covalent_neighbor_table`) ->
    the refined atom cloud. Returns (h_atoms (b, L, 14, d), atoms
    (b, L, 14, 3)); atom slots outside the residue's cloud (or in a
    masked residue) are zero."""

    def __init__(self, dim: int, iters: int = 2, max_degree: int = 4):
        super().__init__()
        self.dim, self.iters = dim, iters
        self.res_to_atom = Dense(dim, dim)
        self.atom_id_embed = nn.Embedding(constants.NUM_ATOM_TOKENS, dim)
        self.layer = SparseEGNNLayer(dim, max_degree=max_degree)

    def forward(self, h_res, ca_coords, seq, mask=None):
        """h_res: (b, L, d); ca_coords: (b, L, 3); seq: (b, L) tokens;
        mask: optional (b, L) residue validity."""
        b, l, _ = h_res.shape
        kk = constants.NUM_COORDS_PER_RES
        n_atoms = l * kk
        atoms = sidechain_container(ca_coords.float()[:, :, None, :], seq)
        cloud = scn_cloud_mask(seq)                        # (b, L, 14)
        if mask is not None:
            cloud = cloud * mask[..., None].to(cloud.dtype)
        h_atom = self.res_to_atom(h_res)[:, :, None, :] + \
            self.atom_id_embed(scn_atom_embedd(seq))

        neigh_idx, neigh_mask = covalent_neighbor_table(seq)
        h = h_atom.reshape(b, n_atoms, self.dim)
        x = atoms.reshape(b, n_atoms, 3)
        node_mask = cloud.reshape(b, n_atoms)
        # a bond to a masked atom slot carries no message
        neigh_mask = neigh_mask * torch.gather(
            node_mask, 1, neigh_idx.reshape(b, -1)).reshape(neigh_idx.shape)
        for _ in range(self.iters):
            h, x = self.layer(h, x, neigh_idx, neigh_mask, mask=node_mask)
        atoms = x.reshape(b, l, kk, 3) * cloud[..., None]
        return h.reshape(b, l, kk, self.dim), atoms
