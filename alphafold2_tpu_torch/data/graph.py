"""Protein graph utilities in PyTorch (counterpart of
`alphafold2_tpu/data/graph.py`).

The covalent-bond adjacency over the flat L*14 atom cloud (per-residue
bonds from `constants.BOND_ADJACENCY_TABLE`, peptide bonds C(i)-N(i+1)),
its n-th degree powers, the padded-batch to flat-graph conversion, and
the fixed-degree neighbour list (`covalent_neighbor_table`) that the
atom-level refiner gathers over instead of a dense (N, N) adjacency.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from alphafold2_tpu_torch import constants


def prot_covalent_bond(seq: torch.Tensor,
                       include_peptide_bonds: bool = True) -> torch.Tensor:
    """(b, L) tokens -> (b, L*14, L*14) fp32 covalent-bond adjacency."""
    b, l = seq.shape
    k = constants.NUM_COORDS_PER_RES
    n = l * k
    table = torch.as_tensor(constants.BOND_ADJACENCY_TABLE,
                            device=seq.device)
    intra = table[seq.long()]                           # (b, l, 14, 14)
    adj = torch.zeros(b, l, k, l, k, dtype=intra.dtype, device=seq.device)
    res = torch.arange(l, device=seq.device)
    # each residue's block on the diagonal
    adj[:, res, :, res, :] = intra.permute(1, 0, 2, 3)
    adj = adj.reshape(b, n, n)
    if include_peptide_bonds and l > 1:
        c_idx = res[:-1] * k + 2   # C of residue i
        n_idx = res[1:] * k        # N of residue i+1
        adj[:, c_idx, n_idx] = 1.0
        adj[:, n_idx, c_idx] = 1.0
    return adj


def nth_deg_adjacency(adj: torch.Tensor, n: int = 1, sparse: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neighbours within n hops: (attr_mat, hops), attr_mat[i, j] the
    reachability weight times its degree and hops[i, j] the smallest hop
    count (0 where unreachable within n). `sparse` is accepted for the
    JAX signature; the computation is dense."""
    del sparse
    attr = adj
    hops = (adj > 0).to(adj.dtype)
    power = adj
    for deg in range(2, n + 1):
        power = torch.clamp(power @ adj, 0.0, 1.0)
        new = (power > 0) & (hops == 0)
        hops = hops + new.to(adj.dtype) * deg
        attr = torch.where(new, power * deg, attr)
    return attr, hops


def mat_input_to_masked(x: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        edges_mat: Optional[torch.Tensor] = None):
    """Padded batch -> flat nodes with a validity mask and the dense edge
    matrices with an edge mask (static shapes, no compaction).

    x: (b, N, d); mask: (b, N) bool; edges_mat: (b, N, N). Returns
    (nodes (b*N, d), node_mask (b*N,), edges (b, N, N), edge_mask
    (b, N, N)), the last two None without `edges_mat`."""
    b, n, d = x.shape
    nodes = x.reshape(b * n, d)
    m = torch.ones(b, n, dtype=torch.bool, device=x.device) \
        if mask is None else mask.bool()
    node_mask = m.reshape(b * n)
    if edges_mat is None:
        return nodes, node_mask, None, None
    edge_mask = m[:, :, None] & m[:, None, :] & (edges_mat > 0)
    return nodes, node_mask, edges_mat, edge_mask


def _intra_neighbor_tables():
    """(21, 14, 3) neighbour slot ids and mask from the bond table (the
    largest intra-residue degree of the 14-slot layout is 3)."""
    t = constants.BOND_ADJACENCY_TABLE
    k_intra = int((t > 0).sum(-1).max())
    idx = np.zeros((*t.shape[:2], k_intra), np.int64)
    msk = np.zeros((*t.shape[:2], k_intra), np.float32)
    for a in range(t.shape[0]):
        for s in range(t.shape[1]):
            nb = np.nonzero(t[a, s])[0]
            idx[a, s, :len(nb)] = nb
            msk[a, s, :len(nb)] = 1.0
    return idx, msk


_INTRA_IDX, _INTRA_MASK = _intra_neighbor_tables()


def covalent_neighbor_table(seq: torch.Tensor,
                            include_peptide_bonds: bool = True
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(b, L) tokens -> neighbour list over the flat L*14 atom cloud:
    (idx (b, L*14, 4) int64, mask (b, L*14, 4) fp32). The same bonds as
    `prot_covalent_bond` in O(N) memory: three intra-residue slots and
    one peptide slot, masked where absent."""
    b, l = seq.shape
    k = constants.NUM_COORDS_PER_RES
    dev = seq.device
    li = torch.as_tensor(_INTRA_IDX, device=dev)[seq.long()]  # (b, l, 14, 3)
    lm = torch.as_tensor(_INTRA_MASK, device=dev)[seq.long()]
    base = (torch.arange(l, device=dev) * k)[None, :, None, None]
    gidx = (li + base).reshape(b, l * k, -1)
    gmask = lm.reshape(b, l * k, -1)

    # the peptide column does not depend on the sequence: N (slot 0)
    # bonds back to C (slot 2) of residue i-1, C forward to N of i+1
    pep = np.zeros((l, k), np.int64)
    pmask = np.zeros((l, k), np.float32)
    if include_peptide_bonds and l > 1:
        rows = np.arange(l)
        pep[1:, 0] = (rows[1:] - 1) * k + 2
        pmask[1:, 0] = 1.0
        pep[:-1, 2] = (rows[:-1] + 1) * k
        pmask[:-1, 2] = 1.0
    pep_idx = torch.as_tensor(pep, device=dev).reshape(1, l * k, 1)
    pep_mask = torch.as_tensor(pmask, device=dev).reshape(1, l * k, 1)
    return (torch.cat([gidx, pep_idx.expand(b, -1, -1)], dim=-1),
            torch.cat([gmask, pep_mask.expand(b, -1, -1)], dim=-1))
