"""Sidechainnet-format masks and atom embeddings in PyTorch (counterpart
of `alphafold2_tpu/data/scn.py`).

Per-residue atom cloud masks over the 14-slot layout, backbone (N/CA/C)
masks and indices, and atom-id tokens, as gathers from the dense tables
of `constants` (`CLOUD_MASK_TABLE`, `ATOM_ID_TABLE`) on the tokens'
device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from alphafold2_tpu_torch import constants


def _table(array: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(array, device=device)


def scn_cloud_mask(seq: torch.Tensor,
                   coords: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(b, L) int tokens -> (b, L, 14) fp32 occupancy mask. With `coords`
    ((b, L, 14, 3) or (b, L*14, 3)) the mask marks the slots holding
    nonzero coordinates instead."""
    if coords is not None:
        if coords.dim() == 3:
            coords = coords.reshape(coords.shape[0], -1,
                                    constants.NUM_COORDS_PER_RES, 3)
        return (coords.abs().sum(-1) != 0).float()
    return _table(constants.CLOUD_MASK_TABLE, seq.device)[seq.long()]


def scn_backbone_mask(seq: torch.Tensor, boolean: bool = True):
    """(b, L) -> masks over the flat (L*14,) atom cloud selecting N, CA
    and C (slots 0, 1, 2): (n_mask, ca_mask, c_mask), each (b, L*14) bool,
    or (L,) index tensors when `boolean` is False."""
    b, l = seq.shape
    k = constants.NUM_COORDS_PER_RES
    slot = torch.arange(k, device=seq.device).repeat(l)
    masks = [slot == i for i in range(3)]
    if boolean:
        return tuple(m[None].expand(b, l * k) for m in masks)
    return tuple(torch.nonzero(m)[:, 0] for m in masks)


def backbone_indices(seq_len: int, device=None):
    """(L,) index tensors of the N, CA and C atoms in the flat L*14
    cloud, the form `core.mds.mirror_fix` takes."""
    base = torch.arange(seq_len, device=device) * constants.NUM_COORDS_PER_RES
    return base, base + 1, base + 2


def scn_atom_embedd(seq: torch.Tensor) -> torch.Tensor:
    """(b, L) -> (b, L, 14) int64 atom-id tokens."""
    return _table(constants.ATOM_ID_TABLE, seq.device)[seq.long()].long()


def chain2atoms(x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-residue features to per-atom: (b, L, d) -> (b, L, 14, d),
    zeroed where `mask` (b, L, 14) is 0."""
    out = x[..., None, :].expand(*x.shape[:-1], constants.NUM_COORDS_PER_RES,
                                 x.shape[-1])
    if mask is not None:
        out = out * mask[..., None]
    return out
