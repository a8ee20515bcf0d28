"""Training losses (counterpart of `alphafold2_tpu/train/losses.py`).

- distogram cross-entropy with ignore_index=-100 over bucketised CA
  distances;
- the end-to-end coordinate loss: Kabsch-align the prediction onto the
  truth, then RMSD, plus the distogram-dispersion-weighted distance-matrix
  term;
- trRosetta-style angle cross-entropies;
- the lDDT confidence regression.

The MSA-MLM loss comes out of the model itself (`model/mlm.py`). Every
loss is a masked mean in fp32 with static shapes: `ignore_index` is a
mask, not boolean indexing.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.core import geometry as geo


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          ignore_index: int = constants.IGNORE_INDEX
                          ) -> torch.Tensor:
    """Mean CE over positions whose label != ignore_index.
    logits: (..., C) float; labels: (...,) int."""
    logits = logits.float()
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, torch.zeros_like(labels))
    logp = F.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, safe_labels.long()[..., None])[..., 0]
    m = valid.float()
    return (ce * m).sum() / torch.clamp(m.sum(), min=1.0)


def distogram_loss(distogram_logits: torch.Tensor, coords_ca: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Distogram pretraining loss: bucketise the true CA distances, CE
    against the predicted logits."""
    targets = geo.bucketed_distance_matrix(coords_ca, mask)
    return softmax_cross_entropy(distogram_logits, targets)


def angle_loss(theta_logits, phi_logits, omega_logits,
               theta_target, phi_target, omega_target) -> torch.Tensor:
    """Sum of the trRosetta anglegram CEs (targets carry ignore_index)."""
    loss = softmax_cross_entropy(theta_logits, theta_target)
    loss = loss + softmax_cross_entropy(phi_logits, phi_target)
    loss = loss + softmax_cross_entropy(omega_logits, omega_target)
    return loss


def coords_loss(pred_coords: torch.Tensor, true_coords: torch.Tensor,
                mask: torch.Tensor,
                distogram_logits: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """End-to-end coordinate loss: Kabsch-align, then RMSD; with
    distogram logits, add the dispersion-weighted distance-matrix term."""
    mask = mask.bool()
    aligned, target = geo.kabsch(pred_coords, true_coords, mask=mask)
    loss = geo.rmsd(aligned, target, mask=mask).mean()

    if distogram_logits is not None:
        probs = torch.softmax(distogram_logits.float(), dim=-1)
        _, weights = geo.center_distogram(probs)
        pair_mask = mask[..., :, None] & mask[..., None, :]
        loss = loss + geo.distmat_loss(pred_coords, true_coords,
                                       mask=weights * pair_mask)
    return loss


def lddt_confidence_loss(pred_confidence: torch.Tensor,
                         pred_coords: torch.Tensor,
                         true_coords: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Regress the confidence head (raw (b, n, 1)) onto the per-residue CA
    lDDT of the prediction (a constant target)."""
    target = geo.lddt_ca(true_coords, pred_coords, mask=mask).detach()
    pred = torch.sigmoid(pred_confidence[..., 0].float())
    m = mask.float()
    return (((pred - target) ** 2) * m).sum() / torch.clamp(m.sum(), min=1.0)
