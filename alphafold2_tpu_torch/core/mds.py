"""Multidimensional scaling, distance matrix -> 3-D coordinates, in
PyTorch (counterpart of `alphafold2_tpu/core/mds.py`).

Classical-MDS initialisation from one batched SVD, then a fixed number
of weighted Guttman-transform iterations in which a batch element whose
relative stress stops improving by `tol` freezes (its later iterations
leave it as it is), then the chirality mirror fix: flip z when fewer
than half of the backbone phi dihedrals are negative. Coordinates are
(..., N, 3). An SVD fixes each singular vector only up to its sign, so
two backends may return the same structure reflected per axis: compare
their outputs by distances.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from alphafold2_tpu_torch.core import geometry as geo


class MDSResult(NamedTuple):
    coords: torch.Tensor          # (b, n, 3)
    stress_history: torch.Tensor  # (iters, b) normalised stress per iteration


def eigen_init(dist_mat: torch.Tensor) -> torch.Tensor:
    """Classical-MDS initialisation from the squared-distance Gram
    matrix. dist_mat: (b, n, n) -> (b, n, 3)."""
    d2 = dist_mat ** 2
    m = 0.5 * (d2[:, :1, :] + d2[:, :, :1] - d2)
    u, s, _ = torch.linalg.svd(m)
    return (u * torch.sqrt(s.abs())[..., None, :])[..., :3]


def mds(dist_mat: torch.Tensor, weights: Optional[torch.Tensor] = None,
        iters: int = 10, tol: float = 1e-5,
        eigen_only: bool = False) -> MDSResult:
    """Weighted MDS: eigen initialisation and `iters` Guttman transforms.
    dist_mat: (b, n, n) target distances; weights: (b, n, n) per-pair
    confidence (`geometry.center_distogram`'s)."""
    b, n, _ = dist_mat.shape
    coords = eigen_init(dist_mat)
    if eigen_only and weights is None:
        return MDSResult(coords, dist_mat.new_zeros((0, b)))

    w = torch.ones_like(dist_mat) if weights is None else weights
    eye = torch.eye(n, dtype=dist_mat.dtype, device=dist_mat.device)
    last = torch.full((b,), float("inf"), dtype=dist_mat.dtype,
                      device=dist_mat.device)
    done = torch.zeros(b, dtype=torch.bool, device=dist_mat.device)
    history = []
    for _ in range(iters):
        cur = geo.cdist(coords, coords)
        stress = 0.5 * (w * (cur - dist_mat) ** 2).sum((-1, -2))
        cur_safe = torch.where(cur <= 0, cur + 1e-7, cur)
        ratio = w * dist_mat / cur_safe
        # Guttman transform: B = -ratio with the row sums on the diagonal
        bmat = -ratio + eye * ratio.sum(-1)[..., None, :]
        new_coords = bmat @ coords / n
        norm = torch.linalg.norm(new_coords, dim=(-1, -2))
        rel = stress / torch.clamp(norm, min=1e-9)
        done = done | ~((last - rel) > tol)
        coords = torch.where(done[:, None, None], coords, new_coords)
        last = torch.where(done, last, rel)
        history.append(rel)
    return MDSResult(coords, torch.stack(history))


def mirror_fix(coords: torch.Tensor, n_idx: torch.Tensor,
               ca_idx: torch.Tensor, c_idx: torch.Tensor) -> torch.Tensor:
    """Flip z where fewer than half of the phi dihedrals are negative.
    coords: (b, n_points, 3); *_idx: (L,) indices of the N, CA and C
    atoms (`data.scn.backbone_indices`)."""
    frac_neg = geo.fraction_negative_phis(coords[:, n_idx], coords[:, ca_idx],
                                          coords[:, c_idx])
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=coords.dtype,
                        device=coords.device)
    return torch.where((frac_neg < 0.5)[:, None, None], coords * flip,
                       coords)


def mdscaling(dist_mat: torch.Tensor, weights: Optional[torch.Tensor] = None,
              iters: int = 10, tol: float = 1e-5, fix_mirror: bool = True,
              n_idx: Optional[torch.Tensor] = None,
              ca_idx: Optional[torch.Tensor] = None,
              c_idx: Optional[torch.Tensor] = None,
              eigen_only: bool = False) -> MDSResult:
    """MDS, then the mirror fix over the given N/CA/C indices."""
    result = mds(dist_mat, weights=weights, iters=iters, tol=tol,
                 eigen_only=eigen_only)
    if not fix_mirror:
        return result
    if n_idx is None or ca_idx is None or c_idx is None:
        raise ValueError("mirror fixing needs N/CA/C index arrays")
    return MDSResult(mirror_fix(result.coords, n_idx, ca_idx, c_idx),
                     result.stress_history)
