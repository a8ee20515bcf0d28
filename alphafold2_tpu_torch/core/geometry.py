"""Geometry and structure-quality metrics in PyTorch (counterpart of
`alphafold2_tpu/core/geometry.py`).

Distance binning, distogram centering, dihedrals, Kabsch alignment,
RMSD / GDT / TM-score / lDDT and the distance-matrix loss. Batched,
mask-aware and static-shaped (masked means, no boolean indexing), and
differentiable. Coordinates are (..., N, 3).
"""

from __future__ import annotations

from typing import Optional

import torch

from alphafold2_tpu_torch import constants

# ---------------------------------------------------------------------------
# Pairwise distances & distogram targets
# ---------------------------------------------------------------------------


def cdist(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Pairwise Euclidean distances. x: (..., N, D), y: (..., M, D)."""
    d2 = ((x[..., :, None, :] - y[..., None, :, :]) ** 2).sum(-1)
    # sqrt has an unstable gradient at exactly 0 (the diagonal); clamp.
    return torch.sqrt(torch.clamp(d2, min=eps))


def distogram_boundaries(
    num_buckets: int = constants.DISTOGRAM_BUCKETS,
    min_dist: float = constants.DISTOGRAM_MIN_DIST,
    max_dist: float = constants.DISTOGRAM_MAX_DIST,
    device=None,
) -> torch.Tensor:
    """linspace(2, 20, B)."""
    return torch.linspace(min_dist, max_dist, num_buckets, device=device)


def bucketed_distance_matrix(
    coords: torch.Tensor,
    mask: torch.Tensor,
    num_buckets: int = constants.DISTOGRAM_BUCKETS,
    ignore_index: int = constants.IGNORE_INDEX,
) -> torch.Tensor:
    """Distogram CE targets. coords: (..., N, 3); mask: (..., N) bool.
    Returns (..., N, N) int64 with `ignore_index` outside the pair mask."""
    distances = cdist(coords, coords)
    boundaries = distogram_boundaries(num_buckets,
                                      device=coords.device)[:-1]
    # right=False is searchsorted(side="left"): a value exactly on a
    # boundary stays in the lower bucket
    buckets = torch.bucketize(distances, boundaries.to(distances.dtype),
                              right=False)
    mask = mask.bool()
    pair_mask = mask[..., :, None] & mask[..., None, :]
    return torch.where(pair_mask, buckets,
                       torch.full_like(buckets, ignore_index))


def center_distogram(
    distogram: torch.Tensor,
    bins: Optional[torch.Tensor] = None,
    center: str = "mean",
    wide: str = "std",
    eps: float = 1e-7,
):
    """Central distance estimate + confidence weights from a distogram.

    distogram: (..., N, N, B) non-negative bin weights (probabilities ok).
    Returns (central (..., N, N), weights (..., N, N))."""
    if bins is None:
        bins = distogram_boundaries(device=distogram.device)
    bins = bins.to(distogram.dtype)
    # bin centers: shift down half a step; first bin -> 1.5 A, last bin is
    # the catch-all "far" bin at 1.33 * max
    step = bins[2] - bins[1]
    n_bins = bins - 0.5 * step
    n_bins = torch.cat([n_bins.new_tensor([1.5]), n_bins[1:-1],
                        (1.33 * bins[-1])[None]])

    magnitudes = distogram.sum(-1)

    if center == "median":
        cum = torch.cumsum(distogram, dim=-1)
        target = 0.5 * cum[..., -1:]
        idx = (cum < target).sum(-1)
        idx = torch.clamp(idx, max=n_bins.shape[0] - 1)
        central = n_bins[idx]
    else:  # mean
        central = (distogram * n_bins).sum(-1) / (magnitudes + eps)

    # pairs predicted beyond the last real bin are ignored downstream
    valid = (central <= bins[-2]).to(distogram.dtype)

    n = distogram.shape[-2]
    eye = torch.eye(n, dtype=distogram.dtype, device=distogram.device)
    central = central * (1.0 - eye)  # zero diagonal

    if wide in ("var", "std"):
        disp = (distogram * (n_bins - central[..., None]) ** 2).sum(-1)
        disp = disp / (magnitudes + eps)
        if wide == "std":
            disp = torch.sqrt(torch.clamp(disp, min=0.0))
    else:
        disp = torch.zeros_like(central)

    weights = valid / (1.0 + disp)
    weights = torch.nan_to_num(weights) * (1.0 - eye)
    return central, weights


# ---------------------------------------------------------------------------
# Dihedrals
# ---------------------------------------------------------------------------


def dihedral(c1, c2, c3, c4) -> torch.Tensor:
    """Dihedral angle (radians) via the atan2 polymer-physics formula.
    Inputs (..., 3), output (...,)."""
    u1 = c2 - c1
    u2 = c3 - c2
    u3 = c4 - c3
    c12 = torch.linalg.cross(u1, u2)
    c23 = torch.linalg.cross(u2, u3)
    y = (torch.linalg.norm(u2, dim=-1, keepdim=True) * u1 * c23).sum(-1)
    x = (c12 * c23).sum(-1)
    return torch.atan2(y, x)


def backbone_phis(n_coords, ca_coords, c_coords) -> torch.Tensor:
    """Phi dihedrals C(-1)-N-CA-C per residue 1..L-1. Inputs (..., L, 3);
    output (..., L-1)."""
    return dihedral(
        c_coords[..., :-1, :],
        n_coords[..., 1:, :],
        ca_coords[..., 1:, :],
        c_coords[..., 1:, :],
    )


def fraction_negative_phis(n_coords, ca_coords, c_coords, mask=None):
    """Proportion of negative phi angles, the mirror-selection statistic.
    Output (...,)."""
    phis = backbone_phis(n_coords, ca_coords, c_coords)
    neg = (phis < 0).float()
    if mask is not None:
        mask = mask.bool()
        m = (mask[..., :-1] & mask[..., 1:]).float()
        return (neg * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0)
    return neg.mean(-1)


# ---------------------------------------------------------------------------
# Kabsch alignment
# ---------------------------------------------------------------------------


def kabsch(x: torch.Tensor, y: torch.Tensor,
           mask: Optional[torch.Tensor] = None):
    """Optimal-rotation alignment of x onto y. x, y: (..., N, 3); mask:
    (..., N) optional. Returns (x_aligned, y_centered), both centered at
    the origin, with x rotated onto y. The rotation is a constant in the
    backward (the covariance is detached), and the SVD's reflection is
    fixed by flipping the last column of U when det(U) det(V^T) < 0."""
    if mask is None:
        w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    else:
        w = mask.to(x.dtype)
    wsum = torch.clamp(w.sum(-1, keepdim=True), min=1.0)[..., None]
    x_mu = (x * w[..., None]).sum(-2, keepdim=True) / wsum
    y_mu = (y * w[..., None]).sum(-2, keepdim=True) / wsum
    x_c = (x - x_mu) * w[..., None]
    y_c = (y - y_mu) * w[..., None]

    c = (x_c.transpose(-1, -2) @ y_c).detach()
    u, _, vt = torch.linalg.svd(c, full_matrices=False)
    det = torch.linalg.det(u) * torch.linalg.det(vt)
    flip = torch.where(det < 0, -1.0, 1.0).to(u.dtype)
    u = torch.cat([u[..., :, :-1], u[..., :, -1:] * flip[..., None, None]],
                  dim=-1)
    rot = u @ vt
    return x_c @ rot, y_c


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def _masked_mean(x, mask, dim):
    if mask is None:
        return x.mean(dim)
    m = mask.to(x.dtype)
    return (x * m).sum(dim) / torch.clamp(m.sum(dim), min=1.0)


def rmsd(x, y, mask=None) -> torch.Tensor:
    """RMSD between point sets (..., N, 3) -> (...,): the mean over both
    the coordinate axis and the points."""
    sq = (x - y) ** 2
    if mask is not None:
        m = mask[..., None].to(x.dtype)
        return torch.sqrt((sq * m).sum((-1, -2)) / torch.clamp(
            3.0 * mask.to(x.dtype).sum(-1), min=1.0))
    return torch.sqrt(sq.mean((-1, -2)))


def gdt(x, y, mask=None, mode: str = "TS", weights=None) -> torch.Tensor:
    """GDT_TS / GDT_HA."""
    cutoffs = torch.tensor([0.5, 1.0, 2.0, 4.0] if mode.upper() == "HA"
                           else [1.0, 2.0, 4.0, 8.0], dtype=x.dtype,
                           device=x.device)
    if weights is None:
        weights = torch.ones_like(cutoffs)
    else:
        weights = torch.as_tensor(weights, dtype=x.dtype, device=x.device)
    dist = torch.linalg.norm(x - y, dim=-1)  # (..., N)
    under = (dist[..., None, :] <= cutoffs[:, None]).to(x.dtype)
    frac = _masked_mean(under, None if mask is None else mask[..., None, :],
                        -1)
    return (frac * weights).mean(-1)


def tm_score(x, y, mask=None) -> torch.Tensor:
    """TM-score. x, y: (..., N, 3)."""
    if mask is None:
        n = torch.full(x.shape[:-2], float(x.shape[-2]), dtype=x.dtype,
                       device=x.device)
    else:
        n = torch.clamp(mask.to(x.dtype).sum(-1), min=1.0)
    l_eff = torch.clamp(n, min=15.0)
    d0 = 1.24 * (l_eff - 15.0) ** (1.0 / 3.0) - 1.8
    dist = torch.linalg.norm(x - y, dim=-1)
    score = 1.0 / (1.0 + (dist / d0[..., None]) ** 2)
    return _masked_mean(score, mask, -1)


def lddt_ca(
    true_ca: torch.Tensor,
    pred_ca: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    r0: float = 15.0,
    thresholds=(0.5, 1.0, 2.0, 4.0),
) -> torch.Tensor:
    """Per-residue CA lDDT in [0, 1]. true_ca, pred_ca: (..., L, 3);
    mask: (..., L). Returns (..., L)."""
    if mask is None:
        mask = torch.ones(true_ca.shape[:-1], dtype=torch.bool,
                          device=true_ca.device)
    m = mask.to(true_ca.dtype)
    pair_m = m[..., :, None] * m[..., None, :]
    n = true_ca.shape[-2]
    off_diag = 1.0 - torch.eye(n, dtype=true_ca.dtype,
                               device=true_ca.device)
    pair_m = pair_m * off_diag

    dt = cdist(true_ca, true_ca)
    dp = cdist(pred_ca, pred_ca)
    incl = (dt < r0).to(true_ca.dtype) * pair_m
    diff = torch.abs(dp - dt)
    th = torch.tensor(thresholds, dtype=true_ca.dtype, device=true_ca.device)
    ok = (diff[..., None] < th).to(true_ca.dtype).mean(-1)
    denom = torch.clamp(incl.sum(-1), min=1e-9)
    return (ok * incl).sum(-1) / denom * m


def distmat_loss(
    x=None, y=None, x_mat=None, y_mat=None,
    p: float = 2.0, q: float = 2.0, mask=None, clamp=None,
) -> torch.Tensor:
    """Alignment-free distance-matrix loss."""

    def distances(z):
        if clamp is not None:
            z = torch.clamp(z, *clamp)
        if p == 2:
            return cdist(z, z)
        return (torch.abs(z[..., :, None, :] - z[..., None, :, :]) ** p
                ).sum(-1) ** (1.0 / p)

    if x_mat is None:
        x_mat = distances(x)
    if y_mat is None:
        y_mat = distances(y)
    loss = (x_mat - y_mat) ** 2
    if q != 2:
        loss = loss ** (q / 2.0)
    if mask is None:
        return loss.mean()
    m = mask.to(loss.dtype)
    return (loss * m).sum() / torch.clamp(m.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Aligned-metric conveniences
# ---------------------------------------------------------------------------


def kabsch_rmsd(x, y, mask=None) -> torch.Tensor:
    """RMSD after optimal alignment of x onto y."""
    x_a, y_c = kabsch(x, y, mask=mask)
    return rmsd(x_a, y_c, mask=mask)


def kabsch_tm(x, y, mask=None) -> torch.Tensor:
    x_a, y_c = kabsch(x, y, mask=mask)
    return tm_score(x_a, y_c, mask=mask)


def kabsch_gdt(x, y, mask=None, mode: str = "TS") -> torch.Tensor:
    x_a, y_c = kabsch(x, y, mask=mask)
    return gdt(x_a, y_c, mask=mask, mode=mode)


__all__ = [
    "backbone_phis", "bucketed_distance_matrix", "cdist", "center_distogram",
    "dihedral", "distmat_loss", "distogram_boundaries",
    "fraction_negative_phis", "gdt", "kabsch", "kabsch_gdt", "kabsch_rmsd",
    "kabsch_tm", "lddt_ca", "rmsd", "tm_score",
]

