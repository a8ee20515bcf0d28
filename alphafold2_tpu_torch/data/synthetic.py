"""Synthetic fixed-shape batches and serving requests (counterpart of
`alphafold2_tpu/data/synthetic.py:17-99`), and the template and
extra-MSA inputs of a full-feature fold (`synthetic_features`, the
port's own).

Draws from a `numpy.random.Generator` so the same seed gives the same
tokens on every device, and returns tensors on the device asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from alphafold2_tpu_torch import constants

# the model's default template feature widths (Alphafold2's
# templates_dim and templates_angles_feats_dim)
TEMPLATES_DIM = 32
TEMPLATES_ANGLES_DIM = 55


def synthetic_batch(
    rng: np.random.Generator,
    batch: int = 1,
    seq_len: int = 128,
    msa_depth: int = 5,
    with_coords: bool = True,
    pad_fraction: float = 0.0,
    device="cpu",
):
    """Dict batch with keys seq, msa, mask, msa_mask and optional coords
    (CA trace, (b, n, 3)). `pad_fraction` of each row is masked out at
    the tail."""
    out = {
        "seq": rng.integers(0, constants.NUM_AMINO_ACIDS, (batch, seq_len)),
        "msa": rng.integers(0, constants.NUM_AMINO_ACIDS,
                            (batch, msa_depth, seq_len)),
    }
    n_valid = seq_len - int(seq_len * pad_fraction)
    mask = np.arange(seq_len)[None, :] < n_valid
    out["mask"] = np.broadcast_to(mask, (batch, seq_len))
    out["msa_mask"] = np.broadcast_to(mask[:, None, :],
                                      (batch, msa_depth, seq_len))
    if with_coords:
        # random-walk chain of 3.8 A steps: a realistic distance spread
        steps = rng.standard_normal((batch, seq_len, 3)).astype(np.float32)
        steps = steps / np.linalg.norm(steps, axis=-1, keepdims=True) * 3.8
        out["coords"] = np.cumsum(steps, axis=1)
    return {k: torch.as_tensor(np.array(v), device=device)
            for k, v in out.items()}


def synthetic_features(
    rng: np.random.Generator,
    seq_len: int = 128,
    valid: int = None,
    num_templates: int = 4,
    extra_depth: int = 1024,
    device="cpu",
):
    """The inputs of one fold (batch 1) beyond seq/msa, at the model's
    default widths: templates_feats (1, t, n, n, 32), templates_angles
    (1, t, n, 55), templates_mask (1, t, n), extra_msa and extra_msa_mask
    (1, e, n). The first `valid` residues are real (all when None), the
    rest padding. The last template is missing (fully masked) and the
    one before it covers only the first two thirds of the real residues;
    each extra row covers a random prefix of at least half of them."""
    valid = seq_len if valid is None else valid
    real = np.arange(seq_len) < valid
    templates_mask = np.broadcast_to(real, (1, num_templates,
                                            seq_len)).copy()
    if num_templates > 1:
        templates_mask[:, -2, (2 * valid) // 3:] = False
        templates_mask[:, -1] = False
    cover = rng.integers(valid // 2, valid + 1, (1, extra_depth, 1))
    out = {
        "templates_feats": rng.standard_normal(
            (1, num_templates, seq_len, seq_len, TEMPLATES_DIM),
            dtype=np.float32),
        "templates_angles": rng.standard_normal(
            (1, num_templates, seq_len, TEMPLATES_ANGLES_DIM),
            dtype=np.float32),
        "templates_mask": templates_mask,
        "extra_msa": rng.integers(0, constants.NUM_AMINO_ACIDS,
                                  (1, extra_depth, seq_len)),
        "extra_msa_mask": np.arange(seq_len) < cover,
    }
    return {k: torch.as_tensor(v, device=device) for k, v in out.items()}


def synthetic_requests(
    rng: np.random.Generator,
    num: int = 32,
    lengths=(24, 48, 96),
    msa_depth: int = 3,
    deadline_s=None,
    priority_levels: int = 1,
):
    """Random mixed-length `serve.request.FoldRequest`s for load tests.
    Lengths cycle through `lengths` (every bucket is covered whatever
    `num` is); msa_depth=0 emits MSA-free requests."""
    from alphafold2_tpu_torch.serve.request import FoldRequest

    requests = []
    for i in range(num):
        n = int(lengths[i % len(lengths)])
        seq = rng.integers(0, constants.NUM_AMINO_ACIDS, (n,))
        msa = None
        if msa_depth > 0:
            msa = rng.integers(0, constants.NUM_AMINO_ACIDS,
                               (msa_depth, n))
        requests.append(FoldRequest(
            seq=seq, msa=msa, deadline_s=deadline_s,
            priority=i % max(priority_levels, 1)))
    return requests


def pad_to(x: torch.Tensor, target_len: int, axis: int = 1,
           value: float = 0) -> torch.Tensor:
    """Pad one axis at its end to a fixed crop size."""
    pad = target_len - x.shape[axis]
    if pad <= 0:
        return x
    widths = [0, 0] * x.ndim
    # F.pad lists (left, right) pairs from the LAST axis backwards
    widths[2 * (x.ndim - 1 - axis) + 1] = pad
    return torch.nn.functional.pad(x, widths, value=value)
