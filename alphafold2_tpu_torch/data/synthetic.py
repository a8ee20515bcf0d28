"""Synthetic fixed-shape batches and serving requests (counterpart of
`alphafold2_tpu/data/synthetic.py:17-99`).

Draws from a `numpy.random.Generator` so the same seed gives the same
tokens on every device, and returns tensors on the device asked for.
"""

from __future__ import annotations

import numpy as np
import torch

from alphafold2_tpu_torch import constants


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
