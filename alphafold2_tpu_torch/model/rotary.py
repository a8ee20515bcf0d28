"""Rotary and fixed sinusoidal positional embeddings in PyTorch
(counterpart of `alphafold2_tpu/model/rotary.py`): `rotate_every_two`,
`apply_rotary_pos_emb`, the sinusoidal tables and the 2-D axial tables
of a pair map, as plain functions over explicit lengths.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rotate_every_two(x: torch.Tensor) -> torch.Tensor:
    """(..., 2k): each pair (x1, x2) -> (-x2, x1), interleaved."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([-x2, x1], dim=-1).reshape(x.shape)


def apply_rotary_pos_emb(x: torch.Tensor,
                         sinu_pos: Tuple[torch.Tensor, torch.Tensor]):
    """x * cos + rotate_every_two(x) * sin; sinu_pos = (sin, cos), each
    (..., n, d_rot). With d_rot below x's width only the first d_rot
    channels rotate and the rest pass through."""
    sin, cos = sinu_pos
    rot_dim = sin.shape[-1]
    if rot_dim < x.shape[-1]:
        x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
        x_rot = x_rot * cos + rotate_every_two(x_rot) * sin
        return torch.cat([x_rot, x_pass], dim=-1)
    return x * cos + rotate_every_two(x) * sin


def fixed_positional_embedding(seq_len: int, dim: int, dtype=torch.float32,
                               device=None):
    """Sinusoidal (sin, cos) tables, each (seq_len, dim), with each
    frequency repeated for the two channels of a rotated pair."""
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dim, 2, dtype=dtype,
                                             device=device) / dim))
    t = torch.arange(seq_len, dtype=dtype, device=device)
    freqs = torch.repeat_interleave(t[:, None] * inv_freq[None], 2, dim=-1)
    return torch.sin(freqs), torch.cos(freqs)


def axial_rotary_embedding(height: int, width: int, dim: int,
                           dtype=torch.float32, device=None):
    """2-D rotary tables of an (i, j) pair map: half the channels encode
    the row, half the column. Returns (sin, cos), each (height, width,
    dim)."""
    if dim % 4:
        raise ValueError("axial rotary needs dim % 4 == 0 (two rotary "
                         "halves of even width)")
    half = dim // 2
    sin_h, cos_h = fixed_positional_embedding(height, half, dtype, device)
    sin_w, cos_w = fixed_positional_embedding(width, half, dtype, device)

    def grid(rows, cols):
        return torch.cat([rows[:, None, :].expand(height, width, half),
                          cols[None, :, :].expand(height, width, half)],
                         dim=-1)

    return grid(sin_h, sin_w), grid(cos_h, cos_w)
