"""Quaternion algebra on tensors (counterpart of
`alphafold2_tpu/core/quaternion.py`).

Convention: quaternions are (..., 4) with the scalar part first, (w, x,
y, z). Rotation matrices act on row vectors: `v @ R`.
"""

from __future__ import annotations

import torch


def identity_quaternion(shape=(), dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """(1, 0, 0, 0) broadcast to shape + (4,)."""
    q = torch.zeros((*shape, 4), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quaternion_multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a * b, both (..., 4) wxyz."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalised rotation matrix from (..., 4) wxyz -> (..., 3, 3).

    Rows are the images of the basis vectors, so `v @ R` rotates the row
    vector v."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - z * w)
    r02 = 2 * (x * z + y * w)
    r10 = 2 * (x * y + z * w)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - x * w)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def quaternion_invert(q: torch.Tensor) -> torch.Tensor:
    """Conjugate of a unit quaternion."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def rotate_vector(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by (..., 4) quaternions."""
    return torch.einsum("...c,...cd->...d", v, quaternion_to_matrix(q))
