"""Rigid-body frames for the structure module (counterpart of
`alphafold2_tpu/core/rigid.py`).

Convention: global = local @ R + t (row vectors), R from the frame's
quaternion.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from alphafold2_tpu_torch.core import quaternion as quat


class Rigid(NamedTuple):
    """Batch of frames: quaternions (..., 4) wxyz, translations (..., 3)."""

    quaternions: torch.Tensor
    translations: torch.Tensor

    @classmethod
    def identity(cls, shape=(), dtype=torch.float32, device=None) -> "Rigid":
        return cls(
            quaternions=quat.identity_quaternion(shape, dtype, device),
            translations=torch.zeros((*shape, 3), dtype=dtype,
                                     device=device),
        )

    @property
    def rotations(self) -> torch.Tensor:
        return quat.quaternion_to_matrix(self.quaternions)

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """local (..., P, 3) -> global, frames broadcast over P."""
        return torch.einsum("...pc,...cd->...pd", points, self.rotations) + \
            self.translations[..., None, :]

    def apply_single(self, points: torch.Tensor) -> torch.Tensor:
        """local (..., 3) -> global, one point per frame."""
        return torch.einsum("...c,...cd->...d", points, self.rotations) + \
            self.translations

    def invert_apply(self, points: torch.Tensor) -> torch.Tensor:
        """global (..., P, 3) -> local, frames broadcast over P."""
        local = points - self.translations[..., None, :]
        return torch.einsum("...pd,...cd->...pc", local, self.rotations)

    def compose_update(self, dq: torch.Tensor, dt: torch.Tensor) -> "Rigid":
        """Apply a local-frame update: q <- q * dq (Hamilton),
        t <- t + dt @ R."""
        new_q = quat.quaternion_multiply(self.quaternions, dq)
        new_t = self.translations + torch.einsum("...c,...cd->...d", dt,
                                                 self.rotations)
        return Rigid(new_q, new_t)
