"""Structure relaxation in PyTorch (counterpart of
`alphafold2_tpu/relax.py`).

`gradient_relax` is a differentiable restraint minimiser: gradient
descent on idealised covalent bond lengths (the per-residue bond tables
plus peptide bonds) and a soft steric clash term, on the coordinates'
device. `pdb2rosetta`, `rosetta2pdb` and `run_fast_relax` need
`pyrosetta` and raise without it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from alphafold2_tpu_torch.data.graph import prot_covalent_bond

# idealised bond length (see core/nerf.py) and the clash distance, in A
_DEFAULT_BOND_LENGTH = 1.52
_CLASH_DISTANCE = 2.0


class RelaxResult(NamedTuple):
    coords: torch.Tensor          # (b, L*14, 3)
    energy_history: torch.Tensor  # (steps,)


def restraint_energy(coords_flat, bonds, atom_mask, bond_length=None):
    """Bond-length violations plus a soft steric clash energy (a scalar).
    coords_flat: (b, L*14, 3); bonds: (b, N, N) covalent adjacency;
    atom_mask: (b, N) occupancy."""
    d2 = ((coords_flat[:, :, None] - coords_flat[:, None, :]) ** 2).sum(-1)
    dist = torch.sqrt(d2 + 1e-8)
    pair_mask = atom_mask[:, :, None] * atom_mask[:, None, :]
    target = _DEFAULT_BOND_LENGTH if bond_length is None else bond_length
    bond_term = (bonds * pair_mask * (dist - target) ** 2).sum((-1, -2))
    eye = torch.eye(dist.shape[-1], dtype=dist.dtype, device=dist.device)
    nonbond = pair_mask * (1.0 - bonds) * (1.0 - eye[None])
    clash = nonbond * torch.clamp(_CLASH_DISTANCE - dist, min=0.0) ** 2
    return (bond_term + 0.25 * clash.sum((-1, -2))).sum()


def gradient_relax(coords14: torch.Tensor, seq: torch.Tensor,
                   cloud_mask: Optional[torch.Tensor] = None,
                   steps: int = 50, lr: float = 0.02) -> RelaxResult:
    """Gradient descent on the restraint energy: coords14 (b, L, 14, 3),
    seq (b, L); atoms outside `cloud_mask` (b, L, 14; default the slots
    with nonzero coordinates) stay where they are."""
    b, l, k, _ = coords14.shape
    x = coords14.reshape(b, l * k, 3).detach()
    bonds = prot_covalent_bond(seq).to(x.dtype)
    mask = (coords14.abs().sum(-1) != 0) if cloud_mask is None \
        else cloud_mask
    mask = mask.to(x.dtype).reshape(b, l * k)
    history = []
    for _ in range(steps):
        with torch.enable_grad():
            leaf = x.requires_grad_()
            (g,) = torch.autograd.grad(
                restraint_energy(leaf, bonds, mask), leaf)
        x = (x - lr * g * mask[..., None]).detach()
        history.append(restraint_energy(x, bonds, mask))
    return RelaxResult(x, torch.stack(history))


# ---------------------------------------------------------------------------
# pyrosetta-gated paths
# ---------------------------------------------------------------------------


def _require_pyrosetta():
    try:
        import pyrosetta  # noqa: F401
        return pyrosetta
    except ImportError as exc:
        raise RuntimeError(
            "pyrosetta is not installed; use gradient_relax() for the "
            "native relaxation path") from exc


def pdb2rosetta(route: str):
    """PDB file -> pyrosetta pose."""
    pyrosetta = _require_pyrosetta()
    pyrosetta.init(silent=True)
    return pyrosetta.pose_from_pdb(route)


def rosetta2pdb(pose, route: str) -> str:
    """pyrosetta pose -> PDB file."""
    _require_pyrosetta()
    pose.dump_pdb(route)
    return route


def run_fast_relax(route_in: str, route_out: str) -> str:
    """FastRelax through pyrosetta."""
    pyrosetta = _require_pyrosetta()
    pose = pdb2rosetta(route_in)
    relax = pyrosetta.rosetta.protocols.relax.FastRelax()
    relax.set_scorefxn(pyrosetta.get_fa_scorefxn())
    relax.apply(pose)
    return rosetta2pdb(pose, route_out)
