"""Differentiable NeRF atom placement and the backbone to 14-atom
sidechain build-out in PyTorch (counterpart of
`alphafold2_tpu/core/nerf.py`).

`nerf_place` puts atom D from a chain A-B-C and (bond length, angle,
torsion); `sidechain_container` chains it over each residue's parent map
to fill the sidechainnet 14-slot scaffold from N/CA/C (or a CA trace,
from which it synthesises a virtual N and C). Vectorised over batch and
residues; the only sequential dimension is the ten sidechain slots.
Idealised bond lengths and angles by element pair with per-residue
chemistry refinements; chi torsions default to the extended
conformation with branch offsets. The build tables are numpy and go to
the coordinates' device at use.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from alphafold2_tpu_torch import constants

# ---------------------------------------------------------------------------
# NeRF primitive
# ---------------------------------------------------------------------------


def _safe_normalise(v: torch.Tensor) -> torch.Tensor:
    # eps inside the sqrt: a zero-length vector (the degenerate frame of
    # a masked-out slot) has a finite gradient
    return v / torch.sqrt((v * v).sum(-1, keepdim=True) + 1e-12)


def nerf_place(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
               bond_length, bond_angle, torsion) -> torch.Tensor:
    """Place atom D given the chain A-B-C and (|CD|, angle BCD, dihedral
    ABCD). Coordinates (..., 3); the scalars broadcast to (...,)."""
    bc = _safe_normalise(c - b)
    n = _safe_normalise(torch.linalg.cross(b - a, bc))
    m = torch.linalg.cross(n, bc)

    def scalar(v):
        return torch.as_tensor(v, dtype=c.dtype,
                               device=c.device).expand(c.shape[:-1])

    bond_length, bond_angle, torsion = map(scalar, (bond_length, bond_angle,
                                                    torsion))
    ang = math.pi - bond_angle  # interior -> placement angle
    d_local = torch.stack([
        torch.cos(ang) * bond_length,
        torch.sin(ang) * torch.cos(torsion) * bond_length,
        torch.sin(ang) * torch.sin(torsion) * bond_length,
    ], dim=-1)
    frame = torch.stack([bc, m, n], dim=-1)  # columns are the basis
    return c + torch.einsum("...ij,...j->...i", frame, d_local)


# ---------------------------------------------------------------------------
# Per-AA build tables (slots 4..13 of the 14-atom layout)
# ---------------------------------------------------------------------------


def _element(atom_name: str) -> str:
    return atom_name[0]  # N/C/O/S in the 14-slot vocabulary


_BOND_LEN = {("C", "C"): 1.52, ("C", "N"): 1.47, ("N", "C"): 1.47,
             ("C", "O"): 1.43, ("O", "C"): 1.43, ("C", "S"): 1.81,
             ("S", "C"): 1.81}
_TET = np.deg2rad(111.0)

# Per-residue chemistry refinements over the element-pair defaults:
# {three-letter: {child atom: (bond length A, angle deg at parent)}}.
# Standard small-molecule/protein values (Engh & Huber-style): aromatic
# ring C-C ~1.39, carbonyl/carboxylate C=O 1.23-1.25, amide/guanidinium
# C-N ~1.33, thioether C-S ~1.80, hydroxyl C-O ~1.42. sp2 centers get
# ~120 deg, 5-ring members ~106-127 deg (exterior).
_CHEM = {
    "ARG": {"NE": (1.46, 112.0), "CZ": (1.33, 124.5),
            "NH1": (1.33, 120.0), "NH2": (1.33, 120.0)},
    "ASN": {"OD1": (1.23, 120.8), "ND2": (1.33, 116.5)},
    "ASP": {"OD1": (1.25, 118.5), "OD2": (1.25, 118.5)},
    "CYS": {"SG": (1.81, 114.0)},
    "GLN": {"OE1": (1.23, 120.8), "NE2": (1.33, 116.5)},
    "GLU": {"OE1": (1.25, 118.5), "OE2": (1.25, 118.5)},
    "HIS": {"CG": (1.50, 113.8), "ND1": (1.38, 122.7),
            "CD2": (1.36, 131.0), "CE1": (1.32, 109.0),
            "NE2": (1.37, 107.0)},
    "ILE": {"CD1": (1.51, 113.9)},
    "LYS": {"NZ": (1.49, 111.7)},
    "MET": {"SD": (1.80, 112.7), "CE": (1.79, 100.9)},
    "PHE": {"CG": (1.50, 113.8), "CD1": (1.39, 120.7),
            "CD2": (1.39, 120.7), "CE1": (1.39, 120.7),
            "CE2": (1.39, 120.7), "CZ": (1.39, 120.0)},
    "PRO": {"CG": (1.49, 104.5), "CD": (1.50, 106.1)},
    "SER": {"OG": (1.42, 111.1)},
    "THR": {"OG1": (1.43, 109.6)},
    "TRP": {"CG": (1.50, 113.6), "CD1": (1.37, 127.0),
            "CD2": (1.43, 126.9), "NE1": (1.38, 110.2),
            "CE2": (1.41, 107.2), "CE3": (1.40, 133.9),
            "CZ2": (1.40, 122.4), "CZ3": (1.39, 118.6),
            "CH2": (1.37, 117.5)},
    "TYR": {"CG": (1.51, 113.8), "CD1": (1.39, 120.8),
            "CD2": (1.39, 120.8), "CE1": (1.39, 121.1),
            "CE2": (1.39, 121.1), "CZ": (1.38, 119.5),
            "OH": (1.38, 119.9)},
}


# Sidechain bond topology: {three-letter: {child: parent}}. The AA_DATA
# bond lists are a graph-features vocabulary, not chemistry (they wire
# aromatic rings as a sequential slot cycle and ARG's CB to backbone C),
# so the build follows this parent map instead.
_PARENTS = {
    "ALA": {"CB": "CA"},
    "ARG": {"CB": "CA", "CG": "CB", "CD": "CG", "NE": "CD", "CZ": "NE",
            "NH1": "CZ", "NH2": "CZ"},
    "ASN": {"CB": "CA", "CG": "CB", "OD1": "CG", "ND2": "CG"},
    "ASP": {"CB": "CA", "CG": "CB", "OD1": "CG", "OD2": "CG"},
    "CYS": {"CB": "CA", "SG": "CB"},
    "GLN": {"CB": "CA", "CG": "CB", "CD": "CG", "OE1": "CD", "NE2": "CD"},
    "GLU": {"CB": "CA", "CG": "CB", "CD": "CG", "OE1": "CD", "OE2": "CD"},
    "GLY": {},
    "HIS": {"CB": "CA", "CG": "CB", "ND1": "CG", "CD2": "CG",
            "CE1": "ND1", "NE2": "CD2"},
    "ILE": {"CB": "CA", "CG1": "CB", "CG2": "CB", "CD1": "CG1"},
    "LEU": {"CB": "CA", "CG": "CB", "CD1": "CG", "CD2": "CG"},
    "LYS": {"CB": "CA", "CG": "CB", "CD": "CG", "CE": "CD", "NZ": "CE"},
    "MET": {"CB": "CA", "CG": "CB", "SD": "CG", "CE": "SD"},
    "PHE": {"CB": "CA", "CG": "CB", "CD1": "CG", "CD2": "CG",
            "CE1": "CD1", "CE2": "CD2", "CZ": "CE1"},
    "PRO": {"CB": "CA", "CG": "CB", "CD": "CG"},
    "SER": {"CB": "CA", "OG": "CB"},
    "THR": {"CB": "CA", "OG1": "CB", "CG2": "CB"},
    "TRP": {"CB": "CA", "CG": "CB", "CD1": "CG", "CD2": "CG",
            "NE1": "CD1", "CE2": "CD2", "CE3": "CD2", "CZ2": "CE2",
            "CZ3": "CE3", "CH2": "CZ2"},
    "TYR": {"CB": "CA", "CG": "CB", "CD1": "CG", "CD2": "CG",
            "CE1": "CD1", "CE2": "CD2", "CZ": "CE1", "OH": "CZ"},
    "VAL": {"CB": "CA", "CG1": "CB", "CG2": "CB"},
}


def _build_tables():
    """For every AA token and slot >= 4: ancestor indices (a, b, c) within
    the residue, bond length and angle. Ancestors follow the chemical
    parent map (_PARENTS); backbone C-N-CA seeds the frame of the first
    sidechain atom."""
    n_aa = len(constants.AA_ALPHABET)
    k = constants.NUM_COORDS_PER_RES
    parent = np.zeros((n_aa, k), dtype=np.int32)
    grand = np.zeros((n_aa, k), dtype=np.int32)
    great = np.zeros((n_aa, k), dtype=np.int32)
    length = np.ones((n_aa, k), dtype=np.float32)
    angle = np.full((n_aa, k), _TET, dtype=np.float32)
    build = np.zeros((n_aa, k), dtype=np.float32)  # 1 if slot is built

    for ai, aa in enumerate(constants.AA_ALPHABET):
        if aa == "_":
            continue
        three = constants.ONE_TO_THREE[aa]
        atoms = constants.BACKBONE_ATOMS + constants.SIDECHAIN_ATOMS[three]
        slot_of = {name: i for i, name in enumerate(atoms)}
        par = {slot_of[c]: slot_of[p]
               for c, p in _PARENTS[three].items()}
        for slot in range(4, len(atoms)):
            p = par.get(slot, 1)
            if p == 1:
                # first sidechain atom off CA: frame seeded from C-N-CA
                g, gg = 0, 2
            else:
                g = par.get(p, 1)
                gg = 0 if g == 1 else par.get(g, 1)
            parent[ai, slot] = p
            grand[ai, slot] = g
            great[ai, slot] = gg
            el = (_element(atoms[p]), _element(atoms[slot]))
            length[ai, slot] = _BOND_LEN.get(el, 1.52)
            chem = _CHEM.get(three, {}).get(atoms[slot])
            if chem is not None:
                length[ai, slot] = chem[0]
                angle[ai, slot] = np.deg2rad(chem[1])
            build[ai, slot] = 1.0
    return parent, grand, great, length, angle, build


_PARENT, _GRAND, _GREAT, _LENGTH, _ANGLE, _BUILD = _build_tables()

# branch torsion offsets: siblings bonded to the same parent fan out
_TORSION_BASE = np.deg2rad(180.0)


def _branch_offsets():
    """Per (aa, slot) torsion offset so atoms sharing a parent don't
    overlap: first child 180 deg, second +120, third -120."""
    n_aa = len(constants.AA_ALPHABET)
    k = constants.NUM_COORDS_PER_RES
    off = np.zeros((n_aa, k), dtype=np.float32)
    for ai, aa in enumerate(constants.AA_ALPHABET):
        if aa == "_":
            continue
        seen = {}
        for slot in range(4, k):
            p = int(_PARENT[ai, slot])
            if _BUILD[ai, slot] == 0:
                continue
            rank = seen.get(p, 0)
            off[ai, slot] = [0.0, 2 * np.pi / 3, -2 * np.pi / 3][rank % 3]
            seen[p] = rank + 1
    return off


_TORSION_OFF = _branch_offsets()


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def place_o(n_coords, ca_coords, c_coords):
    """Backbone carbonyl O from the N-CA-C frame (anti to N, sp2)."""
    return nerf_place(n_coords, ca_coords, c_coords, bond_length=1.23,
                      bond_angle=float(np.deg2rad(121.0)), torsion=math.pi)


def _virtual_backbone(ca: torch.Tensor):
    """A virtual N and C around each CA of a trace (b, l, 3). The end
    residues borrow the adjacent chain step so their N and C span a
    plane with CA; with l == 2 both residues take the one step, and N,
    CA and C are collinear (as in the JAX package)."""
    l = ca.shape[1]
    if l > 2:
        step = ca[:, 1:] - ca[:, :-1]                      # (b, l-1, 3)
        prev_dir = torch.cat([step[:, 1:2], step], dim=1)
        next_dir = torch.cat([step, step[:, -2:-1]], dim=1)
    elif l == 2:
        step = ca[:, 1:] - ca[:, :-1]
        prev_dir = next_dir = torch.cat([step, step], dim=1)
    else:
        prev_dir = next_dir = torch.zeros_like(ca)
    return ca - prev_dir * (1.46 / 3.8), ca + next_dir * (1.52 / 3.8)


def sidechain_container(
    backbone: torch.Tensor,
    seq: torch.Tensor,
    chi_torsions: Optional[torch.Tensor] = None,
    cloud_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Backbone -> the full 14-atom scaffold.

    backbone: (b, L, A, 3) with A in {1 (CA only), 3 (N, CA, C), 4 (+O)};
    seq: (b, L) int tokens; chi_torsions: optional (b, L, 14) torsions
    added per slot; cloud_mask: optional (b, L, 14) zeroing absent slots.
    Returns (b, L, 14, 3); a slot never built sits on its parent atom
    (then zeroed by the cloud mask).
    """
    a = backbone.shape[2]
    k = constants.NUM_COORDS_PER_RES
    if a == 1:
        ca = backbone[:, :, 0]
        n_at, c_at = _virtual_backbone(ca)
    else:
        n_at, ca, c_at = backbone[:, :, 0], backbone[:, :, 1], \
            backbone[:, :, 2]
    o_at = backbone[:, :, 3] if a >= 4 else place_o(n_at, ca, c_at)
    slots = [n_at, ca, c_at, o_at]

    dev, dt = backbone.device, backbone.dtype
    tok = seq.long()

    def table(array):
        return torch.as_tensor(array, device=dev)[tok]     # (b, l, 14)

    parent, grand, great = (table(t) for t in (_PARENT, _GRAND, _GREAT))
    length, angle, build = (table(t).to(dt) for t in (_LENGTH, _ANGLE,
                                                      _BUILD))
    tors = table(_TORSION_OFF).to(dt) + _TORSION_BASE
    if chi_torsions is not None:
        tors = tors + chi_torsions

    # the ten sidechain slots in order; every ancestor index of slot s is
    # below s, so it gathers from the slots already placed
    for slot in range(4, k):
        placed_so_far = torch.stack(slots, dim=2)          # (b, l, s, 3)

        def atom(idx):
            idx = idx[:, :, slot, None, None].expand(-1, -1, 1, 3)
            return torch.gather(placed_so_far, 2, idx)[:, :, 0]

        p = atom(parent)
        placed = nerf_place(atom(great), atom(grand), p,
                            length[:, :, slot], angle[:, :, slot],
                            tors[:, :, slot])
        keep = build[:, :, slot, None]
        # an unbuilt slot collapses onto its parent atom
        slots.append(placed * keep + p * (1 - keep))

    coords = torch.stack(slots, dim=2)
    if cloud_mask is not None:
        coords = coords * cloud_mask[..., None].to(dt)
    return coords
