"""PDB output and chain cleaning (counterpart of
`alphafold2_tpu/data/pdb_io.py`, without `download_pdb`, which needs the
network).

`coords2pdb` writes predicted coordinates as strict-column PDB text,
byte-equal to the JAX package's for the same numpy coordinates;
`clean_pdb` keeps the ATOM records of one chain. Reading lives in
`data/native.py`.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from alphafold2_tpu_torch import constants


def clean_pdb(name: str, route: Optional[str] = None,
              chain: Optional[str] = None) -> str:
    """Keep only ATOM records of the selected chain (first model)."""
    destin = route if route is not None else name
    with open(name) as f:
        text = f.read()
    out_lines = []
    active = chain
    for line in text.splitlines():
        if line.startswith("ENDMDL"):
            break
        if line.startswith("ATOM") and len(line) >= 54:
            ch = line[21]
            if active is None:
                active = ch
            if ch == active:
                out_lines.append(line)
    with open(destin, "w") as f:
        f.write("\n".join(out_lines) + "\nEND\n")
    return destin


def coords2pdb(
    seq: np.ndarray,
    coords: np.ndarray,
    cloud_mask: Optional[np.ndarray] = None,
    prefix: str = "",
    name: str = "af2_struct.pdb",
) -> str:
    """Write a (L, 14, 3) scaffold (or (L, 3) CA trace) as PDB text.
    Returns the written path."""
    seq = np.asarray(seq)
    coords = np.asarray(coords)
    if coords.ndim == 2:  # CA trace -> put in slot 1
        ca = coords
        coords = np.zeros((len(seq), constants.NUM_COORDS_PER_RES, 3),
                          dtype=np.float32)
        coords[:, 1] = ca
        cloud_mask = np.zeros(coords.shape[:2], dtype=bool)
        cloud_mask[:, 1] = True
    if cloud_mask is None:
        cloud_mask = np.abs(coords).sum(-1) != 0

    lines = []
    serial = 1
    for i, tok in enumerate(seq):
        aa = constants.AA_ALPHABET[int(tok)]
        if aa == "_":
            continue
        three = constants.ONE_TO_THREE[aa]
        atoms = constants.BACKBONE_ATOMS + constants.SIDECHAIN_ATOMS[three]
        for slot, atom in enumerate(atoms):
            if slot >= coords.shape[1] or not cloud_mask[i, slot]:
                continue
            x, y, z = coords[i, slot]
            element = atom[0]
            # strict PDB columns: atom 13-16, altLoc 17, resName 18-20,
            # chain 22, resSeq 23-26, coords 31-54, element 77-78
            lines.append(
                f"ATOM  {serial:5d} {atom:<4} {three:>3} A{i + 1:4d}    "
                f"{x:8.3f}{y:8.3f}{z:8.3f}  1.00  0.00          "
                f"{element:>2}")
            serial += 1
    lines.append("END")
    path = os.path.join(prefix, name) if prefix else name
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
