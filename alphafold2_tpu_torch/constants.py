"""Model-level constants the PyTorch port needs.

A copy of the slice of `alphafold2_tpu/constants.py` that the fold and
train paths, the featurizer and the PDB reader and writer read (the port
imports nothing of the JAX package, not even its numpy-only modules).
Values must stay equal to the JAX package's; `tests/test_torch_model.py`,
`tests/test_torch_data.py` and `tests/test_torch_decode.py` pin that. The
atom tables (cloud masks, atom ids, bond adjacency) are numpy arrays,
built here as the JAX package builds them.
"""

import numpy as np

MAX_NUM_MSA = 20
MAX_NUM_TEMPLATES = 10
NUM_AMINO_ACIDS = 21
NUM_EMBEDDS_TR = 1280  # ESM-1b embedding width

DISTOGRAM_BUCKETS = 37
# trRosetta-style angle heads
THETA_BUCKETS = 25
PHI_BUCKETS = 13
OMEGA_BUCKETS = 25

# pretrained-LM embedding widths the model keeps a projector for
MSA_EMBED_DIM = 768         # ESM MSA-Transformer
PROTTRAN_EMBED_DIM = 1024   # ProtT5-XL
ESM_EMBED_DIM = 1280        # ESM-1b

# label of positions a cross-entropy skips
IGNORE_INDEX = -100

# Distogram bin edges span 2..20 Angstrom; the recycling embedder buckets
# CA distances over the same range.
DISTOGRAM_MIN_DIST = 2.0
DISTOGRAM_MAX_DIST = 20.0

# sidechainnet atom slots per residue (the 14-slot coordinate layout the
# PDB reader and writer use)
NUM_COORDS_PER_RES = 14

# Sidechainnet / proteinnet ordering: alphabetical by 3-letter code, then pad.
AA_ALPHABET = "ARNDCQEGHILKMFPSTWYV_"

ONE_TO_THREE = {
    "A": "ALA", "R": "ARG", "N": "ASN", "D": "ASP", "C": "CYS",
    "Q": "GLN", "E": "GLU", "G": "GLY", "H": "HIS", "I": "ILE",
    "L": "LEU", "K": "LYS", "M": "MET", "F": "PHE", "P": "PRO",
    "S": "SER", "T": "THR", "W": "TRP", "Y": "TYR", "V": "VAL",
}

THREE_TO_ONE = {v: k for k, v in ONE_TO_THREE.items()}

# sidechain atom names beyond the N/CA/C/O backbone, in sidechainnet
# build order (slot 4 onward of the 14-slot layout)
SIDECHAIN_ATOMS = {
    "ALA": ["CB"],
    "ARG": ["CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"],
    "ASN": ["CB", "CG", "OD1", "ND2"],
    "ASP": ["CB", "CG", "OD1", "OD2"],
    "CYS": ["CB", "SG"],
    "GLN": ["CB", "CG", "CD", "OE1", "NE2"],
    "GLU": ["CB", "CG", "CD", "OE1", "OE2"],
    "GLY": [],
    "HIS": ["CB", "CG", "ND1", "CD2", "CE1", "NE2"],
    "ILE": ["CB", "CG1", "CG2", "CD1"],
    "LEU": ["CB", "CG", "CD1", "CD2"],
    "LYS": ["CB", "CG", "CD", "CE", "NZ"],
    "MET": ["CB", "CG", "SD", "CE"],
    "PHE": ["CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"],
    "PRO": ["CB", "CG", "CD"],
    "SER": ["CB", "OG"],
    "THR": ["CB", "OG1", "CG2"],
    "TRP": ["CB", "CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"],
    "TYR": ["CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ", "OH"],
    "VAL": ["CB", "CG1", "CG2"],
}

BACKBONE_ATOMS = ["N", "CA", "C", "O"]

# pretrained-LM hub coordinates (plain data: the port loads no hub model)
MSA_MODEL_PATH = ["facebookresearch/esm", "esm_msa1_t12_100M_UR50S"]
ESM_MODEL_PATH = ["facebookresearch/esm", "esm1b_t33_650M_UR50S"]

# per-residue covalent-bond graphs over the 14-slot atom layout; slots
# 0..3 = N, CA, C, O, 4.. = sidechain
AA_DATA = {
    "A": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4]]},
    "R": {"bonds": [[0, 1], [1, 2], [2, 3], [2, 4], [4, 5], [5, 6],
                    [6, 7], [7, 8], [8, 9], [8, 10]]},
    "N": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6], [5, 7]]},
    "D": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6], [5, 7]]},
    "C": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5]]},
    "Q": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6],
                    [6, 7], [6, 8]]},
    "E": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6],
                    [6, 7], [7, 8]]},
    "G": {"bonds": [[0, 1], [1, 2], [2, 3]]},
    "H": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6],
                    [6, 7], [7, 8], [8, 9], [5, 9]]},
    "I": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6], [4, 7]]},
    "L": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6], [5, 7]]},
    "K": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6],
                    [6, 7], [7, 8]]},
    "M": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6], [6, 7]]},
    "F": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6],
                    [6, 7], [7, 8], [8, 9], [9, 10], [5, 10]]},
    "P": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6], [0, 6]]},
    "S": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5]]},
    "T": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [4, 6]]},
    "W": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6],
                    [6, 7], [7, 8], [8, 9], [9, 10], [10, 11], [11, 12],
                    [12, 13], [5, 13], [8, 13]]},
    "Y": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [5, 6],
                    [6, 7], [7, 8], [8, 9], [8, 10], [10, 11], [5, 11]]},
    "V": {"bonds": [[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [4, 6]]},
    "_": {"bonds": []},
}


def _build_atom_ids() -> dict:
    """Token id per atom name: the sorted set of backbone and sidechain
    names plus the empty-slot token ''."""
    names = {"", "N", "CA", "C", "O"}
    for atoms in SIDECHAIN_ATOMS.values():
        names.update(atoms)
    return {name: i for i, name in enumerate(sorted(names))}


ATOM_IDS = _build_atom_ids()
NUM_ATOM_TOKENS = len(ATOM_IDS)


def _cloud_mask(aa: str) -> np.ndarray:
    """Occupied atom slots of the 14-slot layout."""
    mask = np.zeros(NUM_COORDS_PER_RES, dtype=np.float32)
    if aa == "_":
        return mask
    mask[:4 + len(SIDECHAIN_ATOMS[ONE_TO_THREE[aa]])] = 1
    return mask


def _atom_id_embedds(aa: str) -> np.ndarray:
    """Atom-token id per slot."""
    ids = np.zeros(NUM_COORDS_PER_RES, dtype=np.int32)
    if aa == "_":
        return ids
    for i, atom in enumerate(BACKBONE_ATOMS +
                             SIDECHAIN_ATOMS[ONE_TO_THREE[aa]]):
        ids[i] = ATOM_IDS[atom]
    return ids


CUSTOM_INFO = {
    aa: {"cloud_mask": _cloud_mask(aa), "atom_id_embedd": _atom_id_embedds(aa)}
    for aa in AA_ALPHABET
}

# dense (21, 14) lookup tables indexed by token id (one gather per batch)
CLOUD_MASK_TABLE = np.stack(
    [CUSTOM_INFO[aa]["cloud_mask"] for aa in AA_ALPHABET])
ATOM_ID_TABLE = np.stack(
    [CUSTOM_INFO[aa]["atom_id_embedd"] for aa in AA_ALPHABET])


def _bond_adjacency() -> np.ndarray:
    """(21, 14, 14) symmetric 0/1 bond adjacency per residue type."""
    adj = np.zeros((len(AA_ALPHABET), NUM_COORDS_PER_RES, NUM_COORDS_PER_RES),
                   dtype=np.float32)
    for idx, aa in enumerate(AA_ALPHABET):
        for i, j in AA_DATA[aa]["bonds"]:
            adj[idx, i, j] = 1.0
            adj[idx, j, i] = 1.0
    return adj


BOND_ADJACENCY_TABLE = _bond_adjacency()
