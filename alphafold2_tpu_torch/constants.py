"""Model-level constants the PyTorch port needs.

A copy of the slice of `alphafold2_tpu/constants.py` that the fold and
train paths, the featurizer and the PDB reader and writer read (the port
imports nothing of the JAX package, not even its numpy-only modules).
Values must stay equal to the JAX package's; `tests/test_torch_model.py`
and `tests/test_torch_data.py` pin that.
"""

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
