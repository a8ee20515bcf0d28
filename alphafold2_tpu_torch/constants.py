"""Model-level constants the PyTorch port needs.

A copy of the slice of `alphafold2_tpu/constants.py` that the fold path
and train paths read (the port imports nothing of the JAX package, not even its
numpy-only modules). Values must stay equal to the JAX package's;
`tests/test_torch_model.py` pins that.
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
