"""Host-side featurization: tokenize, MSA subsample, crop, pad, distance
targets (counterpart of `alphafold2_tpu/data/featurize.py`).

Token ids, MSA subsampling that always keeps the query row, contiguous
cropping, pad-and-mask collation, and CA/CB bucketized distance maps
(36 x 0.5 A bins from 2 A plus a far bucket) with the Gly virtual-CB
built by a Gram-Schmidt-style construction from N/CA/C.

Pure numpy on the host, as in the JAX package; outputs are fixed-shape
arrays ready for upload to the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from alphafold2_tpu_torch import constants

AA_INDEX = {aa: i for i, aa in enumerate(constants.AA_ALPHABET)}
GAP_CHARS = "-."


def tokenize(seq: str) -> np.ndarray:
    """AA string -> int tokens; gaps and unknown characters map to the
    padding token (index of '_')."""
    pad = AA_INDEX["_"]
    return np.asarray([AA_INDEX.get(c, pad) if c not in GAP_CHARS else pad
                       for c in seq.upper()], dtype=np.int32)


def detokenize(tokens: Sequence[int]) -> str:
    return "".join(constants.AA_ALPHABET[t] for t in tokens)


def subsample_msa(
    msa_tokens: np.ndarray,
    max_rows: int,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Keep the query (first) row, sample the rest uniformly."""
    rng = rng or np.random.default_rng()
    rows = msa_tokens.shape[0]
    if rows <= max_rows:
        return msa_tokens
    picked = rng.choice(np.arange(1, rows), size=max_rows - 1, replace=False)
    return np.concatenate([msa_tokens[:1], msa_tokens[np.sort(picked)]], 0)


def contiguous_crop(
    length: int,
    crop_len: int,
    rng: Optional[np.random.Generator] = None,
) -> slice:
    """Random contiguous crop window."""
    if length <= crop_len:
        return slice(0, length)
    rng = rng or np.random.default_rng()
    start = int(rng.integers(0, length - crop_len + 1))
    return slice(start, start + crop_len)


def virtual_cb(n: np.ndarray, ca: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Virtual C-beta from the backbone frame (Gram-Schmidt-style
    construction, standard trRosetta constants)."""
    b1 = ca - n
    b2 = c - ca
    b3 = np.cross(b1, b2)
    return -0.58273431 * b3 + 0.56802827 * b1 - 0.54067466 * b2 + ca


def distance_map_targets(
    coords14: np.ndarray,
    seq_tokens: np.ndarray,
    mask: np.ndarray,
    mode: str = "cb",
    num_buckets: int = 37,
    ignore_index: int = constants.IGNORE_INDEX,
) -> np.ndarray:
    """Bucketized distance targets from 14-slot coordinates: CA-CA or
    CB-CB (virtual CB for Gly / missing CB), 0.5 A bins from 2 A, last
    bucket = beyond-range.

    coords14: (L, 14, 3); seq_tokens: (L,); mask: (L,). Returns (L, L)."""
    n_at, ca, c_at = coords14[:, 0], coords14[:, 1], coords14[:, 2]
    if mode == "ca":
        points = ca
    else:
        cb = coords14[:, 4].copy()
        has_cb = (np.abs(cb).sum(-1) != 0) & \
            (seq_tokens != AA_INDEX["G"]) & (seq_tokens != AA_INDEX["_"])
        vcb = virtual_cb(n_at, ca, c_at)
        points = np.where(has_cb[:, None], cb, vcb)

    diff = points[:, None, :] - points[None, :, :]
    dist = np.sqrt((diff ** 2).sum(-1))
    boundaries = np.linspace(2.0, 20.0, num_buckets)[:-1]
    buckets = np.searchsorted(boundaries, dist, side="left")
    pair_mask = mask[:, None] & mask[None, :]
    return np.where(pair_mask, buckets, ignore_index).astype(np.int32)


def collate(
    samples: List[Dict[str, np.ndarray]],
    crop_len: int,
    max_msa_rows: int = constants.MAX_NUM_MSA,
    rng: Optional[np.random.Generator] = None,
) -> Dict[str, np.ndarray]:
    """Crop + pad a list of samples into one fixed-shape batch.

    Each sample: {"seq": (L,), "msa": (R, L) optional, "coords": (L, 14, 3)
    optional}. Output keys mirror the model's forward contract."""
    rng = rng or np.random.default_rng()
    b = len(samples)
    out: Dict[str, np.ndarray] = {
        "seq": np.zeros((b, crop_len), np.int32),
        "mask": np.zeros((b, crop_len), bool),
    }
    any_msa = any("msa" in s for s in samples)
    any_coords = any("coords" in s for s in samples)
    if any_msa:
        out["msa"] = np.zeros((b, max_msa_rows, crop_len), np.int32)
        out["msa_mask"] = np.zeros((b, max_msa_rows, crop_len), bool)
    if any_coords:
        out["coords14"] = np.zeros((b, crop_len, 14, 3), np.float32)
        out["coords"] = np.zeros((b, crop_len, 3), np.float32)
        out["dist"] = np.full((b, crop_len, crop_len), constants.IGNORE_INDEX,
                              np.int32)

    for i, s in enumerate(samples):
        length = len(s["seq"])
        window = contiguous_crop(length, crop_len, rng)
        n = window.stop - window.start
        out["seq"][i, :n] = s["seq"][window]
        out["mask"][i, :n] = True
        if "msa" in s:
            msa = subsample_msa(s["msa"], max_msa_rows, rng)[:, window]
            out["msa"][i, :msa.shape[0], :n] = msa
            out["msa_mask"][i, :msa.shape[0], :n] = True
        if "coords" in s:
            c14 = s["coords"][window]
            out["coords14"][i, :n] = c14
            out["coords"][i, :n] = c14[:, 1]  # CA track
            # residues with all-zero coordinates (unresolved, sidechainnet
            # convention) must not produce supervised distance targets
            resolved = np.abs(c14).sum((-1, -2)) != 0
            out["dist"][i, :n, :n] = distance_map_targets(
                c14, s["seq"][window], resolved)
    return out
