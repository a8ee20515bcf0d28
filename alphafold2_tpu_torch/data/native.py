"""ctypes bindings for the native data loader (`native/af2data.cc`) with
pure-Python fallbacks (counterpart of `alphafold2_tpu/data/native.py`).

The native library covers the host-side hot path: a3m/FASTA MSA parsing
+ tokenization and PDB -> 14-slot coordinate extraction. `load_library()`
compiles the repo's `native/af2data.cc` with the host C++ compiler at
first use into `alphafold2_tpu_torch/_build/` (the file name carries a
hash of the source and flags; `native/` itself is never written). Every
entry point falls back to the Python implementation, which gives the
same arrays, when no compiler or library is available, as in the JAX
package; `native_available()` says which one runs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.data import featurize

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR.parent / "native" / "af2data.cc"
BUILD_DIR = PACKAGE_DIR / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None
_lib_failed = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libaf2data-{digest.hexdigest()[:16]}.so"


def _build() -> Path:
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
    subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True)
    os.replace(tmp, lib)
    return lib


def load_library(rebuild: bool = False):
    """Load (building if needed) the native parser; None on failure."""
    global _lib, _lib_failed
    if _lib is not None and not rebuild:
        return _lib
    if _lib_failed and not rebuild:
        return None
    try:
        if rebuild:
            library_path().unlink(missing_ok=True)
        lib = ctypes.CDLL(str(_build()))
        c = ctypes
        lib.msa_parse_a3m_size.restype = c.c_int
        lib.msa_parse_a3m_size.argtypes = [
            c.c_char_p, c.c_int64, c.POINTER(c.c_int64),
            c.POINTER(c.c_int64)]
        lib.msa_parse_a3m.restype = c.c_int
        lib.msa_parse_a3m.argtypes = [
            c.c_char_p, c.c_int64, c.POINTER(c.c_int8), c.c_int64, c.c_int64]
        lib.pdb_parse_size.restype = c.c_int
        lib.pdb_parse_size.argtypes = [
            c.c_char_p, c.c_int64, c.c_char, c.POINTER(c.c_int64)]
        lib.pdb_parse.restype = c.c_int
        lib.pdb_parse.argtypes = [
            c.c_char_p, c.c_int64, c.c_char, c.POINTER(c.c_int8),
            c.POINTER(c.c_float), c.POINTER(c.c_int8), c.c_int64]
        lib.tokenize_seq.restype = None
        lib.tokenize_seq.argtypes = [
            c.c_char_p, c.c_int64, c.POINTER(c.c_int8)]
        _lib = lib
        return lib
    except (OSError, subprocess.CalledProcessError):
        _lib_failed = True
        return None


def native_available() -> bool:
    return load_library() is not None


# ---------------------------------------------------------------------------
# MSA parsing
# ---------------------------------------------------------------------------


def parse_a3m(text: str) -> np.ndarray:
    """a3m/FASTA alignment text -> (rows, cols) int8 token matrix with
    insertions (lowercase, '.') removed and gaps mapped to padding."""
    lib = load_library()
    if lib is None:
        return _parse_a3m_py(text)
    raw = text.encode()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.msa_parse_a3m_size(raw, len(raw), ctypes.byref(rows),
                                ctypes.byref(cols))
    if rc != 0:
        raise ValueError(f"malformed a3m (code {rc})")
    out = np.empty((rows.value, cols.value), dtype=np.int8)
    rc = lib.msa_parse_a3m(raw, len(raw),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                           rows.value, cols.value)
    if rc != 0:
        raise ValueError(f"malformed a3m (code {rc})")
    return out


def _parse_a3m_py(text: str) -> np.ndarray:
    seqs = []
    cur = []
    started = False
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if started and cur:
                seqs.append("".join(cur))
            started = True
            cur = []
        else:
            started = True
            cur.append(line)
    if started and cur:
        seqs.append("".join(cur))
    rows = []
    width = None
    for s in seqs:
        s = "".join(c for c in s if not (c.islower() or c == "."))
        if width is None:
            width = len(s)
        elif len(s) != width:
            raise ValueError("malformed a3m (code -2)")
        rows.append(featurize.tokenize(s).astype(np.int8))
    if not rows:
        return np.zeros((0, 0), dtype=np.int8)
    return np.stack(rows)


# ---------------------------------------------------------------------------
# PDB parsing
# ---------------------------------------------------------------------------


def parse_pdb(text: str, chain: Optional[str] = None
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PDB text -> (seq tokens (L,), coords (L, 14, 3) float32,
    mask (L, 14) bool). First model; `chain` selects a chain id (default:
    first chain encountered)."""
    lib = load_library()
    if lib is None:
        return _parse_pdb_py(text, chain)
    raw = text.encode()
    ch = (chain or "\0").encode()[0]
    n_res = ctypes.c_int64()
    rc = lib.pdb_parse_size(raw, len(raw), ctypes.c_char(bytes([ch])),
                            ctypes.byref(n_res))
    if rc != 0:
        raise ValueError(f"malformed pdb (code {rc})")
    l = n_res.value
    seq = np.empty((l,), dtype=np.int8)
    coords = np.zeros((l, constants.NUM_COORDS_PER_RES, 3), dtype=np.float32)
    mask = np.zeros((l, constants.NUM_COORDS_PER_RES), dtype=np.int8)
    rc = lib.pdb_parse(raw, len(raw), ctypes.c_char(bytes([ch])),
                       seq.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                       coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       mask.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                       l)
    if rc != 0:
        raise ValueError(f"malformed pdb (code {rc})")
    return seq.astype(np.int32), coords, mask.astype(bool)


def _parse_pdb_py(text: str, chain: Optional[str] = None):
    slots = {
        constants.ONE_TO_THREE[aa]:
            {name: i for i, name in enumerate(
                constants.BACKBONE_ATOMS +
                constants.SIDECHAIN_ATOMS[constants.ONE_TO_THREE[aa]])}
        for aa in constants.ONE_TO_THREE
    }
    def atoi(s: str) -> int:
        # C atoi semantics (af2data.cc pdb_parse uses atoi on cols 23-26):
        # leading whitespace skipped, parse signed digits, 0 on garbage
        s = s.strip()
        n = 0
        while n < len(s) and (s[n].isdigit() or (n == 0 and s[n] in "+-")):
            n += 1
        try:
            return int(s[:n])
        except ValueError:
            return 0

    # residue identity is *sequential* (resseq, icode) change-detection,
    # matching the native parser (af2data.cc pdb_parse): a residue id seen
    # again after an intervening one starts a NEW residue rather than
    # merging atoms into the earlier record, so both backends produce the
    # same length/sequence on interleaved or duplicated residue records
    residues = []
    last_key = None
    active = chain
    for line in text.splitlines():
        if line.startswith("ENDMDL"):
            break
        if not line.startswith("ATOM") or len(line) < 54:
            continue
        ch = line[21]
        if active is None:
            active = ch
        if ch != active or line[16] not in (" ", "A"):
            continue
        key = (atoi(line[22:26]), line[26])
        if key != last_key:
            last_key = key
            resname = line[17:20].strip()
            residues.append({"name": resname, "atoms": {}})
        atom = line[12:16].strip()
        residues[-1]["atoms"][atom] = (
            float(line[30:38]), float(line[38:46]), float(line[46:54]))

    l = len(residues)
    k = constants.NUM_COORDS_PER_RES
    seq = np.full((l,), featurize.AA_INDEX["_"], dtype=np.int32)
    coords = np.zeros((l, k, 3), dtype=np.float32)
    mask = np.zeros((l, k), dtype=bool)
    for i, res in enumerate(residues):
        one = constants.THREE_TO_ONE.get(res["name"])
        if one is not None:
            seq[i] = featurize.AA_INDEX[one]
        slot_map = slots.get(res["name"], {})
        for atom, xyz in res["atoms"].items():
            slot = slot_map.get(atom)
            if slot is not None:
                coords[i, slot] = xyz
                mask[i, slot] = True
    return seq, coords, mask
