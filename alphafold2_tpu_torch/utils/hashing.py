"""Stable content digests shared by every cache in the port (counterpart
of `alphafold2_tpu/utils/hashing.py`; a digest equals the JAX package's
byte for byte, so one on-disk store serves both packages).

`stable_digest` is blake2b over a type-tagged encoding of each part:
arrays contribute dtype + shape + raw bytes (an int32 and an int64 view
of the same values differ), scalars and strings their tag + utf-8 form,
and None is its own tag. Nested tuples/lists frame their items, so
("ab",) and ("a", "b") cannot collide. A torch tensor frames exactly as
the numpy array `.detach().cpu().numpy()` gives; bf16 has no numpy
dtype and raises TypeError, as object arrays do, so callers skip caching.
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np
import torch


def as_numpy(part: Any) -> np.ndarray:
    """`part` as a numpy array; a tensor on any device is copied to the
    host (np.asarray on a CUDA tensor raises)."""
    if isinstance(part, torch.Tensor):
        if part.dtype == torch.bfloat16:
            raise TypeError("stable_digest cannot content-hash a bfloat16 "
                            "tensor (numpy has no bfloat16 dtype)")
        return part.detach().cpu().numpy()
    return np.asarray(part)


def _feed(h, part: Any):
    if part is None:
        h.update(b"\x00N")
    elif isinstance(part, bytes):
        h.update(b"\x00B" + len(part).to_bytes(8, "little"))
        h.update(part)
    elif isinstance(part, str):
        _feed(h, part.encode("utf-8"))
        h.update(b"S")                 # distinguish str from raw bytes
    elif isinstance(part, bool):       # before int: bool is an int subclass
        h.update(b"\x00b" + (b"1" if part else b"0"))
    elif isinstance(part, (int, np.integer)):
        h.update(b"\x00i" + str(int(part)).encode())
    elif isinstance(part, (float, np.floating)):
        h.update(b"\x00f" + repr(float(part)).encode())
    elif isinstance(part, (tuple, list)):
        h.update(b"\x00T" + len(part).to_bytes(8, "little"))
        for item in part:
            _feed(h, item)
        h.update(b"t")
    else:
        # ndarray, tensor or anything array-like
        arr = as_numpy(part)
        if arr.dtype.hasobject:
            # an object array's .tobytes() is memory addresses: refuse,
            # so callers fall back to not caching
            raise TypeError(
                f"stable_digest cannot content-hash {type(part).__name__}"
                f" (object dtype); pass bytes/str/numbers/arrays or "
                f"nested tuples/lists of those")
        h.update(b"\x00A")
        _feed(h, str(arr.dtype))
        _feed(h, arr.shape)
        h.update(np.ascontiguousarray(arr).tobytes())


def stable_digest(*parts: Any, digest_size: int = 16) -> str:
    """Hex blake2b digest of `parts`, stable across processes and runs.

    Accepts None / bytes / str / bool / int / float / arrays / tensors
    and nested tuples or lists of those. Order matters; type matters
    (1 != 1.0 != "1" != np.int32(1)-as-array).
    """
    h = hashlib.blake2b(digest_size=digest_size)
    for part in parts:
        _feed(h, part)
    return h.hexdigest()
