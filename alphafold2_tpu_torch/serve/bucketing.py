"""Length-bucket policy: map ragged requests onto a closed set of shapes
(counterpart of `alphafold2_tpu/serve/bucketing.py:31-143`).

The server quantizes sequence length to a small set of bucket edges
(powers of two by default), so each bucket presents one shape and the
executor holds one program per shape. `assemble()` pads a list of
same-bucket requests into one fixed-shape batch of torch tensors on the
device asked for (the card unless the caller names another), padding the
batch axis too; `msa_depth` pins the MSA axis.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.serve.request import FoldRequest


class BucketPolicy:
    """Sorted ascending bucket edges; a request of length n maps to the
    smallest edge >= n."""

    def __init__(self, edges: Sequence[int]):
        edges = sorted(set(int(e) for e in edges))
        if not edges or edges[0] <= 0:
            raise ValueError(f"bucket edges must be positive, got {edges}")
        self.edges: Tuple[int, ...] = tuple(edges)

    @classmethod
    def powers_of_two(cls, min_len: int = 32,
                      max_len: int = 512) -> "BucketPolicy":
        edges = []
        e = 1
        while e < max_len:
            e *= 2
            if e >= min_len:
                edges.append(min(e, max_len))
        if max_len not in edges:
            edges.append(max_len)
        return cls(edges)

    @property
    def num_buckets(self) -> int:
        return len(self.edges)

    @property
    def max_len(self) -> int:
        return self.edges[-1]

    def bucket_for(self, length: int) -> int:
        """Deterministic: same length always lands on the same edge."""
        if length <= 0:
            raise ValueError(f"length must be positive, got {length}")
        for e in self.edges:
            if length <= e:
                return e
        raise ValueError(
            f"length {length} exceeds max bucket {self.edges[-1]}; "
            "add a larger edge or reject upstream")

    def assemble(
        self,
        requests: List[FoldRequest],
        bucket_len: int,
        batch_size: int,
        msa_depth: Optional[int] = None,
        device=None,
    ) -> Tuple[dict, float]:
        """Pad `requests` (all <= bucket_len) into one fixed-shape batch.

        Returns (batch, padding_waste): batch has seq (B, L) int64, mask
        (B, L) bool and msa/msa_mask (B, M, L) (None without an MSA), on
        `device`; padding_waste is the padding share of the (B, L) token
        grid (batch-fill rows count as waste). msa_depth=None takes the
        deepest request's MSA; a pinned depth zero-pads shallower MSAs
        and keeps the first msa_depth rows of deeper ones; msa_depth=0
        forces the MSA-free signature."""
        if not requests:
            raise ValueError("assemble() needs at least one request")
        if len(requests) > batch_size:
            raise ValueError(
                f"{len(requests)} requests > batch_size {batch_size}")
        lengths = [r.length for r in requests]
        if max(lengths) > bucket_len:
            raise ValueError(
                f"request length {max(lengths)} > bucket_len {bucket_len}")
        device = resolve_device(device)

        def put(a):
            return torch.as_tensor(a, device=device)

        seq = np.zeros((batch_size, bucket_len), np.int64)
        mask = np.zeros((batch_size, bucket_len), bool)
        for i, r in enumerate(requests):
            seq[i, : r.length] = r.seq
            mask[i, : r.length] = True
        batch = {"seq": put(seq), "mask": put(mask),
                 "msa": None, "msa_mask": None}

        depth = msa_depth
        if depth is None:
            depths = [r.msa.shape[0] for r in requests
                      if r.msa is not None]
            depth = max(depths) if depths else 0
        if depth > 0:
            msa = np.zeros((batch_size, depth, bucket_len), np.int64)
            msa_mask = np.zeros((batch_size, depth, bucket_len), bool)
            for i, r in enumerate(requests):
                if r.msa is not None:
                    m = min(r.msa.shape[0], depth)
                    n = r.msa.shape[1]
                    msa[i, :m, :n] = r.msa[:m]
                    msa_mask[i, :m, :n] = True
            batch["msa"] = put(msa)
            batch["msa_mask"] = put(msa_mask)

        real = sum(lengths)
        waste = 1.0 - real / float(batch_size * bucket_len)
        return batch, waste


def msa_depth_of(batch: dict) -> int:
    """Shape-key helper: 0 when the batch carries no MSA."""
    return 0 if batch.get("msa") is None else int(batch["msa"].shape[1])


def default_policy(max_len: Optional[int] = None) -> BucketPolicy:
    """The serving default: powers of two from 32 up to max_len (512)."""
    return BucketPolicy.powers_of_two(32, max_len or 512)
