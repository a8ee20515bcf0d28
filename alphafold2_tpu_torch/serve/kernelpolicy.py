"""Per-bucket attention-kernel selection for serving (counterpart of
`alphafold2_tpu/serve/kernelpolicy.py`).

Each length bucket maps to "dense" (the fused attention, K1) or
"blocksparse" (the block-skipping kernel, K2, under a static
banded+global mask). With `contact_priors`, a step-mode batch re-plans its
mask after the first pass from the distogram that pass produced
(`contact_spec_for`). The choice is part of the executor's key, so a
policy flip or a re-plan builds a new program instead of serving a stale
one.

The default cut (`sparse_live_frac` = 0.5) was chosen from TPU
measurements in the JAX package; the port keeps it as a knob until a
measurement on the card sets it.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence

import numpy as np

from alphafold2_tpu_torch.ops.block_sparse import (
    KernelSpec, contact_block_pattern, contact_probs_from_distogram)

DENSE = "dense"
BLOCKSPARSE = "blocksparse"


@dataclass
class KernelPolicy:
    """Bucket edge -> attention-kernel choice.

    table: {bucket_len: "dense" | "blocksparse"}. Buckets not in the
        table serve dense, and so does a "blocksparse" bucket that
        `block` does not divide.
    block: token block size of the sparse pattern.
    window / num_global: the static banded+global first-pass mask.
    backend: "auto" (K2 on the card, its plain version on the CPU) or
        "masked" (dense compute with the pattern as an additive mask).
    contact_priors: re-plan each step-mode batch's mask from its own
        first-pass distogram.
    contact_cutoff: contact distance (Angstrom) for P(d < cutoff).
    contact_threshold: a block stays live when its max cell contact
        probability clears this.
    contact_live_frac: alternatively keep the top fraction of blocks by
        contact score; overrides contact_threshold when set.
    dense_fallback_frac: a pattern whose live fraction is >= this serves
        dense instead (static masks too).
    """

    table: Mapping[int, str] = field(default_factory=dict)
    block: int = 128
    window: int = 1
    num_global: int = 1
    backend: str = "auto"
    contact_priors: bool = False
    contact_cutoff: float = 8.0
    contact_threshold: float = 0.5
    contact_live_frac: Optional[float] = None
    dense_fallback_frac: float = 0.95

    def __post_init__(self):
        self.table = {int(k): str(v) for k, v in dict(self.table).items()}
        for edge, kind in self.table.items():
            if kind not in (DENSE, BLOCKSPARSE):
                raise ValueError(
                    f"bucket {edge}: unknown kernel {kind!r} "
                    f"(want '{DENSE}' or '{BLOCKSPARSE}')")
        if self.block < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")
        self._specs: Dict[int, Optional[KernelSpec]] = {}

    # -- construction -----------------------------------------------------

    @classmethod
    def from_buckets(cls, edges: Sequence[int],
                     min_sparse_len: Optional[int] = None,
                     sparse_live_frac: Optional[float] = None,
                     **kw) -> "KernelPolicy":
        """Route a bucket blocksparse when its static banded+global
        pattern's live fraction is <= `sparse_live_frac` (default 0.5),
        or, with `min_sparse_len`, when the bucket is at least that
        long."""
        pol = cls(**kw)
        if sparse_live_frac is None:
            sparse_live_frac = 0.5
        table = {}
        for edge in edges:
            edge = int(edge)
            if min_sparse_len is not None:
                table[edge] = BLOCKSPARSE if edge >= min_sparse_len \
                    else DENSE
                continue
            if edge % pol.block:
                table[edge] = DENSE
                continue
            spec = KernelSpec.banded(edge, pol.block, pol.window,
                                     pol.num_global, backend=pol.backend)
            table[edge] = BLOCKSPARSE \
                if spec.live_fraction <= sparse_live_frac else DENSE
        pol.table = table
        return pol

    @classmethod
    def parse(cls, spec: str, edges: Sequence[int], block: int = 128,
              sparse_live_frac: Optional[float] = None,
              backend: str = "auto", window: int = 1,
              num_global: int = 1,
              contact_priors: bool = False) -> Optional["KernelPolicy"]:
        """"" -> None (off); "dense" / "blocksparse" -> every bucket;
        "auto" -> from_buckets; "64=dense,512=blocksparse" -> pins."""
        spec = (spec or "").strip()
        if not spec:
            return None
        kw = dict(block=block, backend=backend, window=window,
                  num_global=num_global, contact_priors=contact_priors)
        if spec == "auto":
            return cls.from_buckets(edges,
                                    sparse_live_frac=sparse_live_frac,
                                    **kw)
        if spec in (DENSE, BLOCKSPARSE):
            return cls(table={int(e): spec for e in edges}, **kw)
        table = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            edge, _, kind = part.partition("=")
            kind = kind.strip() or BLOCKSPARSE
            if kind in ("sparse", "bs"):
                kind = BLOCKSPARSE
            table[int(edge)] = kind
        return cls(table=table, **kw)

    @classmethod
    def from_model_config(cls, model_config, edges: Sequence[int],
                          **kw) -> "KernelPolicy":
        """Thread the config's sparse knobs (ModelConfig.sparse_kwargs)
        into the serving policy, so the two cannot drift."""
        sk = model_config.sparse_kwargs()
        kw.setdefault("block", sk["block"])
        kw.setdefault("num_global", sk["num_global"])
        kw.setdefault("window", sk["window"])
        return cls.from_buckets(edges, **kw)

    # -- selection --------------------------------------------------------

    def kernel_for(self, bucket_len: int) -> str:
        """"dense" | "blocksparse": what this bucket actually serves."""
        return DENSE if self.spec_for(bucket_len) is None else BLOCKSPARSE

    def spec_for(self, bucket_len: int) -> Optional[KernelSpec]:
        """The static first-pass KernelSpec for a bucket (memoized), or
        None for dense."""
        bucket_len = int(bucket_len)
        if bucket_len in self._specs:
            return self._specs[bucket_len]
        spec = None
        if self.table.get(bucket_len) == BLOCKSPARSE \
                and bucket_len % self.block == 0:
            cand = KernelSpec.banded(bucket_len, self.block, self.window,
                                     self.num_global,
                                     backend=self.backend)
            if cand.live_fraction < self.dense_fallback_frac:
                spec = cand
        self._specs[bucket_len] = spec
        return spec

    def contact_spec_for(self, bucket_len: int,
                         distogram: np.ndarray,
                         lengths=None) -> Optional[KernelSpec]:
        """Plan a contact-prior KernelSpec from first-pass distogram
        logits ((b, n, n, buckets) numpy; a caller holding a torch tensor
        passes `.float().cpu().numpy()`). None = run the remaining
        recycles dense: the bucket is not sparse-routed, or the planned
        pattern is nearly all live. `lengths` (one per batch row; 0 =
        unoccupied) plans each row's padding as dead blocks."""
        if self.spec_for(bucket_len) is None:
            return None
        contacts = contact_probs_from_distogram(
            np.asarray(distogram), cutoff=self.contact_cutoff,
            lengths=lengths)
        pattern = contact_block_pattern(
            contacts, self.block, threshold=self.contact_threshold,
            live_frac=self.contact_live_frac, window=self.window,
            num_global=self.num_global)
        if pattern.mean() >= self.dense_fallback_frac:
            return None
        return KernelSpec.from_pattern(pattern, self.block,
                                       backend=self.backend,
                                       source="contact")

    # -- views ------------------------------------------------------------

    def snapshot(self) -> dict:
        live = {}
        for edge in sorted(self.table):
            spec = self.spec_for(edge)
            live[str(edge)] = {
                "kernel": DENSE if spec is None else BLOCKSPARSE,
                "live_frac": (None if spec is None
                              else round(spec.live_fraction, 4)),
                "label": None if spec is None else spec.label,
            }
        return {"block": self.block, "window": self.window,
                "num_global": self.num_global, "backend": self.backend,
                "contact_priors": self.contact_priors,
                "buckets": live}
