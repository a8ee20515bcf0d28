"""trRosetta-style dataset: (a3m MSA, PDB structure) pairs from a local
directory (counterpart of `alphafold2_tpu/data/trrosetta.py`).

Point `root` at a directory of `<id>.a3m` files, each with an `<id>.pdb`
or an `<id>.npz` holding `coords` (L, 14, 3). An item is the tokenized
MSA (its first row the sequence) and the 14-slot coordinates; parsing
goes through `data.native` (the C++ loader when it builds, else the
Python one, which gives the same arrays). Featurized items are cached as
`<id>.feat-<digest>.npz` beside the data, the digest a stable hash of
the schema tag and `max_msa_rows`: the same name and the same arrays as
the JAX package writes, so a cache written by either package loads in
the other, and a change of `max_msa_rows` misses instead of serving a
stale item. Nothing is downloaded. Batches come out of
`featurize.collate` with a fixed shape, drawn from
`np.random.default_rng(seed)` as in the JAX package, so both packages
give the same batches.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List

import numpy as np

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.data import featurize, native
from alphafold2_tpu_torch.utils.hashing import stable_digest

# the JAX package's schema tag: the cache names (and so the caches) are
# shared by both packages
_FEAT_SCHEMA = "trrosetta-feat-v1"


class TrRosettaDataset:
    """Iterable dataset over featurized samples."""

    def __init__(self, root: str, cache: bool = True,
                 max_msa_rows: int = 1000):
        self.root = root
        self.cache = cache
        self.max_msa_rows = max_msa_rows
        # everything that changes the featurized content is in the name:
        # a different config misses and refeaturizes instead of loading
        # a stale cache written under other settings
        self._cache_tag = stable_digest(
            _FEAT_SCHEMA, max_msa_rows, digest_size=4)
        self.ids = sorted(
            os.path.splitext(f)[0] for f in os.listdir(root)
            if f.endswith(".a3m"))
        if not self.ids:
            raise FileNotFoundError(f"no .a3m files under {root}")

    def __len__(self) -> int:
        return len(self.ids)

    def _cache_path(self, sample_id: str) -> str:
        return os.path.join(
            self.root, f"{sample_id}.feat-{self._cache_tag}.npz")

    def load(self, sample_id: str) -> Dict[str, np.ndarray]:
        cpath = self._cache_path(sample_id)
        if self.cache and os.path.exists(cpath):
            with np.load(cpath) as z:
                return {k: z[k] for k in z.files}

        with open(os.path.join(self.root, f"{sample_id}.a3m")) as f:
            msa = native.parse_a3m(f.read()).astype(np.int32)
        msa = msa[: self.max_msa_rows]
        sample: Dict[str, np.ndarray] = {
            "seq": msa[0].copy(), "msa": msa}

        pdb_path = os.path.join(self.root, f"{sample_id}.pdb")
        npz_path = os.path.join(self.root, f"{sample_id}.npz")
        if os.path.exists(pdb_path):
            with open(pdb_path) as f:
                _, coords, mask = native.parse_pdb(f.read())
            n = min(len(coords), msa.shape[1])
            c14 = np.zeros((msa.shape[1], constants.NUM_COORDS_PER_RES, 3),
                           np.float32)
            c14[:n] = coords[:n] * mask[:n, :, None]
            sample["coords"] = c14
        elif os.path.exists(npz_path):
            with np.load(npz_path) as z:
                if "coords" in z.files:
                    sample["coords"] = z["coords"].astype(np.float32)

        if self.cache:
            np.savez_compressed(cpath, **sample)
        return sample

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        return self.load(self.ids[idx])


class TrRosettaDataModule:
    """Batched loader producing fixed-shape numpy batches (the train
    loop moves them to its device)."""

    def __init__(
        self,
        root: str,
        crop_len: int = 128,
        batch_size: int = 1,
        max_msa_rows: int = constants.MAX_NUM_MSA,
        val_fraction: float = 0.1,
        seed: int = 0,
    ):
        self.dataset = TrRosettaDataset(root)
        self.crop_len = crop_len
        self.batch_size = batch_size
        self.max_msa_rows = max_msa_rows
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self.dataset))
        n_val = max(1, int(len(order) * val_fraction)) \
            if len(order) > 1 else 0
        self.val_ids = [self.dataset.ids[i] for i in order[:n_val]]
        self.train_ids = [self.dataset.ids[i] for i in order[n_val:]]
        self._rng = rng

    def _batches(self, ids: List[str], shuffle: bool) -> Iterator[dict]:
        while True:
            order = list(ids)
            if shuffle:
                self._rng.shuffle(order)
            # fewer samples than a batch: cycle ids so one batch always
            # comes out (a fixed batch shape)
            while 0 < len(order) < self.batch_size:
                order = order + list(ids)
            for start in range(0, len(order) - self.batch_size + 1,
                               self.batch_size):
                samples = [self.dataset.load(i)
                           for i in order[start:start + self.batch_size]]
                yield featurize.collate(samples, self.crop_len,
                                        self.max_msa_rows, self._rng)

    def train_batches(self) -> Iterator[dict]:
        return self._batches(self.train_ids, shuffle=True)

    def val_batches(self) -> Iterator[dict]:
        return self._batches(self.val_ids or self.train_ids, shuffle=False)
