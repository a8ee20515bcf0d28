"""SidechainNet corpus from a local pickle (counterpart of
`alphafold2_tpu/data/sidechainnet.py`).

A sidechainnet pickle is a dict of splits ('train', 'valid-10', ...,
'test'), each a dict of parallel lists:

  {'seq': [str AA sequence],        'crd': [(L*14, 3) float array],
   'msk': [str of '+'/'-'],         'ids': [str], ...}

`load_scn_pickle` reads one from a local path (nothing is downloaded);
`corpus_from_pdb` builds a split of the same shape from PDB files (for
example `tests/data/1h22_head.pdb`), so the training path runs on real
structure data without a mounted corpus. Batches come out of
`featurize.collate`, their crops and MSA draws from
`np.random.default_rng(seed)`, so both packages give the same bytes.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.data import featurize, native

_SPLIT_KEYS = ("seq", "crd")


def load_scn_pickle(path: str) -> Dict[str, dict]:
    """Load a sidechainnet pickle; returns {split_name: split_dict} for
    every entry that looks like a data split (has seq + crd lists)."""
    with open(path, "rb") as f:
        raw = pickle.load(f)
    splits = {k: v for k, v in raw.items()
              if isinstance(v, dict) and all(x in v for x in _SPLIT_KEYS)}
    if not splits:
        raise ValueError(
            f"{path} contains no sidechainnet-format splits "
            f"(dicts with {_SPLIT_KEYS}); found keys {sorted(raw)[:10]}")
    return splits


def corpus_from_pdb(paths: Sequence[str]) -> dict:
    """PDB files -> one sidechainnet-format split dict (seq strings,
    (L*14, 3) coords, '+'/'-' masks), via the native PDB parser."""
    seqs, crds, msks, ids = [], [], [], []
    for p in paths:
        with open(p) as f:
            seq_tok, coords, mask = native.parse_pdb(f.read())
        seqs.append(featurize.detokenize(seq_tok))
        crds.append((coords * mask[:, :, None]).reshape(-1, 3)
                    .astype(np.float32))
        resolved = mask.any(-1)
        msks.append("".join("+" if r else "-" for r in resolved))
        ids.append(os.path.splitext(os.path.basename(p))[0])
    return {"seq": seqs, "crd": crds, "msk": msks, "ids": ids}


class SidechainnetDataset:
    """One split as featurize-ready samples.

    Items: {"seq": (L,) int tokens, "msa": (1, L) single-row MSA (the
    corpus has no MSAs), "coords": (L, 14, 3) with unresolved residues
    zeroed}, the contract `featurize.collate` consumes.
    """

    def __init__(self, split: dict, max_len: Optional[int] = None):
        n = len(split["seq"])
        keep = [i for i in range(n)
                if max_len is None or len(split["seq"][i]) <= max_len]
        self.seqs: List[str] = [split["seq"][i] for i in keep]
        self.crds = [np.asarray(split["crd"][i], np.float32)
                     for i in keep]
        self.msks = [split.get("msk", [None] * n)[i] for i in keep]
        self.ids = [split.get("ids", list(map(str, range(n))))[i]
                    for i in keep]

    def __len__(self) -> int:
        return len(self.seqs)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        seq = featurize.tokenize(self.seqs[idx])
        length = len(seq)
        c14 = self.crds[idx].reshape(length, constants.NUM_COORDS_PER_RES, 3)
        if self.msks[idx] is not None:
            resolved = np.asarray([c == "+" for c in self.msks[idx]])
            c14 = c14 * resolved[:, None, None]
        return {"seq": seq, "msa": seq[None].copy(), "coords": c14}


class SidechainnetDataModule:
    """Batched loader with TrRosettaDataModule's surface: fixed-shape
    numpy batches from a local sidechainnet pickle or a split dict.
    `max_len` skips proteins longer than it (250 residues by default, as
    the JAX package's)."""

    def __init__(
        self,
        path_or_splits,
        crop_len: int = 128,
        batch_size: int = 1,
        max_msa_rows: int = 1,
        max_len: Optional[int] = 250,
        train_split: str = "train",
        val_split: Optional[str] = None,
        seed: int = 0,
    ):
        splits = load_scn_pickle(path_or_splits) \
            if isinstance(path_or_splits, str) else dict(path_or_splits)
        if train_split not in splits:
            # demo corpora (corpus_from_pdb) are a bare split dict
            splits = {"train": splits} if all(
                k in splits for k in _SPLIT_KEYS) else splits
        if train_split not in splits:
            raise KeyError(f"split {train_split!r} not in "
                           f"{sorted(splits)}")
        self.train_ds = SidechainnetDataset(splits[train_split], max_len)
        if not len(self.train_ds):
            raise ValueError(f"split {train_split!r} has no proteins "
                             f"<= {max_len} residues")
        if val_split is not None and val_split not in splits:
            # an explicitly requested split must exist — silently serving
            # train data as "validation" hides the mistake
            raise KeyError(f"val_split {val_split!r} not in "
                           f"{sorted(splits)}")
        val = val_split or next(
            (k for k in sorted(splits) if k.startswith("valid")), None)
        self.val_ds = SidechainnetDataset(splits[val], max_len) \
            if val in splits else None
        if self.val_ds is not None and not len(self.val_ds):
            # post-filter emptiness: a val split whose proteins all
            # exceed max_len must fall back (an empty dataset would spin
            # _batches forever without yielding)
            self.val_ds = None
        self.crop_len = crop_len
        self.batch_size = batch_size
        self.max_msa_rows = max_msa_rows
        self._rng = np.random.default_rng(seed)

    def _batches(self, ds: SidechainnetDataset,
                 shuffle: bool) -> Iterator[dict]:
        while True:
            order = list(range(len(ds)))
            if shuffle:
                self._rng.shuffle(order)
            while 0 < len(order) < self.batch_size:
                order = order + order  # cycle; one fixed-shape batch min
            for start in range(0, len(order) - self.batch_size + 1,
                               self.batch_size):
                samples = [ds[i]
                           for i in order[start:start + self.batch_size]]
                yield featurize.collate(samples, self.crop_len,
                                        self.max_msa_rows, self._rng)

    def train_batches(self) -> Iterator[dict]:
        return self._batches(self.train_ds, shuffle=True)

    def val_batches(self) -> Iterator[dict]:
        return self._batches(self.val_ds or self.train_ds, shuffle=False)
