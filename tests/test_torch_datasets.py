"""The port's on-disk datasets against the JAX package's, and the
training scripts' dataset flags, on the CPU.

- trRosetta: the featurized cache file (`<id>.feat-<digest>.npz`) has
  the same name in both packages, and a cache written by either loads in
  the other with equal arrays; `TrRosettaDataModule` batches are equal.
- SidechainNet: `corpus_from_pdb` gives the same split, and
  `SidechainnetDataModule` batches from a pickle are byte-equal (crops
  and MSA draws from `np.random.default_rng(seed)` on both sides).
- `train_distogram --data / --scn / --pdb` and `train_end2end --data`
  take one step of a tiny block-sparse menu model on the CPU with finite
  losses.

Inputs: `tests/data/1h22_head.pdb` (72 residues), an `.a3m` of it the
tests write, and a miniature sidechainnet pickle. Everything compares
exactly (integer tokens, and float arrays read from the same parse).
"""

import contextlib
import io
import json
import os
import pickle
import shutil

import numpy as np
import pytest

from alphafold2_tpu.data import sidechainnet as jax_scn
from alphafold2_tpu.data import trrosetta as jax_tr
from alphafold2_tpu_torch.data import sidechainnet as pt_scn
from alphafold2_tpu_torch.data import trrosetta as pt_tr
from test_sidechainnet import _fake_scn_pickle
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)

PDB = os.path.join(os.path.dirname(__file__), "data", "1h22_head.pdb")


def write_sample(root, sample_id="1h22", rows=4, seed=0):
    """`<id>.a3m` (the PDB's sequence, then gapped and lower-case-inserted
    rows) and `<id>.pdb` under `root`."""
    from alphafold2_tpu_torch.data import featurize, native

    with open(PDB) as f:
        text = f.read()
    seq = featurize.detokenize(native.parse_pdb(text)[0])
    rng = np.random.default_rng(seed)
    lines = [seq]
    for _ in range(rows - 1):
        row = "".join("-" if rng.random() < 0.2 else c for c in seq)
        lines.append(row[:10] + "kl" + row[10:])      # an insertion
    root.mkdir(parents=True, exist_ok=True)
    (root / f"{sample_id}.a3m").write_text(
        "".join(f">r{i}\n{r}\n" for i, r in enumerate(lines)))
    shutil.copy(PDB, root / f"{sample_id}.pdb")
    return root


def equal_dicts(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_trrosetta_cache_crosses_packages(tmp_path, writer):
    """One package featurizes and writes the cache; the other finds it
    under the same name, loads it without re-featurizing, and reads the
    same arrays; the two data modules' batches are equal."""
    root = write_sample(tmp_path / "data")
    first, second = (pt_tr, jax_tr) if writer == "port" else (jax_tr, pt_tr)
    written = first.TrRosettaDataset(str(root)).load("1h22")
    names = [f for f in os.listdir(root) if ".feat-" in f]
    assert len(names) == 1
    assert names[0] == os.path.basename(
        second.TrRosettaDataset(str(root))._cache_path("1h22"))
    path = root / names[0]
    stamp = path.stat().st_mtime_ns
    read = second.TrRosettaDataset(str(root)).load("1h22")
    assert path.stat().st_mtime_ns == stamp       # loaded, not rewritten
    equal_dicts(written, read)
    assert written["msa"].shape == (4, 72) and written["coords"].shape == \
        (72, 14, 3)
    # a different featurize config misses under another name
    other = pt_tr.TrRosettaDataset(str(root), max_msa_rows=2)
    assert other._cache_path("1h22") != str(path)
    batches = [m.TrRosettaDataModule(str(root), crop_len=48, batch_size=2,
                                     max_msa_rows=3, seed=5).train_batches()
               for m in (jax_tr, pt_tr)]
    for _ in range(2):
        equal_dicts(next(batches[0]), next(batches[1]))


def test_trrosetta_npz_coords_and_empty_root(tmp_path):
    root = write_sample(tmp_path / "data")
    os.remove(root / "1h22.pdb")
    coords = np.random.default_rng(1).normal(size=(72, 14, 3)).astype(
        np.float32)
    np.savez(root / "1h22.npz", coords=coords)
    for mod in (pt_tr, jax_tr):
        got = mod.TrRosettaDataset(str(root), cache=False).load("1h22")
        np.testing.assert_array_equal(got["coords"], coords)
    (tmp_path / "empty").mkdir()
    for mod in (pt_tr, jax_tr):
        with pytest.raises(FileNotFoundError, match="no .a3m files"):
            mod.TrRosettaDataset(str(tmp_path / "empty"))


def test_sidechainnet_batches_are_byte_equal(tmp_path):
    path = str(tmp_path / "scn.pkl")
    _fake_scn_pickle(path)
    assert jax_scn.load_scn_pickle(path).keys() == \
        pt_scn.load_scn_pickle(path).keys()
    kw = dict(crop_len=32, batch_size=2, max_msa_rows=2, max_len=50, seed=3)
    modules = [m.SidechainnetDataModule(path, **kw)
               for m in (jax_scn, pt_scn)]
    assert len(modules[1].train_ds) == 2          # the 60-residue one is out
    for stream in ("train_batches", "val_batches"):
        a, b = (getattr(m, stream)() for m in modules)
        for _ in range(3):
            equal_dicts(next(a), next(b))
    corpus = [m.corpus_from_pdb([PDB]) for m in (jax_scn, pt_scn)]
    assert corpus[0]["seq"] == corpus[1]["seq"] and \
        corpus[0]["msk"] == corpus[1]["msk"] and corpus[0]["ids"] == ["1h22_head"]
    np.testing.assert_array_equal(corpus[0]["crd"][0], corpus[1]["crd"][0])
    for m in (jax_scn, pt_scn):
        with pytest.raises(KeyError, match="val_split"):
            m.SidechainnetDataModule(path, val_split="valid-90")
    bad = tmp_path / "bad.pkl"
    bad.write_bytes(pickle.dumps({"settings": {}}))
    with pytest.raises(ValueError, match="no sidechainnet-format splits"):
        pt_scn.load_scn_pickle(str(bad))


MENU_MODEL = dict(dim=16, depth=2, heads=2, dim_head=8, bfloat16=False,
                  sparse_self_attn=[True, False], sparse_block=8,
                  structure_module_depth=1, extra_msa_evoformer_layers=1)


@pytest.mark.parametrize("flag", ["data", "scn", "pdb", "end2end_data"])
def test_scripts_train_from_disk(tmp_path, flag):
    from alphafold2_tpu_torch.scripts import train_distogram, train_end2end

    root = write_sample(tmp_path / "data")
    cfg = tmp_path / "exp.json"
    cfg.write_text(json.dumps({
        "model": MENU_MODEL, "data": {"crop_len": 32, "msa_depth": 3},
        "train": {"num_steps": 1, "log_every": 1}}))
    argv = ["--config", str(cfg), "--device", "cpu"]
    if flag == "scn":
        path = tmp_path / "scn.pkl"
        path.write_bytes(pickle.dumps(
            {"train": pt_scn.corpus_from_pdb([PDB])}))
        argv += ["--scn", str(path)]
    elif flag == "pdb":
        argv += ["--pdb", PDB]
    else:
        argv += ["--data", str(root)]
    main = train_end2end.main if flag == "end2end_data" else \
        train_distogram.main
    with contextlib.redirect_stdout(io.StringIO()):
        history = main(argv)
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    if flag == "end2end_data":
        assert "coords_loss" in history[0]
    if flag in ("data", "end2end_data"):
        assert any(".feat-" in f for f in os.listdir(root))
