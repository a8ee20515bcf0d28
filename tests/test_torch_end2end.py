"""The port's two README-era entry points held against the JAX
package's on the CPU: `scripts/train_end2end.py` (its first step's loss
against the JAX `compute_loss` at the same weights, batch and MLM
noise) and `scripts/evaluate.py` (the metrics JSON of a fold of
`tests/data/1h22_head.pdb` against the JAX script's at the same
weights).

Tiny fp32 models (dim 16, depth 1, heads 2, dim_head 8); the JAX params
are drawn on the init's shapes with numpy and bridged with
`load_jax_params`: into the port's model right after the script builds
it (train_end2end), or through a port checkpoint the script restores
with `--checkpoint` (evaluate), while the JAX script's `init` returns
them. Tolerances: the loss within 1e-5 relative (as the train steps of
`test_torch_train.py`); the evaluation's metrics within 1e-3 absolute
(RMSD in A over coordinates of O(10) A after recycling; TM, GDT, lDDT
and confidence are in [0, 1]).
"""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import config as jax_config
from alphafold2_tpu import predict as jax_predict
from alphafold2_tpu.core import geometry as jgeo
from alphafold2_tpu.model import alphafold2 as jax_af2
from alphafold2_tpu.model import mlm as jax_mlm
from alphafold2_tpu.train import loop as jax_loop
from alphafold2_tpu_torch import config as pt_config
from alphafold2_tpu_torch.data.synthetic import synthetic_batch
from alphafold2_tpu_torch.model import mlm as pt_mlm
from alphafold2_tpu_torch.scripts import evaluate as pt_evaluate
from alphafold2_tpu_torch.scripts import train_end2end as pt_train
from alphafold2_tpu_torch.train import CheckpointManager, TrainState
from alphafold2_tpu_torch.weights import load_jax_params
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)
from test_torch_serve import random_params
from test_torch_train import kabsch_broadcast_flip

REPO = Path(__file__).resolve().parent.parent
PDB = REPO / "tests" / "data" / "1h22_head.pdb"
TINY = dict(dim=16, depth=1, heads=2, dim_head=8, structure_module_depth=1,
            extra_msa_evoformer_layers=1, bfloat16=False)


def write_config(tmp_path, model, data=None, train=None):
    path = tmp_path / "exp.json"
    path.write_text(json.dumps({"model": model, "data": data or {},
                                "train": train or {}}))
    return str(path)


def jax_params(jm, seq, msa, mask, msa_mask, seed, train=False):
    shapes = jax.eval_shape(lambda k: jm.init(
        {"params": k, "mlm": k}, seq, msa=msa, mask=mask,
        msa_mask=msa_mask, train=train), jax.random.PRNGKey(0))
    return random_params(shapes, np.random.default_rng(seed))


def run_quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def test_train_end2end_matches_jax(tmp_path, monkeypatch):
    """Two steps of the egnn structure module (BASELINE config 3's path,
    cut to a tiny width): finite losses, and the first equals the JAX
    loss at the bridged weights on the same batch and MLM noise."""
    model = dict(TINY, structure_module_type="egnn", predict_coords=True)
    data = dict(crop_len=12, msa_depth=3, batch_size=1)
    cfg = write_config(tmp_path, model, data,
                       dict(num_steps=2, log_every=1))
    batch = {k: v.numpy() for k, v in synthetic_batch(
        np.random.default_rng(0), seq_len=12, msa_depth=3).items()}

    jm = jax_config.ModelConfig(**model).build()
    params = jax_params(jm, batch["seq"], batch["msa"], batch["mask"],
                        batch["msa_mask"], seed=1, train=True)
    noised, replaced = (np.array(a) for a in jax_mlm.MLM(
        dim=16, num_tokens=21, mask_id=21).apply(
            {}, jax.random.PRNGKey(2), batch["msa"], batch["msa_mask"],
            method=jax_mlm.MLM.noise))
    with monkeypatch.context() as mp:
        mp.setattr(jax_mlm.MLM, "noise",
                   lambda self, rng, seq, mask: (jnp.asarray(noised),
                                                 jnp.asarray(replaced)))
        mp.setattr(jgeo, "kabsch", kabsch_broadcast_flip)
        ref, _ = jax.jit(lambda p: jax_loop.compute_loss(
            jm, p, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(3), train=True))(params)

    build = pt_config.Experiment.build

    def bridged_build(self, *args, **kwargs):
        model, tx, mesh = build(self, *args, **kwargs)
        load_jax_params(model, params)
        return model, tx, mesh

    monkeypatch.setattr(pt_config.Experiment, "build", bridged_build)
    monkeypatch.setattr(pt_mlm.MLM, "noise",
                        lambda self, seq, mask, generator=None:
                        (torch.as_tensor(noised, device=seq.device),
                         torch.as_tensor(replaced, device=seq.device)))
    history = run_quiet(pt_train.main, ["--config", cfg, "--device", "cpu",
                                        "--structure-module", "egnn"])
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
    assert {"coords_loss", "confidence_loss", "mlm_loss"} <= set(history[0])
    assert abs(history[0]["loss"] - float(ref)) <= 1e-5 * abs(float(ref))


def test_train_end2end_flags_and_refusals(tmp_path):
    """BASELINE config 4's flags (se3, refinement, reversible) train
    finite on the CPU at a tiny width; an empty --data directory raises;
    a one-device --mesh trains as no mesh, and a mesh larger than the
    process group raises JAX's error; without --device it needs a
    card."""
    cfg = write_config(tmp_path, TINY, dict(crop_len=10, msa_depth=2),
                       dict(num_steps=2, log_every=1))
    history = run_quiet(pt_train.main, [
        "--config", cfg, "--device", "cpu", "--structure-module", "se3",
        "--refinement-iters", "2", "--refinement", "residue",
        "--reversible"])
    assert len(history) == 2 and all(np.isfinite(h["loss"])
                                     for h in history)
    # --data runs (tests/test_torch_datasets.py); a directory without
    # .a3m files raises as in the JAX package
    with pytest.raises(FileNotFoundError, match="no .a3m files"):
        pt_train.main(["--config", cfg, "--data", str(tmp_path),
                       "--device", "cpu"])
    meshed = run_quiet(pt_train.main, ["--config", cfg, "--device", "cpu",
                                       "--mesh", "1,1,1"])
    assert len(meshed) == 2 and all(np.isfinite(h["loss"]) for h in meshed)
    with pytest.raises(ValueError, match="#devices"):
        pt_train.main(["--config", cfg, "--device", "cpu", "--mesh",
                       "2,1,1"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_quiet(pt_train.main, ["--config", cfg])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_quiet(pt_evaluate.main, ["--pdb", str(PDB)])


def load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_scripts_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_evaluate_matches_jax(tmp_path, monkeypatch):
    """The same metrics JSON (keys and values) as the JAX script at the
    same weights, one recycle; the predicted PDB reads back."""
    from alphafold2_tpu_torch.data import native

    model = dict(TINY, predict_coords=True)
    cfg = write_config(tmp_path, model)
    seq_tok, _, atom_mask = native.parse_pdb(PDB.read_text())
    seq = seq_tok[None].astype(np.int32)
    mask = atom_mask[None, :, 1]
    jm = jax_config.ModelConfig(**model).build()
    params = jax_params(jm, seq, seq[:, None], mask, mask[:, None], seed=4)

    ckpt = tmp_path / "ckpt"
    pm, tx, _ = pt_config.Experiment.from_json(
        Path(cfg).read_text()).build(device="cpu")
    load_jax_params(pm, params)
    CheckpointManager(str(ckpt)).save(TrainState.create(pm, tx))

    monkeypatch.setattr(jax_af2.Alphafold2, "init",
                        lambda self, *a, **k: params)
    # the JAX script folds eagerly; jitted, the reference costs seconds
    # instead of tens of seconds
    monkeypatch.setattr(jax_predict, "fold", jax.jit(
        jax_predict.fold, static_argnums=(0,),
        static_argnames=("num_recycles",)))
    ref_json, out_json = tmp_path / "jax.json", tmp_path / "port.json"
    ref = run_quiet(load_jax_script("evaluate").main, [
        "--pdb", str(PDB), "--config", cfg, "--recycles", "1",
        "--json", str(ref_json)])
    out = run_quiet(pt_evaluate.main, [
        "--pdb", str(PDB), "--config", cfg, "--recycles", "1",
        "--checkpoint", str(ckpt), "--device", "cpu",
        "--json", str(out_json), "--out", str(tmp_path / "pred.pdb")])
    ref_keys = json.loads(ref_json.read_text()).keys()
    assert json.loads(out_json.read_text()).keys() == ref_keys
    for key in ref_keys:
        if key == "checkpoint":
            assert ref[key] is None and out[key] == str(ckpt)
        elif isinstance(ref[key], int):
            assert out[key] == ref[key], key
        else:
            assert abs(out[key] - ref[key]) <= 1e-3, (key, out[key],
                                                      ref[key])
    _, coords, back_mask = native.parse_pdb(
        (tmp_path / "pred.pdb").read_text())
    assert back_mask[:, 1].all() and coords.shape[0] == seq.shape[1]
