"""Fold a PDB's sequence and score the prediction against it, on the
card (counterpart of `scripts/evaluate.py`).

    python -m alphafold2_tpu_torch.scripts.evaluate --pdb ref.pdb \
        [--config cfg.json] [--checkpoint DIR] [--recycles 3] \
        [--out pred.pdb] [--json metrics.json] [--device cuda|cpu] \
        [--mesh data,i,j | pipe,data,i,j]

The reference PDB gives the sequence and the true CA trace (the
residues whose CA is resolved are the mask). The model (the config's,
dim 64 and depth 2 without one, with coordinates) folds the sequence as
its own one-row MSA through `predict.fold`, with weights from the
newest checkpoint in `--checkpoint` (`train.CheckpointManager`, as the
training scripts write it) or seeded random ones. Prints, and with
`--json` writes, the Kabsch-aligned CA RMSD, TM-score and GDT-TS, the
mean lDDT-CA and the mean confidence over the resolved residues; with
`--out` writes the predicted CA trace as a PDB. The fold runs under the
experiment's mesh (`--mesh` overrides it), over the ranks of a
`torchrun` launch, as the JAX script folds under `use_mesh`. Returns
the metrics.
"""

from __future__ import annotations

import argparse
import json

import torch

from alphafold2_tpu_torch.config import Experiment
from alphafold2_tpu_torch.core import geometry
from alphafold2_tpu_torch.data import native
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.parallel import use_mesh
from alphafold2_tpu_torch.parallel.multihost import initialize, parse_mesh
from alphafold2_tpu_torch.predict import fold
from alphafold2_tpu_torch.train import CheckpointManager, TrainState


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pdb", required=True,
                    help="reference PDB: supplies the sequence and the "
                         "ground-truth CA trace to score against")
    ap.add_argument("--config", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--recycles", type=int, default=3)
    ap.add_argument("--out", default=None, help="write predicted CA PDB")
    ap.add_argument("--json", default=None, help="write metrics JSON")
    ap.add_argument("--mesh", default=None, help="data,i,j or pipe,data,i,j")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (cpu runs the plain path)")
    args = ap.parse_args(argv)

    if args.config:
        with open(args.config) as f:
            exp = Experiment.from_json(f.read())
    else:
        exp = Experiment()
        exp.model.dim, exp.model.depth = 64, 2
    exp.model.predict_coords = True

    with open(args.pdb) as f:
        seq_tok, coords14, atom_mask = native.parse_pdb(f.read())
    n = len(seq_tok)
    if args.mesh is not None:
        (exp.mesh.pipe, exp.mesh.data, exp.mesh.i,
         exp.mesh.j) = parse_mesh(args.mesh)
    initialize(backend="gloo" if args.device == "cpu" else None)
    device = resolve_device(args.device)
    seq = torch.as_tensor(seq_tok, device=device)[None].long()
    mask = torch.as_tensor(atom_mask[:, 1], device=device)[None]  # CA resolved
    ca_true = torch.as_tensor(coords14[:, 1], device=device)[None]

    model, tx, mesh = exp.build(device=device,
                             generator=torch.Generator().manual_seed(0))
    if args.checkpoint:
        # the config's optimizer: its state's layout must match what the
        # training script saved
        state = TrainState.create(model, tx, seed=1)
        model = CheckpointManager(args.checkpoint).restore(state).model

    with use_mesh(mesh):
        result = fold(model, seq, msa=seq[:, None], mask=mask,
                      msa_mask=mask[:, None], num_recycles=args.recycles,
                      device=device)
    pred = result.coords.float()
    valid = mask[0].float()
    count = torch.clamp(valid.sum(), min=1.0)
    metrics = {
        "n_residues": n,
        "recycles": args.recycles,
        "kabsch_rmsd": float(geometry.kabsch_rmsd(pred, ca_true,
                                                  mask=mask)[0]),
        "tm_score": float(geometry.kabsch_tm(pred, ca_true, mask=mask)[0]),
        "gdt_ts": float(geometry.kabsch_gdt(pred, ca_true, mask=mask)[0]),
        # lddt_ca is per residue; the mean over the resolved residues
        "lddt": float((geometry.lddt_ca(ca_true, pred, mask=mask)[0] *
                       valid).sum() / count),
        "mean_confidence": float((result.confidence[0].float() * valid)
                                 .sum() / count),
        "checkpoint": args.checkpoint,
    }
    print(json.dumps(metrics))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(metrics, f, indent=2)
    if args.out:
        from alphafold2_tpu_torch.data.pdb_io import coords2pdb
        coords2pdb(seq[0].cpu().numpy(), pred[0].cpu().numpy(),
                   name=args.out)
    return metrics


if __name__ == "__main__":
    main()
