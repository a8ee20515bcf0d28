"""End-to-end coordinate training on the card (counterpart of
`scripts/train_end2end.py`).

    python -m alphafold2_tpu_torch.scripts.train_end2end \
        [--config cfg.json] [--steps N] [--data DIR] \
        [--structure-module {ipa,egnn,en,se3}] [--refinement-iters N] \
        [--refinement {residue,egnn-atom}] [--reversible] \
        [--log metrics.jsonl] [--device cuda|cpu]

The experiment JSON is the JAX package's (`config.Experiment`); without
one the model is dim 128, depth 2 on 64-residue crops, as in the JAX
script. The model predicts coordinates; the flags override the config
only when given. Batches come from a trRosetta-style directory of
`.a3m` + `.pdb`/`.npz` files (`--data`, or the experiment's
`data.root`; the CA trace of the 14-slot coordinates is the target), or
else from `data.synthetic.synthetic_batch` draws with a CA trace, seeded
by their index; the loss is the coordinate loss (Kabsch RMSD and the
distogram dispersion), the confidence regression and the MLM loss
(`train.compute_loss`). `--mesh data,i,j` (or `pipe,data,i,j`) trains
on a mesh over the ranks of a `torchrun` launch, the train state placed
by `parallel.shard_pytree_tp_zero`. Runs `train.fit`, prints the
step-time summary, saves a checkpoint when the experiment
names a `checkpoint_dir`, and returns the logged history.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from alphafold2_tpu_torch.config import Experiment
from alphafold2_tpu_torch.data.synthetic import synthetic_batch
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.parallel import shard_pytree_tp_zero
from alphafold2_tpu_torch.parallel.multihost import initialize, parse_mesh
from alphafold2_tpu_torch.train import CheckpointManager, TrainState, fit
from alphafold2_tpu_torch.utils import MetricsLogger, StepTimer


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--structure-module", default=None,
                    choices=["ipa", "egnn", "en", "se3"])
    ap.add_argument("--refinement-iters", type=int, default=None)
    ap.add_argument("--refinement", default=None,
                    choices=["residue", "egnn-atom"],
                    help="what --refinement-iters refines: the CA trace "
                         "(residue) or the 14-atom covalent graph "
                         "(egnn-atom)")
    ap.add_argument("--reversible", action="store_const", const=True,
                    default=None)
    ap.add_argument("--log", default=None, help="metrics JSONL path")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (cpu runs the plain path)")
    args = ap.parse_args(argv)

    if args.config:
        with open(args.config) as f:
            exp = Experiment.from_json(f.read())
    else:
        exp = Experiment()
        exp.model.dim, exp.model.depth = 128, 2
        exp.data.crop_len = 64
    exp.model.predict_coords = True
    if args.structure_module is not None:
        exp.model.structure_module_type = args.structure_module
    if args.refinement_iters is not None:
        exp.model.structure_module_refinement_iters = args.refinement_iters
    if args.refinement is not None:
        exp.model.structure_module_refinement = args.refinement
    if args.reversible is not None:
        exp.model.reversible = args.reversible
    if args.steps is not None:
        exp.train.num_steps = args.steps
    if args.data is not None:
        exp.data.root = args.data

    if args.mesh is not None:
        (exp.mesh.pipe, exp.mesh.data, exp.mesh.i,
         exp.mesh.j) = parse_mesh(args.mesh)
    # a multi-process launch (torchrun) joins its process group first
    initialize(backend="gloo" if args.device == "cpu" else None)
    device = resolve_device(args.device)
    model, tx, mesh = exp.build(
        device=device,
        generator=torch.Generator().manual_seed(exp.train.seed))

    if exp.data.root:
        from alphafold2_tpu_torch.data.trrosetta import TrRosettaDataModule
        batches = TrRosettaDataModule(
            exp.data.root, crop_len=exp.data.crop_len,
            batch_size=exp.data.batch_size,
            max_msa_rows=exp.data.msa_depth).train_batches()
    else:
        def synthetic_stream():
            i = 0
            while True:
                yield synthetic_batch(np.random.default_rng(i),
                                      batch=exp.data.batch_size,
                                      seq_len=exp.data.crop_len,
                                      msa_depth=exp.data.msa_depth,
                                      with_coords=True)
                i += 1
        batches = synthetic_stream()

    state = TrainState.create(model, tx, seed=exp.train.seed + 2)
    if mesh is not None:
        # TP specs for the projection weights, ZeRO for the rest
        state = shard_pytree_tp_zero(state, mesh)
    timer = StepTimer()
    logger = MetricsLogger(args.log)
    try:
        state, history = fit(model, state, batches,
                             exp.train.num_steps,
                             log_every=exp.train.log_every, logger=logger,
                             step_timer=timer, mesh=mesh)
    finally:
        logger.close()
    print("step time:", timer.summary())
    if exp.train.checkpoint_dir:
        CheckpointManager(exp.train.checkpoint_dir).save(state)
    return history


if __name__ == "__main__":
    main()
