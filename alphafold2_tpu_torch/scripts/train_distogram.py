"""Distogram pretraining on the card (counterpart of
`scripts/train_distogram.py`).

    python -m alphafold2_tpu_torch.scripts.train_distogram \
        [--config cfg.json] [--steps N] \
        [--data DIR | --scn FILE.pkl | --pdb FILE...] \
        [--log metrics.jsonl] [--device cuda|cpu]

The experiment JSON is the JAX package's (`config.Experiment`); without
one the model is dim 128, depth 2, as in the JAX script. Batches come
from a local sidechainnet pickle (`--scn`), from PDB files as a
sidechainnet-format corpus (`--pdb`), from a trRosetta-style directory
of `.a3m` + `.pdb`/`.npz` files (`--data`, or the experiment's
`data.root`), or else from `data.synthetic.synthetic_batch` draws seeded
by their index. `--mesh data,i,j` (or `pipe,data,i,j`) trains on a
mesh over the ranks of a `torchrun` launch (NCCL; gloo with
`--device cpu`), with the train state placed by
`parallel.shard_pytree_tp_zero`. The run trains with `train.fit`
(prefetch on, step timer synchronised), prints the step-time summary,
and saves a checkpoint when the experiment names a `checkpoint_dir`.
Returns the logged history.
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
    ap.add_argument("--scn", default=None,
                    help="local sidechainnet pickle")
    ap.add_argument("--pdb", nargs="+", default=None,
                    help="PDB file(s) as a real-structure corpus")
    ap.add_argument("--mesh", default=None, help="data,i,j or pipe,data,i,j")
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

    if args.scn or args.pdb:
        from alphafold2_tpu_torch.data.sidechainnet import (
            SidechainnetDataModule, corpus_from_pdb)
        source = args.scn if args.scn else corpus_from_pdb(args.pdb)
        batches = SidechainnetDataModule(
            source, crop_len=exp.data.crop_len,
            batch_size=exp.data.batch_size,
            max_msa_rows=exp.data.msa_depth).train_batches()
    elif exp.data.root:
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
                                      msa_depth=exp.data.msa_depth)
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
