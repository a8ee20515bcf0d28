"""Distogram pretraining on the card (counterpart of
`scripts/train_distogram.py`), on synthetic batches.

    python -m alphafold2_tpu_torch.scripts.train_distogram \
        [--config cfg.json] [--steps N] [--log metrics.jsonl] \
        [--device cuda|cpu]

The experiment JSON is the JAX package's (`config.Experiment`); without
one the model is dim 128, depth 2, as in the JAX script. Batches are
`data.synthetic.synthetic_batch` draws seeded by their index; the on-disk
datasets (`--data`, `--scn`, `--pdb`) are not ported (ROADMAP.md, queue
1, item 11) and a mesh (`--mesh`) is not either (item 10): each raises.
The run trains with `train.fit` (prefetch on, step timer synchronised),
prints the step-time summary, and saves a checkpoint when the experiment
names a `checkpoint_dir`. Returns the logged history.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from alphafold2_tpu_torch.config import Experiment
from alphafold2_tpu_torch.data.synthetic import synthetic_batch
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.train import CheckpointManager, TrainState, fit
from alphafold2_tpu_torch.utils import MetricsLogger, StepTimer

_ITEM = "ROADMAP.md, queue 1, item {}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--data", default=None)
    ap.add_argument("--scn", default=None)
    ap.add_argument("--pdb", nargs="+", default=None)
    ap.add_argument("--mesh", default=None, help="data,i,j or pipe,data,i,j")
    ap.add_argument("--log", default=None, help="metrics JSONL path")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (cpu runs the plain path)")
    args = ap.parse_args(argv)

    for flag in ("data", "scn", "pdb"):
        if getattr(args, flag) is not None:
            raise NotImplementedError(
                f"--{flag}: the on-disk datasets are not ported to PyTorch "
                f"yet ({_ITEM.format(11)})")
    if args.mesh is not None:
        raise NotImplementedError(f"--mesh: a device mesh is not ported to "
                                  f"PyTorch yet ({_ITEM.format(10)})")

    if args.config:
        with open(args.config) as f:
            exp = Experiment.from_json(f.read())
    else:
        exp = Experiment()
        exp.model.dim, exp.model.depth = 128, 2
    if args.steps is not None:
        exp.train.num_steps = args.steps

    device = resolve_device(args.device)
    model, tx, _ = exp.build(
        device=device,
        generator=torch.Generator().manual_seed(exp.train.seed))

    def synthetic_stream():
        i = 0
        while True:
            yield synthetic_batch(np.random.default_rng(i),
                                  batch=exp.data.batch_size,
                                  seq_len=exp.data.crop_len,
                                  msa_depth=exp.data.msa_depth)
            i += 1

    state = TrainState.create(model, tx, seed=exp.train.seed + 2)
    timer = StepTimer()
    logger = MetricsLogger(args.log)
    try:
        state, history = fit(model, state, synthetic_stream(),
                             exp.train.num_steps,
                             log_every=exp.train.log_every, logger=logger,
                             step_timer=timer)
    finally:
        logger.close()
    print("step time:", timer.summary())
    if exp.train.checkpoint_dir:
        CheckpointManager(exp.train.checkpoint_dir).save(state)
    return history


if __name__ == "__main__":
    main()
