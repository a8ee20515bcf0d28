"""Minimal end-to-end training loop on synthetic data, on the card
(counterpart of `examples/train_tiny.py`).

    python -m alphafold2_tpu_torch.scripts.train_tiny [steps] \
        [--device cuda|cpu]

`Alphafold2(dim=32, depth=2, heads=2, dim_head=16)` trains on one
synthetic batch (1 x 16 residues, 3 MSA rows, a CA trace) for `steps`
steps (20 by default): distogram and MLM losses, Adam at 1e-3 with 5
warm-up steps and cosine decay over `steps`, each step behind the
non-finite guard (`train.guard.guarded_train_step`). Prints the loss and
the skipped flag every 5 steps and at the last; returns every step's
{"loss", "skipped"}.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from alphafold2_tpu_torch.data.synthetic import synthetic_batch
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.model.alphafold2 import Alphafold2
from alphafold2_tpu_torch.train import TrainState, adam, make_train_step
from alphafold2_tpu_torch.train.guard import guarded_train_step


def build_model(device) -> Alphafold2:
    return Alphafold2(dim=32, depth=2, heads=2, dim_head=16, device=device,
                      generator=torch.Generator().manual_seed(1))


def make_batch(device):
    return synthetic_batch(np.random.default_rng(0), batch=1, seq_len=16,
                           msa_depth=3, with_coords=True, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (cpu runs the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps = args.steps

    model = build_model(device)
    batch = make_batch(device)
    state = TrainState.create(
        model, adam(1e-3, warmup_steps=5, decay_steps=steps), seed=3)
    step = guarded_train_step(make_train_step(model))
    history = []
    for i in range(steps):
        state, metrics = step(state, batch)
        history.append({"loss": float(metrics["loss"]),
                        "skipped": int(metrics["skipped"])})
        if i % 5 == 0 or i == steps - 1:
            print(f"step {i}: loss={history[-1]['loss']:.4f} "
                  f"skipped={history[-1]['skipped']}")
    return history


if __name__ == "__main__":
    main()
