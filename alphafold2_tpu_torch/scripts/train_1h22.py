"""1H22 memorization demo on the card (counterpart of
`examples/train_1h22.py`): show that the structure path learns.

    python -m alphafold2_tpu_torch.scripts.train_1h22 [--steps 3000] \
        [--log-every 50] [--eval-every 250] [--lr 1e-3] \
        [--target-rmsd 1.0] [--train-recycles 0] [--out-dir DIR] \
        [--device cuda|cpu]

Trains `Alphafold2(dim=64, depth=2, heads=4, dim_head=16,
predict_coords=True, structure_module_depth=2)` in fp32 on the full 72
residues of `tests/data/1h22_head.pdb` (the sequence as its own one-row
MSA, the resolved CA trace as the target) with Adam at `--lr`. With
`--train-recycles N > 0` each step draws r ~ U{0..N} recycles
(`train.make_recycled_train_step`), else it trains without recycling
(`train.make_train_step`). Every `--eval-every` steps (and at the last)
it folds at the matched recycle count (`predict.fold`) and stops early
once the Kabsch RMSD is below `--target-rmsd`. It then saves the train
state (`train.CheckpointManager`) and scores the matched fold (the
headline), the other recycle count (3 for 0, 0 otherwise) and a fold of
a randomly initialised model: Kabsch RMSD, TM-score, GDT-TS, mean lDDT
of the CA trace, mean confidence, and the Pearson correlation and mean
absolute difference of the confidence against the per-residue lDDT
(None where either side is near-constant). An overfit fixture should
reach Kabsch RMSD < 2 A.

Writes `<out-dir>/eval_1h22_metrics.json`, the log
`<out-dir>/train_1h22_full_log.jsonl` and the checkpoint
`<out-dir>/ckpt_1h22_full/`, with the JAX runner's keys. The weights
come from seeded `torch.Generator`s (0 for the trained model, 42 for the
random-init contrast, 2 for the train state's draws). Returns the
metrics.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from alphafold2_tpu_torch.core import geometry
from alphafold2_tpu_torch.data import native
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.model.alphafold2 import Alphafold2
from alphafold2_tpu_torch.predict import fold
from alphafold2_tpu_torch.train import (CheckpointManager, TrainState, adam,
                                        make_recycled_train_step,
                                        make_train_step)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PDB = os.path.join(REPO, "tests", "data", "1h22_head.pdb")
# git-ignored, so a run never writes over the JAX runner's committed
# artifacts in examples/
DEFAULT_OUT_DIR = os.path.join(REPO, "runs", "train_1h22")
CONFIG = {"dim": 64, "depth": 2, "heads": 4, "dim_head": 16,
          "structure_module_depth": 2}


def build_model(device, seed: int) -> Alphafold2:
    return Alphafold2(**CONFIG, predict_coords=True, dtype=torch.float32,
                      device=device,
                      generator=torch.Generator().manual_seed(seed))


def _metrics(pred, ca_true, mask, confidence):
    """The JAX runner's scores of one fold (batch row 0): Kabsch RMSD,
    TM, GDT-TS, the mean per-residue lDDT and confidence over the
    resolved residues, and the confidence's Pearson correlation and mean
    absolute difference against that lDDT."""
    pred, ca_true = pred.float(), ca_true.float()
    per_res_lddt = geometry.lddt_ca(ca_true, pred, mask=mask)[0]
    m = mask[0].bool().cpu().numpy()
    conf = confidence[0].float().cpu().numpy()[m]
    real = per_res_lddt.cpu().numpy()[m]
    if conf.std() > 1e-6 and real.std() > 1e-6:
        pearson = float(np.corrcoef(conf, real)[0, 1])
    else:  # memorized fixture: both near-constant; correlation undefined
        pearson = None
    return {
        "kabsch_rmsd": float(geometry.kabsch_rmsd(pred, ca_true,
                                                  mask=mask)[0]),
        "tm_score": float(geometry.kabsch_tm(pred, ca_true, mask=mask)[0]),
        "gdt_ts": float(geometry.kabsch_gdt(pred, ca_true, mask=mask)[0]),
        "lddt": float(real.mean()),
        "mean_confidence": float(conf.mean()),
        "confidence_lddt_pearson": pearson,
        "confidence_lddt_mae": float(np.abs(conf - real).mean()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--log-every", type=int, default=50)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--target-rmsd", type=float, default=1.0,
                    help="early-stop once the protocol-matched eval RMSD "
                         "(at --train-recycles recycles) drops below this")
    ap.add_argument("--train-recycles", type=int, default=0,
                    help=">0: train with sampled recycling "
                         "(train.make_recycled_train_step) so eval at "
                         "recycles<=N is a trained configuration")
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (cpu runs the plain path)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out_dir, exist_ok=True)

    with open(PDB) as f:
        seq_tok, coords14, atom_mask = native.parse_pdb(f.read())
    n = len(seq_tok)
    seq = torch.as_tensor(seq_tok, device=device)[None].long()
    mask = torch.as_tensor(atom_mask[:, 1], device=device)[None]  # CA
    ca_true = torch.as_tensor(coords14[:, 1], device=device)[None]
    batch = {"seq": seq, "msa": seq[:, None], "mask": mask,
             "msa_mask": mask[:, None], "coords": ca_true}

    model = build_model(device, seed=0)
    state = TrainState.create(model, adam(args.lr), seed=2)
    step = make_recycled_train_step(model, args.train_recycles) \
        if args.train_recycles > 0 else make_train_step(model)
    eval_recycles = args.train_recycles  # 0 -> protocol-aligned @0rec

    def run_fold(net, recycles):
        return fold(net, seq, msa=batch["msa"], mask=mask,
                    msa_mask=batch["msa_mask"], num_recycles=recycles,
                    device=device)

    log_path = os.path.join(args.out_dir, "train_1h22_full_log.jsonl")
    ckpt_dir = os.path.join(args.out_dir, "ckpt_1h22_full")
    t0 = time.time()
    with open(log_path, "w") as log:
        for i in range(args.steps):
            state, metrics = step(state, batch)
            if i % args.log_every == 0 or i == args.steps - 1:
                row = {k: round(float(metrics[k]), 4)
                       for k in sorted(metrics)}
                row["step"] = i
                row["elapsed_s"] = round(time.time() - t0, 1)
                log.write(json.dumps(row) + "\n")
                log.flush()
                print(row, flush=True)
            if (i and i % args.eval_every == 0) or i == args.steps - 1:
                res = run_fold(state.model, eval_recycles)
                rmsd = float(geometry.kabsch_rmsd(res.coords, ca_true,
                                                  mask=mask)[0])
                print({"step": i, "eval_rmsd": round(rmsd, 3)},
                      flush=True)
                log.write(json.dumps({"step": i,
                                      "eval_rmsd": round(rmsd, 3)})
                          + "\n")
                log.flush()
                if rmsd < args.target_rmsd:
                    print(f"early stop at step {i}: rmsd {rmsd:.3f}")
                    break

    CheckpointManager(ckpt_dir).save(state)

    # ---- final scoring: protocol-matched headline + the other row
    res0 = run_fold(state.model, eval_recycles)
    other_recycles = 3 if eval_recycles == 0 else 0
    res3 = run_fold(state.model, other_recycles)
    # random-init contrast, same fold path
    res_rnd = run_fold(build_model(device, seed=42), eval_recycles)

    out = {
        "n_residues": n,
        "protocol": ("train full-length with sampled recycling 0..%d; "
                     "headline eval @%d recycles (matched)" %
                     (args.train_recycles, args.train_recycles))
        if args.train_recycles else
        "train full-length @0 recycles; headline eval @0 recycles "
        "(matched); recycles_3 row is the UNtrained-recycling contrast",
        "train_steps": int(state.step),
        "headline": _metrics(res0.coords, ca_true, mask, res0.confidence),
        ("recycles_3" if eval_recycles == 0 else "recycles_0"):
            _metrics(res3.coords, ca_true, mask, res3.confidence),
        "random_init_baseline": _metrics(res_rnd.coords, ca_true, mask,
                                         res_rnd.confidence),
        "checkpoint": ckpt_dir,
        "log": log_path,
        "train_recycles": args.train_recycles,
        "config": {**CONFIG, "dtype": "float32", "lr": args.lr,
                   "full_length": n, "msa_depth": 1},
    }
    path = os.path.join(args.out_dir, "eval_1h22_metrics.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
