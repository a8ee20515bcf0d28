"""Fold a synthetic sequence end to end and write a PDB (counterpart of
`examples/fold_synthetic.py`): trunk forward -> recycling -> structure
module -> confidence -> PDB file, through `predict.fold_and_write`.

    python -m alphafold2_tpu_torch.scripts.fold_synthetic [out.pdb] \
        [--device cuda|cpu] [--cache-dir DIR] [--trace traces.jsonl]

The model is the JAX example's (dim 64, depth 2, heads 4, dim_head 16,
bf16 trunk) with weights drawn from seed 1; the batch is one 48-residue
`data.synthetic.synthetic_batch` draw with 4 MSA rows, seed 0, 3
recycles. `--cache-dir` memoises the fold in a disk `cache.FoldCache`
under the tag of those seeded weights (a second run with the same
directory writes the same PDB without folding), `--trace` appends the
call's trace as JSONL (`tools/obs_report.py` reads it). Runs on the card
unless `--device` names another. Returns the written paths.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from alphafold2_tpu_torch.cache import FoldCache
from alphafold2_tpu_torch.data.synthetic import synthetic_batch
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.model.alphafold2 import Alphafold2
from alphafold2_tpu_torch.obs import Tracer
from alphafold2_tpu_torch.predict import fold_and_write

# names the seeded weights below in the cache's keys
MODEL_TAG = "fold_synthetic-dim64-depth2-seed1"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out", nargs="?", default="folded.pdb")
    ap.add_argument("--device", default=None)
    ap.add_argument("--cache-dir", default=None)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    model = Alphafold2(dim=64, depth=2, heads=4, dim_head=16,
                       predict_coords=True, structure_module_depth=2,
                       dtype=torch.bfloat16, device=device,
                       generator=torch.Generator().manual_seed(1))
    batch = synthetic_batch(np.random.default_rng(0), batch=1, seq_len=48,
                            msa_depth=4, with_coords=False, device=device)
    cache = None if args.cache_dir is None else \
        FoldCache(disk_dir=args.cache_dir)
    tracer = None if args.trace is None else Tracer(jsonl_path=args.trace)
    try:
        paths = fold_and_write(model, batch["seq"], args.out, cache=cache,
                               model_tag=MODEL_TAG, tracer=tracer,
                               device=device, msa=batch["msa"],
                               mask=batch["mask"],
                               msa_mask=batch["msa_mask"], num_recycles=3)
    finally:
        if tracer is not None:
            tracer.close()
    print(f"wrote {paths[0]}"
          + ("" if cache is None else
             f" (cache hits {cache.stats.hits}, misses "
             f"{cache.stats.misses})"))
    return paths


if __name__ == "__main__":
    main()
