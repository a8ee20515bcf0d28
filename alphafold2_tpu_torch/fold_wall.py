"""Wall time of one dense 256-bucket fold on the card, for comparing two
checkouts of the port on one machine.

    python3 alphafold2_tpu_torch/fold_wall.py [--root DIR] [--folds N]

`--root` is the checkout whose `alphafold2_tpu_torch` is imported (by
default the one holding this file), so an unpacked older commit can be
timed by the same script: run it for the older tree and this one in
turn, in one session on one card. The fold is the default ModelConfig
(bf16 trunk) with seeded random weights, a request of 131 residues
padded to the 256 bucket, 5 MSA rows, 3 recycles, as chip_smoke.py
folds it. Prints one JSON line: the root, each timed fold's wall time
(synchronised, ms) and their median.
"""

import argparse
import json
import os
import sys
import time


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--folds", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args()
    # import the package from --root, never from beside this file
    sys.path[0] = os.path.abspath(args.root)

    import numpy as np
    import torch
    from alphafold2_tpu_torch import ModelConfig, fold
    from alphafold2_tpu_torch.data.synthetic import pad_to, synthetic_batch

    if not torch.cuda.is_available():
        print("fold_wall: no CUDA device", file=sys.stderr)
        return 1
    cfg = ModelConfig(predict_coords=True)
    model = cfg.build(device="cuda",
                      generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_((torch.randn(p.shape, generator=g) * 0.05).to(p.device))
    req = synthetic_batch(np.random.default_rng(2), seq_len=131,
                          msa_depth=5, with_coords=False)
    req = {key: pad_to(val, 256, axis=val.dim() - 1)
           for key, val in req.items()}
    walls = []
    for i in range(args.warmup + args.folds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fold(model, **req, num_recycles=3)
        torch.cuda.synchronize()
        if i >= args.warmup:
            walls.append((time.perf_counter() - t0) * 1e3)
    if not torch.isfinite(out.coords).all():
        raise AssertionError("non-finite coords")
    print(json.dumps({"root": args.root, "wall_ms": walls,
                      "median_ms": float(np.median(walls))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
