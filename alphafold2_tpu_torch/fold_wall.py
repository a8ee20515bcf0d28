"""Wall time of one fold on the card, for comparing two checkouts of the
port on one machine.

    python3 alphafold2_tpu_torch/fold_wall.py [--root DIR] [--folds N]
                                              [--bucket 256|512]
                                              [--features none|full]

`--root` is the checkout whose `alphafold2_tpu_torch` is imported (by
default the one holding this file), so an unpacked older commit can be
timed by the same script: run it for the older tree and this one in
turn, in one session on one card. The fold is the default ModelConfig
(bf16 trunk) with seeded random weights, 5 MSA rows and 3 recycles, as
chip_smoke.py folds it: `--bucket 256` (the default) folds a request of
131 residues padded to the 256 bucket through `predict.fold` (dense, K1
only); `--bucket 512` folds a request of 437 residues through
`serve.executor.FoldExecutor` under the default buckets and the default
`KernelPolicy` (the 512 bucket block-sparse: K2 and K1). `--features
full` (256 bucket only) folds the same request with the full model's
inputs, as chip_smoke.py's fold-full phase does: t=4 templates (one
missing, one partial) with their angle features and 1024 extra-MSA rows
(`data.synthetic.synthetic_features`). Prints one JSON line: the root,
the bucket, the features, each timed fold's wall time (synchronised, ms)
and their median.
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
    ap.add_argument("--bucket", type=int, choices=(256, 512), default=256)
    ap.add_argument("--features", choices=("none", "full"), default="none")
    args = ap.parse_args()
    if args.features == "full" and args.bucket != 256:
        ap.error("--features full folds the 256 bucket")
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
    if args.bucket == 256:
        req = synthetic_batch(np.random.default_rng(2), seq_len=131,
                              msa_depth=5, with_coords=False)
        req = {key: pad_to(val, 256, axis=val.dim() - 1)
               for key, val in req.items()}
        if args.features == "full":
            from alphafold2_tpu_torch.data.synthetic import \
                synthetic_features
            req.update(synthetic_features(np.random.default_rng(3),
                                          seq_len=256, valid=131,
                                          num_templates=4, extra_depth=1024))
        run = lambda: fold(model, **req, num_recycles=3)
    else:
        from alphafold2_tpu_torch.data.synthetic import synthetic_requests
        from alphafold2_tpu_torch.serve.bucketing import (BucketPolicy,
                                                          default_policy)
        from alphafold2_tpu_torch.serve.executor import FoldExecutor
        from alphafold2_tpu_torch.serve.kernelpolicy import KernelPolicy
        edges = default_policy().edges
        spec = KernelPolicy.from_model_config(cfg, edges).spec_for(512)
        (request,) = synthetic_requests(np.random.default_rng(2), num=1,
                                        lengths=(437,), msa_depth=5)
        batch, _ = BucketPolicy(edges).assemble([request], 512, 1,
                                                msa_depth=5, device="cuda")
        ex = FoldExecutor(model)
        run = lambda: ex.run(batch, 3, kernel=spec)
    walls = []
    for i in range(args.warmup + args.folds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        if i >= args.warmup:
            walls.append((time.perf_counter() - t0) * 1e3)
    if not torch.isfinite(out.coords).all():
        raise AssertionError("non-finite coords")
    print(json.dumps({"root": args.root, "bucket": args.bucket,
                      "features": args.features, "wall_ms": walls,
                      "median_ms": float(np.median(walls))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
