"""Peak-memory probe of one full train step over a sweep of depths, on
the card (counterpart of `tools/memory_probe.py`; BASELINE.md config 5's
trunk: depth 48, 384-residue crops, dim 256).

    python -m alphafold2_tpu_torch.tools.memory_probe [--depths 2,8,48] \
        [--len 384] [--dim 256] [--reversible] [--no-scan] [--run] \
        [--device cuda|cpu]

Each depth builds `Alphafold2(dim, depth, heads=8, dim_head=64)` with a
bf16 trunk on the meta device (nothing drawn on the host), allocates it
on the device and zeroes every parameter, makes the Adam state
(`adam(3e-4)`) and runs one step of `train.make_train_step` (distogram
and MLM losses, gradients, the Adam update) on a synthetic batch of one
crop with 5 MSA rows and a CA trace. `use_scan` (the default) runs each
trunk layer under `torch.utils.checkpoint` (remat); `--no-scan` is the
plain loop, which keeps every layer's activations for the backward;
`--reversible` is the reversible trunk.

The JAX probe reads XLA's compile-time plan of the step; memory on the
card can only be measured by running, so every depth's step runs here.
One JSON line per depth, with the JAX probe's keys where the meaning
carries over: `argument_size_mb` (the train state handed to the step:
parameters, Adam moments and accumulator), `output_size_mb` (the state
it hands back and the loss terms) and, on the card, `temp_size_mb`: the
step's peak allocated bytes (PyTorch's caching allocator, from
`torch.cuda.max_memory_allocated`) less the bytes allocated when the
step began (the state and the batch) -- a measured peak, not a
compiler's plan. The card's rows also give `step_s` (wall seconds of
the step, ending in a synchronize). `--run` adds the loss and the
allocator's `mb_in_use` / `peak_mb_in_use` after the step. On the CPU a
row gives the state's bytes (and with `--run` the loss) and leaves the
device keys out. The allocator's cache is emptied and its peak reset
between depths.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from alphafold2_tpu_torch.data.synthetic import synthetic_batch
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.model.alphafold2 import Alphafold2
from alphafold2_tpu_torch.train import TrainState, adam, make_train_step

MB = 2 ** 20


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def state_bytes(state: TrainState) -> int:
    """The bytes of the tensors a train state hands to the step: the
    parameters and the optimizer's moments (and accumulator)."""
    return _bytes(state.params) + _bytes(state.optimizer.tensors())


def zero_model(depth: int, dim: int, reversible: bool, use_scan: bool,
               device) -> Alphafold2:
    """The probe's model, built without a host-side random init: on the
    meta device, then allocated on `device` and zeroed."""
    model = Alphafold2(dim=dim, depth=depth, heads=8, dim_head=64,
                       dtype=torch.bfloat16, reversible=reversible,
                       use_scan=use_scan, device="meta")
    model.to_empty(device=device)
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
    return model


def analyze(depth: int, seq_len: int, dim: int, reversible: bool,
            use_scan: bool = True, run: bool = False, device=None):
    device = resolve_device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    model = zero_model(depth, dim, reversible, use_scan, device)
    batch = synthetic_batch(np.random.default_rng(0), batch=1,
                            seq_len=seq_len, msa_depth=5, with_coords=True,
                            device=device)
    state = TrainState.create(model, adam(3e-4), seed=2)
    nbytes = state_bytes(state)
    step = make_train_step(model)
    out = {
        "depth": depth, "seq_len": seq_len, "dim": dim,
        "reversible": reversible, "use_scan": use_scan,
        "platform": "gpu" if on_card else device.type,
    }
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    if on_card:
        torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device)
        out["temp_size_mb"] = round((peak - before) / MB, 1)
    out["argument_size_mb"] = round(nbytes / MB, 1)
    out["output_size_mb"] = round(
        (nbytes + _bytes(metrics.values())) / MB, 1)
    if on_card:
        out["step_s"] = round(seconds, 3)
    if run:
        out["loss"] = float(metrics["loss"])
        if on_card:
            out["mb_in_use"] = round(torch.cuda.memory_allocated(device)
                                     / MB, 1)
            out["peak_mb_in_use"] = round(peak / MB, 1)
    del state, model, metrics
    if on_card:
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default="2,8,48")
    ap.add_argument("--len", dest="seq_len", type=int, default=384)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--reversible", action="store_true")
    ap.add_argument("--no-scan", action="store_true",
                    help="disable remat (linear-memory comparison)")
    ap.add_argument("--run", action="store_true",
                    help="add the loss and the allocator's bytes in use")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (cpu runs the plain path)")
    args = ap.parse_args(argv)

    rows = []
    for d in (int(d) for d in args.depths.split(",")):
        rows.append(analyze(d, args.seq_len, args.dim, args.reversible,
                            use_scan=not args.no_scan, run=args.run,
                            device=args.device))
        print(json.dumps(rows[-1]), flush=True)
    return rows


if __name__ == "__main__":
    main()
