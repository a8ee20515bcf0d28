"""Wall time of the train step on the card, for comparing two checkouts
of the port on one machine (the counterpart of `bench.py`'s child).

    python3 alphafold2_tpu_torch/train_wall.py [--root DIR]
        [--config contract|default] [--steps 10] [--warmup 2] [--profile]

`--config contract` (the default) is the repo's bench configuration,
`evoformer_distogram_train_step@256res(dim256,depth2,msa5,b1)`:
`Alphafold2(dim=256, depth=2, heads=8, dim_head=64)`, bf16 trunk, the
unrolled trunk (`use_scan=False`), 256 residues, 5 MSA rows, b=1, the
distogram CE plus the MSA-MLM loss, `adam(3e-4)`. `--config default` is
the default `ModelConfig` with `predict_coords=True` (dim 256, depth 6,
bf16, the remat trunk) under `make_recycled_train_step(max_recycles=3)`,
coords + confidence + MLM loss, on the same batch shape. Weights are
drawn from a seed; the batch is one synthetic batch, reused every step.

`--root` is the checkout whose `alphafold2_tpu_torch` is imported (by
default the one holding this file), so an older commit unpacked beside
this one is timed by the same script in the same call.

Prints one JSON line: the card's name and power limit (nvidia-smi), each
timed step's wall time (host clock, the device synchronised before and
after, ms) and their median, the last loss, the model FLOPs of a step
(`utils.flops.train_step_flops`; a recycled step adds a third of it for
each of its r passes without gradients) and the TFLOP/s they give (at
the median step; for the recycled steps, over their summed wall time),
the peak device memory over the run, K1's launches in each step (and
the recycle count r of each step of the default configuration), and the
MFU against two
peaks: the H100 SXM5 datasheet's dense bf16 rate (989 TFLOP/s, a
datasheet figure, not a measurement) and the rate a large bf16
`torch.matmul` reaches on this card in this run.

`--profile` then replays the same steps from a fresh setup (same seeds,
so the same recycle counts) under `torch.profiler` and adds the device
time by kernel: the card's busy share (kernel time over the unprofiled
run's wall time), K1's forward, the backward's plain recompute
(`ops.attention.BACKWARD_RANGE`: its kernels' time and its span on the
device) and the top kernels.
"""

import argparse
import json
import os
import subprocess
import sys
import time

# NVIDIA H100 SXM5 datasheet, dense bf16 tensor-core rate (no sparsity)
DATASHEET_BF16_FLOPS = 989e12
SEQ_LEN, MSA_ROWS, SEED = 256, 5, 0


def card_name_and_power():
    """nvidia-smi's `name, power.limit` line for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def matmul_flops_per_s(n=8192, iters=20):
    """FLOP/s of an n x n x n bf16 `torch.matmul` on the current card
    (CUDA events, after warm-up)."""
    import torch
    a = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    for _ in range(3):
        a @ b
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        a @ b
    end.record()
    end.synchronize()
    return 2.0 * n ** 3 * iters / (start.elapsed_time(end) / 1e3)


def setup(config: str):
    """(model, train step, train state, batch) of one configuration, on
    the card."""
    import numpy as np
    import torch
    from alphafold2_tpu_torch import Alphafold2, ModelConfig
    from alphafold2_tpu_torch.data.synthetic import synthetic_batch
    from alphafold2_tpu_torch.train import (TrainState, adam,
                                            make_recycled_train_step,
                                            make_train_step)
    gen = torch.Generator().manual_seed(SEED)
    if config == "contract":
        model = Alphafold2(dim=256, depth=2, heads=8, dim_head=64,
                           use_scan=False, dtype=torch.bfloat16,
                           device="cuda", generator=gen)
        step = make_train_step(model)
    elif config == "default":
        model = ModelConfig(predict_coords=True).build(device="cuda",
                                                       generator=gen)
        step = make_recycled_train_step(model, max_recycles=3)
    else:
        raise ValueError(f"unknown config {config!r}")
    batch = synthetic_batch(np.random.default_rng(SEED + 1), batch=1,
                            seq_len=SEQ_LEN, msa_depth=MSA_ROWS,
                            with_coords=True, device="cuda")
    state = TrainState.create(model, adam(3e-4), seed=SEED + 2)
    return model, step, state, batch


def time_steps(step, state, batch, warmup: int, steps: int):
    """Run warm-up then timed steps; returns (state, wall ms per timed
    step, metrics of every step as floats plus its K1 launches)."""
    import torch
    from alphafold2_tpu_torch.ops import attention as attn
    walls, history = [], []
    for i in range(warmup + steps):
        torch.cuda.synchronize()
        attn.launch_count.reset()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        if i >= warmup:
            walls.append((time.perf_counter() - t0) * 1e3)
        history.append({k: float(v) for k, v in metrics.items()})
        history[-1]["k1_launches"] = attn.launch_count.value
    return state, walls, history


def device_breakdown(prof):
    """From a finished torch.profiler run: (busy ms, K1 forward ms,
    {"kernels": ms, "span": ms} of the backward's plain recompute,
    {kernel: (ms, calls)}). Busy is kernel time by name; the recompute's
    range is an annotation, not a kernel: its kernels are the device time
    of the host-side range, its span the range on the device timeline
    (kernels and the gaps between them)."""
    import re

    from torch.autograd import DeviceType

    from alphafold2_tpu_torch.ops.attention import BACKWARD_RANGE
    rows, recompute = {}, {"kernels": 0.0, "span": 0.0}
    for e in prof.key_averages():
        if e.key == BACKWARD_RANGE:
            part = "span" if e.device_type == DeviceType.CUDA else "kernels"
            recompute[part] += e.device_time_total / 1e3
            continue
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        ms, calls = rows.get(e.key, (0.0, 0))
        rows[e.key] = (ms + e.self_device_time_total / 1e3, calls + e.count)
    k1 = sum(ms for key, (ms, _) in rows.items()
             if re.search(r"fused_attention\w*_kernel", key))
    return sum(ms for ms, _ in rows.values()), k1, recompute, rows


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=here)
    ap.add_argument("--config", choices=("contract", "default"),
                    default="contract")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    # import the package from --root, never from beside this file
    sys.path[0] = os.path.abspath(args.root)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("train_wall: no CUDA device", file=sys.stderr)
        return 1
    from alphafold2_tpu_torch.utils.flops import train_step_flops

    model, step, state, batch = setup(args.config)
    flops = train_step_flops(model, batch)
    torch.cuda.reset_peak_memory_stats()
    state, walls, history = time_steps(step, state, batch, args.warmup,
                                       args.steps)
    peak = torch.cuda.max_memory_allocated()
    median = float(np.median(walls))
    recycles = [h["recycles"] for h in history] if "recycles" \
        in history[0] else None
    if recycles is None:
        tflops = flops / (median / 1e3) / 1e12
    else:
        # a recycled step adds r forward passes without gradients (a
        # third of the gradient pass's model FLOPs each): the rate is
        # the timed steps' FLOPs over their summed wall time
        done = sum(flops * (1 + r / 3) for r in recycles[args.warmup:])
        tflops = done / (sum(walls) / 1e3) / 1e12
    matmul = matmul_flops_per_s()
    record = {
        "root": args.root, "config": args.config,
        "card": card_name_and_power(),
        "wall_ms": walls, "median_ms": median,
        "loss": history[-1]["loss"],
        "recycles": recycles,
        "k1_launches": [h["k1_launches"] for h in history],
        "step_gflop": flops / 1e9, "tflops": tflops,
        "peak_memory_gib": peak / 2 ** 30,
        "mfu_datasheet_989": tflops * 1e12 / DATASHEET_BF16_FLOPS,
        "matmul_tflops": matmul / 1e12,
        "mfu_measured_matmul": tflops * 1e12 / matmul,
    }
    if not np.isfinite(record["loss"]):
        raise AssertionError("non-finite loss")
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        del model, step, state
        model, step, state, batch = setup(args.config)
        state, _, _ = time_steps(step, state, batch, args.warmup, 0)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            state, _, replay = time_steps(step, state, batch, 0, args.steps)
        busy, k1, recompute, rows = device_breakdown(prof)
        if record["recycles"] is not None and [
                h["recycles"] for h in replay] != record["recycles"][
                    args.warmup:]:
            raise AssertionError("the replay drew other recycle counts")
        top = sorted(rows.items(), key=lambda r: -r[1][0])[:12]
        record.update({
            "busy_ms_per_step": busy / args.steps,
            "busy_share": busy / sum(walls),
            "k1_forward_ms_per_step": k1 / args.steps,
            "recompute_kernel_ms_per_step": recompute["kernels"] / args.steps,
            "recompute_span_ms_per_step": recompute["span"] / args.steps,
            "top_kernels": [(key[:90], ms / args.steps, calls)
                            for key, (ms, calls) in top]})
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
