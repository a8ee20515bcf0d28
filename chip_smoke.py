#!/usr/bin/env python3
"""Smoke run of the PyTorch port (alphafold2_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (nonzero exit, no result line):

1. device: the card's name and count, and nvidia-smi's name and power
   limit;
2. build: every CUDA kernel of the fold path (K1 fused attention, K2
   block-sparse attention), from the sources in the checkout, one nvcc
   per source started together (build seconds and the -Xptxas -v
   report);
3. check: each kernel against its plain PyTorch version on the card, at
   the shapes the fold path gives it, in fp32 and bf16 (K1 at the 256
   bucket's three shapes, the 512 bucket's MSA column shape and the
   full-feature fold's four: the template triangle attention (B=8192,
   N=256, bias replayed over 256), the template pointwise attention
   (B=524,288, Nq=1, Nk=4, cells with no valid template), the extra-MSA
   row attention (B=8192, N=256, bias replayed over 1024) and column
   attention (B=2048, N=1024; its plain version over chunks of B), plus
   a small backward against autograd; K2 at the 512 bucket's MSA row and
   triangle shapes under the default policy's pattern and a banded
   block-128 one, plus one call at the default scale), then at the
   tensor-core tile's edge cases (ragged and odd lengths, every head
   width, replayed bias, fully masked rows, every bf16 layout of K1,
   every K2 block size, live keys all masked, other scales), and at the
   widths and blocks without a kernel instance: K1 at D = 8, 48 and 96
   (zero-padded to the next instance), K2 at block 48 (re-planned at
   16) and block 24 (K1 with the pattern as a bias), each launch counted
   on the kernel that ran; a padded D=48 launch timed beside D=64 at
   the triangle shape; and the sliced path of heads wider than 128: K1
   at D = 160, 256 and 384 at the triangle shape (B=2048, N=256, bias
   replayed) and a ragged N=131 one, K2 at D = 256 at the 512 bucket's
   triangle shape under the default pattern, in fp32 and bf16, each
   launch counted, and the D = 256 launches timed beside their plain
   versions, SDPA and the bound;
4. time: each kernel (CUDA events over a run of launches, and device
   time per launch from torch.profiler), its plain version and one
   PyTorch library call computing the same function (a yardstick the
   port never calls), beside the least time the card could take (bytes
   or FLOPs bound), at each shape of phase 3; K1's bf16 layouts at the
   MSA column, triangle and pointwise shapes; K2 also beside K1 on the
   same shape with the pattern as an additive bias (the dense cost),
   under the default pattern and a banded block-128 one;
5. parity: small fp32 models folded on the card (kernel path) and on
   the CPU (plain path) from the same weights: dense on seq/MSA, dense
   with every new input at once (templates, template angles, extra MSA,
   seq_index, sequence and MSA embeddings), and under a block-sparse
   spec; each with its K1 or K2 launch count;
6. serve: the default ModelConfig (dim 256, depth 6, heads 8, dim_head
   64, bf16 trunk) with seeded random weights folds three requests of
   256, 200 and 131 residues padded to the 256 bucket, 5 MSA rows, 3
   recycles; each fold must launch every kernel of the path;
7. profile: torch.profiler over one more fold, device time by kernel,
   and the card's busy share of an unprofiled fold's wall time;
7a. fold-and-write: the same model through `predict.fold_and_write` with
   a disk `cache.FoldCache` and an `obs.Tracer` (JSONL sink) in a
   temporary directory: requests of 200 and 131 residues padded to the
   256 bucket, folded as one batch of two, 5 MSA rows, 3 recycles. The
   miss folds once (96 K1 launches) and writes one PDB per element,
   whose CA trace `data.native.parse_pdb` reads back within 1e-3 A of
   the fold's coordinates; the hit launches nothing, writes the same
   bytes and is traced with source "cache". Miss wall, hit wall, write
   ms and the cache's bytes;
7b. step-snapshot: `fold_init`, `snapshot_step_state`,
   `restore_step_state` (byte-equal, on the same card), then 3
   `fold_step`s from the restored carry against 3 from the original:
   the largest coordinate gap (0 expected on one card);
8. fold-full: the same model folds the same three lengths through
   `predict.fold` with the full model's inputs: t=4 templates
   (templates_dim 32, 55 angle features; one missing, one partial),
   e=1024 extra-MSA rows (4 extra-MSA layers), 5 MSA rows, 3 recycles;
   each fold must launch K1 45 times a pass (180 a fold), counted on
   each path (template pair stack 8, pointwise 1, extra-MSA stack 12,
   trunk 24 a pass), and give finite coords and distogram; wall and
   peak memory per fold, then a profile of one fold (device time by
   kernel, K1's share, busy share);
9. executor: the same model behind `serve.executor.FoldExecutor` with
   the default buckets and the default kernel policy (the 512 bucket
   block-sparse, the others dense): warm-up, three folds of 512, 437
   and 300 residues in the 512 bucket (72 K2 + 24 K1 launches each), one
   of 200 residues in the 256 bucket (0 K2 + 96 K1), and a step-mode
   fold whose steps run under a spec re-planned from the first pass's
   distogram; then a profile of one 512-bucket fold;
9a. scheduler: the same model behind the port's `serve.Scheduler`
   (default buckets and kernel policy, max_batch_size 2, 5 MSA rows, 3
   recycles, a memory FoldCache, a JSONL Tracer, RetryPolicy(
   xla_classify=True)): four threads submit 512, 437, 300, 256, 200 and
   131 residues, a duplicate of 200 behind its leader (coalesced) and
   after it (cache hit); a real CUDA OOM is caught and classified
   transient and one more request is served; every ticket ok with
   finite coords of its length, K2 72 + K1 24 launches per 512 batch
   and K1 96 per 256 batch; each ticket's latency (submit to resolve:
   the burst's completion times, with their p50/p99, which over one
   burst of nine order the batches rather than sample a load), batches
   and fold wall per bucket, the serve_stats() summary. Then a small fp32
   model served through the Scheduler on the card against
   `predict.fold` on the CPU (1e-3), step mode with early exit and
   streaming (serve_recycles_skipped_total), and injected faults: a
   transient error (retried, ok), a poison input ("poisoned" while its
   batch-mate is ok) and a host-side latency that fires the watchdog
   (executor rebuilt, ok);
9b. fleet: an `InProcessFleet` of two replicas on the card over the
   same model (default buckets and `KernelPolicy`, batches of two), a
   `FrontDoorServer` on 127.0.0.1 before each replica's Scheduler and
   `HttpTransport` clients: the scheduler phase's six lengths split over
   the two doors (the 512-bucket ones alternate, the 256-bucket ones go
   alternately to their key's owner and to the other replica, which
   forwards), then a twin of each 256-bucket request sent as an
   already-forwarded hop to the replica not owning its key (served from
   its cache: its own memory, or the owner's peer tier), then a rollout
   (`bump_model_tag`) after which a peer fetch under the old tag gets
   409, and one more request; every ticket ok, K1 and K2 launched,
   forwards, peer hits and 409s each at least one; each ticket's
   submit-to-resolve time in completion order and the peak memory;
9c. serve-tiers: one Scheduler over the same model with the SLO engine,
   the bulk tier (`BulkPolicy` over step-mode recycling), the cascade (a
   draft Scheduler over `draft_preset(ModelConfig())`, dim 128, depth 2,
   sharing the FoldCache under its own tag) and a `PreemptionWatcher` on
   a `FileNoticeSource`: the six lengths and one of 100 residues online
   (each folds on the draft first, then is accepted or escalated) and
   two bulk requests; the SLO report, bulk admits and yields, draft
   decisions, completion times; then the notice file, after which the
   scheduler is in reclaim mode and refuses submits;
9d. procfleet: two replica processes (`python -m
   alphafold2_tpu_torch.fleet.procfleet`, the JAX replica widths: dim
   32, depth 1, heads 2, dim_head 16, so K1 at D = 16) on the card,
   loading the kernels phase 2 built: four folds through the front
   doors (`FleetClient`), kill -9 of one, a `FleetController` reconcile
   that restores the quorum with a new replica, one more fold, and
   SIGTERM, after which each live replica exits 0;
9e. loadtest: the port's load test (`alphafold2_tpu_torch.tools.
   serve_loadtest`, called in-process) at the default ModelConfig
   (`--preset default`): four closed-loop threads submit 64 requests
   of 131 to 512 residues (a quarter Zipf duplicates, cache on) to one
   Scheduler with batches of two, 5 MSA rows, 3 recycles and the 512
   bucket on K2 (block 32, window 1, one global block); --smoke must
   pass (no shed, error, timeout or rejection; the cache hits), K1 and
   K2 must launch exactly as the metrics JSONL's batches, the two
   warm-up runs and the numerics check's one K2 call give, K2's
   serving-time numerics (bf16, against the plain attention in fp32)
   within 2e-2, and `obs_report --check --prom` must pass on the run's
   trace and exposition; folds/hour, warm-up, latency p50/p99 by
   bucket, padding waste, cache hits, coalesced and peak memory;
9f. loadtest-chaos: the same tool at the default model in the 256
   bucket under the default seeded fault plan (10 % transient executor
   faults, one poison): --smoke's chaos checks (every ticket terminal,
   every innocent request ok, exactly one poisoned, cornered within
   log2(max_batch)+1 executions);
9g. loadtest-fleet: two in-process replicas on the card (routing, the
   peer tier, a rollout halfway), 3 recycles: zero stale-tag hits, at
   least one forward, K1 96 per batch and warm-up over both replicas;
10. train-check: K1's autograd (the kernel forward, the backward's plain
   recompute) against the plain version's autograd at the train step's
   triangle, MSA row and MSA column shapes, fp32 and bf16 (gradients
   against fp32 math on the same values, error over the largest
   reference gradient); then a small fp32 train step on the card against
   the same step on the CPU (same weights, same MLM noise from one CPU
   generator): loss within 1e-4, every gradient within 1e-3;
11. train: the contract configuration (`train_wall.py --config
   contract`: dim 256, depth 2, heads 8, dim_head 64, bf16, unrolled
   trunk, 256 residues, 5 MSA rows, distogram + MLM, adam 3e-4): 8 K1
   launches per step, 30 steps on one fixed batch with the mean loss of
   the last 5 below the first 5's, the step's wall time, TFLOP/s, MFU
   and peak memory, and a profile of one step (K1's forward and the
   backward's plain recompute on lines of their own);
12. train-recycled: the default ModelConfig with `predict_coords` and the
   remat trunk under `make_recycled_train_step(max_recycles=3)`: one
   step with a finite loss and 48 + 24 r K1 launches (r its recycle
   count), then a checkpoint saved and restored on the card (bit-equal,
   and the next step draws the same r from the restored generator).

Each phase prints its seconds.

The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without a CUDA device the script exits
nonzero before any phase.

    python3 chip_smoke.py --phases time [--root DIR]

runs only phases 1, 2 and 4 and prints one JSON line of the times;
`--root` imports `alphafold2_tpu_torch` from another checkout (an older
commit unpacked beside this one), so two trees' kernels are timed on
one card in one call.
"""

import argparse
import contextlib
import io
import itertools
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and dense
# tensor-core bf16 / CUDA-core fp32 rates
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# fp32: sums in another order; bf16: the output's rounding (8 bits of
# mantissa on values of a few units)
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}

BUCKET = 256
LENGTHS = (256, 200, 131)
SPARSE_BUCKET = 512
SPARSE_LENGTHS = (512, 437, 300)
DENSE_LENGTH = 200
MSA_ROWS = 5
NUM_RECYCLES = 3
SEED = 0
# the full-feature fold's inputs: AF2's template count and its training
# extra-MSA depth (Jumper et al. 2021, supplementary 1.2.7 and Table 4)
TEMPLATES = 4
EXTRA_ROWS = 1024
# K1's fold-path shapes: the 256 bucket's three, the 512 bucket's MSA
# column attention (B=4096, N=5), and the four that the full-feature fold
# adds: the template pair stack's triangle attention, the template
# pointwise attention (one query over the t templates of each pair cell),
# and the extra-MSA stack's row (pair-biased) and column (N=1024)
# attentions
FULL_K1_SHAPES = ("template_triangle", "pointwise", "extra_row",
                  "extra_col")
K1_SHAPES = ("msa_row", "msa_col", "triangle", "msa_col_512") + \
    FULL_K1_SHAPES


def log(*args):
    print(*args, flush=True)


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"device: {name} (count {count})")
    log(f"nvidia-smi: {smi.stdout.strip()}")
    return name, count


def phase_build():
    from alphafold2_tpu_torch.ops import build
    t0 = time.perf_counter()
    info = build.build()
    log(f"build: {sorted(info)} in {time.perf_counter() - t0:.1f} s")
    for name, entry in info.items():
        log(f"  {name}: nvcc {entry['seconds']:.1f} s -> {entry['path']}")
        for line in ptxas_summary(entry["ptxas"]):
            log(f"    {line}")
    return info


def ptxas_summary(report):
    """One line per compiled kernel from `-Xptxas -v`: kernel name and
    template arguments (the fp32 kernels <D, BQ>; the bf16 tensor-core
    kernels <D, WG, G, BK, STAGES>), registers, shared memory, spills."""
    lines, entry, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            targs = re.search(r"\d((?:fused_attention|block_sparse)"
                              r"(?:_sliced)?(?:_mma(?:_wide)?)?_kernel)"
                              r"I(\w*?)((?:Li\d+E)+)",
                              m.group(1))
            entry = "{} {}<{}>".format(
                targs.group(1), "bf16" if "_mma_" in targs.group(1)
                or "bfloat16" in targs.group(2) else "f32", ", ".join(re.findall(r"Li(\d+)E",
                                                 targs.group(3)))) \
                if targs else m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and entry:
            lines.append(f"{entry}: {m.group(1)} registers, "
                         f"{m.group(2) or 0} B static smem, {spill}")
    return lines


def attention_inputs(shape, dtype, device, seed, d=64):
    """Inputs of one fold-path attention launch (heads 8, D 64 unless
    `d` says otherwise), with a
    padded tail of masked residues (so some query rows are fully masked):
    the 256 bucket's three shapes; `msa_col_512`, the one K1 launch of a
    512-bucket fold (its other attentions run K2); and the full-feature
    fold's four (t=4 templates, the last missing and the one before it
    partial, as `synthetic_features` makes them; e=1024 extra rows, each
    covering a random prefix of the real residues)."""
    heads, valid = 8, 200
    g = torch.Generator(device=device).manual_seed(seed)
    bucket = BUCKET
    if shape == "msa_col_512":  # the 512 bucket's column attention
        shape, bucket, valid = "msa_col", SPARSE_BUCKET, 437
    real = torch.arange(bucket, device=device) < valid
    templates = real[None].repeat(TEMPLATES, 1)
    templates[-2, (2 * valid) // 3:] = False
    templates[-1] = False
    crossed = templates[:, :, None] & templates[:, None, :]   # (t, n, n)
    extra = torch.arange(bucket, device=device)[None] < torch.randint(
        valid // 2, valid + 1, (EXTRA_ROWS, 1), generator=g, device=device)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=device) * scale

    nq = nk = bucket
    bias_rows, bias_repeat = heads, 1
    if shape == "msa_row":      # 5 alignment rows attend over residues
        q_mask = real[None].repeat(MSA_ROWS, 1)
        q_mask[3] = False                        # one fully masked row
        k_mask, bias_repeat = q_mask, MSA_ROWS
    elif shape == "msa_col":    # residues attend over 5 alignment rows
        nq = nk = MSA_ROWS
        k_mask = real[:, None].repeat(1, MSA_ROWS)
        k_mask[:valid, -1] = False               # a ragged last row
        q_mask, bias_rows = k_mask, 0
    elif shape == "triangle":   # triangle attention over the pair map
        q_mask = real[:, None] & real[None, :]
        k_mask, bias_repeat = q_mask, bucket
    elif shape == "template_triangle":   # each template's pair map
        q_mask = crossed.reshape(TEMPLATES * bucket, bucket)
        k_mask, bias_rows, bias_repeat = q_mask, TEMPLATES * heads, bucket
    elif shape == "pointwise":  # each pair cell over its t templates
        nq, nk, bias_rows = 1, TEMPLATES, 0
        q_mask = (real[:, None] & real[None, :]).reshape(-1, 1)
        k_mask = crossed.permute(1, 2, 0).reshape(-1, TEMPLATES)
    elif shape == "extra_row":  # 1024 extra rows over residues
        q_mask = k_mask = extra
        bias_repeat = EXTRA_ROWS
    elif shape == "extra_col":  # residues over the 1024 extra rows
        nq = nk = EXTRA_ROWS
        q_mask = k_mask = extra.t()
        bias_rows = 0
    else:
        raise ValueError(f"unknown attention shape {shape!r}")
    b = q_mask.shape[0] * heads
    q = randn(b, nq, d, scale=0.5).to(dtype)
    k = randn(b, nk, d, scale=0.5).to(dtype)
    v = randn(b, nk, d).to(dtype)
    bias = randn(bias_rows, nq, nk) if bias_rows else None
    return dict(q=q, k=k, v=v, bias=bias,
                q_mask=q_mask.contiguous(), k_mask=k_mask.contiguous(),
                heads=heads, bias_repeat=bias_repeat)


# the most fp32 logits the plain version holds at once on the card
PLAIN_LOGITS_BYTES = 2 ** 31


def plain_attention(kw):
    """The plain version of one launch's inputs, over chunks of B when its
    fp32 logits would pass PLAIN_LOGITS_BYTES (the extra-MSA column
    shape's are 8 GiB): each chunk holds whole bias-replay groups, so it
    reads its own slice of the bias and the masks. One chunk when they
    fit."""
    from alphafold2_tpu_torch.ops import attention as attn
    q, k, v = kw["q"], kw["k"], kw["v"]
    b, nq, _ = q.shape
    heads, rep = kw["heads"], kw["bias_repeat"]
    bias = kw["bias"]
    group = heads * (rep if bias is not None else 1)
    group_bytes = group * nq * k.shape[1] * 4
    rows = max(1, PLAIN_LOGITS_BYTES // group_bytes) * group
    if rows >= b:
        return attn.attention_reference(**kw)
    outs = []
    for s in range(0, b, rows):
        e = min(s + rows, b)
        outs.append(attn.attention_reference(
            q[s:e], k[s:e], v[s:e],
            bias=None if bias is None else bias[s // rep:e // rep],
            q_mask=kw["q_mask"][s // heads:e // heads],
            k_mask=kw["k_mask"][s // heads:e // heads],
            heads=heads, bias_repeat=rep))
    return torch.cat(outs)


def phase_check():
    from alphafold2_tpu_torch.ops import attention as attn
    dev = torch.device("cuda")
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in K1_SHAPES:
            kw = attention_inputs(shape, dtype, dev, seed=1)
            out = attn.fused_attention(**kw)
            torch.cuda.synchronize()
            # the plain version on the same input values, in fp32: its
            # bf16 run rounds the logits to bf16 before the softmax,
            # which the kernel does not
            ref = plain_attention(dict(kw, **{
                key: kw[key].float() for key in ("q", "k", "v")}))
            err = float((out.float() - ref).abs().max())
            tol = TOLERANCE[dtype]
            log(f"check fused_attention {shape} {str(dtype)[6:]} "
                f"B={kw['q'].shape[0]} Nq={kw['q'].shape[1]} "
                f"Nk={kw['k'].shape[1]}: "
                f"max abs err {err:.3e} (tolerance {tol:.0e})")
            if not err <= tol or not torch.isfinite(out).all():
                raise AssertionError(f"fused_attention {shape} {dtype}: "
                                     f"max abs err {err} > {tol}")
            worst[dtype] = max(worst.get(dtype, 0.0), err)
            del out, ref, kw

    # backward: recompute through the plain version vs plain autograd
    g = torch.Generator().manual_seed(2)
    b, rep, heads, n, d = 2, 2, 2, 64, 32
    leaves = [torch.randn(b * rep * heads, n, d, generator=g)
              for _ in range(3)] + [torch.randn(b * heads, n, n,
                                                generator=g)]
    mask = (torch.arange(n)[None] < torch.tensor([[50], [64], [20],
                                                  [64]])).to(dev)
    grads = []
    for fn in (attn.fused_attention, attn.attention_reference):
        xs = [x.to(dev).requires_grad_() for x in leaves]
        out = fn(*xs, q_mask=mask, k_mask=mask, heads=heads,
                 bias_repeat=rep)
        (out * out).sum().backward()
        grads.append([x.grad for x in xs])
    gerr = max(float((a - c).abs().max()) for a, c in zip(*grads))
    log(f"check fused_attention backward: max abs err {gerr:.3e} "
        f"(tolerance 1e-4)")
    if not gerr <= 1e-4:
        raise AssertionError(f"fused_attention backward err {gerr}")
    return worst


# Edge shapes of the tensor-core tile. K1: (Nq, Nk, D, heads,
# bias_repeat, full), lengths off the 16/64 grid (5, 17, 131, 200), odd Nk
# under a bias, every head width, a bias replayed over bias_repeat > 1
# with heads > 1; `full` masks one query row and one key row in full.
# K2: (block, D, scale), every block and head width, scales other than 1.
K1_EDGES = [(5, 5, 64, 8, 3, False), (131, 131, 32, 2, 2, True),
            (200, 131, 16, 2, 1, False), (131, 200, 128, 1, 2, True),
            (17, 5, 64, 4, 2, False), (64, 7, 16, 2, 3, True)]
K2_EDGES = [(16, 16, 1.0), (32, 128, 0.37), (64, 32, 1.0),
            (128, 64, 0.125), (128, 128, 1.0), (32, 64, 2.0)]
# widths and blocks with no kernel instance, and the route each takes
# on the card: K1 at these head widths (zero-padded to 16, 64, 128);
# K2 at block 48 (re-planned at 16) and block 24 (K1, pattern as bias)
K1_PADDED_WIDTHS = (8, 48, 96)
# the sliced path (D > 128, zero-padded to a multiple of 128): K1 at these
# head widths, K2 at SLICED_K2_WIDTH; the D = 256 launches are also timed
SLICED_WIDTHS = (160, 256, 384)
SLICED_K2_WIDTH = 256
# the padding token ('_', the last of the 21), which a PDB leaves out
NUM_TOKENS_PAD = 20
ROUTED_BLOCKS = ((48, "block_sparse_attention (K2, re-planned at 16)"),
                 (24, "fused_attention (K1, pattern as bias)"))


def phase_check_edges():
    """Both kernels at the tile's edge cases against their plain versions
    in fp32 on the same values; bf16 K1 in every layout of its dispatch
    (0 = the shape rule, 1 and 2 forced), K2 with a query block whose live
    keys are all masked (it averages over its live keys, as the plain
    version does). Returns the worst error per (kernel, dtype)."""
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.ops import block_sparse as bs
    dev = torch.device("cuda")
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOLERANCE[dtype]
        layouts = (0,) if dtype == torch.float32 else (0, 1, 2)
        for nq, nk, d, heads, rep, full in K1_EDGES:
            g = torch.Generator().manual_seed(nq + nk + d)
            b = heads * rep
            q, k = (torch.randn(b, n, d, generator=g) * 0.5 for n in (nq, nk))
            v = torch.randn(b, nk, d, generator=g)
            bias = torch.randn(heads, nq, nk, generator=g).to(dev)
            qm = torch.arange(nq)[None] < torch.randint(
                (nq + 1) // 2, nq + 1, (rep, 1), generator=g)
            km = torch.arange(nk)[None] < torch.randint(
                (nk + 1) // 2, nk + 1, (rep, 1), generator=g)
            if full:
                qm[0] = False
                km[-1] = False
            qm, km = qm.to(dev), km.to(dev)
            q, k, v = (t.to(dev, dtype) for t in (q, k, v))
            ref = attn.attention_reference(q.float(), k.float(), v.float(),
                                           bias, qm, km, heads=heads,
                                           bias_repeat=rep)
            errs = []
            for layout in layouts:
                out = attn._launch(q, k, v, bias, qm, km, heads, rep,
                                   layout=layout)
                torch.cuda.synchronize()
                errs.append(float((out.float() - ref).abs().max()))
                if not errs[-1] <= tol or not torch.isfinite(out).all():
                    raise AssertionError(
                        f"fused_attention edge Nq={nq} Nk={nk} D={d} "
                        f"{dtype} layout {layout}: max abs err {errs[-1]}")
            log(f"check fused_attention edge Nq={nq} Nk={nk} D={d} heads="
                f"{heads} repeat={rep}{' full masks' if full else ''} "
                f"{str(dtype)[6:]} layouts {list(layouts)}: max abs err "
                f"{max(errs):.3e} (tolerance {tol:.0e})")
            key = ("fused_attention", dtype)
            worst[key] = max(worst.get(key, 0.0), max(errs))
        heads, rep = 2, 3
        for block, d, scale in K2_EDGES:
            n = 4 * block
            g = torch.Generator().manual_seed(block + d)
            b = heads * rep
            q, k = (torch.randn(b, n, d, generator=g) * 0.5 for _ in range(2))
            v = torch.randn(b, n, d, generator=g)
            bias = torch.randn(heads, n, n, generator=g)
            km = torch.arange(n)[None] < torch.randint(
                n // 2, n + 1, (rep, 1), generator=g)
            # window 0, one global block: query block 1 sees key blocks 0
            # and 1, every key of which is masked in this mask row
            km[1, :2 * block] = False
            plan = bs.BlockPlan.build(bs.banded_block_pattern(4, 0, 1),
                                      block, dev)
            kw = dict(bias=bias.to(dev), bias_repeat=rep, k_mask=km.to(dev),
                      heads=heads, scale=scale)
            args = [t.to(dev, dtype) for t in (q, k, v)]
            out = bs.block_sparse_attention(*args, plan, **kw)
            torch.cuda.synchronize()
            ref = bs.block_sparse_reference(*(t.float() for t in args), plan,
                                            **kw)
            err = float((out.float() - ref).abs().max())
            log(f"check block_sparse edge block={block} D={d} scale={scale} "
                f"{str(dtype)[6:]}: max abs err {err:.3e} (tolerance "
                f"{tol:.0e})")
            if not err <= tol or not torch.isfinite(out).all():
                raise AssertionError(f"block_sparse edge block {block} D {d} "
                                     f"{dtype}: max abs err {err}")
            key = ("block_sparse", dtype)
            worst[key] = max(worst.get(key, 0.0), err)
        check_routes(dtype, worst)
        check_sliced_widths(dtype, worst)
    worst["padded_width_ms"] = time_padded_width()
    worst["sliced"] = time_sliced_widths()
    return worst


def check_routes(dtype, worst):
    """K1 at the padded head widths and K2 at the routed blocks, through
    their public wrappers, against the plain versions in fp32 on the
    same values; each call must add one launch to the counter of the
    kernel that its route names."""
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.ops import block_sparse as bs
    dev = torch.device("cuda")
    tol = TOLERANCE[dtype]
    heads, rep = 2, 2
    for d in K1_PADDED_WIDTHS:
        n = 131
        g = torch.Generator().manual_seed(d)
        q, k = (torch.randn(heads * rep, n, d, generator=g) * 0.5
                for _ in range(2))
        v = torch.randn(heads * rep, n, d, generator=g)
        bias = torch.randn(heads, n, n, generator=g).to(dev)
        qm = (torch.arange(n)[None] < torch.randint(
            n // 2, n + 1, (rep, 1), generator=g)).to(dev)
        args = [t.to(dev, dtype) for t in (q, k, v)]
        before = attn.launch_count.value
        out = attn.fused_attention(*args, bias, qm, qm, heads=heads,
                                   bias_repeat=rep)
        torch.cuda.synchronize()
        launches = attn.launch_count.value - before
        ref = attn.attention_reference(*(t.float() for t in args), bias, qm,
                                       qm, heads=heads, bias_repeat=rep)
        err = float((out.float() - ref).abs().max())
        log(f"check fused_attention padded D={d} -> "
            f"{attn.kernel_head_dim(d)} N={n} {str(dtype)[6:]}: max abs err "
            f"{err:.3e} (tolerance {tol:.0e}), K1 launches {launches}")
        if not err <= tol or launches != 1 or out.shape[-1] != d:
            raise AssertionError(f"fused_attention padded D={d} {dtype}: "
                                 f"err {err}, launches {launches}")
        key = ("fused_attention", dtype)
        worst[key] = max(worst.get(key, 0.0), err)
    n, d = 192, 40
    for (block, route), band_only in itertools.product(ROUTED_BLOCKS,
                                                       (False, True)):
        counter = bs.launch_count if "K2" in route else attn.launch_count
        g = torch.Generator().manual_seed(block)
        q, k = (torch.randn(heads * rep, n, d, generator=g) * 0.5
                for _ in range(2))
        v = torch.randn(heads * rep, n, d, generator=g)
        bias = torch.randn(heads, n, n, generator=g).to(dev)
        nb = n // block
        lengths = torch.randint(n // 2, n + 1, (rep, 1), generator=g)
        if band_only:
            # no global block, and mask row 0 masks every live key of the
            # last q-block: that row averages over its live keys only
            lengths[0] = (nb - 2) * block
        km = (torch.arange(n)[None] < lengths).to(dev)
        plan = bs.BlockPlan.build(
            bs.banded_block_pattern(nb, 1, 0 if band_only else 1), block, dev)
        kw = dict(bias=bias, bias_repeat=rep, k_mask=km, heads=heads)
        args = [t.to(dev, dtype) for t in (q, k, v)]
        before = (attn.launch_count.value, bs.launch_count.value)
        out = bs.block_sparse_attention(*args, plan, **kw)
        torch.cuda.synchronize()
        launches = (attn.launch_count.value - before[0],
                    bs.launch_count.value - before[1])
        ref = bs.block_sparse_reference(*(t.float() for t in args), plan,
                                        **kw)
        err = float((out.float() - ref).abs().max())
        log(f"check block_sparse block={block} D={d} "
            f"{'band only, one row shut' if band_only else 'band+global'} "
            f"via {route} {str(dtype)[6:]}: max abs err {err:.3e} (tolerance "
            f"{tol:.0e}), K1 / K2 launches {launches}")
        expected = (0, 1) if counter is bs.launch_count else (1, 0)
        if not err <= tol or launches != expected:
            raise AssertionError(f"block_sparse block {block} {dtype}: err "
                                 f"{err}, launches {launches}")
        key = ("block_sparse", dtype)
        worst[key] = max(worst.get(key, 0.0), err)


def ragged_triangle(n, d, dtype, device, seed):
    """K1's inputs for triangle attention over an n x n pair map (heads
    8, the last quarter of the residues padding, the bias replayed over
    the n rows): B = 8 n."""
    heads, valid = 8, (3 * n) // 4
    g = torch.Generator(device=device).manual_seed(seed)
    q, k = (torch.randn(n * heads, n, d, generator=g, device=device) * 0.5
            for _ in range(2))
    v = torch.randn(n * heads, n, d, generator=g, device=device)
    real = torch.arange(n, device=device) < valid
    mask = (real[:, None] & real[None, :]).contiguous()
    return dict(q=q.to(dtype), k=k.to(dtype), v=v.to(dtype),
                bias=torch.randn(heads, n, n, generator=g, device=device),
                q_mask=mask, k_mask=mask, heads=heads, bias_repeat=n)


def check_sliced_widths(dtype, worst):
    """The sliced path (D > 128): K1 at SLICED_WIDTHS at the 256
    bucket's triangle shape and a ragged N = 131 one, K2 at D = 256 at
    the 512 bucket's triangle shape under the default policy's pattern,
    through the public wrappers, against the plain versions in fp32 on
    the same values; each call must add one launch to its kernel's
    counter. The worst errors land under ("sliced", kernel, dtype)."""
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.ops import block_sparse as bs
    dev = torch.device("cuda")
    tol = TOLERANCE[dtype]
    for d, n in itertools.product(SLICED_WIDTHS, (BUCKET, 131)):
        kw = (attention_inputs("triangle", dtype, dev, seed=d, d=d)
              if n == BUCKET else ragged_triangle(n, d, dtype, dev, seed=d))
        before = attn.launch_count.value
        out = attn.fused_attention(**kw)
        torch.cuda.synchronize()
        launches = attn.launch_count.value - before
        ref = plain_attention(dict(kw, **{
            key: kw[key].float() for key in ("q", "k", "v")}))
        err = float((out.float() - ref).abs().max())
        log(f"check fused_attention sliced D={d} -> "
            f"{attn.kernel_head_dim(d)} triangle B={kw['q'].shape[0]} N={n} "
            f"{str(dtype)[6:]}: max abs err {err:.3e} (tolerance "
            f"{tol:.0e}), K1 launches {launches}")
        if not err <= tol or launches != 1 or out.shape != kw["q"].shape \
                or not torch.isfinite(out).all():
            raise AssertionError(f"fused_attention sliced D={d} N={n} "
                                 f"{dtype}: err {err}, launches {launches}")
        key = ("sliced", "fused_attention", dtype)
        worst[key] = max(worst.get(key, 0.0), err)
        del kw, out, ref
    spec = sparse_specs()["default"]
    kw = block_sparse_inputs("triangle", spec, dtype, dev, seed=7,
                             d=SLICED_K2_WIDTH)
    before = bs.launch_count.value
    out = bs.block_sparse_attention(**kw)
    torch.cuda.synchronize()
    launches = bs.launch_count.value - before
    ref = bs.block_sparse_reference(**dict(kw, **{
        key: kw[key].float() for key in ("q", "k", "v")}))
    err = float((out.float() - ref).abs().max())
    log(f"check block_sparse sliced D={SLICED_K2_WIDTH} triangle "
        f"({spec.label}) B={kw['q'].shape[0]} N={SPARSE_BUCKET} "
        f"{str(dtype)[6:]}: max abs err {err:.3e} (tolerance {tol:.0e}), "
        f"K2 launches {launches}")
    if not err <= tol or launches != 1 or not torch.isfinite(out).all():
        raise AssertionError(f"block_sparse sliced D={SLICED_K2_WIDTH} "
                             f"{dtype}: err {err}, launches {launches}")
    worst[("sliced", "block_sparse", dtype)] = err


def attention_bound(kw):
    """(bound ms, 'bytes' | 'operations', bytes, flops) of one K1 call:
    q, k, v read and out written once, the bias and masks read once;
    the two products."""
    q, k, bias = kw["q"], kw["k"], kw["bias"]
    b, nq, d = q.shape
    nk = k.shape[1]
    nbytes = (2 * b * (nq + nk) * d * q.element_size()
              + (0 if bias is None else bias.numel() * 4)
              + kw["q_mask"].numel() + kw["k_mask"].numel())
    flops = 4 * b * nq * nk * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations", nbytes, flops)


def time_sliced_widths():
    """bf16 at D = 256: K1 at the triangle shape and K2 at the 512
    bucket's triangle shape under the default pattern, each kernel
    (CUDA events), its plain version, one SDPA call on the equivalent
    additive mask (a yardstick the port never calls) and the bound."""
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.ops import block_sparse as bs
    dtype, dev = torch.bfloat16, torch.device("cuda")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    kw = attention_inputs("triangle", dtype, dev, SEED, d=SLICED_K2_WIDTH)
    spec = sparse_specs()["default"]
    skw = block_sparse_inputs("triangle", spec, dtype, dev, SEED,
                              d=SLICED_K2_WIDTH)
    for name, args, run, plain, mask, bound in (
            ("fused_attention", kw, lambda: attn.fused_attention(**kw),
             lambda: plain_attention(kw), lambda: sdpa_mask(kw, dtype),
             attention_bound(kw)),
            ("block_sparse", skw,
             lambda: bs.block_sparse_attention(**skw),
             lambda: bs.block_sparse_reference(**skw),
             lambda: sparse_sdpa_mask(skw, spec, dtype),
             block_sparse_bound(skw, spec))):
        ms = cuda_ms(run, 10)
        plain_ms = cuda_ms(plain, 3, warmup=1)
        add_mask = mask()
        try:
            library_ms = cuda_ms(lambda: sdpa(args["q"], args["k"],
                                              args["v"], attn_mask=add_mask,
                                              scale=1.0), 3, warmup=1)
        except RuntimeError as e:   # the library has no kernel for it
            log(f"  sdpa refused {name} D={SLICED_K2_WIDTH}: "
                f"{str(e).splitlines()[0][:200]}")
            library_ms = None
        del add_mask
        b, n, d = args["q"].shape
        lib = "refused" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"time {name} sliced D={d} triangle bf16 B={b} N={n}: kernel "
            f"{ms:.4f} ms (events), plain {plain_ms:.4f} ms, sdpa {lib}, "
            f"bound {bound[0]:.4f} ms ({bound[1]}: {bound[2] / 1e6:.1f} MB, "
            f"{bound[3] / 1e9:.3f} GFLOP), {100 * bound[0] / ms:.1f} % of "
            f"bound")
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound[0], bound_by=bound[1])
    return out


def time_padded_width():
    """K1 at the triangle shape (bf16, heads 8) with D=48, padded to 64
    by the wrapper, beside the same launch at D=64 (CUDA events)."""
    from alphafold2_tpu_torch.ops import attention as attn
    kw = attention_inputs("triangle", torch.bfloat16, torch.device("cuda"),
                          SEED)
    narrow = dict(kw, **{x: kw[x][..., :48].contiguous()
                         for x in ("q", "k", "v")})
    ms = {d: cuda_ms(lambda a=a: attn.fused_attention(**a), 20)
          for d, a in ((64, kw), (48, narrow))}
    log(f"time fused_attention triangle bf16: D=48 (padded to 64) "
        f"{ms[48]:.4f} ms, D=64 {ms[64]:.4f} ms per launch")
    return ms


def device_ms(fn, iters):
    """Device time per call from torch.profiler: the time of every CUDA
    kernel that `iters` calls of `fn` launched (after one warm-up call),
    over `iters`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / iters / 1e3


def cuda_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def sdpa_mask(kw, dtype):
    """The additive mask (B, Nq, Nk) in `dtype` that makes one SDPA call
    compute what one K1 launch does: the bias replayed over the fold and
    -1e9 at masked pairs."""
    q, bias, heads = kw["q"], kw["bias"], kw["heads"]
    b, nq, nk = q.shape[0], q.shape[1], kw["k"].shape[1]
    valid = (kw["q_mask"][:, :, None] & kw["k_mask"][:, None, :]
             ).repeat_interleave(heads, dim=0)
    if bias is None:
        return torch.zeros(b, nq, nk, device=q.device, dtype=dtype
                           ).masked_fill_(~valid, -1e9)
    add = bias.reshape(-1, heads, nq, nk).repeat_interleave(
        kw["bias_repeat"], dim=0).reshape(b, nq, nk)
    return add.masked_fill(~valid, -1e9).to(dtype)


# iterations of the timed runs per shape; the layouts are timed at the
# shapes where the shape rule chooses between them
TIME_ITERS = {"msa_row": 50, "msa_col": 50, "triangle": 20,
              "msa_col_512": 50, "template_triangle": 10, "pointwise": 20,
              "extra_row": 10, "extra_col": 10}
LAYOUT_SHAPES = ("msa_col", "triangle", "msa_col_512", "pointwise")


def phase_time():
    """K1 at each fold-path shape in bf16: kernel (CUDA events over a run
    of launches, and device time per launch from torch.profiler), plain
    version (over chunks of B where its logits pass 2 GiB), SDPA
    yardstick and the bound; at the MSA column, triangle and pointwise
    shapes also each bf16 layout of the kernel's dispatch by profiler
    device time (where the tree has them), which is what the shape rule
    is chosen from. The JSON record carries the triangle shape, the
    256-bucket fold's largest and most frequent launch, and the other
    shapes under `<shape>_*`."""
    import inspect
    from alphafold2_tpu_torch.ops import attention as attn
    dtype = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    has_layouts = "layout" in inspect.signature(attn._launch).parameters
    results = {}
    for shape in K1_SHAPES:
        iters = TIME_ITERS[shape]
        kw = attention_inputs(shape, dtype, torch.device("cuda"), seed=3)
        q, k, v, bias = kw["q"], kw["k"], kw["v"], kw["bias"]
        heads, rep = kw["heads"], kw["bias_repeat"]
        b, nq, d = q.shape
        nk = k.shape[1]
        ms = cuda_ms(lambda: attn.fused_attention(**kw), iters=iters)
        dev_ms = device_ms(lambda: attn.fused_attention(**kw), iters=iters)
        plain_ms = cuda_ms(lambda: plain_attention(kw),
                           iters=max(iters // 2, 5))
        # yardstick only: one library call on the equivalent additive mask
        add_mask = sdpa_mask(kw, dtype)
        try:
            library_ms = cuda_ms(
                lambda: sdpa(q, k, v, attn_mask=add_mask, scale=1.0),
                iters=max(iters // 2, 5))
        except RuntimeError as e:   # the library has no kernel for it
            log(f"  sdpa refused {shape}: {str(e).splitlines()[0][:200]}")
            library_ms = None
        del add_mask
        layouts = {}
        if has_layouts and shape in LAYOUT_SHAPES:
            args = [kw[key] for key in ("q", "k", "v", "bias", "q_mask",
                                        "k_mask")] + [heads, rep]
            for layout in (1, 2):
                layouts[layout] = device_ms(
                    lambda: attn._launch(*args, layout=layout), iters=iters)

        nbytes = (2 * b * (nq + nk) * d * q.element_size()
                  + (0 if bias is None else bias.numel() * 4)
                  + kw["q_mask"].numel() + kw["k_mask"].numel())
        flops = 4 * b * nq * nk * d
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS[dtype] * 1e3
        bound_ms = max(bytes_ms, flops_ms)
        bound_by = "bytes" if bytes_ms >= flops_ms else "operations"
        lib = "refused" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"time fused_attention {shape} bf16 B={b} Nq={nq} Nk={nk} "
            f"D={d}: kernel {ms:.4f} ms (events), {dev_ms:.4f} ms "
            f"(profiler device time), plain {plain_ms:.4f} ms, sdpa {lib}, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB -> "
            f"{bytes_ms:.4f} ms, {flops / 1e9:.3f} GFLOP -> "
            f"{flops_ms:.4f} ms), {100 * bound_ms / dev_ms:.1f} % of bound")
        if layouts:
            log(f"  layouts by profiler device time (ms): " + ", ".join(
                f"{key} {val:.4f}" for key, val in layouts.items()))
        results[shape] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bound_ms,
                              bound_by=bound_by)
        results[shape].update({f"layout{key}_ms": val
                               for key, val in layouts.items()})
        del kw, q, k, v, bias
    per_fold = sum(results[s]["device_ms"] * c for s, c in
                   (("msa_row", 24), ("msa_col", 24), ("triangle", 48)))
    log(f"time fused_attention: {per_fold:.2f} ms of kernel device time "
        f"per fold (24 row + 24 column + 48 triangle launches); "
        f"{24 * results['msa_col_512']['device_ms']:.2f} ms per 512-bucket "
        f"fold (24 column launches)")
    record = dict(results["triangle"])
    for shape in K1_SHAPES:
        if shape != "triangle":
            record.update({f"{shape}_{key}": val
                           for key, val in results[shape].items()
                           if key != "bound_by"})
    return record


def sparse_specs():
    """The two K2 patterns held on the card: the default kernel policy's
    spec for the 512 bucket (block 32, window 1, one global block) and a
    banded block-128 one."""
    from alphafold2_tpu_torch import ModelConfig
    from alphafold2_tpu_torch.ops.block_sparse import KernelSpec
    from alphafold2_tpu_torch.serve.bucketing import default_policy
    from alphafold2_tpu_torch.serve.kernelpolicy import KernelPolicy
    policy = KernelPolicy.from_model_config(ModelConfig(),
                                            default_policy().edges)
    return {"default": policy.spec_for(SPARSE_BUCKET),
            "banded128": KernelSpec.banded(SPARSE_BUCKET, 128)}


def block_sparse_inputs(shape, spec, dtype, device, seed, d=64):
    """Inputs of one 512-bucket K2 launch (heads 8, D 64 unless `d` says
    otherwise): key masks with a padded tail and key rows masked in full
    (a padded alignment row; the padded rows of the pair map)."""
    heads, valid, n = 8, 437, SPARSE_BUCKET
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=device) * scale

    if shape == "msa_row":      # 5 alignment rows attend over residues
        fold = MSA_ROWS
        k_mask = (torch.arange(n, device=device) < valid)[None].expand(
            fold, n).clone()
        k_mask[3] = False
    else:                       # triangle attention over the pair map
        fold = n
        row = torch.arange(n, device=device) < valid
        k_mask = row[:, None] & row[None, :]
    b = fold * heads
    return dict(q=randn(b, n, d, scale=0.5).to(dtype),
                k=randn(b, n, d, scale=0.5).to(dtype),
                v=randn(b, n, d).to(dtype),
                plan=spec.device_plan(device), bias=randn(heads, n, n),
                bias_repeat=fold, k_mask=k_mask.contiguous(), heads=heads,
                scale=1.0)


def phase_check_block_sparse():
    """K2 against its plain version (in fp32 on the same values) at every
    row, at the 512 bucket's two K2 shapes, both patterns, both dtypes;
    one more call at the default scale."""
    from alphafold2_tpu_torch.ops import block_sparse as bs
    dev = torch.device("cuda")
    worst = {}
    cases = [(dtype, shape, pname, 1.0)
             for dtype in (torch.float32, torch.bfloat16)
             for shape in ("msa_row", "triangle")
             for pname in ("default", "banded128")]
    cases.append((torch.float32, "msa_row", "default", None))
    for dtype, shape, pname, scale in cases:
        spec = sparse_specs()[pname]
        kw = block_sparse_inputs(shape, spec, dtype, dev, seed=4)
        kw["scale"] = scale
        out = bs.block_sparse_attention(**kw)
        torch.cuda.synchronize()
        ref = bs.block_sparse_reference(**dict(kw, **{
            key: kw[key].float() for key in ("q", "k", "v")}))
        err = float((out.float() - ref).abs().max())
        del ref
        tol = TOLERANCE[dtype]
        log(f"check block_sparse {shape} {pname} ({spec.label}, live "
            f"{spec.live_fraction:.4f}) {str(dtype)[6:]} scale "
            f"{'default' if scale is None else scale} "
            f"B={kw['q'].shape[0]} N={kw['q'].shape[1]}: max abs err "
            f"{err:.3e} (tolerance {tol:.0e})")
        if not err <= tol or not torch.isfinite(out).all():
            raise AssertionError(f"block_sparse {shape} {pname} {dtype}: "
                                 f"max abs err {err} > {tol}")
        worst[dtype] = max(worst.get(dtype, 0.0), err)
    return worst


def block_sparse_bound(kw, spec):
    """(bound ms, 'bytes' | 'operations', bytes, flops) of one K2 call:
    q, k, v read and out written once, the live bias tiles, the key mask
    and the plan read once; the live blocks' two products."""
    q, bias = kw["q"], kw["bias"]
    b, n, d = q.shape
    live, blk = int(spec.pattern_array().sum()), spec.block
    nbytes = (4 * b * n * d * q.element_size()
              + bias.shape[0] * live * blk * blk * 4
              + kw["k_mask"].numel()
              + kw["plan"].cols.numel() * 4 + kw["plan"].counts.numel() * 4)
    flops = 4 * b * live * blk * blk * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (max(bytes_ms, flops_ms),
            "bytes" if bytes_ms >= flops_ms else "operations", nbytes, flops)


def sparse_sdpa_mask(kw, spec, dtype):
    """The additive mask (B, N, N) in `dtype` that makes one SDPA call
    compute what one K2 launch does: the bias replayed over the fold,
    -1e9 at masked keys, -inf in dead blocks."""
    from alphafold2_tpu_torch.ops import attention as attn
    q, bias, heads = kw["q"], kw["bias"], kw["heads"]
    b, n = q.shape[:2]
    live = torch.as_tensor(spec.token_mask(), device=q.device)
    add_mask = bias.reshape(-1, heads, n, n).repeat_interleave(
        kw["bias_repeat"], dim=0).reshape(b, n, n)
    keep = kw["k_mask"].repeat_interleave(heads, dim=0)[:, None, :]
    add_mask = add_mask.masked_fill(~keep, attn.MASK_VALUE)
    return add_mask.masked_fill(~live, float("-inf")).to(dtype)


def phase_time_block_sparse():
    """K2 at the 512 bucket's shapes in bf16 under the default policy's
    pattern (live 0.2891) and the banded block-128 one (live 0.875):
    kernel (CUDA events, and profiler device time per launch), K1 on the
    same shape with the pattern as an additive bias (the masked backend:
    the dense cost, both clocks), and the bound; under the default
    pattern also the plain version and an SDPA yardstick on the
    equivalent dense additive mask. The two patterns are two measured
    points of the K2/dense crossover in live fraction. The JSON record
    carries the default pattern's triangle shape and the rest under
    `<shape>_*` and `banded128_<shape>_*`."""
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.ops import block_sparse as bs
    dtype = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    for pname, spec in sparse_specs().items():
        for shape, iters in (("msa_row", 50), ("triangle", 10)):
            kw = block_sparse_inputs(shape, spec, dtype,
                                     torch.device("cuda"), seed=5)
            q, k, v, bias = kw["q"], kw["k"], kw["v"], kw["bias"]
            heads, rep, k_mask = kw["heads"], kw["bias_repeat"], \
                kw["k_mask"]
            b, n, d = q.shape
            run = lambda: bs.block_sparse_attention(**kw)
            ms = cuda_ms(run, iters=iters)
            dev_ms = device_ms(run, iters=iters)
            live = torch.as_tensor(spec.token_mask(), device=q.device)
            pattern_bias = (bias + torch.where(live, 0.0, attn.MASK_VALUE)
                            ).contiguous()
            dense = lambda: attn.fused_attention(
                q, k, v, bias=pattern_bias, q_mask=k_mask, k_mask=k_mask,
                heads=heads, bias_repeat=rep)
            dense_ms = cuda_ms(dense, iters=max(iters // 2, 3))
            dense_dev_ms = device_ms(dense, iters=max(iters // 2, 3))
            del pattern_bias
            entry = dict(ms=ms, device_ms=dev_ms, dense_k1_ms=dense_ms,
                         dense_k1_device_ms=dense_dev_ms)
            extra = ""
            if pname == "default":
                plain_ms = cuda_ms(lambda: bs.block_sparse_reference(**kw),
                                   iters=max(iters // 2, 3))
                # yardstick only: one library call on the equivalent mask
                add_mask = sparse_sdpa_mask(kw, spec, dtype)
                library_ms = cuda_ms(
                    lambda: sdpa(q, k, v, attn_mask=add_mask, scale=1.0),
                    iters=max(iters // 2, 3))
                del add_mask
                entry.update(plain_ms=plain_ms, library_ms=library_ms)
                extra = (f", plain {plain_ms:.4f} ms, sdpa "
                         f"{library_ms:.4f} ms")
            bound_ms, bound_by, nbytes, flops = block_sparse_bound(kw, spec)
            entry.update(bound_ms=bound_ms, bound_by=bound_by)
            log(f"time block_sparse {shape} {pname} bf16 B={b} N={n} D={d} "
                f"({spec.label}, live {spec.live_fraction:.4f}): kernel "
                f"{ms:.4f} ms (events), {dev_ms:.4f} ms (profiler device "
                f"time); K1 with the pattern as bias {dense_ms:.4f} ms "
                f"(events), {dense_dev_ms:.4f} ms (profiler){extra}, bound "
                f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.3f} GFLOP), {100 * bound_ms / dev_ms:.1f} % "
                f"of bound; K2 / dense {dev_ms / dense_dev_ms:.3f}")
            results[(pname, shape)] = entry
    row, tri = results[("default", "msa_row")], results[("default",
                                                         "triangle")]
    log(f"time block_sparse: {24 * row['device_ms'] + 48 * tri['device_ms']:.2f}"
        f" ms of K2 device time per 512-bucket fold (24 row + 48 triangle "
        f"launches), against {24 * row['dense_k1_device_ms'] + 48 * tri['dense_k1_device_ms']:.2f}"
        f" ms for K1 on the same shapes with the pattern as bias")
    record = dict(tri)
    for (pname, shape), entry in results.items():
        if (pname, shape) == ("default", "triangle"):
            continue
        prefix = shape if pname == "default" else f"{pname}_{shape}"
        record.update({f"{prefix}_{key}": val for key, val in entry.items()
                       if key != "bound_by"})
    return record


def perturb(model, seed, scale=0.05):
    """Seeded noise on every parameter, so the zero-initialised output
    projections do not hide the attention kernel's output."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_((torch.randn(p.shape, generator=g) * scale).to(p.device))


def small_features(rng, n, valid):
    """Every model input beyond seq/msa for the small parity fold: t=4
    templates with their angles (one missing, one partial), 16 extra rows,
    residue indices with a chain break, and pretrained sequence and MSA
    embeddings of two LM widths."""
    from alphafold2_tpu_torch.data.synthetic import synthetic_features
    feats = synthetic_features(rng, seq_len=n, valid=valid,
                               num_templates=TEMPLATES, extra_depth=16)
    feats["seq_index"] = torch.cat([torch.arange(n // 2),
                                    torch.arange(n // 2) + n])
    feats["seq_embed"] = torch.as_tensor(
        rng.standard_normal((1, n, 768), dtype=np.float32))
    feats["msa_embed"] = torch.as_tensor(
        rng.standard_normal((1, 3, n, 1024), dtype=np.float32))
    return feats


def k1_per_pass(model, full: bool) -> dict:
    """K1 launches of one pass, by path: 4 per trunk layer; with the
    features also 2 per template pair block application, 1 for the
    pointwise attention and 3 per extra-MSA layer (its ingoing triangle
    attention is global-query, plain PyTorch)."""
    paths = {"main trunk": 4 * len(model.net.layers)}
    if full:
        paths.update({
            "template pair stack": 2 * model.templates_embed_layers,
            "template pointwise": 1,
            "extra-MSA stack": 3 * len(model.extra_msa_evoformer.layers)})
    return paths


def phase_parity():
    """A small fp32 model: the card (kernel path) against the CPU (plain
    path), same weights and inputs; once on seq/MSA alone, once with every
    new input at once (templates, template angles, extra MSA, seq_index,
    sequence and MSA embeddings)."""
    from alphafold2_tpu_torch import Alphafold2, fold
    from alphafold2_tpu_torch.data.synthetic import synthetic_batch
    from alphafold2_tpu_torch.ops import attention as attn
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kw = dict(dim=32, depth=2, heads=2, dim_head=16, predict_coords=True,
              generator=torch.Generator().manual_seed(SEED))
    cpu_model = Alphafold2(**kw, device="cpu")
    perturb(cpu_model, SEED + 1)
    gpu_model = Alphafold2(**kw, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(SEED)
    batch = synthetic_batch(rng, seq_len=32, msa_depth=3, with_coords=False,
                            pad_fraction=0.25)          # 24 valid residues
    for full in (False, True):
        feats = small_features(rng, 32, 24) if full else {}
        ref = fold(cpu_model, **batch, num_recycles=2, device="cpu", **feats)
        attn.launch_count.reset()
        out = fold(gpu_model, **batch, num_recycles=2, device="cuda",
                   **feats)
        torch.cuda.synchronize()
        launches = attn.launch_count.value
        want = 3 * sum(k1_per_pass(gpu_model, full).values())
        err = float((out.coords.cpu() - ref.coords)[:, :24].abs().max())
        log(f"parity small fold (dim 32, depth 2, n 32, 2 recycles"
            f"{', every new input' if full else ''}) card vs cpu: coords "
            f"max abs err {err:.3e} (tolerance 1e-3), K1 launches "
            f"{launches} (expected {want})")
        if not err <= 1e-3:
            raise AssertionError(f"card fold differs from cpu fold: {err}")
        if launches != want:
            raise AssertionError(f"K1 launched {launches} times, expected "
                                 f"{want}")


def phase_parity_block_sparse():
    """A small fp32 model folded under a block-sparse spec: the card (K2)
    against the CPU (K2's plain version), same weights and inputs, at
    real residues (padded query rows are unspecified)."""
    from alphafold2_tpu_torch import Alphafold2, fold
    from alphafold2_tpu_torch.data.synthetic import synthetic_batch
    from alphafold2_tpu_torch.ops import block_sparse as bs
    from alphafold2_tpu_torch.ops.block_sparse import KernelSpec
    kw = dict(dim=32, depth=2, heads=2, dim_head=16, predict_coords=True,
              generator=torch.Generator().manual_seed(SEED))
    cpu_model = Alphafold2(**kw, device="cpu")
    perturb(cpu_model, SEED + 1)
    gpu_model = Alphafold2(**kw, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    batch = synthetic_batch(np.random.default_rng(SEED), seq_len=64,
                            msa_depth=3, with_coords=False,
                            pad_fraction=0.25)          # 48 valid residues
    spec = KernelSpec.banded(64, 16, window=0, num_global=1)
    ref = fold(cpu_model, **batch, num_recycles=2, device="cpu",
               kernel=spec)
    bs.launch_count.reset()
    out = fold(gpu_model, **batch, num_recycles=2, device="cuda",
               kernel=spec)
    torch.cuda.synchronize()
    launches = bs.launch_count.value
    err = float((out.coords.cpu() - ref.coords)[:, :48].abs().max())
    log(f"parity small block-sparse fold ({spec.label}, dim 32, depth 2, "
        f"n 64, 2 recycles) card vs cpu: coords max abs err {err:.3e} "
        f"(tolerance 1e-3), K2 launches {launches}")
    # MSA row + two triangle attentions, 2 layers, 3 passes
    if launches != 3 * 2 * 3:
        raise AssertionError(f"K2 launched {launches} times, expected 18")
    if not err <= 1e-3:
        raise AssertionError(f"card sparse fold differs from cpu: {err}")


def phase_serve():
    from alphafold2_tpu_torch import ModelConfig, fold
    from alphafold2_tpu_torch.data.synthetic import pad_to, synthetic_batch
    cfg = ModelConfig(predict_coords=True)
    model = cfg.build(device="cuda",
                      generator=torch.Generator().manual_seed(SEED))
    perturb(model, SEED + 1)
    log(f"serve: ModelConfig dim {cfg.dim} depth {cfg.depth} heads "
        f"{cfg.heads} dim_head {cfg.dim_head} bf16 {cfg.bfloat16}, "
        f"{sum(p.numel() for p in model.parameters())} parameters")
    expected = 4 * cfg.depth * (NUM_RECYCLES + 1)
    rng = np.random.default_rng(SEED + 2)
    launches = 0
    times = []
    for length in LENGTHS:
        req = synthetic_batch(rng, seq_len=length, msa_depth=MSA_ROWS,
                              with_coords=False)
        req = {key: pad_to(val, BUCKET, axis=val.dim() - 1)
               for key, val in req.items()}
        result, k2, count, seconds, peak = count_fold(
            lambda: fold(model, **req, num_recycles=NUM_RECYCLES))
        log(f"serve fold {length} residues (bucket {BUCKET}): "
            f"{seconds * 1e3:.1f} ms wall, peak memory "
            f"{peak / 2**30:.3f} GiB, fused_attention launches {count}")
        check_result(result, BUCKET)
        if (k2, count) != (0, expected):
            raise AssertionError(f"fused_attention launched {count} times "
                                 f"and block_sparse {k2} times in the "
                                 f"fold, expected {expected} and 0")
        launches += count
        times.append(seconds)
    return launches, times, model, cfg, req


def phase_fold_and_write(model):
    """`predict.fold_and_write` through a disk FoldCache and a Tracer: a
    miss (one fold of the batch of two, 96 K1 launches, PDBs that parse
    back to the fold's CA coords within 1e-3 A), then a hit (no launch,
    the same PDB bytes, source "cache"). Returns the numbers it printed."""
    import tempfile

    from alphafold2_tpu_torch.cache import FoldCache, fold_key
    from alphafold2_tpu_torch.data.native import parse_pdb
    from alphafold2_tpu_torch.data.synthetic import pad_to, synthetic_batch
    from alphafold2_tpu_torch.obs import Tracer
    from alphafold2_tpu_torch.predict import fold_and_write
    rng = np.random.default_rng(SEED + 5)
    lengths = LENGTHS[1:]
    reqs = [synthetic_batch(rng, seq_len=n, msa_depth=MSA_ROWS,
                            with_coords=False) for n in lengths]
    batch = {key: torch.cat([pad_to(r[key], BUCKET, axis=r[key].dim() - 1)
                             for r in reqs]) for key in reqs[0]}
    # four K1 attentions a trunk layer and pass, one fold of the batch
    expected = 4 * len(model.net.layers) * (NUM_RECYCLES + 1)
    tag = f"chip_smoke-seed{SEED}"
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache = FoldCache(disk_dir=os.path.join(tmp, "cache"))
        trace_path = os.path.join(tmp, "traces.jsonl")
        tracer = Tracer(jsonl_path=trace_path)
        runs = []
        for call in ("miss", "hit"):
            paths, k2, k1, seconds, _ = count_fold(lambda: fold_and_write(
                model, batch["seq"], os.path.join(tmp, f"{call}.pdb"),
                cache=cache, model_tag=tag, tracer=tracer,
                msa=batch["msa"], mask=batch["mask"],
                msa_mask=batch["msa_mask"], num_recycles=NUM_RECYCLES))
            runs.append((paths, k1, k2, seconds))
        tracer.close()
        stats = {k: v for k, v in cache.snapshot().items()
                 if k in ("hits", "misses", "puts")}
        with open(trace_path) as fh:
            records = [json.loads(line) for line in fh]
        (miss, k1_miss, k2_miss, miss_s), (hit, k1_hit, k2_hit, hit_s) = runs
        if (k1_miss, k2_miss, k1_hit, k2_hit) != (expected, 0, 0, 0):
            raise AssertionError(
                f"fold_and_write launches: miss K1 {k1_miss} K2 {k2_miss}, "
                f"hit K1 {k1_hit} K2 {k2_hit}; expected {expected} / 0")
        if [r["source"] for r in records] != ["fold", "cache"] or \
                [r["status"] for r in records] != ["ok", "ok"]:
            raise AssertionError(f"fold_and_write traces {records}")
        gap = 0.0
        for k, (a, b) in enumerate(zip(miss, hit)):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                text = fa.read()
                if text != fb.read():
                    raise AssertionError(f"hit PDB {b} differs from {a}")
            valid = batch["mask"][k].numpy()
            seq = batch["seq"][k].numpy()[valid]
            entry = cache.get(fold_key(
                seq, batch["msa"][k].numpy()[:, valid],
                num_recycles=NUM_RECYCLES, model_tag=tag))
            # the PDB has a residue for every token but the padding one
            written = entry.coords[seq != NUM_TOKENS_PAD]
            _, coords, _ = parse_pdb(text.decode())
            if coords.shape[0] != len(written) or \
                    not np.isfinite(entry.coords).all():
                raise AssertionError(f"PDB {a}: {coords.shape[0]} residues, "
                                     f"expected {len(written)}")
            gap = max(gap, float(np.abs(coords[:, 1] - written).max()))
        if not gap <= 1e-3:
            raise AssertionError(f"PDB CA coords {gap} A from the fold's")
        write_ms = [s["dur_s"] * 1e3 for r in records for s in r["spans"]
                    if s["name"] == "write"]
        disk_bytes = sum(os.path.getsize(os.path.join(d, f))
                         for d, _, files in os.walk(os.path.join(tmp,
                                                                 "cache"))
                         for f in files)
        out = {"miss_ms": miss_s * 1e3, "hit_ms": hit_s * 1e3,
               "write_ms": write_ms, "k1_launches_miss": k1_miss,
               "k1_launches_hit": k1_hit, "pdb_ca_gap_A": gap,
               "cache_disk_bytes": disk_bytes,
               "cache_memory_bytes": cache.bytes_resident,
               "cache": stats}
    log(f"fold-and-write batch {list(lengths)} (bucket {BUCKET}): miss "
        f"{out['miss_ms']:.1f} ms wall ({k1_miss} K1 launches), hit "
        f"{out['hit_ms']:.1f} ms wall ({k1_hit}), write spans "
        f"{[round(w, 3) for w in write_ms]} ms, PDB CA gap {gap:.2e} A, "
        f"cache {disk_bytes} bytes on disk / {cache.bytes_resident} in "
        f"memory, {out['cache']}")
    return out


def phase_step_snapshot(model, req):
    """fold_init, a host snapshot of the carry and its restore (byte-equal,
    on the same card), then 3 fold_steps from the restored carry against
    3 from the original. Returns the largest coordinate gap."""
    from alphafold2_tpu_torch.predict import (fold_init, fold_step,
                                              restore_step_state,
                                              snapshot_step_state,
                                              tree_flatten)
    inputs = dict(msa=req["msa"], mask=req["mask"], msa_mask=req["msa_mask"])
    state = fold_init(model, req["seq"], **inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = snapshot_step_state(state)
    t1 = time.perf_counter()
    restored = restore_step_state(snap)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    for a, b in zip(tree_flatten(restored)[0], tree_flatten(state)[0]):
        if a.device != b.device or a.dtype != b.dtype or \
                not torch.equal(a.view(torch.uint8), b.view(torch.uint8)):
            raise AssertionError(f"restored leaf {tuple(a.shape)} on "
                                 f"{a.device} differs from {b.device}")
    runs = []
    for carry in (state, restored):
        for _ in range(NUM_RECYCLES):
            carry = fold_step(model, req["seq"], carry.recyclables, **inputs)
        runs.append(carry.coords)
    gap = float((runs[0] - runs[1]).abs().max())
    nbytes = sum(val.nbytes for kind, val, _ in snap[1] if kind == "dev")
    log(f"step-snapshot: {len(snap[1])} leaves, {nbytes} bytes, snapshot "
        f"{(t1 - t0) * 1e3:.2f} ms, restore {(t2 - t1) * 1e3:.2f} ms, "
        f"restored on {restored.coords.device}; coords after "
        f"{NUM_RECYCLES} steps differ by {gap:.3e} from the uninterrupted "
        f"loop")
    if not gap <= 1e-3:
        raise AssertionError(f"resumed coords differ by {gap}")
    return gap


def phase_profile(run, title, unprofiled=5):
    """Where one fold's (or train step's) device time goes: torch.profiler
    over one call of `run`, kernel time summed by name; the device time
    of the kernels inside K1's backward recompute range is also given on
    its own line. The card's busy share is read against the median wall
    time of `unprofiled` calls of the same run, because the profiler
    slows the host that launches the kernels and so stretches the run it
    traces. Returns (busy ms, median wall ms, {label: (ms, calls)})."""
    from alphafold2_tpu_torch.ops.attention import BACKWARD_RANGE
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(unprofiled):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    wall_us = float(np.median(walls))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t0) * 1e6
    rows = {}
    # K1's backward recompute is an annotation, not a kernel: the device
    # time of its host-side range is the kernels launched inside it
    # (already counted under their own names)
    recompute = (0.0, 0)
    for e in prof.key_averages():
        if e.key == BACKWARD_RANGE:
            if e.device_type != DeviceType.CUDA:
                recompute = (e.device_time_total, e.count)
            continue
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        if re.search(r"fused_attention\w*_kernel", e.key):
            label = "fused_attention (K1)"
        elif re.search(r"block_sparse\w*_kernel", e.key):
            label = "block_sparse_attention (K2)"
        else:
            label = e.key[:80]
        us, calls = rows.get(label, (0.0, 0))
        rows[label] = (us + e.self_device_time_total, calls + e.count)
    busy_us = sum(us for us, _ in rows.values())
    log(f"profile {title}: device busy {busy_us / 1e3:.1f} ms; unprofiled "
        f"wall {wall_us / 1e3:.1f} ms (median of {unprofiled}: "
        f"{[round(w / 1e3, 1) for w in walls]}), busy "
        f"{100 * busy_us / wall_us:.1f} %; wall under the profiler "
        f"{traced_us / 1e3:.1f} ms")
    for label, (us, calls) in sorted(rows.items(), key=lambda r: -r[1][0])[:12]:
        log(f"  {us / 1e3:9.3f} ms {100 * us / max(busy_us, 1):5.1f} % "
            f"{calls:5d} x {label}")
    if recompute[1]:
        log(f"  {recompute[0] / 1e3:9.3f} ms "
            f"{100 * recompute[0] / max(busy_us, 1):5.1f} % "
            f"{recompute[1]:5d} x {BACKWARD_RANGE} (the kernels inside "
            f"it, counted above under their names)")
    table = {label: (us / 1e3, calls) for label, (us, calls) in rows.items()}
    table[BACKWARD_RANGE] = (recompute[0] / 1e3, recompute[1])
    return busy_us / 1e3, wall_us / 1e3, table


def count_fold(run):
    """Run one fold with both launch counters set to 0 just before it;
    returns (result, K2 launches, K1 launches, wall s, peak bytes)."""
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.ops import block_sparse as bs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attn.launch_count.reset()
    bs.launch_count.reset()
    t0 = time.perf_counter()
    result = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return (result, bs.launch_count.value, attn.launch_count.value,
            seconds, torch.cuda.max_memory_allocated())


def check_result(result, bucket):
    coords, conf = result.coords, result.confidence
    if tuple(coords.shape) != (1, bucket, 3) or \
            not torch.isfinite(coords).all():
        raise AssertionError(f"bad coords {tuple(coords.shape)}")
    if not torch.isfinite(result.distogram).all():
        raise AssertionError("non-finite distogram")
    if not ((conf >= 0) & (conf <= 1)).all():
        raise AssertionError("confidence outside [0, 1]")


def path_launches(model):
    """Forward hooks around the module of each K1 path of a full-feature
    pass (the main trunk, the template pair stack, the template pointwise
    attention, the extra-MSA stack) that add the K1 launches made inside
    each call to that path's tally. Returns the tally and the hooks'
    handles."""
    from alphafold2_tpu_torch.ops import attention as attn
    modules = {"main trunk": model.net,
               "template pair stack": model.template_pairwise_embedder,
               "template pointwise": model.template_pointwise_attn,
               "extra-MSA stack": model.extra_msa_evoformer}
    tally = dict.fromkeys(modules, 0)
    before = {}
    handles = []
    for name, module in modules.items():
        def pre(_module, _args, name=name):
            before[name] = attn.launch_count.value

        def post(_module, _args, _out, name=name):
            tally[name] += attn.launch_count.value - before[name]

        handles += [module.register_forward_pre_hook(pre),
                    module.register_forward_hook(post)]
    return tally, handles


def phase_fold_full(model):
    """The default ModelConfig folds through `predict.fold` with the full
    model's inputs: t=4 templates (templates_dim 32, 55 angle features;
    the last missing, the one before it partial), e=1024 extra-MSA rows,
    5 MSA rows, 3 recycles; requests of 256, 200 and 131 residues padded
    to the 256 bucket. Each fold must launch K1 the counted number of
    times on each path and give finite coords and distogram and a
    confidence in [0, 1]. Returns (K1 launches of the folds, walls in ms,
    peak bytes, the last request and its features)."""
    from alphafold2_tpu_torch import fold
    from alphafold2_tpu_torch.data.synthetic import (pad_to, synthetic_batch,
                                                     synthetic_features)
    passes = NUM_RECYCLES + 1
    want = {name: count * passes
            for name, count in k1_per_pass(model, True).items()}
    rng = np.random.default_rng(SEED + 6)
    tally, handles = path_launches(model)
    launches, walls, peaks = 0, [], []
    try:
        for length in LENGTHS:
            req = synthetic_batch(rng, seq_len=length, msa_depth=MSA_ROWS,
                                  with_coords=False)
            req = {key: pad_to(val, BUCKET, axis=val.dim() - 1)
                   for key, val in req.items()}
            feats = synthetic_features(rng, seq_len=BUCKET, valid=length,
                                       num_templates=TEMPLATES,
                                       extra_depth=EXTRA_ROWS)
            for name in tally:
                tally[name] = 0
            result, k2, count, seconds, peak = count_fold(
                lambda: fold(model, **req, num_recycles=NUM_RECYCLES,
                             **feats))
            log(f"fold-full {length} residues (bucket {BUCKET}, t="
                f"{TEMPLATES}, e={EXTRA_ROWS}): {seconds * 1e3:.1f} ms "
                f"wall, peak memory {peak / 2**30:.3f} GiB, K1 launches "
                f"{count} ({json.dumps(tally)})")
            check_result(result, BUCKET)
            if k2 or tally != want or count != sum(want.values()):
                raise AssertionError(
                    f"full-feature fold launched K1 {count} times "
                    f"({tally}) and K2 {k2} times, expected "
                    f"{sum(want.values())} ({want}) and 0")
            launches += count
            walls.append(seconds * 1e3)
            peaks.append(peak)
    finally:
        for handle in handles:
            handle.remove()
    return launches, walls, peaks, req, feats


def phase_executor(model, cfg):
    """The serving path: FoldExecutor under the default buckets and the
    default kernel policy (contact re-plans keep the top 15 % of blocks,
    so the re-planned pattern stays sparse whatever the random weights
    give). Returns the K2 and K1 launches of the three 512-bucket folds,
    the executor, the last 512 batch and its spec."""
    from alphafold2_tpu_torch.data.synthetic import synthetic_requests
    from alphafold2_tpu_torch.serve.bucketing import (BucketPolicy,
                                                      default_policy)
    from alphafold2_tpu_torch.serve.executor import FoldExecutor
    from alphafold2_tpu_torch.serve.kernelpolicy import KernelPolicy
    edges = default_policy().edges
    buckets = BucketPolicy(edges)
    policy = KernelPolicy.from_model_config(cfg, edges,
                                            contact_live_frac=0.15)
    log(f"executor: kernel policy {json.dumps(policy.snapshot()['buckets'])}")
    spec = policy.spec_for(SPARSE_BUCKET)
    if spec is None or policy.spec_for(BUCKET) is not None:
        raise AssertionError("the default policy must route only the 512 "
                             "bucket block-sparse")
    ex = FoldExecutor(model)
    t0 = time.perf_counter()
    fresh = ex.warmup([(BUCKET, 1, MSA_ROWS, NUM_RECYCLES)],
                      kernel=policy.spec_for(BUCKET))
    fresh += ex.warmup([(SPARSE_BUCKET, 1, MSA_ROWS, NUM_RECYCLES)],
                       kernel=spec)
    fresh += ex.warmup([(SPARSE_BUCKET, 1, MSA_ROWS, 0)], kernel=spec,
                       step_mode=True)
    log(f"executor: warm-up built {fresh} programs in "
        f"{time.perf_counter() - t0:.2f} s")
    if fresh != 4:
        raise AssertionError(f"warm-up built {fresh} programs, expected 4")

    rng = np.random.default_rng(SEED + 3)
    k2_total = k1_total = 0
    per_fold = 3 * cfg.depth * (NUM_RECYCLES + 1)
    for length in SPARSE_LENGTHS + (DENSE_LENGTH,):
        bucket = buckets.bucket_for(length)
        (req,) = synthetic_requests(rng, num=1, lengths=(length,),
                                    msa_depth=MSA_ROWS)
        batch, _ = buckets.assemble([req], bucket, 1, msa_depth=MSA_ROWS,
                                    device="cuda")
        kernel = policy.spec_for(bucket)
        result, k2, k1, seconds, peak = count_fold(
            lambda: ex.run(batch, NUM_RECYCLES, kernel=kernel))
        log(f"executor fold {length} residues (bucket {bucket}, "
            f"{'dense' if kernel is None else kernel.label}): "
            f"{seconds * 1e3:.1f} ms wall, peak memory "
            f"{peak / 2**30:.3f} GiB, K2 launches {k2}, K1 launches {k1}")
        check_result(result, bucket)
        want = (per_fold, cfg.depth * (NUM_RECYCLES + 1)) \
            if kernel is not None else (0, 4 * cfg.depth * (NUM_RECYCLES + 1))
        if (k2, k1) != want:
            raise AssertionError(f"fold of {length} launched K2 {k2} and K1 "
                                 f"{k1} times, expected {want}")
        if kernel is not None:
            k2_total, k1_total = k2_total + k2, k1_total + k1
            sparse_batch = batch

    # the contact flow: first pass under the static spec, the rest of
    # the recycles under a spec planned from that pass's distogram
    n = SPARSE_LENGTHS[-1]
    state, _, _, seconds, _ = count_fold(
        lambda: ex.run_init(sparse_batch, kernel=spec))
    log(f"executor step-mode init {n} residues: {seconds * 1e3:.1f} ms")
    t0 = time.perf_counter()
    contact = policy.contact_spec_for(
        SPARSE_BUCKET, state.distogram.float().cpu().numpy(), lengths=[n])
    plan_s = time.perf_counter() - t0
    if contact is None or contact.label == spec.label:
        raise AssertionError("the contact re-plan gave no new spec")
    log(f"executor contact re-plan: {contact.label}, live "
        f"{contact.live_fraction:.4f} ({int(contact.pattern_array().sum())}"
        f" blocks), planned on the host in {plan_s * 1e3:.1f} ms")
    for i in range(NUM_RECYCLES):
        state, k2, k1, seconds, _ = count_fold(
            lambda: ex.run_step(sparse_batch, state, i, kernel=contact))
        log(f"executor contact step {i}: {seconds * 1e3:.1f} ms wall, "
            f"K2 launches {k2}, K1 launches {k1}")
        if (k2, k1) != (3 * cfg.depth, cfg.depth):
            raise AssertionError(f"contact step launched K2 {k2} and K1 "
                                 f"{k1} times")
    check_result(state, SPARSE_BUCKET)
    stats = ex.stats()
    keys = stats["keys"]
    log(f"executor stats: hits {stats['hits']}, misses {stats['misses']}, "
        f"evictions {stats['evictions']}, keys {keys}")
    if not any(k[6] == "step" and k[7] == contact.label for k in keys):
        raise AssertionError("no step key carries the contact label")
    if stats["misses"] != len(set(keys)) or stats["evictions"]:
        raise AssertionError("misses must equal the distinct keys")
    return k2_total, k1_total, ex, sparse_batch, spec


# the scheduler phase's threaded traffic: one request of each length over
# the 512 and 256 buckets, from four client threads
SCHED_LENGTHS = (512, 437, 300, 256, 200, 131)
SCHED_DUPLICATE = 200
SCHED_CLIENTS = 4


def small_models(seed=SEED):
    """The parity phases' small fp32 model on the CPU and on the card,
    from the same perturbed weights."""
    from alphafold2_tpu_torch import Alphafold2
    kw = dict(dim=32, depth=2, heads=2, dim_head=16, predict_coords=True,
              generator=torch.Generator().manual_seed(seed))
    cpu_model = Alphafold2(**kw, device="cpu")
    perturb(cpu_model, seed + 1)
    gpu_model = Alphafold2(**kw, device="cuda")
    gpu_model.load_state_dict(cpu_model.state_dict())
    return cpu_model, gpu_model


def serve_requests(lengths, seed, rows=MSA_ROWS):
    from alphafold2_tpu_torch.data.synthetic import synthetic_requests
    return synthetic_requests(np.random.default_rng(seed), num=len(lengths),
                              lengths=lengths, msa_depth=rows)


def resolved_ok(resp, req, source=None):
    """A response that ended ok with finite coords of its request's
    length (and, when given, from `source`)."""
    return (resp.status == "ok" and resp.coords is not None
            and resp.coords.shape == (req.length, 3)
            and bool(np.isfinite(resp.coords).all())
            and (source is None or resp.source == source))


def phase_scheduler(model, cfg):
    """The serving front door on the card: the default ModelConfig behind
    FoldExecutor and the port's Scheduler (default buckets, the default
    KernelPolicy, max_batch_size 2, 5 MSA rows, 3 recycles, a memory
    FoldCache, a JSONL Tracer, RetryPolicy(xla_classify=True)), warmed
    up over every bucket. Four client threads submit one request of each SCHED_LENGTHS, a duplicate
    of 200 residues right behind its leader (coalesced) and again once it
    resolved (a cache hit); then a real CUDA OOM (an allocation larger
    than the card) is caught and classified transient, and the Scheduler
    serves one more request. Every 512
    batch must launch K2 72 and K1 24 times, every 256 batch K1 96 times.
    Then a small fp32 model served through the Scheduler against
    `predict.fold` on the CPU, step mode with early exit and streaming,
    and the injected faults (a transient error, a poison input, a
    watchdog fire). Returns the numbers it printed."""
    import tempfile
    import threading

    from alphafold2_tpu_torch import serve
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.ops import block_sparse as bs
    edges = serve.default_policy().edges
    passes = NUM_RECYCLES + 1
    per_fold = {SPARSE_BUCKET: (3 * cfg.depth * passes, cfg.depth * passes),
                BUCKET: (0, 4 * cfg.depth * passes)}
    reqs = serve_requests(SCHED_LENGTHS, SEED + 7)
    leader = reqs[SCHED_LENGTHS.index(SCHED_DUPLICATE)]

    def twin(r):
        return serve.FoldRequest(seq=r.seq.copy(), msa=r.msa.copy())

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        registry = serve.MetricsRegistry()
        metrics = serve.ServeMetrics(os.path.join(tmp, "batches.jsonl"),
                                     registry=registry)
        tracer = serve.Tracer(jsonl_path=os.path.join(tmp, "traces.jsonl"))
        sched = serve.Scheduler(
            serve.FoldExecutor(model), serve.BucketPolicy(edges),
            serve.SchedulerConfig(max_batch_size=2, msa_depth=MSA_ROWS,
                                  num_recycles=NUM_RECYCLES),
            metrics, cache=serve.FoldCache(registry=registry),
            model_tag=f"chip_smoke-seed{SEED}", tracer=tracer,
            registry=registry, retry=serve.RetryPolicy(xla_classify=True),
            kernel_policy=serve.KernelPolicy.from_model_config(cfg, edges))
        tickets, lock = [], threading.Lock()

        def client(i):
            for r in reqs[i::SCHED_CLIENTS]:
                pair = [(r, sched.submit(r), "fold")]
                if r is leader:
                    pair.append((r, sched.submit(twin(r)), "coalesced"))
                with lock:
                    tickets.extend(pair)

        with sched:
            # every bucket's program once, on a zero batch, as a server
            # does before it takes traffic
            t0 = time.perf_counter()
            fresh = sched.warmup()
            warm_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            attn.launch_count.reset()
            bs.launch_count.reset()
            t0 = time.perf_counter()
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(SCHED_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            resps = [(r, t.result(timeout=600), src)
                     for r, t, src in tickets]
            resps.append((leader, sched.submit(twin(leader)).result(
                timeout=600), "cache"))
            traffic_s = time.perf_counter() - t0
            # more than the card holds (the caching allocator could
            # serve an allocation past mem_get_info's free bytes from
            # memory it already reserved)
            total = torch.cuda.get_device_properties(0).total_memory
            try:
                torch.empty(total + (1 << 30), dtype=torch.uint8,
                            device="cuda")
                raise AssertionError("an allocation past the card's "
                                     "memory succeeded")
            except torch.cuda.OutOfMemoryError as exc:
                verdict = serve.classify(repr(exc))
            after = serve_requests((131,), SEED + 8)[0]
            resps.append((after, sched.submit(after).result(timeout=600),
                          "fold"))
        # after the stop: the worker records a batch after its tickets
        stats = sched.serve_stats()
        torch.cuda.synchronize()
        k1, k2 = attn.launch_count.value, bs.launch_count.value
        tracer.close()
        metrics.close()
        with open(os.path.join(tmp, "batches.jsonl")) as fh:
            batches = [json.loads(line) for line in fh]
        with open(os.path.join(tmp, "traces.jsonl")) as fh:
            traces = [json.loads(line) for line in fh]
    bad = [(r.length, resp.status, resp.source, resp.error)
           for r, resp, src in resps if not resolved_ok(resp, r, src)]
    if bad:
        raise AssertionError(f"scheduler responses not ok: {bad}")
    if verdict is None or not verdict.transient:
        raise AssertionError(f"a real CUDA OOM classified {verdict}")
    walls = {}
    for rec in batches:
        walls.setdefault(int(rec["bucket_len"]), []).append(
            rec["batch_latency_s"] * 1e3)
    if set(walls) - set(per_fold):
        raise AssertionError(f"batches in buckets {sorted(walls)}")
    want = [sum(per_fold[b][i] * len(w) for b, w in walls.items())
            for i in (0, 1)]
    lat = [resp.latency_s * 1e3 for _, resp, _ in resps]
    # (length, how it resolved, ms) of every ticket, in completion order
    done = sorted(((r.length, src, round(ms, 1))
                   for (r, _, src), ms in zip(resps, lat)),
                  key=lambda x: x[2])
    folded = [tr for tr in traces if tr["source"] == "fold"]
    per_bucket = {b: [round(x, 1) for x in w]
                  for b, w in sorted(walls.items())}
    resilience = {k: v for k, v in stats["resilience"].items()
                  if not isinstance(v, dict)}
    log(f"scheduler warm-up: {fresh} programs built in {warm_s:.2f} s")
    log(f"scheduler traffic {list(SCHED_LENGTHS)} + duplicate of "
        f"{SCHED_DUPLICATE} (coalesced, then cache) from {SCHED_CLIENTS} "
        f"threads, then one more after a real CUDA OOM (classified "
        f"{verdict.reason}, transient): {len(resps)} tickets ok in "
        f"{traffic_s:.2f} s; latency (ms) of each {done}, p50 "
        f"{np.percentile(lat, 50):.1f}, p99 {np.percentile(lat, 99):.1f} "
        f"over these {len(lat)}; batches "
        f"{ {b: len(w) for b, w in per_bucket.items()} }, fold wall per "
        f"bucket (ms) {per_bucket}; "
        f"K2 launches {k2} (expected {want[0]}), K1 launches {k1} "
        f"(expected {want[1]}); {len(traces)} traces, "
        f"{len(folded)} folded")
    log(f"scheduler serve_stats: served {stats['served']}, batches "
        f"{stats['batches']}, cache hits {stats['cache']['hits']} / "
        f"misses {stats['cache']['misses']} / coalesced "
        f"{stats['cache']['coalesced']}, resilience {resilience}, padding "
        f"waste {stats['padding_waste']:.3f}")
    if [k2, k1] != want:
        raise AssertionError(f"scheduler traffic launched K2 {k2} and K1 "
                             f"{k1} times, expected {want}")
    out.update(latency_ms=[list(x) for x in done],
               latency_p50_ms=float(np.percentile(lat, 50)),
               latency_p99_ms=float(np.percentile(lat, 99)),
               batches={str(b): len(w) for b, w in walls.items()},
               fold_wall_ms={str(b): w for b, w in walls.items()},
               k1_launches=k1, k2_launches=k2, traffic_s=traffic_s,
               warmup_s=warm_s,
               oom_verdict=verdict.reason)
    out["parity_err"] = scheduler_parity()
    out["recycles_skipped"] = scheduler_step_mode(model)
    out["faults"] = scheduler_faults()
    return out


def scheduler_parity():
    """A small fp32 model served through the Scheduler on the card
    against `predict.fold` on the CPU from the same weights, at real
    residues (tolerance 1e-3)."""
    from alphafold2_tpu_torch import fold, serve
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu_model, gpu_model = small_models()
    (req,) = serve_requests((24,), SEED + 9, rows=3)
    policy = serve.BucketPolicy((32,))
    batch, _ = policy.assemble([req], 32, 1, msa_depth=3, device="cpu")
    ref = fold(cpu_model, **batch, num_recycles=2, device="cpu")
    sched = serve.Scheduler(
        serve.FoldExecutor(gpu_model), policy,
        serve.SchedulerConfig(max_batch_size=1, msa_depth=3,
                              num_recycles=2),
        registry=serve.MetricsRegistry())
    with sched:
        resp = sched.submit(req).result(timeout=600)
    if not resolved_ok(resp, req):
        raise AssertionError(f"scheduler parity fold: {resp.status} "
                             f"{resp.error}")
    err = float(np.abs(resp.coords - ref.coords[0, :24].numpy()).max())
    log(f"scheduler parity (dim 32, depth 2, n 24 in bucket 32, 2 "
        f"recycles) card vs cpu: coords max abs err {err:.3e} (tolerance "
        f"1e-3)")
    if not err <= 1e-3:
        raise AssertionError(f"scheduler fold differs from cpu fold: {err}")
    return err


def scheduler_step_mode(model):
    """The default model in step mode: RecyclePolicy(converge_tol > 0,
    stream=True) on two 256-bucket requests; progressive results reach
    the tickets and the early exits are counted in
    serve_recycles_skipped_total."""
    from alphafold2_tpu_torch import serve
    registry = serve.MetricsRegistry()
    sched = serve.Scheduler(
        serve.FoldExecutor(model), serve.BucketPolicy((BUCKET,)),
        serve.SchedulerConfig(max_batch_size=2, msa_depth=MSA_ROWS,
                              num_recycles=NUM_RECYCLES),
        registry=registry,
        recycle_policy=serve.RecyclePolicy(converge_tol=1e3, stream=True))
    reqs = serve_requests((200, 131), SEED + 10)
    with sched:
        tickets = [sched.submit(r) for r in reqs]
        resps = [t.result(timeout=600) for t in tickets]
    skipped = registry.counter("serve_recycles_skipped_total").value()
    progress = [len(t.progress()) for t in tickets]
    log(f"scheduler step mode (converge_tol 1e3, stream): recycles run "
        f"{[r.recycles for r in resps]} of {NUM_RECYCLES}, progressive "
        f"results {progress}, serve_recycles_skipped_total {skipped:g}")
    if not all(resolved_ok(r, q) for r, q in zip(resps, reqs)) or \
            min(progress) < 1 or not skipped > 0:
        raise AssertionError("step mode: no early exit or no progress")
    return skipped


def scheduler_faults():
    """Injected faults on the small model's Scheduler on the card: one
    transient executor error (retried, ends ok), one poison input (ends
    "poisoned" after bisection while its batch-mate ends ok) and a
    host-side latency that fires the watchdog (the executor is rebuilt
    and the batch ends ok). The seeds make each plan fire on its first
    draw only."""
    from alphafold2_tpu_torch import serve
    _, gpu_model = small_models()
    results = {}
    cases = (
        ("transient", dict(seed=10, exec_error_rate=0.5), {}, None),
        ("poison", dict(seed=0), {}, "poison"),
        ("watchdog", dict(seed=19, exec_latency_rate=0.5,
                          exec_latency_s=3.0), dict(watchdog_s=1.0), None))
    for name, plan_kw, retry_kw, poison in cases:
        registry = serve.MetricsRegistry()
        plan = serve.FaultPlan(registry=registry, **plan_kw)
        reqs = serve_requests((24, 20), SEED + 11, rows=3)
        if poison:
            plan.add_poison(reqs[0].seq)
        sched = serve.Scheduler(
            serve.FoldExecutor(gpu_model, faults=plan.arm()),
            serve.BucketPolicy((32,)),
            serve.SchedulerConfig(max_batch_size=2, max_wait_ms=200.0,
                                  msa_depth=3, num_recycles=1),
            registry=registry,
            retry=serve.RetryPolicy(max_attempts=3, backoff_base_s=0.01,
                                    **retry_kw))
        with sched:
            resps = [t.result(timeout=600)
                     for t in [sched.submit(r) for r in reqs]]
            res = sched.serve_stats()["resilience"]
        statuses = [r.status for r in resps]
        want = ["poisoned", "ok"] if poison else ["ok", "ok"]
        counts = {k: res[k] for k in ("retries", "bisections",
                                      "watchdog_fires", "executor_rebuilds")}
        injected = {k: v for k, v in plan.snapshot()["injected"].items()
                    if v}
        log(f"scheduler fault {name}: statuses {statuses}, attempts "
            f"{[r.attempts for r in resps]}, injected {injected}, {counts}")
        if statuses != want or (name == "watchdog" and
                                counts["watchdog_fires"] != 1):
            raise AssertionError(f"fault {name}: {statuses}, {counts}")
        results[name] = dict(statuses=statuses, **counts)
        if name == "watchdog":
            # the abandoned attempt sleeps out its latency, then runs
            time.sleep(plan.exec_latency_s)
            torch.cuda.synchronize()
    return results


# the contract configuration's K1 shapes: b=1, 256 residues, 5 MSA rows,
# heads 8, dim_head 64 (the 256 bucket's fold shapes)
TRAIN_K1_SHAPES = ("triangle", "msa_row", "msa_col")
TRAIN_STEPS = 30


# the fleet phases: the scheduler phase's lengths over two replicas, the
# serving tiers on one Scheduler, and two replica processes
FLEET_LENGTHS = SCHED_LENGTHS
FLEET_BULK_LENGTHS = (256, 200)
FLEET_CASCADE_LENGTH = 100
# the replica processes' JAX widths (heads 2, dim_head 16; K1 at D = 16)
PROC_MODEL = {"dim": 32, "depth": 1, "msa_depth": 3}
PROC_BUCKETS = (32, 64)
PROC_LENGTHS = (24, 57, 31, 64)


def peak_gib():
    """The card's peak allocated memory since the last reset, in GiB."""
    return torch.cuda.max_memory_allocated() / 2**30


def reset_peak():
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def reset_launches():
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.ops import block_sparse as bs
    torch.cuda.synchronize()
    attn.launch_count.reset()
    bs.launch_count.reset()


def read_launches():
    """(K1, K2) launches since the last reset_launches()."""
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.ops import block_sparse as bs
    torch.cuda.synchronize()
    return attn.launch_count.value, bs.launch_count.value


def require_launches(phase, k1, k2):
    """A phase that folds in both buckets launched both kernels."""
    if k1 <= 0 or k2 <= 0:
        raise AssertionError(f"{phase}: K1 launched {k1} and K2 {k2} "
                             f"times; both must be positive")


def outcome_counts(registry, name, labels):
    """{label value: count} of one counter of `registry`."""
    return {s["labels"][labels[-1]]: s["value"] for s in
            registry.counter(name, "", labels).samples()}


def completion_ms(done):
    """(length, source, ms) of each ticket in completion order."""
    return [list(x) for x in sorted(done, key=lambda x: x[2])]


def phase_fleet(model, cfg):
    """An InProcessFleet of two replicas on the card, each a FoldExecutor
    over the default ModelConfig with the default buckets and
    KernelPolicy (the 512 bucket on K2), a FrontDoorServer on 127.0.0.1
    in front of each replica's Scheduler, and HttpTransport clients. The
    FLEET_LENGTHS requests split across the two doors: the 512-bucket
    ones alternate, the 256-bucket ones go alternately to the replica
    owning their key (folded there) and to the other one (forwarded).
    Then a twin of each 256-bucket request goes, as a request that has
    taken its one hop (as a replica with a stale ring would send it), to
    the replica that does not own it: it may not forward again, so it is
    served from that replica's cache — its own memory when it forwarded
    the original, else the owner's peer tier. Then a rollout
    (`bump_model_tag`), after which a peer fetch under the old tag gets
    409. Returns the numbers it printed."""
    from alphafold2_tpu_torch import fleet, serve
    edges = serve.default_policy().edges
    registry = serve.MetricsRegistry()
    tag = f"chip_smoke-fleet-seed{SEED}"
    fl = fleet.InProcessFleet(
        lambda: serve.FoldExecutor(model), serve.BucketPolicy(edges),
        serve.SchedulerConfig(max_batch_size=2, msa_depth=MSA_ROWS,
                              num_recycles=NUM_RECYCLES),
        n_replicas=2, model_tag=tag, registry=registry,
        kernel_policy=serve.KernelPolicy.from_model_config(cfg, edges))
    reqs = serve_requests(FLEET_LENGTHS, SEED + 9)
    doors = []
    out = {}
    with fl:
        t0 = time.perf_counter()
        fresh = fl.warmup()
        warm_s = time.perf_counter() - t0
        try:
            for r in fl.replicas:
                doors.append(fleet.FrontDoorServer(
                    r.scheduler, rollout=fl.registry.rollout,
                    replica_id=r.replica_id, metrics=registry).start())
            clients = [fleet.HttpTransport(d.url, rollout=fl.registry.rollout,
                                           metrics=registry) for d in doors]
            reset_peak()
            reset_launches()
            t0 = time.perf_counter()
            done, lock = [], threading.Lock()

            def send(req, door, kind):
                sent = time.perf_counter()
                ticket = clients[door].submit(req)

                def mark(resp):
                    with lock:
                        done.append((req.length, f"{kind}:{resp.source}",
                                     round((time.perf_counter() - sent)
                                           * 1e3, 1)))
                ticket.add_done_callback(mark)
                return ticket

            keys = [fl.replicas[0].scheduler._cache_key_for(r)
                    for r in reqs]
            owner = [int(fl.replicas[0].router.owner_for(k)[1:])
                     for k in keys]
            short = [i for i, r in enumerate(reqs) if r.length <= BUCKET]
            entry = [(owner[i] if short.index(i) % 2 == 0
                      else 1 - owner[i]) if i in short else i % 2
                     for i in range(len(reqs))]
            first = [(r, d, send(r, d, "burst"))
                     for r, d in zip(reqs, entry)]
            first = [(r, door, t.result(timeout=600))
                     for r, door, t in first]
            twins = [(reqs[i], 1 - owner[i]) for i in short]
            second = [(r, send(serve.FoldRequest(seq=r.seq.copy(),
                                                 msa=r.msa.copy(),
                                                 forwarded=True),
                               other, "twin")) for r, other in twins]
            second = [(r, t.result(timeout=600)) for r, t in second]
            traffic_s = time.perf_counter() - t0
            k1, k2 = read_launches()
            peak = peak_gib()
            epoch = fl.bump_model_tag(f"{tag}@v2")
            straggler = fleet.PeerCacheClient(
                fl.registry, "r0", metrics=serve.MetricsRegistry(),
                rollout=fleet.RolloutState(tag,
                                           registry=serve.MetricsRegistry()))
            stale = [straggler.get(keys[i]) for i in short]
            after = serve_requests((131,), SEED + 10)[0]
            after_resp = send(after, 0, "after-rollout").result(timeout=600)
        finally:
            for d in doors:
                d.stop()
    stats = fl.stats()
    served = outcome_counts(registry, "fleet_peer_served_total",
                            ("replica", "outcome"))
    forwards = sum(outcome_counts(registry, "fleet_forwards_total",
                                  ("peer",)).values())
    bad = [(r.length, resp.status, resp.source, resp.error)
           for r, _, resp in first if not resolved_ok(resp, r)]
    bad += [(r.length, resp.status, resp.source, resp.error)
            for r, resp in second if not resolved_ok(resp, r, "cache")]
    if not resolved_ok(after_resp, after):
        bad.append((after.length, after_resp.status, after_resp.source,
                    after_resp.error))
    if bad:
        raise AssertionError(f"fleet responses not ok: {bad}")
    peer_hits = stats["aggregate"]["peer_hits"]
    log(f"fleet warm-up: {fresh} programs built in {warm_s:.2f} s")
    log(f"fleet traffic {list(FLEET_LENGTHS)} over two front doors, then "
        f"{len(second)} twins at the non-owner: {len(first) + len(second)} "
        f"tickets ok in {traffic_s:.2f} s; submit-to-resolve (ms) in "
        f"completion order {completion_ms(done[:len(first) + len(second)])}")
    log(f"fleet: sources {[resp.source for _, _, resp in first]} then "
        f"{[resp.source for _, resp in second]}; forwards {forwards}, peer "
        f"hits {peer_hits}, rollout to epoch {epoch}: old-tag fetches "
        f"{['miss' if s is None else 'hit' for s in stale]}, peer 409s "
        f"{served.get('stale_tag', 0)}, after the rollout "
        f"{after_resp.source}; K1 launches {k1}, K2 launches {k2}; peak "
        f"memory {peak:.3f} GiB; aggregate {stats['aggregate']}")
    require_launches("fleet", k1, k2)
    if forwards < 1 or peer_hits < 1 or served.get("stale_tag", 0) < 1 \
            or any(s is not None for s in stale):
        raise AssertionError(
            f"fleet: forwards {forwards}, peer hits {peer_hits}, 409s "
            f"{served.get('stale_tag', 0)}; each must be at least 1, and "
            f"no old-tag fetch may hit")
    out.update(k1_launches=k1, k2_launches=k2, forwards=forwards,
               peer_hits=peer_hits, stale_409=served.get("stale_tag", 0),
               completion_ms=completion_ms(done), traffic_s=traffic_s,
               warmup_s=warm_s, peak_gib=peak,
               sources=[resp.source for _, _, resp in first]
               + [resp.source for _, resp in second])
    return out


def phase_serve_tiers(model, cfg):
    """One Scheduler at the default ModelConfig on the card with the SLO
    engine, the bulk tier (BulkPolicy over step-mode recycling, as
    tests/test_bulk.py enables it), the cascade (a draft Scheduler over
    `draft_preset(ModelConfig())`: dim 128, depth 2, sharing the
    FoldCache under its own tag) and a PreemptionWatcher on a
    FileNoticeSource. Traffic: the FLEET_LENGTHS requests and one more
    (all online, so each folds on the draft first and is accepted or
    escalated), and two bulk requests; then the notice file is written
    and the scheduler must enter reclaim mode. Returns the numbers it
    printed."""
    import dataclasses
    import tempfile

    from alphafold2_tpu_torch import obs, serve
    from alphafold2_tpu_torch.config import draft_preset
    edges = serve.default_policy().edges
    dcfg = dataclasses.replace(draft_preset(cfg), predict_coords=True)
    draft_model = dcfg.build(device="cuda",
                             generator=torch.Generator().manual_seed(SEED + 3))
    perturb(draft_model, SEED + 4)
    tag = f"chip_smoke-tiers-seed{SEED}"
    reqs = serve_requests(FLEET_LENGTHS + (FLEET_CASCADE_LENGTH,), SEED + 11)
    bulk = [serve.FoldRequest(seq=r.seq, msa=r.msa, qos="bulk") for r in
            serve_requests(FLEET_BULK_LENGTHS, SEED + 12)]
    with tempfile.TemporaryDirectory() as tmp:
        registry = serve.MetricsRegistry()
        cache = serve.FoldCache(registry=registry)
        draft = serve.build_draft_scheduler(
            serve.FoldExecutor(draft_model), serve.BucketPolicy(edges),
            config=serve.SchedulerConfig(max_batch_size=2,
                                         msa_depth=MSA_ROWS, num_recycles=1,
                                         confidence_summary=True),
            model_tag=f"{tag}#draft", cache=cache,
            kernel_policy=serve.KernelPolicy.from_model_config(dcfg, edges))
        slo = obs.SLOEngine(obs.SLOPolicy.parse(
            "256=30000,512=60000,all=60000", window_s=600.0),
            registry=registry)
        sched = serve.Scheduler(
            serve.FoldExecutor(model), serve.BucketPolicy(edges),
            serve.SchedulerConfig(max_batch_size=2, msa_depth=MSA_ROWS,
                                  num_recycles=NUM_RECYCLES),
            serve.ServeMetrics(registry=registry), cache=cache,
            model_tag=tag, registry=registry,
            kernel_policy=serve.KernelPolicy.from_model_config(cfg, edges),
            recycle_policy=serve.RecyclePolicy(converge_tol=0.0),
            retry=serve.RetryPolicy(backoff_base_s=0.0, jitter=0.0),
            slo=slo, bulk=serve.BulkPolicy(check_interval_s=0.0),
            cascade=serve.CascadePolicy(draft=draft))
        notice = os.path.join(tmp, "preempt.notice")
        seen = []
        with sched:
            t0 = time.perf_counter()
            fresh = sched.warmup() + draft.warmup()
            warm_s = time.perf_counter() - t0
            watcher = serve.PreemptionWatcher(
                [serve.FileNoticeSource(notice, grace_s=30.0)],
                scheduler=sched, on_notice=seen.append, poll_s=0.05).start()
            reset_peak()
            reset_launches()
            t0 = time.perf_counter()
            tickets = [(r, sched.submit(r)) for r in reqs + bulk]
            resps = [(r, t.result(timeout=900)) for r, t in tickets]
            traffic_s = time.perf_counter() - t0
            k1, k2 = read_launches()
            peak = peak_gib()
            report = slo.report()
            with open(notice, "w") as fh:
                json.dump({"grace_s": 30.0, "detail": "chip_smoke"}, fh)
            deadline = time.monotonic() + 30
            while not seen and time.monotonic() < deadline:
                time.sleep(0.05)
            watcher.stop()
            stats = sched.serve_stats()
            try:
                sched.submit(serve_requests((FLEET_CASCADE_LENGTH,),
                                            SEED + 13)[0])
                refused = False
            except serve.DrainingError:
                refused = True
            complete = sched.drain(grace_s=10.0)
    bad = [(r.length, resp.status, resp.source, resp.error)
           for r, resp in resps if not resolved_ok(resp, r)]
    if bad:
        raise AssertionError(f"serve-tiers responses not ok: {bad}")
    casc = stats["cascade"]
    bulk_stats = stats["bulk"]
    reclaim = stats.get("preemption", {})
    done = completion_ms([(r.length, f"{r.qos}:{resp.tier or resp.source}",
                           round(resp.latency_s * 1e3, 1))
                          for r, resp in resps])
    log(f"serve-tiers warm-up: {fresh} programs built in {warm_s:.2f} s; "
        f"draft ModelConfig dim {dcfg.dim} depth {dcfg.depth} heads "
        f"{dcfg.heads} dim_head {dcfg.dim_head}")
    log(f"serve-tiers traffic {list(FLEET_LENGTHS) + [FLEET_CASCADE_LENGTH]}"
        f" online (cascaded) + bulk {list(FLEET_BULK_LENGTHS)}: "
        f"{len(resps)} tickets ok in {traffic_s:.2f} s; submit-to-resolve "
        f"(ms) in completion order {done}")
    log(f"serve-tiers: drafts accepted {casc['draft_accepted']}, escalated "
        f"{casc['escalated']}, draft errors {casc['draft_errors']}, "
        f"cross-tier hits {casc['cross_tier_hits']}; bulk admits "
        f"{bulk_stats['admits']}, yields {bulk_stats['yields']}; K1 "
        f"launches {k1}, K2 launches {k2}; peak memory {peak:.3f} GiB")
    log(f"serve-tiers SLO report: {json.dumps(report['classes'])}")
    log(f"serve-tiers preemption: notice {seen[0] if seen else None}, "
        f"reclaiming {reclaim.get('reclaiming')}, submit refused "
        f"{refused}, drain complete {complete}")
    require_launches("serve-tiers", k1, k2)
    if bulk_stats["admits"] != len(bulk) \
            or casc["draft_accepted"] + casc["escalated"] < 1 \
            or casc["cross_tier_hits"] != 0 or not report["classes"] \
            or not seen or not reclaim.get("reclaiming") or not refused:
        raise AssertionError(
            f"serve-tiers: bulk {bulk_stats}, cascade {casc}, SLO classes "
            f"{list(report['classes'])}, notice {seen}, reclaim {reclaim}, "
            f"refused {refused}")
    return {"k1_launches": k1, "k2_launches": k2,
            "draft_accepted": casc["draft_accepted"],
            "escalated": casc["escalated"],
            "bulk_admits": bulk_stats["admits"],
            "bulk_yields": bulk_stats["yields"],
            "slo": report["classes"], "reclaiming": reclaim["reclaiming"],
            "completion_ms": done, "traffic_s": traffic_s,
            "warmup_s": warm_s, "peak_gib": peak}


def phase_procfleet():
    """Two replica processes (`python -m alphafold2_tpu_torch.fleet.
    procfleet`) at the JAX package's replica widths on the card, which
    load the kernels this process built. PROC_LENGTHS go through the
    front doors (FleetClient); one replica is killed with -9, one
    FleetController reconcile restores the quorum (a new replica), one
    more request is served, and SIGTERM drains the live replicas, each
    of which must exit 0."""
    import tempfile

    from alphafold2_tpu_torch import serve
    from alphafold2_tpu_torch.fleet.controlplane import FleetController
    from alphafold2_tpu_torch.fleet.procfleet import FleetClient, ProcFleet
    from alphafold2_tpu_torch.fleet.scaling import ScalingPolicy
    rng = np.random.default_rng(SEED + 14)
    reqs = [serve.FoldRequest(
        seq=rng.integers(0, 20, n).astype(np.int32),
        msa=rng.integers(0, 20, (PROC_MODEL["msa_depth"], n)).astype(
            np.int32)) for n in PROC_LENGTHS]
    with tempfile.TemporaryDirectory() as tmp:
        fl = ProcFleet(2, os.path.join(tmp, "run"), buckets=PROC_BUCKETS,
                       model=dict(PROC_MODEL))
        rcs, logs = None, {}
        try:
            t0 = time.perf_counter()
            fl.start(timeout_s=300)
            boot_s = time.perf_counter() - t0
            client = FleetClient([h.frontdoor_url for h in fl.replicas],
                                 result_timeout_s=120)
            t0 = time.perf_counter()
            resps = [client.fold(r, hint=i) for i, r in enumerate(reqs)]
            traffic_s = time.perf_counter() - t0
            devices = [fl.stats(i)["identity"] for i in range(2)]
            killed_rc = fl.kill(1)
            ctrl = FleetController(
                fl, policy=ScalingPolicy(min_replicas=2, max_replicas=3,
                                         cooldown_s=5.0),
                probe_timeout_s=10.0, registry=serve.MetricsRegistry())
            t0 = time.perf_counter()
            rec = ctrl.reconcile()
            fl.wait_ready([2], timeout_s=300)
            healthy = ctrl.reconcile()["healthy"]
            restore_s = time.perf_counter() - t0
            last = client.fold(reqs[0], hint=1)
        finally:
            fl.stop(timeout_s=120)
            rcs = [h.proc.returncode if h.proc is not None else None
                   for h in fl.replicas]
            for h in fl.replicas:
                with open(h.log_path) as fh:
                    logs[h.replica_id] = fh.read()[-4000:]
    bad = [(r.length, resp.status, resp.error)
           for r, resp in zip(reqs + [reqs[0]], resps + [last])
           if not resolved_ok(resp, r)]
    log(f"procfleet: two replicas (dim {PROC_MODEL['dim']}, depth "
        f"{PROC_MODEL['depth']}, heads 2, dim_head 16, buckets "
        f"{list(PROC_BUCKETS)}) ready in {boot_s:.2f} s; "
        f"{len(resps)} folds {list(PROC_LENGTHS)} in {traffic_s:.2f} s "
        f"({[resp.source for resp in resps]}); identities {devices}")
    log(f"procfleet: kill -9 r1 (rc {killed_rc}); reconcile "
        f"{rec['decision']['action']} ({rec['decision']['reason']}), "
        f"actions {[a['verb'] for a in rec['actions']]}, healthy "
        f"{healthy} after {restore_s:.2f} s; one more fold "
        f"{last.status}; exit codes after SIGTERM {rcs}")
    ready = [json.loads(line) for text in logs.values()
             for line in text.splitlines() if line.startswith('{"ready"')]
    log(f"procfleet: replicas ready on {[r['device'] for r in ready]}")
    if bad or healthy != 2 or rec["decision"]["action"] != "scale_up" \
            or rcs[0] != 0 or rcs[2] != 0 or killed_rc >= 0 \
            or len(ready) != 3 \
            or any(not r["device"].startswith("cuda") for r in ready):
        raise AssertionError(f"procfleet: bad folds {bad}, healthy "
                             f"{healthy}, exit codes {rcs}; logs {logs}")
    return {"boot_s": boot_s, "traffic_s": traffic_s,
            "restore_s": restore_s, "exit_codes": rcs}


# the load-test phases: the port's serve_loadtest at the default
# ModelConfig (--preset default) under closed-loop traffic
LOADTEST_ARGS = {
    "loadtest": [
        "--requests", "64", "--concurrency", "4",
        "--lengths", "131,200,256,300,437,512", "--buckets", "256,512",
        "--msa-depth", "5", "--max-batch", "2", "--max-wait-ms", "25",
        "--num-recycles", "3", "--dup-rate", "0.25", "--cache", "on",
        "--kernel-policy", "512=blocksparse", "--sparse-block", "32",
        "--sparse-window", "1", "--sparse-global", "1"],
    "loadtest-chaos": [
        "--requests", "24", "--lengths", "131,200,256", "--buckets", "256",
        "--dup-rate", "0.5", "--chaos"],
    "loadtest-fleet": [
        "--replicas", "2", "--fleet", "on", "--rollout-at", "0.5",
        "--requests", "24", "--lengths", "131,200,256", "--buckets", "256",
        "--num-recycles", "3", "--dup-rate", "0.5"],
}
# K1 launches per pass of the default model: 6 layers x 4 attentions in
# the 256 bucket; in the 512 bucket under the default pattern the MSA
# column attention stays on K1 (6) and the other three take K2 (18)
K1_PER_PASS = {256: 24, 512: 6}
K2_PER_PASS = {256: 0, 512: 18}


def batches_per_bucket(*metrics_paths):
    """{bucket: batches} from the ServeMetrics JSONL the load test
    wrote (one record per executed batch)."""
    out = {}
    for path in metrics_paths:
        with open(path) as fh:
            for line in fh:
                rec = json.loads(line)
                if "bucket_len" in rec:
                    b = int(rec["bucket_len"])
                    out[b] = out.get(b, 0) + 1
    return out


def run_loadtest(name, tmp, extra=()):
    """The port's serve_loadtest in this process at the default model,
    with its trace, exposition and metrics in `tmp`; the launch counts
    of the run (warm-up, traffic and the numerics check) beside its
    report. Raises unless it exits 0 under --smoke."""
    from alphafold2_tpu_torch.tools import serve_loadtest
    paths = {k: os.path.join(tmp, f"{name}.{k}")
             for k in ("jsonl", "traces.jsonl", "prom")}
    argv = ["--preset", "default", "--smoke",
            "--metrics-path", paths["jsonl"],
            "--trace-path", paths["traces.jsonl"],
            "--prom-path", paths["prom"], *LOADTEST_ARGS[name], *extra]
    reset_peak()
    reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_loadtest.main(argv)
    k1, k2 = read_launches()
    peak = peak_gib()
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    report = json.loads(lines[-1]) if lines else None
    if rc != 0 or report is None:
        raise AssertionError(f"{name}: serve_loadtest exited {rc}: "
                             f"{out.getvalue()[-3000:]}")
    return report, k1, k2, peak, paths


def loadtest_summary(report, peak):
    """The numbers a load-test phase prints and records."""
    keys = ("folds_per_hour", "requests_per_hour", "serving_wall_s",
            "warmup_s", "padding_waste", "served", "batches",
            "latency_by_bucket", "cache_hit_ratio", "coalesced",
            "executor_calls_avoided", "hit_ratio", "cache_hits",
            "forwards", "peer_hits", "retried", "poisoned")
    return dict({k: report[k] for k in keys if k in report},
                peak_gib=peak)


def expected_launches(batches, warm, recycles, k2_numerics=0):
    """(K1, K2) the path must launch: each batch and each warm-up run
    (one per bucket and executor) is one opaque fold of 1 + recycles
    passes; the numerics check adds its own K2 launches."""
    runs = {b: batches.get(b, 0) + warm.get(b, 0) for b in K1_PER_PASS}
    passes = 1 + recycles
    return (sum(K1_PER_PASS[b] * passes * n for b, n in runs.items()),
            sum(K2_PER_PASS[b] * passes * n for b, n in runs.items())
            + k2_numerics)


def phase_loadtest():
    """The port's load test at full width: 64 closed-loop requests from
    four threads over both buckets (the 512 bucket on K2), a quarter of
    them Zipf duplicates served from the cache or coalesced. The launch
    counts must equal what the metrics JSONL's batches (and the warm-up
    of each bucket, and the numerics check's one K2 call) give; K2's
    serving-time numerics at most 2e-2 in bf16; obs_report --check
    --prom exits 0 on the run's files."""
    import tempfile

    from alphafold2_tpu_torch.tools import obs_report
    with tempfile.TemporaryDirectory() as tmp:
        report, k1, k2, peak, paths = run_loadtest("loadtest", tmp)
        batches = batches_per_bucket(paths["jsonl"])
        numerics = report["kernel"]["numerics_max_diff"]
        want = expected_launches(batches, {256: 1, 512: 1}, 3,
                                 k2_numerics=len(numerics))
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            check = obs_report.main([paths["traces.jsonl"], "--check",
                                     "--prom", paths["prom"]])
    # the waterfall (the report's head): where a request's time went
    log("\n".join(text.getvalue().splitlines()[:16]))
    summary = loadtest_summary(report, peak)
    log(f"loadtest: {json.dumps(summary)}")
    log(f"loadtest: batches {batches}, compiles {report['compiles']}, "
        f"K1 {k1} / K2 {k2} launched (expected {want[0]} / {want[1]}), "
        f"K2 numerics {numerics}, kernel folds "
        f"{report['kernel']['folds']}, obs_report --check rc {check}")
    if (k1, k2) != want or report["compiles"] != 2 \
            or numerics.get("512", 1.0) > TOLERANCE[torch.bfloat16] \
            or check != 0:
        raise AssertionError(
            f"loadtest: K1/K2 {k1}/{k2} launched, {want} expected from "
            f"batches {batches}; numerics {numerics}; obs_report rc "
            f"{check}")
    return dict(summary, batches_per_bucket=batches, k1_launches=k1,
                k2_launches=k2, numerics_max_diff=numerics,
                kernel_folds=report["kernel"]["folds"])


def phase_loadtest_chaos():
    """The load test at full width under the default seeded fault plan
    (10 % transient executor faults, one poison in raise mode): its own
    --smoke checks decide — every ticket terminal, every innocent
    request ok, exactly one poisoned, cornered within log2(max_batch)+1
    batch executions."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        report, k1, k2, peak, _ = run_loadtest("loadtest-chaos", tmp)
    chaos = report["chaos"]
    summary = dict(loadtest_summary(report, peak),
                   injected=chaos["injected"],
                   poison_results=chaos["poison_results"])
    log(f"loadtest-chaos: {json.dumps(summary)}; K1 {k1}, K2 {k2}")
    return dict(summary, k1_launches=k1, k2_launches=k2)


def phase_loadtest_fleet():
    """The load test at full width through two in-process replicas
    sharing the card, consistent-hash routing and the peer tier, with a
    rollout halfway: zero stale-tag hits, at least one forward, and K1
    launched per batch and warm-up, summed over both replicas."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        report, k1, k2, peak, paths = run_loadtest("loadtest-fleet", tmp)
        batches = batches_per_bucket(
            *[f"{paths['jsonl']}.r{i}" for i in range(2)])
    want = expected_launches(batches, {256: 2}, 3)
    summary = dict(loadtest_summary(report, peak),
                   rollout=report["rollout"], batches_per_bucket=batches)
    log(f"loadtest-fleet: {json.dumps(summary)}; K1 {k1} / K2 {k2} "
        f"(expected {want[0]} / {want[1]})")
    if report["rollout"]["stale_tag_hits"] != 0 \
            or report["forwards"] < 1 or (k1, k2) != want \
            or report["compiles"] != 2:
        raise AssertionError(
            f"loadtest-fleet: stale-tag hits "
            f"{report['rollout']['stale_tag_hits']}, forwards "
            f"{report['forwards']}, K1/K2 {k1}/{k2} against {want} from "
            f"batches {batches}, compiles {report['compiles']}")
    return dict(summary, k1_launches=k1, k2_launches=k2)


def attention_grads(fn, kw, dtype, cot):
    """Gradients of sum(fn(...) * cot) with respect to q, k, v (in
    `dtype`) and the fp32 bias."""
    leaves = [kw[key].to(dtype).requires_grad_() for key in ("q", "k", "v")]
    bias = None if kw["bias"] is None else \
        kw["bias"].clone().requires_grad_()
    out = fn(*leaves, bias=bias, q_mask=kw["q_mask"], k_mask=kw["k_mask"],
             heads=kw["heads"], bias_repeat=kw["bias_repeat"])
    inputs = leaves + ([] if bias is None else [bias])
    return torch.autograd.grad((out.float() * cot).sum(), inputs)


def phase_train_check():
    """K1's autograd at the train step's shapes, then a small fp32 train
    step on the card against the CPU. Returns the worst K1 gradient error
    per dtype."""
    from alphafold2_tpu_torch.ops import attention as attn
    dev = torch.device("cuda")
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in TRAIN_K1_SHAPES:
            kw = attention_inputs(shape, torch.float32, dev, seed=6)
            # the same values in both dtypes: round once to `dtype`
            for key in ("q", "k", "v"):
                kw[key] = kw[key].to(dtype).float()
            g = torch.Generator(device=dev).manual_seed(7)
            cot = torch.randn(kw["q"].shape, generator=g, device=dev)
            before = attn.launch_count.value
            got = attention_grads(attn.fused_attention, kw, dtype, cot)
            if attn.launch_count.value != before + 1:
                raise AssertionError("K1's forward was not the kernel")
            ref = attention_grads(attn.attention_reference, kw,
                                  torch.float32, cot)
            errs = [float((a.float() - b).abs().max() / b.abs().max())
                    for a, b in zip(got, ref)]
            tol = TOLERANCE[dtype]
            log(f"train-check K1 autograd {shape} {str(dtype)[6:]} "
                f"B={kw['q'].shape[0]} N={kw['q'].shape[1]}: gradient "
                f"error over the largest reference gradient "
                f"{', '.join(f'{n} {e:.3e}' for n, e in zip('qkvb', errs))}"
                f" (tolerance {tol:.0e})")
            if not max(errs) <= tol or not all(torch.isfinite(x).all()
                                               for x in got):
                raise AssertionError(f"K1 autograd {shape} {dtype}: "
                                     f"{errs} > {tol}")
            worst[dtype] = max(worst.get(dtype, 0.0), max(errs))
            del got, ref
    phase_train_parity()
    return worst


def phase_train_parity():
    """A small fp32 distogram + MLM model (remat trunk): one train step on
    the card against the same step on the CPU, from the same weights,
    with the MLM noise drawn from one seeded CPU generator on both."""
    from alphafold2_tpu_torch import Alphafold2
    from alphafold2_tpu_torch.data.synthetic import synthetic_batch
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.train import (TrainState, adam,
                                            make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    batch = synthetic_batch(np.random.default_rng(SEED), seq_len=32,
                            msa_depth=3, pad_fraction=0.25)
    results = []
    for device in ("cpu", "cuda"):
        model = Alphafold2(dim=32, depth=2, heads=2, dim_head=16,
                           device=device,
                           generator=torch.Generator().manual_seed(SEED))
        perturb(model, SEED + 1)
        state = TrainState.create(model, adam(1e-3),
                                  generator=torch.Generator().manual_seed(3))
        seen = []
        apply, params = state.apply_gradients, state.params
        # a None gradient (a parameter the loss does not reach) is zero
        state.apply_gradients = lambda grads: (
            seen.extend((torch.zeros_like(p) if x is None else x).detach()
                        .cpu() for p, x in zip(params, grads)),
            apply(grads))[1]
        attn.launch_count.reset()
        state, metrics = make_train_step(model)(
            state, {k: v.to(device) for k, v in batch.items()})
        results.append((float(metrics["loss"]), seen,
                        attn.launch_count.value))
    (loss_cpu, g_cpu, _), (loss_gpu, g_gpu, launches) = results
    gerr = max(float((a - b).abs().max()) for a, b in zip(g_cpu, g_gpu))
    log(f"train-check small fp32 step (dim 32, depth 2, n 32, remat) card "
        f"vs cpu: loss {loss_gpu:.6f} vs {loss_cpu:.6f} (abs err "
        f"{abs(loss_gpu - loss_cpu):.3e}, tolerance 1e-4), gradients max "
        f"abs err {gerr:.3e} (tolerance 1e-3), K1 launches {launches}")
    # 4 attentions x 2 layers, forward and the remat recompute
    if launches != 16:
        raise AssertionError(f"K1 launched {launches} times, expected 16")
    if not abs(loss_gpu - loss_cpu) <= 1e-4 or not gerr <= 1e-3:
        raise AssertionError("card train step differs from the cpu step")


def phase_train():
    """The contract configuration: K1 launches per step, the loss over
    TRAIN_STEPS steps on one batch, the step's numbers, a profile."""
    from alphafold2_tpu_torch import train_wall
    from alphafold2_tpu_torch.utils.flops import train_step_flops
    model, step, state, batch = train_wall.setup("contract")
    flops = train_step_flops(model, batch)
    torch.cuda.reset_peak_memory_stats()
    state, walls, history = train_wall.time_steps(step, state, batch, 2,
                                                  TRAIN_STEPS - 2)
    peak = torch.cuda.max_memory_allocated()
    launches = {h["k1_launches"] for h in history}
    losses = [h["loss"] for h in history]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    median = float(np.median(walls))
    tflops = flops / (median / 1e3) / 1e12
    matmul = train_wall.matmul_flops_per_s()
    log(f"train contract (dim 256, depth 2, bf16, unrolled, 256 residues, "
        f"5 MSA rows): K1 launches per step {sorted(launches)}; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, mean of the first 5 "
        f"{first:.4f}, of the last 5 {last:.4f}")
    log(f"train contract: median wall {median:.2f} ms over {len(walls)} "
        f"steps ({min(walls):.2f}-{max(walls):.2f}), {flops / 1e9:.1f} "
        f"GFLOP a step -> {tflops:.2f} TFLOP/s, MFU "
        f"{100 * tflops * 1e12 / train_wall.DATASHEET_BF16_FLOPS:.2f} % of "
        f"the 989 TFLOP/s datasheet bf16 peak, "
        f"{100 * tflops * 1e12 / matmul:.2f} % of the {matmul / 1e12:.1f} "
        f"TFLOP/s an 8192^3 bf16 matmul reached; peak memory "
        f"{peak / 2**30:.3f} GiB")
    if launches != {8}:
        raise AssertionError(f"K1 launched {launches} times a step, "
                             f"expected 8")
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError(f"the loss did not fall: {losses}")
    busy, wall, table = phase_profile(lambda: step(state, batch),
                                      "train step, contract configuration")
    from alphafold2_tpu_torch.ops.attention import BACKWARD_RANGE
    record = {"k1_launches_per_step": launches.pop(),
              "median_ms": median, "wall_ms": walls, "loss_first": losses[0],
              "loss_last": losses[-1], "step_gflop": flops / 1e9,
              "tflops": tflops, "matmul_tflops": matmul / 1e12,
              "peak_memory_gib": peak / 2**30, "busy_ms": busy,
              "unprofiled_wall_ms": wall,
              "k1_forward_ms": table.get("fused_attention (K1)",
                                         (0.0, 0))[0],
              "backward_recompute_ms": table[BACKWARD_RANGE][0]}
    log("train: " + json.dumps(record))
    return record


def phase_train_recycled():
    """The default ModelConfig with predict_coords and the remat trunk:
    one recycled step, its K1 launches, then a checkpoint round trip."""
    import tempfile

    from alphafold2_tpu_torch import train_wall
    from alphafold2_tpu_torch.train import CheckpointManager
    model, step, state, batch = train_wall.setup("default")
    depth = len(model.net.layers)
    torch.cuda.reset_peak_memory_stats()
    state, walls, history = train_wall.time_steps(step, state, batch, 0, 1)
    (h,) = history
    r = int(h["recycles"])
    want = 8 * depth + 4 * depth * r
    log(f"train-recycled default ModelConfig (dim 256, depth {depth}, bf16, "
        f"remat, predict_coords, 256 residues): r={r}, loss "
        f"{h['loss']:.4f} (coords {h['coords_loss']:.4f}, confidence "
        f"{h['confidence_loss']:.4f}, mlm {h['mlm_loss']:.4f}), wall "
        f"{walls[0]:.1f} ms (first step), peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, K1 launches "
        f"{h['k1_launches']} (expected 48 + 24 r = {want})")
    if not np.isfinite(h["loss"]) or h["k1_launches"] != want:
        raise AssertionError(f"recycled step: loss {h['loss']}, K1 "
                             f"{h['k1_launches']} != {want}")
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp)
        mgr.save(state)
        _, _, fresh, _ = train_wall.setup("default")
        perturb(fresh.model, SEED + 5)
        restored = mgr.restore(fresh)
    same = all(torch.equal(a, b) for a, b in zip(
        state.model.state_dict().values(),
        restored.model.state_dict().values()))
    same &= all(torch.equal(a, b) for a, b in zip(
        state.optimizer.tensors(), restored.optimizer.tensors()))
    same &= torch.equal(state.generator.get_state(),
                        restored.generator.get_state())
    same &= (state.step, state.optimizer.count) == \
        (restored.step, restored.optimizer.count)
    metrics = []
    for st in (state, restored):
        st, m = step(st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    a, b = metrics
    log(f"train-recycled checkpoint round trip on the card: bit-equal "
        f"{same}; next step r {a['recycles']:.0f} / {b['recycles']:.0f}, "
        f"loss {a['loss']:.6f} / {b['loss']:.6f}")
    if not same or a["recycles"] != b["recycles"] or \
            not abs(a["loss"] - b["loss"]) <= 1e-3 * abs(a["loss"]):
        raise AssertionError("checkpoint round trip differs")
    return {"r": r, "k1_launches": h["k1_launches"], "loss": h["loss"]}


def sliced_record(edges, kernel):
    """One kernel's sliced-path entries of the JSON record: its worst
    errors at D > 128 and its D = 256 times."""
    timed = edges["sliced"][kernel]
    return {"max_err_sliced_f32": edges[("sliced", kernel, torch.float32)],
            "max_err_sliced_bf16": edges[("sliced", kernel,
                                          torch.bfloat16)],
            **{f"d{SLICED_K2_WIDTH}_{key}": val
               for key, val in timed.items()}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="checkout whose alphafold2_tpu_torch is imported "
                         "(default: the one holding this script), so an "
                         "older tree's kernels can be timed in the same "
                         "call")
    ap.add_argument("--phases", choices=("all", "time"), default="all",
                    help="'time': only the device, build and the two time "
                         "phases, then one JSON line of the times")
    args = ap.parse_args(argv)
    if args.root is not None:
        sys.path[0] = os.path.abspath(args.root)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card", file=sys.stderr)
        return 1
    seconds = {}

    def run(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = round(time.perf_counter() - t0, 1)
        log(f"phase {phase}: {seconds[phase]} s")
        return out

    name, count = run("device", phase_device)
    run("build", phase_build)
    if args.phases == "time":
        record = {"root": args.root or os.path.dirname(
            os.path.abspath(__file__)),
                  "fused_attention": phase_time(),
                  "block_sparse_attention": phase_time_block_sparse()}
        print(json.dumps(record), flush=True)
        return 0
    worst = run("check", phase_check)
    bs_worst = run("check-block-sparse", phase_check_block_sparse)
    edges = run("check-edges", phase_check_edges)
    for dtype in (torch.float32, torch.bfloat16):
        worst[dtype] = max(worst[dtype], edges[("fused_attention", dtype)],
                           edges[("sliced", "fused_attention", dtype)])
        bs_worst[dtype] = max(bs_worst[dtype],
                              edges[("block_sparse", dtype)],
                              edges[("sliced", "block_sparse", dtype)])
    timing = run("time", phase_time)
    bs_timing = run("time-block-sparse", phase_time_block_sparse)
    run("parity", phase_parity)
    run("parity-block-sparse", phase_parity_block_sparse)
    launches, times, model, cfg, req = run("serve", phase_serve)
    log(f"serve: fold wall times {[round(s * 1e3, 1) for s in times]} ms")
    from alphafold2_tpu_torch import fold
    run("profile", phase_profile,
        lambda: fold(model, **req, num_recycles=NUM_RECYCLES),
        f"fold {LENGTHS[-1]} residues, bucket {BUCKET}")
    faw = run("fold-and-write", phase_fold_and_write, model)
    snapshot_gap = run("step-snapshot", phase_step_snapshot, model, req)
    full_launches, full_walls, full_peaks, full_req, feats = run(
        "fold-full", phase_fold_full, model)
    busy, _, table = run(
        "fold-full-profile", phase_profile,
        lambda: fold(model, **full_req, num_recycles=NUM_RECYCLES, **feats),
        f"full-feature fold {LENGTHS[-1]} residues, bucket {BUCKET}, "
        f"t={TEMPLATES}, e={EXTRA_ROWS}")
    k1_full_ms = table.get("fused_attention (K1)", (0.0, 0))[0]
    log(f"fold-full: walls {[round(w, 1) for w in full_walls]} ms, peak "
        f"memory {max(full_peaks) / 2**30:.3f} GiB, K1 "
        f"{k1_full_ms:.1f} ms of {busy:.1f} ms device time "
        f"({100 * k1_full_ms / busy:.1f} %)")
    del full_req, feats
    bs_launches, k1_sparse, ex, batch, spec = run("executor", phase_executor,
                                                  model, cfg)
    run("executor-profile", phase_profile,
        lambda: ex.run(batch, NUM_RECYCLES, kernel=spec),
        f"executor fold {SPARSE_LENGTHS[-1]} residues, bucket "
        f"{SPARSE_BUCKET} ({spec.label})")
    del ex
    sched = run("scheduler", phase_scheduler, model, cfg)
    fleet_out = run("fleet", phase_fleet, model, cfg)
    tiers = run("serve-tiers", phase_serve_tiers, model, cfg)
    del model
    procfleet = run("procfleet", phase_procfleet)
    loadtest = run("loadtest", phase_loadtest)
    loadtest_chaos = run("loadtest-chaos", phase_loadtest_chaos)
    loadtest_fleet = run("loadtest-fleet", phase_loadtest_fleet)
    grad_worst = run("train-check", phase_train_check)
    train = run("train", phase_train)
    recycled = run("train-recycled", phase_train_recycled)
    log(f"phase seconds: {json.dumps(seconds)}")
    record = {"kernels": [{
        "name": "fused_attention",
        "route": "cuda",
        "source": "alphafold2_tpu_torch/csrc/fused_attention.cu",
        "replaces": "alphafold2_tpu/ops/attention.py:170",
        "launches": launches,
        "launches_per_fold": launches // len(LENGTHS),
        "launches_per_fold_512": k1_sparse // len(SPARSE_LENGTHS),
        "launches_per_fold_full": full_launches // len(LENGTHS),
        "launches_fold_and_write_miss": faw["k1_launches_miss"],
        "launches_fold_and_write_hit": faw["k1_launches_hit"],
        "fold_and_write": faw,
        "step_snapshot_coords_gap": snapshot_gap,
        "padded_d48_ms": edges["padded_width_ms"][48],
        "d64_ms": edges["padded_width_ms"][64],
        "fold_full_wall_ms": full_walls,
        "fold_full_peak_gib": max(full_peaks) / 2**30,
        "fold_full_k1_device_ms": k1_full_ms,
        "fold_full_device_busy_ms": busy,
        "launches_per_train_step": train["k1_launches_per_step"],
        "launches_per_recycled_train_step": recycled["k1_launches"],
        "recycles_of_that_step": recycled["r"],
        "train_step_ms": train["median_ms"],
        "train_k1_forward_ms": train["k1_forward_ms"],
        "train_backward_recompute_ms": train["backward_recompute_ms"],
        "max_grad_err_f32": grad_worst[torch.float32],
        "max_grad_err_bf16": grad_worst[torch.bfloat16],
        "max_abs_err": worst[torch.bfloat16],
        "max_err_f32": worst[torch.float32],
        "max_err_bf16": worst[torch.bfloat16],
        **sliced_record(edges, "fused_attention"),
        "launches_scheduler": sched["k1_launches"],
        "scheduler": sched,
        "launches_fleet": fleet_out["k1_launches"],
        "launches_serve_tiers": tiers["k1_launches"],
        "fleet": fleet_out,
        "serve_tiers": tiers,
        "procfleet": procfleet,
        "launches_loadtest": loadtest["k1_launches"],
        "launches_loadtest_chaos": loadtest_chaos["k1_launches"],
        "launches_loadtest_fleet": loadtest_fleet["k1_launches"],
        "loadtest": loadtest,
        "loadtest_chaos": loadtest_chaos,
        "loadtest_fleet": loadtest_fleet,
        **timing,
    }, {
        "name": "block_sparse_attention",
        "route": "cuda",
        "source": "alphafold2_tpu_torch/csrc/block_sparse.cu",
        "replaces": "alphafold2_tpu/ops/block_sparse.py:269",
        "launches": bs_launches,
        "launches_per_fold": bs_launches // len(SPARSE_LENGTHS),
        "live_fraction": spec.live_fraction,
        "max_abs_err": bs_worst[torch.bfloat16],
        "max_err_f32": bs_worst[torch.float32],
        "max_err_bf16": bs_worst[torch.bfloat16],
        **sliced_record(edges, "block_sparse"),
        "launches_scheduler": sched["k2_launches"],
        "launches_fleet": fleet_out["k2_launches"],
        "launches_serve_tiers": tiers["k2_launches"],
        "launches_loadtest": loadtest["k2_launches"],
        "launches_loadtest_chaos": loadtest_chaos["k2_launches"],
        "launches_loadtest_fleet": loadtest_fleet["k2_launches"],
        **bs_timing,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
