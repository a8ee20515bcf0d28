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
   attention (B=2048, N=1024; its plain version over chunks of B), and
   the row, column and triangle shapes of phases 13-15 (evaluate's 72
   residues under a one-row MSA, whose column attention runs at Nq = Nk
   = 1; end2end-egnn's 64 residues; the fp32 reversible checks' 128),
   plus a small backward against autograd; K2 at the 512 bucket's MSA row and
   triangle shapes under the default policy's pattern and a banded
   block-128 one, bf16 in both layouts (the warpgroup kernel and the
   mma.sync tile), plus one call at the default scale), then at the
   tensor-core tile's edge cases (ragged and odd lengths, every head
   width, replayed bias, fully masked rows, every bf16 layout of K1 —
   layout 3, the warpgroup kernel, at Nq and Nk of 64 to 1024 beside
   layout 1, and the shapes the layout rule keeps off it —
   K2 at every block size and head width in fp32 and in both bf16
   layouts, live keys all masked, other scales, the global row of 16
   live blocks, irregular contact patterns, and K2's layout rule's
   routes), and at the
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
   under the default pattern and a banded block-128 one; K1's bf16
   layouts, where the rule chooses between two (1 and 3 for Nq >= 64, 1
   and 2 for Nq <= 16), by profiler device time in turns, at each shape
   and at the menu's 512 and the memory probe's 384 triangle; K2's bf16
   layouts (the mma.sync tile and the warpgroup kernel) by profiler
   device time in turns at the triangle and the MSA row under both
   patterns, each beside its bound and share;
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
8a. fold-ab: the 256-bucket fold of phase 6 and the full-feature fold of
   phase 8 under K1's layout rule before layout 3 and under the current
   one (`ops.attention.kernel_layout` swapped in the module), in turns
   (old, new, new, old): each turn's wall (median of four unprofiled
   folds), K1's device ms in one profiled fold, and K1's launches, equal
   under both rules;
9. executor: the same model behind `serve.executor.FoldExecutor` with
   the default buckets and the default kernel policy (the 512 bucket
   block-sparse, the others dense): warm-up, three folds of 512, 437
   and 300 residues in the 512 bucket (72 K2 + 24 K1 launches each), one
   of 200 residues in the 256 bucket (0 K2 + 96 K1), and a step-mode
   fold whose steps run under a spec re-planned from the first pass's
   distogram; then a profile of one 512-bucket fold;
9h. fold-ab-k2: one 512-bucket executor fold of 300 residues under K2's
   layout rule before the warpgroup layout and under
   `ops.block_sparse.kernel_layout` (swapped in the module), in turns
   (old, new, new, old): each turn's wall (median of four unprofiled
   folds), K2's device ms in one profiled fold, and K2's launches (72
   under both rules);
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
   and the next step draws the same r from the restored generator);
13. end2end-egnn (BASELINE config 3): the port's
   `scripts/train_end2end.py --structure-module egnn` in-process at the
   default ModelConfig on 64-residue synthetic crops, 5 MSA rows: one
   warm-up step and 3 more; each step's wall (its synchronised
   StepTimer), peak memory, finite losses and gradients, and K1 launches
   per step, which must equal the prediction from the code (8 per remat
   layer: 48);
14. end2end-se3-rev (BASELINE config 4): the same with `--structure-
   module se3 --refinement-iters 4 --reversible` on 256-residue crops
   (K1 12 per reversible layer: forward, inversion, re-linearisation:
   72); then the trained trunk's reconstruction (the inverse of its
   forward against the inputs, bf16, and an fp32 copy at 128 residues)
   and the fp32 copy's reversible gradients against plain autograd
   through the same layers;
15. evaluate: the port's `scripts/evaluate.py --pdb
   tests/data/1h22_head.pdb --recycles 3` at the default ModelConfig
   (random weights): RMSD, TM, GDT-TS, lDDT and confidence, K1 96
   launches, and a predicted PDB that reads back;
16. refiners-check: one forward of each refiner kind (egnn, en, se3 and
   the atom-level EGNN) at dim 256 and `core.nerf.sidechain_container`,
   the card against the CPU in fp32: each one's largest difference
   (within 1e-3) and largest value, their ratio within 1e-5;
17. menu-check: this slice's new kernel shapes against their plain
   versions in fp32 and bf16 at valid query rows, under the gates of
   phase 3: K2 at the model-level sparse row of the 512 bucket (B = 40,
   N = 512, block 32, window 1, one global block, no bias, the padded
   tail in the key mask), K1 at the Kronecker row (B = 40, Nq = 256,
   Nk = 512 pooled tokens) and K1 at the unpadded 300-residue sparse row
   (the pattern as a -1e9 bias); each timed (events, profiler device
   time) beside its plain version, SDPA and its bound;
18. menu-parity: each menu model (interleaved sparse, kron, FAVOR+,
   elu linear, compress, conv, reversible conv) at dim 64, depth 4, fp32,
   folded on the card and on the CPU from the same weights: coordinates
   within 1e-3 at real residues; the sparse menu launches K2;
19. menu-fold: `ModelConfig(predict_coords=True, depth=12,
   sparse_self_attn=[True, False] * 6)` (the documented README menu)
   through `predict.fold`: 512 and 437 residues in the 512 bucket (K1
   168 and K2 24 a fold) and 300 unpadded (K1 192, K2 0); wall, peak
   memory, launches; a profile of one 512 fold (K2's share);
20. menu-variants: one 256-bucket fold of 200 residues at depth 6 for
   `kron_attn` (K1 96), FAVOR+ `linear_attn` (72), `kv_compress_ratio=2`
   (72) and `use_conv` (96); then one train step of the reversible trunk
   with `use_conv` at 256 residues (K1 72): wall, peak memory;
21. menu-train: `scripts/train_distogram.py --config <menu JSON> --data
   <dir>` (the interleaved menu at depth 6; the phase writes the
   directory: an .a3m and `tests/data/1h22_head.pdb`), the same with
   `--scn` on a pickle `corpus_from_pdb` writes, and
   `scripts/train_end2end.py --data <dir>`: 3 steps each on 64-residue
   crops, K1 48 a step (the sparse rows under gradients take K1 with
   the pattern bias), K2 0, finite losses, walls and peak memory;
22. mesh: a one-rank NCCL process group (a FileStore in a temporary
   directory, no network port) and `parallel.make_mesh()` over the card
   (`make_mesh(2, 1, 1)` must raise JAX's error); the train phase's
   contract architecture in fp32 with `ring_attention=True`, its state
   placed by `shard_pytree_tp_zero`, 3 steps through `train.fit(mesh=)`
   against the same steps without a mesh: losses within 1e-5 relative,
   updated parameters within 1e-4 absolute (the largest update beside
   it), equal K1
   launches a step (every attention reaches K1 through the DTensor
   wrapping; no ring on one rank) and the placed state's bytes equal to
   the unplaced state's; the default model folds 131 residues in the
   256 bucket under the mesh and without (coords within 1e-3, equal K1);
   a "named" fold-checkpoint leaf restored onto the mesh, bit-equal;
23. ring: the ring's arithmetic at full width: K1's 512 triangle shape
   (B = 4096, N = 512, D = 64, 437 real, bias replayed) in fp32 split
   into 2 and 4 key shards in one process and accumulated with
   `parallel.ring._block_attend`, against K1 on the whole at every valid
   query (within 1e-4); one `_block_attend` step at S = 4 timed beside
   K1 (CUDA events). A multi-card mesh needs one process per card
   (`torchrun`); one card runs none;
24. slice: the serving executor's rank processes. On one card: a
   one-rank `serve.SliceGroup` (NCCL over a FileStore, 1 x 1 mesh, the
   executor's one-card slice sent to it by `one_rank_executor`) folds
   131 residues in the 256 bucket (default model, 3 recycles) within
   1e-3 A of the in-process executor with equal K1 launches (counted on
   the rank: 96); a step loop of init and 3 steps on the group, then
   init and 2 steps, a snapshot, the group killed, a fresh group
   started by the restore's next step, and the last step byte-equal to
   the unbroken loop. With two or more cards (else one line says why
   not): the fp32 and bf16 default model at the 512 bucket (437
   residues, the default KernelPolicy's K2 spec) on 1 x 2 and, with
   four, 2 x 2 and 1 x 4 slices against one card (fp32: the slices
   that keep the rows whole within 1e-3 A; 2 x 2, which shards the
   rows, within 1e-2 A at the first pass, its fold's gap printed; the
   bf16 gaps printed), beside the one-card fold with one projection
   nudged by an ulp (the gap rounding alone makes), and a `Scheduler`
   with MeshPolicy({256: 1, 512: 4}) and a RecyclePolicy over the fp32
   default model serving the scheduler phase's six lengths, each
   response within 1e-3 A of a one-card scheduler's; K1 and K2
   launches per rank, walls, start-up seconds, peak memory per rank
   and the replies' bytes and transfer time;
25. runner-check: K1 at the runners' shapes against its plain version
   and timed beside it, SDPA and the bound (RUNNER_K1_SHAPES): the 1H22
   demo's row, column (Nq = Nk = 1: a one-row MSA) and triangle
   attention in fp32 at heads 4, D = 16 over 72 residues, and the memory
   probe's in bf16 at heads 8, D = 64 over 384 residues and 5 MSA rows;
26. train-1h22: the port's `scripts/train_1h22.py --train-recycles 3`
   (at most 1500 steps, an eval every 250, early stop at 1 A): the
   headline Kabsch RMSD below 2 A and below the random-init row's, the
   steps, wall, ms a step, every metric and K1's launches against the
   count predicted from the recycles drawn and the folds run;
27. train-tiny: `scripts/train_tiny.py` for 20 steps, every loss finite,
   none skipped, K1 16 a step;
28. memory-probe: `tools/memory_probe.py`'s step at 384 residues, dim
   256: the remat trunk at depths 2, 8 and 48, the reversible trunk at
   48 and the plain loop at the depths it fits (2, 4, 8): state bytes,
   temp (peak less state), peak, step seconds and K1 launches a step
   against 8 a layer (remat), 12 (reversible) and 4 (plain loop).

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
# K1's shapes on the paths of phases 13-15 that no fold-path shape has,
# as (fold-path shape, residues, real residues, MSA rows), every real
# row and column unmasked as there: evaluate's 72 residues of
# tests/data/1h22_head.pdb under its one-row MSA (the column attention
# at Nq = Nk = 1), end2end-egnn's 64-residue crops, and the fp32
# reversible checks' 128 residues with the last 16 padded
PATH_K1_SHAPES = {
    "evaluate_row": ("msa_row", 72, 72, 1),
    "evaluate_col": ("msa_col", 72, 72, 1),
    "evaluate_triangle": ("triangle", 72, 72, 1),
    "egnn_row": ("msa_row", 64, 64, MSA_ROWS),
    "egnn_col": ("msa_col", 64, 64, MSA_ROWS),
    "egnn_triangle": ("triangle", 64, 64, MSA_ROWS),
    "rev128_row": ("msa_row", 128, 112, MSA_ROWS),
    "rev128_col": ("msa_col", 128, 112, MSA_ROWS),
    "rev128_triangle": ("triangle", 128, 112, MSA_ROWS),
}
# K1's shapes on the menu fold's dense attentions that no earlier shape
# has, in the same form: the 512 bucket's MSA row and triangle attention
# at 437 real residues (the triangle is 96 of the fold's 168 launches),
# and the unpadded 300-residue fold's row, column and triangle attention
MENU_K1_SHAPES = {
    "menu_k1_row_512": ("msa_row", SPARSE_BUCKET, 437, MSA_ROWS),
    "menu_k1_triangle_512": ("triangle", SPARSE_BUCKET, 437, MSA_ROWS),
    "menu_k1_row_300": ("msa_row", 300, 300, MSA_ROWS),
    "menu_k1_col_300": ("msa_col", 300, 300, MSA_ROWS),
    "menu_k1_triangle_300": ("triangle", 300, 300, MSA_ROWS),
}
# K1's shapes on the runners' paths (phases 26-28), as (fold-path shape,
# residues, real residues, MSA rows, heads, head width, dtype): the 1H22
# demo in fp32 at heads 4, D = 16 (72 residues under a one-row MSA, so
# its column attention runs at Nq = Nk = 1), and the memory probe in
# bf16 at heads 8, D = 64 over a 384-residue crop with 5 MSA rows (BASELINE
# config 5's trunk)
RUNNER_K1_SHAPES = {
    "demo_row": ("msa_row", 72, 72, 1, 4, 16, torch.float32),
    "demo_col": ("msa_col", 72, 72, 1, 4, 16, torch.float32),
    "demo_triangle": ("triangle", 72, 72, 1, 4, 16, torch.float32),
    "probe_row": ("msa_row", 384, 384, MSA_ROWS, 8, 64, torch.bfloat16),
    "probe_col": ("msa_col", 384, 384, MSA_ROWS, 8, 64, torch.bfloat16),
    "probe_triangle": ("triangle", 384, 384, MSA_ROWS, 8, 64,
                       torch.bfloat16),
}


def log(*args):
    print(*args, flush=True)


# the card's name and power limit as nvidia-smi prints them, set by
# phase_device and printed beside the numbers of the later phases
CARD = ""


def phase_device():
    global CARD
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(f"device: {name} (count {count})")
    CARD = smi.stdout.strip()
    log(f"nvidia-smi: {CARD}")
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
    kernels <D, WG, G, BK, STAGES>; the warpgroup kernel <D, BIAS>),
    registers, shared memory, spills."""
    lines, entry, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            targs = re.search(r"\d((?:fused_attention|block_sparse)"
                              r"(?:_sliced)?(?:_mma(?:_wide)?|_wgmma)?"
                              r"_kernel)I(\w*?)((?:Li\d+E)+)",
                              m.group(1))
            entry = "{} {}<{}>".format(
                targs.group(1), "bf16" if "mma_" in targs.group(1)
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
    covering a random prefix of the real residues); or one of
    PATH_K1_SHAPES, MENU_K1_SHAPES or RUNNER_K1_SHAPES (the last at their
    own heads and head width), without the fold-path shapes' masked MSA
    row and ragged last row."""
    heads, valid, rows, ragged = 8, 200, MSA_ROWS, True
    g = torch.Generator(device=device).manual_seed(seed)
    bucket = BUCKET
    if shape == "msa_col_512":  # the 512 bucket's column attention
        shape, bucket, valid = "msa_col", SPARSE_BUCKET, 437
    if shape in PATH_K1_SHAPES or shape in MENU_K1_SHAPES:
        shape, bucket, valid, rows = {**PATH_K1_SHAPES,
                                      **MENU_K1_SHAPES}[shape]
        ragged = False
    if shape in RUNNER_K1_SHAPES:
        shape, bucket, valid, rows, heads, d, _ = RUNNER_K1_SHAPES[shape]
        ragged = False
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
    if shape == "msa_row":      # the alignment rows attend over residues
        q_mask = real[None].repeat(rows, 1)
        if ragged:
            q_mask[3] = False                    # one fully masked row
        k_mask, bias_repeat = q_mask, rows
    elif shape == "msa_col":    # residues attend over the alignment rows
        nq = nk = rows
        k_mask = real[:, None].repeat(1, rows)
        if ragged:
            k_mask[:valid, -1] = False           # a ragged last row
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
        for shape in K1_SHAPES + tuple(PATH_K1_SHAPES):
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
# K2: (block, D, scale), every block at every head width, scales other
# than 1; K2_PATTERN_EDGES: (name, N, block), the global row of 16 live
# blocks and irregular contact patterns, whose pair unions have unequal
# halves. bf16 runs each in both layouts.
K1_EDGES = [(5, 5, 64, 8, 3, False), (131, 131, 32, 2, 2, True),
            (200, 131, 16, 2, 1, False), (131, 200, 128, 1, 2, True),
            (17, 5, 64, 4, 2, False), (64, 7, 16, 2, 3, True)]
K2_EDGES = [(block, d, scale) for (block, d), scale in zip(
    itertools.product((16, 32, 64, 128), (16, 32, 64, 128)),
    itertools.cycle((1.0, 0.37, 0.125, 2.0)))]
K2_PATTERN_EDGES = [("global row", 512, 32), ("contact", 512, 32),
                    ("contact", 256, 16)]
# K1's layout 3 (the warpgroup kernel) at its edges: (Nq, Nk, D, heads,
# bias_repeat, bias, full), Nq and Nk over 64, 131, 200, 256 and 1024,
# every head width, a bias replayed over bias_repeat > 1 with heads > 1,
# ragged lengths (131 keys only without a bias), `full` masking one query
# row and one key row in full; each against layout 1 and the plain version
K1_WARPGROUP_EDGES = [(64, 64, 16, 8, 3, True, True),
                      (131, 131, 32, 2, 2, False, True),
                      (200, 256, 64, 2, 3, True, False),
                      (256, 200, 128, 1, 2, True, True),
                      (1024, 1024, 64, 2, 1, False, True),
                      (131, 1024, 16, 2, 2, True, True),
                      (1024, 64, 32, 1, 2, True, False),
                      (256, 131, 128, 4, 2, False, False)]
# launch shapes the rule keeps off layout 3, and the layout each takes:
# odd Nk under a bias (1), Nq <= 16 (2), 16 < Nq < 64 (1)
K1_ROUTED_SHAPES = [((131, 131, 64, True), 1), ((257, 257, 64, True), 1),
                    ((5, 5, 64, False), 2), ((1, 4, 64, False), 2),
                    ((48, 48, 64, True), 1)]
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
    in fp32 on the same values; bf16 K1 in the mma.sync tile's layouts (0
    = the C side's older rule, 1 and 2 forced) and, at K1_WARPGROUP_EDGES,
    in layout 3, with the rule's routes; K2 with a query block whose live
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
        edges = [(f"block={block} D={d} scale={scale}", 4 * block, block, d,
                  scale, bs.banded_block_pattern(4, 0, 1))
                 for block, d, scale in K2_EDGES]
        edges += [(f"{name} N={n} block={block}", n, block, 64, 1.0,
                   k2_edge_pattern(name, n, block))
                  for name, n, block in K2_PATTERN_EDGES]
        for label, n, block, d, scale, pattern in edges:
            g = torch.Generator().manual_seed(block + d + n)
            b = heads * rep
            q, k = (torch.randn(b, n, d, generator=g) * 0.5 for _ in range(2))
            v = torch.randn(b, n, d, generator=g)
            bias = torch.randn(heads, n, n, generator=g)
            km = torch.arange(n)[None] < torch.randint(
                n // 2, n + 1, (rep, 1), generator=g)
            # the small pattern (window 0, one global block): query block 1
            # sees key blocks 0 and 1, every key of which is masked in this
            # mask row
            km[1, :2 * block] = False
            plan = bs.BlockPlan.build(pattern, block, dev)
            kw = dict(bias=bias.to(dev), bias_repeat=rep, k_mask=km.to(dev),
                      heads=heads, scale=scale)
            args = [t.to(dev, dtype) for t in (q, k, v)]
            ref = bs.block_sparse_reference(*(t.float() for t in args), plan,
                                            **kw)
            if dtype == torch.float32:
                runs = {"rule": lambda: bs.block_sparse_attention(
                    *args, plan, **kw)}
            else:
                runs = {layout: lambda layout=layout: bs._launch(
                    *args, plan, layout=layout, **kw)
                    for layout in (attn.TILE, attn.WARPGROUP)}
            errs = {}
            for name, run in runs.items():
                out = run()
                torch.cuda.synchronize()
                errs[name] = float((out.float() - ref).abs().max())
                if not errs[name] <= tol or not torch.isfinite(out).all():
                    raise AssertionError(
                        f"block_sparse edge {label} {dtype} layout {name}: "
                        f"max abs err {errs[name]}")
            log(f"check block_sparse edge {label} {str(dtype)[6:]}: max abs "
                f"err " + ", ".join(f"{e:.3e}" if name == "rule" else
                                    f"layout {name} {e:.3e}"
                                    for name, e in errs.items()) +
                f" (tolerance {tol:.0e})")
            key = ("block_sparse", dtype)
            worst[key] = max(worst.get(key, 0.0), *errs.values())
        if dtype == torch.bfloat16:
            check_warpgroup_edges(worst)
            check_block_sparse_rule()
        check_routes(dtype, worst)
        check_sliced_widths(dtype, worst)
    worst["padded_width_ms"] = time_padded_width()
    worst["sliced"] = time_sliced_widths()
    return worst


def check_warpgroup_edges(worst):
    """bf16 K1 in layout 3 at K1_WARPGROUP_EDGES against the plain version
    in fp32 on the same values and against layout 1 (tolerance 2e-2), and
    the rule's layout at K1_ROUTED_SHAPES."""
    from alphafold2_tpu_torch.ops import attention as attn
    dev, dtype = torch.device("cuda"), torch.bfloat16
    tol = TOLERANCE[dtype]
    for nq, nk, d, heads, rep, with_bias, full in K1_WARPGROUP_EDGES:
        g = torch.Generator().manual_seed(nq + 3 * nk + d)
        b = heads * rep
        q, k = (torch.randn(b, n, d, generator=g) * 0.5 for n in (nq, nk))
        v = torch.randn(b, nk, d, generator=g)
        bias = torch.randn(heads, nq, nk, generator=g).to(dev) \
            if with_bias else None
        qm = torch.arange(nq)[None] < torch.randint(
            (nq + 1) // 2, nq + 1, (rep, 1), generator=g)
        km = torch.arange(nk)[None] < torch.randint(
            (nk + 1) // 2, nk + 1, (rep, 1), generator=g)
        if full:
            qm[0] = False
            km[-1] = False
        qm, km = qm.to(dev), km.to(dev)
        q, k, v = (t.to(dev, dtype) for t in (q, k, v))
        if attn.kernel_layout(nq, nk, d, dtype, with_bias) != attn.WARPGROUP:
            raise AssertionError(f"the rule keeps Nq={nq} Nk={nk} D={d} "
                                 f"off layout 3")
        ref = attn.attention_reference(q.float(), k.float(), v.float(), bias,
                                       qm, km, heads=heads, bias_repeat=rep)
        outs = {layout: attn._launch(q, k, v, bias, qm, km, heads, rep,
                                     layout=layout)
                for layout in (attn.WARPGROUP, attn.TILE)}
        torch.cuda.synchronize()
        err = float((outs[attn.WARPGROUP].float() - ref).abs().max())
        gap = float((outs[attn.WARPGROUP].float() -
                     outs[attn.TILE].float()).abs().max())
        log(f"check fused_attention layout 3 edge Nq={nq} Nk={nk} D={d} "
            f"heads={heads} repeat={rep}{' bias' if with_bias else ''}"
            f"{' full masks' if full else ''} bf16: max abs err {err:.3e}, "
            f"against layout 1 {gap:.3e} (tolerance {tol:.0e})")
        if not (err <= tol and gap <= tol) or \
                not torch.isfinite(outs[attn.WARPGROUP]).all():
            raise AssertionError(f"fused_attention layout 3 edge Nq={nq} "
                                 f"Nk={nk} D={d}: err {err}, gap {gap}")
        key = ("fused_attention", dtype)
        worst[key] = max(worst.get(key, 0.0), err)
    for (nq, nk, d, with_bias), want in K1_ROUTED_SHAPES:
        got = attn.kernel_layout(nq, nk, d, dtype, with_bias)
        log(f"check fused_attention rule Nq={nq} Nk={nk} D={d}"
            f"{' bias' if with_bias else ''}: layout {got} (want {want})")
        if got != want:
            raise AssertionError(f"rule sends Nq={nq} Nk={nk} D={d} "
                                 f"bias={with_bias} to {got}, not {want}")


def k2_edge_pattern(name, n, block):
    """A K2_PATTERN_EDGES pattern: the default policy's banded pattern
    (window 1, one global block: a global row of n / block live blocks),
    or one planned from seeded random contacts (the top 20 % of blocks,
    symmetrised with the band), whose pair unions have unequal halves."""
    from alphafold2_tpu_torch.ops import block_sparse as bs
    if name == "global row":
        return bs.banded_block_pattern(n // block, 1, 1)
    contacts = np.random.default_rng(n + block).random((n, n))
    return bs.contact_block_pattern(contacts.astype(np.float32), block,
                                    live_frac=0.2)


# K2's layout rule at the shapes it keeps off the warpgroup kernel, and
# at a re-planned block: ((kernel block, N, launch head width, dtype),
# layout); block 48 re-plans at 16
K2_RULE_SHAPES = [((32, 512, 64, torch.float32), 0),
                  ((32, 512, 256, torch.bfloat16), 1),
                  ((16, 192, 64, torch.bfloat16), 3)]


def check_block_sparse_rule():
    """K2's layout rule: fp32 to the CUDA-core kernel, D > 128 to the
    sliced path (the mma.sync tile), and a block of 48 re-planned at 16
    onto the warpgroup kernel."""
    from alphafold2_tpu_torch.ops import block_sparse as bs
    plan = bs.BlockPlan.build(bs.banded_block_pattern(4, 1, 1), 48, "cpu")
    log(f"check block_sparse rule: block 48 re-planned at "
        f"{plan.kernel_block}")
    if plan.kernel_block != 16:
        raise AssertionError(f"block 48 re-plans at {plan.kernel_block}")
    for (block, n, d, dtype), want in K2_RULE_SHAPES:
        got = bs.kernel_layout(block, n, d, dtype, True)
        log(f"check block_sparse rule block={block} N={n} D={d} "
            f"{str(dtype)[6:]}: layout {got} (want {want})")
        if got != want:
            raise AssertionError(f"K2's rule sends block {block} D {d} "
                                 f"{dtype} to {got}, not {want}")


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
              "extra_row": 10, "extra_col": 10, "menu_k1_triangle_512": 10,
              "probe_triangle": 10}
LAYOUT_SHAPES = ("msa_col", "triangle", "msa_col_512", "pointwise")
# K1's bf16 shapes beyond the fold path's that phase_time also times with
# layouts 1 and 3 in turns: the menu fold's 512 triangle (96 launches a
# depth-12 fold) and the memory probe's 384 triangle
LAYOUT3_EXTRA_SHAPES = ("menu_k1_triangle_512", "probe_triangle")


def previous_rule(nq, nk, d, dtype, has_bias):
    """K1's layout rule before the warpgroup layout: one warp per row for
    Nq <= 16, the mma.sync tile for the rest of bf16, the fp32 kernel for
    fp32 (the signature of `ops.attention.kernel_layout`)."""
    from alphafold2_tpu_torch.ops import attention as attn
    if dtype != torch.bfloat16:
        return attn.F32
    return attn.ROW if nq <= 16 else attn.TILE


def layout_turns(kw, iters):
    """The bf16 layouts the rule chooses between at this launch, timed by
    profiler device time in turns (a, b, b, a): 1 against 3 where the
    warpgroup layout applies, 1 against 2 for Nq <= 16, else {}. Returns
    {layout: [ms of the first turn, ms of the second]}."""
    from alphafold2_tpu_torch.ops import attention as attn
    q, k, bias = kw["q"], kw["k"], kw["bias"]
    nq, d = q.shape[1:]
    if not hasattr(attn, "kernel_layout"):     # a tree before layout 3
        pair = (1, 2) if nq <= 16 else ()
    elif nq <= 16:
        pair = (attn.TILE, attn.ROW)
    elif attn.kernel_layout(nq, k.shape[1], d, q.dtype,
                            bias is not None) == attn.WARPGROUP:
        pair = (attn.TILE, attn.WARPGROUP)
    else:
        pair = ()
    args = [kw[key] for key in ("q", "k", "v", "bias", "q_mask",
                                "k_mask")] + [kw["heads"], kw["bias_repeat"]]
    times = {}
    for layout in pair + pair[::-1]:
        times.setdefault(layout, []).append(device_ms(
            lambda: attn._launch(*args, layout=layout), iters=iters))
    return times


def phase_time():
    """K1 at each fold-path shape in bf16, and at LAYOUT3_EXTRA_SHAPES:
    kernel (CUDA events over a run of launches, and device time per launch
    from torch.profiler), plain version (over chunks of B where its logits
    pass 2 GiB), SDPA yardstick and the bound; where the shape rule
    chooses between layouts, each candidate by profiler device time in
    turns (`layout_turns`: 1 and 3, or 1 and 2 for Nq <= 16), beside its
    share of the bound and the layout the rule picks. The JSON record
    carries the triangle shape, the 256-bucket fold's largest and most
    frequent launch, and the other shapes under `<shape>_*`."""
    from alphafold2_tpu_torch.ops import attention as attn
    dtype = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results = {}
    for shape in K1_SHAPES + LAYOUT3_EXTRA_SHAPES:
        iters = TIME_ITERS[shape]
        kw = attention_inputs(shape, dtype, torch.device("cuda"), seed=3)
        q, k, v, bias = kw["q"], kw["k"], kw["v"], kw["bias"]
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
        turns = layout_turns(kw, iters)
        bound_ms, bound_by, nbytes, flops = attention_bound(kw)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        flops_ms = flops / PEAK_FLOPS[dtype] * 1e3
        lib = "refused" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"time fused_attention {shape} bf16 B={b} Nq={nq} Nk={nk} "
            f"D={d}: kernel {ms:.4f} ms (events), {dev_ms:.4f} ms "
            f"(profiler device time), plain {plain_ms:.4f} ms, sdpa {lib}, "
            f"bound {bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB -> "
            f"{bytes_ms:.4f} ms, {flops / 1e9:.3f} GFLOP -> "
            f"{flops_ms:.4f} ms), {100 * bound_ms / dev_ms:.1f} % of bound "
            f"[{CARD}]")
        results[shape] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bound_ms,
                              bound_by=bound_by,
                              share=bound_ms / dev_ms)
        if turns:
            mean = {key: sum(val) / len(val) for key, val in turns.items()}
            picked = attn.kernel_layout(nq, nk, d, dtype, bias is not None) \
                if hasattr(attn, "kernel_layout") else 0
            log(f"  layouts by profiler device time in turns (ms): " +
                "; ".join(f"{key}: " + ", ".join(f"{t:.4f}" for t in val) +
                          f" ({100 * bound_ms / mean[key]:.1f} % of bound)"
                          for key, val in turns.items()) +
                f"; the rule picks {picked}, the faster is "
                f"{min(mean, key=mean.get)}")
            for key, val in mean.items():
                results[shape][f"layout{key}_ms"] = val
                results[shape][f"layout{key}_share"] = bound_ms / val
        del kw, q, k, v, bias
    per_fold = sum(results[s]["device_ms"] * c for s, c in
                   (("msa_row", 24), ("msa_col", 24), ("triangle", 48)))
    log(f"time fused_attention: {per_fold:.2f} ms of kernel device time "
        f"per fold (24 row + 24 column + 48 triangle launches); "
        f"{24 * results['msa_col_512']['device_ms']:.2f} ms per 512-bucket "
        f"fold (24 column launches)")
    record = dict(results["triangle"])
    for shape in results:
        if shape != "triangle":
            record.update({f"{shape}_{key}": val
                           for key, val in results[shape].items()
                           if key != "bound_by"})
    return record


def sparse_specs():
    """The K2 patterns held on the card: the default kernel policy's spec
    for the 512 bucket (block 32, window 1, one global block), a banded
    block-128 one and (timed only) a banded block-16 one."""
    from alphafold2_tpu_torch import ModelConfig
    from alphafold2_tpu_torch.ops.block_sparse import KernelSpec
    from alphafold2_tpu_torch.serve.bucketing import default_policy
    from alphafold2_tpu_torch.serve.kernelpolicy import KernelPolicy
    policy = KernelPolicy.from_model_config(ModelConfig(),
                                            default_policy().edges)
    return {"default": policy.spec_for(SPARSE_BUCKET),
            "banded128": KernelSpec.banded(SPARSE_BUCKET, 128),
            "banded16": KernelSpec.banded(SPARSE_BUCKET, 16)}


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
    one more call at the default scale; bf16 in both layouts (the
    mma.sync tile, 1, and the warpgroup kernel, 3)."""
    from alphafold2_tpu_torch.ops import attention as attn
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
        ref = bs.block_sparse_reference(**dict(kw, **{
            key: kw[key].float() for key in ("q", "k", "v")}))
        layouts = {"rule": None} if dtype == torch.float32 else {
            layout: layout for layout in (attn.TILE, attn.WARPGROUP)}
        tol = TOLERANCE[dtype]
        errs = {}
        for name, layout in layouts.items():
            if layout is None:
                out = bs.block_sparse_attention(**kw)
            else:
                out = bs._launch(*(kw[key] for key in ("q", "k", "v",
                                                       "plan")),
                                 layout=layout, **{
                                     key: kw[key] for key in (
                                         "bias", "bias_repeat", "k_mask",
                                         "heads", "scale")})
            torch.cuda.synchronize()
            errs[name] = float((out.float() - ref).abs().max())
            if not errs[name] <= tol or not torch.isfinite(out).all():
                raise AssertionError(f"block_sparse {shape} {pname} {dtype} "
                                     f"layout {name}: max abs err "
                                     f"{errs[name]} > {tol}")
            del out
        del ref
        log(f"check block_sparse {shape} {pname} ({spec.label}, live "
            f"{spec.live_fraction:.4f}) {str(dtype)[6:]} scale "
            f"{'default' if scale is None else scale} "
            f"B={kw['q'].shape[0]} N={kw['q'].shape[1]}: max abs err " +
            ", ".join(f"{e:.3e}" if name == "rule" else
                      f"layout {name} {e:.3e}" for name, e in errs.items()) +
            f" (tolerance {tol:.0e})")
        worst[dtype] = max(worst.get(dtype, 0.0), *errs.values())
    return worst


def block_sparse_bound(kw, spec):
    """(bound ms, 'bytes' | 'operations', bytes, flops) of one K2 call:
    q, k, v read and out written once, the live bias tiles, the key mask
    and the plan read once; the live blocks' two products."""
    q, bias = kw["q"], kw.get("bias")
    b, n, d = q.shape
    live, blk = int(spec.pattern_array().sum()), spec.block
    nbytes = (4 * b * n * d * q.element_size()
              + (0 if bias is None else bias.shape[0] * live * blk * blk * 4)
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
    q, bias, heads = kw["q"], kw.get("bias"), kw["heads"]
    b, n = q.shape[:2]
    live = torch.as_tensor(spec.token_mask(), device=q.device)
    add_mask = torch.zeros(b, n, n, device=q.device) if bias is None else \
        bias.reshape(-1, heads, n, n).repeat_interleave(
            kw["bias_repeat"], dim=0).reshape(b, n, n)
    keep = kw["k_mask"].repeat_interleave(heads, dim=0)[:, None, :]
    add_mask = add_mask.masked_fill(~keep, attn.MASK_VALUE)
    return add_mask.masked_fill(~live, float("-inf")).to(dtype)


def k2_layout_turns(kw, iters):
    """K2's bf16 layouts at this launch, the mma.sync tile (1) and the
    warpgroup kernel (3), timed by profiler device time in turns (1, 3,
    3, 1). Returns {layout: [ms of the first turn, ms of the second]}."""
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.ops import block_sparse as bs
    args = [kw[key] for key in ("q", "k", "v", "plan")]
    rest = {key: kw[key] for key in ("bias", "bias_repeat", "k_mask",
                                     "heads", "scale")}
    times = {}
    for layout in (attn.TILE, attn.WARPGROUP, attn.WARPGROUP, attn.TILE):
        times.setdefault(layout, []).append(device_ms(
            lambda: bs._launch(*args, layout=layout, **rest), iters=iters))
    return times


def phase_time_block_sparse():
    """K2 at the 512 bucket's shapes in bf16 under the default policy's
    pattern (live 0.2891), the banded block-128 one (live 0.875) and the
    banded block-16 one (live 0.1504): kernel (CUDA events, and profiler
    device time per launch), K1 on the same shape with the pattern as an
    additive bias (the masked backend: the dense cost, both clocks), the
    bound, the plain version and an SDPA yardstick on the equivalent
    dense additive mask; K2's two bf16 layouts by profiler device time in
    turns (`k2_layout_turns`), each beside its share of the bound and the
    layout the rule picks. The patterns are three measured points of the
    K2/dense crossover in live fraction. The JSON record carries the
    default pattern's triangle shape and the rest under `<shape>_*`,
    `banded128_<shape>_*` and `banded16_<shape>_*`."""
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
            plain_ms = cuda_ms(lambda: bs.block_sparse_reference(**kw),
                               iters=max(iters // 2, 3))
            # yardstick only: one library call on the equivalent mask
            add_mask = sparse_sdpa_mask(kw, spec, dtype)
            library_ms = cuda_ms(
                lambda: sdpa(q, k, v, attn_mask=add_mask, scale=1.0),
                iters=max(iters // 2, 3))
            del add_mask
            entry.update(plain_ms=plain_ms, library_ms=library_ms)
            extra = f", plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms"
            bound_ms, bound_by, nbytes, flops = block_sparse_bound(kw, spec)
            entry.update(bound_ms=bound_ms, bound_by=bound_by,
                         share=bound_ms / dev_ms)
            turns = k2_layout_turns(kw, iters)
            log(f"time block_sparse {shape} {pname} bf16 B={b} N={n} D={d} "
                f"({spec.label}, live {spec.live_fraction:.4f}): kernel "
                f"{ms:.4f} ms (events), {dev_ms:.4f} ms (profiler device "
                f"time); K1 with the pattern as bias {dense_ms:.4f} ms "
                f"(events), {dense_dev_ms:.4f} ms (profiler){extra}, bound "
                f"{bound_ms:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.3f} GFLOP), {100 * bound_ms / dev_ms:.1f} % "
                f"of bound; K2 / dense {dev_ms / dense_dev_ms:.3f} [{CARD}]")
            mean = {key: sum(val) / len(val) for key, val in turns.items()}
            picked = bs.kernel_layout(spec.block, n, d, dtype, True)
            log(f"  K2 layouts by profiler device time in turns (ms): " +
                "; ".join(f"{key}: " + ", ".join(f"{t:.4f}" for t in val) +
                          f" ({100 * bound_ms / mean[key]:.1f} % of bound)"
                          for key, val in turns.items()) +
                f"; the rule picks {picked}, the faster is "
                f"{min(mean, key=mean.get)}")
            for key, val in mean.items():
                entry[f"layout{key}_ms"] = val
                entry[f"layout{key}_share"] = bound_ms / val
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
    kernels = sum(calls for _, calls in rows.values())
    log(f"profile {title}: {kernels} kernels, device busy "
        f"{busy_us / 1e3:.1f} ms; unprofiled "
        f"wall {wall_us / 1e3:.1f} ms (median of {unprofiled}: "
        f"{[round(w / 1e3, 1) for w in walls]}), busy "
        f"{100 * busy_us / wall_us:.1f} %; wall under the profiler "
        f"{traced_us / 1e3:.1f} ms [{CARD}]")
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


def k1_device_ms(run):
    """K1's device ms in one call of `run` under torch.profiler (device
    activity only, so the host is slowed the least)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and re.search(r"fused_attention\w*_kernel", e.key)) / 1e3


# unprofiled folds per turn of the fold-level A/B, whose median is the
# turn's wall
AB_WALLS = 4


def phase_fold_ab(runs):
    """Fold-level A/B of K1's layout rule in this one call: each of `runs`
    ({name: fold}) under the rule before the warpgroup layout
    (`previous_rule`) and under `ops.attention.kernel_layout`, swapped in
    the module, in turns (old, new, new, old). Per turn: the median wall
    of AB_WALLS unprofiled folds, the first of which also counts K1's
    launches (equal under both rules: the rule picks a layout, not a
    number of launches), and K1's device ms in one profiled fold. Returns
    {name: {rule: [turns]}}."""
    from alphafold2_tpu_torch.ops import attention as attn
    rules = {"old": previous_rule, "new": attn.kernel_layout}
    out = {}
    try:
        for name, run in runs.items():
            turns = out[name] = {"old": [], "new": []}
            for rule in ("old", "new", "new", "old"):
                attn.kernel_layout = rules[rule]
                walls = []
                for i in range(AB_WALLS):
                    result, _, k1, seconds, _ = count_fold(run)
                    if i == 0:
                        check_result(result, BUCKET)
                        launches = k1
                    walls.append(seconds * 1e3)
                turns[rule].append(dict(
                    k1_launches=launches, wall_ms=float(np.median(walls)),
                    k1_device_ms=k1_device_ms(run)))
            launches = {t["k1_launches"] for ts in turns.values() for t in ts}
            if len(launches) != 1:
                raise AssertionError(f"fold-ab {name}: K1 launches differ "
                                     f"between the rules: {turns}")
            mean = {rule: {key: float(np.mean([t[key] for t in ts]))
                           for key in ("wall_ms", "k1_device_ms")}
                    for rule, ts in turns.items()}
            log(f"fold-ab {name}: K1 launches {launches.pop()} under both "
                f"rules; old rule wall " + ", ".join(
                    f"{t['wall_ms']:.1f}" for t in turns["old"]) +
                " ms, K1 " + ", ".join(
                    f"{t['k1_device_ms']:.2f}" for t in turns["old"]) +
                " ms; new rule wall " + ", ".join(
                    f"{t['wall_ms']:.1f}" for t in turns["new"]) +
                " ms, K1 " + ", ".join(
                    f"{t['k1_device_ms']:.2f}" for t in turns["new"]) +
                f" ms (means: wall {mean['old']['wall_ms']:.1f} -> "
                f"{mean['new']['wall_ms']:.1f} ms, K1 "
                f"{mean['old']['k1_device_ms']:.2f} -> "
                f"{mean['new']['k1_device_ms']:.2f} ms) [{CARD}]")
    finally:
        attn.kernel_layout = rules["new"]
    return out


def previous_k2_rule(block, n, d, dtype, has_bias):
    """K2's layout rule before the warpgroup layout: the CUDA-core kernel
    for fp32, the mma.sync tile for bf16 (the signature of
    `ops.block_sparse.kernel_layout`)."""
    from alphafold2_tpu_torch.ops import attention as attn
    return attn.F32 if dtype != torch.bfloat16 else attn.TILE


def k2_device_ms(run):
    """K2's device ms in one call of `run` under torch.profiler (device
    activity only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and re.search(r"block_sparse\w*_kernel", e.key)) / 1e3


def phase_fold_ab_k2(run, want):
    """Fold-level A/B of K2's layout rule in this one call: the 512-bucket
    executor fold `run` under the rule before the warpgroup layout
    (`previous_k2_rule`) and under `ops.block_sparse.kernel_layout`,
    swapped in the module, in turns (old, new, new, old). Per turn: the
    median wall of AB_WALLS unprofiled folds, the first of which also
    counts K2's launches (`want`, under both rules), and K2's device ms in
    one profiled fold. Returns {rule: [turns]}."""
    from alphafold2_tpu_torch.ops import block_sparse as bs
    rules = {"old": previous_k2_rule, "new": bs.kernel_layout}
    turns = {"old": [], "new": []}
    try:
        for rule in ("old", "new", "new", "old"):
            bs.kernel_layout = rules[rule]
            walls = []
            for i in range(AB_WALLS):
                result, k2, _, seconds, _ = count_fold(run)
                if i == 0:
                    check_result(result, SPARSE_BUCKET)
                    launches = k2
                walls.append(seconds * 1e3)
            turns[rule].append(dict(
                k2_launches=launches, wall_ms=float(np.median(walls)),
                k2_device_ms=k2_device_ms(run)))
    finally:
        bs.kernel_layout = rules["new"]
    launches = {t["k2_launches"] for ts in turns.values() for t in ts}
    if launches != {want}:
        raise AssertionError(f"fold-ab-k2: K2 launches {turns}")
    mean = {rule: {key: float(np.mean([t[key] for t in ts]))
                   for key in ("wall_ms", "k2_device_ms")}
            for rule, ts in turns.items()}
    log(f"fold-ab-k2 512-bucket executor fold: K2 launches {launches.pop()} "
        f"under both rules; old rule wall " + ", ".join(
            f"{t['wall_ms']:.1f}" for t in turns["old"]) + " ms, K2 " +
        ", ".join(f"{t['k2_device_ms']:.2f}" for t in turns["old"]) +
        " ms; new rule wall " + ", ".join(
            f"{t['wall_ms']:.1f}" for t in turns["new"]) + " ms, K2 " +
        ", ".join(f"{t['k2_device_ms']:.2f}" for t in turns["new"]) +
        f" ms (means: wall {mean['old']['wall_ms']:.1f} -> "
        f"{mean['new']['wall_ms']:.1f} ms, K2 "
        f"{mean['old']['k2_device_ms']:.2f} -> "
        f"{mean['new']['k2_device_ms']:.2f} ms) [{CARD}]")
    return turns


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


# the end-to-end training phases (BASELINE configs 3 and 4 at the
# default ModelConfig's widths): crop lengths, steps after one warm-up
# step, and K1 launches per step predicted from the code (PERF.md
# section 6): the remat trunk launches 4 per layer forward and 4 in each
# layer's recompute; the reversible trunk 4 per layer forward, 4 in each
# layer's inversion and 4 in its re-linearisation; the refiners, NeRF and
# the losses launch none
END2END_STEPS = 3
END2END_EGNN_LENGTH = 64
END2END_SE3_LENGTH = 256
END2END_SE3_REFINEMENT = 4
K1_PER_LAYER = {"remat": 8, "reversible": 12}
# the reversible trunk's checks: fp32 reconstruction and gradients at
# full width (fp32 sums in another order through six layers), and the
# bf16 reconstruction of the trained trunk (8 bits of mantissa per
# coupling: the JAX package measures ~1e-2 of drift per 10 layers)
REV_CHECK_LENGTH = 128
REV_RECON_TOL = {torch.float32: 1e-3, torch.bfloat16: 1e-1}
REV_GRAD_TOL = 1e-3
# card against CPU for the refiners and the NeRF build-out (fp32): the
# largest difference, absolute and over the largest output value (the
# noise-moved modules put out values up to ~250; fp32 sums in another
# order read 1e-6 to 1.1e-4 absolute, 4e-9 to 5e-7 relative on an
# NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6)
REFINER_CHECK_LENGTH = 64
REFINER_CHECK_TOL = 1e-3
REFINER_CHECK_REL_TOL = 1e-5
EVALUATE_PDB = os.path.join("tests", "data", "1h22_head.pdb")


def end2end_config(tmp, length):
    """The default ModelConfig (dim 256, depth 6, heads 8, dim_head 64,
    bf16 trunk) on `length`-residue synthetic crops, 5 MSA rows, one
    warm-up step and END2END_STEPS more, each logged."""
    from alphafold2_tpu_torch.config import Experiment
    exp = Experiment()
    exp.data.crop_len = length
    exp.data.msa_depth = MSA_ROWS
    exp.train.num_steps = 1 + END2END_STEPS
    exp.train.log_every = 1
    path = os.path.join(tmp, "exp.json")
    with open(path, "w") as f:
        f.write(exp.to_json())
    return path


def run_end2end(tag, length, flags, per_layer):
    """The port's scripts/train_end2end.py in-process on the card: step
    walls (its StepTimer, synchronised), K1 launches per step, peak
    memory, finite losses and gradients; then a profile of one more step
    (where its time goes). Returns (record, model)."""
    import tempfile

    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.scripts import train_end2end
    from alphafold2_tpu_torch.train.state import TrainState
    from alphafold2_tpu_torch.utils import StepTimer

    launches, grads_finite, states, timers = [], [], [], []

    class CountingTimer(StepTimer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            timers.append(self)

        def start(self):
            super().start()
            self.k1_before = attn.launch_count.value

        def stop(self):
            super().stop()
            launches.append(attn.launch_count.value - self.k1_before)

    apply = TrainState.apply_gradients

    def checked(self, grads):
        norms = torch._foreach_norm([g for g in grads if g is not None])
        grads_finite.append(torch.isfinite(torch.stack(norms)).all())
        states[:] = [self]
        return apply(self, grads)

    with tempfile.TemporaryDirectory() as tmp:
        cfg = end2end_config(tmp, length)
        train_end2end.StepTimer, TrainState.apply_gradients = \
            CountingTimer, checked
        try:
            reset_peak()
            reset_launches()
            t0 = time.perf_counter()
            history = train_end2end.main(["--config", cfg, *flags])
            total = time.perf_counter() - t0
            peak = peak_gib()
        finally:
            train_end2end.StepTimer, TrainState.apply_gradients = \
                StepTimer, apply
    (state,) = states
    model = state.model
    depth = len(model.net.rev.rev_layers) if model.net.rev is not None \
        else len(model.net.layers)
    want = per_layer * depth
    walls = [s * 1e3 for s in timers[0].durations]
    losses = [h["loss"] for h in history]
    finite = bool(torch.stack(grads_finite).all())
    log(f"{tag}: default ModelConfig (dim {model.dim}, depth {depth}, "
        f"bf16) "
        f"{' '.join(flags)}, {length} residues, {MSA_ROWS} MSA rows: "
        f"losses {[round(v, 4) for v in losses]}, step walls (after the "
        f"warm-up step) {[round(w, 2) for w in walls[1:]]} ms, warm-up "
        f"{walls[0]:.1f} ms, peak memory {peak:.3f} GiB, K1 launches per "
        f"step {launches} (predicted {want}), gradients finite {finite}, "
        f"script {total:.1f} s [{CARD}]")
    if not np.isfinite(losses).all() or not finite:
        raise AssertionError(f"{tag}: losses {losses}, finite grads "
                             f"{finite}")
    if set(launches) != {want}:
        raise AssertionError(f"{tag}: K1 launched {launches} times per "
                             f"step, predicted {want}")
    from alphafold2_tpu_torch.data.synthetic import synthetic_batch
    from alphafold2_tpu_torch.train import make_train_step
    step = make_train_step(model)
    batch = synthetic_batch(np.random.default_rng(0), seq_len=length,
                            msa_depth=MSA_ROWS, device=model.device)
    busy, wall, _ = phase_profile(lambda: step(state, batch),
                                  f"{tag} train step")
    return {"length": length, "flags": flags, "losses": losses,
            "step_ms": walls[1:], "warmup_ms": walls[0],
            "median_step_ms": float(np.median(walls[1:])),
            "peak_memory_gib": peak, "k1_launches_per_step": launches,
            "profiled_busy_ms": busy,
            "profiled_wall_ms": wall}, model


def phase_end2end_egnn():
    """BASELINE config 3's path: `train_end2end.py --structure-module
    egnn` on 64-residue crops."""
    record, _ = run_end2end("end2end-egnn", END2END_EGNN_LENGTH,
                            ["--structure-module", "egnn"],
                            K1_PER_LAYER["remat"])
    return record


def phase_end2end_se3_rev():
    """BASELINE config 4's path: `--structure-module se3
    --refinement-iters 4 --reversible` on 256-residue crops, then the
    reversible trunk's reconstruction and gradient checks."""
    record, model = run_end2end(
        "end2end-se3-rev", END2END_SE3_LENGTH,
        ["--structure-module", "se3", "--refinement-iters",
         str(END2END_SE3_REFINEMENT), "--reversible"],
        K1_PER_LAYER["reversible"])
    record.update(reversible_checks(model.net.rev))
    return record


def reversible_checks(trained):
    """The trained trunk (bf16) and an fp32 copy of it at full width:
    reconstruction of the inputs by inverting the forward, and (fp32)
    the reversible backward's gradients against plain autograd through
    the same layers."""
    from alphafold2_tpu_torch.config import ModelConfig
    from alphafold2_tpu_torch.model import reversible as rev
    cfg = ModelConfig()
    dev = next(trained.parameters()).device
    depth, dim = len(trained.rev_layers), cfg.dim
    g = torch.Generator().manual_seed(SEED + 11)
    n = REV_CHECK_LENGTH

    def draw(*shape):
        return torch.randn(*shape, generator=g).to(dev)

    x, m = draw(1, n, n, dim), draw(1, MSA_ROWS, n, dim)
    valid = torch.arange(n, device=dev) < n - n // 8
    pair_mask = (valid[:, None] & valid[None])[None]
    msa_mask = valid[None, None].expand(1, MSA_ROWS, n)
    fp32 = rev.ReversibleEvoformer(dim, depth, heads=cfg.heads,
                                   dim_head=cfg.dim_head).to(dev)
    fp32.load_state_dict(trained.state_dict())
    out = {}
    with torch.no_grad():
        for dtype, trunk in ((torch.bfloat16, trained),
                             (torch.float32, fp32)):
            streams = tuple(s.to(dtype) for s in (x, x, m, m))
            fwd = rev.run_layers(trunk.rev_layers, streams, pair_mask,
                                 msa_mask)
            back = rev.run_layers(trunk.rev_layers, fwd, pair_mask,
                                  msa_mask, inverse=True)
            err = max(float((a.float() - b.float()).abs().max())
                      for a, b in zip(back, streams)) / \
                max(float(s.float().abs().max()) for s in streams)
            out[f"reconstruction_err_{str(dtype)[6:]}"] = err
            log(f"end2end-se3-rev reversible trunk ({str(dtype)[6:]}, "
                f"depth {depth}, dim {dim}, n {n}, {MSA_ROWS} rows): "
                f"inverse of the forward against the inputs, max error over "
                f"the largest input {err:.3e} (tolerance "
                f"{REV_RECON_TOL[dtype]:.0e}) [{CARD}]")
            if not err <= REV_RECON_TOL[dtype]:
                raise AssertionError(f"reconstruction error {err}")

    params = list(fp32.parameters())

    def loss_of(pair, msa):
        return (pair.float() ** 2).mean() + (msa.float() ** 2).mean()

    leaves = [x.clone().requires_grad_(), m.clone().requires_grad_()]
    reset_launches()
    got = torch.autograd.grad(
        loss_of(*fp32(*leaves, pair_mask, msa_mask)), leaves + params)
    k1_rev = read_launches()[0]
    plain_leaves = [x.clone().requires_grad_(), m.clone().requires_grad_()]
    s = rev.run_layers(fp32.rev_layers, (plain_leaves[0], plain_leaves[0],
                                         plain_leaves[1], plain_leaves[1]),
                       pair_mask, msa_mask)
    ref = torch.autograd.grad(
        loss_of((s[0] + s[1]) * 0.5, (s[2] + s[3]) * 0.5),
        plain_leaves + params)
    scale = max(float(r.abs().max()) for r in ref)
    err = max(float((a - b).abs().max()) for a, b in zip(got, ref)) / scale
    log(f"end2end-se3-rev reversible backward (fp32, K1 {k1_rev} launches: "
        f"{depth} x 4 forward + {depth} x 8 inversion and "
        f"re-linearisation) against plain autograd through the same "
        f"layers: max gradient error over the largest gradient {err:.3e} "
        f"(tolerance {REV_GRAD_TOL:.0e}) [{CARD}]")
    if not err <= REV_GRAD_TOL or k1_rev != 12 * depth:
        raise AssertionError(f"reversible gradients: error {err}, K1 "
                             f"{k1_rev}")
    out["grad_err_fp32"] = err
    return out


def phase_evaluate():
    """`scripts/evaluate.py --pdb tests/data/1h22_head.pdb --recycles 3`
    on the card at the default ModelConfig: the metrics, K1 launches,
    and a predicted PDB that reads back."""
    import tempfile

    from alphafold2_tpu_torch.config import Experiment
    from alphafold2_tpu_torch.data import native
    from alphafold2_tpu_torch.scripts import evaluate
    pdb = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       EVALUATE_PDB)
    with tempfile.TemporaryDirectory() as tmp:
        cfg, out = os.path.join(tmp, "exp.json"), os.path.join(tmp,
                                                               "pred.pdb")
        with open(cfg, "w") as f:
            f.write(Experiment().to_json())
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            metrics = evaluate.main(["--pdb", pdb, "--config", cfg,
                                     "--recycles", str(NUM_RECYCLES),
                                     "--out", out])
        wall = time.perf_counter() - t0
        k1 = read_launches()[0]
        with open(out) as f:
            _, coords, atom_mask = native.parse_pdb(f.read())
    n = metrics["n_residues"]
    from alphafold2_tpu_torch.config import ModelConfig
    want = 4 * ModelConfig().depth * (NUM_RECYCLES + 1)
    log(f"evaluate: {EVALUATE_PDB} ({n} residues), default ModelConfig "
        f"(random weights), {NUM_RECYCLES} recycles: RMSD "
        f"{metrics['kabsch_rmsd']:.3f} A, TM {metrics['tm_score']:.4f}, "
        f"GDT-TS {metrics['gdt_ts']:.4f}, lDDT {metrics['lddt']:.4f}, "
        f"confidence {metrics['mean_confidence']:.4f}; K1 launches {k1} "
        f"(predicted {want}); the PDB reads back {coords.shape[0]} CA; "
        f"script {wall:.1f} s [{CARD}]")
    values = [metrics[k] for k in ("kabsch_rmsd", "tm_score", "gdt_ts",
                                   "lddt", "mean_confidence")]
    if not np.isfinite(values).all() or k1 != want or \
            coords.shape[0] != n or not atom_mask[:, 1].all():
        raise AssertionError(f"evaluate: {metrics}, K1 {k1}")
    return dict(metrics, k1_launches=k1, wall_s=wall)


def phase_refiners_check():
    """Each refiner kind (egnn, en, se3, the atom-level EGNN) and the
    NeRF build-out: the card against the CPU in fp32, same weights (the
    model's initialisation, moved by noise) and inputs; the error is the
    largest difference over the largest output value."""
    from alphafold2_tpu_torch.core.nerf import sidechain_container
    from alphafold2_tpu_torch.model import refiners
    from alphafold2_tpu_torch.model.primitives import init_weights
    dim, n = 256, REFINER_CHECK_LENGTH
    rng = np.random.default_rng(SEED + 12)

    def arr(*shape, scale=1.0):
        return torch.as_tensor(rng.standard_normal(shape,
                                                   dtype=np.float32) * scale)

    h, x, edges = arr(1, n, dim), arr(1, n, 3, scale=5.0), arr(1, n, n, dim)
    mask = torch.arange(n)[None] < n - 8
    seq = torch.as_tensor(rng.integers(0, 21, (1, n)))
    ca = torch.cumsum(arr(1, n, 3) + torch.tensor([3.8, 0.0, 0.0]), dim=1)
    cases = {kind: (refiners.Refiner(dim, kind=kind, iters=2,
                                     edge_dim=dim),
                    (h, x), {"edges": edges, "mask": mask})
             for kind in ("egnn", "en", "se3")}
    cases["egnn-atom"] = (refiners.AtomEGNNRefiner(dim, iters=2),
                          (h, ca, seq), {"mask": mask})
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    errors = {}
    try:
        for kind, (module, args, kw) in cases.items():
            init_weights(module, torch.Generator().manual_seed(SEED + 13))
            perturb(module, SEED + 14)
            with torch.no_grad():
                cpu = module(*args, **kw)
                module.to("cuda")
                gpu = module(*(a.cuda() for a in args),
                             **{k: v.cuda() for k, v in kw.items()})
            errors[kind] = compare(cpu, [b.cpu() for b in gpu])
        backbone = torch.stack([ca - torch.tensor([1.2, 0.6, 0.0]), ca,
                                ca + torch.tensor([1.2, -0.6, 0.3])], dim=2)
        cpu = sidechain_container(backbone, seq)
        gpu = sidechain_container(backbone.cuda(), seq.cuda())
        errors["sidechain_container"] = compare([cpu], [gpu.cpu()])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    log(f"refiners-check card vs cpu (fp32, dim {dim}, n {n}, 2 "
        f"iterations; sidechain_container at {n} residues), max abs err / "
        f"largest value = error: "
        + ", ".join(f"{k} {e['abs_err']:.3e} / {e['max_value']:.1f} = "
                    f"{e['err']:.3e}" for k, e in errors.items())
        + f" (tolerance {REFINER_CHECK_TOL:.0e} absolute, "
        f"{REFINER_CHECK_REL_TOL:.0e} relative) [{CARD}]")
    if not (max(e["abs_err"] for e in errors.values()) <= REFINER_CHECK_TOL
            and max(e["err"] for e in errors.values())
            <= REFINER_CHECK_REL_TOL):
        raise AssertionError(f"refiners differ on the card: {errors}")
    return errors


# the README-era menu's phases: the documented interleaved
# block-sparse menu at full width, depth 12, through `predict.fold` in the
# 512 bucket (512 and 437 residues, the padded tail in K2's key mask) and
# unpadded at 300 residues (300 % 32 != 0: the sparse rows take K1 with
# the pattern as a -1e9 bias); K1 and K2 launches a fold counted from the
# code: the full layers launch 4 K1 a pass, the sparse layers 3 K1 (the
# column and the two triangle attentions) and 1 K2 or, at 300, 4 K1
MENU_DEPTH = 12
MENU_SPARSE = [True, False] * 6
MENU_FOLD_LENGTHS = (512, 437)
MENU_UNPADDED_LENGTH = 300
MENU_FOLD_LAUNCHES = {512: (4 * 6 + 3 * 6, 6), 300: (4 * 12, 0)}
# the other menus, one 256-bucket fold each at the default depth 6: K1 a
# pass (kron: its row is K1 at Nq = 256, Nk = 512; linear and compress
# rows are plain PyTorch; conv adds none); the reversible conv trunk's
# train step launches 12 per layer (forward, inversion,
# re-linearisation)
MENU_VARIANTS = {
    "kron": (dict(kron_attn=True), 4 * 6),
    "linear_favor": (dict(linear_attn=True), 3 * 6),
    "compress2": (dict(kv_compress_ratio=2), 3 * 6),
    "conv": (dict(use_conv=True), 4 * 6),
}
MENU_REV_CONV_LAUNCHES = 12 * 6
MENU_VARIANT_LENGTH = 200
# the menu's training path: train_distogram.py --data on the 72 residues
# of tests/data/1h22_head.pdb (64-residue crops) with the interleaved
# menu at depth 6, dropout 0; under gradients each layer launches 4 K1
# forward and 4 in its recompute (the sparse rows take the pattern bias)
MENU_TRAIN_STEPS = 3
MENU_TRAIN_CROP = 64
MENU_TRAIN_LAUNCHES = 8 * 6
# menu-parity: each menu model small (dim 64, depth 4, heads 4, dim_head
# 16), fp32, the card against the CPU at 64 residues (48 real), blocks
# of 32 so the sparse rows run K2 on the card
MENU_PARITY = {
    "sparse_interleaved": dict(sparse_self_attn=[True, False] * 2),
    "kron": dict(kron_attn=True),
    "linear_favor": dict(linear_attn=True, performer_nb_features=32),
    "linear_elu": dict(linear_attn=True, linear_attn_kind="elu"),
    "compress": dict(kv_compress_ratio=[2, 0, 3, 0]),
    "conv": dict(use_conv=True),
    "reversible_conv": dict(reversible=True, use_conv=True),
}


def menu_model(depth=6, **menu):
    """The default ModelConfig with coordinates (dim 256, heads 8,
    dim_head 64, bf16 trunk) and `menu`, seeded random weights moved by
    noise, on the card."""
    from alphafold2_tpu_torch import ModelConfig
    cfg = ModelConfig(predict_coords=True, depth=depth, **menu)
    model = cfg.build(device="cuda",
                      generator=torch.Generator().manual_seed(SEED))
    perturb(model, SEED + 1)
    return cfg, model


def menu_request(rng, length, bucket):
    from alphafold2_tpu_torch.data.synthetic import pad_to, synthetic_batch
    req = synthetic_batch(rng, seq_len=length, msa_depth=MSA_ROWS,
                          with_coords=False)
    return {key: pad_to(val, bucket, axis=val.dim() - 1)
            for key, val in req.items()}


def menu_kernel_inputs(shape, dtype, seed):
    """One launch of this slice's new shapes (heads 8, D 64, 5 MSA rows
    folded into B = 40): K2 at the 512 bucket's model-level sparse row
    (no bias, the padded tail in the key mask), K1 at the Kronecker row
    (Nq = 256 residues over Nk = 512 pooled tokens, the pooled padding
    masked), and K1 at the unpadded 300-residue sparse row (the pattern
    as a -1e9 bias of one head group replayed over the 5 rows), the
    pattern and bias as the model's `banded_route` makes them; or K1 at
    one of MENU_K1_SHAPES. Returns (kernel inputs, valid query rows)."""
    from alphafold2_tpu_torch.model.attention_variants import banded_route
    dev = torch.device("cuda")
    if shape in MENU_K1_SHAPES:
        return (attention_inputs(shape, dtype, dev, seed),
                MENU_K1_SHAPES[shape][2])
    g = torch.Generator(device=dev).manual_seed(seed)
    heads, rows = 8, MSA_ROWS

    def randn(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=dev) * scale

    if shape == "menu_k2_row_512":
        n, valid = SPARSE_BUCKET, 437
        kw = dict(plan=banded_route(n, 32, 1, 1, dev)[1], heads=heads,
                  scale=1.0,
                  k_mask=(torch.arange(n, device=dev) < valid)[None]
                  .repeat(rows, 1))
        nq = nk = n
    elif shape == "menu_k1_kron":
        nq, valid = BUCKET, 200
        nk = 2 * BUCKET
        real = torch.arange(BUCKET, device=dev) < valid
        q_mask = real[None].repeat(rows, 1)
        k_mask = torch.cat([real, real])[None].repeat(rows, 1)
        kw = dict(bias=None, q_mask=q_mask, k_mask=k_mask, heads=heads,
                  bias_repeat=1)
    elif shape == "menu_k1_pattern_300":
        nq = nk = valid = MENU_UNPADDED_LENGTH
        full = torch.ones(rows, nq, dtype=torch.bool, device=dev)
        bias = banded_route(nq, 32, 1, 1, dev)[2].expand(
            1, heads, nq, nq).reshape(-1, nq, nq)
        kw = dict(bias=bias.contiguous(), q_mask=full, k_mask=full,
                  heads=heads, bias_repeat=rows)
    else:
        raise ValueError(f"unknown menu shape {shape!r}")
    b = rows * heads
    kw.update(q=randn(b, nq, 64, scale=0.5).to(dtype),
              k=randn(b, nk, 64, scale=0.5).to(dtype),
              v=randn(b, nk, 64).to(dtype))
    return kw, valid


MENU_SHAPES = ("menu_k2_row_512", "menu_k1_kron",
               "menu_k1_pattern_300") + tuple(MENU_K1_SHAPES)


def phase_menu_check():
    """This slice's new kernel shapes against the plain versions (in fp32
    on the same values), fp32 and bf16, at valid query rows, under the
    check phases' gates; then each timed in bf16 (events and profiler
    device time), beside its plain version, one SDPA call computing the
    same function and the bound. Returns (worst errors by kernel and
    dtype, {shape: times})."""
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.model.attention_variants import banded_route
    from alphafold2_tpu_torch.ops import block_sparse as bs
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst, times = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        for shape in MENU_SHAPES:
            kw, valid = menu_kernel_inputs(shape, dtype, seed=6)
            sparse = shape.startswith("menu_k2")
            fn = bs.block_sparse_attention if sparse else \
                attn.fused_attention
            # K1's plain version over chunks of B where its fp32 logits
            # pass 2 GiB (the 512 triangle's are 4 GiB)
            plain = bs.block_sparse_reference if sparse else \
                lambda **kw: plain_attention(kw)
            out = fn(**kw)
            torch.cuda.synchronize()
            ref = plain(**dict(kw, **{key: kw[key].float()
                                      for key in ("q", "k", "v")}))
            err = float((out.float() - ref)[:, :valid].abs().max())
            tol = TOLERANCE[dtype]
            kernel = "block_sparse_attention" if sparse else \
                "fused_attention"
            log(f"menu-check {kernel} {shape} {str(dtype)[6:]} "
                f"B={kw['q'].shape[0]} Nq={kw['q'].shape[1]} "
                f"Nk={kw['k'].shape[1]}: max abs err {err:.3e} at "
                f"{valid} valid query rows (tolerance {tol:.0e})")
            if not err <= tol or not torch.isfinite(out[:, :valid]).all():
                raise AssertionError(f"menu-check {shape} {dtype}: max abs "
                                     f"err {err} > {tol}")
            del out, ref
            key = (kernel, dtype)
            worst[key] = max(worst.get(key, 0.0), err)
            if dtype != torch.bfloat16:
                continue
            run = lambda: fn(**kw)
            ms = cuda_ms(run, iters=30)
            # a launch this short can leave the profiler's buffer empty:
            # once more over more launches, else not measured (None) and
            # the bound share read against the events time
            dev_ms = device_ms(run, iters=30) or device_ms(run, iters=200) \
                or None
            plain_ms = cuda_ms(lambda: plain(**kw), iters=5)
            q, k, v = kw["q"], kw["k"], kw["v"]
            if sparse:
                # the model's row pattern is this serving spec
                spec = banded_route(SPARSE_BUCKET, 32, 1, 1, q.device)[0]
                add_mask = sparse_sdpa_mask(kw, spec, dtype)
                bound_ms, bound_by, _, _ = block_sparse_bound(kw, spec)
            else:
                add_mask = sdpa_mask(kw, dtype)
                bound_ms, bound_by, _, _ = attention_bound(kw)
            library_ms = cuda_ms(lambda: sdpa(q, k, v, attn_mask=add_mask,
                                              scale=1.0), iters=5)
            del add_mask
            times[shape] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                library_ms=library_ms, bound_ms=bound_ms,
                                bound_by=bound_by)
            dev_text = "not measured" if dev_ms is None else \
                f"{dev_ms:.4f} ms"
            log(f"menu-time {kernel} {shape} bf16: kernel {ms:.4f} ms "
                f"(events), {dev_text} (profiler device time), plain "
                f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}), "
                f"{100 * bound_ms / (dev_ms or ms):.1f} % of bound "
                f"[{CARD}]")
    return worst, times


def phase_menu_parity():
    """Each menu model small and in fp32: the card (K1, K2) against the
    CPU (their plain versions), same weights and inputs, folded with 2
    recycles at 64 residues (48 real), coordinates at real residues
    within 1e-3; the sparse menu must launch K2 on the card."""
    from alphafold2_tpu_torch import ModelConfig, fold
    from alphafold2_tpu_torch.data.synthetic import synthetic_batch
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for name, menu in MENU_PARITY.items():
        cfg = ModelConfig(dim=64, depth=4, heads=4, dim_head=16,
                          predict_coords=True, bfloat16=False, **menu)
        cpu_model = cfg.build(device="cpu",
                              generator=torch.Generator().manual_seed(SEED))
        perturb(cpu_model, SEED + 1)
        gpu_model = cfg.build(device="cuda")
        gpu_model.load_state_dict(cpu_model.state_dict())
        batch = synthetic_batch(np.random.default_rng(SEED), seq_len=64,
                                msa_depth=3, with_coords=False,
                                pad_fraction=0.25)
        ref = fold(cpu_model, **batch, num_recycles=2, device="cpu")
        reset_launches()
        out = fold(gpu_model, **batch, num_recycles=2, device="cuda")
        k1, k2 = read_launches()
        err = float((out.coords.cpu() - ref.coords)[:, :48].abs().max())
        top = float(ref.coords[:, :48].abs().max())
        errs[name] = err
        log(f"menu-parity {name} (dim 64, depth 4, n 64, 2 recycles) card "
            f"vs cpu: coords max abs err {err:.3e} of {top:.1f} (tolerance "
            f"1e-3), K1 {k1}, K2 {k2} launches")
        if not err <= 1e-3 or not torch.isfinite(out.coords).all():
            raise AssertionError(f"menu-parity {name}: {err}")
        if name == "sparse_interleaved" and k2 != 2 * 3:
            raise AssertionError(f"menu-parity {name}: K2 launched {k2} "
                                 f"times, expected 6")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev
    return errs


def phase_menu_fold():
    """The documented menu, `sparse_self_attn=[True, False] * 6` at depth
    12 (MIGRATING.md), full width, through `predict.fold`: 512 and 437
    residues in the 512 bucket, then 300 unpadded. Each fold's wall, peak
    memory and K1/K2 launches against the counts from the code; then a
    profile of one 512 fold (K2's share of device time)."""
    from alphafold2_tpu_torch import fold
    cfg, model = menu_model(MENU_DEPTH, sparse_self_attn=MENU_SPARSE)
    rng = np.random.default_rng(SEED + 12)
    folds = []
    for length, bucket in [(n, SPARSE_BUCKET) for n in MENU_FOLD_LENGTHS] \
            + [(MENU_UNPADDED_LENGTH, MENU_UNPADDED_LENGTH)]:
        req = menu_request(rng, length, bucket)
        result, k2, k1, seconds, peak = count_fold(
            lambda: fold(model, **req, num_recycles=NUM_RECYCLES))
        check_result(result, bucket)
        per_pass = MENU_FOLD_LAUNCHES[512 if bucket == SPARSE_BUCKET
                                      else 300]
        want = tuple(c * (NUM_RECYCLES + 1) for c in per_pass)
        log(f"menu-fold {length} residues (bucket {bucket}), depth "
            f"{MENU_DEPTH}, sparse_self_attn [True, False] x 6: "
            f"{seconds * 1e3:.1f} ms wall, peak memory "
            f"{peak / 2**30:.3f} GiB, K1 {k1} and K2 {k2} launches "
            f"(predicted {want[0]} and {want[1]}) [{CARD}]")
        if (k1, k2) != want:
            raise AssertionError(f"menu-fold {length}: K1 {k1}, K2 {k2}, "
                                 f"predicted {want}")
        folds.append({"length": length, "bucket": bucket,
                      "wall_ms": seconds * 1e3,
                      "peak_gib": peak / 2**30, "k1": k1, "k2": k2})
        if length == MENU_FOLD_LENGTHS[0]:
            req512 = req
    busy, wall, table = phase_profile(
        lambda: fold(model, **req512, num_recycles=NUM_RECYCLES),
        f"menu fold {MENU_FOLD_LENGTHS[0]} residues, depth {MENU_DEPTH}, "
        f"interleaved sparse", unprofiled=3)
    k2_ms = table.get("block_sparse_attention (K2)", (0.0, 0))[0]
    k1_ms = table.get("fused_attention (K1)", (0.0, 0))[0]
    if busy > 0:
        log(f"menu-fold profile: K2 {k2_ms:.3f} ms "
            f"({100 * k2_ms / busy:.3f} %), K1 {k1_ms:.2f} ms "
            f"({100 * k1_ms / busy:.1f} %) of {busy:.1f} ms device time, "
            f"{100 * busy / wall:.1f} % busy")
    else:
        log("menu-fold profile: the profiler saw no device time; K2's "
            "share not measured")
    return {"folds": folds, "profile_busy_ms": busy,
            "profile_wall_ms": wall, "k2_device_ms": k2_ms,
            "k1_device_ms": k1_ms,
            "k2_share": k2_ms / busy if busy > 0 else None}


def phase_menu_variants():
    """The other menus at full width, depth 6: one 256-bucket fold each
    (wall, peak, K1 launches against the count from the code), then one
    train step of the reversible trunk with conv couplings."""
    from alphafold2_tpu_torch import fold
    from alphafold2_tpu_torch.data.synthetic import synthetic_batch
    from alphafold2_tpu_torch.train import (TrainState, adam,
                                            make_train_step)
    rng = np.random.default_rng(SEED + 13)
    out = {}
    for name, (menu, per_pass) in MENU_VARIANTS.items():
        _, model = menu_model(**menu)
        req = menu_request(rng, MENU_VARIANT_LENGTH, BUCKET)
        fold(model, **req, num_recycles=0)          # warm-up pass
        result, k2, k1, seconds, peak = count_fold(
            lambda: fold(model, **req, num_recycles=NUM_RECYCLES))
        check_result(result, BUCKET)
        want = per_pass * (NUM_RECYCLES + 1)
        log(f"menu-variants {name}: fold {MENU_VARIANT_LENGTH} residues "
            f"(bucket {BUCKET}), depth 6, {seconds * 1e3:.1f} ms wall, peak "
            f"memory {peak / 2**30:.3f} GiB, K1 {k1} (predicted {want}), "
            f"K2 {k2} [{CARD}]")
        if (k1, k2) != (want, 0):
            raise AssertionError(f"menu-variants {name}: K1 {k1}, K2 {k2}")
        out[name] = {"wall_ms": seconds * 1e3, "peak_gib": peak / 2**30,
                     "k1": k1}
        del model
    _, model = menu_model(reversible=True, use_conv=True)
    state = TrainState.create(model, adam(3e-4, 1), seed=SEED)
    step = make_train_step(model)
    batch = synthetic_batch(np.random.default_rng(SEED), seq_len=BUCKET,
                            msa_depth=MSA_ROWS, device=model.device)
    state, _ = step(state, batch)                   # warm-up step
    reset_peak()
    reset_launches()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    k1, k2 = read_launches()
    seconds = time.perf_counter() - t0
    loss = float(metrics["loss"])
    log(f"menu-variants reversible_conv: train step at {BUCKET} residues, "
        f"depth 6, {seconds * 1e3:.1f} ms wall, peak memory "
        f"{peak_gib():.3f} GiB, loss {loss:.4f}, K1 {k1} (predicted "
        f"{MENU_REV_CONV_LAUNCHES}), K2 {k2} [{CARD}]")
    if (k1, k2) != (MENU_REV_CONV_LAUNCHES, 0) or not np.isfinite(loss):
        raise AssertionError(f"menu-variants reversible_conv: K1 {k1}, "
                             f"K2 {k2}, loss {loss}")
    out["reversible_conv_train_step"] = {"wall_ms": seconds * 1e3,
                                         "peak_gib": peak_gib(), "k1": k1,
                                         "loss": loss}
    return out


def run_script(tag, main_fn, module, argv):
    """One of the port's training scripts in-process on the card, its
    StepTimer counting K1 and K2 launches per step. Returns (history,
    K1 per step, K2 per step, step walls in ms, peak GiB)."""
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.ops import block_sparse as bs
    from alphafold2_tpu_torch.utils import StepTimer
    k1s, k2s, timers = [], [], []

    class CountingTimer(StepTimer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            timers.append(self)

        def start(self):
            super().start()
            self.before = (attn.launch_count.value, bs.launch_count.value)

        def stop(self):
            super().stop()
            k1s.append(attn.launch_count.value - self.before[0])
            k2s.append(bs.launch_count.value - self.before[1])

    module.StepTimer = CountingTimer
    try:
        reset_peak()
        history = main_fn(argv)
        peak = peak_gib()
    finally:
        module.StepTimer = StepTimer
    walls = [s * 1e3 for s in timers[0].durations]
    losses = [h["loss"] for h in history]
    log(f"menu-train {tag}: losses {[round(v, 4) for v in losses]}, step "
        f"walls {[round(w, 1) for w in walls]} ms (the first a warm-up), "
        f"peak memory {peak:.3f} GiB, K1 per step {k1s}, K2 per step {k2s} "
        f"[{CARD}]")
    if not np.isfinite(losses).all():
        raise AssertionError(f"menu-train {tag}: losses {losses}")
    return history, k1s, k2s, walls, peak


def phase_menu_train():
    """The menu's training path at full width: train_distogram.py with the
    interleaved menu JSON on a trRosetta-style directory this phase writes
    (an .a3m of tests/data/1h22_head.pdb and the PDB), then on a
    sidechainnet pickle `corpus_from_pdb` writes from the same PDB
    (--scn), then train_end2end.py --data on the directory. K1 per step
    against the count from the code; K2 never (forward only)."""
    import pickle
    import shutil
    import tempfile

    from alphafold2_tpu_torch.config import Experiment
    from alphafold2_tpu_torch.data import featurize, native
    from alphafold2_tpu_torch.data.sidechainnet import corpus_from_pdb
    from alphafold2_tpu_torch.scripts import train_distogram, train_end2end
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        os.makedirs(data)
        with open(EVALUATE_PDB) as f:
            seq = featurize.detokenize(native.parse_pdb(f.read())[0])
        rng = np.random.default_rng(SEED)
        rows = [seq] + ["".join("-" if rng.random() < 0.2 else c
                                for c in seq) for _ in range(MSA_ROWS - 1)]
        with open(os.path.join(data, "1h22.a3m"), "w") as f:
            f.write("".join(f">r{i}\n{r}\n" for i, r in enumerate(rows)))
        shutil.copy(EVALUATE_PDB, os.path.join(data, "1h22.pdb"))
        scn = os.path.join(tmp, "scn.pkl")
        with open(scn, "wb") as f:
            pickle.dump({"train": corpus_from_pdb([EVALUATE_PDB])}, f)
        exp = Experiment()
        exp.model.sparse_self_attn = [True, False] * 3
        exp.model.attn_dropout = exp.model.ff_dropout = 0.0
        exp.data.crop_len, exp.data.msa_depth = MENU_TRAIN_CROP, MSA_ROWS
        exp.train.num_steps, exp.train.log_every = MENU_TRAIN_STEPS, 1
        cfg = os.path.join(tmp, "menu.json")
        with open(cfg, "w") as f:
            f.write(exp.to_json())
        for tag, main_fn, module, argv in (
                ("distogram --data", train_distogram.main, train_distogram,
                 ["--config", cfg, "--data", data]),
                ("distogram --scn", train_distogram.main, train_distogram,
                 ["--config", cfg, "--scn", scn]),
                ("end2end --data", train_end2end.main, train_end2end,
                 ["--config", cfg, "--data", data])):
            history, k1s, k2s, walls, peak = run_script(tag, main_fn, module,
                                                        argv)
            if set(k1s) != {MENU_TRAIN_LAUNCHES} or set(k2s) != {0}:
                raise AssertionError(f"menu-train {tag}: K1 {k1s}, K2 "
                                     f"{k2s}, predicted "
                                     f"{MENU_TRAIN_LAUNCHES} and 0")
            out[tag] = {"losses": [h["loss"] for h in history],
                        "step_ms": walls, "peak_gib": peak,
                        "k1_per_step": k1s, "k2_per_step": k2s}
        cached = [f for f in os.listdir(data) if ".feat-" in f]
        if len(cached) != 1:
            raise AssertionError(f"menu-train: cache files {cached}")
    return out


# the mesh phase's train steps, and the ring phase's key shards
MESH_STEPS = 3
RING_SHARDS = (2, 4)
# fp32 gates of the mesh phase (the one-rank mesh runs the same local
# ops; only summation order may differ) and of the ring phase (phase
# 3's fp32 tolerance). Parameters are held absolutely: 3 Adam steps at
# 3e-4 move one by at most 9e-4, and Adam's m / sqrt(v) turns fp32
# rounding in a near-zero gradient into up to the whole step, so a gap
# relative to the largest update says little
MESH_LOSS_RTOL = 1e-5
MESH_PARAM_ATOL = 1e-4
RING_ATOL = TOLERANCE[torch.float32]


def contract_model(**kw):
    """The train phase's contract architecture (dim 256, depth 2, heads
    8, dim_head 64, unrolled trunk) in fp32, seeded."""
    from alphafold2_tpu_torch import Alphafold2
    return Alphafold2(dim=256, depth=2, heads=8, dim_head=64,
                      use_scan=False, dtype=torch.float32, device="cuda",
                      generator=torch.Generator().manual_seed(SEED), **kw)


def mesh_train(model, batch, mesh):
    """MESH_STEPS steps through `train.fit` (on `mesh` when given, the
    state placed by `shard_pytree_tp_zero`): (losses, K1 launches a
    step, the state's bytes on this rank, the unplaced state's)."""
    import itertools
    from alphafold2_tpu_torch.parallel import (pytree_bytes_per_device,
                                               shard_pytree_tp_zero)
    from alphafold2_tpu_torch.train import TrainState, adam, fit
    state = TrainState.create(model, adam(3e-4), seed=SEED + 2)
    whole = pytree_bytes_per_device(state)
    if mesh is not None:
        state = shard_pytree_tp_zero(state, mesh)
    placed = pytree_bytes_per_device(state)
    reset_launches()
    state, history = fit(model, state, itertools.repeat(batch), MESH_STEPS,
                         log_every=1, mesh=mesh)
    k1, _ = read_launches()
    return [h["loss"] for h in history], k1 / MESH_STEPS, placed, whole


def phase_mesh():
    """A one-rank NCCL process group (FileStore rendezvous in a temporary
    directory): the (pipe, data, i, j) mesh over the card; the contract
    architecture in fp32 with ring_attention=True trained MESH_STEPS
    steps on the mesh (state placed by shard_pytree_tp_zero) against the
    same steps without a mesh; the 256 bucket folded under the mesh and
    without; a "named" fold-checkpoint leaf round-tripped on the card."""
    import tempfile
    import torch.distributed as dist
    from alphafold2_tpu_torch import ModelConfig, fold
    from alphafold2_tpu_torch.cache import checkpoints as ckpt
    from alphafold2_tpu_torch.data.synthetic import pad_to, synthetic_batch
    from alphafold2_tpu_torch.parallel import (NamedSharding, PartitionSpec,
                                               is_dtensor, make_mesh,
                                               use_mesh)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = make_mesh()
            try:
                make_mesh(2, 1, 1)
                raise AssertionError("make_mesh(2, 1, 1) on one rank did "
                                     "not raise")
            except ValueError as e:
                out["refusal"] = str(e)
            log(f"mesh: {mesh}; make_mesh(2, 1, 1) raises: "
                f"{out['refusal']}")

            plain, ring = contract_model(), contract_model(
                ring_attention=True)
            ring.load_state_dict(plain.state_dict())
            start = {n: p.detach().clone()
                     for n, p in plain.named_parameters()}
            batch = synthetic_batch(np.random.default_rng(SEED + 1),
                                    batch=1, seq_len=BUCKET,
                                    msa_depth=MSA_ROWS)
            t0 = time.perf_counter()
            ref_losses, ref_k1, _, whole = mesh_train(plain, batch, None)
            plain_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            losses, k1, placed, _ = mesh_train(ring, batch, mesh)
            mesh_s = time.perf_counter() - t0
            loss_err = max(abs(a - b) / abs(b)
                           for a, b in zip(losses, ref_losses))
            params = dict(ring.named_parameters())
            top = max(float((p.detach() - start[n]).abs().max())
                      for n, p in plain.named_parameters())
            param_gap = max(float((params[n].detach() - p.detach())
                                  .abs().max())
                            for n, p in plain.named_parameters())
            out["train"] = dict(
                losses=losses, ref_losses=ref_losses, loss_rel_err=loss_err,
                param_abs_err=param_gap, largest_update=top,
                update_rel_err=param_gap / top, k1_per_step=k1,
                ref_k1_per_step=ref_k1, state_bytes=placed,
                unplaced_state_bytes=whole, wall_s=mesh_s,
                ref_wall_s=plain_s)
            log(f"mesh train (contract architecture, fp32, ring_attention, "
                f"{MESH_STEPS} steps, {BUCKET} residues): losses {losses} "
                f"vs {ref_losses} without the mesh (largest relative gap "
                f"{loss_err:.3e}); updated parameters' gap {param_gap:.3e} "
                f"(the largest update {top:.3e}); K1 {k1:g} a step vs "
                f"{ref_k1:g}; "
                f"state bytes {placed} vs {whole}; {mesh_s:.1f} s vs "
                f"{plain_s:.1f} s")
            if not (loss_err <= MESH_LOSS_RTOL
                    and param_gap <= MESH_PARAM_ATOL):
                raise AssertionError("the meshed steps differ from the "
                                     "steps without a mesh")
            if k1 != ref_k1 or k1 <= 0:
                raise AssertionError(f"K1 launched {k1} times a step on "
                                     f"the mesh, {ref_k1} without")
            if placed != whole:
                raise AssertionError(f"placed state {placed} B on one rank "
                                     f"!= {whole} B unplaced")
            del plain, ring, start, params

            model = ModelConfig(predict_coords=True).build(
                device="cuda", generator=torch.Generator().manual_seed(SEED))
            perturb(model, SEED + 1)
            req = synthetic_batch(np.random.default_rng(SEED + 2),
                                  seq_len=LENGTHS[-1], msa_depth=MSA_ROWS,
                                  with_coords=False)
            req = {key: pad_to(val, BUCKET, axis=val.dim() - 1)
                   for key, val in req.items()}
            ref, ref_k2, ref_k1, ref_s, _ = count_fold(
                lambda: fold(model, **req, num_recycles=NUM_RECYCLES))
            with use_mesh(mesh):
                got, k2, k1, got_s, peak = count_fold(
                    lambda: fold(model, **req, num_recycles=NUM_RECYCLES))
            check_result(got, BUCKET)
            gap = float((got.coords - ref.coords).abs().max())
            out["fold"] = dict(coords_gap=gap, k1=k1, ref_k1=ref_k1,
                               wall_ms=got_s * 1e3, ref_wall_ms=ref_s * 1e3,
                               peak_gib=peak / 2**30)
            log(f"mesh fold {LENGTHS[-1]} residues (bucket {BUCKET}, default "
                f"model): coords gap {gap:.3e} to the fold without the "
                f"mesh; K1 {k1} vs {ref_k1}; {got_s * 1e3:.1f} ms vs "
                f"{ref_s * 1e3:.1f} ms")
            if gap > 1e-3 or k1 != ref_k1 or (k2, ref_k2) != (0, 0):
                raise AssertionError("the meshed fold differs")
            del model

            leaf = np.random.default_rng(SEED).standard_normal(
                (1, BUCKET, 3)).astype(np.float32)
            spec = ckpt.sharding_spec(NamedSharding(
                mesh, PartitionSpec("data", "i")))
            row = ckpt.RowCheckpoint(fold_key="mesh", model_tag="", age=0,
                                     seq=np.zeros(BUCKET, np.int32),
                                     leaves=[("dev", leaf, spec)])
            key = ckpt.checkpoint_key("mesh", "", 0)
            back = ckpt.decode_checkpoint(key,
                                          ckpt.encode_checkpoint(key, row))
            restored = back.restore_leaves()[0]
            if not (is_dtensor(restored) and restored.device.type == "cuda"
                    and np.array_equal(restored.full_tensor().cpu().numpy(),
                                       leaf)):
                raise AssertionError("the named checkpoint leaf did not "
                                     "restore onto the mesh")
            out["checkpoint"] = dict(spec=spec, bytes=leaf.nbytes)
            log(f"mesh checkpoint: {spec} restored as a DTensor on the card, "
                f"bit-equal")
        finally:
            dist.destroy_process_group()
    return out


def ring_accumulate(kw, shards):
    """Phase 3's K1 inputs (fp32) attended in `shards` key blocks with
    `parallel.ring._block_attend`, the per-rank step of a ring of that
    many ranks: the bias replayed over the fold and the key mask as -1e9,
    as the ring adds them."""
    from alphafold2_tpu_torch.parallel.ring import _block_attend
    heads = kw["heads"]
    b, n, d = kw["q"].shape
    q, k, v = (kw[key].reshape(b // heads, heads, -1, d)
               for key in ("q", "k", "v"))
    bias = kw["bias"][None]                              # (1, h, n, n)
    keys_ok = kw["k_mask"][:, None, None, :]
    acc = q.new_zeros(q.shape)
    row_max = q.new_full(q.shape[:-1], -float("inf"))
    row_sum = q.new_zeros(q.shape[:-1])
    size = n // shards
    for s in range(shards):
        cut = slice(s * size, (s + 1) * size)
        blk = bias[..., cut] + torch.where(keys_ok[..., cut], 0.0, -1e9)
        acc, row_max, row_sum = _block_attend(
            q, k[:, :, cut], v[:, :, cut], blk, acc, row_max, row_sum)
    return (acc / row_sum[..., None]).reshape(b, n, d)


def phase_ring():
    """The ring's arithmetic at full width: K1's 512 triangle shape of
    phase 3 (B = 4096, N = 512, D = 64, 437 real residues, bias replayed
    over 512) in fp32, split into RING_SHARDS key shards in one process
    and accumulated with `_block_attend`, against K1 on the whole at
    every valid query; one `_block_attend` step at S = 4 (a four-card
    ring's per-rank work) timed beside K1 with CUDA events."""
    from alphafold2_tpu_torch.ops import attention as attn
    from alphafold2_tpu_torch.parallel.ring import _block_attend
    kw = attention_inputs("menu_k1_triangle_512", torch.float32,
                          torch.device("cuda"), seed=7)
    reset_launches()
    whole = attn.fused_attention(**kw)
    k1_launches, _ = read_launches()
    valid = kw["q_mask"].repeat_interleave(kw["heads"], dim=0)
    out = {"k1_launches": k1_launches}
    for shards in RING_SHARDS:
        got = ring_accumulate(kw, shards)
        err = float((got - whole)[valid].abs().max())
        out[f"max_abs_err_s{shards}"] = err
        log(f"ring S={shards}: _block_attend accumulation vs K1 on the "
            f"whole (fp32, valid queries): max abs err {err:.3e}")
        if not err <= RING_ATOL:
            raise AssertionError(f"the S={shards} ring differs from K1")
        del got
    heads = kw["heads"]
    b, n, d = kw["q"].shape
    size = n // 4
    q, k, v = (kw[key].reshape(b // heads, heads, -1, d)
               for key in ("q", "k", "v"))
    blk = kw["bias"][None][..., :size] + torch.where(
        kw["k_mask"][:, None, None, :size], 0.0, -1e9)
    state = (q.new_zeros(q.shape), q.new_full(q.shape[:-1], -float("inf")),
             q.new_zeros(q.shape[:-1]))
    kb, vb = k[:, :, :size].contiguous(), v[:, :, :size].contiguous()
    out["block_attend_ms_s4"] = cuda_ms(
        lambda: _block_attend(q, kb, vb, blk, *state), iters=10)
    out["k1_ms"] = cuda_ms(lambda: attn.fused_attention(**kw), iters=10)
    log(f"ring: one _block_attend step at S=4 (B={b}, Nq={n}, Nk={size}, "
        f"fp32) {out['block_attend_ms_s4']:.4f} ms (events); K1 on the "
        f"whole {out['k1_ms']:.4f} ms")
    return out


# the slice phase: the 256 bucket's 131 residues through a one-rank
# group on the card; with more cards, the 512 bucket's 437 residues on
# slices of 2 and 4 cards. Tolerance: JAX's for a meshed fold
# (tests/test_serve_mesh.py), 1e-3 A, where each rank keeps whole rows
# (one rank, 1 x j). A slice that shards the rows (i > 1) hands cuBLAS
# blocks of another shape, whose fp32 sums round otherwise (the first
# pass 1.4e-3-2.3e-3 A off on four cards), and recycling's distance
# buckets turn that into whole angstroms: its first pass is held within
# 1e-2 A, and its fold's gap is printed beside the gap that a one-ulp
# nudge of one projection makes on one card (`nudged_fold`)
SLICE_ATOL = 1e-3
SLICE_ROWS_ATOL = 1e-2
SLICE_SPARSE_LENGTH = SPARSE_LENGTHS[1]
SLICE_REPEATS = 2


def slice_batch(length, bucket, seed):
    from alphafold2_tpu_torch import serve
    (req,) = serve_requests((length,), seed)
    batch, _ = serve.BucketPolicy((bucket,)).assemble(
        [req], bucket, 1, msa_depth=MSA_ROWS, device="cuda")
    return batch, length


def coords_gap(got, ref, length):
    """Largest coordinate difference (A) over the real residues."""
    return float((got.coords.float().cpu()[:, :length]
                  - ref.coords.float().cpu()[:, :length]).abs().max())


def slice_step_loop(ex, batch, devices, steps, stop_after=None):
    """init and `steps` steps; with `stop_after`, the state after that
    many steps instead."""
    state = ex.run_init(batch, devices=devices)
    for r in range(steps if stop_after is None else stop_after):
        state = ex.run_step(batch, state, r, devices=devices)
    return state


def one_rank_executor(model):
    """A FoldExecutor whose one-card slice runs on a one-rank group (a
    process of its own under a 1 x 1 mesh) instead of in this process,
    so the check holds the rank path against the in-process one."""
    from alphafold2_tpu_torch.serve import FoldExecutor
    ex = FoldExecutor(model)

    def on_group(devices, mesh_shape):
        devices = [torch.device(d) for d in devices]
        ids = tuple(str(d) for d in devices)
        return ex._group(devices, ids, (1, 1)), ids, (1, 1)

    ex._slice = on_group
    return ex


def slice_one_card(model):
    """Part one of the slice phase (module doc, phase 24)."""
    from alphafold2_tpu_torch.predict import (restore_step_state,
                                              snapshot_step_state)
    from alphafold2_tpu_torch.serve import FoldExecutor
    from alphafold2_tpu_torch.serve.slices import to_local
    card = [torch.device("cuda", 0)]
    batch, n = slice_batch(LENGTHS[-1], BUCKET, SEED + 10)
    ex = FoldExecutor(model)
    gx = one_rank_executor(model)
    gx.prestart(card)
    (group,) = gx.groups()
    # the in-process reference while the rank starts
    ex.run(batch, NUM_RECYCLES)
    ref, ref_k2, ref_k1, ref_s, _ = count_fold(
        lambda: ex.run(batch, NUM_RECYCLES))
    group.wait_ready()
    startup = [group.startup_s]
    gx.run(batch, NUM_RECYCLES, devices=card)
    group.rank_stats(reset=True)
    t0 = time.perf_counter()
    got = gx.run(batch, NUM_RECYCLES, devices=card)
    got_s = time.perf_counter() - t0
    (rank,) = group.rank_stats()
    gap = coords_gap(got, ref, n)
    dist = np.asarray(got.distogram)
    if not np.isfinite(dist).all() or dist.shape[:3] != (1, BUCKET, BUCKET):
        raise AssertionError(f"bad distogram from the rank {dist.shape}")
    out = {"coords_gap": gap, "k1_rank": rank["k1"], "k2_rank": rank["k2"],
           "k1_in_process": ref_k1, "wall_ms": got_s * 1e3,
           "in_process_wall_ms": ref_s * 1e3,
           "reply_bytes": group.last_reply_bytes,
           "reply_transfer_ms": group.last_transfer_s * 1e3,
           "rank_fold_ms": group.last_rank_s * 1e3,
           "rank_startup": group.rank_startup,
           "peak_gib_rank": rank["peak_bytes"] / 2**30}
    log(f"slice one card: one-rank group fold {n} residues (bucket "
        f"{BUCKET}): coords gap {gap:.3e} A to the in-process executor; K1 "
        f"{rank['k1']} on the rank vs {ref_k1} in process (K2 "
        f"{rank['k2']} vs {ref_k2}); wall {got_s * 1e3:.1f} ms vs "
        f"{ref_s * 1e3:.1f} ms in process (the rank's own fold "
        f"{group.last_rank_s * 1e3:.1f} ms); reply {group.last_reply_bytes}"
        f" B in {group.last_transfer_s * 1e3:.2f} ms; group start-up "
        f"{group.startup_s:.1f} s ({group.rank_startup})")
    if not gap <= SLICE_ATOL or rank["k1"] != ref_k1 or rank["k1"] <= 0 \
            or (rank["k2"], ref_k2) != (0, 0):
        raise AssertionError("the one-rank group's fold differs")

    unbroken = to_local(slice_step_loop(gx, batch, card, NUM_RECYCLES))
    local = slice_step_loop(ex, batch, None, NUM_RECYCLES)
    state = slice_step_loop(gx, batch, card, NUM_RECYCLES,
                            stop_after=NUM_RECYCLES - 1)
    snap = snapshot_step_state(state)
    group.kill()
    restored = restore_step_state(snap)
    t0 = time.perf_counter()
    final = gx.run_step(batch, restored, NUM_RECYCLES - 1, devices=card)
    restart_s = time.perf_counter() - t0
    (fresh,) = gx.groups()
    startup.append(fresh.startup_s)
    final = to_local(final)
    same = all(torch.equal(a, b) for a, b in (
        (final.coords, unbroken.coords),
        (final.confidence, unbroken.confidence),
        (final.distogram, unbroken.distogram),
        (final.recyclables.pairwise_repr,
         unbroken.recyclables.pairwise_repr)))
    loop_gap = coords_gap(final, local, n)
    out.update(step_loop_byte_equal=same, step_loop_gap_in_process=loop_gap,
               restart_step_s=restart_s, startup_s=startup)
    log(f"slice one card: step loop (init + {NUM_RECYCLES} steps) "
        f"snapshotted after {NUM_RECYCLES - 1} steps, group killed, "
        f"restored, last step on a fresh group ({restart_s:.1f} s with its "
        f"start-up): byte-equal to the unbroken loop: {same}; coords gap "
        f"{loop_gap:.3e} A to the in-process loop; start-up seconds "
        f"{[round(x, 2) for x in startup]}")
    gx.close()
    if not same or not loop_gap <= SLICE_ATOL:
        raise AssertionError("the restored step loop differs")
    return out


def nudged_fold(ex, batch, recycles, spec):
    """A fold in process with the first layer's MSA column attention's
    query projection moved by one ulp at every element (its last bit
    flipped): rounding of the size a GEMM of another shape gives."""
    to_q = ex.model.get_submodule("net.layers.0.msa_attn.col_attn.attn.to_q")

    def nudge(module, args, out):
        bits = torch.int32 if out.dtype == torch.float32 else torch.int16
        return (out.view(bits) ^ 1).view(out.dtype)

    handle = to_q.register_forward_hook(nudge)
    try:
        return ex.run(batch, recycles, kernel=spec)
    finally:
        handle.remove()


def slice_executor_folds(cards):
    """The fp32 and bf16 default model at the 512 bucket through the
    executor: one card in process, then each multi-card slice (its
    group started beside the reference); on the one card, the same fold
    with one projection nudged by an ulp (`nudged_fold`), the witness
    of what rounding alone moves. Returns, per dtype and slice, the gap,
    walls and per-rank launches and peak memory."""
    from alphafold2_tpu_torch import ModelConfig, serve
    shapes = [(1, 2)] + ([(2, 2), (1, 4)] if len(cards) >= 4 else [])
    edges = serve.default_policy().edges
    out = {}
    for bf16 in (False, True):
        name = "bf16" if bf16 else "fp32"
        cfg = ModelConfig(predict_coords=True, bfloat16=bf16)
        model = cfg.build(device="cuda",
                          generator=torch.Generator().manual_seed(SEED))
        perturb(model, SEED + 1)
        spec = serve.KernelPolicy.from_model_config(cfg, edges).spec_for(
            SPARSE_BUCKET)
        batch, n = slice_batch(SLICE_SPARSE_LENGTH, SPARSE_BUCKET,
                               SEED + 11)
        ex = serve.FoldExecutor(model)
        for shape in shapes:
            ex.prestart(cards[:shape[0] * shape[1]], shape)
        ex.run(batch, NUM_RECYCLES, kernel=spec)
        walls = []
        for _ in range(SLICE_REPEATS):
            ref, k2, k1, sec, peak = count_fold(
                lambda: ex.run(batch, NUM_RECYCLES, kernel=spec))
            walls.append(sec * 1e3)
        # the slices' ranks share these cards
        torch.cuda.empty_cache()
        row = {"one_card": {"wall_ms": walls, "k1": k1, "k2": k2,
                            "peak_gib": peak / 2**30}}
        first = ex.run(batch, 0, kernel=spec)
        row["one_ulp_witness"] = {
            "first_pass_gap": coords_gap(nudged_fold(ex, batch, 0, spec),
                                         first, n),
            "coords_gap": coords_gap(nudged_fold(ex, batch, NUM_RECYCLES,
                                                 spec), ref, n),
            "rerun_gap": coords_gap(ex.run(batch, NUM_RECYCLES, kernel=spec),
                                    ref, n)}
        log(f"slice {name} one card, the first layer's MSA column "
            f"attention's to_q nudged by one ulp: coords gap "
            f"{row['one_ulp_witness']['coords_gap']:.3e} A after "
            f"{NUM_RECYCLES} recycles (first pass "
            f"{row['one_ulp_witness']['first_pass_gap']:.3e}); the fold "
            f"rerun unnudged {row['one_ulp_witness']['rerun_gap']:.3e} A")
        for shape in shapes:
            devs = cards[:shape[0] * shape[1]]
            t0 = time.perf_counter()
            ex.run(batch, NUM_RECYCLES, devices=devs, mesh_shape=shape,
                   kernel=spec)
            first_s = time.perf_counter() - t0
            pass_gap = coords_gap(ex.run(batch, 0, devices=devs,
                                         mesh_shape=shape, kernel=spec),
                                  first, n)
            group = next(g for g in ex.groups() if g.mesh_shape == shape)
            group.rank_stats(reset=True)
            walls = []
            for _ in range(SLICE_REPEATS):
                t0 = time.perf_counter()
                got = ex.run(batch, NUM_RECYCLES, devices=devs,
                             mesh_shape=shape, kernel=spec)
                walls.append((time.perf_counter() - t0) * 1e3)
            ranks = group.rank_stats()
            if not torch.isfinite(got.coords).all():
                raise AssertionError(f"{name} {shape}: non-finite coords")
            gap = coords_gap(got, ref, n)
            label = f"{shape[0]}x{shape[1]}"
            row[label] = {
                "coords_gap": gap, "first_pass_gap": pass_gap,
                "wall_ms": walls,
                "first_run_s": first_s, "startup_s": group.startup_s,
                "rank_startup": group.rank_startup,
                "k1_per_rank": [r["k1"] // SLICE_REPEATS for r in ranks],
                "k2_per_rank": [r["k2"] // SLICE_REPEATS for r in ranks],
                "peak_gib_per_rank": [r["peak_bytes"] / 2**30
                                      for r in ranks],
                "reply_bytes": group.last_reply_bytes,
                "reply_transfer_ms": group.last_transfer_s * 1e3,
                "rank_fold_ms": group.last_rank_s * 1e3}
            log(f"slice {name} fold {n} residues (bucket {SPARSE_BUCKET}, "
                f"{getattr(spec, 'label', 'dense')}) on {label}: coords "
                f"gap {gap:.3e} A to one card (first pass {pass_gap:.3e}); "
                f"wall {[round(w, 1) for w in walls]} ms vs "
                f"{[round(w, 1) for w in row['one_card']['wall_ms']]} ms "
                f"on one card (first run {first_s:.1f} s, start-up "
                f"{group.startup_s:.1f} s); per rank K1 "
                f"{row[label]['k1_per_rank']} K2 "
                f"{row[label]['k2_per_rank']} (one card K1 {k1} K2 {k2}); "
                f"peak GiB per rank "
                f"{[round(x, 2) for x in row[label]['peak_gib_per_rank']]}"
                f"; reply {group.last_reply_bytes} B in "
                f"{group.last_transfer_s * 1e3:.2f} ms")
            if any(r["k1"] <= 0 or r["k2"] <= 0 for r in ranks):
                raise AssertionError(f"{label}: a rank launched no K1 or K2")
            if not bf16 and not (gap <= SLICE_ATOL if shape[0] == 1
                                 else pass_gap <= SLICE_ROWS_ATOL):
                raise AssertionError(f"fp32 fold on {label} differs from "
                                     f"one card by {gap} A (first pass "
                                     f"{pass_gap} A)")
        out[name] = row
        ex.close()
        del ex, model
        torch.cuda.empty_cache()
    return out


def slice_scheduler(cards):
    """Two Schedulers over the fp32 default model with a RecyclePolicy
    and the default KernelPolicy: one card, and MeshPolicy({256: 1,
    512: 4}) over the cards (a 1 x 4 slice on four cards, the face a
    pool of cards gives four; 1 x 2 on two or three); the scheduler
    phase's six lengths from threads, one request a batch; every
    response of the sliced one within 1e-3 A of the one-card one's."""
    import threading

    from alphafold2_tpu_torch import ModelConfig, serve
    chips = 4 if len(cards) >= 4 else 2
    cfg = ModelConfig(predict_coords=True, bfloat16=False)
    model = cfg.build(device="cuda",
                      generator=torch.Generator().manual_seed(SEED))
    perturb(model, SEED + 1)
    edges = serve.default_policy().edges
    reqs = serve_requests(SCHED_LENGTHS, SEED + 7)

    def serve_all(mesh_policy):
        ex = serve.FoldExecutor(model)
        sched = serve.Scheduler(
            ex, serve.BucketPolicy(edges),
            serve.SchedulerConfig(max_batch_size=1, msa_depth=MSA_ROWS,
                                  num_recycles=NUM_RECYCLES),
            model_tag="chip_smoke-slice",
            registry=serve.MetricsRegistry(),
            metrics=serve.ServeMetrics(registry=serve.MetricsRegistry()),
            recycle_policy=serve.RecyclePolicy(),
            kernel_policy=serve.KernelPolicy.from_model_config(cfg, edges),
            mesh_policy=mesh_policy)
        t0 = time.perf_counter()
        sched.warmup()
        warm_s = time.perf_counter() - t0
        groups = ex.groups()
        for g in groups:
            g.rank_stats(reset=True)
        reset_launches()
        tickets = {}
        with sched:
            t0 = time.perf_counter()
            threads = [threading.Thread(target=lambda r=r: tickets.__setitem__(
                r.length, sched.submit(r))) for r in reqs]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            resps = {n: t.result(timeout=900) for n, t in tickets.items()}
            traffic_s = time.perf_counter() - t0
            ranks = [g.rank_stats() for g in groups]
        k1, k2 = read_launches()
        stats = sched.serve_stats()
        bad = [(n, r.status, r.error) for n, r in resps.items() if not r.ok]
        if bad:
            raise AssertionError(f"slice scheduler responses not ok: {bad}")
        return resps, {"warmup_s": warm_s, "traffic_s": traffic_s,
                       "k1_parent": k1, "k2_parent": k2,
                       "ranks": [[{k: r[k] for k in ("k1", "k2")} | {
                           "peak_gib": r["peak_bytes"] / 2**30}
                           for r in g] for g in ranks],
                       "groups": [g.stats() for g in groups],
                       "mesh": stats.get("mesh"),
                       "latency_ms": {n: r.latency_s * 1e3
                                      for n, r in resps.items()}}

    ref, ref_info = serve_all(None)
    policy = serve.MeshPolicy({BUCKET: 1, SPARSE_BUCKET: chips},
                              devices=cards)
    got, info = serve_all(policy)
    gaps = {n: float(np.abs(got[n].coords - ref[n].coords).max())
            for n in ref}
    info.update(coords_gap=gaps, one_card=ref_info)
    log(f"slice scheduler: MeshPolicy {policy.snapshot()['policy']} over "
        f"{len(cards)} cards, lengths {list(SCHED_LENGTHS)}, RecyclePolicy "
        f"({NUM_RECYCLES} steps): coords gap to the one-card scheduler "
        f"{ {n: f'{g:.2e}' for n, g in gaps.items()} } A; latency (ms) "
        f"{ {n: round(v, 1) for n, v in info['latency_ms'].items()} } vs "
        f"{ {n: round(v, 1) for n, v in ref_info['latency_ms'].items()} } "
        f"on one card; K1/K2 per rank of each group {info['ranks']}; in "
        f"the scheduler's process K1 {info['k1_parent']} K2 {info['k2_parent']}; warm-up "
        f"{info['warmup_s']:.1f} s; mesh stats {info['mesh']['folds']}")
    if not max(gaps.values()) <= SLICE_ATOL:
        raise AssertionError(f"sliced scheduler differs: {gaps}")
    sharded = sum(v["batches"] for k, v in info["mesh"]["folds"].items()
                  if k != "1x1")
    if sharded == 0 or any(r["k2"] <= 0 for g in info["ranks"] for r in g):
        raise AssertionError("no sharded batch, or a rank without K2")
    del model
    torch.cuda.empty_cache()
    return info


def phase_slice():
    """The serving executor's rank processes (module doc, phase 24)."""
    from alphafold2_tpu_torch import ModelConfig
    from alphafold2_tpu_torch.serve.meshpolicy import visible_devices
    model = ModelConfig(predict_coords=True).build(
        device="cuda", generator=torch.Generator().manual_seed(SEED))
    perturb(model, SEED + 1)
    out = {"one_card": slice_one_card(model)}
    del model
    torch.cuda.empty_cache()
    cards = visible_devices()
    if len(cards) < 2:
        log("slice: the multi-card part did not run: one card is visible")
        return out
    out["folds"] = slice_executor_folds(cards)
    out["scheduler"] = slice_scheduler(cards)
    return out


# the runners (phases 25-28): the 1H22 demo's protocol (at most this many
# steps, an eval every 250, early stop at 1 A, the demo's 2 A gate), the
# tiny trainer's steps, and the memory probe's sweep at BASELINE config
# 5's trunk (dim 256, 384 residues, depth up to 48)
DEMO_STEPS = 1500
DEMO_EVAL_EVERY = 250
DEMO_RECYCLES = 3
DEMO_TARGET_RMSD = 1.0
DEMO_GATE_RMSD = 2.0
DEMO_DEPTH = 2
TINY_STEPS = 20
TINY_DEPTH = 2
PROBE_LENGTH = 384
PROBE_DIM = 256
PROBE_DEPTHS = (2, 8, 48)
PROBE_REVERSIBLE_DEPTHS = (48,)
# the plain loop keeps every layer's activations: 6.1 GB a layer at 384
# residues on the card (18.2 GB of temp at depth 2, 30.3 at depth 4), so
# depth 8 needs ~55 GB of an 80 GB card and depth 48 ~300 GB, which is
# not run (PERF.md section 6)
PROBE_NO_SCAN_DEPTHS = (2, 4, 8)


def phase_runner_check():
    """K1 at RUNNER_K1_SHAPES against its plain version (in fp32 on the
    same values), in the dtype each runner uses, under TOLERANCE; then
    each timed in that dtype (events and profiler device time), beside
    its plain version, one SDPA call computing the same function and the
    bound. Returns (worst error by dtype, {shape: times})."""
    from alphafold2_tpu_torch.ops import attention as attn
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    worst, times = {}, {}
    for shape, spec in RUNNER_K1_SHAPES.items():
        dtype = spec[-1]
        kw = attention_inputs(shape, dtype, dev, seed=8)
        before = attn.launch_count.value
        out = attn.fused_attention(**kw)
        torch.cuda.synchronize()
        if attn.launch_count.value != before + 1:
            raise AssertionError(f"runner-check {shape}: K1 did not launch")
        ref = plain_attention(dict(kw, **{
            key: kw[key].float() for key in ("q", "k", "v")}))
        err = float((out.float() - ref).abs().max())
        tol = TOLERANCE[dtype]
        b, nq, d = kw["q"].shape
        log(f"runner-check fused_attention {shape} {str(dtype)[6:]} "
            f"B={b} Nq={nq} Nk={kw['k'].shape[1]} D={d} heads "
            f"{kw['heads']}: max abs err {err:.3e} (tolerance {tol:.0e})")
        if not err <= tol or not torch.isfinite(out).all():
            raise AssertionError(f"runner-check {shape} {dtype}: max abs "
                                 f"err {err} > {tol}")
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        del out, ref
        run = lambda: attn.fused_attention(**kw)  # noqa: E731
        iters = 20 if shape.endswith("triangle") else 50
        ms = cuda_ms(run, iters=iters)
        # a launch this short can leave the profiler's buffer empty: once
        # more over more launches, else not measured (None)
        dev_ms = device_ms(run, iters=iters) or \
            device_ms(run, iters=200) or None
        plain_ms = cuda_ms(lambda: plain_attention(kw), iters=5)
        add_mask = sdpa_mask(kw, dtype)
        try:
            library_ms = cuda_ms(lambda: sdpa(kw["q"], kw["k"], kw["v"],
                                              attn_mask=add_mask,
                                              scale=1.0), iters=5)
        except RuntimeError as e:   # the library has no kernel for it
            log(f"  sdpa refused {shape}: {str(e).splitlines()[0][:200]}")
            library_ms = None
        del add_mask
        bound_ms, bound_by, nbytes, flops = attention_bound(kw)
        times[shape] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                            library_ms=library_ms, bound_ms=bound_ms,
                            bound_by=bound_by)
        dev_text = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        lib = "refused" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"runner-time fused_attention {shape} {str(dtype)[6:]}: kernel "
            f"{ms:.4f} ms (events), {dev_text} (profiler device time), "
            f"plain {plain_ms:.4f} ms, sdpa {lib}, bound {bound_ms:.4f} ms "
            f"({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} "
            f"GFLOP), {100 * bound_ms / (dev_ms or ms):.1f} % of bound "
            f"[{CARD}]")
        del kw
    return worst, times


def phase_train_1h22():
    """The 1H22 memorization demo (`scripts/train_1h22.py
    --train-recycles 3`, at most DEMO_STEPS steps, an eval every
    DEMO_EVAL_EVERY, early stop at DEMO_TARGET_RMSD): the headline Kabsch
    RMSD must be below DEMO_GATE_RMSD and below the random-init row's,
    every metric finite, and K1's launches as predicted from the code:
    a train step of r recycles launches 4 a layer for each pass without
    gradients and 8 a layer for the last (forward and the remat
    recompute), a fold of n recycles 4 a layer a pass."""
    import tempfile

    from alphafold2_tpu_torch.scripts import train_1h22
    draws, step_s, folds = [], [], []
    make_step, fold_fn = train_1h22.make_recycled_train_step, \
        train_1h22.fold

    def counting_step(model, max_recycles):
        step = make_step(model, max_recycles)

        def timed(state, batch):
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            step_s.append(time.perf_counter() - t0)
            draws.append(int(metrics["recycles"]))
            return state, metrics
        return timed

    def counting_fold(*args, num_recycles, **kwargs):
        folds.append(num_recycles)
        return fold_fn(*args, num_recycles=num_recycles, **kwargs)

    train_1h22.make_recycled_train_step = counting_step
    train_1h22.fold = counting_fold
    try:
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches()
            reset_peak()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                out = train_1h22.main([
                    "--steps", str(DEMO_STEPS),
                    "--eval-every", str(DEMO_EVAL_EVERY),
                    "--target-rmsd", str(DEMO_TARGET_RMSD),
                    "--train-recycles", str(DEMO_RECYCLES),
                    "--out-dir", tmp])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k1 = read_launches()[0]
            peak = peak_gib()
            with open(out["log"]) as f:
                evals = [(row["step"], row["eval_rmsd"]) for row in
                         map(json.loads, f) if "eval_rmsd" in row]
    finally:
        train_1h22.make_recycled_train_step = make_step
        train_1h22.fold = fold_fn
    per_pass = 4 * DEMO_DEPTH
    want = sum(2 * per_pass + per_pass * r for r in draws) + \
        sum(per_pass * (1 + n) for n in folds)
    head, rnd = out["headline"], out["random_init_baseline"]
    other = out["recycles_0"]
    ms_step = 1e3 * sum(step_s) / len(step_s)
    log(f"train-1h22: {out['train_steps']} steps (r drawn: mean "
        f"{np.mean(draws):.3f}), wall {wall:.1f} s, {ms_step:.2f} ms a "
        f"step; evals (step, RMSD) {evals}; headline @{DEMO_RECYCLES} "
        f"recycles: RMSD {head['kabsch_rmsd']:.4f} A, TM "
        f"{head['tm_score']:.4f}, GDT-TS {head['gdt_ts']:.4f}, lDDT "
        f"{head['lddt']:.4f}, confidence {head['mean_confidence']:.4f} "
        f"(Pearson {head['confidence_lddt_pearson']}, MAE "
        f"{head['confidence_lddt_mae']:.4f}); @0 recycles RMSD "
        f"{other['kabsch_rmsd']:.4f} A; random init RMSD "
        f"{rnd['kabsch_rmsd']:.4f} A; K1 launches {k1} (predicted {want}: "
        f"{len(draws)} steps, {len(folds)} folds); peak {peak:.3f} GiB "
        f"[{CARD}]")
    values = [row[k] for row in (head, other, rnd) for k in (
        "kabsch_rmsd", "tm_score", "gdt_ts", "lddt", "mean_confidence")]
    if not np.isfinite(values).all():
        raise AssertionError(f"train-1h22: non-finite metrics {out}")
    if not head["kabsch_rmsd"] < DEMO_GATE_RMSD or \
            not head["kabsch_rmsd"] < rnd["kabsch_rmsd"]:
        raise AssertionError(
            f"train-1h22: headline RMSD {head['kabsch_rmsd']} A is not "
            f"below {DEMO_GATE_RMSD} A and the random-init "
            f"{rnd['kabsch_rmsd']} A")
    if k1 != want:
        raise AssertionError(f"train-1h22: K1 launched {k1} times, "
                             f"predicted {want}")
    return {"train_steps": out["train_steps"], "wall_s": wall,
            "ms_per_step": ms_step, "mean_recycles": float(np.mean(draws)),
            "evals": evals, "headline": head, "recycles_0": other,
            "random_init_baseline": rnd, "k1_launches": k1,
            "k1_predicted": want, "peak_gib": peak}


def phase_train_tiny():
    """`scripts/train_tiny.py` for TINY_STEPS steps: every loss finite,
    no step skipped by the guard, K1 8 a layer a step (remat)."""
    from alphafold2_tpu_torch.scripts import train_tiny
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        history = train_tiny.main([str(TINY_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = read_launches()[0]
    losses = [h["loss"] for h in history]
    skipped = sum(h["skipped"] for h in history)
    want = TINY_STEPS * 8 * TINY_DEPTH
    log(f"train-tiny: {TINY_STEPS} steps in {wall:.2f} s, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, skipped {skipped}, K1 "
        f"launches {k1} (predicted {want}) [{CARD}]")
    if len(losses) != TINY_STEPS or not np.isfinite(losses).all() or \
            skipped or k1 != want:
        raise AssertionError(f"train-tiny: losses {losses}, skipped "
                             f"{skipped}, K1 {k1} (predicted {want})")
    return {"losses": losses, "skipped": skipped, "wall_s": wall,
            "k1_launches": k1, "k1_per_step": k1 // TINY_STEPS}


def probe_label(row):
    """'d48_remat', 'd48_rev' or 'd2_plain' for a memory-probe row."""
    kind = "rev" if row["reversible"] else \
        "remat" if row["use_scan"] else "plain"
    return f"d{row['depth']}_{kind}"


def phase_memory_probe():
    """`tools/memory_probe.py`'s step at PROBE_LENGTH residues and dim
    PROBE_DIM: the remat trunk at PROBE_DEPTHS, the reversible trunk at
    PROBE_REVERSIBLE_DEPTHS and the plain loop at PROBE_NO_SCAN_DEPTHS,
    each row with its peak, step seconds and K1 launches a step against
    the prediction from the code (8 a layer under remat, 12 reversible,
    4 for the plain loop), and a finite loss."""
    from alphafold2_tpu_torch.tools import memory_probe
    runs = [(d, False, True) for d in PROBE_DEPTHS] + \
        [(d, True, True) for d in PROBE_REVERSIBLE_DEPTHS] + \
        [(d, False, False) for d in PROBE_NO_SCAN_DEPTHS]
    rows = []
    for depth, reversible, use_scan in runs:
        reset_launches()
        row = memory_probe.analyze(depth, PROBE_LENGTH, PROBE_DIM,
                                   reversible, use_scan=use_scan, run=True,
                                   device="cuda")
        k1 = read_launches()[0]
        want = depth * (12 if reversible else 8 if use_scan else 4)
        row.update(k1_launches=k1, k1_predicted=want)
        rows.append(row)
        kind = "reversible" if reversible else \
            "remat" if use_scan else "plain loop"
        log(f"memory-probe depth {depth} {kind}: state "
            f"{row['argument_size_mb']} MB, temp {row['temp_size_mb']} MB, "
            f"peak {row['peak_mb_in_use'] / 1024:.3f} GiB, step "
            f"{row['step_s']:.3f} s, loss {row['loss']:.4f}, K1 {k1} a "
            f"step (predicted {want}) [{CARD}]")
        if not np.isfinite(row["loss"]) or k1 != want:
            raise AssertionError(f"memory-probe: {row}")
    remat = [r for r in rows if r["use_scan"] and not r["reversible"]]
    log("memory-probe: remat temp MB by depth " + ", ".join(
        f"{r['depth']}: {r['temp_size_mb']}" for r in remat))
    return rows


def compare(cpu, gpu):
    """The largest difference over outputs, the largest CPU value and
    their ratio."""
    abs_err = max(float((a - b).abs().max()) for a, b in zip(cpu, gpu))
    top = max(float(a.abs().max()) for a in cpu)
    return {"abs_err": abs_err, "max_value": top, "err": abs_err / top}


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
    fold_ab = run("fold-ab", phase_fold_ab, {
        "fold": lambda: fold(model, **req, num_recycles=NUM_RECYCLES),
        "fold_full": lambda: fold(model, **full_req,
                                  num_recycles=NUM_RECYCLES, **feats)})
    del full_req, feats
    bs_launches, k1_sparse, ex, batch, spec = run("executor", phase_executor,
                                                  model, cfg)
    run("executor-profile", phase_profile,
        lambda: ex.run(batch, NUM_RECYCLES, kernel=spec),
        f"executor fold {SPARSE_LENGTHS[-1]} residues, bucket "
        f"{SPARSE_BUCKET} ({spec.label})")
    fold_ab_k2 = run("fold-ab-k2", phase_fold_ab_k2,
                     lambda: ex.run(batch, NUM_RECYCLES, kernel=spec),
                     bs_launches // len(SPARSE_LENGTHS))
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
    e2e_egnn = run("end2end-egnn", phase_end2end_egnn)
    e2e_rev = run("end2end-se3-rev", phase_end2end_se3_rev)
    evaluated = run("evaluate", phase_evaluate)
    refiner_errs = run("refiners-check", phase_refiners_check)
    menu_worst, menu_times = run("menu-check", phase_menu_check)
    for dtype in (torch.float32, torch.bfloat16):
        worst[dtype] = max(worst[dtype],
                           menu_worst[("fused_attention", dtype)])
        bs_worst[dtype] = max(bs_worst[dtype],
                              menu_worst[("block_sparse_attention", dtype)])
    menu_parity = run("menu-parity", phase_menu_parity)
    menu_fold = run("menu-fold", phase_menu_fold)
    menu_variants = run("menu-variants", phase_menu_variants)
    menu_train = run("menu-train", phase_menu_train)
    meshed = run("mesh", phase_mesh)
    ringed = run("ring", phase_ring)
    worst[torch.float32] = max(worst[torch.float32],
                               *(ringed[f"max_abs_err_s{s}"]
                                 for s in RING_SHARDS))
    sliced = run("slice", phase_slice)
    runner_worst, runner_times = run("runner-check", phase_runner_check)
    for dtype, err in runner_worst.items():
        worst[dtype] = max(worst[dtype], err)
    demo = run("train-1h22", phase_train_1h22)
    tiny = run("train-tiny", phase_train_tiny)
    probe = run("memory-probe", phase_memory_probe)
    log(f"phase seconds: {json.dumps(seconds)}")
    folds = {f["length"]: f for f in menu_fold["folds"]}
    menu_k1 = {f"{shape}_{key}": val
               for shape in MENU_SHAPES if shape.startswith("menu_k1")
               for key, val in menu_times[shape].items()}
    menu_k2 = menu_times["menu_k2_row_512"]
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
        "fold_ab": fold_ab,
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
        "launches_evaluate": evaluated["k1_launches"],
        "end2end_egnn": e2e_egnn,
        "end2end_se3_rev": e2e_rev,
        "evaluate": evaluated,
        "refiners_card_vs_cpu": refiner_errs,
        "launches_menu_fold_512": folds[512]["k1"],
        "launches_menu_fold_437": folds[437]["k1"],
        "launches_menu_fold_300": folds[MENU_UNPADDED_LENGTH]["k1"],
        "launches_menu_variants": {name: v["k1"] for name, v in
                                   menu_variants.items()},
        "launches_menu_train_step": menu_train["distogram --data"][
            "k1_per_step"][-1],
        "menu_fold": menu_fold,
        "menu_variants": menu_variants,
        "menu_train": menu_train,
        "menu_parity_card_vs_cpu": menu_parity,
        "launches_mesh_train_step": meshed["train"]["k1_per_step"],
        "launches_mesh_fold": meshed["fold"]["k1"],
        "mesh": meshed,
        "launches_slice_fold_rank": sliced["one_card"]["k1_rank"],
        "slice": sliced,
        "ring": ringed,
        "launches_train_1h22": demo["k1_launches"],
        "launches_train_tiny_step": tiny["k1_per_step"],
        "launches_memory_probe_step": {
            probe_label(r): r["k1_launches"] for r in probe},
        "train_1h22": demo,
        "train_tiny": tiny,
        "memory_probe": probe,
        **{f"runner_k1_{shape}_{key}": val
           for shape, times in runner_times.items()
           for key, val in times.items()},
        **menu_k1,
        **timing,
    }, {
        "name": "block_sparse_attention",
        "route": "cuda",
        "source": "alphafold2_tpu_torch/csrc/block_sparse.cu",
        "replaces": "alphafold2_tpu/ops/block_sparse.py:269",
        "launches": bs_launches,
        "launches_per_fold": bs_launches // len(SPARSE_LENGTHS),
        "live_fraction": spec.live_fraction,
        "fold_ab": fold_ab_k2,
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
        "launches_menu_fold_512": folds[512]["k2"],
        "launches_menu_fold_437": folds[437]["k2"],
        "launches_menu_fold_300": folds[MENU_UNPADDED_LENGTH]["k2"],
        "launches_menu_train_step": menu_train["distogram --data"][
            "k2_per_step"][-1],
        "menu_fold_k2_share_of_device_time": menu_fold["k2_share"],
        "launches_slice_fold_rank": sliced["one_card"]["k2_rank"],
        **({"launches_slice_512_per_rank": {
            f"{dtype}_{label}": row["k2_per_rank"]
            for dtype, rows in sliced["folds"].items()
            for label, row in rows.items() if label != "one_card"}}
           if "folds" in sliced else {}),
        **{f"menu_row_512_{key}": val for key, val in menu_k2.items()},
        **bs_timing,
    }]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
