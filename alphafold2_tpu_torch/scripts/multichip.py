"""Runnable multi-device demo (counterpart of `examples/multichip.py`):
every parallelism family on one model, one training step each.

On cards, one process per card (NCCL), under `torchrun` or spawned by
the script over the visible cards (2, 4 or 8):

    torchrun --nproc-per-node=8 -m alphafold2_tpu_torch.scripts.multichip
    python -m alphafold2_tpu_torch.scripts.multichip

On the CPU, gloo ranks (8 unless `--ranks` says), spawned or under
`torchrun`:

    python -m alphafold2_tpu_torch.scripts.multichip --device cpu [--ranks 4]

Shows, in one run:
  1. data parallelism x 2-D pair sharding + ring attention + TP/ZeRO
     placement of the train state, on (data 2, i 2, j 2) with 8 ranks
     ((i 2, j 2) with 4, (j 2) with 2): one training step;
  2. GPipe pipeline parallelism of the trunk on (pipe 2, data 2, i 2)
     with 8 ranks ((pipe 2, data 2) with 4, (pipe 2) with 2): one
     training step from THE SAME parameters, so checkpoints move freely
     between the plain and the pipelined trunks.
Each step's loss is taken before its update, so the two agree, and so
do the updated parameters and Adam moments.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from alphafold2_tpu_torch.data.synthetic import synthetic_batch
from alphafold2_tpu_torch.device import resolve_device
from alphafold2_tpu_torch.model.alphafold2 import Alphafold2
from alphafold2_tpu_torch.parallel import (make_mesh, pytree_bytes_per_device,
                                           shard_pytree_tp_zero, use_mesh)
from alphafold2_tpu_torch.parallel.multihost import initialize
from alphafold2_tpu_torch.train import TrainState, adam, make_train_step
from alphafold2_tpu_torch.train.loop import shard_batch

# (data, i, j) of the first demo and (pipe, data, i) of the second, by
# the number of ranks
MESHES = {8: ((2, 2, 2), (2, 2, 2)), 4: ((1, 2, 2), (2, 2, 1)),
          2: ((1, 1, 2), (2, 1, 1))}


def models(width: int, device: torch.device):
    """The demo's batch, its ring model and the pipelined model with the
    same parameters."""
    batch = synthetic_batch(np.random.default_rng(0), batch=4, seq_len=16,
                            msa_depth=3, with_coords=True)
    kw = dict(dim=width, depth=2, heads=4, dim_head=16, predict_coords=True,
              structure_module_depth=2, device=device,
              dtype=torch.bfloat16 if device.type == "cuda" else
              torch.float32)
    model = Alphafold2(**kw, ring_attention=True,
                       generator=torch.Generator().manual_seed(1))
    # ONE set of parameters serves both runs: the pipelined trunk regroups
    # the same layers (copied before the first step updates them)
    model_pp = Alphafold2(**kw, pipeline_stages=2,
                          generator=torch.Generator().manual_seed(1))
    model_pp.load_state_dict(model.state_dict())
    return batch, model, model_pp


def one_step(model, mesh, batch, tag: str) -> dict:
    """One train step of `model` on `mesh` (None: unmeshed); its loss
    (taken before the update), the updated parameters and the Adam
    moments, whole, as numpy."""
    from alphafold2_tpu_torch.ops import attention
    state = TrainState.create(model, adam(3e-4), seed=2)
    if mesh is not None:
        state = shard_pytree_tp_zero(state, mesh)
    launches = attention.launch_count.value
    with use_mesh(mesh):
        state, metrics = make_train_step(model)(state,
                                                shard_batch(batch, mesh))
    loss = float(metrics["loss"])
    launches = attention.launch_count.value - launches
    if mesh is not None and dist.get_rank() == 0:
        print(f"[{tag}] mesh={mesh.shape} loss={loss:.4f} state bytes per "
              f"rank={pytree_bytes_per_device(state)} K1 launches on rank "
              f"0={launches}", flush=True)
    whole = lambda xs: [x.detach().float().cpu().numpy()  # noqa: E731
                        for x in xs]
    moments = state.optimizer.state_dict()
    return {"loss": loss, "params": whole(state.params),
            "mu": whole(moments["mu"]), "nu": whole(moments["nu"])}


def run(width: int = 32) -> dict:
    """Both demos on the process group's ranks (cards under NCCL, the
    CPU under gloo); `one_step`'s results of each."""
    world = dist.get_world_size()
    if world not in MESHES:
        raise ValueError(f"the demo runs on 2, 4 or 8 ranks, not {world}")
    (data, i, j), (pipe, pp_data, pp_i) = MESHES[world]
    device = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    batch, model, model_pp = models(width, device)
    out = {"ring": one_step(model, make_mesh(data, i, j), batch,
                            "dp x sp(ring) x tp x zero"),
           "pipeline": one_step(model_pp, make_mesh(pp_data, pp_i, 1,
                                                    pipe=pipe),
                                batch, "pp(GPipe) x dp")}
    if dist.get_rank() == 0:
        # the same gradient either way: the first Adam moments agree
        mus = [out[k]["mu"] for k in ("ring", "pipeline")]
        gap = max(float(np.abs(a - b).max()) for a, b in zip(*mus))
        top = max(float(np.abs(a).max()) for a in mus[0])
        print(f"first moments, ring vs pipeline: max gap {gap:.3e} of "
              f"the largest {top:.3e}", flush=True)
    return out


def _spawned(rank, world, store_path, width, backend):
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend,
                            store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        run(width)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="cuda: NCCL, one rank per card (the default); "
                         "cpu: gloo ranks on the CPU")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to spawn without torchrun (default: every "
                         "visible card, or 8 on the CPU)")
    ap.add_argument("--width", type=int, default=32)
    args = ap.parse_args(argv)
    # the card unless asked for the CPU (raises without a card)
    backend = "nccl" if resolve_device(args.device).type == "cuda" \
        else "gloo"
    if initialize(backend=backend):
        return run(args.width)
    if backend == "nccl":
        cards = torch.cuda.device_count()
        ranks = cards if args.ranks is None else args.ranks
        if ranks not in MESHES or ranks > cards:
            raise SystemExit(
                f"the demo takes 2, 4 or 8 ranks, one per card, and "
                f"{cards} card(s) are visible: pass --ranks, launch under "
                f"torchrun --nproc-per-node=N, or run on the CPU with "
                f"--device cpu")
    else:
        ranks = 8 if args.ranks is None else args.ranks
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_spawned, args=(ranks, os.path.join(tmp, "store"),
                                 args.width, backend), nprocs=ranks)
    return None


if __name__ == "__main__":
    main()
