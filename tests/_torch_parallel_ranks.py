"""Rank side of tests/test_torch_parallel.py: one gloo group of 4 ranks
runs every case of the port's `parallel/` and its meshed model paths on
inputs the test made with numpy, and each rank writes its results
(numpy) for the test to hold against the JAX package. Imports torch and
the port only.
"""

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4


def _t(x, grad=False):
    return torch.from_numpy(np.array(x)).requires_grad_(grad)


def _np(x):
    from alphafold2_tpu_torch.parallel import unshard
    return unshard(x).detach().numpy()


def case_ring(inp, mesh_1d, mesh_2x2):
    from alphafold2_tpu_torch.parallel.ring import ring_attention_sharded
    q, k, v = (_t(a) for a in inp["ring_qkv"])
    out = {
        "plain": _np(ring_attention_sharded(q, k, v, mesh_1d, "ring")),
        "bias": _np(ring_attention_sharded(q, k, v, mesh_1d, "ring",
                                           bias=_t(inp["ring_bias"]))),
        "mask": _np(ring_attention_sharded(q, k, v, mesh_1d, "ring",
                                           mask=_t(inp["ring_mask"]))),
        "large": _np(ring_attention_sharded(q * 40.0, k, v, mesh_1d,
                                            "ring")),
    }
    q2, k2, v2 = (_t(a) for a in inp["ring_qkv16"])
    # a ring of 2 on each row of the 2 x 2 grid
    out["two"] = _np(ring_attention_sharded(q2, k2, v2, mesh_2x2, "ring"))
    qg, kg, vg = (_t(a, grad=True) for a in inp["ring_qkv16"])
    loss = (ring_attention_sharded(qg, kg, vg, mesh_1d, "ring")
            .full_tensor() ** 2).sum()
    loss.backward()
    out["grads"] = [g.grad.numpy() for g in (qg, kg, vg)]
    return out


def case_pair_row(inp, mesh_ij, mesh_1x4, mesh_dj):
    from alphafold2_tpu_torch.parallel.ring import (
        pair_row_attention_sharded)
    q, k, v = (_t(a) for a in inp["pr_qkv"])
    bias, mask = _t(inp["pr_bias"]), _t(inp["pr_mask"])
    out = {
        "bias": _np(pair_row_attention_sharded(q, k, v, bias, mesh_ij)),
        "mask": _np(pair_row_attention_sharded(q, k, v, None, mesh_ij,
                                               mask=mask)),
        "unsharded_rows": _np(pair_row_attention_sharded(
            q, k, v, None, mesh_1x4, i_axis=None, j_axis="j")),
    }
    qd, kd, vd = (_t(a) for a in inp["pr_qkv_b2"])
    out["data"] = _np(pair_row_attention_sharded(
        qd, kd, vd, _t(inp["pr_bias_b2"]), mesh_dj))
    q1, k1, v1 = (_t(a[:1]) for a in inp["pr_qkv_b2"])
    out["batch_one"] = _np(pair_row_attention_sharded(q1, k1, v1, None,
                                                      mesh_dj))
    grads = [_t(a, grad=True) for a in inp["pr_qkv"]] + \
        [_t(inp["pr_bias"], grad=True)]
    loss = (pair_row_attention_sharded(*grads[:3], grads[3], mesh_ij,
                                       mask=mask).full_tensor() ** 2).sum()
    loss.backward()
    out["grads"] = [g.grad.numpy() for g in grads]
    return out


def case_dropout(inp, mesh_ij):
    from alphafold2_tpu_torch.parallel.ring import (
        pair_row_attention_sharded, pair_row_dropout_mask)
    q, k, v = (_t(a) for a in inp["pr_qkv"])
    bias = _t(inp["pr_bias"])
    rate = 0.3

    def run(rate, key, vv=v):
        return _np(pair_row_attention_sharded(
            q, k, vv, bias, mesh_ij, dropout_rate=rate, dropout_key=key))

    b, h, n_i, n_j, _ = q.shape
    keep = pair_row_dropout_mask(7, rate, b=b, h=h, j_blocks=2,
                                 il=n_i // 2, jl=n_j // 2, i_blocks=2)
    return {"rate0": run(0.0, 7), "drop": run(rate, 7),
            "again": run(rate, 7), "other_key": run(rate, 8),
            "ones": run(rate, 7, torch.ones_like(v)),
            "keep": keep.numpy()}


def case_pipeline(inp, mesh_pd):
    from alphafold2_tpu_torch.parallel import (pipeline_apply,
                                               stack_stage_params)

    w = _t(inp["pp_w"], grad=True)
    bvec = _t(inp["pp_b"], grad=True)
    xs = _t(inp["pp_xs"], grad=True)

    def stage(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    stacked = stack_stage_params([{"w": w[s], "b": bvec[s]}
                                  for s in range(2)])
    out = pipeline_apply(stage, stacked, xs, mesh_pd, data_axis="data")
    full = out.full_tensor()
    (full ** 2).sum().backward()
    # a stage's parameter gradient lands in its slice on its ranks, and
    # each data rank holds its rows' share
    gw, gb = w.grad.clone(), bvec.grad.clone()
    for g in (gw, gb):
        dist.all_reduce(g)
    # the input gradient is whole on every rank (replicated convention)
    return {"out": full.detach().numpy(), "w": gw.numpy(),
            "b": gb.numpy(), "xs": xs.grad.numpy()}


def _load_trunk(params, **kw):
    from alphafold2_tpu_torch.model.evoformer import Evoformer
    from alphafold2_tpu_torch.weights import load_jax_params
    trunk = Evoformer(16, kw.pop("depth"), heads=4, dim_head=16, **kw)
    load_jax_params(trunk, params)
    return trunk


def _trunk_grads(trunk, inp, mesh):
    """d loss / d (x, m, parameters) under `mesh` through the train
    step's own gradient function (a pipelined trunk's stage gradients
    summed over ``pipe``); loss = sum(w * out) over the valid positions,
    with the test's fixed cotangents."""
    from alphafold2_tpu_torch.parallel import unshard, use_mesh
    from alphafold2_tpu_torch.train.loop import _gradients
    x, m = (_t(a, grad=True) for a in inp["evo_inputs"][:2])
    pm, mm = (_t(a) for a in inp["evo_inputs"][2:])
    wx, wm = (_t(a) for a in inp["evo_cotangents"])
    params = list(trunk.parameters())
    with use_mesh(mesh):
        ox, om = trunk(x, m, mask=pm, msa_mask=mm)
        loss = (unshard(ox) * wx).sum() + (unshard(om) * wm).sum()
        grads = _gradients(loss, [x, m] + params, trunk)
    return [np.zeros(tuple(p.shape), np.float32) if g is None
            else g.detach().numpy() for g, p in zip(grads, [x, m] + params)]


def case_evoformer(inp, mesh_ij, mesh_pipe):
    from alphafold2_tpu_torch.parallel import unshard, use_mesh
    x, m, pm, mm = (_t(a) for a in inp["evo_inputs"])
    out = {}
    ring = _load_trunk(inp["evo_ring_params"], depth=1, ring_attention=True)
    with torch.no_grad(), use_mesh(mesh_ij):
        rx, rm = ring(x, m, mask=pm, msa_mask=mm)
        out["ring"] = (unshard(rx).numpy(), unshard(rm).numpy())
    out["ring_grads"] = _trunk_grads(ring, inp, mesh_ij)
    pp = _load_trunk(inp["evo_pp_params"], depth=2, pipeline_stages=2)
    with torch.no_grad(), use_mesh(mesh_pipe):
        px, pmm = pp(x, m, mask=pm, msa_mask=mm)
        out["pipeline"] = (unshard(px).numpy(), unshard(pmm).numpy())
    out["pipeline_grads"] = _trunk_grads(pp, inp, mesh_pipe)
    return out


def case_specs(inp, mesh_dj):
    import warnings
    from alphafold2_tpu_torch.parallel import (pytree_bytes_per_device,
                                               shard_pytree_tp,
                                               shard_pytree_tp_zero,
                                               shard_pytree_zero,
                                               single_device_mesh,
                                               tp_param_specs,
                                               zero_param_specs)
    trunk = _load_trunk(inp["evo_ring_params"], depth=1)
    params = {n: p.detach() for n, p in trunk.named_parameters()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tp_param_specs({"head.weight": torch.zeros(4, 4)}, mesh_dj)
    return {"tp": {n: tuple(s) for n, s in
                   tp_param_specs(params, mesh_dj).items()},
            "zero": {n: tuple(s) for n, s in
                     zero_param_specs(params, mesh_dj).items()},
            "bytes": pytree_bytes_per_device(
                shard_pytree_tp_zero(params, mesh_dj)),
            "bytes_zero": pytree_bytes_per_device(
                shard_pytree_zero(params, mesh_dj)),
            "bytes_tp": pytree_bytes_per_device(
                shard_pytree_tp(params, mesh_dj)),
            "whole": sum(p.numel() * 4 for p in params.values()),
            "warned": [str(w.message) for w in caught],
            "single": dict(single_device_mesh().shape)}


def case_named_checkpoint(inp, mesh_dj):
    from alphafold2_tpu_torch.cache import checkpoints as ckpt
    from alphafold2_tpu_torch.parallel import NamedSharding, PartitionSpec
    spec = ckpt.sharding_spec(NamedSharding(mesh_dj, PartitionSpec(
        None, None, "j")))
    val = inp["ckpt_leaf"]
    row = ckpt.RowCheckpoint(fold_key="fk", model_tag="", age=0,
                             seq=np.arange(4, dtype=np.int32),
                             leaves=[("dev", val, spec)])
    key = ckpt.checkpoint_key("fk", "", 0)
    back = ckpt.decode_checkpoint(key, ckpt.encode_checkpoint(key, row))
    leaf = back.restore_leaves("cpu")[0]
    return {"spec": spec, "local": leaf.to_local().numpy(),
            "whole": leaf.full_tensor().numpy(),
            "placements": [(type(p).__name__, getattr(p, "dim", None))
                           for p in leaf.placements]}


def case_multihost(inp, mesh_dj):
    """global_mesh, host_local_batch_to_global (each rank passes its
    rows of `data`) and fold_input_shardings on (data 2, j 2)."""
    from alphafold2_tpu_torch.parallel import fold_input_shardings
    from alphafold2_tpu_torch.parallel.multihost import (
        global_mesh, host_local_batch_to_global)
    mesh = global_mesh(2, 1, 2)
    rows = inp["batch_rows"]
    mine = rows[mesh.coord("data")]
    whole = host_local_batch_to_global({"x": mine}, mesh)["x"]
    specs = fold_input_shardings(mesh_dj, {
        k: torch.zeros(shape) for k, shape in inp["fold_shapes"].items()})
    return {"shape": dict(mesh.shape), "whole": whole.numpy(),
            "specs": {k: None if v is None else tuple(v.spec)
                      for k, v in specs.items()}}


def case_multichip(inp):
    from alphafold2_tpu_torch.scripts import multichip
    return multichip.run(width=16)


def rank_main(rank, store_path, inputs_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD),
                            rank=rank, world_size=WORLD)
    from alphafold2_tpu_torch.parallel import make_mesh
    from alphafold2_tpu_torch.parallel.mesh import Mesh
    from alphafold2_tpu_torch.parallel.pipeline import make_pipeline_mesh

    with open(inputs_path, "rb") as f:
        inp = pickle.load(f)
    ranks = np.arange(WORLD)
    mesh_1d = Mesh(ranks, ("ring",))
    mesh_2x2 = Mesh(ranks.reshape(2, 2), ("other", "ring"))
    mesh_ij = Mesh(ranks.reshape(2, 2), ("i", "j"))
    mesh_1x4 = Mesh(ranks.reshape(1, 4), ("i", "j"))
    mesh_dj = make_mesh(2, 1, 2)
    cases = {
        "ring": lambda: case_ring(inp, mesh_1d, mesh_2x2),
        "pair_row": lambda: case_pair_row(inp, mesh_ij, mesh_1x4, mesh_dj),
        "dropout": lambda: case_dropout(inp, mesh_ij),
        "pipeline": lambda: case_pipeline(inp, make_pipeline_mesh(2, 2)),
        "evoformer": lambda: case_evoformer(inp, make_mesh(1, 2, 2),
                                            make_mesh(2, 1, 1, pipe=2)),
        "specs": lambda: case_specs(inp, mesh_dj),
        "named_checkpoint": lambda: case_named_checkpoint(inp, mesh_dj),
        "multihost": lambda: case_multihost(inp, mesh_dj),
        "multichip": lambda: case_multichip(inp),
    }
    out = {}
    try:
        for name, run in cases.items():
            out[name] = run()
    finally:
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
