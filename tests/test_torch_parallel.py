"""The PyTorch port's `parallel/` against the JAX package on the same mesh
shapes: ring attention (plain, bias, mask, large logits, a ring of two,
gradients), the pair-row ring (bias, a non-separable mask, an unsharded
row axis, the data axis, batch one on a data mesh, gradients), dropout
inside the ring, `pipeline_apply` (forward and gradients), the Evoformer
with `ring_attention=True` on (data 1, i 2, j 2) and with
`pipeline_stages=2` on (pipe 2, data 2) (outputs, and the input and
parameter gradients), the ZeRO and tensor-parallel specs leaf by leaf
with per-rank bytes, a "named" fold checkpoint leaf restored onto a
mesh, the multi-host helpers and the serving inputs' specs, and
`scripts/multichip.py` at a tiny width against its unmeshed step.

The port runs in one gloo group of 4 spawned ranks (file-store
rendezvous under the test's tmp dir, one intra-op thread each), started
once for the file: `_torch_parallel_ranks.py` runs every case and each
rank writes its results. The JAX references run here on conftest's 8
virtual CPU devices while the ranks work. Inputs are numpy draws from
fixed seeds.

Tolerances: JAX's own for the rings (1e-5 absolute forward, 1e-4 for
gradients and large logits, tests/test_ring.py) and for the pipeline
(1e-5 forward, 1e-4 gradients); the Evoformers within 1e-4 absolute at
every valid position (tests/test_torch_model.py's module tolerance),
their gradients within 1e-4 of the largest (as
tests/test_torch_reversible.py's);
dropout's dense replay within 1e-5, its mean over the rows of an
all-ones V within 0.15 of 1; the multichip losses within 1e-4
relative, its Adam first moments within 1e-4 of the largest.
"""

import os
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp
from jax.sharding import Mesh

from _torch_parallel_ranks import WORLD, rank_main
from alphafold2_tpu.model import evoformer as jax_evo
from alphafold2_tpu.parallel import (fold_input_shardings, make_mesh,
                                     pytree_bytes_per_device,
                                     shard_pytree_tp_zero, shard_pytree_zero,
                                     tp_param_specs, use_mesh,
                                     zero_param_specs)
from alphafold2_tpu.parallel.sharding import shard_pytree_tp
from alphafold2_tpu.parallel.pipeline import (make_pipeline_mesh,
                                              pipeline_apply)
from alphafold2_tpu.parallel.ring import (pair_row_attention_sharded,
                                          ring_attention_sharded)
from alphafold2_tpu_torch import weights
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)
from test_torch_serve import random_params

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

# the Evoformer cases at the shapes of scripts/multichip.py's trunk (batch
# 4, 16 residues, 3 MSA rows, heads 4 x 16): DTensor's sharding
# propagation, paid once per op and shape, then serves the demo too
DIM, N, ROWS, VALID, BATCH, RATE = 16, 16, 3, 12, 4, 0.3


def make_inputs():
    rng = np.random.default_rng(0)

    def normal(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    inp = {
        "ring_qkv": [normal(2, 2, 32, 8, scale=0.5) for _ in range(3)],
        "ring_bias": normal(2, 2, 32, 32),
        "ring_mask": np.arange(32)[None].repeat(2, 0) < 24,
        "ring_qkv16": [normal(2, 2, 16, 8, scale=0.5) for _ in range(3)],
        "pr_qkv": [normal(1, 2, 4, 8, 8, scale=0.5),
                   normal(1, 2, 4, 8, 8, scale=0.5), normal(1, 2, 4, 8, 8)],
        "pr_bias": normal(1, 2, 8, 8),
        "pr_qkv_b2": [normal(2, 2, 4, 8, 8, scale=0.5),
                      normal(2, 2, 4, 8, 8, scale=0.5),
                      normal(2, 2, 4, 8, 8)],
        "pr_bias_b2": normal(2, 2, 8, 8),
        "pp_w": normal(2, 8, 8, scale=8 ** -0.5),
        "pp_b": normal(2, 8, scale=0.1),
        "pp_xs": normal(4, 4, 8),
        "ckpt_leaf": normal(1, 4, 4),
        # the data axis's two ranks' rows, and one serving batch's shapes
        "batch_rows": normal(2, 3, 5),
        "fold_shapes": {"seq": (1, 16), "mask": (1, 16),
                        "msa": (1, 5, 16), "msa_mask": (1, 5, 16)},
    }
    mask = rng.random((1, 4, 8)) < 0.6
    mask[..., :2] = True
    inp["pr_mask"] = mask
    valid = np.arange(N) < VALID
    inp["evo_inputs"] = [
        normal(BATCH, N, N, DIM, scale=0.5),
        normal(BATCH, ROWS, N, DIM, scale=0.5),
        np.broadcast_to(valid[:, None] & valid[None], (BATCH, N, N)).copy(),
        np.broadcast_to(valid, (BATCH, ROWS, N)).copy()]
    # the gradient cases' cotangents, zero off the valid positions
    inp["evo_cotangents"] = [
        normal(BATCH, N, N, DIM) * inp["evo_inputs"][2][..., None],
        normal(BATCH, ROWS, N, DIM) * inp["evo_inputs"][3][..., None]]
    return inp


def jax_trunk(depth, **kw):
    return jax_evo.Evoformer(dim=DIM, depth=depth, heads=4, dim_head=16,
                            **kw)


def jax_references(inp):
    """Every JAX reference, each group under one jit (op-by-op dispatch
    of sharded arrays compiles each op alone, seconds per model)."""
    devices = jax.devices()[:WORLD]
    ring = Mesh(np.array(devices), ("ring",))
    ij = Mesh(np.array(devices).reshape(2, 2), ("i", "j"))
    rows = Mesh(np.array(devices).reshape(1, 4), ("i", "j"))
    dj = make_mesh(2, 1, 2, devices=devices)
    pp_mesh = make_pipeline_mesh(2, 2, devices=devices)

    @jax.jit
    def rings(q, k, v, bias, mask, qkv16):
        return {
            "plain": ring_attention_sharded(q, k, v, ring, "ring"),
            "bias": ring_attention_sharded(q, k, v, ring, "ring", bias=bias),
            "mask": ring_attention_sharded(q, k, v, ring, "ring", mask=mask),
            "large": ring_attention_sharded(q * 40.0, k, v, ring, "ring"),
            "grads": jax.grad(lambda a: (ring_attention_sharded(
                *a, ring, "ring") ** 2).sum())(qkv16),
        }

    @jax.jit
    def pair_rows(q, k, v, bias, mask, qkv_b2, bias_b2):
        return {
            "bias": pair_row_attention_sharded(q, k, v, bias, ij),
            "mask": pair_row_attention_sharded(q, k, v, None, ij, mask=mask),
            "unsharded_rows": pair_row_attention_sharded(
                q, k, v, None, rows, i_axis=None, j_axis="j"),
            "data": pair_row_attention_sharded(*qkv_b2, bias_b2, dj),
            "batch_one": pair_row_attention_sharded(
                *(a[:1] for a in qkv_b2), None, dj),
            "grads": jax.grad(lambda a: (pair_row_attention_sharded(
                a[0], a[1], a[2], a[3], ij, mask=mask) ** 2).sum())(
                    (q, k, v, bias)),
        }

    def stage(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    @jax.jit
    def pipeline(params, xs):
        out = pipeline_apply(stage, params, xs, pp_mesh, data_axis="data")
        g_params, g_xs = jax.grad(lambda p, x: (pipeline_apply(
            stage, p, x, pp_mesh, data_axis="data") ** 2).sum(),
            argnums=(0, 1))(params, xs)
        return {"out": out, "w": g_params["w"], "b": g_params["b"],
                "xs": g_xs}

    ref = {
        "ring": rings(*inp["ring_qkv"], inp["ring_bias"], inp["ring_mask"],
                      tuple(inp["ring_qkv16"])),
        # a ring of two devices: a device set of its own, its own jit
        "two": jax.jit(lambda qkv: ring_attention_sharded(
            *qkv, Mesh(np.array(devices[:2]), ("ring",)), "ring"))(
                tuple(inp["ring_qkv16"])),
        "pair_row": pair_rows(*inp["pr_qkv"], inp["pr_bias"], inp["pr_mask"],
                              tuple(inp["pr_qkv_b2"]), inp["pr_bias_b2"]),
        "pipeline": pipeline({"w": inp["pp_w"], "b": inp["pp_b"]},
                             inp["pp_xs"]),
    }
    x, m, pm, mm = inp["evo_inputs"]
    wx, wm = inp["evo_cotangents"]

    def trunk_grads(trunk, params):
        def loss(p, x, m):
            ox, om = trunk.apply(p, x, m, mask=pm, msa_mask=mm)
            return (ox * wx).sum() + (om * wm).sum()
        return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(params, x, m)

    evo = {}
    with use_mesh(make_mesh(1, 2, 2, devices=devices)):
        trunk = jax_trunk(1, ring_attention=True)
        evo["ring"] = jax.jit(trunk.apply)(
            inp["evo_ring_params"], x, m, mask=pm, msa_mask=mm)
        evo["ring_grads"] = trunk_grads(trunk, inp["evo_ring_params"])
    with use_mesh(make_mesh(2, 1, 1, pipe=2, devices=devices)):
        trunk = jax_trunk(2, pipeline_stages=2)
        evo["pipeline"] = jax.jit(trunk.apply)(
            inp["evo_pp_params"], x, m, mask=pm, msa_mask=mm)
        evo["pipeline_grads"] = trunk_grads(trunk, inp["evo_pp_params"])
    ref["evoformer"] = evo

    ref["fold_specs"] = {
        k: None if v is None else tuple(v.spec)
        for k, v in fold_input_shardings(dj, {
            k: np.zeros(shape) for k, shape in
            inp["fold_shapes"].items()}).items()}
    tree = inp["evo_ring_params"]
    ref["specs"] = {
        "tp": tp_param_specs(tree, dj),
        "zero": zero_param_specs(tree, dj),
        "bytes": pytree_bytes_per_device(shard_pytree_tp_zero(
            jax.tree.map(jnp.asarray, tree), dj)),
        "bytes_zero": pytree_bytes_per_device(shard_pytree_zero(
            jax.tree.map(jnp.asarray, tree), dj)),
        "bytes_tp": pytree_bytes_per_device(shard_pytree_tp(
            jax.tree.map(jnp.asarray, tree), dj))}
    ref["ring"]["two"] = ref.pop("two")
    return jax.tree.map(lambda a: np.asarray(a) if hasattr(a, "shape")
                        else a, ref)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    inp = make_inputs()
    x, m, pm, mm = inp["evo_inputs"]
    key = jax.random.PRNGKey(0)
    for name, depth, kw in (("evo_ring_params", 1, {}),
                            ("evo_pp_params", 2, {})):
        shapes = jax.eval_shape(lambda: jax_trunk(depth, **kw).init(
            key, x, m, mask=pm, msa_mask=mm))
        inp[name] = jax.tree.map(
            np.asarray, random_params(shapes, np.random.default_rng(depth)))
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    ctx = mp.start_processes(
        rank_main, args=(str(tmp / "store"), str(tmp / "inputs.pkl"),
                         str(tmp)),
        nprocs=WORLD, join=False, start_method="spawn")
    try:
        # the references run here while the ranks work
        ref = jax_references(inp)
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError("the gloo ranks did not finish")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    got = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            got.append(pickle.load(f))
    return inp, ref, got


def close(a, b, atol):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.max(np.abs(a - b)))
    assert err <= atol, f"max abs err {err} > {atol}"


@pytest.mark.parametrize("case", ["plain", "bias", "mask", "two"])
def test_ring_attention_matches_jax(runs, case):
    _, ref, got = runs
    for rank in got:
        close(rank["ring"][case], ref["ring"][case], 1e-5)


def test_ring_attention_large_logits_and_grads(runs):
    _, ref, got = runs
    for rank in got:
        assert np.isfinite(rank["ring"]["large"]).all()
        close(rank["ring"]["large"], ref["ring"]["large"], 1e-4)
        for a, b in zip(rank["ring"]["grads"], ref["ring"]["grads"]):
            close(a, b, 1e-4)


@pytest.mark.parametrize("case", ["bias", "mask", "unsharded_rows", "data",
                                  "batch_one"])
def test_pair_row_attention_matches_jax(runs, case):
    inp, ref, got = runs
    if case == "mask":   # actually non-separable
        mask = inp["pr_mask"]
        assert not np.array_equal(mask, mask.any(1, keepdims=True)
                                  & mask.any(2, keepdims=True))
    for rank in got:
        close(rank["pair_row"][case], ref["pair_row"][case], 1e-5)


def test_pair_row_gradients_match_jax(runs):
    _, ref, got = runs
    for rank in got:
        for a, b in zip(rank["pair_row"]["grads"], ref["pair_row"]["grads"]):
            close(a, b, 1e-4)


def test_ring_dropout_semantics(runs):
    """Rate 0 is the plain ring; a rate > 0 replays the same masks for
    the same key, other masks for another key, masks that differ across
    ranks and key shards, and equals the dense dropout(softmax) @ v of
    its own masks (row_sum undropped, 1 / (1 - rate) scaling)."""
    inp, ref, got = runs
    q, k, v = inp["pr_qkv"]
    bias = inp["pr_bias"]
    for rank in got:
        d = rank["dropout"]
        close(d["rate0"], ref["pair_row"]["bias"], 1e-5)
        np.testing.assert_array_equal(d["again"], d["drop"])
        assert np.abs(d["other_key"] - d["drop"]).max() > 1e-3
    d = got[0]["dropout"]
    for other in got[1:]:
        np.testing.assert_array_equal(other["dropout"]["keep"], d["keep"])
    keep = d["keep"]                                  # (b, h, I, Jq, Jk)
    blocks = [keep[:, :, i0:i0 + 2, q0:q0 + 4, k0:k0 + 4]
              for i0 in (0, 2) for q0 in (0, 4) for k0 in (0, 4)]
    assert len({b.tobytes() for b in blocks}) == len(blocks)
    assert 0.55 < keep.mean() < 0.85
    logits = np.einsum("bhiqd,bhikd->bhiqk", q, k) + bias[:, :, None]
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    dense = np.einsum("bhiqk,bhikd->bhiqd", p * keep / (1 - RATE), v)
    close(d["drop"], dense, 1e-5)
    ones = d["ones"]
    assert np.abs(ones - 1).max() > 0.05      # the numerators dropped
    assert abs(float(ones.mean()) - 1.0) < 0.15


@pytest.mark.parametrize("what", ["out", "w", "b", "xs"])
def test_pipeline_apply_matches_jax(runs, what):
    _, ref, got = runs
    atol = 1e-5 if what == "out" else 1e-4
    for rank in got:
        close(rank["pipeline"][what], ref["pipeline"][what], atol)


@pytest.mark.parametrize("case", ["ring", "pipeline"])
def test_meshed_evoformer_matches_jax(runs, case):
    inp, ref, got = runs
    (jx, jm) = ref["evoformer"][case]
    for rank in got:
        px, pm = rank["evoformer"][case]
        close(px[:, :VALID, :VALID], jx[:, :VALID, :VALID], 1e-4)
        close(pm[:, :, :VALID], jm[:, :, :VALID], 1e-4)


@pytest.mark.parametrize("case", ["ring", "pipeline"])
def test_meshed_evoformer_gradients_match_jax(runs, case):
    """d loss / d (x, m, every parameter) of the ring trunk on (i 2, j 2)
    and of the pipelined one on (pipe 2, data 2), each rank's through
    the train step's `_gradients` (stage gradients summed over pipe),
    against `jax.grad` of the JAX trunk under the same mesh; the JAX
    parameter gradients are bridged like parameters into a holder
    trunk. Relative to the largest gradient, as the port's other
    trunk-gradient tests (tests/test_torch_reversible.py)."""
    from alphafold2_tpu_torch.model.evoformer import Evoformer as PtEvo
    _, ref, got = runs
    g_params, g_x, g_m = ref["evoformer"][case + "_grads"]
    holder = PtEvo(DIM, 1 if case == "ring" else 2, heads=4, dim_head=16)
    weights.load_jax_params(holder, g_params)
    want = [g_x, g_m] + [p.detach().numpy() for p in holder.parameters()]
    scale = max(float(np.abs(w).max()) for w in want)
    for rank in got:
        have = rank["evoformer"][case + "_grads"]
        assert len(have) == len(want)
        for a, b in zip(have, want):
            assert a.shape == b.shape, (a.shape, b.shape)
        err = max(float(np.abs(a - b).max()) for a, b in zip(have, want))
        assert err <= 1e-4 * scale, f"relative err {err / scale}"


def _port_spec(jax_path, spec, kind):
    """A JAX leaf's spec in the port's layout (a Dense kernel is the
    transpose of the port's Linear weight)."""
    spec = tuple(spec) + (None,) * (2 - len(tuple(spec))) \
        if jax_path[-1] == "kernel" else tuple(spec)
    spec = spec[::-1] if jax_path[-1] == "kernel" else spec
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


def test_zero_and_tp_specs_match_jax_leaf_by_leaf(runs):
    inp, ref, got = runs
    for kind in ("tp", "zero"):
        jax_specs = dict(weights._flatten(jax.tree.map(
            lambda s: np.array(tuple(s), dtype=object), ref["specs"][kind],
            is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))))
        matched = 0
        for path, spec in jax_specs.items():
            path = path[1:]     # drop "params"
            names = [n for n, _ in weights._translate(path, np.zeros((1, 1)))]
            for name in names:
                port = got[0]["specs"][kind][name]
                while port and port[-1] is None:
                    port = port[:-1]
                assert port == _port_spec(path, list(spec), kind), \
                    (kind, path, name, port, spec)
                matched += 1
        assert matched == len(got[0]["specs"][kind])
    assert any(s != () for s in got[0]["specs"]["tp"].values())
    for rank in got:
        for key in ("bytes", "bytes_zero", "bytes_tp"):
            assert rank["specs"][key] == ref["specs"][key], key
            assert rank["specs"][key] < rank["specs"]["whole"], key
        # nothing matches the suffix table: JAX's warning
        assert any("matched no parameters" in w
                   for w in rank["specs"]["warned"])
        assert rank["specs"]["single"] == {"pipe": 1, "data": 1, "i": 1,
                                           "j": 1}


def test_named_checkpoint_restores_onto_the_mesh(runs):
    inp, _, got = runs
    for r, rank in enumerate(got):
        c = rank["named_checkpoint"]
        assert c["spec"] == {"kind": "named",
                             "axes": ["pipe", "data", "i", "j"],
                             "sizes": [1, 2, 1, 2],
                             "spec": [None, None, "j"]}
        np.testing.assert_array_equal(c["whole"], inp["ckpt_leaf"])
        j = r % 2        # the rank's j coordinate on (data 2, j 2)
        np.testing.assert_array_equal(
            c["local"], inp["ckpt_leaf"][:, :, 2 * j:2 * j + 2])
        assert ("Shard", 2) in c["placements"]


def test_multihost_placement_matches_jax(runs):
    """global_mesh's axes, host-local rows gathered into the global
    batch in data order, and the serving inputs' specs as JAX's."""
    inp, ref, got = runs
    for rank in got:
        m = rank["multihost"]
        assert m["shape"] == {"pipe": 1, "data": 2, "i": 1, "j": 2}
        np.testing.assert_array_equal(
            m["whole"], inp["batch_rows"].reshape(6, 5))
        assert m["specs"] == {k: tuple(v) for k, v in
                              ref["fold_specs"].items()}


def test_multichip_demo_on_four_ranks(runs):
    """scripts/multichip.py on 4 gloo ranks at width 16: one train step
    of the ring model on (i 2, j 2) with TP/ZeRO state, then one of the
    pipelined model on (pipe 2, data 2) from the same parameters. Each
    against the same step without a mesh, run here: the loss (taken
    before the update) within 1e-4 relative and the Adam first moments
    (0.1 x the gradient) within 1e-4 of the largest. The updated
    parameters are Adam's first update from the step's own moments,
    within 1e-6 (the update moves each by about the learning rate,
    3e-4; it is held to the rank's moments, not the unmeshed step's
    parameters, because where a gradient is as small as eps a first
    Adam step turns a 1e-9 difference of the gradient into 1e-5)."""
    import torch
    from alphafold2_tpu_torch.scripts import multichip
    _, _, got = runs
    batch, model, _ = multichip.models(16, torch.device("cpu"))
    before = [p.detach().clone().numpy() for p in model.parameters()]
    want = multichip.one_step(model, None, batch, "unmeshed")
    scale = max(float(np.abs(g).max()) for g in want["mu"])
    lr, b1, b2, eps = 3e-4, 0.9, 0.999, 1e-8
    for rank in got:
        for demo in ("ring", "pipeline"):
            have = rank["multichip"][demo]
            assert np.isfinite(have["loss"])
            assert abs(have["loss"] - want["loss"]) <= \
                1e-4 * abs(want["loss"]), demo
            for a, b in zip(have["mu"], want["mu"]):
                close(a, b, 1e-4 * scale)
            for p0, p1, mu, nu in zip(before, have["params"], have["mu"],
                                      have["nu"]):
                step = (mu / (1 - b1)) / (np.sqrt(nu / (1 - b2)) + eps)
                close(p1, p0 - lr * step, 1e-6)
    assert max(float(np.abs(a - b).max())
               for a, b in zip(want["params"], before)) > 1e-4
