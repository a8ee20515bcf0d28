"""Parity of the PyTorch port's modules and fold path with the JAX package.

Inputs are drawn with numpy from a seed and cross as numpy arrays; the
JAX params are perturbed (so zero-initialised output projections do not
make every comparison 0 == 0) and bridged with `load_jax_params`. Both
sides compute in fp32: conftest pins JAX matmuls to float32 and TF32 is
off in torch. Module outputs agree within atol 1e-4 (fp32 sums taken in
another order); coordinates after the structure module and recycling
within atol 1e-3. Small size: dim 32, heads 2, dim_head 16, n 16, 3 MSA
rows, depth 2, and a mask with a padded tail.
"""

import ast
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from conftest import perturb_params

from alphafold2_tpu import constants as jax_constants
from alphafold2_tpu import predict as jax_predict
from alphafold2_tpu.model import alphafold2 as jax_af2
from alphafold2_tpu.model import evoformer as jax_evo
from alphafold2_tpu.model import primitives as jax_prim
from alphafold2_tpu.model import structure as jax_struct
from alphafold2_tpu_torch import constants as pt_constants
from alphafold2_tpu_torch import predict as pt_predict
from alphafold2_tpu_torch.model import alphafold2 as pt_af2
from alphafold2_tpu_torch.model import evoformer as pt_evo
from alphafold2_tpu_torch.model import primitives as pt_prim
from alphafold2_tpu_torch.model import structure as pt_struct
from alphafold2_tpu_torch.weights import load_jax_params
from test_torch_serve import random_params
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)


DIM, HEADS, DIM_HEAD, N, ROWS, DEPTH, VALID = 32, 2, 16, 16, 3, 2, 12
ATOL = 1e-4
COORDS_ATOL = 1e-3
REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _fp32_torch():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev


def bridged(jax_module, port_module, *args, seed=0, **kwargs):
    """Init the JAX module on `args`, perturb its params, and load them
    into the port module. Returns the perturbed JAX params."""
    params = jax_module.init(jax.random.PRNGKey(seed), *args, **kwargs)
    params = perturb_params(params, jax.random.PRNGKey(seed + 100))
    load_jax_params(port_module, jax.tree.map(np.asarray, params))
    return params


def t(x):
    return torch.from_numpy(np.array(x))


def close(jax_out, port_out, atol=ATOL):
    a = np.asarray(jax_out, np.float32)
    b = port_out.detach().float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max())
    assert err <= atol, f"max abs err {err} > {atol}"


def padded_mask(b, n, valid=VALID):
    return np.broadcast_to(np.arange(n) < valid, (b, n)).copy()


def test_constants_match():
    for name in ("MAX_NUM_MSA", "MAX_NUM_TEMPLATES", "NUM_AMINO_ACIDS",
                 "NUM_EMBEDDS_TR", "DISTOGRAM_BUCKETS", "THETA_BUCKETS",
                 "PHI_BUCKETS", "OMEGA_BUCKETS", "MSA_EMBED_DIM",
                 "PROTTRAN_EMBED_DIM", "ESM_EMBED_DIM",
                 "DISTOGRAM_MIN_DIST", "DISTOGRAM_MAX_DIST",
                 "IGNORE_INDEX"):
        assert getattr(pt_constants, name) == getattr(jax_constants, name)


def test_geglu_uses_tanh_gelu():
    x = np.random.default_rng(0).normal(size=(4, 8)).astype(np.float32)
    out = jax_prim.GEGLU().apply({}, jnp.asarray(x))
    close(out, pt_prim.GEGLU()(t(x)), atol=1e-6)


def test_attention_with_repeated_bias_and_mask():
    rng = np.random.default_rng(1)
    rep = 3
    x = rng.normal(size=(2 * rep, N, DIM)).astype(np.float32)
    bias = rng.normal(size=(2, HEADS, N, N)).astype(np.float32)
    mask = padded_mask(2 * rep, N)
    mask[1, :] = False                     # one fully masked fold row
    kw = dict(mask=mask, attn_bias=bias, attn_bias_repeat=rep)
    jm = jax_prim.Attention(dim=DIM, heads=HEADS, dim_head=DIM_HEAD)
    pm = pt_prim.Attention(DIM, HEADS, DIM_HEAD)
    params = bridged(jm, pm, x, **kw)
    ref = jm.apply(params, x, **kw)
    out = pm(t(x), mask=t(mask), attn_bias=t(bias), attn_bias_repeat=rep)
    close(ref, out)


@pytest.mark.parametrize("row,global_query", [
    (True, False), (False, False), (False, True)],
    ids=["row", "col", "col_global_query"])
def test_axial_attention_with_edges(row, global_query):
    """Row and column attention with the pair-edge bias; the global-query
    (tie_dim) column variant runs the plain branch in both packages."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, N, N, DIM)).astype(np.float32)
    mask = padded_mask(1, N)[:, :, None] & padded_mask(1, N)[:, None, :]
    jm = jax_prim.AxialAttention(dim=DIM, heads=HEADS, dim_head=DIM_HEAD,
                                 row_attn=row, col_attn=not row,
                                 accept_edges=True,
                                 global_query_attn=global_query)
    pm = pt_prim.AxialAttention(DIM, HEADS, DIM_HEAD, row_attn=row,
                                col_attn=not row, accept_edges=True,
                                global_query_attn=global_query)
    params = bridged(jm, pm, x, edges=x, mask=mask)
    ref = jm.apply(params, x, edges=x, mask=mask)
    close(ref, pm(t(x), edges=t(x), mask=t(mask)))


@pytest.mark.parametrize("mix", ["outgoing", "ingoing"])
def test_triangle_multiplicative(mix):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, N, N, DIM)).astype(np.float32)
    mask = padded_mask(1, N)[:, :, None] & padded_mask(1, N)[:, None, :]
    jm = jax_prim.TriangleMultiplicativeModule(dim=DIM, mix=mix)
    pm = pt_prim.TriangleMultiplicativeModule(DIM, mix=mix)
    params = bridged(jm, pm, x, mask=mask)
    close(jm.apply(params, x, mask=mask), pm(t(x), mask=t(mask)))


@pytest.mark.parametrize("reference_scale", [False, True])
def test_outer_mean(reference_scale):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, ROWS, N, DIM)).astype(np.float32)
    msa_mask = np.broadcast_to(padded_mask(1, N)[:, None],
                               (1, ROWS, N)).copy()
    msa_mask[:, -1, 4:] = False            # a ragged last alignment row
    jm = jax_prim.OuterMean(dim=DIM, reference_scale=reference_scale)
    pm = pt_prim.OuterMean(DIM, reference_scale=reference_scale)
    params = bridged(jm, pm, x, mask=msa_mask)
    close(jm.apply(params, x, mask=msa_mask), pm(t(x), mask=t(msa_mask)))


def test_evoformer_scanned_depth2():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1, N, N, DIM)).astype(np.float32)
    m = rng.normal(size=(1, ROWS, N, DIM)).astype(np.float32)
    mask1 = padded_mask(1, N)
    mask = mask1[:, :, None] & mask1[:, None, :]
    msa_mask = np.broadcast_to(mask1[:, None], (1, ROWS, N)).copy()
    jm = jax_evo.Evoformer(dim=DIM, depth=DEPTH, heads=HEADS,
                           dim_head=DIM_HEAD)
    pm = pt_evo.Evoformer(DIM, DEPTH, heads=HEADS, dim_head=DIM_HEAD)
    params = bridged(jm, pm, x, m, mask=mask, msa_mask=msa_mask)
    assert "block" in params["params"]["layers"]   # the scanned layout
    rx, rm = jm.apply(params, x, m, mask=mask, msa_mask=msa_mask)
    px, pm_out = pm(t(x), t(m), mask=t(mask), msa_mask=t(msa_mask))
    valid = mask[..., None]
    close(np.asarray(rx) * valid, px * t(valid))
    close(np.asarray(rm) * msa_mask[..., None], pm_out * t(msa_mask)[..., None])


def test_structure_module():
    rng = np.random.default_rng(6)
    single = rng.normal(size=(1, N, DIM)).astype(np.float32)
    pair = rng.normal(size=(1, N, N, DIM)).astype(np.float32)
    mask = padded_mask(1, N)
    jm = jax_struct.StructureModule(dim=DIM, depth=4, heads=1)
    pm = pt_struct.StructureModule(DIM, depth=4, heads=1)
    params = bridged(jm, pm, single, pair, mask=mask)
    rc, rs = jm.apply(params, single, pair, mask=mask)
    pc, ps = pm(t(single), t(pair), mask=t(mask))
    close(np.asarray(rc)[:, :VALID], pc[:, :VALID], atol=COORDS_ATOL)
    close(np.asarray(rs)[:, :VALID], ps[:, :VALID])


MODEL_KW = dict(dim=DIM, depth=DEPTH, heads=HEADS, dim_head=DIM_HEAD,
                predict_coords=True)


@pytest.fixture(scope="module")
def models():
    """The JAX model with perturbed params and the port's model bridged
    from them, plus one padded batch."""
    rng = np.random.default_rng(7)
    seq = rng.integers(0, 21, (1, N))
    msa = rng.integers(0, 21, (1, ROWS, N))
    mask = padded_mask(1, N)
    msa_mask = np.broadcast_to(mask[:, None], (1, ROWS, N)).copy()
    batch = dict(seq=seq, msa=msa, mask=mask, msa_mask=msa_mask)
    jm = jax_af2.Alphafold2(**MODEL_KW)
    params = jax.jit(jm.init)(jax.random.PRNGKey(8), seq, msa=msa,
                              mask=mask, msa_mask=msa_mask)
    params = perturb_params(params, jax.random.PRNGKey(9))
    pm = pt_af2.Alphafold2(**MODEL_KW, device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    return jm, params, pm, batch


def torch_batch(batch):
    return {k: t(v) for k, v in batch.items()}


@pytest.mark.parametrize("recycled", [False, True],
                         ids=["first_pass", "recyclables"])
def test_alphafold2_forward(models, recycled):
    jm, params, pm, batch = models
    rec_j = rec_p = None
    if recycled:
        rng = np.random.default_rng(10)
        coords = np.cumsum(rng.normal(size=(1, N, 3)) * 2.0,
                           axis=1).astype(np.float32)
        row = rng.normal(size=(1, N, DIM)).astype(np.float32)
        pair = rng.normal(size=(1, N, N, DIM)).astype(np.float32)
        rec_j = jax_af2.Recyclables(coords, row, pair)
        rec_p = pt_af2.Recyclables(t(coords), t(row), t(pair))
    rc, rret = jm.apply(params, **batch, recyclables=rec_j,
                        return_aux_logits=True, return_recyclables=True)
    with torch.inference_mode():
        pc, pret = pm(**torch_batch(batch), recyclables=rec_p,
                      return_aux_logits=True, return_recyclables=True)
    v = slice(0, VALID)
    close(np.asarray(rc)[:, v], pc[:, v], atol=COORDS_ATOL)
    close(np.asarray(rret.distance)[:, v, v], pret.distance[:, v, v])
    close(np.asarray(rret.confidence)[:, v], pret.confidence[:, v],
          atol=COORDS_ATOL)
    close(np.asarray(rret.recyclables.pairwise_repr)[:, v, v],
          pret.recyclables.pairwise_repr[:, v, v])


def bucket_margin(coords, mask):
    """Smallest distance between a valid pair's CA distance and a
    recycling bucket boundary."""
    c = coords.double()
    d = torch.sqrt(((c[:, :, None] - c[:, None]) ** 2).sum(-1)
                   .clamp(min=1e-12))
    pair = mask[:, :, None] & mask[:, None, :]
    edges = torch.linspace(2.0, 20.0, 32, dtype=torch.float64)[:-1]
    return float((d[pair][:, None] - edges).abs().min())


def test_fold_matches_jax(models):
    jm, params, pm, batch = models
    ref = jax_predict.fold(jm, params, **batch, num_recycles=2)
    out = pt_predict.fold(pm, **batch, num_recycles=2, device="cpu")
    # the seed is chosen so that no recycled CA distance lies within 1e-4
    # of a bucket boundary, where an fp32 rounding could flip the bucket
    state = pt_predict.fold_init(pm, **batch, device="cpu")
    for _ in range(2):
        assert bucket_margin(state.recyclables.coords,
                             t(batch["mask"])) > 1e-4
        state = pt_predict.fold_step(pm, batch["seq"], state.recyclables,
                                     msa=batch["msa"], mask=batch["mask"],
                                     msa_mask=batch["msa_mask"],
                                     device="cpu")
    v = slice(0, VALID)
    assert out.coords.shape == (1, N, 3)
    close(np.asarray(ref.coords)[:, v], out.coords[:, v], atol=COORDS_ATOL)
    close(np.asarray(ref.confidence)[:, v], out.confidence[:, v],
          atol=COORDS_ATOL)
    close(np.asarray(ref.distogram)[:, v, v], out.distogram[:, v, v],
          atol=COORDS_ATOL)


def test_fold_steps_equal_fold(models):
    _, _, pm, batch = models
    full = pt_predict.fold(pm, **batch, num_recycles=2, device="cpu")
    state = pt_predict.fold_init(pm, **batch, device="cpu")
    for _ in range(2):
        state = pt_predict.fold_step(
            pm, batch["seq"], state.recyclables, msa=batch["msa"],
            mask=batch["mask"], msa_mask=batch["msa_mask"], device="cpu")
    for a, b in ((full.coords, state.coords),
                 (full.confidence, state.confidence),
                 (full.distogram, state.distogram)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fold_init_rows_selects_rows(models):
    _, _, pm, batch = models
    two = {k: np.concatenate([v, v[:, ::-1] if k == "seq" else v])
           for k, v in batch.items()}
    state = pt_predict.fold_init(pm, **two, device="cpu")
    stepped = pt_predict.fold_step(pm, two["seq"], state.recyclables,
                                   msa=two["msa"], mask=two["mask"],
                                   msa_mask=two["msa_mask"], device="cpu")
    mixed = pt_predict.fold_init_rows(pm, two["seq"], [True, False],
                                      stepped, msa=two["msa"],
                                      mask=two["mask"],
                                      msa_mask=two["msa_mask"],
                                      device="cpu")
    torch.testing.assert_close(mixed.coords[0], state.coords[0],
                               rtol=0, atol=0)
    torch.testing.assert_close(mixed.coords[1], stepped.coords[1],
                               rtol=0, atol=0)
    torch.testing.assert_close(mixed.recyclables.pairwise_repr[1],
                               stepped.recyclables.pairwise_repr[1],
                               rtol=0, atol=0)


def test_forward_matches_jax_at_dim_head_160():
    """A head wider than 128 (the card launches it on the kernels' sliced
    path; here the plain version): a small model at dim_head 160 gives
    the JAX model's coords and distogram from the same perturbed
    weights."""
    rng = np.random.default_rng(14)
    n, valid = 12, 10
    kw = dict(MODEL_KW, depth=1, dim_head=160)
    mask = padded_mask(1, n, valid)
    batch = dict(seq=rng.integers(0, 21, (1, n)),
                 msa=rng.integers(0, 21, (1, ROWS, n)), mask=mask,
                 msa_mask=np.broadcast_to(mask[:, None], (1, ROWS, n)).copy())
    jm = jax_af2.Alphafold2(**kw)
    # numpy draws on the init's shapes: a real init costs ~30 s here
    shapes = jax.eval_shape(lambda key: jm.init(key, **batch),
                            jax.random.PRNGKey(15))
    params = random_params(shapes, np.random.default_rng(16))
    pm = pt_af2.Alphafold2(**kw, device="cpu")
    load_jax_params(pm, params)
    coords, ret = jax.jit(functools.partial(
        jm.apply, return_aux_logits=True))(params, **batch)
    with torch.inference_mode():
        pc, pret = pm(**torch_batch(batch), return_aux_logits=True)
    v = slice(0, valid)
    close(np.asarray(coords)[:, v], pc[:, v], atol=COORDS_ATOL)
    close(np.asarray(ret.distance)[:, v, v], pret.distance[:, v, v])


def test_unrolled_depth1_bridge():
    """An unrolled (depth 1) trunk's `net/layers_0` params bridge too."""
    rng = np.random.default_rng(11)
    seq = rng.integers(0, 21, (1, 8))
    kw = dict(MODEL_KW, depth=1)
    jm = jax_af2.Alphafold2(**kw)
    # the JAX side under jit: an eager init and forward of the whole
    # model compile every primitive on its own
    params = perturb_params(jax.jit(jm.init)(jax.random.PRNGKey(12), seq),
                            jax.random.PRNGKey(13))
    assert "layers_0" in params["params"]["net"]
    pm = pt_af2.Alphafold2(**kw, device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    with torch.inference_mode():
        out = pm(t(seq))
    close(jax.jit(jm.apply)(params, seq), out, atol=COORDS_ATOL)


def test_bridge_refuses_strays_and_gaps(models):
    jm, params, pm, _ = models
    tree = jax.tree.map(np.asarray, params)
    tree["params"]["unknown_head"] = {"kernel": np.zeros((DIM, 2))}
    with pytest.raises(ValueError, match="unknown_head"):
        load_jax_params(pm, tree)
    tree = jax.tree.map(np.asarray, params)
    del tree["params"]["lddt_linear"]
    with pytest.raises(ValueError, match="lddt_linear"):
        load_jax_params(pm, tree)
    load_jax_params(pm, jax.tree.map(np.asarray, params))  # restore


@pytest.mark.parametrize("case", [
    "reversible", "structure_module_type", "ring_attention", "kernel",
    "use_conv", "structure_module_refinement_iters"])
def test_unported_options_raise(case):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if case == "structure_module_type":
            pt_af2.Alphafold2(**dict(MODEL_KW, structure_module_type="egnn"),
                              device="cpu")
        elif case == "kernel":
            # fold(kernel=KernelSpec) is ported (tests/test_torch_serve.py);
            # the model-level block-sparse row attention is not
            pt_af2.Alphafold2(**dict(MODEL_KW, sparse_self_attn=True),
                              device="cpu")
        elif case == "structure_module_refinement_iters":
            pt_af2.Alphafold2(**dict(MODEL_KW, **{case: 2}), device="cpu")
        else:
            pt_af2.Alphafold2(**dict(MODEL_KW, **{case: True}),
                              device="cpu")


def test_structure_module_dim_head_is_accepted_and_unread():
    """The JAX model takes structure_module_dim_head and never reads it;
    the port builds the same modules whatever its value."""
    assert "structure_module_dim_head" in \
        jax_af2.Alphafold2.__dataclass_fields__
    ref = pt_af2.Alphafold2(**MODEL_KW, device="cpu")
    pm = pt_af2.Alphafold2(**dict(MODEL_KW, structure_module_dim_head=32),
                           device="cpu")
    assert {k: v.shape for k, v in pm.state_dict().items()} == \
        {k: v.shape for k, v in ref.state_dict().items()}


@pytest.mark.parametrize("field,value", [
    ("conv_seq_kernels", ((3, 3),)), ("conv_msa_kernels", ((1, 3),)),
    ("conv_dilations", (1, 2))])
def test_conv_fields_raise_naming_item_11(field, value):
    """The use_conv menu's fields raise NotImplementedError naming item
    11 unless they hold the JAX default."""
    with pytest.raises(NotImplementedError, match="item 11"):
        pt_af2.Alphafold2(**dict(MODEL_KW, **{field: value}), device="cpu")
    default = jax_af2.Alphafold2.__dataclass_fields__[field].default
    pt_af2.Alphafold2(**dict(MODEL_KW, **{field: default}), device="cpu")


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_af2.Alphafold2(dim=DIM, depth=1, heads=HEADS, dim_head=DIM_HEAD)


FORBIDDEN = ("jax", "flax", "alphafold2_tpu")


def _forbidden_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{path.name}: import {name}")
    return bad


def test_port_imports_no_jax():
    files = sorted((REPO / "alphafold2_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    names = {str(f.relative_to(REPO)) for f in files}
    for covered in ("alphafold2_tpu_torch/train/loop.py",
                    "alphafold2_tpu_torch/utils/flops.py",
                    "alphafold2_tpu_torch/scripts/train_distogram.py",
                    "alphafold2_tpu_torch/core/geometry.py",
                    "alphafold2_tpu_torch/train_wall.py",
                    "alphafold2_tpu_torch/utils/hashing.py",
                    "alphafold2_tpu_torch/data/featurize.py",
                    "alphafold2_tpu_torch/data/native.py",
                    "alphafold2_tpu_torch/data/pdb_io.py",
                    "alphafold2_tpu_torch/obs/export.py",
                    "alphafold2_tpu_torch/obs/trace.py",
                    "alphafold2_tpu_torch/utils/profiling.py",
                    "alphafold2_tpu_torch/cache/bytestore.py",
                    "alphafold2_tpu_torch/cache/keys.py",
                    "alphafold2_tpu_torch/cache/store.py",
                    "alphafold2_tpu_torch/cache/coalesce.py",
                    "alphafold2_tpu_torch/cache/features.py",
                    "alphafold2_tpu_torch/cache/checkpoints.py",
                    "alphafold2_tpu_torch/fleet/object_store.py",
                    "alphafold2_tpu_torch/scripts/fold_synthetic.py",
                    "alphafold2_tpu_torch/serve/scheduler.py",
                    "alphafold2_tpu_torch/serve/cuda_errors.py",
                    "alphafold2_tpu_torch/serve/features.py",
                    "alphafold2_tpu_torch/serve/meshpolicy.py",
                    "alphafold2_tpu_torch/obs/slo.py",
                    "alphafold2_tpu_torch/serve/bulk.py",
                    "alphafold2_tpu_torch/serve/cascade.py",
                    "alphafold2_tpu_torch/serve/preemption.py",
                    "alphafold2_tpu_torch/fleet/registry.py",
                    "alphafold2_tpu_torch/fleet/rpc.py",
                    "alphafold2_tpu_torch/fleet/router.py",
                    "alphafold2_tpu_torch/fleet/peer.py",
                    "alphafold2_tpu_torch/fleet/local.py",
                    "alphafold2_tpu_torch/fleet/frontdoor.py",
                    "alphafold2_tpu_torch/fleet/scaling.py",
                    "alphafold2_tpu_torch/fleet/controlplane.py",
                    "alphafold2_tpu_torch/fleet/procfleet.py",
                    "alphafold2_tpu_torch/data/threefry.py",
                    "alphafold2_tpu_torch/tools/obs_report.py",
                    "alphafold2_tpu_torch/tools/obs_fleet.py",
                    "alphafold2_tpu_torch/tools/serve_loadtest.py",
                    "alphafold2_tpu_torch/tools/cache_warm.py",
                    "alphafold2_tpu_torch/tools/bulk_submit.py"):
        assert covered in names, covered
    bad = [b for f in files for b in _forbidden_imports(f)]
    # the port's tools are its own copies: nothing loads a file of the
    # repo's tools/ by path
    bad += [f"{f.name}: loads a file by path" for f in files
            if "tools" in f.parts
            and re.search(r"spec_from_file_location|exec\(|runpy",
                          f.read_text())]
    assert not bad, bad


def _smoke_python(text):
    """(inline Python blocks, python command lines) of a shell script:
    each `python - <<'TAG'` heredoc's body, and every other line that
    runs python, with its continuation lines."""
    blocks, commands = [], []
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        heredoc = re.search(r"python - <<'(\w+)'", line)
        if heredoc:
            end = lines.index(heredoc.group(1), i + 1)
            blocks.append("\n".join(lines[i + 1:end]))
            i = end + 1
            continue
        if re.search(r"\bpython3?\b", line) and not line.lstrip(
                ).startswith("#"):
            command = [line]
            while command[-1].rstrip().endswith("\\"):
                i += 1
                command.append(lines[i])
            commands.append("\n".join(command))
        i += 1
    return blocks, commands


def test_serve_smoke_runs_only_the_port():
    """serve_smoke.sh's inline Python imports the port alone, and its
    python commands run the port's tools, never JAX, flax, the JAX
    package or a file of the repo's tools/."""
    text = (REPO / "alphafold2_tpu_torch/tools/serve_smoke.sh").read_text()
    blocks, commands = _smoke_python(text)
    assert len(blocks) >= 12 and len(commands) >= 30
    bad = []
    for block in blocks:
        tree = ast.parse(block)
        bad += [f"inline: {name}" for node in ast.walk(tree)
                for name in ([a.name for a in node.names]
                             if isinstance(node, ast.Import) else
                             [node.module] if isinstance(
                                 node, ast.ImportFrom) else [])
                if name.split(".")[0] in FORBIDDEN]
    pattern = re.compile(r"alphafold2_tpu(?!_torch)|\bjax\b|\bflax\b|"
                         r"(?<![\w/.])tools/")
    bad += [f"text: {m.group(0)!r} in {src[:80]!r}"
            for src in blocks + commands for m in pattern.finditer(src)]
    assert not bad, bad
    assert all("alphafold2_tpu_torch.tools." in c for c in commands
               if re.search(r"python3? -m", c))


def test_quaternion_and_rigid_match_jax():
    from alphafold2_tpu.core import quaternion as jq
    from alphafold2_tpu.core.rigid import Rigid as JaxRigid
    from alphafold2_tpu_torch.core import quaternion as pq
    from alphafold2_tpu_torch.core.rigid import Rigid as PortRigid

    rng = np.random.default_rng(20)
    qa = rng.normal(size=(3, 5, 4)).astype(np.float32)
    qb = rng.normal(size=(3, 5, 4)).astype(np.float32)
    tr = rng.normal(size=(3, 5, 3)).astype(np.float32)
    pts = rng.normal(size=(3, 5, 7, 3)).astype(np.float32)
    close(jq.quaternion_multiply(qa, qb), pq.quaternion_multiply(t(qa), t(qb)),
          atol=1e-6)
    # unit normalisation inside: a scaled quaternion gives the same matrix
    close(jq.quaternion_to_matrix(qa), pq.quaternion_to_matrix(t(3 * qa)),
          atol=1e-6)
    jr, pr = JaxRigid(qa, tr), PortRigid(t(qa), t(tr))
    close(jr.apply(pts), pr.apply(t(pts)), atol=1e-5)
    close(jr.invert_apply(pts), pr.invert_apply(t(pts)), atol=1e-5)
    close(jr.apply_single(pts[:, :, 0]), pr.apply_single(t(pts[:, :, 0])),
          atol=1e-5)
    ident = PortRigid.identity((2, 3))
    close(np.asarray(JaxRigid.identity((2, 3)).rotations), ident.rotations,
          atol=0)


def test_synthetic_batch_and_pad_to():
    from alphafold2_tpu.data.synthetic import pad_to as jax_pad_to
    from alphafold2_tpu_torch.data.synthetic import pad_to, synthetic_batch

    batch = synthetic_batch(np.random.default_rng(0), batch=2, seq_len=16,
                            msa_depth=3, pad_fraction=0.25)
    assert batch["seq"].shape == (2, 16) and batch["msa"].shape == (2, 3, 16)
    assert batch["mask"].dtype == torch.bool
    assert batch["mask"].sum(-1).tolist() == [12, 12]
    assert torch.equal(batch["msa_mask"][:, 0], batch["mask"])
    steps = (batch["coords"][:, 1:] - batch["coords"][:, :-1]).norm(dim=-1)
    torch.testing.assert_close(steps, torch.full_like(steps, 3.8))
    again = synthetic_batch(np.random.default_rng(0), batch=2, seq_len=16,
                            msa_depth=3, pad_fraction=0.25)
    assert torch.equal(again["msa"], batch["msa"])     # seeded
    for x, axis in ((batch["mask"], 1), (batch["msa"], 2),
                    (batch["coords"], 1)):
        want = np.asarray(jax_pad_to(jnp.asarray(x.numpy()), 20, axis=axis))
        got = pad_to(x, 20, axis=axis)
        assert got.dtype == x.dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_trunk_tracks_jax(models):
    """With dtype=bfloat16 both packages run the trunk in bf16 with fp32
    parameters cast down, and the heads and structure module in fp32. The
    two round at other places, so the port is held to bf16's own scale:
    its bf16 distogram lies within twice the JAX package's bf16-vs-fp32
    difference of both the JAX bf16 and the JAX fp32 result."""
    jm, params, _, batch = models
    jm16 = jax_af2.Alphafold2(**MODEL_KW, dtype=jnp.bfloat16)
    pm16 = pt_af2.Alphafold2(**MODEL_KW, dtype=torch.bfloat16,
                             device="cpu")
    load_jax_params(pm16, jax.tree.map(np.asarray, params))
    assert all(p.dtype == torch.float32 for p in pm16.parameters())
    v = slice(0, VALID)
    _, r32 = jm.apply(params, **batch, return_aux_logits=True)
    _, r16 = jm16.apply(params, **batch, return_aux_logits=True)
    with torch.inference_mode():
        coords, pret = pm16(**torch_batch(batch), return_aux_logits=True)
    assert coords.dtype == pret.distance.dtype == torch.float32
    j32 = np.asarray(r32.distance)[:, v, v]
    j16 = np.asarray(r16.distance, np.float32)[:, v, v]
    bf16_scale = float(np.abs(j16 - j32).max())
    assert 0 < bf16_scale < 0.5
    close(j16, pret.distance[:, v, v], atol=2 * bf16_scale)
    close(j32, pret.distance[:, v, v], atol=2 * bf16_scale)
