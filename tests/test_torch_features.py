"""Parity of the port's templates, template angles, extra-MSA stack,
pretrained-embedding projectors, angle heads and return options with the
JAX package.

Inputs are drawn with numpy from a seed and cross as numpy arrays; the
JAX params are perturbed (so zero-initialised output projections do not
make every comparison 0 == 0) and bridged with `load_jax_params`, every
leaf of the JAX tree used. Both sides compute in fp32 (conftest pins JAX
matmuls to float32; TF32 is off in torch). Module outputs agree within
atol 1e-4, coordinates and confidence within 1e-3, at valid positions
only. Small size: dim 32, heads 2, dim_head 16, n 16, b 2 with ragged
masks, 3 MSA rows, t 2 templates (one with a ragged tail, one fully
masked in the first batch row), e 4 extra rows, one extra-MSA layer, two
template-embed layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import predict as jax_predict
from alphafold2_tpu.model import alphafold2 as jax_af2
from alphafold2_tpu.model import evoformer as jax_evo
from alphafold2_tpu.model import primitives as jax_prim
from alphafold2_tpu.ops.block_sparse import KernelSpec as JaxKernelSpec
from alphafold2_tpu.train import loop as jax_loop
from alphafold2_tpu_torch import predict as pt_predict
from alphafold2_tpu_torch.model import alphafold2 as pt_af2
from alphafold2_tpu_torch.model import evoformer as pt_evo
from alphafold2_tpu_torch.model import primitives as pt_prim
from alphafold2_tpu_torch.ops.block_sparse import KernelSpec
from alphafold2_tpu_torch.train import loop as pt_loop
from alphafold2_tpu_torch.weights import load_jax_params
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)


DIM, HEADS, DIM_HEAD, N, B, ROWS, T, E = 32, 2, 16, 16, 2, 3, 2, 4
LENGTHS = (12, 10)          # valid residues of the two batch rows
ATOL = 1e-4
COORDS_ATOL = 1e-3
MODEL_KW = dict(dim=DIM, depth=1, heads=HEADS, dim_head=DIM_HEAD,
                predict_coords=True, structure_module_depth=2,
                extra_msa_evoformer_layers=1, templates_embed_layers=2)


@pytest.fixture(autouse=True, scope="module")
def _fp32_torch():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev


def t(x):
    return torch.from_numpy(np.array(x))


def close(jax_out, port_out, atol=ATOL, lengths=None, pair=False):
    """Max abs difference within `atol`, at each batch row's valid
    residues when `lengths` is given (both residue axes when `pair`)."""
    a = np.asarray(jax_out, np.float32)
    b = port_out.detach().float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    if lengths is None:
        err = float(np.abs(a - b).max())
    else:
        err = max(float(np.abs(a[i, :n, :n] - b[i, :n, :n]).max()) if pair
                  else float(np.abs(a[i, :n] - b[i, :n]).max())
                  for i, n in enumerate(lengths))
    assert err <= atol, f"max abs err {err} > {atol}"


def make_inputs(seed=0):
    """Every model input, numpy, seeded: the base batch (seq, msa and
    their ragged masks) and the features."""
    rng = np.random.default_rng(seed)
    mask = np.arange(N)[None] < np.array(LENGTHS)[:, None]
    msa_mask = np.repeat(mask[:, None], ROWS, axis=1)
    msa_mask[:, -1, 5:] = False                      # a ragged MSA row
    templates_mask = np.repeat(mask[:, None], T, axis=1)
    templates_mask[:, 0, 8:] = False                 # a ragged template
    templates_mask[0, 1] = False                     # a missing template
    extra_msa_mask = np.repeat(mask[:, None], E, axis=1)
    extra_msa_mask[:, 1, 6:] = False
    base = dict(seq=rng.integers(0, 21, (B, N)),
                msa=rng.integers(0, 21, (B, ROWS, N)), mask=mask,
                msa_mask=msa_mask)
    feats = dict(
        templates_feats=rng.normal(size=(B, T, N, N, 32)).astype(np.float32),
        templates_mask=templates_mask,
        templates_angles=rng.normal(size=(B, T, N, 55)).astype(np.float32),
        extra_msa=rng.integers(0, 21, (B, E, N)),
        extra_msa_mask=extra_msa_mask,
        # a chain break: residue indices jump by 30 after the eighth
        seq_index=np.concatenate([np.arange(8), np.arange(8) + 30]),
        seq_embed=rng.normal(size=(B, N, 768)).astype(np.float32),
        msa_embed=rng.normal(size=(B, ROWS, N, 1024)).astype(np.float32),
        embedds=rng.normal(size=(B, ROWS, N, 1280)).astype(np.float32),
        seq_embed_at_dim=rng.normal(size=(B, N, DIM)).astype(np.float32))
    return base, feats


def random_params(shapes, rng):
    """Parameters on the init's shapes, drawn with numpy: LayerNorm
    scales near 1, Dense kernels N(0, 1/fan_in), everything else small
    noise (so no output projection is zero)."""
    def fill(path, x):
        name = str(path[-1].key)
        if name == "scale":
            a = 1 + 0.05 * rng.standard_normal(x.shape)
        elif name == "kernel":
            a = rng.standard_normal(x.shape) / np.sqrt(x.shape[-2])
        else:
            a = 0.05 * rng.standard_normal(x.shape)
        return np.asarray(a, x.dtype)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def init_pair(seed=8, **kw):
    """The JAX model with random params on its init's shapes (traced
    abstractly: every branch's params exist, as `init` makes them) and
    the port's model bridged from them."""
    base, feats = make_inputs()
    jm = jax_af2.Alphafold2(**dict(MODEL_KW, **kw))
    shapes = jax.eval_shape(
        lambda key: jm.init(key, base["seq"], msa=base["msa"],
                            mask=base["mask"], msa_mask=base["msa_mask"],
                            seq_embed=feats["seq_embed"],
                            msa_embed=feats["msa_embed"]),
        jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.default_rng(seed))
    pm = pt_af2.Alphafold2(**dict(MODEL_KW, **kw), device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    return jm, params, pm


@pytest.fixture(scope="module")
def models():
    return init_pair()


def port_call(pm, inputs, **kw):
    with torch.inference_mode():
        return pm(**{k: None if v is None else t(v)
                     for k, v in inputs.items()}, **kw)


# each case: the features added to the base batch (msa None = dropped)
CASES = {
    "templates": ("templates_feats", "templates_mask"),
    "templates_angles": ("templates_angles", "templates_mask"),
    "extra_msa": ("extra_msa", "extra_msa_mask"),
    "extra_msa_default_mask": ("extra_msa",),
    "seq_index": ("seq_index",),
    "seq_embed": ("seq_embed",),
    "msa_embed": ("msa_embed",),
    "embedds": ("embedds",),
    "all": ("templates_feats", "templates_mask", "templates_angles",
            "extra_msa", "extra_msa_mask", "seq_index", "seq_embed",
            "msa_embed"),
}


def case_inputs(case):
    base, feats = make_inputs()
    inputs = dict(base, **{k: feats[k] for k in CASES[case]})
    if case == "embedds":
        # the embeddings replace the MSA (and its mask)
        inputs.update(msa=None, msa_mask=None)
    return inputs


def test_cross_attention_matches_jax():
    """The template pointwise attention's shape: one query per cell over t
    keys, a ragged and a fully masked context row; with `mask` the key
    mask is `context_mask`, without it the keys are not masked at all."""
    rng = np.random.default_rng(1)
    cells = 6
    x = rng.normal(size=(cells, 1, DIM)).astype(np.float32)
    ctx = rng.normal(size=(cells, 3, DIM)).astype(np.float32)
    mask = np.ones((cells, 1), bool)
    mask[2] = False                               # a masked query
    cmask = np.ones((cells, 3), bool)
    cmask[1, 2:] = False                          # ragged keys
    cmask[4] = False                              # no valid key
    jm = jax_prim.Attention(dim=DIM, heads=HEADS, dim_head=DIM_HEAD)
    pm = pt_prim.Attention(DIM, HEADS, DIM_HEAD)
    params = random_params(
        jax.eval_shape(lambda key: jm.init(key, x, mask=mask, context=ctx,
                                           context_mask=cmask),
                       jax.random.PRNGKey(2)),
        np.random.default_rng(3))
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    for kw in (dict(mask=mask, context_mask=cmask), dict(mask=mask),
               dict(context_mask=cmask), {}):
        ref = jm.apply(params, x, context=ctx, **kw)
        out = pm(t(x), context=t(ctx),
                 **{k: t(v) for k, v in kw.items()})
        close(ref, out)
    # without `mask` the context mask is ignored, as in the JAX module
    unmasked = pm(t(x), context=t(ctx))
    torch.testing.assert_close(pm(t(x), context=t(ctx),
                                  context_mask=t(cmask)), unmasked,
                               rtol=0, atol=0)


def test_template_stack_matches_jax():
    """The weight-shared template pair block (no outer mean), applied
    twice over (b*t, n, n, dim) under the crossed template mask."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B * T, N, N, DIM)).astype(np.float32)
    _, feats = make_inputs()
    tm = feats["templates_mask"].reshape(B * T, N)
    mask = tm[:, :, None] & tm[:, None, :]
    jm = jax_evo.PairwiseAttentionBlock(dim=DIM, heads=HEADS,
                                        dim_head=DIM_HEAD)
    pm = pt_evo.PairwiseAttentionBlock(DIM, HEADS, DIM_HEAD,
                                       with_outer_mean=False)
    assert pm.outer_mean is None
    params = random_params(
        jax.eval_shape(lambda key: jm.init(key, x, mask=mask),
                       jax.random.PRNGKey(5)),
        np.random.default_rng(6))
    assert "outer_mean" not in params["params"]
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    ref, out = x, t(x)
    for _ in range(2):
        ref = jm.apply(params, ref, mask=mask)
        out = pm(out, mask=t(mask))
    close(np.asarray(ref) * mask[..., None], out * t(mask)[..., None])
    with pytest.raises(ValueError, match="outer mean"):
        pm(t(x), mask=t(mask), msa_repr=t(x[:, :3]))


@pytest.mark.parametrize("case", list(CASES))
def test_forward_with_input_matches_jax(models, case):
    jm, params, pm = models
    inputs = case_inputs(case)
    rc, rret = jm.apply(params, **inputs, return_aux_logits=True)
    pc, pret = port_call(pm, inputs, return_aux_logits=True)
    close(rc, pc, atol=COORDS_ATOL, lengths=LENGTHS)
    close(rret.distance, pret.distance, lengths=LENGTHS, pair=True)
    close(rret.confidence, pret.confidence, atol=COORDS_ATOL,
          lengths=LENGTHS)
    if case != "all":
        return
    # the features really reach the result
    base, _ = make_inputs()
    _, plain = port_call(pm, base, return_aux_logits=True)
    assert float((plain.distance - pret.distance).abs().max()) > 1e-2


def test_embedding_at_the_model_width_is_not_projected(models):
    jm, params, pm = models
    base, feats = make_inputs()
    inputs = dict(base, seq_embed=feats["seq_embed_at_dim"])
    close(jm.apply(params, **inputs), port_call(pm, inputs),
          atol=COORDS_ATOL, lengths=LENGTHS)
    with pytest.raises(ValueError, match="width 100"):
        port_call(pm, dict(base, seq_embed=np.zeros((B, N, 100),
                                                     np.float32)))


@pytest.mark.parametrize("symmetrize_omega", [False, True],
                         ids=["omega", "omega_symmetrized"])
def test_angle_heads_match_jax(symmetrize_omega):
    jm, params, pm = init_pair(seed=20, predict_angles=True,
                               symmetrize_omega=symmetrize_omega)
    inputs = case_inputs("templates")
    _, rret = jm.apply(params, **inputs, return_aux_logits=True)
    _, pret = port_call(pm, inputs, return_aux_logits=True)
    for name in ("theta", "phi", "omega", "distance"):
        close(getattr(rret, name), getattr(pret, name), lengths=LENGTHS,
              pair=True)
    omega = pret.omega[0, :LENGTHS[0], :LENGTHS[0]]
    symmetric = torch.allclose(omega, omega.transpose(0, 1), atol=1e-5)
    assert symmetric == symmetrize_omega


def test_return_trunk_and_confidence_match_jax(models):
    jm, params, pm = models
    inputs = case_inputs("extra_msa")
    rtrunk = jm.apply(params, **inputs, return_trunk=True)
    ptrunk = port_call(pm, inputs, return_trunk=True)
    assert isinstance(ptrunk, pt_af2.ReturnValues)
    assert ptrunk.confidence is None and ptrunk.recyclables is None
    close(rtrunk.distance, ptrunk.distance, lengths=LENGTHS, pair=True)
    rc, rconf = jm.apply(params, **inputs, return_confidence=True)
    pc, pconf = port_call(pm, inputs, return_confidence=True)
    close(rc, pc, atol=COORDS_ATOL, lengths=LENGTHS)
    close(rconf, pconf, atol=COORDS_ATOL, lengths=LENGTHS)


def test_disable_token_embed_matches_jax():
    jm, params, pm = init_pair(seed=30, disable_token_embed=True)
    assert pm.token_emb is None
    assert "token_emb" not in params["params"]
    inputs = case_inputs("all")
    del inputs["extra_msa"], inputs["extra_msa_mask"]
    close(jm.apply(params, **inputs), port_call(pm, inputs),
          atol=COORDS_ATOL, lengths=LENGTHS)
    with pytest.raises(ValueError, match="sequence embedding"):
        port_call(pm, make_inputs()[0])


def fold_extras():
    inputs = case_inputs("all")
    base = {k: inputs.pop(k) for k in ("seq", "msa", "mask", "msa_mask")}
    return base, inputs


def test_fold_with_extras_matches_jax(models):
    jm, params, pm = models
    base, extra = fold_extras()
    ref = jax_predict.fold(jm, params, **base, num_recycles=2, **extra)
    out = pt_predict.fold(pm, **base, num_recycles=2, device="cpu", **extra)
    close(ref.coords, out.coords, atol=COORDS_ATOL, lengths=LENGTHS)
    close(ref.confidence, out.confidence, atol=COORDS_ATOL, lengths=LENGTHS)
    close(ref.distogram, out.distogram, atol=COORDS_ATOL, lengths=LENGTHS,
          pair=True)


def test_fold_steps_equal_fold_with_extras(models):
    """fold_init then R fold_steps is fold(num_recycles=R), exactly, with
    every feature passed to each entry point; fold_init_rows re-inits the
    chosen row from the same features."""
    _, _, pm = models
    base, extra = fold_extras()
    full = pt_predict.fold(pm, **base, num_recycles=2, device="cpu",
                           **extra)
    rest = {k: v for k, v in base.items() if k != "seq"}
    state = pt_predict.fold_init(pm, **base, device="cpu", **extra)
    first = state
    for _ in range(2):
        state = pt_predict.fold_step(pm, base["seq"], state.recyclables,
                                     device="cpu", **rest, **extra)
    for a, b in ((full.coords, state.coords),
                 (full.confidence, state.confidence),
                 (full.distogram, state.distogram)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    mixed = pt_predict.fold_init_rows(pm, base["seq"], [True, False], state,
                                      device="cpu", **rest, **extra)
    torch.testing.assert_close(mixed.coords[0], first.coords[0], rtol=0,
                               atol=0)
    torch.testing.assert_close(mixed.coords[1], state.coords[1], rtol=0,
                               atol=0)


def test_fold_moves_extras_and_refuses_unknown_inputs(models):
    _, _, pm = models
    base, extra = fold_extras()
    _, _, _, _, _, moved = pt_predict._prepare(
        pm, "cpu", *(base[k] for k in ("seq", "msa", "mask", "msa_mask")),
        None, None, dict(extra, embedds=None))
    assert "embedds" not in moved
    assert moved["templates_feats"].dtype == torch.float32
    assert moved["templates_mask"].dtype == torch.bool
    assert moved["extra_msa"].dtype == moved["seq_index"].dtype == \
        torch.long
    with pytest.raises(TypeError, match="templates_fetas"):
        pt_predict.fold(pm, **base, device="cpu", templates_fetas=1)


def test_fold_with_extras_under_spec_matches_jax(models):
    """Under a block-sparse spec the template triangle attentions and the
    extra stack's row attention (length n) take the pattern; the
    pointwise attention (a context) and the column attentions do not.
    The port's "auto" (K2's plain version) against JAX's "pallas"
    (interpret mode), at real residues; the pattern changes the result."""
    jm, params, pm = models
    base, extra = fold_extras()
    pattern = dict(window=0, num_global=0)
    jspec = JaxKernelSpec.banded(N, 4, backend="pallas", **pattern)
    spec = KernelSpec.banded(N, 4, backend="auto", **pattern)
    ref = jax_predict.fold(jm, params, **base, num_recycles=1,
                           kernel=jspec, **extra)
    out = pt_predict.fold(pm, **base, num_recycles=1, device="cpu",
                          kernel=spec, **extra)
    close(ref.coords, out.coords, atol=5e-4, lengths=LENGTHS)
    close(ref.confidence, out.confidence, atol=5e-4, lengths=LENGTHS)
    dense = pt_predict.fold(pm, **base, num_recycles=1, device="cpu",
                            **extra)
    assert float((dense.coords - out.coords).abs().max()) > 1e-3


def test_bridge_uses_every_leaf_and_refuses_strays_and_gaps(models):
    """A full JAX tree fills the port with no skip list: every port
    parameter is set, the scanned extra stack unstacks, and a stray leaf
    or a missing subtree raises."""
    _, params, pm = models
    tree = jax.tree.map(np.asarray, params)
    top = set(tree["params"])
    for name in ("to_template_embed", "template_pairwise_embedder",
                 "template_pointwise_attn", "template_angle_mlp_in",
                 "template_angle_mlp_out", "extra_msa_evoformer",
                 "embedd_project", "seq_embed_project_768",
                 "msa_embed_project_1280"):
        assert name in top, name
    leaves = len(jax.tree.leaves(tree))
    assert leaves == len(list(pm.parameters()))
    jm2, scanned, pm2 = init_pair(seed=9, extra_msa_evoformer_layers=2)
    assert "block" in scanned["params"]["extra_msa_evoformer"]["layers"]
    np.testing.assert_array_equal(
        pm2.extra_msa_evoformer.layers[1].ff.proj_in.bias.detach().numpy(),
        np.asarray(scanned["params"]["extra_msa_evoformer"]["layers"]
                   ["block"]["ff"]["Dense_0"]["bias"][1]))
    stray = jax.tree.map(np.asarray, params)
    stray["params"]["extra_msa_evoformer"]["stray"] = {
        "kernel": np.zeros((DIM, 2))}
    with pytest.raises(ValueError, match="stray"):
        load_jax_params(pm, stray)
    gap = jax.tree.map(np.asarray, params)
    del gap["params"]["template_pointwise_attn"]
    with pytest.raises(ValueError, match="template_pointwise_attn"):
        load_jax_params(pm, gap)
    load_jax_params(pm, tree)                           # restore


def test_compute_loss_angle_term_matches_jax():
    """compute_loss adds the trRosetta angle CEs when the model predicts
    angles and the batch carries their targets (ignore_index on padding)."""
    jm, params, pm = init_pair(seed=40, predict_angles=True,
                               predict_coords=False)
    base, _ = make_inputs()
    rng = np.random.default_rng(41)
    batch = dict(base)
    pair = base["mask"][:, :, None] & base["mask"][:, None, :]
    for name, buckets in (("theta", 25), ("phi", 13), ("omega", 25)):
        batch[name] = np.where(pair, rng.integers(0, buckets, (B, N, N)),
                               -100)
    ref_loss, ref_metrics = jax_loop.compute_loss(
        jm, params, batch, jax.random.PRNGKey(0), train=False)
    with torch.no_grad():
        loss, metrics = pt_loop.compute_loss(
            pm, {k: t(v) for k, v in batch.items()}, train=False)
    assert set(metrics) == set(ref_metrics) == {"angle_loss", "loss"}
    np.testing.assert_allclose(float(metrics["angle_loss"]),
                               float(ref_metrics["angle_loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
