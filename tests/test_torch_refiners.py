"""The PyTorch port's equivariant refiners held against the JAX package
on the CPU: `EGNNLayer`, `EnAttentionLayer` (kinds en and se3),
`Refiner`, `SparseEGNNLayer`, `AtomEGNNRefiner`, and `Alphafold2` with
each `structure_module_type` and each refinement mode (one model a
configuration: egnn as the structure module; se3 with the residue
refinement over the reversible trunk; en with the egnn-atom
refinement).

Inputs are drawn with numpy from a seed; JAX params come from
`jax.eval_shape` of the init plus numpy draws (every leaf nonzero, so
the zero-initialised coordinate projections move the coordinates) and
are bridged with `load_jax_params`; the JAX side runs jitted, once per
configuration. Both sides compute in fp32. Tolerances, absolute: node
features and logits 1e-4; coordinates 1e-3, because they are O(10) A
values built through several refinement iterations (and, for the atom
cloud, a chain of NeRF placements), where fp32 sums taken in another
order differ by ~1e-4 A; 2e-3 for the egnn-atom model's atom cloud and
CA, because the jitted JAX reference itself differs from the eager JAX
model there by 1.2e-3 A at 37 A (XLA:CPU fuses the NeRF chain), while
the port agrees with the eager one within 3e-5 A. Equivariance (port only): the output of
rotated and translated inputs equals the rotated and translated output
within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.model import alphafold2 as jaf2
from alphafold2_tpu.model import refiners as jref
from alphafold2_tpu_torch.core.nerf import sidechain_container
from alphafold2_tpu_torch.data import scn as pscn
from alphafold2_tpu_torch.model import alphafold2 as paf2
from alphafold2_tpu_torch.model import refiners as pref
from alphafold2_tpu_torch.weights import load_jax_params
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)
from test_torch_serve import random_params

ATOL = 1e-4
COORDS_ATOL = 1e-3
ATOM_MODEL_ATOL = 2e-3
B, N, D, E = 2, 10, 16, 8


def t(x):
    return torch.from_numpy(np.array(x))


def close(jax_out, port_out, atol=ATOL, where=None):
    a = np.asarray(jax_out, np.float64)
    b = port_out.detach().double().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    if where is not None:
        a, b = a[where], b[where]
    err = float(np.abs(a - b).max())
    assert err <= atol, f"max abs err {err} > {atol}"


def bridged(jax_module, port_module, *args, seed=0, **kwargs):
    """JAX params drawn on the init's shapes, loaded into the port."""
    shapes = jax.eval_shape(
        lambda key: jax_module.init(key, *args, **kwargs),
        jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.default_rng(seed))
    load_jax_params(port_module, params)
    return params


def rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


def node_inputs(seed, n=N):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, n, D)).astype(np.float32)
    x = (rng.normal(size=(B, n, 3)) * 3).astype(np.float32)
    edges = rng.normal(size=(B, n, n, E)).astype(np.float32)
    mask = np.ones((B, n), bool)
    mask[1, n - 3:] = False
    return h, x, edges, mask


def atom_inputs(seed, l=6):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(B, l, D)).astype(np.float32)
    ca = np.cumsum(rng.normal(size=(B, l, 3)) * 0.5 + [3.8, 0.0, 0.0],
                   axis=1).astype(np.float32)
    seq = rng.integers(0, 21, (B, l))
    mask = np.ones((B, l), bool)
    mask[1, l - 2:] = False
    return h, ca, seq, mask


@pytest.mark.parametrize("kind", ["egnn", "en", "se3"])
def test_refiner_matches_jax(kind):
    """Two weight-shared iterations with pair edges and a padded tail;
    outputs compared at valid nodes."""
    h, x, edges, mask = node_inputs(1)
    jm = jref.Refiner(dim=D, kind=kind, iters=2, edge_dim=E)
    pm = pref.Refiner(D, kind=kind, iters=2, edge_dim=E)
    params = bridged(jm, pm, h, x, edges=edges, mask=mask)
    ref = jax.jit(jm.apply)(params, h, x, edges=edges, mask=mask)
    out = pm(t(h), t(x), edges=t(edges), mask=t(mask))
    close(ref[0], out[0], where=mask)
    close(ref[1], out[1], atol=COORDS_ATOL, where=mask)
    assert float((out[1] - t(x)).detach().abs().max()) > 1e-2  # they move
    # without edges or a mask (the layer's own defaults)
    layer_cls = {"egnn": (jref.EGNNLayer, pref.EGNNLayer)}.get(
        kind, (jref.EnAttentionLayer, pref.EnAttentionLayer))
    jl, pl = layer_cls[0](dim=D), layer_cls[1](D)
    params = bridged(jl, pl, h, x, seed=2)
    ref = jl.apply(params, h, x)
    out = pl(t(h), t(x))
    close(ref[0], out[0])
    close(ref[1], out[1], atol=COORDS_ATOL)


def test_sparse_egnn_layer_matches_jax():
    rng = np.random.default_rng(3)
    h, x, _, mask = node_inputs(3, n=12)
    idx = rng.integers(0, 12, (B, 12, 4))
    live = (rng.random((B, 12, 4)) < 0.7).astype(np.float32)
    jm = jref.SparseEGNNLayer(dim=D)
    pm = pref.SparseEGNNLayer(D)
    params = bridged(jm, pm, h, x, idx, live, mask=mask.astype(np.float32))
    for m in (mask.astype(np.float32), None):
        ref = jm.apply(params, h, x, idx, live, mask=m)
        out = pm(t(h), t(x), t(idx), t(live),
                 mask=None if m is None else t(m))
        close(ref[0], out[0])
        close(ref[1], out[1], atol=COORDS_ATOL)


def test_atom_refiner_matches_jax():
    h, ca, seq, mask = atom_inputs(4)
    jm = jref.AtomEGNNRefiner(dim=D, iters=2)
    pm = pref.AtomEGNNRefiner(D, iters=2)
    params = bridged(jm, pm, h, ca, seq, mask=mask)
    ref = jax.jit(jm.apply)(params, h, ca, seq, mask=mask)
    out = pm(t(h), t(ca), t(seq), mask=t(mask))
    close(ref[0], out[0])
    close(ref[1], out[1], atol=COORDS_ATOL)
    # absent slots and masked residues are zero
    cloud = pscn.scn_cloud_mask(t(seq)) * t(mask)[..., None]
    assert float(out[1].detach()[cloud == 0].abs().max()) == 0.0


def port_layers(seed):
    """Port refiners with seeded weights, the zero-initialised coordinate
    projections moved off zero so the coordinate update is live."""
    gen = torch.Generator().manual_seed(seed)
    layers = {"egnn": pref.EGNNLayer(D, edge_dim=E),
              "en": pref.EnAttentionLayer(D, edge_dim=E),
              "atom": pref.AtomEGNNRefiner(D, iters=2)}
    with torch.no_grad():
        for layer in layers.values():
            for p in layer.parameters():
                p.add_(torch.randn(p.shape, generator=gen) * 0.1)
    return layers


@pytest.mark.parametrize("kind", ["egnn", "en", "atom"])
def test_equivariance(kind):
    """Rotate and translate the input coordinates: features stay, the
    coordinates rotate and translate with them."""
    rng = np.random.default_rng(5)
    rot, shift = t(rotation(rng)), torch.tensor([1.5, -2.0, 0.5])
    layer = port_layers(6)[kind]
    if kind == "atom":
        h, ca, seq, mask = (t(a) for a in atom_inputs(7))
        h1, x1 = layer(h, ca, seq, mask=mask)
        h2, x2 = layer(h, ca @ rot + shift, seq, mask=mask)
        cloud = pscn.scn_cloud_mask(seq) * mask[..., None]
        expect = (x1 @ rot + shift) * cloud[..., None]
        start = sidechain_container(ca[:, :, None], seq) * \
            cloud[..., None]
    else:
        h, x, edges, mask = (t(a) for a in node_inputs(8))
        h1, x1 = layer(h, x, edges=edges, mask=mask)
        h2, x2 = layer(h, x @ rot + shift, edges=edges, mask=mask)
        expect, start = x1 @ rot + shift, x
    with torch.no_grad():
        assert float((h1 - h2).abs().max()) <= 1e-4
        assert float((x2 - expect).abs().max()) <= 1e-4
        assert float((x1 - start).abs().max()) > 1e-3    # the update is live


def test_covalent_graph_is_the_message_path():
    """With every bond slot masked, coordinates stay where they are."""
    layer = port_layers(9)["atom"].layer
    h = torch.randn(1, 8, D, generator=torch.Generator().manual_seed(1))
    x = torch.randn(1, 8, 3, generator=torch.Generator().manual_seed(2))
    idx = torch.zeros(1, 8, 4, dtype=torch.long)
    _, x_out = layer(h, x, idx, torch.zeros(1, 8, 4))
    assert torch.allclose(x_out, x, atol=1e-6)


SEQ_N, ROWS, VALID = 12, 3, 9
MODEL_KW = dict(dim=D, depth=1, heads=2, dim_head=8, predict_coords=True,
                structure_module_depth=2, extra_msa_evoformer_layers=1)
CONFIGS = {
    "egnn": dict(structure_module_type="egnn"),
    "se3_residue_reversible": dict(structure_module_type="se3",
                                   structure_module_refinement_iters=2,
                                   reversible=True),
    "en_egnn_atom": dict(structure_module_type="en",
                         structure_module_refinement_iters=2,
                         structure_module_refinement="egnn-atom"),
}


def model_inputs():
    rng = np.random.default_rng(10)
    seq = rng.integers(0, 20, (1, SEQ_N))
    seq[0, 3] = 20                  # an unknown token: no atom cloud
    mask = (np.arange(SEQ_N) < VALID)[None]
    return dict(seq=seq, msa=rng.integers(0, 21, (1, ROWS, SEQ_N)),
                mask=mask, msa_mask=np.broadcast_to(
                    mask[:, None], (1, ROWS, SEQ_N)).copy())


@pytest.fixture(scope="module")
def model_refs():
    """Per configuration: the JAX outputs (coords, ReturnValues) and the
    bridged port model."""
    inputs = model_inputs()
    refs = {}
    for name, extra in CONFIGS.items():
        jm = jaf2.Alphafold2(**MODEL_KW, **extra)
        pm = paf2.Alphafold2(**MODEL_KW, **extra, device="cpu")
        args = {k: jnp.asarray(v) for k, v in inputs.items()}
        params = bridged(jm, pm, args.pop("seq"), **args, seed=11)
        ref = jax.jit(lambda p, jm=jm: jm.apply(
            p, inputs["seq"], msa=inputs["msa"], mask=inputs["mask"],
            msa_mask=inputs["msa_mask"], return_aux_logits=True))(params)
        refs[name] = (ref, pm)
    return inputs, refs


@pytest.mark.parametrize("name", list(CONFIGS))
def test_alphafold2_with_refiners_matches_jax(model_refs, name):
    inputs, refs = model_refs
    (coords, ret), pm = refs[name]
    pc, pret = pm(*(t(inputs[k]) for k in ("seq", "msa", "mask",
                                          "msa_mask")),
                  return_aux_logits=True)
    valid = inputs["mask"]
    close(ret.distance, pret.distance)
    close(ret.confidence, pret.confidence, where=valid)
    if name == "en_egnn_atom":
        close(coords, pc, atol=ATOM_MODEL_ATOL, where=valid)
        close(ret.atoms, pret.atoms, atol=ATOM_MODEL_ATOL)
        # the unknown token keeps the structure module's coordinates
        assert float(pc[0, 3].abs().max()) > 0.0
    else:
        close(coords, pc, atol=COORDS_ATOL, where=valid)
        assert ret.atoms is None and pret.atoms is None
    # the port trains through every branch
    pc.float().pow(2).sum().backward()
    grads = [p.grad for p in pm.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
    pm.zero_grad(set_to_none=True)


def test_has_ca_ignores_the_residue_mask_as_jax(model_refs):
    """A JAX fault kept for parity (ROADMAP queue 3): under egnn-atom the
    refined CA replaces the coordinates wherever the residue type has a
    CA, whatever the residue mask says, and the refiner zeroes masked
    residues' atoms, so a masked residue of a standard type sits at the
    origin in both packages."""
    inputs, refs = model_refs
    (coords, _), pm = refs["en_egnn_atom"]
    with torch.no_grad():
        pc = pm(*(t(inputs[k]) for k in ("seq", "msa", "mask",
                                         "msa_mask")))
    masked = ~inputs["mask"][0]
    assert masked.any()
    assert np.abs(np.asarray(coords)[0, masked]).max() == 0.0
    assert float(pc[0, t(masked)].abs().max()) == 0.0


def test_model_options_are_checked():
    with pytest.raises(ValueError, match="structure_module_refinement"):
        paf2.Alphafold2(**MODEL_KW, structure_module_refinement_iters=1,
                        structure_module_refinement="atoms", device="cpu")
    with pytest.raises(ValueError, match="unknown refiner kind"):
        paf2.Alphafold2(**MODEL_KW, structure_module_type="tfn",
                        device="cpu")
    # the JAX tree and the port's hold the same refiner modules
    names = {n.split(".")[0] for n, _ in paf2.Alphafold2(
        **MODEL_KW, **CONFIGS["en_egnn_atom"],
        device="cpu").named_parameters()}
    assert {"structure_module_refiner", "atom_refiner"} <= names
    assert not names & {"structure_module", "coords_refiner"}
