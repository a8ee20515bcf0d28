"""The PyTorch port's reversible Evoformer trunk: the inverse of a layer,
the gradients of the reversible stack against plain autograd through
the same layers (dropout on, replayed from the same seeds), and the
trunk (with its conv couplings) and its gradients against the JAX
package's `ReversibleEvoformer` at bridged weights, on the CPU.

Small size: dim 16, heads 2, dim_head 8, 8 residues (6 valid), 3 MSA
rows. Weights are the init's with every parameter moved by N(0, 0.05)
noise (so the zero-initialised output projections do not make each
coupling the identity). Tolerances: the inverse reconstructs the
streams within 1e-5 absolute (fp32, O(1) values); the reversible
gradients equal plain autograd's within 1e-5 of the largest gradient
(the same arithmetic replayed, only the inverse's rounding in between);
the trunk matches JAX within 1e-4 absolute and its gradients within
1e-4 of the largest JAX gradient (fp32 sums in another order).
"""

import jax
import numpy as np
import pytest
import torch

from alphafold2_tpu.model import reversible as jrev
from alphafold2_tpu_torch import ModelConfig
from alphafold2_tpu_torch.model import evoformer as pevo
from alphafold2_tpu_torch.model import reversible as prev
from alphafold2_tpu_torch.weights import load_jax_params
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)
from test_torch_serve import random_params

D, HEADS, DIM_HEAD, N, ROWS, VALID = 16, 2, 8, 8, 3, 6
# the conv couplings (use_conv), an even kernel among them
CONV = dict(use_conv=True, conv_seq_kernels=((2, 2),),
            conv_msa_kernels=((1, 3),))


def t(x):
    return torch.from_numpy(np.array(x))


def inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, N, N, D)).astype(np.float32)
    m = rng.normal(size=(1, ROWS, N, D)).astype(np.float32)
    valid = (np.arange(N) < VALID)[None]
    return (x, m, valid[:, :, None] & valid[:, None, :],
            np.broadcast_to(valid[:, None], (1, ROWS, N)).copy())


def port_trunk(depth, seed=0, **kw):
    trunk = prev.ReversibleEvoformer(D, depth, heads=HEADS,
                                     dim_head=DIM_HEAD, **kw)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in trunk.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
    return trunk


def relative_err(got, ref):
    scale = max(float(r.abs().max()) for r in ref)
    return max(float((a - b).abs().max()) for a, b in zip(got, ref)) / scale


def test_layer_inverse_roundtrip():
    x, m, pair_mask, msa_mask = (t(a) for a in inputs(1))
    layer = port_trunk(1, seed=2).rev_layers[0]
    streams = (x, x + 0.1, m, m - 0.1)
    with torch.no_grad():
        out = prev.layer_forward(layer, streams, pair_mask, msa_mask)
        back = prev.layer_inverse(layer, out, pair_mask, msa_mask)
    for a, b in zip(back, streams):
        assert float((a - b).abs().max()) <= 1e-5
    assert float((out[0] - streams[0]).abs().max()) > 1e-2


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["plain", "dropout"])
def test_gradients_match_plain_autograd(dropout):
    """The autograd function (store the outputs, invert, re-linearise)
    against autograd through `run_layers` with the same dropout seed:
    the same primal value and the same gradients for the inputs and
    every parameter."""
    x, m, pair_mask, msa_mask = (t(a) for a in inputs(3))
    trunk = port_trunk(3, seed=4, attn_dropout=dropout, ff_dropout=dropout)
    params = list(trunk.parameters())

    def loss_of(out):
        return sum((o ** 2).sum() for o in out)

    xl, ml = x.clone().requires_grad_(), m.clone().requires_grad_()
    rev = trunk(xl, ml, pair_mask, msa_mask, train=True,
                generator=torch.Generator().manual_seed(5))
    got = torch.autograd.grad(loss_of(rev), [xl, ml] + params)

    seed, device = trunk.dropout_seed(True,
                                      torch.Generator().manual_seed(5))
    assert (seed is None) == (dropout == 0.0)
    xp, mp = x.clone().requires_grad_(), m.clone().requires_grad_()
    s = prev.run_layers(trunk.rev_layers, (xp, xp, mp, mp), pair_mask,
                        msa_mask, True, seed, device)
    plain = ((s[0] + s[1]) * 0.5, (s[2] + s[3]) * 0.5)
    ref = torch.autograd.grad(loss_of(plain), [xp, mp] + params)
    assert torch.equal(rev[0], plain[0]) and torch.equal(rev[1], plain[1])
    assert relative_err(got, ref) <= 1e-5
    # dropout is live, and the reconstruction is of the dropped-out
    # forward: without the replay the inputs would not come back
    if dropout:
        with torch.no_grad():
            det = trunk(x, m, pair_mask, msa_mask)
            out = prev.run_layers(trunk.rev_layers, (x, x, m, m),
                                  pair_mask, msa_mask, True, seed, device)
            back = prev.run_layers(trunk.rev_layers, out, pair_mask,
                                   msa_mask, True, seed, device,
                                   inverse=True)
            wrong = prev.run_layers(trunk.rev_layers, out, pair_mask,
                                    msa_mask, True, seed + 1, device,
                                    inverse=True)
        assert float((det[0] - rev[0].detach()).abs().max()) > 1e-4
        assert float((back[0] - x).abs().max()) <= 1e-5
        assert float((wrong[0] - x).abs().max()) > 1e-3


def test_dropout_draws_from_the_generator():
    x, m, pair_mask, msa_mask = (t(a) for a in inputs(6))
    trunk = port_trunk(2, seed=7, attn_dropout=0.3, ff_dropout=0.3)
    with torch.no_grad():
        def run(seed):
            return trunk(x, m, pair_mask, msa_mask, train=True,
                         generator=torch.Generator().manual_seed(seed))[0]
        a, again, other = run(1), run(1), run(2)
    assert torch.equal(a, again)
    assert float((a - other).abs().max()) > 1e-4


@pytest.fixture(scope="module")
def jax_trunk():
    """JAX params drawn on the init's shapes (depth 2) and the JAX
    trunk's outputs and gradients at them."""
    x, m, pair_mask, msa_mask = inputs(8)
    jm = jrev.ReversibleEvoformer(dim=D, depth=2, heads=HEADS,
                                  dim_head=DIM_HEAD, **CONV)
    shapes = jax.eval_shape(lambda k: jm.init(
        k, x, m, mask=pair_mask, msa_mask=msa_mask), jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.default_rng(9))

    def loss(p, x, m):
        out = jm.apply(p, x, m, mask=pair_mask, msa_mask=msa_mask)
        return sum((o ** 2).sum() for o in out), out

    (_, out), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(params, x, m)
    return params, out, grads


def test_trunk_and_gradients_match_jax(jax_trunk):
    """The reversible backward against `jax.grad` through the JAX
    trunk's custom VJP, parameters bridged layer by layer from the
    depth-stacked flax tree; the conv blocks in both FF couplings."""
    params, ref_out, (g_params, g_x, g_m) = jax_trunk
    assert "pair_conv" in params["params"]["rev_layers"]
    x, m, pair_mask, msa_mask = (t(a) for a in inputs(8))
    trunk = prev.ReversibleEvoformer(D, 2, heads=HEADS, dim_head=DIM_HEAD,
                                     **CONV)
    load_jax_params(trunk, params)
    xl, ml = x.clone().requires_grad_(), m.clone().requires_grad_()
    out = trunk(xl, ml, pair_mask, msa_mask)
    for a, b in zip(ref_out, out):
        assert float(np.abs(np.asarray(a) - b.detach().numpy()).max()) \
            <= 1e-4
    got = torch.autograd.grad(sum((o ** 2).sum() for o in out),
                              [xl, ml] + list(trunk.parameters()))
    holder = prev.ReversibleEvoformer(D, 2, heads=HEADS, dim_head=DIM_HEAD,
                                      **CONV)
    load_jax_params(holder, jax.tree.map(np.asarray, g_params))
    ref = [t(np.asarray(g_x)), t(np.asarray(g_m))] + \
        [p.detach() for p in holder.parameters()]
    assert relative_err(got, ref) <= 1e-4


def test_the_trunk_options_reach_the_model_and_refusals_hold():
    cfg = ModelConfig(dim=D, depth=2, heads=HEADS, dim_head=DIM_HEAD,
                      predict_coords=True, structure_module_type="se3",
                      structure_module_refinement_iters=2,
                      structure_module_refinement="egnn-atom",
                      reversible=True, bfloat16=False)
    model = cfg.build(device="cpu")
    assert len(model.net.rev.rev_layers) == 2
    assert model.structure_module is None
    assert model.structure_module_refiner.iters == 4
    assert model.atom_refiner.iters == 2
    # the conv couplings are ported (tests/test_torch_menu.py): both
    # constructors build them
    trunk = pevo.Evoformer(D, 2, heads=HEADS, reversible=True,
                           use_conv=True)
    assert trunk.rev.rev_layers[1].msa_conv is not None
    assert prev.ReversibleEvoformer(D, 2, heads=HEADS, use_conv=True
                                    ).rev_layers[0].pair_conv is not None
    with pytest.raises(ValueError, match="pipeline_stages"):
        pevo.Evoformer(D, 2, heads=HEADS, reversible=True,
                       pipeline_stages=2)
    with pytest.raises(ValueError, match="outer_mean_reference_scale"):
        pevo.Evoformer(D, 2, heads=HEADS, reversible=True,
                       outer_mean_reference_scale=True)
    # ring_attention reaches the couplings' attentions (the ring itself
    # runs under a mesh: tests/test_torch_parallel.py)
    ringed = pevo.Evoformer(D, 2, heads=HEADS, reversible=True,
                            ring_attention=True).rev.rev_layers[1]
    assert ringed.pair_attn.triangle_attention_ingoing.ring_axes == \
        ("i", "j")
    assert ringed.msa_attn.row_attn.ring_axes == (None, "i")
