"""The PyTorch port's training path held against the JAX package on the CPU.

Geometry, losses, MLM, the optimizer chain, the train steps (distogram,
coords, recycled), the guard, checkpoints, prefetch, the experiment
config and the FLOP count. Inputs are drawn with numpy from a seed; JAX
params are perturbed (so zero-initialised output projections do not make
gradients vanish) and bridged with `load_jax_params`, and a JAX gradient
tree is bridged the same way for comparison. Both sides compute in fp32
(conftest pins JAX matmuls to float32; TF32 is off in torch). Small size:
dim 32, depth 1, heads 2, dim_head 16, 16 residues (12 valid), 3 MSA
rows. Each JAX reference step is built once per module.

Tolerances: geometry and losses atol 1e-5; a train step's loss within
1e-5 relative, every bridged gradient within atol 1e-4 + rtol 1e-3, the
parameters after one Adam step within 1e-5; the bf16 distogram step's
loss within 2e-2 relative of the JAX package's bf16 loss.
"""

import functools
import json
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from conftest import perturb_params

from alphafold2_tpu import config as jax_config
from alphafold2_tpu.core import geometry as jgeo
from alphafold2_tpu.model import alphafold2 as jax_af2
from alphafold2_tpu.model import mlm as jax_mlm
from alphafold2_tpu.train import loop as jax_loop
from alphafold2_tpu.train import losses as jax_losses
from alphafold2_tpu.train import state as jax_state
from alphafold2_tpu.utils import flops as jax_flops
from alphafold2_tpu_torch import config as pt_config
from alphafold2_tpu_torch import constants
from alphafold2_tpu_torch.core import geometry as pgeo
from alphafold2_tpu_torch.model import alphafold2 as pt_af2
from alphafold2_tpu_torch.model import mlm as pt_mlm
from alphafold2_tpu_torch.model import primitives as pt_prim
from alphafold2_tpu_torch.train import checkpoint as pt_ckpt
from alphafold2_tpu_torch.train import guard as pt_guard
from alphafold2_tpu_torch.train import loop as pt_loop
from alphafold2_tpu_torch.train import losses as pt_losses
from alphafold2_tpu_torch.train import prefetch as pt_prefetch
from alphafold2_tpu_torch.train import state as pt_state
from alphafold2_tpu_torch.utils import flops as pt_flops
from alphafold2_tpu_torch.weights import load_jax_params
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)


DIM, HEADS, DIM_HEAD, N, ROWS, VALID = 32, 2, 16, 16, 3, 12
GEO_ATOL = 1e-5
# the port ignores extra_msa_evoformer_layers (the extra-MSA stack is not
# ported); one layer keeps the JAX init small
MODEL_KW = dict(dim=DIM, depth=1, heads=HEADS, dim_head=DIM_HEAD,
                extra_msa_evoformer_layers=1)
# the default `adam()` rate. Adam's first update is lr * g / (|g| + 1e-8)
# per entry, so two gradients that agree within the gradient tolerance
# but sit near 1e-7 (a few entries do) move a parameter by amounts up to
# lr * 0.02 apart; at 3e-4 that stays inside the 1e-5 parameter check
LR = 3e-4


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


def close(jax_out, port_out, atol=GEO_ATOL, rtol=0.0):
    a = np.asarray(jax_out, np.float64)
    b = port_out.detach().double().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b)
    assert (err <= atol + rtol * np.abs(a)).all(), \
        f"max abs err {float(err.max())} (atol {atol}, rtol {rtol})"


def chain(rng, b=2, n=N, step=3.8):
    steps = rng.normal(size=(b, n, 3))
    steps = steps / np.linalg.norm(steps, axis=-1, keepdims=True) * step
    return np.cumsum(steps, axis=1).astype(np.float32)


def padded_mask(b, n=N, valid=VALID):
    return np.broadcast_to(np.arange(n) < valid, (b, n)).copy()


def rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _geometry_case(name, rng):
    """(jax callable, port callable, numpy args) of one geometry function."""
    x, y = chain(rng), chain(rng)
    mask = padded_mask(2)
    probs = rng.dirichlet(np.ones(37), size=(2, N, N)).astype(np.float32)
    backbone = [chain(rng) for _ in range(3)]
    cases = {
        "cdist": ("cdist", (x, y)),
        "distogram_boundaries": ("distogram_boundaries", ()),
        "bucketed_distance_matrix": ("bucketed_distance_matrix",
                                     (x, mask)),
        "center_distogram_mean_std": ("center_distogram", (probs,)),
        "center_distogram_median_var": (
            "center_distogram", (probs,), dict(center="median",
                                               wide="var")),
        "center_distogram_mean_none": (
            "center_distogram", (probs,), dict(wide="none")),
        "dihedral": ("dihedral", tuple(c[:, :4] for c in backbone) + (
            x[:, :4],)),
        "backbone_phis": ("backbone_phis", tuple(backbone)),
        "fraction_negative_phis": ("fraction_negative_phis",
                                   tuple(backbone), dict(mask=mask)),
        "kabsch": ("kabsch", (x, y)),
        "kabsch_masked": ("kabsch", (x, y), dict(mask=mask)),
        "rmsd": ("rmsd", (x, y), dict(mask=mask)),
        "gdt_ts": ("gdt", (x, x + rng.normal(size=x.shape).astype(
            np.float32) * 2), dict(mask=mask)),
        "gdt_ha": ("gdt", (x, x + rng.normal(size=x.shape).astype(
            np.float32)), dict(mode="HA")),
        "tm_score": ("tm_score", (x, y), dict(mask=mask)),
        "tm_score_unmasked": ("tm_score", (x, y)),
        "lddt_ca": ("lddt_ca", (x, x + rng.normal(size=x.shape).astype(
            np.float32)), dict(mask=mask)),
        "distmat_loss": ("distmat_loss", (x, y), dict(mask=np.broadcast_to(
            mask[:, :, None] & mask[:, None], (2, N, N)))),
        "distmat_loss_p1_q1_clamp": ("distmat_loss", (x, y), dict(
            p=1.0, q=1.0, clamp=(-5.0, 5.0))),
        "kabsch_rmsd": ("kabsch_rmsd", (x, y), dict(mask=mask)),
        "kabsch_tm": ("kabsch_tm", (x, y), dict(mask=mask)),
        "kabsch_gdt": ("kabsch_gdt", (x, y), dict(mask=mask)),
    }
    fn, args, *kw = cases[name]
    return fn, args, (kw[0] if kw else {})


GEOMETRY_CASES = [
    "cdist", "distogram_boundaries", "bucketed_distance_matrix",
    "center_distogram_mean_std", "center_distogram_median_var",
    "center_distogram_mean_none", "dihedral", "backbone_phis",
    "fraction_negative_phis", "kabsch", "kabsch_masked", "rmsd", "gdt_ts",
    "gdt_ha", "tm_score", "tm_score_unmasked", "lddt_ca", "distmat_loss",
    "distmat_loss_p1_q1_clamp", "kabsch_rmsd", "kabsch_tm", "kabsch_gdt"]


@pytest.mark.parametrize("name", GEOMETRY_CASES)
def test_geometry_matches_jax(name):
    fn, args, kw = _geometry_case(name, np.random.default_rng(
        GEOMETRY_CASES.index(name)))
    ref = getattr(jgeo, fn)(*(jnp.asarray(a) for a in args), **{
        k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
        for k, v in kw.items()})
    out = getattr(pgeo, fn)(*(t(a) for a in args), **{
        k: t(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()})
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    for r, o in zip(refs, outs, strict=True):
        close(r, o)


def test_kabsch_and_rmsd_under_rigid_motion():
    rng = np.random.default_rng(30)
    x = chain(rng, b=1)[0]
    mask = padded_mask(1)[0]
    for _ in range(3):
        rot, shift = rotation(rng), rng.normal(size=3).astype(np.float32) * 7
        moved = x @ rot + shift
        assert float(pgeo.kabsch_rmsd(t(moved), t(x))) < 1e-4
        assert float(pgeo.kabsch_rmsd(t(moved), t(x), mask=t(mask))) < 1e-4
        aligned, target = pgeo.kabsch(t(moved), t(x))
        assert float((aligned - target).abs().max()) < 1e-4
        close(jgeo.kabsch_rmsd(moved, x), pgeo.kabsch_rmsd(t(moved), t(x)))
    # RMSD itself is invariant under one motion applied to both sets
    y = x + rng.normal(size=x.shape).astype(np.float32)
    rot, shift = rotation(rng), rng.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(
        float(pgeo.rmsd(t(x @ rot + shift), t(y @ rot + shift))),
        float(pgeo.rmsd(t(x), t(y))), rtol=1e-5)


def test_bucketed_distance_matrix_at_boundaries():
    """Distances within 1e-4 of a bucket boundary fall on the side JAX's
    searchsorted(side='left') puts them."""
    edges = np.linspace(2.0, 20.0, 37)[:-1]
    offsets = np.array([-1e-4, -5e-5, 5e-5, 1e-4])
    dists = (edges[:, None] + offsets[None]).reshape(-1)
    coords = np.zeros((1, 1 + dists.size, 3), np.float32)
    coords[0, 1:, 0] = dists
    mask = np.ones((1, 1 + dists.size), bool)
    ref = np.asarray(jgeo.bucketed_distance_matrix(coords, mask))
    out = pgeo.bucketed_distance_matrix(t(coords), t(mask)).numpy()
    # the distances from the first point are the ones placed near a
    # boundary (the others fall anywhere)
    np.testing.assert_array_equal(out[0, 0], ref[0, 0])
    np.testing.assert_array_equal(out[0, :, 0], ref[0, :, 0])
    expect = np.searchsorted(edges.astype(np.float32), dists.astype(
        np.float32), side="left")
    np.testing.assert_array_equal(out[0, 0, 1:], expect)
    masked = mask.copy()
    masked[0, 3] = False
    out = pgeo.bucketed_distance_matrix(t(coords), t(masked)).numpy()
    assert (out[0, 3] == constants.IGNORE_INDEX).all()
    assert (out[0, :, 3] == constants.IGNORE_INDEX).all()


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    rng = np.random.default_rng(31)
    logits = rng.normal(size=(2, N, N, 37)).astype(np.float32)
    labels = rng.integers(0, 37, (2, N, N))
    labels[0, :3] = constants.IGNORE_INDEX
    close(jax_losses.softmax_cross_entropy(logits, labels),
          pt_losses.softmax_cross_entropy(t(logits), t(labels)))
    everything = np.full_like(labels, constants.IGNORE_INDEX)
    close(jax_losses.softmax_cross_entropy(logits, everything),
          pt_losses.softmax_cross_entropy(t(logits), t(everything)))

    x, y, mask = chain(rng), chain(rng), padded_mask(2)
    close(jax_losses.distogram_loss(logits, x, mask),
          pt_losses.distogram_loss(t(logits), t(x), t(mask)))
    angles = [rng.normal(size=(2, N, N, c)).astype(np.float32)
              for c in (25, 13, 25)]
    targets = [rng.integers(0, c, (2, N, N)) for c in (25, 13, 25)]
    close(jax_losses.angle_loss(*angles, *targets),
          pt_losses.angle_loss(*map(t, angles), *map(t, targets)))
    for dl in (None, logits):
        close(jax_losses.coords_loss(x, y, mask, distogram_logits=dl),
              pt_losses.coords_loss(t(x), t(y), t(mask),
                                    distogram_logits=None if dl is None
                                    else t(dl)))
    conf = rng.normal(size=(2, N, 1)).astype(np.float32)
    close(jax_losses.lddt_confidence_loss(conf, x, y, mask),
          pt_losses.lddt_confidence_loss(t(conf), t(x), t(y), t(mask)))


def test_coords_loss_gradient_matches_jax():
    """The coordinate loss's gradient: the Kabsch rotation is a constant
    and lDDT's target is detached on both sides."""
    rng = np.random.default_rng(32)
    x, y, mask = chain(rng), chain(rng), padded_mask(2)
    logits = rng.normal(size=(2, N, N, 37)).astype(np.float32)
    conf = rng.normal(size=(2, N, 1)).astype(np.float32)

    def jloss(x, logits, conf):
        return jax_losses.coords_loss(x, y, mask, distogram_logits=logits) + \
            jax_losses.lddt_confidence_loss(conf, x, y, mask)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jgeo, "kabsch", kabsch_broadcast_flip)
        ref = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(x, logits, conf)
    leaves = [t(a).requires_grad_() for a in (x, logits, conf)]
    loss = pt_losses.coords_loss(leaves[0], t(y), t(mask),
                                 distogram_logits=leaves[1]) + \
        pt_losses.lddt_confidence_loss(leaves[2], leaves[0], t(y), t(mask))
    grads = torch.autograd.grad(loss, leaves)
    for r, g in zip(ref, grads):
        close(r, g, atol=1e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# MLM
# ---------------------------------------------------------------------------

def test_mlm_noise_properties():
    gen = torch.Generator().manual_seed(0)
    mlm = pt_mlm.MLM(DIM, constants.NUM_AMINO_ACIDS,
                     mask_id=constants.NUM_AMINO_ACIDS)
    rng = np.random.default_rng(33)
    b, m, n = 4, 8, 200
    seq = t(rng.integers(0, constants.NUM_AMINO_ACIDS, (b, m, n)))
    mask = t(np.arange(n)[None, None] < rng.integers(100, n + 1, (b, m, 1)))
    noised, replaced = mlm.noise(seq, mask, gen)
    eligible = mask & (seq != 0)
    # the replaced set lies inside the mask, never on an excluded token
    assert not (replaced & ~eligible).any()
    # ~15 % of each row's eligible tokens: at least ceil(prob * count),
    # at most ceil(prob * n) (the reference trims the top-k draws by the
    # running count of eligible positions, so excluded tokens early in a
    # row let a few more through)
    per_row = replaced.reshape(b * m, n).sum(-1).float()
    budget = torch.ceil(eligible.reshape(b * m, n).sum(-1) * 0.15)
    assert (per_row >= budget).all() and (per_row <= 30).all()
    frac = float(replaced.sum() / eligible.sum())
    assert 0.14 <= frac <= 0.18, frac
    # outside the replaced set a token changes only by random
    # replacement (the reference's trim lets ranks past a row's replaced
    # count through, onto its lowest-index positions outside the set;
    # the JAX package does the same, see the test below)
    outside = noised[~replaced] != seq[~replaced]
    assert (noised[~replaced][outside] < constants.NUM_AMINO_ACIDS).all()
    assert (noised[~replaced][outside] >= 1).all()
    inside = noised[replaced]
    random = inside != constants.NUM_AMINO_ACIDS
    # the replaced positions become the mask token or a random amino acid
    # in [1, NUM_AMINO_ACIDS). The random share is not the nominal
    # 0.9 * 0.1: the same trim keeps most of the second draw's ranks (the
    # JAX package's rule too; ROADMAP.md, queue 3)
    assert 0 < int(random.sum()) < int(random.numel())
    assert ((inside[random] >= 1) &
            (inside[random] < constants.NUM_AMINO_ACIDS)).all()
    # the same generator seed gives the same noise
    again = mlm.noise(seq, mask, torch.Generator().manual_seed(0))
    assert torch.equal(again[0], noised) and torch.equal(again[1], replaced)


def test_mask_subset_matches_jax_given_the_same_draws(monkeypatch):
    """get_mask_subset_with_prob is the JAX algorithm: fed the same
    uniform draws, both pick the same positions."""
    rng = np.random.default_rng(35)
    mask = np.arange(40)[None] < rng.integers(3, 41, (6, 1))
    mask &= rng.random((6, 40)) > 0.2
    draws = rng.random((6, 40)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(draws))
    monkeypatch.setattr(pt_mlm, "random_uniform",
                        lambda shape, generator, like: t(draws))
    for prob in (0.15, 0.09, 0.5):
        ref = jax_mlm.get_mask_subset_with_prob(jax.random.PRNGKey(0),
                                                jnp.asarray(mask), prob)
        out = pt_mlm.get_mask_subset_with_prob(t(mask), prob)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_mlm_options_reach_the_model_and_noise_as_jax(monkeypatch):
    """Alphafold2's four mlm_* options reach its MLM (JAX defaults when
    absent), and a non-default set noises as the JAX MLM does, given the
    same uniform and token draws."""
    defaults = pt_af2.Alphafold2(**MODEL_KW, device="cpu").mlm
    jax_fields = jax_af2.Alphafold2.__dataclass_fields__
    assert (defaults.mask_prob, defaults.random_replace_token_prob,
            defaults.keep_token_same_prob, defaults.exclude_token_ids) == \
        tuple(jax_fields[f"mlm_{name}"].default for name in (
            "mask_prob", "random_replace_token_prob",
            "keep_token_same_prob", "exclude_token_ids"))
    opts = dict(mlm_mask_prob=0.3, mlm_random_replace_token_prob=0.5,
                mlm_keep_token_same_prob=0.2, mlm_exclude_token_ids=(0, 20))
    pm = pt_af2.Alphafold2(**MODEL_KW, **opts, device="cpu")
    jm = jax_af2.Alphafold2(**MODEL_KW, **opts)
    jax_noise_mlm = jax_mlm.MLM(
        dim=DIM, num_tokens=constants.NUM_AMINO_ACIDS,
        mask_id=constants.NUM_AMINO_ACIDS, mask_prob=jm.mlm_mask_prob,
        random_replace_token_prob=jm.mlm_random_replace_token_prob,
        keep_token_same_prob=jm.mlm_keep_token_same_prob,
        exclude_token_ids=jm.mlm_exclude_token_ids)
    rng = np.random.default_rng(36)
    b, m, n = 2, 3, 40
    seq = rng.integers(0, constants.NUM_AMINO_ACIDS, (b, m, n))
    mask = np.arange(n)[None, None] < rng.integers(20, n + 1, (b, m, 1))
    draws = [rng.random((b * m, n)).astype(np.float32) for _ in range(2)]
    tokens = rng.integers(1, constants.NUM_AMINO_ACIDS, (b * m, n))
    jax_draws, port_draws = iter(draws), iter(draws)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape: jnp.asarray(next(jax_draws)))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(tokens))
    monkeypatch.setattr(pt_mlm, "random_uniform",
                        lambda shape, generator, like: t(next(port_draws)))
    monkeypatch.setattr(pt_mlm.torch, "randint",
                        lambda *a, **kw: t(tokens))
    ref = jax_noise_mlm.apply({}, jax.random.PRNGKey(0), jnp.asarray(seq),
                              jnp.asarray(mask), method=jax_mlm.MLM.noise)
    out = pm.mlm.noise(t(seq), t(mask))
    for got, want in zip(out, ref):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert out[1].any() and not out[1][t(seq) == 20].any()


def test_mlm_loss_head_matches_jax():
    rng = np.random.default_rng(34)
    embed = rng.normal(size=(1, ROWS, N, DIM)).astype(np.float32)
    seq = rng.integers(0, constants.NUM_AMINO_ACIDS, (1, ROWS, N))
    replaced = rng.random((1, ROWS, N)) < 0.3
    jm = jax_mlm.MLM(dim=DIM, num_tokens=constants.NUM_AMINO_ACIDS,
                     mask_id=constants.NUM_AMINO_ACIDS)
    params = perturb_params(jm.init(jax.random.PRNGKey(0), embed, seq,
                                    replaced), jax.random.PRNGKey(1))
    pm = pt_mlm.MLM(DIM, constants.NUM_AMINO_ACIDS,
                    mask_id=constants.NUM_AMINO_ACIDS)
    load_jax_params(pm, jax.tree.map(np.asarray, params))
    close(jm.apply(params, embed, seq, replaced),
          pm(t(embed), t(seq), t(replaced)))


# ---------------------------------------------------------------------------
# train steps against the JAX package
# ---------------------------------------------------------------------------

def make_batch(seed, with_coords=True):
    rng = np.random.default_rng(seed)
    mask = padded_mask(1)
    batch = dict(seq=rng.integers(0, constants.NUM_AMINO_ACIDS, (1, N)),
                 msa=rng.integers(0, constants.NUM_AMINO_ACIDS,
                                  (1, ROWS, N)),
                 mask=mask,
                 msa_mask=np.broadcast_to(mask[:, None], (1, ROWS, N)).copy())
    if with_coords:
        batch["coords"] = chain(rng, b=1)
    return batch


def jax_noise(batch, seed):
    """MLM noise drawn by the JAX package's MLM.noise from a JAX key."""
    jm = jax_mlm.MLM(dim=DIM, num_tokens=constants.NUM_AMINO_ACIDS,
                     mask_id=constants.NUM_AMINO_ACIDS)
    noised, replaced = jm.apply({}, jax.random.PRNGKey(seed), batch["msa"],
                                batch["msa_mask"], method=jax_mlm.MLM.noise)
    return np.asarray(noised), np.asarray(replaced)


def kabsch_broadcast_flip(x, y, mask=None):
    """The JAX package's `geometry.kabsch`, with the reflection fix written
    as a broadcast product instead of `u.at[..., :, -1].multiply(flip)`.
    Under `jax.jit` on XLA:CPU (jax 0.9.0) the scatter form is lost when
    the product feeds the matmuls after it, so a jitted step whose
    prediction needs a reflection aligns with the wrong rotation; eagerly
    both forms agree (`test_reference_kabsch_is_the_jax_kabsch`). The
    reference steps run jitted with this form."""
    w = jnp.ones(x.shape[:-1], x.dtype) if mask is None else \
        mask.astype(x.dtype)
    wsum = jnp.maximum(w.sum(-1, keepdims=True), 1.0)[..., None]
    x_c = (x - (x * w[..., None]).sum(-2, keepdims=True) / wsum) * \
        w[..., None]
    y_c = (y - (y * w[..., None]).sum(-2, keepdims=True) / wsum) * \
        w[..., None]
    c = jax.lax.stop_gradient(jnp.swapaxes(x_c, -1, -2) @ y_c)
    u, _, vt = jnp.linalg.svd(c, full_matrices=False)
    det = jnp.linalg.det(u) * jnp.linalg.det(vt)
    flip = jnp.where(det < 0, -1.0, 1.0)[..., None, None]
    u = u * jnp.concatenate([jnp.ones_like(flip), jnp.ones_like(flip),
                             flip], axis=-1)
    return x_c @ (u @ vt), y_c


def test_reference_kabsch_is_the_jax_kabsch():
    """Eagerly, the broadcast form equals the JAX package's kabsch, and
    the port's kabsch equals both and the float64 optimum, reflections
    included; jitted, the broadcast form still does."""
    rng = np.random.default_rng(36)
    flips = 0
    for _ in range(12):
        x, y = chain(rng), chain(rng)
        mask = padded_mask(2)
        ref = jgeo.kabsch(x, y, mask=mask)
        for out in (kabsch_broadcast_flip(x, y, mask),
                    jax.jit(kabsch_broadcast_flip)(x, y, mask)):
            close(ref[0], t(np.asarray(out[0])))
        close(ref[0], pgeo.kabsch(t(x), t(y), mask=t(mask))[0])
        for i in range(2):
            xc = x[i, :VALID] - x[i, :VALID].mean(0)
            yc = y[i, :VALID] - y[i, :VALID].mean(0)
            u, _, vt = np.linalg.svd(xc.T.astype(np.float64) @ yc)
            d = np.sign(np.linalg.det(u) * np.linalg.det(vt))
            flips += d < 0
            u[:, -1] *= d
            best = np.sqrt(((xc @ u @ vt - yc) ** 2).sum() / (3 * VALID))
            got = float(pgeo.kabsch_rmsd(t(x[i]), t(y[i]),
                                         mask=t(mask[i])))
            assert abs(got - best) <= 1e-5, (got, best)
    assert flips > 0


class Reference:
    """One configuration's JAX step and the port model bridged from the
    same perturbed params, with both MLM noisings patched to one JAX
    draw. `jax_step(recyclables)` gives (loss, grads, params after one
    Adam step) as numpy trees."""

    def __init__(self, kw, batch, seed, dtype=jnp.float32):
        self.kw, self.batch = kw, batch
        self.jm = jax_af2.Alphafold2(**kw, dtype=dtype)
        params = jax.jit(self.jm.init, static_argnames=("train",))(
            {"params": jax.random.PRNGKey(seed),
             "mlm": jax.random.PRNGKey(seed + 1)},
            batch["seq"], msa=batch["msa"], mask=batch["mask"],
            msa_mask=batch["msa_mask"], train=True)
        self.params = perturb_params(params, jax.random.PRNGKey(seed + 2))
        self.noise = jax_noise(batch, seed + 3)
        self.tx = jax_state.adam(LR)
        self._first = None

    def _adam_step(self, grads, params):
        updates, _ = self.tx.update(grads, self.tx.init(params), params)
        return optax.apply_updates(params, updates)

    def port_model(self, dtype=torch.float32):
        pm = pt_af2.Alphafold2(**self.kw, dtype=dtype, device="cpu")
        load_jax_params(pm, jax.tree.map(np.asarray, self.params))
        return pm

    def bridged(self, tree):
        """A JAX params-shaped tree in the port's parameter layout."""
        holder = self.port_model()
        load_jax_params(holder, jax.tree.map(np.asarray, tree))
        return dict(holder.named_parameters())

    def jax_step(self, recyclables=None):
        if recyclables is None:
            if self._first is None:
                self._first = self._jax_step(None)
            return self._first
        return self._jax_step(recyclables)

    def _jax_step(self, recyclables):
        batch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        noised, replaced = map(jnp.asarray, self.noise)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_mlm.MLM, "noise",
                       lambda self, rng, seq, mask: (noised, replaced))
            mp.setattr(jgeo, "kabsch", kabsch_broadcast_flip)

            def loss_fn(p):
                return jax_loop.compute_loss(self.jm, p, batch,
                                             jax.random.PRNGKey(5),
                                             train=True,
                                             recyclables=recyclables)

            grads, metrics = jax.jit(jax.grad(loss_fn, has_aux=True))(
                self.params)
        # the Adam step under jit: eager, every leaf's ops compile alone
        new_params = jax.jit(self._adam_step)(grads, self.params)
        return (float(metrics["loss"]), self.bridged(grads),
                self.bridged(new_params),
                {k: float(v) for k, v in metrics.items()})


def port_noise(monkeypatch, noise):
    noised, replaced = (t(a) for a in noise)
    monkeypatch.setattr(pt_mlm.MLM, "noise",
                        lambda self, seq, mask, generator=None:
                        (noised, replaced))


def check_step(ref_loss, ref_grads, ref_params, state, metrics):
    loss = float(metrics["loss"])
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), (loss, ref_loss)
    after = dict(state.model.named_parameters())
    assert len(state.grads_seen) == len(after) == len(ref_grads)
    for name, grad in zip(after, state.grads_seen):
        close(ref_grads[name].detach(), grad, atol=1e-4, rtol=1e-3)
    for name, value in after.items():
        close(ref_params[name].detach(), value, atol=1e-5)


def port_step(model, step, batch, generator=None):
    """One port train step from a fresh Adam state; the state keeps the
    gradients it applied as `grads_seen`."""
    state = pt_state.TrainState.create(
        model, pt_state.adam(LR),
        generator=generator or torch.Generator().manual_seed(0))
    seen = []
    apply = state.apply_gradients

    def keep(grads):
        # a None gradient (a parameter the loss does not reach) is zero
        seen.extend(torch.zeros_like(p) if g is None else g.clone()
                    for p, g in zip(state.params, grads))
        return apply(grads)

    state.apply_gradients = keep
    state, metrics = step(state, {k: t(v) for k, v in batch.items()})
    state.grads_seen = seen
    return state, metrics


@pytest.fixture(scope="module")
def distogram_ref():
    return Reference(MODEL_KW, make_batch(40), seed=41)


@pytest.fixture(scope="module")
def coords_ref():
    kw = dict(MODEL_KW, predict_coords=True, structure_module_depth=2)
    return Reference(kw, make_batch(50), seed=51)


def test_distogram_train_step_matches_jax(distogram_ref, monkeypatch):
    ref_loss, ref_grads, ref_params, ref_metrics = distogram_ref.jax_step()
    assert set(ref_metrics) == {"loss", "distogram_loss", "mlm_loss"}
    port_noise(monkeypatch, distogram_ref.noise)
    model = distogram_ref.port_model()
    state, metrics = port_step(model, pt_loop.make_train_step(model),
                               distogram_ref.batch)
    assert set(metrics) == set(ref_metrics)
    check_step(ref_loss, ref_grads, ref_params, state, metrics)
    assert state.step == 1 and state.optimizer.count == 1


def test_coords_train_step_matches_jax(coords_ref, monkeypatch):
    """Coords + confidence + MLM: the gradient reaches every parameter
    through IPA, whose rotations are detached except on the last
    iteration, in both packages."""
    ref_loss, ref_grads, ref_params, ref_metrics = coords_ref.jax_step()
    assert set(ref_metrics) == {"loss", "coords_loss", "confidence_loss",
                                "mlm_loss"}
    port_noise(monkeypatch, coords_ref.noise)
    model = coords_ref.port_model()
    state, metrics = port_step(model, pt_loop.make_train_step(model),
                               coords_ref.batch)
    for key in ref_metrics:
        assert abs(float(metrics[key]) - ref_metrics[key]) <= \
            1e-5 * abs(ref_metrics[key]) + 1e-7, key
    check_step(ref_loss, ref_grads, ref_params, state, metrics)
    structure = [n for n in ref_grads if n.startswith("structure_module.")]
    assert structure and all(
        float(ref_grads[n].detach().abs().max()) > 0 for n in structure)


@pytest.mark.parametrize("recycles", [0, 1])
def test_recycled_train_step_matches_jax(coords_ref, monkeypatch, recycles):
    """make_recycled_train_step with r drawn as 0 and as 1, against JAX's
    compute_loss with the recyclables of one JAX pass without gradients
    (r = 1) or none (r = 0)."""
    rec = None
    if recycles:
        b = coords_ref.batch
        _, ret = jax.jit(functools.partial(
            coords_ref.jm.apply, return_aux_logits=True,
            return_recyclables=True))(
            coords_ref.params, b["seq"], msa=b["msa"], mask=b["mask"],
            msa_mask=b["msa_mask"])
        rec = ret.recyclables
    ref_loss, ref_grads, ref_params, _ = coords_ref.jax_step(rec)
    port_noise(monkeypatch, coords_ref.noise)
    # the generator seed whose first draw is `recycles`
    seed = next(s for s in range(100) if pt_loop.draw_recycles(
        torch.Generator().manual_seed(s), 1) == recycles)
    model = coords_ref.port_model()
    state, metrics = port_step(
        model, pt_loop.make_recycled_train_step(model, max_recycles=1),
        coords_ref.batch, generator=torch.Generator().manual_seed(seed))
    assert float(metrics["recycles"]) == recycles
    check_step(ref_loss, ref_grads, ref_params, state, metrics)


def test_bf16_distogram_step_tracks_jax(distogram_ref, monkeypatch):
    """bf16 trunks round at other places in the two packages: the port's
    bf16 loss stays within 2e-2 (relative) of the JAX package's."""
    b = distogram_ref.batch
    jm16 = jax_af2.Alphafold2(**MODEL_KW, dtype=jnp.bfloat16)
    noised, replaced = map(jnp.asarray, distogram_ref.noise)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mlm.MLM, "noise",
                   lambda self, rng, seq, mask: (noised, replaced))
        ref, _ = jax.jit(lambda p: jax_loop.compute_loss(
            jm16, p, {k: jnp.asarray(v) for k, v in b.items()},
            jax.random.PRNGKey(5), train=True))(distogram_ref.params)
    port_noise(monkeypatch, distogram_ref.noise)
    model = distogram_ref.port_model(dtype=torch.bfloat16)
    state, metrics = port_step(model, pt_loop.make_train_step(model), b)
    loss = float(metrics["loss"])
    assert np.isfinite(loss)
    assert abs(loss - float(ref)) <= 2e-2 * abs(float(ref)), (loss, ref)
    assert all(p.dtype == torch.float32 for p in model.parameters())


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

SCHEDULES = {"constant": dict(), "warmup_only": dict(warmup_steps=5),
             "warmup_cosine": dict(warmup_steps=5, decay_steps=40),
             "cosine_only": dict(decay_steps=30)}


def optax_schedule(lr, warmup_steps=0, decay_steps=None, end_lr_ratio=0.1):
    """The learning rate the JAX package's `adam` builds
    (alphafold2_tpu/train/state.py:33-71), as an optax schedule."""
    if decay_steps is not None:
        return optax.warmup_cosine_decay_schedule(
            init_value=0.0 if warmup_steps > 0 else lr, peak_value=lr,
            warmup_steps=warmup_steps,
            decay_steps=max(decay_steps, warmup_steps + 1),
            end_value=end_lr_ratio * lr)
    if warmup_steps > 0:
        return optax.join_schedules(
            [optax.linear_schedule(0.0, lr, warmup_steps),
             optax.constant_schedule(lr)], boundaries=[warmup_steps])
    return optax.constant_schedule(lr)


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_optax(name):
    kw = SCHEDULES[name]
    spec = pt_state.adam(1e-2, **kw)
    ref = optax_schedule(1e-2, **kw)
    for count in range(60):
        assert abs(spec.schedule(count) - float(ref(count))) <= 1e-7, count
    if name == "warmup_only":   # holds the peak after the ramp
        assert spec.schedule(59) == 1e-2 and spec.schedule(0) == 0.0


def toy_params(rng):
    return {"a": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32)}


@pytest.mark.parametrize("accum,clip,schedule", [
    (1, None, "constant"), (1, 0.5, "warmup_cosine"), (3, None, "constant"),
    (3, 0.5, "warmup_only"), (2, 100.0, "cosine_only")],
    ids=["plain", "clip_cosine", "accum3", "accum3_clip_warmup",
         "accum2_noclip_cosine"])
def test_optimizer_trajectory_matches_optax(accum, clip, schedule):
    """The port's chain against the JAX package's `adam` (clip, Adam with
    the schedule, MultiSteps) over 2k micro-steps of random gradients
    (plus 10 more steps without accumulation): the parameters agree within
    1e-5 after every step, and between updates they do not move."""
    rng = np.random.default_rng(37)
    params = toy_params(rng)
    tx = jax_state.adam(1e-2, grad_accum_every=accum, max_grad_norm=clip,
                        **SCHEDULES[schedule])
    opt_state = tx.init(params)
    mine = [t(params["a"]), t(params["b"])]
    opt = pt_state.adam(1e-2, grad_accum_every=accum, max_grad_norm=clip,
                        **SCHEDULES[schedule])(mine)
    steps = 2 * accum if accum > 1 else 10
    for i in range(steps):
        grads = {k: (rng.normal(size=v.shape) * 3).astype(np.float32)
                 for k, v in params.items()}
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        before = [p.clone() for p in mine]
        applied = opt.update([t(grads["a"]), t(grads["b"])])
        assert applied == ((i + 1) % accum == 0)
        if not applied:
            assert all(torch.equal(a, b) for a, b in zip(before, mine))
        close(params["a"], mine[0])
        close(params["b"], mine[1])
    assert opt.count == steps // accum


def test_clip_by_global_norm_matches_optax():
    rng = np.random.default_rng(38)
    grads = toy_params(rng)
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                             for g in grads.values())))
    for max_norm in (norm / 3, norm * 2):
        ref, _ = optax.clip_by_global_norm(max_norm).update(grads, None)
        out = pt_state.clip_by_global_norm([t(grads["a"]), t(grads["b"])],
                                           max_norm)
        close(ref["a"], out[0], atol=1e-6)
        close(ref["b"], out[1], atol=1e-6)
        # inside the chain: the first moment after one update is
        # (1 - b1) times the clipped gradient
        opt = pt_state.adam(1.0, max_grad_norm=max_norm)(
            [torch.zeros(4, 3), torch.zeros(5)])
        opt.update([t(grads["a"]), t(grads["b"])])
        close(np.asarray(ref["a"]) * 0.1, opt.mu[0], atol=1e-6)


@pytest.mark.parametrize("accum,clip", [(1, None), (1, 0.5), (3, 0.5)],
                         ids=["plain", "clipped", "accumulated"])
def test_unreached_parameters_leave_the_chain_bit_equal(accum, clip):
    """A None gradient is a zero one: the chain skips parameters that have
    never had a gradient, and every parameter, moment and accumulator is
    bit-equal to the chain fed explicit zeros, through a parameter's
    first gradient (step 4), clipping, accumulation and a state reload."""
    rng = np.random.default_rng(39)
    shapes = [(4, 3), (5,), (2, 2), (6,)]
    init = [t(rng.normal(size=s).astype(np.float32)) for s in shapes]
    spec = pt_state.adam(1e-2, grad_accum_every=accum, max_grad_norm=clip)
    zeros, skips = spec([p.clone() for p in init]), spec(
        [p.clone() for p in init])
    for i in range(12):
        grads = [t(rng.normal(size=s).astype(np.float32)) for s in shapes]
        # parameter 2 gets its first gradient at step 4; 3 never gets one
        unreached = {2, 3} if i < 4 else {3}
        zeros.update([torch.zeros_like(g) if at in unreached else g
                      for at, g in enumerate(grads)])
        skips.update([None if at in unreached else g
                      for at, g in enumerate(grads)])
        if i == 6:
            reloaded = spec([p.clone() for p in skips.params])
            reloaded.load_state_dict(skips.state_dict())
            assert reloaded.reached == [True, True, True, False]
            skips = reloaded
        for a, b in zip(zeros.params + zeros.tensors(),
                        skips.params + skips.tensors()):
            assert torch.equal(a, b)
    assert skips.reached == [True, True, True, False]
    assert torch.equal(skips.params[3], init[3])


# ---------------------------------------------------------------------------
# guard
# ---------------------------------------------------------------------------

class Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4))


def toy_step(loss_of):
    """A raw train step on the toy model: loss_of(w, batch) -> loss; the
    step draws once from the generator, as a real step's noise does."""

    def step(state, batch):
        loss = loss_of(state.model.w, batch)
        grads = torch.autograd.grad(loss, state.params)
        torch.rand(1, generator=state.generator)
        state.apply_gradients(grads)
        return state, {"loss": loss.detach()}

    return step


def test_guard_skips_a_nonfinite_step():
    state = pt_state.TrainState.create(Toy(), pt_state.adam(1e-2),
                                       generator=torch.Generator())
    step = pt_guard.guarded_train_step(toy_step(lambda w, b: (w * b).sum()))
    state, m1 = step(state, torch.ones(4))
    assert float(m1["skipped"]) == 0.0
    w1 = state.model.w.detach().clone()
    assert not torch.equal(w1, torch.ones(4))
    mu1 = [m.clone() for m in state.optimizer.mu]
    gen1, step1 = state.generator.get_state(), state.step

    state, m2 = step(state, torch.full((4,), float("nan")))
    assert float(m2["skipped"]) == 1.0
    assert torch.equal(state.model.w.detach(), w1)
    assert all(torch.equal(a, b) for a, b in zip(state.optimizer.mu, mu1))
    assert pt_guard.all_finite(state.optimizer.tensors())
    assert state.optimizer.count == 1
    # step and generator still advance, so the schedule moves on and a
    # skipped batch is not replayed with the same randomness
    assert state.step == step1 + 1
    assert not torch.equal(state.generator.get_state(), gen1)

    state, m3 = step(state, torch.ones(4))
    assert float(m3["skipped"]) == 0.0
    assert pt_guard.all_finite(state.params)
    assert state.optimizer.count == 2


def test_guard_rejects_a_poisoned_accumulator():
    """With accumulation a micro-step can have a finite loss and untouched
    parameters while its gradient is infinite: the accumulator must be
    rolled back, or every later update carries the poison."""
    state = pt_state.TrainState.create(
        Toy(), pt_state.adam(1e-2, grad_accum_every=2),
        generator=torch.Generator())
    step = pt_guard.guarded_train_step(
        toy_step(lambda w, b: torch.sqrt((w * b).sum())))
    state, m1 = step(state, torch.zeros(4))     # sqrt(0): value 0, grad inf
    assert np.isfinite(float(m1["loss"]))
    assert float(m1["skipped"]) == 1.0
    assert pt_guard.all_finite(state.optimizer.tensors())
    assert state.optimizer.mini_step == 0 and state.step == 1
    state, m2 = step(state, torch.ones(4))
    state, m3 = step(state, torch.ones(4))
    assert float(m2["skipped"]) == float(m3["skipped"]) == 0.0
    assert state.optimizer.count == 1
    assert pt_guard.all_finite(state.params + state.optimizer.tensors())


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------

SMALL = dict(dim=16, depth=1, heads=2, dim_head=16)


def small_state(seed=0, accum=1, **kw):
    model = pt_af2.Alphafold2(**SMALL, **kw, device="cpu",
                              generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed + 1)
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return pt_state.TrainState.create(
        model, pt_state.adam(1e-3, grad_accum_every=accum),
        generator=torch.Generator().manual_seed(seed + 2))


def small_batch(seed):
    from alphafold2_tpu_torch.data.synthetic import synthetic_batch
    return synthetic_batch(np.random.default_rng(seed), seq_len=12,
                           msa_depth=2, pad_fraction=0.25)


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    state = small_state(accum=2)
    step = pt_loop.make_train_step(state.model)
    for i in range(3):
        state, _ = step(state, small_batch(i))
    mgr = pt_ckpt.CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None
    assert mgr.save(state) == 3 and mgr.latest_step() == 3

    restored = mgr.restore(small_state(seed=9, accum=2))
    assert restored.step == 3
    for a, b in zip(state.model.state_dict().values(),
                    restored.model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in zip(state.optimizer.tensors(), restored.optimizer.tensors()):
        assert torch.equal(a, b)
    assert (restored.optimizer.count, restored.optimizer.mini_step) == \
        (state.optimizer.count, state.optimizer.mini_step) == (1, 1)
    assert torch.equal(restored.generator.get_state(),
                       state.generator.get_state())

    # the step after a restore equals the step without one
    state, m_a = step(state, small_batch(3))
    restored, m_b = pt_loop.make_train_step(restored.model)(
        restored, small_batch(3))
    assert float(m_a["loss"]) == float(m_b["loss"])
    for a, b in zip(state.params, restored.params):
        assert torch.equal(a, b)


def test_checkpoint_keeps_the_newest(tmp_path):
    state = small_state()
    mgr = pt_ckpt.CheckpointManager(str(tmp_path / "keep"), max_to_keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(state, s)
    assert mgr.steps() == [3, 4]
    assert not [f for f in (tmp_path / "keep").iterdir()
                if ".tmp" in f.name]
    with pytest.raises(FileNotFoundError):
        pt_ckpt.CheckpointManager(str(tmp_path / "empty")).restore(state)


def test_autocheckpointer(tmp_path):
    state = small_state()
    ck = pt_guard.AutoCheckpointer(str(tmp_path / "auto"), every=2)
    assert ck.resume_or(state) is state
    state.step = 1
    ck.maybe_save(state)
    assert ck.manager.latest_step() is None
    state.step = 2
    ck.maybe_save(state)
    assert ck.manager.latest_step() == 2
    assert ck.resume_or(small_state(seed=5)).step == 2
    state.step = 3
    ck.on_failure(state)
    assert ck.manager.latest_step() == 3


# ---------------------------------------------------------------------------
# prefetch, fit, config, entry point
# ---------------------------------------------------------------------------

def test_prefetch_keeps_order_and_values():
    src = [{"x": np.full((4, 2), i, np.float32)} for i in range(7)]
    out = list(pt_prefetch.device_prefetch(iter(src), size=3,
                                           device="cpu"))
    assert [float(b["x"][0, 0]) for b in out] == list(range(7))
    assert all(isinstance(b["x"], torch.Tensor) for b in out)


def test_prefetch_surfaces_the_source_exception():
    def bad():
        yield {"x": np.zeros((2,), np.float32)}
        raise RuntimeError("loader died")

    it = pt_prefetch.device_prefetch(bad(), size=2)
    next(it)
    with pytest.raises(RuntimeError, match="loader died"):
        next(it)


def test_prefetch_worker_stops_on_close():
    consumed = []

    def src():
        for i in range(100):
            consumed.append(i)
            yield {"x": np.full((2,), i, np.float32)}

    it = pt_prefetch.device_prefetch(src(), size=2)
    next(it), next(it)
    it.close()
    deadline = time.monotonic() + 5
    alive = lambda: any(t.name == "device-prefetch" and t.is_alive()  # noqa
                        for t in threading.enumerate())
    while time.monotonic() < deadline and alive():
        time.sleep(0.05)
    assert not alive()
    # yielded 2 + queue capacity 2 + at most 1 in flight
    assert len(consumed) <= 5, consumed


def test_fit_with_prefetch_trains():
    from alphafold2_tpu_torch.obs.registry import MetricsRegistry
    from alphafold2_tpu_torch.utils import StepTimer

    state = small_state()
    reg = MetricsRegistry()

    def stream():
        i = 0
        while True:
            yield {k: v.numpy() for k, v in small_batch(i).items()}
            i += 1

    timer = StepTimer()
    state, history = pt_loop.fit(state.model, state, stream(), num_steps=4,
                                 log_every=1, prefetch=2, registry=reg,
                                 step_timer=timer)
    assert state.step == 4 and len(history) == 4 and timer.count == 4
    assert all(np.isfinite(h["loss"]) for h in history)
    assert reg.counter("train_steps_total").value() == 4
    assert reg.histogram("train_step_seconds").count() == 4
    assert reg.gauge("train_metric", label_names=("name",)).value(
        name="loss") == history[-1]["loss"]


def test_eval_step_is_deterministic_and_leaves_the_state():
    state = small_state()
    before = [p.detach().clone() for p in state.params]
    gen = state.generator.get_state()
    step = pt_loop.make_eval_step(state.model)
    b = small_batch(5)
    m1, m2 = step(state, b), step(state, b)
    assert set(m1) == {"loss", "distogram_loss"}     # no MLM in eval
    assert float(m1["loss"]) == float(m2["loss"])
    assert all(torch.equal(a, p) for a, p in zip(before, state.params))
    assert torch.equal(gen, state.generator.get_state())
    assert state.step == 0


def test_a_mesh_raises():
    with pytest.raises(NotImplementedError, match="item 10"):
        pt_loop.shard_batch({"x": np.zeros(2)}, mesh=object())
    with pytest.raises(NotImplementedError, match="item 10"):
        pt_config.MeshConfig(data=2).build()


def test_jax_experiment_json_loads():
    exp = jax_config.Experiment()
    exp.model.dim, exp.model.depth = 16, 1
    exp.model.attn_dropout, exp.model.bfloat16 = 0.1, False
    exp.train.warmup_steps, exp.train.decay_steps = 10, 100
    exp.train.max_grad_norm = 1.0
    exp.data.crop_len = 24
    port = pt_config.Experiment.from_json(exp.to_json())
    assert port.to_dict() == json.loads(exp.to_json())
    model, tx, mesh = port.build(device="cpu")
    assert mesh is None and model.dim == 16
    assert tx == pt_state.adam(3e-4, 16, 1.0, warmup_steps=10,
                               decay_steps=100)
    attn = model.net.layers[0].msa_attn.row_attn.attn
    assert attn.dropout == 0.1
    assert model.net.layers[0].ff.dropout == 0.0


def test_train_distogram_entry_point(tmp_path):
    from alphafold2_tpu_torch.scripts import train_distogram

    exp = pt_config.Experiment()
    exp.model.dim, exp.model.depth, exp.model.heads = 16, 1, 2
    exp.model.dim_head, exp.model.bfloat16 = 16, False
    exp.data.crop_len, exp.data.msa_depth = 12, 2
    exp.train.num_steps, exp.train.grad_accum_every = 3, 1
    exp.train.log_every = 1
    exp.train.checkpoint_dir = str(tmp_path / "ckpt")
    cfg = tmp_path / "exp.json"
    cfg.write_text(exp.to_json())
    history = train_distogram.main(["--config", str(cfg), "--device", "cpu",
                                    "--log", str(tmp_path / "log.jsonl")])
    assert len(history) == 3 and all(np.isfinite(h["loss"])
                                      for h in history)
    assert pt_ckpt.CheckpointManager(exp.train.checkpoint_dir
                                     ).latest_step() == 3
    assert len((tmp_path / "log.jsonl").read_text().splitlines()) == 3
    for flag, item in (("--data", "item 11"), ("--mesh", "item 10")):
        with pytest.raises(NotImplementedError, match=item):
            train_distogram.main(["--config", str(cfg), "--device", "cpu",
                                  flag, "1,2,1" if flag == "--mesh"
                                  else str(tmp_path)])


# ---------------------------------------------------------------------------
# FLOPs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    dict(dim=256, depth=2, seq_len=256, msa_depth=5),
    dict(dim=32, depth=1, seq_len=16, msa_depth=3, heads=2, dim_head=16,
         batch=2)])
def test_flops_formula_is_the_jax_formula(args):
    assert pt_flops.evoformer_step_flops_formula(**args) == \
        jax_flops.evoformer_step_flops_formula(**args)


def test_train_step_flops_tracks_jax(distogram_ref):
    batch = distogram_ref.batch
    ref = jax_flops.train_step_flops(
        distogram_ref.jm, distogram_ref.params,
        {k: jnp.asarray(v) for k, v in batch.items()})
    out = pt_flops.train_step_flops(distogram_ref.port_model(),
                                    {k: t(v) for k, v in batch.items()})
    assert abs(out - ref) <= 0.02 * ref, (out, ref)


# ---------------------------------------------------------------------------
# dropout and remat
# ---------------------------------------------------------------------------

def dropout_model(use_scan=True, seed=0):
    state = small_state(seed=seed, attn_dropout=0.3, ff_dropout=0.3,
                        use_scan=use_scan)
    return state.model


def test_dropout_acts_in_training_only():
    model = dropout_model()
    b = small_batch(0)
    kw = dict(msa=b["msa"], mask=b["mask"], msa_mask=b["msa_mask"])
    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        noise = model.mlm.noise(b["msa"], b["msa_mask"],
                                torch.Generator().manual_seed(0))
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pt_mlm.MLM, "noise",
                       lambda self, seq, mask, generator=None: noise)
            train = [model(b["seq"], **kw, train=True,
                           generator=torch.Generator().manual_seed(s)
                           ).distance for s in (1, 2, 1)]
        evals = [model(b["seq"], **kw).distance for _ in range(2)]
    assert not torch.allclose(train[0], train[1])
    assert torch.equal(train[0], train[2])
    assert torch.equal(evals[0], evals[1])
    # the rates reach every module
    layer = model.net.layers[0]
    for attn in (layer.msa_attn.row_attn, layer.msa_attn.col_attn,
                 layer.attn.triangle_attention_outgoing,
                 layer.attn.triangle_attention_ingoing):
        assert attn.attn.dropout == 0.3
    assert layer.msa_ff.dropout == layer.ff.dropout == 0.3


def test_fused_attention_seam_under_dropout(monkeypatch):
    """Attention dropout in a training pass warns and takes the plain
    path (the fused kernel has no dropout); eval passes still reach the
    fused attention, and a block-sparse 'auto' spec runs as 'masked'."""
    from alphafold2_tpu_torch.ops.block_sparse import (KernelSpec,
                                                        kernel_context)
    calls = []
    real = pt_prim.fused_attention
    monkeypatch.setattr(pt_prim, "fused_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(pt_prim.Attention, "_block_sparse",
                        lambda *a, **k: pytest.fail("K2 under dropout"))
    attn = pt_prim.Attention(16, heads=2, dim_head=8, dropout=0.2)
    x = torch.randn(3, 16, 16)
    mask = torch.ones(3, 16, dtype=torch.bool)
    with pytest.warns(UserWarning, match="plain attention path"):
        attn(x, mask=mask, train=True, generator=torch.Generator())
    assert not calls
    attn(x, mask=mask)
    assert len(calls) == 1
    spec = KernelSpec.banded(16, 8, window=0, num_global=1)
    with kernel_context(spec, spec.device_plan(torch.device("cpu"))):
        with pytest.warns(UserWarning, match="plain attention path"):
            attn(x, mask=mask, train=True, generator=torch.Generator())
    assert len(calls) == 1
    quiet = pt_prim.Attention(16, heads=2, dim_head=8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        quiet(x, mask=mask, train=True)
    assert len(calls) == 2


def test_remat_replays_dropout():
    """Under use_scan each layer is checkpointed: the recompute must draw
    the masks the forward drew, so the gradient equals the unrolled
    trunk's for the same generator seed."""
    b = small_batch(1)
    out = []
    for use_scan in (True, False):
        model = dropout_model(use_scan=use_scan)
        state = pt_state.TrainState.create(
            model, pt_state.adam(1e-3),
            generator=torch.Generator().manual_seed(4))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            loss, _ = pt_loop.compute_loss(model, b, state.generator)
            grads = pt_loop._gradients(loss, state.params)
        out.append((float(loss.detach()), grads,
                    state.generator.get_state()))
    assert out[0][0] == out[1][0]
    for a, b_ in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-6)
    # the generator ends where the forward left it, recompute or not
    assert torch.equal(out[0][2], out[1][2])
