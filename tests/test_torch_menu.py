"""The port's README-era menu against the JAX package on the CPU: each
class of `attention_variants`, the trunks that use them (interleaved and
scanned block-sparse, FAVOR+, Kronecker and memory-compressed rows, the
conv blocks in the plain and the reversible trunk), the full model from
a `ModelConfig` JSON through the weight bridge, the menu's refusals, and
the `embeds` wrappers over stubbed language models.

Inputs are drawn with numpy from a seed. JAX parameters are drawn with
numpy on `jax.eval_shape(init)`'s shapes (`random_params`: no output
projection is zero) and bridged with `load_jax_params`; every JAX
reference runs under `jax.jit`. Small size: dim 16, heads 2, dim_head
8, 16 residues (12 valid), 3 MSA rows, blocks of 4, depth <= 4. Both
sides compute in fp32; outputs agree within atol 1e-4 at valid
positions (fp32 sums in another order; values of O(1)) and trunk
gradients within 1e-4 of the largest JAX gradient. FAVOR+ runs on one
projection on both sides (JAX's normal, chi-square and QR draws are not
reproduced bit for bit): JAX draws it in place of its own, the port's
class takes it as `projection=`, and the port's trunk draws it in place
of its own. The block-sparse row runs K2's plain version without
gradients and the pattern as a -1e9 bias under them, against JAX's
interpret-mode kernel and its masked-dense path respectively; the two
differ only at padded query rows, which are not compared.
"""

import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import embeds as jax_embeds
from alphafold2_tpu.model import alphafold2 as jax_af2
from alphafold2_tpu.model import attention_variants as jav
from alphafold2_tpu.model import evoformer as jevo
from alphafold2_tpu.ops import attention as jax_ops_attn
from alphafold2_tpu_torch import embeds as pt_embeds
from alphafold2_tpu_torch.config import Experiment
from alphafold2_tpu_torch.model import attention_variants as pav
from alphafold2_tpu_torch.model import evoformer as pevo
from alphafold2_tpu_torch.model import reversible as prev
from alphafold2_tpu_torch.weights import load_jax_params
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)
from test_torch_serve import random_params

D, HEADS, DIM_HEAD, N, ROWS, VALID, BLOCK = 16, 2, 8, 16, 3, 12, 4
ATOL = 1e-4
GRAD_REL = 1e-4
NB_FEATURES = 16


def t(x):
    return torch.from_numpy(np.array(x))


def close(ref, out, atol=ATOL, where=None):
    a = np.asarray(ref, np.float32)
    b = out.detach().float().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    if where is not None:
        a, b = a[where], b[where]
    err = float(np.abs(a - b).max())
    assert err <= atol, f"max abs err {err} > {atol}"
    return err


def jax_params(module, seed, *args, **kwargs):
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs),
                            jax.random.PRNGKey(0))
    return random_params(shapes, np.random.default_rng(seed))


def bridge(port_module, params):
    load_jax_params(port_module, jax.tree.map(np.asarray, params))
    return port_module


@pytest.fixture
def projection(monkeypatch):
    """One FAVOR+ projection, drawn by the JAX package in place of its
    own draw."""
    proj = np.random.default_rng(40).standard_normal(
        (NB_FEATURES, DIM_HEAD)).astype(np.float32)
    monkeypatch.setattr(jav, "orthogonal_random_features",
                        lambda key, nb, d: jnp.asarray(proj))
    return proj


@pytest.fixture
def trunk_projection(projection, monkeypatch):
    """The same projection drawn by the port's trunk too, whose rows take
    no `projection=`."""
    monkeypatch.setattr(pav, "orthogonal_random_features",
                        lambda gen, nb, d, device=None: t(projection))
    return projection


@contextlib.contextmanager
def jax_kernel_route():
    """JAX's block-sparse kernel path on the CPU, as
    tests/test_attention_variants.py sets it up: the Pallas backend
    selected and the fused attention in interpret mode."""
    fused = jax_ops_attn.fused_attention
    jax_ops_attn.fused_attention = \
        lambda *a, **k: fused(*a, **dict(k, interpret=True))
    try:
        with jax_ops_attn.pallas_attention(True):
            yield
    finally:
        jax_ops_attn.fused_attention = fused


def rows_inputs(seed, n=N, valid=VALID, b=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, D)).astype(np.float32)
    mask = np.broadcast_to(np.arange(n) < valid, (b, n)).copy()
    return x, mask


# ---------------------------------------------------------------------------
# the variant classes
# ---------------------------------------------------------------------------

def _linear():
    return (jav.LinearAttention(dim=D, heads=HEADS, dim_head=DIM_HEAD),
            pav.LinearAttention(D, HEADS, DIM_HEAD), {})


def _performer():
    return (jav.PerformerAttention(dim=D, heads=HEADS, dim_head=DIM_HEAD,
                                   nb_features=NB_FEATURES),
            pav.PerformerAttention(D, HEADS, DIM_HEAD,
                                   nb_features=NB_FEATURES), {})


def _compress(r):
    return lambda: (
        jav.MemoryCompressedAttention(dim=D, heads=HEADS, dim_head=DIM_HEAD,
                                      compress_ratio=r),
        pav.MemoryCompressedAttention(D, HEADS, DIM_HEAD, compress_ratio=r),
        {})


def _sparse():
    return (jav.BlockSparseAttention(dim=D, heads=HEADS, dim_head=DIM_HEAD,
                                     block=BLOCK),
            pav.BlockSparseAttention(D, HEADS, DIM_HEAD, block=BLOCK), {})


VARIANTS = {
    "linear": (_linear, N),
    "performer": (_performer, N),
    "compress2": (_compress(2), N),
    "compress3_ragged": (_compress(3), N),
    # K2's plain version (no gradients, n % block == 0); 8 blocks, so
    # the pattern leaves valid keys out
    "sparse_kernel_route": (_sparse, 2 * N),
    # the pattern as a bias: a partial last block
    "sparse_partial_block": (_sparse, 2 * N - 2),
}


@pytest.mark.parametrize("case", list(VARIANTS))
def test_variant_matches_jax(case, projection):
    make, n = VARIANTS[case]
    jm, pm, _ = make()
    valid = n - 4
    x, mask = rows_inputs(1, n=n, valid=valid)
    params = jax_params(jm, 2, x, mask=mask)
    bridge(pm, params)
    apply = jax.jit(lambda p, x, mask: jm.apply(p, x, mask=mask))
    if case == "sparse_kernel_route":
        with jax_kernel_route():
            ref = apply(params, x, mask)
    else:
        ref = apply(params, x, mask)
    # the port's Performer takes the JAX draw as `projection=`
    extra = {"projection": t(projection)} if case == "performer" else {}
    with torch.no_grad():
        out = pm(t(x), mask=t(mask), **extra)
    close(ref, out, where=(slice(None), slice(0, valid)))
    if case.startswith("sparse"):
        # the pattern shapes the result: all keys live differs
        with torch.no_grad():
            dense = pm.attn(t(x), mask=t(mask))
        assert float((dense - out)[:, :valid].abs().max()) > 1e-3


def test_kronecker_attention_and_pool_match_jax():
    rng = np.random.default_rng(3)
    x, mask = rows_inputs(4)
    ctx = rng.normal(size=(2, 6, 5, D)).astype(np.float32)
    cmask = np.ones((2, 6, 5), bool)
    cmask[0, 4:] = False
    cmask[1, :, 3:] = False
    for cm in (cmask, None):
        pooled, tmask = jav.kronecker_pool_2d(ctx, cm)
        got, gmask = pav.kronecker_pool_2d(t(ctx), None if cm is None
                                           else t(cm))
        close(pooled, got)
        np.testing.assert_array_equal(np.asarray(tmask), gmask.numpy())
    jm = jav.KroneckerAttention(dim=D, heads=HEADS, dim_head=DIM_HEAD)
    pm = pav.KroneckerAttention(D, HEADS, DIM_HEAD)
    params = jax_params(jm, 5, x, ctx, mask=mask, context_mask=cmask)
    bridge(pm, params)
    ref = jax.jit(lambda p: jm.apply(p, x, ctx, mask=mask,
                                     context_mask=cmask))(params)
    with torch.no_grad():
        out = pm(t(x), t(ctx), mask=t(mask), context_mask=t(cmask))
    close(ref, out, where=(slice(None), slice(0, VALID)))


def test_conv_block_matches_jax_with_even_kernels_and_dilation():
    """SAME padding of an even kernel puts the extra row on the high
    side, as XLA does; dilation 2 widens each branch."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 7, 9, D)).astype(np.float32)
    mask = np.ones((2, 7, 9), bool)
    mask[0, 5:] = False
    mask[1, :, 6:] = False
    kernels, dilations = ((2, 2), (1, 4), (3, 1)), (1, 2)
    jm = jav.MultiKernelConvBlock(dim=D, kernels=kernels,
                                  dilations=dilations)
    pm = pav.MultiKernelConvBlock(D, kernels, dilations)
    params = jax_params(jm, 7, x, mask=mask)
    assert "conv_2x2_d2" in params["params"]
    bridge(pm, params)
    ref = jax.jit(lambda p: jm.apply(p, x, mask=mask))(params)
    with torch.no_grad():
        out = pm(t(x), mask=t(mask))
    close(ref, out)
    assert float(out.abs().max()) > 1e-2


def test_block_sparse_patterns_match_jax():
    for n, block, glob, window in ((64, 16, 1, 1), (50, 8, 2, 0)):
        np.testing.assert_array_equal(
            np.asarray(jav.block_sparse_mask(n, block, glob, window)),
            pav.block_sparse_mask(n, block, glob, window))
    # the row's pattern is the serving spec's, made once per length and
    # device; a partial last block has a bias and no plan
    cpu = torch.device("cpu")
    spec, plan, bias = pav.banded_route(N, BLOCK, 1, 1, cpu)
    assert pav.banded_route(N, BLOCK, 1, 1, cpu)[1] is plan
    np.testing.assert_array_equal(plan.pattern,
                                  jav.block_sparse_block_pattern(N // BLOCK))
    np.testing.assert_array_equal(
        bias[0, 0].numpy() == 0, jav.block_sparse_mask(N, BLOCK))
    _, plan, bias = pav.banded_route(N - 2, BLOCK, 1, 1, cpu)
    assert plan is None
    np.testing.assert_array_equal(
        bias[0, 0].numpy() == 0, jav.block_sparse_mask(N - 2, BLOCK))


def test_sparse_row_trains_where_the_jax_kernel_route_raises():
    """A fault of the JAX package, kept out of the port (ROADMAP queue
    3): where its kernel route is on (a TPU backend, or the Pallas
    backend selected as here) and n divides into blocks, `jax.grad`
    through `BlockSparseAttention` raises NotImplementedError, as the
    block-skipping kernel has no VJP, so the documented menu cannot train
    at the default dropout 0. The port takes the -1e9 bias route under
    gradients (on the card, K1 and its backward) and trains; the
    sparse_gradients trunk case holds those gradients against JAX's
    masked-dense ones."""
    jm, pm, _ = _sparse()
    x, mask = rows_inputs(18, n=2 * N, valid=2 * N)
    params = jax_params(jm, 19, x, mask=mask)
    with jax_kernel_route(), pytest.raises(NotImplementedError):
        jax.grad(lambda p: jm.apply(p, x, mask=mask).sum())(params)
    bridge(pm, params)
    out = pm(t(x), mask=t(mask))
    grads = torch.autograd.grad(out.sum(), list(pm.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    assert float(grads[0].abs().max()) > 0


def test_sparse_dropout_warns_and_takes_the_dense_path():
    _, pm, _ = _sparse()
    pm.dropout = pm.attn.dropout = 0.5
    x, mask = rows_inputs(8)
    with pytest.warns(RuntimeWarning, match="DENSE masked attention"):
        a = pm(t(x), mask=t(mask), train=True,
               generator=torch.Generator().manual_seed(1))
    assert torch.isfinite(a).all()


# ---------------------------------------------------------------------------
# trunks
# ---------------------------------------------------------------------------

def trunk_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, N, N, D)).astype(np.float32)
    m = rng.normal(size=(1, ROWS, N, D)).astype(np.float32)
    valid = (np.arange(N) < VALID)[None]
    return (x, m, valid[:, :, None] & valid[:, None, :],
            np.broadcast_to(valid[:, None], (1, ROWS, N)).copy())


TRUNKS = {
    # one variant per layer: the unrolled trunk (flax `layers_<i>`)
    "interleaved_sparse": dict(depth=4,
                               sparse_self_attn=(True, False) * 2),
    # the sparse row under gradients (the -1e9 bias route) and the remat
    # backward: the menu's training step
    "sparse_gradients": dict(depth=2, sparse_self_attn=(True, False)),
    # a uniform menu runs the scanned trunk (flax `layers/block`)
    "scanned_favor": dict(depth=2, linear_attn=True),
    "kron_and_compress": dict(depth=2, kron_attn=(True, False),
                              kv_compress_ratio=(0, 3)),
}
# the conv blocks in the plain scanned trunk and in the reversible trunk
# (outputs and gradients) are held against JAX by
# tests/test_torch_model.py::test_evoformer_scanned_depth2 and
# tests/test_torch_reversible.py::test_trunk_and_gradients_match_jax
WITH_GRADS = ("sparse_gradients",)
LAYOUT = {"scanned_favor": "layers"}


def relative_err(got, ref):
    scale = max(float(r.abs().max()) for r in ref)
    return max(float((a - b).abs().max()) for a, b in zip(got, ref)) / scale


@pytest.mark.parametrize("case", list(TRUNKS))
def test_trunk_matches_jax(case, trunk_projection):
    kw = dict(TRUNKS[case], performer_nb_features=NB_FEATURES,
              sparse_block=BLOCK)
    x, m, pair_mask, msa_mask = trunk_inputs(9)
    jm = jevo.Evoformer(dim=D, heads=HEADS, dim_head=DIM_HEAD, **kw)
    params = jax_params(jm, 10, x, m, mask=pair_mask, msa_mask=msa_mask)
    assert LAYOUT.get(case, "layers_0") in params["params"]
    pm = bridge(pevo.Evoformer(D, heads=HEADS, dim_head=DIM_HEAD, **kw),
                params)
    valid = (pair_mask[..., None], msa_mask[..., None])

    def loss(p, x, m):
        out = jm.apply(p, x, m, mask=pair_mask, msa_mask=msa_mask)
        return sum(((o * v) ** 2).sum() for o, v in zip(out, valid)), out

    grads = case in WITH_GRADS
    if grads:
        (_, ref), ref_g = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(params, x, m)
    else:
        ref = jax.jit(lambda p: loss(p, x, m)[1])(params)
    with torch.no_grad():
        out = pm(t(x), t(m), mask=t(pair_mask), msa_mask=t(msa_mask))
    for r, o, v in zip(ref, out, valid):
        close(np.asarray(r) * v, o * t(v))
    if not grads:
        return
    # under gradients the sparse rows take the -1e9 bias route, and the
    # remat (use_scan) backward replays them
    xl, ml = t(x).requires_grad_(), t(m).requires_grad_()
    out = pm(xl, ml, mask=t(pair_mask), msa_mask=t(msa_mask))
    total = sum(((o * t(v)) ** 2).sum() for o, v in zip(out, valid))
    got = torch.autograd.grad(total, [xl, ml] + list(pm.parameters()))
    holder = bridge(pevo.Evoformer(D, heads=HEADS, dim_head=DIM_HEAD, **kw),
                    ref_g[0])
    want = [t(np.asarray(ref_g[1])), t(np.asarray(ref_g[2]))] + \
        [p.detach() for p in holder.parameters()]
    assert relative_err(got, want) <= GRAD_REL


def test_performer_projection_is_fixed_at_inference_and_redrawn_in_training():
    pm = pav.PerformerAttention(D, HEADS, DIM_HEAD, nb_features=12, seed=3)
    cpu = torch.device("cpu")
    fixed = pm.projection_for(cpu, False, None)
    again = pav.PerformerAttention(D, HEADS, DIM_HEAD, nb_features=12,
                                   seed=3).projection_for(cpu, False, None)
    assert torch.equal(fixed, again) and fixed.shape == (12, DIM_HEAD)
    other = pav.PerformerAttention(D, HEADS, DIM_HEAD, nb_features=12,
                                   seed=4).projection_for(cpu, False, None)
    assert not torch.equal(fixed, other)
    gen = torch.Generator().manual_seed(0)
    a = pm.projection_for(cpu, True, gen)
    b = pm.projection_for(cpu, True, gen)
    assert not torch.equal(a, b)
    # rows of one block are orthogonal; norms are chi(dim_head)
    block = a[:DIM_HEAD] / a[:DIM_HEAD].norm(dim=-1, keepdim=True)
    torch.testing.assert_close(block @ block.T, torch.eye(DIM_HEAD),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the full model from a ModelConfig JSON
# ---------------------------------------------------------------------------

MENU_CONFIG = dict(
    dim=D, depth=4, heads=HEADS, dim_head=DIM_HEAD, bfloat16=False,
    sparse_self_attn=[True, False, False, False],
    linear_attn=[False, True, False, False], linear_attn_kind="elu",
    kron_attn=[False, False, True, False],
    kv_compress_ratio=[0, 0, 0, 2], use_conv=True, sparse_block=BLOCK,
    extra_msa_evoformer_layers=1)


def test_menu_model_from_config_json_bridges_from_jax():
    """Every row variant and the conv blocks in one unrolled trunk: the
    JSON lists reach the trunk, and the bridge fills every port parameter
    from the JAX tree (no skip list); the model folds finite."""
    exp = Experiment.from_json(json.dumps({"model": MENU_CONFIG}))
    pm = exp.model.build(device="cpu")
    assert [layer.msa_attn.row_variant for layer in pm.net.layers] == \
        ["sparse", "linear", "kron", "compress"]
    rng = np.random.default_rng(11)
    seq = rng.integers(0, 21, (1, N))
    msa = rng.integers(0, 21, (1, ROWS, N))
    mask = (np.arange(N) < VALID)[None]
    msa_mask = np.broadcast_to(mask[:, None], (1, ROWS, N)).copy()
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in MENU_CONFIG.items() if k != "bfloat16"}
    jm = jax_af2.Alphafold2(**kw)
    params = jax_params(jm, 12, seq, msa=msa, mask=mask, msa_mask=msa_mask)
    assert "row_norm" in params["params"]["net"]["layers_0"]["msa_attn"]
    assert "conv_9x1_d1" in params["params"]["net"]["layers_3"]["pair_conv"]
    bridge(pm, params)
    with torch.inference_mode():
        out = pm(t(seq), msa=t(msa), mask=t(mask), msa_mask=t(msa_mask))
    assert torch.isfinite(out.distance).all()


REFUSALS = {
    "conflict": dict(depth=2, sparse_self_attn=True, linear_attn=(False,
                                                                 True)),
    "length": dict(depth=2, kron_attn=(True, False, True)),
    "reversible": dict(depth=2, sparse_self_attn=True, reversible=True),
    "ring": dict(depth=2, kv_compress_ratio=2, ring_attention=True),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_menu_refusals_match_jax(case):
    x, m, pair_mask, msa_mask = trunk_inputs(13)
    jm = jevo.Evoformer(dim=D, heads=HEADS, dim_head=DIM_HEAD,
                        **REFUSALS[case])
    with pytest.raises(AssertionError) as jax_err:
        jax.eval_shape(lambda k: jm.init(k, x, m, mask=pair_mask,
                                         msa_mask=msa_mask),
                       jax.random.PRNGKey(0))
    with pytest.raises(ValueError) as port_err:
        pevo.Evoformer(D, heads=HEADS, dim_head=DIM_HEAD, **REFUSALS[case])
    assert str(port_err.value) == str(jax_err.value)


def test_reversible_conv_inverts_exactly():
    x, m, pair_mask, msa_mask = (t(a) for a in trunk_inputs(14))
    trunk = prev.ReversibleEvoformer(D, 1, heads=HEADS, dim_head=DIM_HEAD,
                                     use_conv=True)
    gen = torch.Generator().manual_seed(15)
    with torch.no_grad():
        for p in trunk.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.05)
        layer = trunk.rev_layers[0]
        streams = (x, x + 0.1, m, m - 0.1)
        out = prev.layer_forward(layer, streams, pair_mask, msa_mask)
        back = prev.layer_inverse(layer, out, pair_mask, msa_mask)
        no_conv = prev.layer_forward(
            prev.RevEvoLayer(D, HEADS, DIM_HEAD), streams, pair_mask,
            msa_mask)
    assert layer.pair_conv is not None and layer.msa_conv is not None
    for a, b in zip(back, streams):
        assert float((a - b).abs().max()) <= 1e-5
    assert no_conv[1].shape == out[1].shape


# ---------------------------------------------------------------------------
# embeds: the wrappers over stubbed language models
# ---------------------------------------------------------------------------

class _FakeHubModel:
    """representations[layer][b, i] = the token id at i plus i / 100: the
    test sees which positions and rows the wrapper keeps."""

    def __init__(self, width):
        self.width = width

    def __call__(self, toks, repr_layers=(), return_contacts=False):
        pos = torch.arange(toks.shape[-1], dtype=torch.float32) / 100
        rep = (toks.float() + pos)[..., None].expand(*toks.shape,
                                                     self.width)
        return {"representations": {repr_layers[0]: rep}}


def _batch_converter(msa):
    """ESM's converter: a leading BOS (id 0) per row, residues as their
    alphabet index; the MSA converter adds a batch axis."""
    from alphafold2_tpu_torch.constants import AA_ALPHABET

    def convert(data):
        toks = torch.tensor([[0] + [AA_ALPHABET.index(c) + 1 if c in
                                    AA_ALPHABET else 99 for c in
                                    s.replace("<pad>", "_")]
                             for _, s in data])
        return None, None, toks[None] if msa else toks
    return convert


class _FakeTokenizer:
    """ProtBert / ProtT5: space-separated residues; `cls` a leading
    token, and a trailing end token."""

    def __init__(self, cls):
        self.cls = cls

    def _encode(self, texts):
        rows = [[ord(c) for c in s.split()] for s in texts]
        ids = torch.tensor([[7] * self.cls + r + [9] for r in rows])
        return {"input_ids": ids, "attention_mask": torch.ones_like(ids)}

    def __call__(self, texts, return_tensors="pt", padding=True):
        return self._encode(texts)

    def batch_encode_plus(self, texts, **kw):
        return self._encode(texts)


class _FakeEncoder:
    def __call__(self, input_ids=None, attention_mask=None):
        pos = torch.arange(input_ids.shape[-1], dtype=torch.float32) / 100

        class R:
            last_hidden_state = (input_ids.float() + pos)[..., None].expand(
                *input_ids.shape, 4)
        return R()


WRAPPERS = {
    "esm": ("ESMEmbedWrapper", lambda: (_FakeHubModel(1280),
                                        _batch_converter(False))),
    "msa": ("MSAEmbedWrapper", lambda: (_FakeHubModel(768),
                                        _batch_converter(True))),
    "prot_t5": ("ProtT5EmbedWrapper", lambda: (_FakeEncoder(),
                                               _FakeTokenizer(0))),
    "prot_bert": ("ProtTranEmbedWrapper", lambda: (_FakeEncoder(),
                                                   _FakeTokenizer(1))),
}


@pytest.mark.parametrize("name", list(WRAPPERS))
def test_embed_wrapper_matches_jax(name):
    """Token slicing, MSA flattening and row layout equal the JAX
    wrapper's on the same stubbed backend, for the sequence and a
    (b, rows, n) MSA with a gap."""
    cls, backend = WRAPPERS[name]
    rng = np.random.default_rng(16)
    seq = rng.integers(0, 20, (2, 5))
    msa = rng.integers(0, 21, (2, 3, 5))
    ref_w = getattr(jax_embeds, cls)(alphafold2=None)
    port_w = getattr(pt_embeds, cls)(alphafold2=None)
    ref_w._backend, port_w._backend = backend(), backend()
    ref = ref_w.embed_batch(seq, msa)
    got = port_w.embed_batch(t(seq), t(msa))
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got[1].shape[:3] == (2, 3, 5)


def test_embed_wrapper_injects_and_stays_gated(monkeypatch):
    """The wrapper's call is the model's forward with the embeddings as
    seq_embed / msa_embed; without its backend the first embedding
    raises RuntimeError, as in JAX."""
    from alphafold2_tpu_torch.model.alphafold2 import Alphafold2

    model = Alphafold2(dim=D, depth=1, heads=HEADS, dim_head=DIM_HEAD,
                       device="cpu")
    w = pt_embeds.ESMEmbedWrapper(model)
    w._backend = WRAPPERS["esm"][1]()
    seq = np.random.default_rng(17).integers(0, 20, (1, 6))
    msa = np.repeat(seq[:, None], 2, axis=1)
    with torch.inference_mode():
        out = w(seq=seq, msa=msa)
        e_seq, e_msa = w.embed_batch(seq, msa)
        direct = model(t(seq), msa=t(msa), seq_embed=t(e_seq),
                       msa_embed=t(e_msa))
        plain = model(t(seq), msa=t(msa))
    torch.testing.assert_close(out.distance, direct.distance, rtol=0, atol=0)
    assert float((out.distance - plain.distance).abs().max()) > 1e-4

    def offline(*a, **k):
        raise OSError("offline")

    monkeypatch.setattr(torch.hub, "load", offline)
    with pytest.raises(RuntimeError, match="needs its pretrained weights"):
        pt_embeds.ESMEmbedWrapper(model).embed_batch(seq)
