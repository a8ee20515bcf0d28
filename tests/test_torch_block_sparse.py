"""The port's block-sparse attention (ops/block_sparse.py) against the JAX
package's.

The plain version (what the wrapper runs on CPU tensors) is held against
the JAX Pallas kernel in interpret mode, mirroring
tests/test_ops.py::TestBlockSparseKernel, at every row: the two share the
contract, masked-key rows included. fp32 within atol 1e-5 (online vs
dense softmax, sums in another order); bf16 within 2e-2 (the output's
rounding). The host half (plans, contact planning, KernelSpec labels) must
equal the JAX package's exactly. Small sizes: N <= 16 for interpret-mode
calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops import block_sparse as jax_bs
from alphafold2_tpu.ops.attention import attention_reference as jax_attn_ref
from alphafold2_tpu_torch.model import primitives as pt_prim
from alphafold2_tpu_torch.ops import block_sparse as pt_bs
from alphafold2_tpu_torch.ops.attention import (attention_reference,
                                                kernel_head_dim)
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)


ATOL = 1e-5


def t(x):
    return torch.from_numpy(np.array(x))


def case(name, seed=0):
    """(q, k, v, pattern, kwargs) as numpy, kwargs shared by both sides."""
    rng = np.random.default_rng(seed)
    b, n, d, blk, heads, rep = 2, 16, 16, 4, 1, 1
    pattern = pt_bs.banded_block_pattern(n // blk, 1, 1)
    bias = k_mask = None
    scale = 1.0
    if name == "default_scale":
        scale = None
    elif name == "k_mask":
        # a ragged tail, a fully masked block, and one row whose keys are
        # all masked (it averages over its live keys)
        b, heads = 3, 1
        k_mask = np.ones((b, n), bool)
        k_mask[0, 11:] = False
        k_mask[1, 4:8] = False
        k_mask[2] = False
    elif name == "bias_repeat":
        heads, rep = 2, 3
        b = 2 * rep * heads
        bias = rng.normal(size=(2 * heads, n, n)).astype(np.float32)
        k_mask = np.arange(n)[None] < rng.integers(6, n + 1, (b // heads, 1))
    elif name == "wide":
        blk = 2
        pattern = pt_bs.banded_block_pattern(n // blk, 2, 2)
    q, k, v = (rng.normal(size=(b, n, d)).astype(np.float32)
               for _ in range(3))
    return q, k, v, pattern, dict(bias=bias, bias_repeat=rep, heads=heads,
                                  k_mask=k_mask, scale=scale, block=blk)


def jax_out(q, k, v, pattern, kw, dtype=jnp.float32):
    kw = dict(kw)
    for key in ("bias", "k_mask"):
        if kw[key] is not None:
            kw[key] = jnp.asarray(kw[key])
    return np.asarray(jax_bs.block_sparse_attention(
        *(jnp.asarray(x, dtype) for x in (q, k, v)), pattern,
        interpret=True, **kw).astype(jnp.float32))


def port_kw(kw):
    return dict(kw, bias=None if kw["bias"] is None else t(kw["bias"]),
                k_mask=None if kw["k_mask"] is None else t(kw["k_mask"]))


@pytest.mark.parametrize("name", ["dense_equivalent", "default_scale",
                                  "k_mask", "bias_repeat", "wide"])
def test_plain_and_cpu_wrapper_match_jax_kernel(name):
    q, k, v, pattern, kw = case(name)
    want = jax_out(q, k, v, pattern, kw)
    plain = pt_bs.block_sparse_reference(t(q), t(k), t(v), pattern,
                                         **port_kw(kw))
    wrapped = pt_bs.block_sparse_attention(t(q), t(k), t(v), pattern,
                                           **port_kw(kw))
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL, rtol=0)
    assert torch.equal(plain, wrapped)        # CPU tensors: the plain path


def unit_walk(q, k, v, plan, *, bias=None, bias_repeat=1, k_mask=None,
              heads=1, scale=1.0):
    """A plain PyTorch walker of the warpgroup layout's unit plan, in the
    kernel's order: per unit of 64 query rows (units in `unit_order`),
    its entries and key tiles of min(block, 32) keys, an online fp32
    softmax tile by tile in which only the 16-row warps an entry's owner
    mask names take part (the others keep their max, sum and output)."""
    b, n, d = q.shape
    kb = plan.kernel_block
    bk = min(kb, 32)
    full = None
    if bias is not None:
        full = bias.float().reshape(-1, heads, n, n).repeat_interleave(
            bias_repeat, 0).reshape(b, n, n)
    out = torch.zeros(b, n, d)
    for u in plan.unit_order.tolist():
        r0, r1 = 64 * u, min(64 * u + 64, n)
        qs = torch.zeros(b, 64, d)
        qs[:, :r1 - r0] = q[:, r0:r1].float()
        m = torch.full((b, 64), float("-inf"))
        l = torch.zeros(b, 64)
        o = torch.zeros(b, 64, d)
        for e in range(int(plan.unit_counts[u])):
            col, own = int(plan.unit_cols[u, e]), int(plan.unit_owners[u, e])
            rows = torch.tensor([(own >> (r // 16)) & 1 == 1
                                 for r in range(64)])
            for t in range(kb // bk):
                j = col * kb + t * bk + torch.arange(bk)
                s = qs @ k[:, j].float().transpose(1, 2) * scale
                if full is not None:
                    tile = torch.zeros(b, 64, bk)
                    tile[:, :r1 - r0] = full[:, r0:r1][:, :, j]
                    s = s + tile
                if k_mask is not None:
                    keep = k_mask.repeat_interleave(heads, 0)[:, j]
                    s = s.masked_fill(~keep[:, None, :], pt_bs.MASK_VALUE)
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[..., None])
                alpha = torch.exp(m - m_new)
                l_new = l * alpha + p.sum(-1)
                o_new = o * alpha[..., None] + p @ v[:, j].float()
                m = torch.where(rows, m_new, m)
                l = torch.where(rows, l_new, l)
                o = torch.where(rows[:, None], o_new, o)
        out[:, r0:r1] = (o / l[..., None])[:, :r1 - r0]
    return out


@pytest.mark.parametrize("block", [16, 32])
def test_unit_plan_walker_matches_jax_kernel(block):
    """The warpgroup layout's unit plan, walked tile by tile with its
    owner masks (`unit_walk`), computes the contract: held against the
    JAX Pallas kernel in interpret mode (fp32, atol 1e-5) at N = 96, so
    the last unit holds rows past N; a bias replayed over bias_repeat
    with two heads, a scale other than 1, and a query block whose live
    keys are all masked in one mask row."""
    rng = np.random.default_rng(block)
    heads, rep, n, d = 2, 2, 96, 16
    b = 2 * heads * rep
    nqb = n // block
    pattern = pt_bs.banded_block_pattern(nqb, 1, 1)
    q, k, v = (rng.normal(size=(b, n, d)).astype(np.float32)
               for _ in range(3))
    bias = rng.normal(size=(b // rep, n, n)).astype(np.float32)
    k_mask = np.arange(n)[None] < rng.integers(n // 2, n + 1,
                                               (b // heads, 1))
    k_mask[1, :3 * block] = False       # query block 1: every live key
    kw = dict(bias=bias, bias_repeat=rep, heads=heads, k_mask=k_mask,
              scale=0.37, block=block)
    want = jax_out(q, k, v, pattern, kw)
    plan = pt_bs.BlockPlan.build(pattern, block, "cpu")
    got = unit_walk(t(q), t(k), t(v), plan, bias=t(bias), bias_repeat=rep,
                    k_mask=t(k_mask), heads=heads, scale=0.37)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def unit_plan_cases():
    """(pattern, block) of every unit shape: the default 512 spec, banded
    patterns at each K2 block, a block-48 pattern (re-planned at 16) and
    an irregular contact pattern."""
    rng = np.random.default_rng(5)
    contacts = rng.random((256, 256)).astype(np.float32)
    return {
        "default_512": (pt_bs.banded_block_pattern(16, 1, 1), 32),
        "band16": (pt_bs.banded_block_pattern(10, 1, 1), 16),
        "band32": (pt_bs.banded_block_pattern(7, 2, 0), 32),
        "band64": (pt_bs.banded_block_pattern(4, 0, 1), 64),
        "band128": (pt_bs.banded_block_pattern(4, 1, 0), 128),
        "replan48": (pt_bs.banded_block_pattern(4, 1, 1), 48),
        "contact32": (pt_bs.contact_block_pattern(
            np.maximum(contacts, contacts.T), 32, live_frac=0.2), 32),
    }


@pytest.mark.parametrize("name", sorted(unit_plan_cases()))
def test_block_sparse_unit_plan(name):
    """The warpgroup layout's unit plan: every live (query block, key
    block) is owned exactly once by each 16-row warp of the query block,
    no dead one is owned, the tile counts are the unions' sizes (50 a
    batch*head row at the default 512 spec) and the units run heaviest
    first."""
    pattern, block = unit_plan_cases()[name]
    plan = pt_bs.BlockPlan.build(pattern, block, "cpu")
    kb = plan.kernel_block
    live = live_pattern(plan)
    n = plan.n
    units = -(-n // 64)
    for name_ in pt_bs.UNIT_FIELDS:
        assert getattr(plan, name_).dtype == torch.int32
    assert tuple(plan.unit_counts.shape) == (units,)
    owned = np.zeros((units * 4, live.shape[1]), int)   # (16-row warp, key)
    for u in range(units):
        count = int(plan.unit_counts[u])
        cols = plan.unit_cols[u, :count].numpy()
        owners = plan.unit_owners[u, :count].numpy()
        assert np.all(np.diff(cols) > 0) and np.all(owners > 0)
        for w in range(4):
            owned[4 * u + w, cols] += (owners >> w) & 1
        want = set()
        for w in range(4):
            if 64 * u + 16 * w < n:
                want |= set(np.nonzero(live[(64 * u + 16 * w) // kb])[0])
        assert set(cols.tolist()) == want
    rows = np.arange(units * 4) * 16
    expect = np.zeros_like(owned)
    expect[rows < n] = live[rows[rows < n] // kb]
    np.testing.assert_array_equal(owned, expect)
    if name == "default_512":
        assert int(plan.unit_counts.sum()) == 50
        assert plan.unit_counts.tolist() == [16, 5, 5, 5, 5, 5, 5, 4]
    order = plan.unit_order.numpy()
    assert sorted(order.tolist()) == list(range(units))
    assert np.all(np.diff(plan.unit_counts.numpy()[order]) <= 0)


def test_dense_equivalence_through_pattern_bias():
    """With the pattern as a -1e9 additive bias, dense attention (JAX's
    and the port's) computes the same function."""
    q, k, v, pattern, kw = case("dense_equivalent")
    tok = pt_bs.token_mask(pattern, kw["block"])
    bias = np.broadcast_to(np.where(tok, 0.0, pt_bs.MASK_VALUE),
                           q.shape[:1] + tok.shape).astype(np.float32)
    out = pt_bs.block_sparse_reference(t(q), t(k), t(v), pattern,
                                       **port_kw(kw))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jax_attn_ref(q, k, v, bias=bias)),
        atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        out.numpy(), attention_reference(t(q), t(k), t(v), t(bias)).numpy(),
        atol=ATOL, rtol=0)


def test_default_scale_is_inv_sqrt_d():
    q, k, v, pattern, kw = case("default_scale")
    d = q.shape[-1]
    kw = port_kw(kw)
    default = pt_bs.block_sparse_attention(t(q), t(k), t(v), pattern, **kw)
    prescaled = pt_bs.block_sparse_attention(
        t(q) * d ** -0.5, t(k), t(v), pattern, **dict(kw, scale=1.0))
    torch.testing.assert_close(default, prescaled, atol=1e-6, rtol=0)


def test_bf16_matches_jax_kernel():
    q, k, v, pattern, kw = case("bias_repeat", seed=1)
    want = jax_out(q, k, v, pattern, kw, dtype=jnp.bfloat16)
    bf = [t(x).to(torch.bfloat16) for x in (q, k, v)]
    out = pt_bs.block_sparse_attention(*bf, pattern, **port_kw(kw))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), want, atol=2e-2, rtol=0)


@pytest.mark.parametrize("window,num_global,nqb", [
    (1, 1, 16), (0, 0, 5), (2, 2, 8), (0, 1, 3)])
def test_host_plans_and_labels_match_jax(window, num_global, nqb):
    pattern = pt_bs.banded_block_pattern(nqb, window, num_global)
    np.testing.assert_array_equal(
        pattern, jax_bs.banded_block_pattern(nqb, window, num_global))
    for a, b in zip(pt_bs.plan_block_pattern(pattern),
                    jax_bs.plan_block_pattern(pattern)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    plan = pt_bs.BlockPlan.build(pattern, 32, "cpu")
    assert plan.cols.dtype == plan.counts.dtype == torch.int32
    assert plan.counts.tolist() == pattern.sum(1).tolist()
    for block in (16, 32):
        port = pt_bs.KernelSpec.banded(nqb * block, block, window,
                                       num_global)
        jax_spec = jax_bs.KernelSpec.banded(nqb * block, block, window,
                                            num_global)
        assert port.label == jax_spec.label
        assert port.live_fraction == jax_spec.live_fraction
        np.testing.assert_array_equal(port.token_mask(),
                                      jax_spec.token_mask())
        masked = pt_bs.KernelSpec.banded(nqb * block, block, window,
                                         num_global, backend="masked")
        assert masked.label == jax_bs.KernelSpec.banded(
            nqb * block, block, window, num_global,
            backend="masked").label


def test_contact_planning_matches_jax():
    rng = np.random.default_rng(3)
    dist = rng.normal(size=(2, 32, 32, 37)).astype(np.float32) * 3
    for lengths in (None, [32, 20], [0, 17]):
        want = jax_bs.contact_probs_from_distogram(dist, lengths=lengths)
        got = pt_bs.contact_probs_from_distogram(dist, lengths=lengths)
        np.testing.assert_array_equal(got, want)
    contacts = pt_bs.contact_probs_from_distogram(dist)
    for kw in (dict(threshold=0.3), dict(live_frac=0.2, window=0),
               dict(threshold=0.9, window=0, num_global=0)):
        pattern = pt_bs.contact_block_pattern(contacts, 8, **kw)
        np.testing.assert_array_equal(
            pattern, jax_bs.contact_block_pattern(contacts, 8, **kw))
        assert pt_bs.KernelSpec.from_pattern(
            pattern, 8, source="contact").label == \
            jax_bs.KernelSpec.from_pattern(pattern, 8,
                                           source="contact").label


def test_refusals():
    bad = np.zeros((4, 4), bool)
    bad[0, 0] = True                      # rows 1-3 have no live block
    with pytest.raises(ValueError):
        pt_bs.plan_block_pattern(bad)
    with pytest.raises(ValueError):
        pt_bs.KernelSpec.from_pattern(bad, 8)
    with pytest.raises(ValueError, match="interpret"):
        pt_bs.KernelSpec.banded(32, 8, backend="pallas")
    spec = pt_bs.KernelSpec.banded(32, 8)
    other = pt_bs.KernelSpec.banded(32, 8, window=0)
    with pytest.raises(ValueError, match="plan"):
        with pt_bs.kernel_context(spec, other.device_plan("cpu")):
            pass


@pytest.mark.parametrize("problem", [
    "fits", "head_width", "block", "length", "bias_shape", "k_mask_dtype",
    "plan_dtype", "dtype"])
def test_kernel_checks_refuse_misfits(problem):
    """The checks the wrapper runs before a launch on the card."""
    b, n, d, heads = 4, 64, 32, 2
    plan = pt_bs.BlockPlan.build(pt_bs.banded_block_pattern(4), 16, "cpu")
    q = torch.zeros(b, n, d)
    bias, k_mask = torch.zeros(2, n, n), torch.ones(2, n, dtype=torch.bool)
    if problem == "head_width":
        q = torch.zeros(b, n, 24)
    elif problem == "block":
        plan = pt_bs.BlockPlan.build(pt_bs.banded_block_pattern(8), 8, "cpu")
    elif problem == "length":
        q = torch.zeros(b, 48, d)
    elif problem == "bias_shape":
        bias = torch.zeros(3, n, n)
    elif problem == "k_mask_dtype":
        k_mask = k_mask.float()
    elif problem == "plan_dtype":
        plan = plan._replace(cols=plan.cols.long())
    elif problem == "dtype":
        q = q.half()
    check = lambda: pt_bs._check(q, q.clone(), q.clone(), plan, bias, 2,
                                 k_mask, heads)
    if problem == "fits":
        check()
        return
    with pytest.raises((ValueError, TypeError)):
        check()


def test_attention_seam_routes_by_spec(monkeypatch):
    """Attention under a spec: self-attention of the spec's length goes
    through block_sparse_attention with the unrepeated bias, the key
    mask, no query mask and scale 1.0; a column attention built with
    sparse_kernel_ok=False (the MSA column track) and a global-query
    attention never do, even when their attended length equals the
    spec's. A spec that comes without its device plan is refused, not
    planned per launch."""
    calls = []
    real = pt_bs.block_sparse_attention

    def spy(*args, **kwargs):
        calls.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(pt_prim, "block_sparse_attention", spy)
    torch.manual_seed(0)
    n, dim = 16, 16
    spec = pt_bs.KernelSpec.banded(n, 4, window=0, num_global=1)
    row = pt_prim.AxialAttention(dim, 2, 8, row_attn=True,
                                 accept_edges=True)
    col = pt_prim.AxialAttention(dim, 2, 8, row_attn=False, col_attn=True,
                                 sparse_kernel_ok=False)
    glob = pt_prim.AxialAttention(dim, 2, 8, row_attn=False, col_attn=True,
                                  global_query_attn=True)
    x = torch.randn(1, 3, n, dim)
    edges = torch.randn(1, n, n, dim)
    mask = torch.ones(1, 3, n, dtype=torch.bool)
    square = torch.randn(1, n, n, dim)
    with torch.no_grad():
        plain_col, plain_glob = col(square), glob(square)
        with pytest.raises(ValueError, match="device plan"):
            with pt_bs.kernel_context(spec):
                row(x, edges=edges, mask=mask)
        assert not calls
        with pt_bs.kernel_context(spec, spec.device_plan("cpu")):
            row(x, edges=edges, mask=mask)
            assert len(calls) == 1
            kw = calls[0]
            assert kw["scale"] == 1.0 and kw["bias_repeat"] == 3
            assert tuple(kw["bias"].shape) == (2, n, n)
            assert tuple(kw["k_mask"].shape) == (3, n)
            torch.testing.assert_close(col(square), plain_col, rtol=0,
                                       atol=0)
            # global-query attention never takes a spec either
            torch.testing.assert_close(glob(square), plain_glob, rtol=0,
                                       atol=0)
            row(torch.randn(1, 3, 8, dim))    # another length: dense
    assert len(calls) == 1


def live_pattern(plan):
    """The live set a plan's cols/counts describe, at its kernel block."""
    rows = plan.cols.shape[0]
    pattern = np.zeros((rows, rows), bool)
    for i, (cols, count) in enumerate(zip(plan.cols.numpy(),
                                          plan.counts.numpy())):
        pattern[i, cols[:count]] = True
    return pattern


@pytest.mark.parametrize("band_only", [False, True],
                         ids=["global", "band_only"])
@pytest.mark.parametrize("block,d", [(48, 16), (48, 40), (96, 64),
                                     (24, 16), (24, 40), (32, 40)])
def test_card_routes_are_exact_with_the_plain_standing_in(block, d,
                                                          band_only,
                                                          monkeypatch):
    """The card's routes for blocks and head widths without a K2
    instance, with the plain version standing in for K2: a block that is
    a multiple of 16 re-plans at a K2 block over the same live set; any
    other block runs K1 (here its plain version) with the pattern as a
    -1e9 bias; D is padded to the next instance. Every route equals the
    plain block-sparse version on the original plan. `band_only` drops
    the global block and masks every live key of the last q-block in
    one mask row, so that row averages over its live keys only."""
    rng = np.random.default_rng(block + d)
    heads, rep, n = 2, 2, 192
    b = heads * rep
    nb = n // block
    pattern = pt_bs.banded_block_pattern(nb, 1, 0 if band_only else 1)
    plan = pt_bs.BlockPlan.build(pattern, block, "cpu")
    assert plan.kernel_block == {48: 16, 96: 32, 24: 0, 32: 32}[block]
    q, k, v = (t(rng.normal(size=(b, n, d)).astype(np.float32))
               for _ in range(3))
    bias = t(rng.normal(size=(heads, n, n)).astype(np.float32))
    lengths = rng.integers(100, n, (b // heads, 1))
    if band_only:
        lengths[0] = (nb - 2) * block
    k_mask = t(np.arange(n)[None] < lengths)
    seen = []

    def k2_stand_in(q, k, v, plan, **kw):
        seen.append((q.shape[-1], plan.kernel_block))
        sub = pt_bs.BlockPlan.build(live_pattern(plan), plan.kernel_block,
                                    "cpu")
        return pt_bs.block_sparse_reference(q, k, v, sub, **kw)

    monkeypatch.setattr(pt_bs, "_launch", k2_stand_in)

    for with_bias in (True, False):
        kw = dict(bias=bias if with_bias else None,
                  bias_repeat=rep if with_bias else 1, k_mask=k_mask,
                  heads=heads, scale=0.25)
        ref = pt_bs.block_sparse_reference(q, k, v, plan, **kw)
        out = pt_bs.kernel_route(q, k, v, plan, **kw)
        assert out.shape == ref.shape
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
    if plan.kernel_block:
        assert seen == [(kernel_head_dim(d), plan.kernel_block)] * 2
        np.testing.assert_array_equal(
            pt_bs.token_mask(live_pattern(plan), plan.kernel_block),
            pt_bs.token_mask(pattern, block))
    else:
        assert not seen and plan.bias.shape == (n, n)
