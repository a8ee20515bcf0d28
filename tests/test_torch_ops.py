"""The port's fused attention (alphafold2_tpu_torch/ops/attention.py)
against the JAX package's kernel and reference.

On the CPU the port's wrapper takes its plain version; the JAX kernel
runs in Pallas interpret mode. Inputs come from numpy seeds; both sides
compute in fp32 (conftest pins JAX matmuls to float32, TF32 is off in
torch) and agree within atol 1e-5 at every query row: both implement
the -1e9 fill exactly, so masked rows are comparable too. The CUDA
kernel itself is held against the plain version by the `gpu` test,
in tests/test_torch_gpu.py, which runs only where a card is present.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.ops import attention as jax_attn
from alphafold2_tpu_torch.ops import attention as pt_attn
from test_torch_gpu import CASES, make_case
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)


ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _fp32_torch():
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = prev


def as_torch(x):
    return None if x is None else torch.from_numpy(np.array(x))


def as_jax(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("name", CASES)
def test_fused_attention_matches_jax(name):
    q, k, v, bias, qm, km, heads, rep = make_case(name)
    kw = dict(heads=heads, bias_repeat=rep)
    jargs = [as_jax(a) for a in (q, k, v, bias, qm, km)]
    targs = [as_torch(a) for a in (q, k, v, bias, qm, km)]
    jax_kernel = np.asarray(jax_attn.fused_attention(*jargs, **kw,
                                                     interpret=True))
    jax_ref = np.asarray(jax_attn.attention_reference(*jargs, **kw))
    port = pt_attn.fused_attention(*targs, **kw).numpy()
    port_ref = pt_attn.attention_reference(*targs, **kw).numpy()
    assert port.shape == jax_ref.shape
    for got in (port, port_ref):
        for want in (jax_kernel, jax_ref):
            err = float(np.abs(got - want).max())
            assert err <= ATOL, f"max abs err {err} > {ATOL}"
    assert np.isfinite(port).all()


def test_fully_masked_row_averages_all_keys():
    q, k, v, bias, qm, km, heads, rep = make_case("fully_masked_row")
    out = pt_attn.fused_attention(*map(as_torch, (q, k, v, bias, qm, km)),
                                  heads=heads, bias_repeat=rep).numpy()
    # fold row 1 has no valid query: each of its heads averages all keys
    for i in range(heads):
        np.testing.assert_allclose(out[1 * heads + i],
                                   np.broadcast_to(v[heads + i].mean(0),
                                                   out[0].shape),
                                   atol=ATOL)


def test_bf16_matches_jax_reference():
    q, k, v, bias, _, _, heads, rep = make_case("bias")
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    targs = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    ref = jax_attn.attention_reference(*jargs, jnp.asarray(bias),
                                       heads=heads, bias_repeat=rep)
    out = pt_attn.fused_attention(*targs, torch.from_numpy(bias),
                                  heads=heads, bias_repeat=rep)
    assert out.dtype == torch.bfloat16
    # bf16 products round at other places in the two frameworks
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=3e-2)


def _grad_case():
    q, k, v, bias, qm, km, heads, rep = make_case("bias_and_masks", seed=3)
    qm = np.ones(km.shape, bool)
    qm[:, -3:] = False
    return q, k, v, bias, qm, km, heads, rep


def _jax_grads(q, k, v, bias, qm, km, heads, rep):
    def f(q, k, v, bias):
        out = jax_attn.fused_attention(q, k, v, bias, q_mask=qm, k_mask=km,
                                       heads=heads, bias_repeat=rep,
                                       interpret=True)
        return jnp.sum(out * out)

    return jax.grad(f, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (q, k, v, bias)))


@pytest.mark.parametrize("path", ["plain", "autograd_function"])
def test_grads_match_jax_vjp(path, monkeypatch):
    """Gradients of sum(out^2) w.r.t. q, k, v and the unrepeated bias
    (summed over the fold) agree with JAX's custom_vjp. The
    `autograd_function` case runs the port's torch.autograd.Function
    with its launch replaced by the plain forward, so its recompute
    backward is checked here on the CPU."""
    q, k, v, bias, qm, km, heads, rep = _grad_case()
    want = _jax_grads(q, k, v, bias, qm, km, heads, rep)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    masks = [torch.from_numpy(qm), torch.from_numpy(km)]
    if path == "plain":
        out = pt_attn.fused_attention(*leaves, *masks, heads=heads,
                                      bias_repeat=rep)
    else:
        monkeypatch.setattr(
            pt_attn, "_launch",
            lambda q, k, v, b, qm, km, h, r: pt_attn.attention_reference(
                q, k, v, b, qm, km, heads=h, bias_repeat=r))
        out = pt_attn._FusedAttention.apply(*leaves, *masks, heads, rep)
    (out * out).sum().backward()
    for leaf, ref in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-5)


def _rejected(**overrides):
    q = torch.zeros(4, 8, 16)
    args = dict(q=q, k=q, v=q, bias=None, q_mask=None, k_mask=None,
                heads=2, bias_repeat=1)
    args.update(overrides)
    with pytest.raises((TypeError, ValueError)):
        pt_attn._check(**args)


def test_kernel_wrapper_rejects_what_it_cannot_take():
    pt_attn._check(torch.zeros(4, 8, 16), torch.zeros(4, 8, 16),
                   torch.zeros(4, 8, 16), None, None, None, 2, 1)
    _rejected(q=torch.zeros(4, 8, 48), k=torch.zeros(4, 8, 48),
              v=torch.zeros(4, 8, 48))                     # head width
    _rejected(q=torch.zeros(4, 8, 16, dtype=torch.float16))
    _rejected(k=torch.zeros(4, 16, 8).transpose(1, 2))     # not contiguous
    _rejected(q_mask=torch.ones(2, 8))                     # not bool
    _rejected(k_mask=torch.ones(4, 8, dtype=torch.bool))   # B, not B/heads
    _rejected(bias=torch.zeros(2, 8, 8, dtype=torch.bfloat16))
    _rejected(bias=torch.zeros(2, 8, 8), bias_repeat=3)    # 2*3 != 4
    _rejected(heads=3)


def test_other_devices_never_reach_the_plain_version():
    q = torch.zeros(2, 8, 16, device="meta")
    with pytest.raises(ValueError):
        pt_attn.fused_attention(q, q, q)


def test_build_hash_covers_the_headers(tmp_path, monkeypatch):
    """A kernel's library name hashes its source, every `*.cuh` beside it
    and the flags: editing only the shared tile header gives a new path,
    so no stale library is loaded (no nvcc needed)."""
    from alphafold2_tpu_torch.ops import build
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "kernel.cu").write_text('#include "tile.cuh"\n')
    header = csrc / "tile.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(build, "PACKAGE_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "SOURCES", {"kernel": "csrc/kernel.cu"})
    first = build.library_path("kernel")
    assert first.parent == tmp_path / "_build"
    assert build.library_path("kernel") == first      # stable
    header.write_text("// v2\n")
    second = build.library_path("kernel")
    assert second != first
    (csrc / "other.cuh").write_text("// a new header\n")
    assert build.library_path("kernel") not in (first, second)
    header.write_text("// v1\n")
    (csrc / "other.cuh").unlink()
    assert build.library_path("kernel") == first


@pytest.mark.parametrize("d", [8, 48, 96])
def test_head_width_pad_is_exact_with_the_plain_standing_in(d):
    """The card's route for a head width without a kernel instance:
    q/k/v zero-padded to the next instance, launched, sliced back. With
    the plain version standing in for the kernel, the output and the
    gradients equal the unpadded plain version's exactly."""
    rng = np.random.default_rng(40 + d)
    b, heads, n = 4, 2, 12
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n, d))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    bias = torch.from_numpy(rng.normal(size=(b, n, n)).astype(np.float32))
    qm = torch.from_numpy(rng.random((b // heads, n)) > 0.2)
    km = torch.from_numpy(rng.random((b // heads, n)) > 0.2)
    widths = []

    def stand_in(q, k, v, *args, **kw):
        widths.append(q.shape[-1])
        return pt_attn.attention_reference(q, k, v, *args, **kw)

    out = pt_attn.pad_head_dim(stand_in, q, k, v, bias, qm, km, heads=heads)
    ref = pt_attn.attention_reference(q, k, v, bias, qm, km, heads=heads)
    assert widths == [pt_attn.kernel_head_dim(d)] and widths[0] > d
    assert out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    ref_grads = torch.autograd.grad(ref.sum(), (q, k, v))
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)


@pytest.mark.parametrize("d", [160, 192, 256, 384])
def test_head_width_above_128_takes_the_sliced_route(d, monkeypatch):
    """D > 128 launches on the kernels' sliced path, at the next multiple
    of 128. With the plain versions standing in for the launches, K1's
    route (q/k/v zero-padded, launched, sliced back) equals
    `attention_reference`, gradients included, and K2's route equals
    K2's plain version on the unpadded inputs; each launch sees the
    padded width, which the kernels take as it is."""
    from alphafold2_tpu_torch.ops import block_sparse as pt_bs
    assert [pt_attn.kernel_head_dim(w) for w in (1, 16, 17, 64, 65, 128)] \
        == [16, 16, 32, 64, 128, 128]
    width = pt_attn.kernel_head_dim(d)
    assert width == -(-d // 128) * 128 and width >= d
    pt_attn.check_head_dim(width)            # the kernels take it as it is
    if d % 128:
        with pytest.raises(ValueError, match=f"head width {d}"):
            pt_attn.check_head_dim(d)
    rng = np.random.default_rng(d)
    b, heads, rep, n = 4, 2, 2, 32
    q, k, v = (torch.from_numpy(rng.normal(size=(b, n, d))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    bias = torch.from_numpy(rng.normal(size=(heads, n, n)).astype(np.float32))
    qm = torch.from_numpy(rng.random((b // heads, n)) > 0.2)
    km = torch.from_numpy(rng.random((b // heads, n)) > 0.2)
    widths = []

    def k1_stand_in(q, k, v, *args, **kw):
        widths.append(q.shape[-1])
        return pt_attn.attention_reference(q, k, v, *args, **kw)

    kw = dict(heads=heads, bias_repeat=rep)
    out = pt_attn.pad_head_dim(k1_stand_in, q, k, v, bias, qm, km, **kw)
    ref = pt_attn.attention_reference(q, k, v, bias, qm, km, **kw)
    assert widths == [width] and out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    grads = torch.autograd.grad(out.sum(), (q, k, v))
    ref_grads = torch.autograd.grad(ref.sum(), (q, k, v))
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-6)

    def k2_stand_in(q, k, v, plan, **kw):
        widths.append(q.shape[-1])
        return pt_bs.block_sparse_reference(q, k, v, plan, **kw)

    monkeypatch.setattr(pt_bs, "_launch", k2_stand_in)
    plan = pt_bs.BlockPlan.build(pt_bs.banded_block_pattern(n // 16, 0, 1),
                                 16, "cpu")
    q, k, v = (x.detach() for x in (q, k, v))
    kw = dict(bias=bias, bias_repeat=rep, k_mask=km, heads=heads,
              scale=None)
    out = pt_bs.kernel_route(q, k, v, plan, **kw)
    ref = pt_bs.block_sparse_reference(q, k, v, plan, **kw)
    assert widths == [width, width] and out.shape == ref.shape
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-6)
