"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked `gpu`: each test skips where no CUDA device is present.

This file imports nothing of JAX, so it runs on a machine that has only
PyTorch: python -m pytest -m gpu tests/test_torch_gpu.py
It also holds the attention cases that tests/test_torch_ops.py holds
against the JAX package on the CPU.
"""

import itertools
import json

import numpy as np
import pytest
import torch

from alphafold2_tpu_torch.ops import attention as pt_attn


def make_case(name, seed=0):
    """(q, k, v, bias, q_mask, k_mask, heads, bias_repeat) as numpy."""
    rng = np.random.default_rng(seed)
    batch, rep, heads, nq, nk, d = 2, 1, 2, 64, 64, 32
    bias_on = qm_on = km_on = False
    if name == "plain":
        pass
    elif name == "bias":
        bias_on = True
    elif name == "unrepeated_bias":
        rep, nq, nk, d, bias_on = 4, 32, 32, 16, True
    elif name == "masks":
        qm_on = km_on = True
    elif name == "fully_masked_row":
        rep, bias_on, qm_on, km_on = 2, True, True, True
    elif name == "n5":
        # the MSA column attention's shape: N = msa depth < 8
        rep, nq, nk, d, qm_on, km_on = 3, 5, 5, 16, True, True
    elif name == "cross_lengths":
        nk, bias_on = 32, True
    elif name == "bias_and_masks":
        rep, nq, nk, d, bias_on, km_on = 2, 32, 32, 16, True, True
    b_all = batch * rep * heads
    q = rng.normal(size=(b_all, nq, d)).astype(np.float32) * 0.5
    k = rng.normal(size=(b_all, nk, d)).astype(np.float32) * 0.5
    v = rng.normal(size=(b_all, nk, d)).astype(np.float32)
    bias = rng.normal(size=(batch * heads, nq, nk)).astype(np.float32) \
        if bias_on else None
    rows = batch * rep
    qm = (np.arange(nq)[None] < rng.integers(nq // 2, nq + 1, (rows, 1))) \
        if qm_on else None
    km = (np.arange(nk)[None] < rng.integers(nk // 2, nk + 1, (rows, 1))) \
        if km_on else None
    if name == "fully_masked_row":
        qm[1] = False
        km[2] = False
    return q, k, v, bias, qm, km, heads, rep


CASES = ["plain", "bias", "unrepeated_bias", "masks", "fully_masked_row",
         "n5", "cross_lengths", "bias_and_masks"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(cuda_device, dtype):
    """The kernel against the plain version on the same input values,
    computed in fp32 (the plain bf16 run rounds its logits to bf16):
    atol 1e-4 for fp32 (sums in another order), 2e-2 for bf16 (the
    output's rounding)."""
    dt = getattr(torch, dtype)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    for name in CASES:
        q, k, v, bias, qm, km, heads, rep = make_case(name)
        to = lambda a, d=dt: None if a is None else \
            torch.from_numpy(np.array(a)).to(cuda_device, d)
        args = [to(q), to(k), to(v), to(bias, torch.float32),
                to(qm, torch.bool), to(km, torch.bool)]
        before = pt_attn.launch_count.value
        out = pt_attn.fused_attention(*args, heads=heads, bias_repeat=rep)
        torch.cuda.synchronize()
        assert pt_attn.launch_count.value == before + 1
        ref = pt_attn.attention_reference(
            *(a.float() for a in args[:3]), *args[3:], heads=heads,
            bias_repeat=rep)
        err = float((out.float() - ref).abs().max())
        assert err <= atol, f"{name}: max abs err {err} > {atol}"


# Edge shapes of the tensor-core tile: (Nq, Nk, D, heads, bias_repeat,
# masks). Lengths off the 16/64 grid (5, 17, 131, 200), odd Nk under a
# bias, every head width, a bias replayed over bias_repeat > 1 with
# heads > 1; "full" masks one query row and one key row in full.
EDGE_SHAPES = [
    (5, 5, 64, 8, 3, "ragged"),
    (131, 131, 32, 2, 2, "full"),
    (200, 131, 16, 2, 1, "ragged"),
    (131, 200, 128, 1, 2, "full"),
    (17, 5, 64, 4, 2, "ragged"),
    (64, 7, 16, 2, 3, "full"),
]


def edge_case(shape, dtype, device, seed=0):
    """(q, k, v, bias, q_mask, k_mask, heads, bias_repeat) on `device`
    for one EDGE_SHAPES entry, one batch element."""
    nq, nk, d, heads, rep, masks = shape
    g = torch.Generator().manual_seed(seed)
    b = rep * heads
    q, k = (torch.randn(b, n, d, generator=g) * 0.5 for n in (nq, nk))
    v = torch.randn(b, nk, d, generator=g)
    bias = torch.randn(heads, nq, nk, generator=g)
    q_mask = torch.arange(nq)[None] < torch.randint(
        (nq + 1) // 2, nq + 1, (rep, 1), generator=g)
    k_mask = torch.arange(nk)[None] < torch.randint(
        (nk + 1) // 2, nk + 1, (rep, 1), generator=g)
    if masks == "full":
        q_mask[0] = False
        k_mask[-1] = False
    return (q.to(device, dtype), k.to(device, dtype), v.to(device, dtype),
            bias.to(device), q_mask.to(device), k_mask.to(device), heads,
            rep)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_edge_shapes(cuda_device, dtype):
    """K1 at the tile's edge shapes against the plain version in fp32 on
    the same values (atol 1e-4 fp32, 2e-2 bf16). bf16 runs every layout
    of the tensor-core kernel (0 = the shape rule, 1 and 2 forced), so the
    rule may pick any of them."""
    dt = getattr(torch, dtype)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    layouts = (0,) if dt == torch.float32 else (0, 1, 2)
    for shape in EDGE_SHAPES:
        q, k, v, bias, qm, km, heads, rep = edge_case(shape, dt,
                                                      cuda_device)
        ref = pt_attn.attention_reference(
            q.float(), k.float(), v.float(), bias, qm, km, heads=heads,
            bias_repeat=rep)
        for layout in layouts:
            out = pt_attn._launch(q, k, v, bias, qm, km, heads, rep,
                                  layout=layout)
            torch.cuda.synchronize()
            err = float((out.float() - ref).abs().max())
            assert torch.isfinite(out).all()
            assert err <= atol, f"{shape} layout {layout}: {err} > {atol}"


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_template_pointwise_shape(cuda_device, dtype):
    """K1 at the template pointwise attention's shape: one query over t=4
    keys for each of 524,288 batch*head rows (65,536 pair cells, heads
    8), with ragged key masks, cells whose keys are all masked (they
    average every key, as the plain version does) and masked queries;
    against the plain version in fp32 on the same values (atol 1e-4 fp32,
    2e-2 bf16)."""
    dt = getattr(torch, dtype)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(3)
    cells, heads, t, d = 65536, 8, 4, 64
    q = torch.randn(cells * heads, 1, d, generator=g) * 0.5
    k = torch.randn(cells * heads, t, d, generator=g) * 0.5
    v = torch.randn(cells * heads, t, d, generator=g)
    k_mask = torch.arange(t)[None] < torch.randint(0, t + 1, (cells, 1),
                                                   generator=g)
    q_mask = torch.rand(cells, 1, generator=g) < 0.9
    args = [x.to(cuda_device, dt) for x in (q, k, v)]
    qm, km = q_mask.to(cuda_device), k_mask.to(cuda_device)
    assert not bool(k_mask.any(-1).all())        # some cells have no key
    pt_attn.launch_count.reset()
    out = pt_attn.fused_attention(*args, q_mask=qm, k_mask=km, heads=heads)
    torch.cuda.synchronize()
    assert pt_attn.launch_count.value == 1
    ref = pt_attn.attention_reference(*(x.float() for x in args),
                                      q_mask=qm, k_mask=km, heads=heads)
    assert torch.isfinite(out).all()
    err = float((out.float() - ref).abs().max())
    assert err <= atol, err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_long_key_row(cuda_device, dtype):
    """K1 at N=1024, the extra-MSA column attention's length (1024 extra
    rows attend each other for every residue), with a ragged row mask and
    a fully masked row, on 8 residues x 8 heads: against the plain
    version in fp32 on the same values (atol 1e-4 fp32, 2e-2 bf16)."""
    dt = getattr(torch, dtype)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(4)
    cols, heads, n, d = 8, 8, 1024, 64
    q, k = (torch.randn(cols * heads, n, d, generator=g) * 0.5
            for _ in range(2))
    v = torch.randn(cols * heads, n, d, generator=g)
    mask = torch.arange(n)[None] < torch.randint(600, n + 1, (cols, 1),
                                                 generator=g)
    mask[5] = False
    args = [x.to(cuda_device, dt) for x in (q, k, v)]
    m = mask.to(cuda_device)
    out = pt_attn.fused_attention(*args, q_mask=m, k_mask=m, heads=heads)
    torch.cuda.synchronize()
    ref = pt_attn.attention_reference(*(x.float() for x in args), q_mask=m,
                                      k_mask=m, heads=heads)
    assert torch.isfinite(out).all()
    err = float((out.float() - ref).abs().max())
    assert err <= atol, err


@pytest.mark.gpu
def test_cuda_fold_matches_cpu_fold(cuda_device):
    """A small fp32 model folds on the card (through the kernel) as it
    does on the CPU (plain version), from the same weights: coordinates
    within atol 1e-3, and 4 kernel launches per layer and pass."""
    from alphafold2_tpu_torch import Alphafold2, fold

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(dim=32, depth=2, heads=2, dim_head=16, predict_coords=True,
              generator=torch.Generator().manual_seed(0))
    cpu_model = Alphafold2(**kw, device="cpu")
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for p in cpu_model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    gpu_model = Alphafold2(**kw)          # the default device is the card
    gpu_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.default_rng(2)
    mask = np.arange(24)[None] < 20
    batch = dict(seq=rng.integers(0, 21, (1, 24)),
                 msa=rng.integers(0, 21, (1, 3, 24)), mask=mask,
                 msa_mask=np.broadcast_to(mask[:, None], (1, 3, 24)).copy())
    ref = fold(cpu_model, **batch, num_recycles=1, device="cpu")
    pt_attn.launch_count.reset()
    out = fold(gpu_model, **batch, num_recycles=1)
    torch.cuda.synchronize()
    assert pt_attn.launch_count.value == 4 * 2 * 2
    err = float((out.coords.cpu() - ref.coords)[:, :20].abs().max())
    assert err <= 1e-3, err


def block_sparse_case(name, dtype, device, seed=0):
    """Inputs of one K2 call: (q, k, v, plan, kwargs). Key masks with a
    padded tail and one key row masked in full (its queries average over
    their live keys)."""
    from alphafold2_tpu_torch.ops import block_sparse as pt_bs
    b_rows, rep, heads, n, d, block, window = {
        "small": (2, 3, 2, 64, 16, 16, 1),
        "d32_b64": (2, 2, 2, 256, 32, 64, 0),
        "d128_b128": (1, 2, 2, 256, 128, 128, 0),
        "d64_b128": (1, 3, 4, 512, 64, 128, 1),
        # the 512 bucket's MSA row attention under the default policy
        "msa_row_512": (1, 5, 8, 512, 64, 32, 1),
    }[name]
    g = torch.Generator().manual_seed(seed)
    b = b_rows * rep * heads
    q, k = (torch.randn(b, n, d, generator=g) * 0.5 for _ in range(2))
    v = torch.randn(b, n, d, generator=g)
    bias = torch.randn(b_rows * heads, n, n, generator=g)
    k_mask = torch.arange(n)[None] < torch.randint(
        n // 2, n + 1, (b // heads, 1), generator=g)
    k_mask[-1] = False
    plan = pt_bs.BlockPlan.build(
        pt_bs.banded_block_pattern(n // block, window, 1), block, device)
    to = lambda t: t.to(device, dtype)
    return (to(q), to(k), to(v), plan,
            dict(bias=bias.to(device), bias_repeat=rep,
                 k_mask=k_mask.to(device), heads=heads, scale=1.0))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_kernel_matches_plain(cuda_device, dtype):
    """K2 against its plain version at every row (the two share the
    contract, masked keys included), on the same input values computed
    in fp32: atol 1e-4 for fp32, 2e-2 for bf16 (the output's rounding).
    One call takes the default scale."""
    from alphafold2_tpu_torch.ops import block_sparse as pt_bs
    dt = getattr(torch, dtype)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    for name in ("small", "d32_b64", "d128_b128", "d64_b128",
                 "msa_row_512"):
        for scale in ((1.0, None) if name == "small" else (1.0,)):
            q, k, v, plan, kw = block_sparse_case(name, dt, cuda_device)
            kw["scale"] = scale
            before = pt_bs.launch_count.value
            out = pt_bs.block_sparse_attention(q, k, v, plan, **kw)
            torch.cuda.synchronize()
            assert pt_bs.launch_count.value == before + 1
            assert out.dtype == dt
            ref = pt_bs.block_sparse_reference(q.float(), k.float(),
                                               v.float(), plan, **kw)
            err = float((out.float() - ref).abs().max())
            assert err <= atol, f"{name}: max abs err {err} > {atol}"


# K2's edge cases: (block, D, scale), every block and head width, and
# scales other than the model's 1.0
BLOCK_EDGES = [(16, 16, 1.0), (32, 128, 0.37), (64, 32, 1.0),
               (128, 64, 0.125), (128, 128, 1.0), (32, 64, 2.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_kernel_edge_cases(cuda_device, dtype):
    """K2 at every block size and head width, a replayed bias over
    bias_repeat > 1 with heads > 1, and a query block whose live keys are
    all masked (it averages over its live keys, as the plain version
    does), against the plain version in fp32 on the same values."""
    from alphafold2_tpu_torch.ops import block_sparse as pt_bs
    dt = getattr(torch, dtype)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    heads, rep = 2, 3
    for block, d, scale in BLOCK_EDGES:
        n = 4 * block
        g = torch.Generator().manual_seed(block + d)
        b = heads * rep
        q, k = (torch.randn(b, n, d, generator=g) * 0.5 for _ in range(2))
        v = torch.randn(b, n, d, generator=g)
        bias = torch.randn(heads, n, n, generator=g)
        k_mask = torch.arange(n)[None] < torch.randint(
            n // 2, n + 1, (rep, 1), generator=g)
        # window 0, one global block: query block 1 sees key blocks 0, 1
        k_mask[1, :2 * block] = False
        plan = pt_bs.BlockPlan.build(
            pt_bs.banded_block_pattern(4, 0, 1), block, cuda_device)
        kw = dict(bias=bias.to(cuda_device), bias_repeat=rep,
                  k_mask=k_mask.to(cuda_device), heads=heads, scale=scale)
        args = [t.to(cuda_device, dt) for t in (q, k, v)]
        out = pt_bs.block_sparse_attention(*args, plan, **kw)
        torch.cuda.synchronize()
        ref = pt_bs.block_sparse_reference(*(t.float() for t in args),
                                           plan, **kw)
        err = float((out.float() - ref).abs().max())
        assert torch.isfinite(out).all()
        assert err <= atol, f"block {block} D {d}: {err} > {atol}"


@pytest.mark.gpu
def test_block_sparse_kernel_refuses_misfits(cuda_device):
    """On the card there is no fallback: a shape or type the kernels do
    not take raises before any launch (the wrapper pads every head width
    to one the kernel takes, so the misfit width goes straight to the
    launch: 144, neither an instance nor a multiple of 128)."""
    from alphafold2_tpu_torch.ops import block_sparse as pt_bs
    q, k, v, plan, kw = block_sparse_case("small", torch.float32,
                                          cuda_device)
    before = pt_bs.launch_count.value
    with pytest.raises(ValueError, match="head width 144"):
        pt_bs._launch(q.repeat(1, 1, 9), k.repeat(1, 1, 9),
                      v.repeat(1, 1, 9), plan, **kw)
    with pytest.raises(TypeError):
        pt_bs.block_sparse_attention(q.half(), k.half(), v.half(), plan,
                                     **kw)
    with pytest.raises(ValueError, match="plan covers"):
        pt_bs.block_sparse_attention(q[:, :32].contiguous(),
                                     k[:, :32].contiguous(),
                                     v[:, :32].contiguous(), plan,
                                     **dict(kw, bias=None, k_mask=None))
    assert pt_bs.launch_count.value == before


@pytest.mark.gpu
def test_executor_folds_512_bucket_through_k2(cuda_device):
    """The default ModelConfig under the default kernel policy: a
    437-residue request in the 512 bucket launches K2 in every residue
    self-attention (3 per layer and pass: 72 with 3 recycles) and K1 only
    in the MSA column attention (24)."""
    from alphafold2_tpu_torch import ModelConfig
    from alphafold2_tpu_torch.data.synthetic import synthetic_requests
    from alphafold2_tpu_torch.ops import block_sparse as pt_bs
    from alphafold2_tpu_torch.serve.bucketing import (BucketPolicy,
                                                      default_policy)
    from alphafold2_tpu_torch.serve.executor import FoldExecutor
    from alphafold2_tpu_torch.serve.kernelpolicy import KernelPolicy

    cfg = ModelConfig(predict_coords=True)
    model = cfg.build(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for p in model.parameters():
            p.add_((torch.randn(p.shape, generator=g) * 0.05).to(p.device))
    edges = default_policy().edges
    policy = KernelPolicy.from_model_config(cfg, edges)
    spec = policy.spec_for(512)
    assert spec is not None and policy.spec_for(256) is None
    (req,) = synthetic_requests(np.random.default_rng(2), num=1,
                                lengths=(437,), msa_depth=5)
    batch, _ = BucketPolicy(edges).assemble([req], 512, 1, msa_depth=5)
    ex = FoldExecutor(model)
    pt_attn.launch_count.reset()
    pt_bs.launch_count.reset()
    out = ex.run(batch, 3, kernel=spec)
    assert (pt_bs.launch_count.value, pt_attn.launch_count.value) == \
        (72, 24)
    assert tuple(out.coords.shape) == (1, 512, 3)
    assert torch.isfinite(out.coords).all()
    conf = out.confidence
    assert ((conf >= 0) & (conf <= 1)).all()
    assert ex.stats()["keys"][0][7] == spec.label
    # a warm-up batch: zeros, every position masked
    zero = {k: torch.zeros_like(v) for k, v in batch.items()}
    state = ex.run_init(zero, kernel=spec)
    assert torch.isfinite(state.coords).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_autograd_matches_plain(cuda_device, dtype):
    """K1 under autograd: the kernel forward (one launch), the backward's
    plain recompute (no launch), against the plain version's autograd in
    fp32 on the same values. Error over the largest reference gradient:
    1e-4 fp32, 2e-2 bf16 (the bf16 recompute rounds its logits)."""
    dt = getattr(torch, dtype)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    for name in CASES:
        q, k, v, bias, qm, km, heads, rep = make_case(name, seed=3)
        to = lambda a, d: None if a is None else \
            torch.from_numpy(np.array(a)).to(cuda_device, d)
        masks = dict(q_mask=to(qm, torch.bool), k_mask=to(km, torch.bool),
                     heads=heads, bias_repeat=rep)
        cot = torch.randn(q.shape, generator=torch.Generator().manual_seed(
            4)).to(cuda_device)
        grads = []
        for fn, d in ((pt_attn.fused_attention, dt),
                      (pt_attn.attention_reference, torch.float32)):
            leaves = [to(a, dt).to(d).requires_grad_() for a in (q, k, v)]
            b = None if bias is None else \
                to(bias, torch.float32).requires_grad_()
            before = pt_attn.launch_count.value
            out = fn(*leaves, bias=b, **masks)
            inputs = leaves + ([] if b is None else [b])
            grads.append(torch.autograd.grad((out.float() * cot).sum(),
                                             inputs))
            if fn is pt_attn.fused_attention:
                torch.cuda.synchronize()
                assert pt_attn.launch_count.value == before + 1
        for got, ref in zip(*grads):
            err = float((got.float() - ref).abs().max() / ref.abs().max())
            assert err <= tol, f"{name}: {err} > {tol}"


@pytest.mark.gpu
def test_cuda_train_step_matches_cpu_step(cuda_device):
    """One fp32 train step (distogram + MLM, remat trunk) on the card
    against the same step on the CPU, from the same weights and the same
    MLM noise (one seeded CPU generator on both): loss within 1e-4,
    gradients within 1e-3, and the card's K1 ran forward and recompute."""
    from alphafold2_tpu_torch import Alphafold2
    from alphafold2_tpu_torch.data.synthetic import synthetic_batch
    from alphafold2_tpu_torch.train import TrainState, adam, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = synthetic_batch(np.random.default_rng(0), seq_len=24,
                            msa_depth=3, pad_fraction=0.25)
    out = []
    for device in ("cpu", cuda_device):
        model = Alphafold2(dim=32, depth=2, heads=2, dim_head=16,
                           device=device,
                           generator=torch.Generator().manual_seed(0))
        with torch.no_grad():
            g = torch.Generator().manual_seed(1)
            for p in model.parameters():
                p.add_((torch.randn(p.shape, generator=g) * 0.05).to(
                    p.device))
        state = TrainState.create(model, adam(1e-3),
                                  generator=torch.Generator().manual_seed(2))
        seen = []
        apply, params = state.apply_gradients, state.params
        # a None gradient (a parameter the loss does not reach) is zero
        state.apply_gradients = lambda gr: (
            seen.extend((torch.zeros_like(p) if x is None else x).detach()
                        .cpu() for p, x in zip(params, gr)), apply(gr))[1]
        before = pt_attn.launch_count.value
        state, metrics = make_train_step(model)(
            state, {k: v.to(device) for k, v in batch.items()})
        out.append((float(metrics["loss"]), seen,
                    pt_attn.launch_count.value - before))
    (loss_cpu, g_cpu, _), (loss_gpu, g_gpu, launches) = out
    assert abs(loss_gpu - loss_cpu) <= 1e-4
    assert max(float((a - b).abs().max()) for a, b in zip(g_cpu, g_gpu)) \
        <= 1e-3
    assert launches == 16     # 4 attentions x 2 layers, forward + remat


@pytest.mark.gpu
def test_adam_leaves_unreached_parameters_bit_equal(cuda_device):
    """On the card (the foreach kernels over other lists): the chain fed
    None for never-reached parameters is bit-equal to the chain fed
    explicit zeros, with clipping, over 8 steps."""
    from alphafold2_tpu_torch.train.state import adam

    g = torch.Generator().manual_seed(5)
    shapes = [(64, 32), (300,), (7, 7), (1000,), (3,)]
    init = [torch.randn(s, generator=g).to(cuda_device) for s in shapes]
    zeros = adam(1e-2, max_grad_norm=1.0)([p.clone() for p in init])
    skips = adam(1e-2, max_grad_norm=1.0)([p.clone() for p in init])
    for i in range(8):
        grads = [torch.randn(s, generator=g).to(cuda_device) for s in shapes]
        unreached = {1, 3} if i < 3 else {3}
        zeros.update([torch.zeros_like(x) if at in unreached else x
                      for at, x in enumerate(grads)])
        skips.update([None if at in unreached else x
                      for at, x in enumerate(grads)])
        for a, b in zip(zeros.params + zeros.tensors(),
                        skips.params + skips.tensors()):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_at_routed_widths_and_blocks(cuda_device, dtype):
    """The widths and blocks without a kernel instance, on the card: K1
    at D = 8, 48, 96 (zero-padded to 16, 64, 128), K2 at block 48
    (re-planned at 16) and block 24 (K1 with the pattern as a bias),
    with and without a q-block whose live keys are all masked, each
    against its plain version at 1e-4 fp32, 2e-2 bf16, each launch
    counted on the kernel that ran."""
    from alphafold2_tpu_torch.ops import block_sparse as pt_bs
    dt = getattr(torch, dtype)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(5)
    heads, n = 2, 96
    for d in (8, 48, 96):
        q, k, v = (torch.randn(4, n, d, generator=g) * 0.5 for _ in range(3))
        km = torch.rand(2, n, generator=g) > 0.2
        args = [x.to(cuda_device, dt) for x in (q, k, v)]
        before = pt_attn.launch_count.value
        out = pt_attn.fused_attention(*args, k_mask=km.to(cuda_device),
                                      heads=heads)
        torch.cuda.synchronize()
        assert pt_attn.launch_count.value == before + 1
        ref = pt_attn.attention_reference(*(x.float() for x in args),
                                          k_mask=km.to(cuda_device),
                                          heads=heads)
        assert out.shape == ref.shape
        assert float((out.float() - ref).abs().max()) <= atol, d
    n = 192
    for (block, d, counter), band_only in itertools.product(
            ((48, 40, pt_bs.launch_count), (24, 64, pt_attn.launch_count)),
            (False, True)):
        # band_only: no global block, and mask row 0 masks every live
        # key of the last q-block, which then averages over its live keys
        nb = n // block
        plan = pt_bs.BlockPlan.build(
            pt_bs.banded_block_pattern(nb, 1, 0 if band_only else 1),
            block, cuda_device)
        q, k, v = (torch.randn(4, n, d, generator=g) * 0.5 for _ in range(3))
        bias = torch.randn(heads, n, n, generator=g).to(cuda_device)
        lengths = torch.tensor([[(nb - 2) * block if band_only else 150],
                                [150]])
        km = (torch.arange(n)[None] < lengths).to(cuda_device)
        args = [x.to(cuda_device, dt) for x in (q, k, v)]
        kw = dict(bias=bias, bias_repeat=2, k_mask=km.contiguous(),
                  heads=heads, scale=None)
        before = counter.value
        with torch.no_grad():
            out = pt_bs.block_sparse_attention(*args, plan, **kw)
        torch.cuda.synchronize()
        assert counter.value == before + 1
        ref = pt_bs.block_sparse_reference(*(x.float() for x in args), plan,
                                           **kw)
        assert float((out.float() - ref).abs().max()) <= atol, (block,
                                                                band_only)


# K1 at the sliced path's widths (D > 128): the triangle shape of the
# 256 bucket (B = 256 rows x 8 heads, N = 256, the bias replayed over the
# rows) and a ragged N = 131 one; K2 at D = 256 at the 512 bucket's
# triangle shape under the default policy's pattern
SLICED_WIDTHS = (160, 256, 384)


def triangle_case(n, d, rows, dtype, device, seed):
    """(q, k, v, bias, q_mask, k_mask, heads, bias_repeat): triangle
    attention over an n x n pair map of `rows` rows, 8 heads, the last
    quarter of the residues padding."""
    heads, valid = 8, (3 * n) // 4
    g = torch.Generator(device=device).manual_seed(seed)
    b = rows * heads
    q, k = (torch.randn(b, n, d, generator=g, device=device) * 0.5
            for _ in range(2))
    v = torch.randn(b, n, d, generator=g, device=device)
    bias = torch.randn(heads, n, n, generator=g, device=device)
    real = torch.arange(n, device=device) < valid
    mask = (real[:rows, None] & real[None, :]).contiguous()
    return (q.to(dtype), k.to(dtype), v.to(dtype), bias, mask, mask, heads,
            rows)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_at_sliced_widths(cuda_device, dtype):
    """K1 at D = 160, 256, 384 (padded to 256, 256, 384) at the 256
    bucket's triangle shape and a ragged N = 131 one, and K2 at D = 256
    at the 512 bucket's triangle shape under the default policy's
    pattern: each one launch of its own kernel, against its plain version
    in fp32 on the same values (1e-4 fp32, 2e-2 bf16)."""
    from alphafold2_tpu_torch import ModelConfig
    from alphafold2_tpu_torch.ops import block_sparse as pt_bs
    from alphafold2_tpu_torch.serve.bucketing import default_policy
    from alphafold2_tpu_torch.serve.kernelpolicy import KernelPolicy
    dt = getattr(torch, dtype)
    atol = 1e-4 if dt == torch.float32 else 2e-2
    for d, (n, rows) in itertools.product(SLICED_WIDTHS,
                                          ((256, 256), (131, 16))):
        q, k, v, bias, qm, km, heads, rep = triangle_case(
            n, d, rows, dt, cuda_device, seed=d + n)
        before = pt_attn.launch_count.value
        out = pt_attn.fused_attention(q, k, v, bias, qm, km, heads=heads,
                                      bias_repeat=rep)
        torch.cuda.synchronize()
        assert pt_attn.launch_count.value == before + 1
        ref = pt_attn.attention_reference(q.float(), k.float(), v.float(),
                                          bias, qm, km, heads=heads,
                                          bias_repeat=rep)
        assert out.shape == ref.shape and torch.isfinite(out).all()
        err = float((out.float() - ref).abs().max())
        assert err <= atol, f"D={d} N={n}: {err} > {atol}"
        del q, k, v, out, ref
    spec = KernelPolicy.from_model_config(
        ModelConfig(), default_policy().edges).spec_for(512)
    q, k, v, bias, _, km, heads, rep = triangle_case(
        512, 256, 512, dt, cuda_device, seed=7)
    kw = dict(bias=bias, bias_repeat=rep, k_mask=km, heads=heads, scale=1.0)
    plan = spec.device_plan(cuda_device)
    before = pt_bs.launch_count.value
    with torch.no_grad():
        out = pt_bs.block_sparse_attention(q, k, v, plan, **kw)
    torch.cuda.synchronize()
    assert pt_bs.launch_count.value == before + 1
    ref = pt_bs.block_sparse_reference(q.float(), k.float(), v.float(),
                                       plan, **kw)
    err = float((out.float() - ref).abs().max())
    assert torch.isfinite(out).all() and err <= atol, err


@pytest.mark.gpu
def test_cuda_fold_and_write_miss_then_hit(cuda_device, tmp_path):
    """fold_and_write on the card through a disk FoldCache: the miss
    launches K1 (4 a layer and pass) and writes PDBs whose CA trace
    parses back to the fold's coordinates within 1e-3 A; the hit
    launches nothing and writes the same bytes, traced as a cache hit."""
    from alphafold2_tpu_torch import Alphafold2
    from alphafold2_tpu_torch.cache import FoldCache, fold_key
    from alphafold2_tpu_torch.data.native import parse_pdb
    from alphafold2_tpu_torch.obs import Tracer
    from alphafold2_tpu_torch.predict import fold_and_write

    model = Alphafold2(dim=32, depth=2, heads=2, dim_head=16,
                       predict_coords=True,
                       generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)
    mask = np.arange(24)[None] < np.array([[24], [17]])
    kw = dict(msa=rng.integers(0, 21, (2, 3, 24)), mask=mask,
              msa_mask=np.broadcast_to(mask[:, None], (2, 3, 24)).copy(),
              num_recycles=1)
    seq = rng.integers(0, 20, (2, 24))
    cache = FoldCache(disk_dir=str(tmp_path / "cache"))
    tracer = Tracer(jsonl_path=str(tmp_path / "t.jsonl"))
    runs = []
    for tag in ("miss", "hit"):
        pt_attn.launch_count.reset()
        paths = fold_and_write(model, seq, str(tmp_path / f"{tag}.pdb"),
                               cache=cache, tracer=tracer, **kw)
        torch.cuda.synchronize()
        runs.append((pt_attn.launch_count.value, paths))
    tracer.close()
    assert [r[0] for r in runs] == [4 * 2 * 2, 0]
    records = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    assert [r["source"] for r in records] == ["fold", "cache"]
    for k, (miss, hit) in enumerate(zip(runs[0][1], runs[1][1])):
        with open(miss, "rb") as a, open(hit, "rb") as b:
            assert a.read() == b.read()
        valid = mask[k]
        entry = cache.get(fold_key(seq[k][valid], kw["msa"][k][:, valid],
                                   num_recycles=1))
        _, coords, _ = parse_pdb(open(miss).read())
        assert np.abs(coords[:, 1] - entry.coords).max() <= 1e-3


@pytest.mark.gpu
def test_cuda_scheduler_matches_cpu_fold(cuda_device):
    """The port's Scheduler on the card (threaded submits, one batch of
    two in the 32 bucket, a cache hit after) against `predict.fold` on
    the CPU from the same weights: coords within 1e-3 at real residues,
    K1 launched 4 times a layer and pass for the one batch."""
    from alphafold2_tpu_torch import Alphafold2, fold, serve
    from alphafold2_tpu_torch.data.synthetic import synthetic_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(dim=32, depth=2, heads=2, dim_head=16, predict_coords=True,
              generator=torch.Generator().manual_seed(0))
    cpu_model = Alphafold2(**kw, device="cpu")
    gpu_model = Alphafold2(**kw)
    gpu_model.load_state_dict(cpu_model.state_dict())
    reqs = synthetic_requests(np.random.default_rng(6), num=2,
                              lengths=(24, 19), msa_depth=3)
    policy = serve.BucketPolicy((32,))
    sched = serve.Scheduler(
        serve.FoldExecutor(gpu_model), policy,
        serve.SchedulerConfig(max_batch_size=2, max_wait_ms=500.0,
                              msa_depth=3, num_recycles=1),
        cache=serve.FoldCache(registry=serve.MetricsRegistry()),
        model_tag="gpu-test", registry=serve.MetricsRegistry())
    pt_attn.launch_count.reset()
    with sched:
        resps = [t.result(timeout=300)
                 for t in [sched.submit(r) for r in reqs]]
        twin = serve.FoldRequest(seq=reqs[0].seq, msa=reqs[0].msa)
        hit = sched.submit(twin).result(timeout=300)
    torch.cuda.synchronize()
    assert pt_attn.launch_count.value == 4 * 2 * 2
    assert [r.status for r in resps + [hit]] == ["ok"] * 3
    assert hit.source == "cache"
    batch, _ = policy.assemble(reqs, 32, 2, msa_depth=3, device="cpu")
    ref = fold(cpu_model, **batch, num_recycles=1, device="cpu")
    for i, (r, resp) in enumerate(zip(reqs, resps)):
        err = float(np.abs(resp.coords - ref.coords[i, :r.length].numpy())
                    .max())
        assert err <= 1e-3, err


@pytest.mark.gpu
def test_cuda_in_process_fleet_launches_k1_on_both_replicas(cuda_device):
    """A two-replica InProcessFleet on the card (dim 32, depth 1, heads 2,
    dim_head 16, bucket 32): a request folded by each replica launches
    K1 4 times a layer and pass in that replica's fold, and a duplicate
    submitted to the replica that does not own its key is forwarded to
    the owner and resolves with source "forwarded"."""
    from alphafold2_tpu_torch import Alphafold2, fleet, serve
    from alphafold2_tpu_torch.data.synthetic import synthetic_requests

    model = Alphafold2(dim=32, depth=1, heads=2, dim_head=16,
                       predict_coords=True,
                       generator=torch.Generator().manual_seed(0))
    fl = fleet.InProcessFleet(
        lambda: serve.FoldExecutor(model), serve.BucketPolicy((32,)),
        serve.SchedulerConfig(max_batch_size=1, max_wait_ms=5.0,
                              msa_depth=3, num_recycles=1),
        n_replicas=2, model_tag="gpu-fleet",
        registry=serve.MetricsRegistry())
    reqs = synthetic_requests(np.random.default_rng(8), num=12,
                              lengths=(24,) * 12, msa_depth=3)
    with fl:
        router = fl.replicas[0].router
        sched = fl.replicas[0].scheduler
        owner = {}
        for r in reqs:
            owner.setdefault(router.owner_for(sched._cache_key_for(r)), r)
        assert set(owner) == {"r0", "r1"}
        for rid, r in sorted(owner.items()):
            replica = int(rid[1:])
            torch.cuda.synchronize()
            pt_attn.launch_count.reset()
            resp = fl.submit(r, replica=replica).result(timeout=300)
            torch.cuda.synchronize()
            assert resp.status == "ok" and resp.source == "fold"
            assert np.isfinite(resp.coords).all()
            assert pt_attn.launch_count.value == 4 * 1 * 2
        dup = owner["r1"]
        twin = serve.FoldRequest(seq=dup.seq.copy(), msa=dup.msa.copy())
        got = fl.submit(twin, replica=0).result(timeout=300)
    assert got.status == "ok" and got.source == "forwarded"
    np.testing.assert_array_equal(got.coords, fl.replicas[1].cache.get(
        sched._cache_key_for(dup)).coords)


@pytest.mark.gpu
def test_cuda_loadtest_blocksparse_launches_k2(cuda_device, tmp_path):
    """The port's load test at the tiny preset on the card with every
    bucket on the block-sparse policy (block 16): --smoke passes, K2
    launches in the served folds and in the numerics check, and the
    check agrees with the plain attention within 1e-3 (float32)."""
    import contextlib
    import io

    from alphafold2_tpu_torch.ops import block_sparse as pt_bs
    from alphafold2_tpu_torch.tools import serve_loadtest

    torch.cuda.synchronize()
    pt_bs.launch_count.reset()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_loadtest.main([
            "--requests", "12", "--lengths", "40,60,100", "--buckets",
            "64,128", "--kernel-policy", "blocksparse", "--sparse-block",
            "16", "--smoke", "--metrics-path", str(tmp_path / "m.jsonl")])
    torch.cuda.synchronize()
    report = json.loads(out.getvalue().splitlines()[-1])
    assert rc == 0, report["failures"]
    assert report["platform"] == "gpu"
    assert pt_bs.launch_count.value > len(report["kernel"][
        "numerics_max_diff"])
    assert max(report["kernel"]["numerics_max_diff"].values()) <= 1e-3
    assert {k.split(":")[0] for k in report["kernel"]["folds"]} \
        == {"blocksparse"}
