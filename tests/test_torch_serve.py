"""The port's serving layer (serve/, with predict's kernel= path) against
the JAX package's.

Host logic must match exactly: bucket assembly, kernel-policy routing and
its snapshot, and the executor's 8-tuple keys. Folds are compared at real
residues only (padded query rows are unspecified on every backend), within
atol 5e-4, the JAX package's own tolerance for its sparse backends: the
port's "auto" spec on the CPU (the plain version of K2) against JAX's
"pallas" backend (its kernel in interpret mode), and the port's "masked"
backend against JAX's. Small size: dim 32, depth 1, n 16, 3 MSA rows; the
JAX params are drawn with numpy onto the shapes of the JAX model's init.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import Alphafold2 as JaxAlphafold2
from alphafold2_tpu.config import ModelConfig as JaxModelConfig
from alphafold2_tpu.ops.block_sparse import KernelSpec as JaxKernelSpec
from alphafold2_tpu.serve import bucketing as jax_bucketing
from alphafold2_tpu.serve.executor import FoldExecutor as JaxFoldExecutor
from alphafold2_tpu.serve.kernelpolicy import KernelPolicy as JaxKernelPolicy
from alphafold2_tpu.serve.request import FoldRequest as JaxFoldRequest
from alphafold2_tpu_torch import predict as pt_predict
from alphafold2_tpu_torch.config import ModelConfig
from alphafold2_tpu_torch.data.synthetic import synthetic_requests
from alphafold2_tpu_torch.model.alphafold2 import Alphafold2
from alphafold2_tpu_torch.ops.block_sparse import KernelSpec
from alphafold2_tpu_torch.serve.bucketing import (BucketPolicy,
                                                  default_policy,
                                                  msa_depth_of)
from alphafold2_tpu_torch.serve.executor import FoldExecutor
from alphafold2_tpu_torch.serve.kernelpolicy import KernelPolicy
from alphafold2_tpu_torch.weights import load_jax_params


@pytest.fixture(autouse=True, scope="module")
def _torch_threads_per_worker():
    """Each pytest-xdist worker takes its share of the cores for torch's
    intra-op threads: the default (every core in every worker)
    oversubscribes the CPU, and the port's small CPU models then run an
    order of magnitude slower (a load-test case: ~2 s alone, 17-39 s
    beside busy workers). One process keeps the default."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    prev = torch.get_num_threads()
    torch.set_num_threads(max(1, prev // workers))
    yield
    torch.set_num_threads(prev)

N, ROWS, LENGTHS = 16, 3, (12, 9)
MODEL_KW = dict(dim=32, depth=1, heads=2, dim_head=16, predict_coords=True,
                structure_module_depth=1)
ALL_LIVE = dict(window=16, num_global=1)    # every block live
SPARSE = dict(window=0, num_global=0)       # diagonal only
FOLD_ATOL = 5e-4


def perturb_numpy(params, seed, scale=0.05):
    """`conftest.perturb_params` with the noise drawn by numpy: every
    leaf moves by scale * N(0, 1), without the eager JAX draw that
    compiles once per leaf shape (seconds for a model's tree)."""
    rng = np.random.default_rng(seed)

    def move(leaf):
        leaf = np.asarray(leaf)
        return leaf + (scale * rng.standard_normal(leaf.shape)).astype(
            leaf.dtype)
    return jax.tree.map(move, params)


def random_params(shapes, rng):
    """Parameters on the init's shapes: LayerNorm scales near 1, Dense
    kernels N(0, 1/fan_in), everything else small noise (so no output
    projection is zero and every attention path shows in the result)."""
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


@pytest.fixture(scope="module")
def models():
    jm = JaxAlphafold2(**MODEL_KW)
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, N), jnp.int32),
                            msa=jnp.zeros((1, ROWS, N), jnp.int32),
                            mask=jnp.ones((1, N), bool),
                            msa_mask=jnp.ones((1, ROWS, N), bool)),
        jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.default_rng(0))
    pm = Alphafold2(**MODEL_KW, device="cpu")
    load_jax_params(pm, params)
    return jm, params, pm


def requests(lengths=LENGTHS, seed=1):
    return synthetic_requests(np.random.default_rng(seed), num=len(lengths),
                              lengths=lengths, msa_depth=ROWS)


def both_batches(reqs, bucket=N, batch_size=2, msa_depth=ROWS):
    jax_reqs = [JaxFoldRequest(seq=r.seq, msa=r.msa) for r in reqs]
    jb, jw = jax_bucketing.BucketPolicy((bucket,)).assemble(
        jax_reqs, bucket, batch_size, msa_depth=msa_depth)
    pb, pw = BucketPolicy((bucket,)).assemble(
        reqs, bucket, batch_size, msa_depth=msa_depth, device="cpu")
    return jb, jw, pb, pw


@pytest.mark.parametrize("msa_depth", [None, 2, 5, 0])
def test_assemble_matches_jax(msa_depth):
    reqs = requests((12, 16, 5), seed=2)
    reqs[1].msa = None
    jb, jw, pb, pw = both_batches(reqs, batch_size=4, msa_depth=msa_depth)
    assert pw == jw
    assert set(pb) == set(jb)
    for key, jv in jb.items():
        if jv is None:
            assert pb[key] is None
            continue
        assert pb[key].device.type == "cpu"
        np.testing.assert_array_equal(pb[key].numpy(), np.asarray(jv))
    assert msa_depth_of(pb) == jax_bucketing.msa_depth_of(jb)
    assert default_policy().edges == jax_bucketing.default_policy().edges
    assert BucketPolicy.powers_of_two(16, 384).edges == \
        jax_bucketing.BucketPolicy.powers_of_two(16, 384).edges


def test_default_policy_routes_512_blocksparse_like_jax():
    """The default ModelConfig's knobs (block 32, window 1, one global
    block) over the default buckets: 32-256 dense, 512 block-sparse at a
    live fraction of 0.2891, with the JAX package's label."""
    edges = default_policy().edges
    port = KernelPolicy.from_model_config(ModelConfig(), edges)
    jax_pol = JaxKernelPolicy.from_model_config(JaxModelConfig(), edges)
    assert port.snapshot() == jax_pol.snapshot()
    snap = port.snapshot()["buckets"]
    assert [e for e in edges if snap[str(e)]["kernel"] == "blocksparse"] \
        == [512]
    assert snap["512"]["live_frac"] == 0.2891
    spec = port.spec_for(512)
    assert spec.pattern_array().sum() == 74 and spec.n == 512
    assert port.kernel_for(256) == "dense" and port.spec_for(256) is None
    for text in ("", "dense", "blocksparse", "auto", "64=dense,512=bs"):
        a = KernelPolicy.parse(text, (64, 512), block=64)
        b = JaxKernelPolicy.parse(text, (64, 512), block=64)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.snapshot() == b.snapshot()


def test_contact_spec_matches_jax():
    rng = np.random.default_rng(4)
    dist = rng.normal(size=(2, 64, 64, 37)).astype(np.float32)
    dist[..., -1] += 8.0                  # most pairs far apart
    i, j = rng.integers(0, 64, (2, 6))
    dist[0, i, j, 0] = 50.0               # a few certain contacts
    kw = dict(table={64: "blocksparse"}, block=8, window=0, num_global=1)
    for extra in (dict(contact_threshold=0.6),
                  dict(contact_live_frac=0.15)):
        port = KernelPolicy(**kw, **extra).contact_spec_for(
            64, dist, lengths=[64, 40])
        want = JaxKernelPolicy(**kw, **extra).contact_spec_for(
            64, dist, lengths=[64, 40])
        assert port.label == want.label and port.source == "contact"
        # the static mask is a floor the contacts only add to
        static = KernelSpec.banded(64, 8, window=0, num_global=1)
        assert (port.pattern_array() >= static.pattern_array()).all()
        assert static.live_fraction < port.live_fraction < 1.0
    assert KernelPolicy(**kw).contact_spec_for(32, dist[:, :32, :32]) \
        is None


def test_exec_keys_match_jax(models):
    jm, params, pm = models
    jb, _, pb, _ = both_batches(requests())
    jex, pex = JaxFoldExecutor(jm, params), FoldExecutor(pm)
    spec = KernelSpec.banded(N, 4, **SPARSE)
    jspec = JaxKernelSpec.banded(N, 4, **SPARSE)
    for tag in ("", "v2"):
        jex.model_tag = pex.model_tag = tag
        for variant in ("fold", "init", "step", "init_rows"):
            for kernels in ((None, None), (spec, jspec)):
                assert pex.key_for(pb, 3, variant=variant,
                                   kernel=kernels[0]) == \
                    jex.key_for(jb, 3, variant=variant, kernel=kernels[1])
        for key in ((16, 1, 3, 0), (16, 1, 3, 0, (1, 1)),
                    (16, 1, 3, 0, [1, 1], "t"),
                    (16, 1, 3, 0, (1, 1), "t", "step"),
                    (16, 1, 3, 0, (1, 1), "t", "step", spec.label)):
            assert pex._normalize_key(key) == jex._normalize_key(key)


def test_kernel_flip_misses_then_hits_and_warmup_counts(models):
    """A different spec is a different program (a miss, never a stale
    hit); flipping back hits the resident one; evicting frees it."""
    _, _, pm = models
    ex = FoldExecutor(pm, max_entries=3)
    _, _, batch, _ = both_batches(requests())
    a = KernelSpec.banded(N, 8, **ALL_LIVE)
    b = KernelSpec.banded(N, 8, **SPARSE)
    ex.run(batch, 0, kernel=a)
    ex.run(batch, 0, kernel=b)
    ex.run(batch, 0)
    assert ex.stats()["misses"] == 3
    ex.run(batch, 0, kernel=a)
    assert ex.stats()["hits"] == 1
    programs = list(ex._cache.values())
    assert [p.plan is not None for p in programs] == [True, False, True]
    assert ex.warmup([(N, 2, ROWS, 0)], kernel=b, step_mode=True,
                     continuous=True) == 3
    stats = ex.stats()
    assert stats["evictions"] == 3 and stats["resident"] == 3
    assert [k[6] for k in stats["keys"]] == ["init", "init_rows", "step"]
    assert all(k[7] == b.label for k in stats["keys"])
    assert ex.warmup([(N, 2, ROWS, 0), (8, 1, 0, 1)], kernel=b) == 2
    assert ex.stats()["keys"][-1][7] == "dense"   # 8 is not b's length
    fresh = ex.rebuild()
    assert fresh.model is pm and fresh.max_entries == 3
    assert (fresh.stats()["misses"], fresh.stats()["resident"]) == (0, 0)


def test_step_mode_equals_full_fold(models):
    _, _, pm = models
    ex = FoldExecutor(pm)
    _, _, batch, _ = both_batches(requests())
    spec = KernelSpec.banded(N, 4, window=0, num_global=1)
    full = ex.run(batch, 2, kernel=spec)
    state = ex.run_init(batch, kernel=spec)
    for i in range(2):
        state = ex.run_step(batch, state, i, kernel=spec)
    for a, b in ((full.coords, state.coords),
                 (full.confidence, state.confidence),
                 (full.distogram, state.distogram)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    rows = ex.run_init_rows(batch, state, [False, True], kernel=spec)
    torch.testing.assert_close(rows.coords[0], state.coords[0], rtol=0,
                               atol=0)
    assert not torch.equal(rows.coords[1], state.coords[1])


def test_warmup_batch_stays_finite(models):
    """Warm-up folds zero batches with every position masked: every
    query row attends only masked keys, and the fold stays finite."""
    _, _, pm = models
    ex = FoldExecutor(pm)
    _, _, batch, _ = both_batches(requests())
    zero = {k: torch.zeros_like(v) for k, v in batch.items()}
    for kernel in (KernelSpec.banded(N, 4, **SPARSE), None):
        state = ex.run_init(zero, kernel=kernel)
        assert torch.isfinite(state.coords).all()
        assert torch.isfinite(state.confidence).all()


def test_slices(models):
    """A one-device slice runs in process (its own key); a slice of two
    devices runs on a group of two rank processes (its own key, mesh
    1 x 2), bit-equal to the one-device fold; a mesh shape that does not
    cover the slice raises."""
    _, _, pm = models
    ex = FoldExecutor(pm)
    _, _, batch, _ = both_batches(requests())
    out = ex.run(batch, 0, devices=["cpu"])
    assert torch.equal(out.coords, ex.run(batch, 0).coords)
    assert ex.stats()["misses"] == 2
    try:
        two = ex.run(batch, 0, devices=["cpu", "cpu"])
        assert torch.equal(two.coords, out.coords)
        assert ex.stats()["misses"] == 3
        assert ex.stats()["keys"][-1][4] == (1, 2)
        with pytest.raises(ValueError, match="mesh"):
            ex.run_init(batch, devices=["cpu"], mesh_shape=(2, 1))
    finally:
        ex.close()
    assert not ex.groups()


def test_fold_refuses_what_is_not_a_spec(models):
    _, _, pm = models
    _, _, batch, _ = both_batches(requests())
    inputs = {k: batch[k] for k in ("seq", "msa", "mask", "msa_mask")}
    with pytest.raises(TypeError, match="KernelSpec"):
        pt_predict.fold(pm, **inputs, device="cpu", kernel=object())
    with pytest.raises(ValueError, match="the plan was not made"):
        pt_predict.fold(pm, **inputs, device="cpu",
                        kernel=KernelSpec.banded(N, 4),
                        plan=KernelSpec.banded(N, 8).device_plan("cpu"))


def real_diff(a, b, lengths=LENGTHS):
    return max(float(np.abs(np.asarray(a)[i, :n] - np.asarray(b)[i, :n])
                   .max()) for i, n in enumerate(lengths))


@pytest.mark.parametrize("case", ["sparse_b4", "all_live_b8", "masked_b4"])
def test_fold_with_spec_matches_jax(models, case):
    """A served fold under a spec: the port's plain K2 against the JAX
    kernel (interpret mode), and the masked backends against each other,
    at real residues. The sparse pattern really changes the result."""
    jm, params, pm = models
    jb, _, pb, _ = both_batches(requests())
    blk, pattern, port_backend, jax_backend, recycles = {
        "sparse_b4": (4, SPARSE, "auto", "pallas", 1),
        "all_live_b8": (8, ALL_LIVE, "auto", "pallas", 0),
        "masked_b4": (4, SPARSE, "masked", "masked", 1)}[case]
    spec = KernelSpec.banded(N, blk, backend=port_backend, **pattern)
    jspec = JaxKernelSpec.banded(N, blk, backend=jax_backend, **pattern)
    want = JaxFoldExecutor(jm, params).run(jb, recycles, kernel=jspec)
    ex = FoldExecutor(pm)
    got = ex.run(pb, recycles, kernel=spec)
    assert real_diff(got.coords, want.coords) <= FOLD_ATOL
    assert real_diff(got.confidence, want.confidence) <= FOLD_ATOL
    dense = ex.run(pb, recycles)
    if pattern is SPARSE:
        assert real_diff(got.coords, dense.coords) > 1e-3
    else:
        assert real_diff(got.coords, dense.coords) <= FOLD_ATOL
