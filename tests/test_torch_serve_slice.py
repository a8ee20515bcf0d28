"""The serving executor's multi-device slices (`serve/slices.py`: one
rank process per device, driven from the executor) against the JAX
executor's meshed path, on the CPU.

The port's slices are gloo groups of spawned ranks over a pool of CPU
devices (one intra-op thread a rank); the JAX side runs on conftest's
8 virtual devices. Both executors are built once for the module over
the same weights (the JAX params drawn with numpy onto the init's
shapes and bridged with `load_jax_params`), so each JAX program
compiles once and the port's slice groups start as few times as the
cases allow. Cases: `run` on (1, 2) and (2, 2) slices, the step-mode
variants on (1, 2), the Scheduler end to end with
MeshPolicy({16: 1, 32: 4}) (mesh stats and the shard / mesh-tagged fold
spans by structure), raise-mode poison isolated on a (1, 2) lease,
snapshot / rebuild() / restore of a sliced carry, a rank's exception,
a retag, and no rank process left once the executors closed.

Tolerance: JAX's own for a meshed fold (tests/test_serve_mesh.py):
coordinates and confidence within 1e-3 at valid positions. Within the
port a slice's results are compared byte for byte. Small size: dim 32,
depth 1, heads 2, dim_head 16, 3 MSA rows.
"""

import json
import multiprocessing
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import Alphafold2 as JaxAlphafold2
from alphafold2_tpu import serve as jax_serve
from alphafold2_tpu_torch import serve as pt_serve
from alphafold2_tpu_torch.model.alphafold2 import Alphafold2
from alphafold2_tpu_torch.serve import cuda_errors
from alphafold2_tpu_torch.serve.slices import RemoteTensor, SliceRankLost
from alphafold2_tpu_torch.weights import load_jax_params
from test_torch_serve import MODEL_KW, ROWS, random_params
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")

ATOL = 1e-3
CPU = torch.device("cpu")
SLICES = {(1, 2): 2, (2, 2): 4}


@pytest.fixture(scope="module")
def executors():
    """One executor per side over the same weights; the port's slice
    groups run one intra-op thread a rank (a rank takes this process's
    count). Closed at the module's end."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    n = 16
    jm = JaxAlphafold2(**MODEL_KW)
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, n), jnp.int32),
                            msa=jnp.zeros((1, ROWS, n), jnp.int32),
                            mask=jnp.ones((1, n), bool),
                            msa_mask=jnp.ones((1, ROWS, n), bool)),
        jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.default_rng(0))
    pm = Alphafold2(**MODEL_KW, device="cpu")
    load_jax_params(pm, params)
    out = {"jax": jax_serve.FoldExecutor(jm, params, max_entries=32),
           "port": pt_serve.FoldExecutor(pm, max_entries=32)}
    for shape in SLICES:
        # both groups' ranks start while the JAX programs compile
        out["port"].prestart(port_slice(shape), shape)
    yield out
    out["port"].close()
    torch.set_num_threads(threads)


def batches(n, b=2, seed=0, lengths=None):
    """The same batch for both sides: numpy draws, the tail of each row
    past its length masked."""
    rng = np.random.default_rng(seed)
    lengths = lengths or [n] * b
    mask = np.arange(n)[None] < np.asarray(lengths)[:, None]
    seq = rng.integers(0, 20, (b, n)).astype(np.int32)
    msa = rng.integers(0, 20, (b, ROWS, n)).astype(np.int32)
    msa_mask = np.broadcast_to(mask[:, None], msa.shape).copy()
    jb = {"seq": jnp.asarray(seq), "mask": jnp.asarray(mask),
          "msa": jnp.asarray(msa), "msa_mask": jnp.asarray(msa_mask)}
    pb = {"seq": torch.as_tensor(seq).long(), "mask": torch.as_tensor(mask),
          "msa": torch.as_tensor(msa).long(),
          "msa_mask": torch.as_tensor(msa_mask)}
    return jb, pb, mask


def close_at(got, ref, mask):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.abs(got - ref)[mask].max())
    assert err <= ATOL, f"max abs err {err} > {ATOL}"


def jax_slice(shape):
    return jax.devices()[:SLICES[shape]]


def port_slice(shape):
    return [CPU] * SLICES[shape]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_run_on_slice_matches_jax(executors, shape):
    """A fold on a slice of 2 and of 4 ranks against the JAX executor on
    the same mesh; the port's slice equals its one-device fold bit for
    bit; the distogram stays on the ranks until read."""
    jb, pb, mask = batches(32 if shape == (2, 2) else 16, seed=1,
                           lengths=[30, 21] if shape == (2, 2) else [16, 11])
    ref = executors["jax"].run(jb, 1, devices=jax_slice(shape),
                               mesh_shape=shape)
    ex = executors["port"]
    got = ex.run(dict(pb), 1, devices=port_slice(shape), mesh_shape=shape)
    close_at(got.coords, ref.coords, mask)
    close_at(got.confidence, ref.confidence, mask)
    assert isinstance(got.distogram, RemoteTensor)
    local = ex.run(dict(pb), 1)
    assert torch.equal(got.coords, local.coords)
    assert np.array_equal(np.asarray(got.distogram),
                          local.distogram.numpy())
    key = ex.key_for(pb, 1, mesh_shape=shape)
    assert key[4] == shape and key in ex.stats()["keys"]


def test_step_variants_on_slice_match_jax(executors):
    """run_init, two run_step and run_init_rows on (1, 2) against the
    JAX executor's; the step carry stays on the ranks behind handles
    and the batch's inputs travel once (one shard span)."""
    shape = (1, 2)
    jb, pb, mask = batches(16, seed=2, lengths=[16, 13])
    jex, ex = executors["jax"], executors["port"]
    jkw = dict(devices=jax_slice(shape), mesh_shape=shape)
    kw = dict(devices=port_slice(shape), mesh_shape=shape)
    spans = []

    class Trace:
        def span(self, name, **attrs):
            spans.append((name, attrs.get("mesh")))
            return torch.no_grad()   # any context manager

    jstate = jex.run_init(jb, **jkw)
    state = ex.run_init(pb, trace=Trace(), **kw)
    assert isinstance(state.recyclables.pairwise_repr, RemoteTensor)
    for r in range(2):
        jstate = jex.run_step(jb, jstate, r, **jkw)
        state = ex.run_step(pb, state, r, trace=Trace(), **kw)
        close_at(state.coords, jstate.coords, mask)
        close_at(state.confidence, jstate.confidence, mask)
    rows = np.array([False, True])
    jrows = jex.run_init_rows(jb, jstate, rows, **jkw)
    got = ex.run_init_rows(pb, state, rows, trace=Trace(), **kw)
    close_at(got.coords, jrows.coords, mask)
    close_at(got.confidence, jrows.confidence, mask)
    # row 0 kept its carried state, row 1 restarted
    assert torch.equal(got.coords[0], state.coords[0])
    names = [n for n, _ in spans]
    assert names.count("shard") == 1
    assert all(m == "1x2" for n, m in spans if n in ("fold", "recycle",
                                                      "admit"))


def test_rank_exception_reaches_the_executor(executors):
    """A rank's exception is raised here as the same exception type,
    with the rank's traceback as a note, and the group keeps serving;
    rank errors classify as they would in process."""
    shape = (1, 2)
    jb, pb, mask = batches(16, seed=3)
    ex = executors["port"]
    kw = dict(devices=port_slice(shape), mesh_shape=shape)
    state = ex.run_init(pb, **kw)
    bad = state.recyclables._replace(
        single_msa_repr_row=torch.zeros(2, 16, 7))
    with pytest.raises(RuntimeError) as caught:
        ex.run_step(pb, state._replace(recyclables=bad), 0, **kw)
    assert any("slice rank" in note for note in caught.value.__notes__)
    assert ex.run_step(pb, state, 0, **kw).coords.shape == (2, 16, 3)
    lost = cuda_errors.classify(repr(SliceRankLost(
        "slice rank 1 of 1x2[cuda:0,cuda:1] exited with code -9")))
    assert lost is not None and lost.transient
    oom = cuda_errors.classify(repr(torch.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB")))
    assert oom.transient and oom.reason == "cuda_oom"


def test_snapshot_rebuild_restore(executors):
    """A sliced carry survives snapshot_step_state, the executor's
    rebuild() (which kills its groups) and restore_step_state, and the
    loop continues byte-equal to the unbroken one; restored while the
    group lives, it goes back onto the ranks byte-equal."""
    from alphafold2_tpu_torch.predict import (restore_step_state,
                                              snapshot_step_state,
                                              tree_flatten)
    from alphafold2_tpu_torch.serve.slices import to_local
    shape = (1, 2)
    _, pb, _ = batches(16, seed=4, lengths=[16, 10])
    ex = executors["port"]
    kw = dict(devices=port_slice(shape), mesh_shape=shape)
    state = ex.run_step(pb, ex.run_init(pb, **kw), 0, **kw)
    snap = snapshot_step_state(state)
    back = restore_step_state(snap)
    for a, b in zip(tree_flatten(back)[0], tree_flatten(state)[0]):
        assert type(a) is type(b)
        assert np.array_equal(np.asarray(a), np.asarray(b))
    unbroken = to_local(ex.run_step(pb, state, 1, **kw))
    old = ex.groups()
    fresh = ex.rebuild()
    executors["port"] = fresh
    assert not any(g.alive for g in old)
    restored = restore_step_state(snap)
    assert isinstance(restored.recyclables.pairwise_repr, torch.Tensor)
    got = fresh.run_step(pb, restored, 1, **kw)
    assert torch.equal(got.coords, unbroken.coords)
    assert torch.equal(got.confidence, unbroken.confidence)
    assert np.array_equal(np.asarray(got.recyclables.pairwise_repr),
                          unbroken.recyclables.pairwise_repr.numpy())


def test_retag_closes_other_groups(executors):
    """Re-tagging the executor closes the groups of the old tag and
    keys every later slice run under the new one."""
    ex = executors["port"]
    old = ex.groups()
    assert old and all(g.model_tag == "" for g in old)
    ex.model_tag = "v2"
    assert not any(g.alive for g in old)
    assert not ex.groups()
    assert ex.stats()["placed_param_slices"] == 0
    _, pb, _ = batches(16, seed=6)
    assert ex.key_for(pb, 0, mesh_shape=(1, 2))[5] == "v2"
    ex.model_tag = ""


def _mesh_scheduler(side, executor, policy, tracer=None, **kw):
    s = jax_serve if side == "jax" else pt_serve
    registry = s.MetricsRegistry()
    return s.Scheduler(
        executor, s.BucketPolicy(kw.pop("edges", (16, 32))),
        s.SchedulerConfig(max_batch_size=2, max_wait_ms=10.0,
                          num_recycles=kw.pop("num_recycles", 0),
                          msa_depth=ROWS),
        metrics=s.ServeMetrics(registry=registry), model_tag="",
        tracer=tracer, registry=registry, mesh_policy=policy, **kw)


def _span_structure(path):
    """Per request: (status, span names in order, fold spans' mesh
    labels, shard spans' mesh labels)."""
    out = []
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            spans = rec.get("spans", ())
            out.append((rec["status"], tuple(s["name"] for s in spans),
                        tuple((s.get("attrs") or {}).get("mesh")
                              for s in spans if s["name"] == "fold"),
                        tuple((s.get("attrs") or {}).get("mesh")
                              for s in spans if s["name"] == "shard")))
    return sorted(out)


def test_scheduler_mesh_matches_jax(executors, tmp_path):
    """The Scheduler with MeshPolicy({16: 1, 32: 4}) over a pool of 4:
    short folds on one-device slices, long ones on the 2 x 2 slice's
    ranks; every response within 1e-3 of the JAX scheduler's,
    serve_stats()["mesh"] and the health payload equal to JAX's, and the
    traces' shard and mesh-tagged fold spans equal in structure. The JAX
    side serves in a thread meanwhile."""
    from alphafold2_tpu.data.synthetic import synthetic_requests
    reqs = synthetic_requests(jax.random.PRNGKey(1), num=6,
                              lengths=(12, 24), msa_depth=ROWS)

    def serve(side):
        s = jax_serve if side == "jax" else pt_serve
        pool = jax.devices()[:4] if side == "jax" else [CPU] * 4
        tracer = s.Tracer(jsonl_path=str(tmp_path / f"{side}.jsonl"))
        sched = _mesh_scheduler(side, executors[side],
                                s.MeshPolicy({16: 1, 32: 4}, devices=pool),
                                tracer=tracer)
        sched.warmup()
        got = []
        with sched:
            for r in reqs:
                t = sched.submit(s.FoldRequest(seq=np.asarray(r.seq),
                                               msa=np.asarray(r.msa)))
                got.append(t.result(timeout=300))
        tracer.close()
        return (got, sched.serve_stats()["mesh"], sched.health().get("mesh"),
                _span_structure(tmp_path / f"{side}.jsonl"))

    with ThreadPoolExecutor(1) as pool:
        jax_side = pool.submit(serve, "jax")
        got, snap, health, spans = serve("port")
        ref, ref_snap, ref_health, ref_spans = jax_side.result()
    for a, b in zip(got, ref):
        assert a.ok, a.error
        close_at(a.coords, b.coords, np.ones(len(b.coords), bool))
        close_at(a.confidence, b.confidence, np.ones(len(b.confidence), bool))
    assert snap == ref_snap
    assert snap["folds"]["2x2"]["batches"] >= 1
    assert health == ref_health == {"total_devices": 4, "busy_devices": 0}
    assert spans == ref_spans
    assert any("2x2" in fold for _, _, fold, _ in spans)
    # stop() closed the executor's groups
    assert not executors["port"].groups()


def test_poison_isolated_on_slice(executors):
    """Raise-mode poison on a (1, 2) lease: the poison row is isolated
    (row isolation through the FaultPlan's attribution), the innocent
    batch mate's coords are byte-equal to a fold alone on the same
    slice, and the slice comes back."""
    from alphafold2_tpu_torch.data.synthetic import synthetic_requests
    s = pt_serve
    ex = executors["port"]
    a, p = synthetic_requests(np.random.default_rng(5), num=2,
                              lengths=(12, 10), msa_depth=ROWS)
    shape = (1, 2)
    kw = dict(devices=port_slice(shape), mesh_shape=shape)
    # alone: the scheduler's step loop (init, then one step per recycle)
    # on the same slice, over the batch it would assemble
    batch, _ = s.BucketPolicy((16,)).assemble(
        [s.FoldRequest(seq=a.seq, msa=a.msa)], 16, 2, msa_depth=ROWS,
        device="cpu")
    state = ex.run_init(batch, **kw)
    for r in range(2):
        state = ex.run_step(batch, state, r, **kw)
    alone = state.coords[0, :12].numpy()

    plan = s.FaultPlan(seed=0)
    plan.add_poison(np.asarray(p.seq), mode="raise")
    ex.faults = plan
    sched = _mesh_scheduler(
        "port", ex, s.MeshPolicy({16: 2}, devices=port_slice(shape)),
        edges=(16,), num_recycles=2,
        recycle_policy=s.RecyclePolicy(converge_tol=0.0),
        retry=s.RetryPolicy(max_attempts=3, backoff_base_s=0.0,
                            row_isolation=True))
    sched.warmup()
    plan.arm()
    try:
        with sched:
            ta = sched.submit(s.FoldRequest(seq=a.seq, msa=a.msa))
            tp = sched.submit(s.FoldRequest(seq=p.seq, msa=p.msa))
            ra, rp = ta.result(timeout=300), tp.result(timeout=300)
    finally:
        ex.faults = None
    assert ra.ok, ra.error
    assert rp.status == "poisoned"
    stats = sched.serve_stats()
    assert stats["resilience"]["row_poison_isolations"] >= 1
    assert stats["mesh"]["allocator"]["busy_devices"] == 0
    assert np.array_equal(ra.coords, alone)


def test_pool_and_memory_defaults(executors, monkeypatch):
    """The mesh pool is every visible card (the CPU for a model there);
    a chip count's face keeps the rows whole on cards (1 x n) and is the
    JAX package's squarest one on the CPU; a fleet replica takes its
    chunk of the pool by JAX's rule; a pool of cards is priced at each
    card's own memory: the TPU's 16 GB stays only as the CPU's budget,
    in serve_loadtest and ProcFleet alike."""
    import inspect

    from alphafold2_tpu_torch.fleet.procfleet import ProcFleet
    from alphafold2_tpu_torch.serve import meshpolicy
    from alphafold2_tpu_torch.tools import serve_loadtest
    model = executors["port"].model
    assert meshpolicy.visible_devices("cpu") == [CPU]
    assert pt_serve.MeshPolicy.from_model(
        model, None, (16,), hbm_gb=1.0).devices == [CPU]
    assert meshpolicy.default_hbm_gb("cpu") == 16.0
    assert meshpolicy.default_hbm_gb("cuda:0") is None
    assert serve_loadtest.parse_args([]).mesh_hbm_gb is None
    assert inspect.signature(ProcFleet).parameters[
        "mesh_hbm_gb"].default is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cards = [torch.device("cuda", i) for i in range(4)]
    assert meshpolicy.visible_devices() == cards
    policy = pt_serve.MeshPolicy({16: 1, 32: 4, 64: (2, 2)})
    assert policy.devices == cards and policy.shape_for(32) == (1, 4)
    assert policy.shape_for(64) == (2, 2) and not policy.clamped
    assert pt_serve.MeshPolicy({32: 8}).shape_for(32) == (1, 4)
    assert meshpolicy.slice_face(4, [CPU] * 4) == (2, 2)
    assert meshpolicy.slice_face(8, cards) == (1, 8)
    for count in (1, 2, 3, 8):
        for i in range(count):
            chunk = max(1, 4 // count)
            want = cards[i * chunk:(i + 1) * chunk] or cards[-chunk:]
            assert meshpolicy.device_share(cards, i, count) == want
    assert meshpolicy.device_share(cards, 1, 2) == cards[2:]


def test_no_rank_outlives_the_executors(executors):
    """Closing the executors ends every rank process they started."""
    executors["port"].close()
    left = [p for p in multiprocessing.active_children()
            if p.name.startswith("af2-slice-rank")]
    assert not left, left
