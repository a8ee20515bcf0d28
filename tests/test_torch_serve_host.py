"""The port's host-side serving modules against the JAX package's, on
the same inputs: request types, confidence scoring, serving metrics,
resilience verdicts and backoff draws, the seeded fault plan, the
recycle policy's deltas and repack, the memory model and mesh policy at
a given memory budget, featurization and its feature keys, and the CUDA
error classifier (`serve/cuda_errors.py`, the counterpart of
`serve/xla_errors.py`) on real CUDA and torch error strings plus the JAX
classifier's own payloads, which keep the JAX verdict through
`RetryPolicy`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import Alphafold2 as JaxAlphafold2
from alphafold2_tpu.obs.registry import MetricsRegistry as JaxRegistry
from alphafold2_tpu.predict import FoldStepState as JaxStepState
from alphafold2_tpu.model.alphafold2 import Recyclables as JaxRecyclables
from alphafold2_tpu.serve import confidence as jax_conf
from alphafold2_tpu.serve import faults as jax_faults
from alphafold2_tpu.serve import features as jax_feat
from alphafold2_tpu.serve import meshpolicy as jax_mesh
from alphafold2_tpu.serve import metrics as jax_metrics
from alphafold2_tpu.serve import recycle as jax_recycle
from alphafold2_tpu.serve import request as jax_request
from alphafold2_tpu.serve import resilience as jax_res
from alphafold2_tpu.serve import xla_errors
from alphafold2_tpu_torch.model.alphafold2 import (Alphafold2,
                                                   Recyclables)
from alphafold2_tpu_torch.obs.registry import MetricsRegistry
from alphafold2_tpu_torch.predict import FoldStepState
from alphafold2_tpu_torch.serve import confidence as pt_conf
from alphafold2_tpu_torch.serve import cuda_errors
from alphafold2_tpu_torch.serve import faults as pt_faults
from alphafold2_tpu_torch.serve import features as pt_feat
from alphafold2_tpu_torch.serve import meshpolicy as pt_mesh
from alphafold2_tpu_torch.serve import metrics as pt_metrics
from alphafold2_tpu_torch.serve import recycle as pt_recycle
from alphafold2_tpu_torch.serve import request as pt_request
from alphafold2_tpu_torch.serve import resilience as pt_res
from test_torch_serve import MODEL_KW, N, ROWS
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)


def fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else None) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["FoldRequest", "FoldResponse",
                                  "FoldProgress"])
def test_request_types_match(name):
    """The request, response and progress types carry the JAX package's
    fields and defaults."""
    assert fields(getattr(pt_request, name)) == \
        fields(getattr(jax_request, name))


def test_ticket_resolves_and_streams_like_jax():
    out = []
    for mod in (jax_request, pt_request):
        ticket = mod.FoldTicket("r-1")
        seen = []
        ticket.add_done_callback(lambda resp: seen.append(resp.status))
        ticket._publish_progress(mod.FoldProgress(
            request_id="r-1", recycle=1, coords=np.zeros((3, 3)),
            confidence=np.ones(3)))
        ticket._resolve(mod.FoldResponse(request_id="r-1", status="ok"))
        out.append((ticket.done(), [p.recycle for p in ticket.progress()],
                    ticket.latest_progress().recycle, seen,
                    ticket.result(timeout=1).status))
    assert out[0] == out[1] == (True, [1], 1, ["ok"], "ok")


def test_confidence_scores_match():
    rng = np.random.default_rng(0)
    conf = rng.random(20).astype(np.float32)
    mask = np.arange(20) < 15
    pairs = mask[:, None] & mask[None, :]
    logits = rng.normal(size=(20, 20, 37)).astype(np.float32)
    for mod in (jax_conf, pt_conf):
        assert mod.plddt_score(conf, mask) == jax_conf.plddt_score(conf,
                                                                  mask)
        assert mod.distogram_entropy(logits, pairs) == \
            jax_conf.distogram_entropy(logits, pairs)
    resp = pt_request.FoldResponse(request_id="x", status="ok",
                                   confidence=conf)
    resp.distogram_entropy = 0.3
    got = pt_conf.score_response(resp)
    ref = jax_conf.score_response(resp)
    assert (got.plddt, got.entropy, got.score) == \
        (ref.plddt, ref.entropy, ref.score)
    for kw in (dict(), dict(accept_plddt=0.4, max_entropy=0.2)):
        assert pt_conf.ConfidenceGate(**kw).accepts(got) == \
            jax_conf.ConfidenceGate(**kw).accepts(ref)


def metrics_calls(m):
    m.record_enqueued(3)
    m.record_served(16, 0.25)
    m.record_served(32, 0.5)
    m.record_batch(16, 2, 1, 12, 0.625, 0.125, 1)
    m.record_cache_hit()
    m.record_cache_miss()
    m.record_coalesced()
    m.record_shed()
    m.record_rejected()
    m.record_retried(2)
    m.record_admit(0.25)
    m.record_step_occupancy(24, 32)
    return m.snapshot()


def test_serve_metrics_snapshots_match(tmp_path):
    """The same calls give the same snapshot and the same JSONL record
    keys, on the registry each package has."""
    ref = metrics_calls(jax_metrics.ServeMetrics(
        str(tmp_path / "jax.jsonl"), registry=JaxRegistry()))
    got = metrics_calls(pt_metrics.ServeMetrics(
        str(tmp_path / "port.jsonl"), registry=MetricsRegistry()))
    assert got == ref
    logs = []
    for side in ("jax", "port"):
        mod = jax_metrics if side == "jax" else pt_metrics
        log = mod.KeyFrequencyLog(str(tmp_path / f"{side}.keys"),
                                  flush_every=1)
        log.observe(np.arange(5), np.ones((2, 5), np.int32))
        log.observe(np.arange(5), np.ones((2, 5), np.int32))
        log.observe(np.arange(7))
        log.flush()
        snap = log.snapshot()
        assert snap.pop("path") == str(tmp_path / f"{side}.keys")
        logs.append((snap, (tmp_path / f"{side}.keys").read_text()))
    assert logs[0] == logs[1]


# JAX payloads the legacy markers of RetryPolicy decide, with the verdict
# both packages' RetryPolicy give them whatever the classifiers say
MARKER_PAYLOADS = [
    ("RESOURCE_EXHAUSTED: Out of memory allocating 123 bytes", True),
    ("DEADLINE_EXCEEDED: barrier timed out at batch index 1", True),
    ("UNAVAILABLE: socket closed", True),
    ("connection reset by peer", True),
    ("transient executor hiccup", True),
]
# platform-free payloads: the same verdict, reason and rows from both
# classifiers, and through both RetryPolicy
GENERIC_PAYLOADS = [
    ("XlaRuntimeError: INVALID_ARGUMENT: shape mismatch", False),
    ("found a NaN in row=2", False),
    ("something nobody has seen", False),
]
# XLA/TPU-only payloads: the port cannot raise them, so its classifier
# has no opinion
TPU_PAYLOADS = [
    "TPU program halted at batch index 3",
    "ABORTED: slice halted for maintenance",
    "slice health check failed",
    "INTERNAL: during HLO pass pipeline",
    "core halted unexpectedly",
]
CUDA_PAYLOADS = [
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB (GPU 0; 79.11 "
        "GiB total capacity)"), True, "cuda_oom"),
    (RuntimeError("CUDA error: out of memory"), True, "cuda_oom"),
    (RuntimeError("cudaErrorMemoryAllocation"), True, "cuda_oom"),
    (RuntimeError("CUDA error: an illegal memory access was "
                  "encountered"), False, "illegal_address"),
    (RuntimeError("CUDA error: misaligned address"), False,
     "misaligned_address"),
    (RuntimeError("CUDA error: unspecified launch failure"), False,
     "launch_failure"),
    (RuntimeError("CUDA error: device-side assert triggered"), False,
     "device_assert"),
    (RuntimeError("NCCL error in: ProcessGroupNCCL.cpp:1333, unhandled "
                  "cuda error"), False, "nccl"),
    (RuntimeError("fused_attention kernel launch failed: CUDA error 2 "
                  "(B=2048, Nq=256, Nk=256, D=64, layout 0)"), True,
     "cuda_oom"),
    (RuntimeError("fused_attention kernel launch failed: CUDA error 700 "
                  "(B=8, Nq=16, Nk=16, D=64, layout 0)"), False,
     "illegal_address"),
    (RuntimeError("block_sparse_attention kernel launch failed: CUDA "
                  "error -1 (B=16, N=64, D=16, block=16)"), False,
     "kernel_refused"),
]


@pytest.mark.parametrize("payload,transient", MARKER_PAYLOADS)
def test_jax_payloads_keep_their_verdict(payload, transient):
    """Through each package's RetryPolicy, the legacy markers decide
    first; and the payload's rows as the JAX regex reads them."""
    exc = RuntimeError(payload)
    for xla_classify in (True, False):
        assert pt_res.RetryPolicy(xla_classify=xla_classify).is_transient(
            exc) == jax_res.RetryPolicy(
                xla_classify=xla_classify).is_transient(exc) == transient
    assert cuda_errors.attributed_rows(payload) == \
        xla_errors.attributed_rows(payload)


@pytest.mark.parametrize("payload,transient", GENERIC_PAYLOADS)
def test_generic_payloads_classified_as_in_jax(payload, transient):
    exc = RuntimeError(payload)
    assert pt_res.RetryPolicy().is_transient(exc) == \
        jax_res.RetryPolicy().is_transient(exc) == transient
    ref, got = xla_errors.classify(repr(exc)), cuda_errors.classify(
        repr(exc))
    assert (got is None) == (ref is None)
    if got is not None:
        assert (got.transient, got.reason, got.rows) == \
            (ref.transient, ref.reason, ref.rows)
    assert cuda_errors.attributed_rows(payload) == \
        xla_errors.attributed_rows(payload)


@pytest.mark.parametrize("payload", TPU_PAYLOADS)
def test_tpu_only_payloads_have_no_opinion(payload):
    assert xla_errors.classify(payload) is not None
    assert cuda_errors.classify(payload) is None
    assert pt_res.RetryPolicy().is_transient(RuntimeError(payload)) is False


@pytest.mark.parametrize("exc,transient,reason", CUDA_PAYLOADS,
                         ids=[p[2] + str(i) for i, p in
                              enumerate(CUDA_PAYLOADS)])
def test_cuda_payloads_classified(exc, transient, reason):
    verdict = cuda_errors.classify(repr(exc))
    assert verdict is not None and (verdict.transient, verdict.reason) == \
        (transient, reason)
    assert pt_res.RetryPolicy().is_transient(exc) == transient
    # the legacy markers alone have no opinion on any of them
    assert pt_res.RetryPolicy(xla_classify=False).is_transient(exc) is False


def test_classifier_never_raises_and_unknown_codes_have_no_opinion():
    assert cuda_errors.classify(None) is None
    assert cuda_errors.classify("CUDA error 12345 (B=1)") is None
    assert cuda_errors.attributed_rows(None) == ()


def test_resilience_draws_and_state_machines_match():
    """Backoff draws from one seed, the breaker's state sequence and the
    quarantine's strikes."""
    out = []
    for mod, reg in ((jax_res, JaxRegistry()), (pt_res, MetricsRegistry())):
        policy = mod.RetryPolicy(seed=3, backoff_base_s=0.01)
        draws = [policy.delay_s(a) for a in (1, 2, 3, 4, 9)]
        clock = [0.0]
        cb = mod.CircuitBreaker(failure_threshold=2, cooldown_s=5.0,
                                clock=lambda: clock[0])
        states = []
        for step in ("f", "f", "t5", "s", "f", "f"):
            if step == "f":
                cb.record_failure()
            elif step == "s":
                states.append((cb.allow_submit(), cb.allow_execute()))
                cb.begin_probe()
                cb.record_success()
            else:
                clock[0] += 5.0
            states.append(cb.state)
        q = mod.Quarantine(registry=reg)
        strikes = [q.strike("k", threshold=2) for _ in range(2)]
        out.append((draws, states, strikes, q.reason("k")))
    assert out[0] == out[1]


def test_fault_plan_injects_the_same_sequence():
    """One seed, both plans: the same injections at the same calls, the
    same poison rows, and NaN-mode poison written into the port's result
    tensor where the JAX plan writes its numpy copy."""
    seqs = np.array([[1, 2, 3, 0], [4, 5, 6, 7]], np.int32)
    mask = np.array([[1, 1, 1, 0], [1, 1, 1, 1]], bool)
    runs = []
    for mod, reg in ((jax_faults, JaxRegistry()),
                     (pt_faults, MetricsRegistry())):
        plan = mod.FaultPlan(seed=5, exec_error_rate=0.3,
                             step_fail_at={1: 0.5}, registry=reg).arm()
        plan.add_poison(np.array([4, 5, 6, 7]), mode="nan")
        batch = {"seq": seqs, "mask": mask} if mod is jax_faults else \
            {"seq": torch.from_numpy(seqs), "mask": torch.from_numpy(mask)}
        hits = []
        for i in range(20):
            try:
                plan.on_executor_run(batch, variant="step", recycle=i % 3)
                hits.append(None)
            except Exception as e:
                hits.append(type(e).__name__)
        coords = np.ones((2, 4, 3), np.float32)
        if mod is pt_faults:
            coords = torch.from_numpy(coords)
        res = plan.mutate_result(batch, JaxStepState(coords, None, None,
                                                     None))
        runs.append((hits, plan.snapshot()["injected"],
                     np.asarray(res.coords), type(res.coords)))
    (h0, i0, c0, _), (h1, i1, c1, t1) = runs
    assert h0 == h1 and i0 == i1 and any(h0)
    assert t1 is torch.Tensor
    np.testing.assert_array_equal(np.isnan(c1), np.isnan(c0))
    assert np.isnan(c1[1]).all() and not np.isnan(c1[0]).any()


def test_element_deltas_and_repack_match():
    """element_deltas on the same arrays, and the repacked carry equal
    to the JAX package's row for row."""
    rng = np.random.default_rng(1)
    b, n, d = 3, 6, 4
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((b, n, 3), (b, n), (b, n, n, 5), (b, n, 3), (b, n, d),
                      (b, n, n, d))]
    prev = [rng.normal(size=a.shape).astype(np.float32) for a in arrs[:2]]
    args = (prev[0], prev[1], arrs[0], arrs[1], [6, 4, 0])
    assert pt_recycle.element_deltas(*args) == \
        jax_recycle.element_deltas(*args)
    assert pt_recycle.element_deltas(*args, rows=[2, 0, 1]) == \
        jax_recycle.element_deltas(*args, rows=[2, 0, 1])
    jstate = JaxStepState(*map(jnp.asarray, arrs[:3]),
                          JaxRecyclables(*map(jnp.asarray, arrs[3:])))
    pstate = FoldStepState(*map(torch.from_numpy, arrs[:3]),
                           Recyclables(*map(torch.from_numpy, arrs[3:])))
    jrep, jidx = jax_recycle.repack_rows(jstate, [2, 0], b)
    prep, pidx = pt_recycle.repack_rows(pstate, [2, 0], b)
    assert pidx == jidx == [2, 0, 0]
    for a, c in zip(jax.tree_util.tree_leaves(jrep),
                    jax.tree_util.tree_leaves(tuple(prep[:3]) +
                                              tuple(prep.recyclables))):
        np.testing.assert_array_equal(np.asarray(c), np.asarray(a))
    batch = {"seq": arrs[1], "mask": arrs[1] > 0, "msa": None,
             "msa_mask": None, "_placed": object()}
    jb = jax_recycle.repack_batch({k: (jnp.asarray(v) if isinstance(
        v, np.ndarray) else v) for k, v in batch.items()}, jidx)
    pb = pt_recycle.repack_batch({k: (torch.from_numpy(v) if isinstance(
        v, np.ndarray) else v) for k, v in batch.items()}, pidx)
    assert set(pb) == set(jb) == {"seq", "mask", "msa", "msa_mask"}
    np.testing.assert_array_equal(pb["seq"].numpy(), np.asarray(jb["seq"]))
    assert pt_recycle.steps_saved(3, 1) == jax_recycle.steps_saved(3, 1)


@pytest.fixture(scope="module")
def models():
    jm = JaxAlphafold2(**MODEL_KW)
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, N), jnp.int32),
                            msa=jnp.zeros((1, ROWS, N), jnp.int32),
                            mask=jnp.ones((1, N), bool),
                            msa_mask=jnp.ones((1, ROWS, N), bool)),
        jax.random.PRNGKey(0))
    params = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    return jm, params, Alphafold2(**MODEL_KW, device="cpu")


def test_memory_model_and_mesh_policy_match(models):
    """At the same memory budget the port's FoldMemoryModel (parameter
    bytes from `model.parameters()`) equals the JAX package's, and so do
    the mesh policy built from it, its admission verdicts and the
    admission pricer's decisions; shapes wider than the one-device pool
    clamp as the JAX policy clamps them."""
    jm, params, pm = models
    ref = jax_mesh.FoldMemoryModel.from_model(jm, params, hbm_gb=0.01)
    got = pt_mesh.FoldMemoryModel.from_model(pm, hbm_gb=0.01)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    for args in ((16, 1, 3), (64, 2, 5), (512, 1, 5)):
        assert got.fold_bytes(*args) == ref.fold_bytes(*args)
        assert got.fits(*args, 1, carry_recyclables=True) == \
            ref.fits(*args, 1, carry_recyclables=True)
    cpu = [torch.device("cpu")]
    jpol = jax_mesh.MeshPolicy.from_model(jm, params, (16, 64, 512),
                                          msa_depth=5, hbm_gb=0.01,
                                          devices=["d0"])
    ppol = pt_mesh.MeshPolicy.from_model(pm, None, (16, 64, 512),
                                         msa_depth=5, hbm_gb=0.01,
                                         devices=cpu)
    assert ppol.snapshot() == jpol.snapshot()
    assert [ppol.admits(e, 1, 5) for e in (16, 64, 512)] == \
        [jpol.admits(e, 1, 5) for e in (16, 64, 512)]
    wide = {16: 1, 512: 4}
    assert pt_mesh.MeshPolicy(wide, devices=cpu).snapshot() == \
        jax_mesh.MeshPolicy(wide, devices=["d0"]).snapshot()
    kw = dict(native_len=64, host_len=128, length=50, batch_size=2,
              msa_depth=5, candidate_steps=3, remaining_host_steps=2,
              native_delay_s=0.5, deadline_slack_s=None, host_step_s=0.01)
    for length in (50, 20):
        kw["length"] = length
        assert dataclasses.astuple(
            pt_mesh.AdmissionPricer(memory=got).price(**kw)) == \
            dataclasses.astuple(
                jax_mesh.AdmissionPricer(memory=ref).price(**kw))
    alloc = ppol.allocator()
    lease = alloc.acquire((1, 1))
    assert lease.devices == cpu and pt_mesh.chips_of(lease.shape) == 1
    assert alloc.acquire((1, 1)) is None and alloc.acquire((2, 2)) is None
    alloc.release(lease)


def test_featurize_and_feature_keys_match():
    raw_kw = dict(seq="MKVLAAGIVG", msa=["MKVLAAGIVG", "MK-LAAG.VG"])
    got = pt_feat.featurize_raw(pt_feat.RawFoldRequest(**raw_kw))
    ref = jax_feat.featurize_raw(jax_feat.RawFoldRequest(**raw_kw))
    np.testing.assert_array_equal(got.seq, ref.seq)
    np.testing.assert_array_equal(got.msa, ref.msa)
    assert pt_feat.featurizer_config_digest() == \
        jax_feat.featurizer_config_digest()
    emb_kw = dict(seq="MKVLAAGIVG", qos="express")
    got = pt_feat.express_featurize(pt_feat.RawFoldRequest(**emb_kw),
                                    pt_feat.StubEmbedder())
    ref = jax_feat.express_featurize(jax_feat.RawFoldRequest(**emb_kw),
                                     jax_feat.StubEmbedder())
    for a, b in zip(dataclasses.astuple(got), dataclasses.astuple(ref)):
        if a is None or b is None:
            assert a is b
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_process_featurize_pool_spawns():
    """The process executor's pool starts its workers by spawn (a fork
    would copy the parent's CUDA state), and its module-level, CUDA-free
    worker featurizes as the JAX package's featurize_raw does."""
    pool = pt_feat._process_pool(1)
    try:
        assert pool._mp_context.get_start_method() == "spawn"
        raw = pt_feat.RawFoldRequest(seq="MKVLAG", msa=["MKVLAG", "MK-LAG"])
        got = pool.submit(pt_feat.featurize_raw, raw).result(timeout=120)
    finally:
        pool.shutdown()
    ref = jax_feat.featurize_raw(jax_feat.RawFoldRequest(
        seq="MKVLAG", msa=["MKVLAG", "MK-LAG"]))
    np.testing.assert_array_equal(got.seq, ref.seq)
    np.testing.assert_array_equal(got.msa, ref.msa)
