"""The port's Scheduler (alphafold2_tpu_torch/serve/scheduler.py) against
the JAX package's, on the CPU.

Both schedulers get the same requests in scenarios whose outcome does not
depend on thread timing: batch formation, deadline shed, reject on a
full queue, a cache hit and a coalesced follower, transient retry, poison
bisection and quarantine, the circuit breaker opening and closing, step
mode with early exit, a continuous-batching admission and a step
checkpoint with its resume. Each side runs its own executor over the
same weights (the JAX params drawn with numpy onto the init's shapes and
bridged with `load_jax_params`); the executors are built once per module,
so the JAX programs compile once. Compared: statuses, sources and
attempts, the integer counters of `serve_stats()`, the traces by
structure (span names in order, status, source; never ids or times),
and the coords at real residues within 5e-4. Small size: dim 32, depth
1, heads 2, dim_head 16, bucket 16, 3 MSA rows.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphafold2_tpu import Alphafold2 as JaxAlphafold2
from alphafold2_tpu import serve as jax_serve
from alphafold2_tpu_torch import serve as pt_serve
from alphafold2_tpu_torch.model.alphafold2 import Alphafold2
from alphafold2_tpu_torch.weights import load_jax_params
from test_torch_serve import MODEL_KW, N, ROWS, random_params

FOLD_ATOL = 5e-4
SIDES = ("jax", "port")
# serve_stats() leaves that hold times, rates, shares or sizes in bytes
# (measured, so never equal across the two runs) or a process-local
# identity; every other integer leaf is compared
_UNCOMPARED = {"s", "ms", "seconds", "latency", "p50", "p90", "p99",
               "wall", "busy", "fraction", "waste", "rate", "bytes",
               "uptime", "idle", "traces"}


@pytest.fixture(scope="module")
def executors():
    """One executor per side over the same weights, shared by every
    scenario of the module (the JAX side compiles each program once)."""
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
    return {"jax": jax_serve.FoldExecutor(jm, params, max_entries=16),
            "port": pt_serve.FoldExecutor(pm, max_entries=16)}


def api(side):
    return jax_serve if side == "jax" else pt_serve


def tokens(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 20, n).astype(np.int32),
            rng.integers(0, 20, (ROWS, n)).astype(np.int32))


def request(side, n, seed, **kw):
    seq, msa = tokens(n, seed)
    return api(side).FoldRequest(seq=seq, msa=msa, **kw)


def make(side, executors, tmp_path, *, faults=None, max_batch_size=2,
         max_wait_ms=50.0, num_recycles=1, **kw):
    """A scheduler of `side` over the shared executor (its fault plan
    set to `faults`), a fresh registry and a JSONL tracer."""
    s = api(side)
    ex = executors[side]
    ex.faults = faults
    tracer = s.Tracer(jsonl_path=str(tmp_path / f"{side}.jsonl"))
    config = s.SchedulerConfig(max_batch_size=max_batch_size,
                               max_wait_ms=max_wait_ms,
                               num_recycles=num_recycles, msa_depth=ROWS,
                               poll_ms=2.0)
    registry = s.MetricsRegistry()
    return s.Scheduler(ex, s.BucketPolicy((N,)), config,
                       s.ServeMetrics(registry=registry), tracer=tracer,
                       registry=registry, **kw)


def counters(stats, prefix=""):
    """The integer (and bool) leaves of a serve_stats() dict by path."""
    out = {}
    for key, val in stats.items():
        path = f"{prefix}{key}"
        if _UNCOMPARED & set(str(key).split("_")):
            continue
        if isinstance(val, dict):
            out.update(counters(val, path + "."))
        elif isinstance(val, (bool, int)) and not isinstance(val, float):
            out[path] = val
    return out


def traces(sched, tmp_path, side, order):
    """(status, source, span names) per request, in submit order."""
    sched.tracer.close()
    by_id = {}
    with open(tmp_path / f"{side}.jsonl") as fh:
        for line in fh:
            rec = json.loads(line)
            by_id[rec["request_id"]] = (
                rec["status"], rec["source"],
                tuple(s["name"] for s in rec["spans"]))
    return [by_id.get(rid) for rid in order]


def settle(tickets):
    """Wait for every ticket inside the scheduler's `with` block: a stop
    that drains resolves a batch still waiting for its retry as an
    error."""
    for t in tickets:
        t.result(timeout=120)


def outcome(sched, tickets, tmp_path, side):
    """Called once the scheduler has stopped, so its counters are
    final."""
    resps = [t.result(timeout=120) for t in tickets]
    return {"responses": resps,
            "summary": [(r.status, r.source, r.attempts) for r in resps],
            "counters": counters(sched.serve_stats()),
            "traces": traces(sched, tmp_path, side,
                             [r.request_id for r in resps])}


def both(executors, tmp_path, scenario):
    """Run `scenario(side, tmp)` on each side; returns the outcomes."""
    out = {}
    for side in SIDES:
        tmp = tmp_path / side
        tmp.mkdir()
        out[side] = scenario(side, tmp)
    executors["jax"].faults = executors["port"].faults = None
    return out["jax"], out["port"]


def assert_same(ref, got):
    assert got["summary"] == ref["summary"]
    assert got["traces"] == ref["traces"]
    assert got["counters"] == ref["counters"], sorted(
        set(got["counters"].items()) ^ set(ref["counters"].items()))
    for a, b in zip(ref["responses"], got["responses"]):
        assert (a.coords is None) == (b.coords is None)
        if a.coords is not None:
            assert b.coords.shape == a.coords.shape
            np.testing.assert_allclose(b.coords, a.coords, rtol=0,
                                       atol=FOLD_ATOL)
            np.testing.assert_allclose(b.confidence, a.confidence,
                                       rtol=0, atol=FOLD_ATOL)


def test_batch_formation(executors, tmp_path):
    """Two requests under max_batch_size 2 form one padded batch."""
    def scenario(side, tmp):
        sched = make(side, executors, tmp, max_wait_ms=500.0)
        with sched:
            tickets = [sched.submit(request(side, n, seed=n))
                       for n in (12, 9)]
            settle(tickets)
        res = outcome(sched, tickets, tmp, side)
        return res

    ref, got = both(executors, tmp_path, scenario)
    assert_same(ref, got)
    assert [s[0] for s in got["summary"]] == ["ok", "ok"]
    assert got["counters"]["batches"] == 1
    assert [r.coords.shape for r in got["responses"]] == [(12, 3), (9, 3)]


def test_deadline_shed(executors, tmp_path):
    """A request past its deadline is shed without touching the
    executor."""
    def scenario(side, tmp):
        sched = make(side, executors, tmp)
        misses = executors[side].stats()["misses"]
        with sched:
            tickets = [sched.submit(request(side, 8, seed=1,
                                            deadline_s=0.0))]
            settle(tickets)
        res = outcome(sched, tickets, tmp, side)
        res["built"] = executors[side].stats()["misses"] - misses
        return res

    ref, got = both(executors, tmp_path, scenario)
    assert_same(ref, got)
    assert got["summary"][0][0] == "shed" and got["built"] == 0


def test_reject_on_full_queue(executors, tmp_path):
    """queue_limit 1 with full_policy "reject": the second submit raises
    QueueFullError, and a stop without drain cancels the first."""
    def scenario(side, tmp):
        sched = make(side, executors, tmp, max_batch_size=8,
                     max_wait_ms=60_000.0)
        sched.config.queue_limit, sched.config.full_policy = 1, "reject"
        sched.start()
        first = sched.submit(request(side, 8, seed=2))
        with pytest.raises(api(side).QueueFullError):
            sched.submit(request(side, 8, seed=3))
        sched.stop(drain=False)
        return outcome(sched, [first], tmp, side)

    ref, got = both(executors, tmp_path, scenario)
    assert_same(ref, got)
    assert got["summary"][0][0] == "cancelled"
    assert got["counters"]["rejected"] == 1


def test_cache_hit_and_coalesced_follower(executors, tmp_path):
    """A duplicate submitted while its leader is queued parks as a
    follower ("coalesced"); one submitted after the leader resolved is a
    cache hit ("cache")."""
    def scenario(side, tmp):
        s = api(side)
        sched = make(side, executors, tmp, max_wait_ms=300.0,
                     cache=s.FoldCache(registry=s.MetricsRegistry()),
                     model_tag="parity")
        with sched:
            leader = sched.submit(request(side, 11, seed=4))
            follower = sched.submit(request(side, 11, seed=4))
            leader.result(timeout=120)
            hit = sched.submit(request(side, 11, seed=4))
            settle([leader, follower, hit])
        res = outcome(sched, [leader, follower, hit], tmp, side)
        return res

    ref, got = both(executors, tmp_path, scenario)
    assert_same(ref, got)
    assert [s[:2] for s in got["summary"]] == [
        ("ok", "fold"), ("ok", "coalesced"), ("ok", "cache")]


def test_transient_retry(executors, tmp_path):
    """One injected transient executor error (the seeded plan hits its
    first draw only): the batch is retried and both requests end ok on
    their second attempt."""
    def scenario(side, tmp):
        s = api(side)
        plan = s.FaultPlan(seed=10, exec_error_rate=0.5,
                           registry=s.MetricsRegistry()).arm()
        sched = make(side, executors, tmp, faults=plan,
                     max_wait_ms=500.0,
                     retry=s.RetryPolicy(max_attempts=3,
                                         backoff_base_s=0.01, seed=1))
        with sched:
            tickets = [sched.submit(request(side, n, seed=n))
                       for n in (10, 13)]
            settle(tickets)
        res = outcome(sched, tickets, tmp, side)
        res["injected"] = plan.snapshot()["injected"]["exec_error"]
        return res

    ref, got = both(executors, tmp_path, scenario)
    assert_same(ref, got)
    assert got["summary"] == [("ok", "fold", 2)] * 2, [
        r.error for r in got["responses"]]
    assert got["injected"] == ref["injected"] == 1
    assert got["counters"]["resilience.retries"] == 2


def test_poison_bisection_and_quarantine(executors, tmp_path):
    """A poison input batched with an innocent one: the batch is
    bisected, the poison ends "poisoned" and is quarantined, its
    batch-mate ends ok, and a later duplicate fails fast."""
    def scenario(side, tmp):
        s = api(side)
        plan = s.FaultPlan(seed=0, registry=s.MetricsRegistry())
        plan.add_poison(tokens(9, seed=5)[0]).arm()
        sched = make(side, executors, tmp, faults=plan,
                     max_wait_ms=500.0,
                     retry=s.RetryPolicy(max_attempts=3,
                                         backoff_base_s=0.01))
        with sched:
            tickets = [sched.submit(request(side, 9, seed=5)),
                       sched.submit(request(side, 12, seed=6))]
            for t in tickets:
                t.result(timeout=120)
            tickets.append(sched.submit(request(side, 9, seed=5)))
            settle(tickets)
        res = outcome(sched, tickets, tmp, side)
        return res

    ref, got = both(executors, tmp_path, scenario)
    assert_same(ref, got)
    assert [s[0] for s in got["summary"]] == ["poisoned", "ok", "poisoned"]
    assert got["counters"]["resilience.quarantine.quarantined"] == 1
    assert got["counters"]["resilience.bisections"] == 1


def test_breaker_opens_and_closes(executors, tmp_path):
    """Two batches failed by transient errors open the breaker (the next
    novel submit is "degraded"); after the cooldown a probe batch
    succeeds and closes it."""
    def scenario(side, tmp):
        s = api(side)
        plan = s.FaultPlan(seed=0, exec_error_rate=1.0,
                           registry=s.MetricsRegistry()).arm()
        sched = make(side, executors, tmp, faults=plan, max_batch_size=1,
                     retry=s.RetryPolicy(max_attempts=1,
                                         backoff_base_s=0.01,
                                         breaker_threshold=2,
                                         breaker_cooldown_s=0.3))
        with sched:
            tickets = []
            for seed in (7, 8, 9):
                tickets.append(sched.submit(request(side, 8, seed=seed)))
                tickets[-1].result(timeout=120)
            state = sched.serve_stats()["resilience"]["breaker"]["state"]
            plan.disarm()
            time.sleep(0.35)
            tickets.append(sched.submit(request(side, 8, seed=10)))
            settle(tickets)
        res = outcome(sched, tickets, tmp, side)
        res["state_when_open"] = state
        return res

    ref, got = both(executors, tmp_path, scenario)
    assert_same(ref, got)
    assert [s[0] for s in got["summary"]] == ["error", "error", "degraded",
                                              "ok"]
    assert got["state_when_open"] == "open"
    assert got["counters"]["resilience.breaker.opens"] == 1
    assert got["counters"]["resilience.breaker.closes"] == 1


def test_step_mode_early_exit(executors, tmp_path):
    """A RecyclePolicy with converge_tol > 0 and streaming: both
    elements converge after the first step, the remaining recycles are
    skipped, and progressive results reached the tickets."""
    def scenario(side, tmp):
        s = api(side)
        sched = make(side, executors, tmp, num_recycles=3,
                     max_wait_ms=500.0,
                     recycle_policy=s.RecyclePolicy(converge_tol=1e3,
                                                    stream=True),
                     cache=s.FoldCache(registry=s.MetricsRegistry()),
                     model_tag="parity")
        with sched:
            tickets = [sched.submit(request(side, n, seed=20 + n))
                       for n in (14, 10)]
            settle(tickets)
        res = outcome(sched, tickets, tmp, side)
        res["recycles"] = [r.recycles for r in res["responses"]]
        res["progress"] = [len(t.progress()) for t in tickets]
        return res

    ref, got = both(executors, tmp_path, scenario)
    assert_same(ref, got)
    assert got["recycles"] == ref["recycles"] == [1, 1]
    assert got["progress"] == ref["progress"] and min(got["progress"]) >= 1
    assert got["counters"]["recycle.recycles_skipped"] == 2
    assert got["counters"]["recycle.retired_early"] == 2


def test_continuous_admission(executors, tmp_path):
    """continuous=True: a batch formed around one request leaves its
    second row empty; a request submitted once the loop streams its
    first step is admitted into that row through the row-masked init
    (init_rows) instead of waiting for a new batch."""
    def scenario(side, tmp):
        s = api(side)
        # 50 ms a step keeps the loop open well past the second submit,
        # however busy the host is
        plan = s.FaultPlan(exec_latency_rate=1.0, exec_latency_s=0.05,
                           registry=s.MetricsRegistry()).arm()
        sched = make(side, executors, tmp, faults=plan, num_recycles=6,
                     max_wait_ms=5.0,
                     recycle_policy=s.RecyclePolicy(stream=True,
                                                    continuous=True))
        with sched:
            tickets = [sched.submit(request(side, 14, seed=31))]
            deadline = time.monotonic() + 60
            while tickets[0].latest_progress() is None:
                assert time.monotonic() < deadline
                time.sleep(0.001)
            tickets.append(sched.submit(request(side, 10, seed=32)))
            settle(tickets)
        res = outcome(sched, tickets, tmp, side)
        res["recycles"] = [r.recycles for r in res["responses"]]
        return res

    ref, got = both(executors, tmp_path, scenario)
    assert_same(ref, got)
    assert [s[0] for s in got["summary"]] == ["ok", "ok"]
    assert got["recycles"] == [6, 6]
    assert got["counters"]["recycle.row_admissions"] == 1, sorted(
        got["counters"].items())
    assert got["counters"]["batches"] == 1


def test_step_checkpoint_and_resume(executors, tmp_path):
    """checkpoint_every=1 and one injected transient at recycle 1 (the
    seeded plan hits its first draw there only): the loop resumes from
    the checkpoint instead of restarting at zero, and both requests end
    ok with every recycle run."""
    def scenario(side, tmp):
        s = api(side)
        plan = s.FaultPlan(seed=1, step_fail_at={1: 0.5},
                           registry=s.MetricsRegistry()).arm()
        sched = make(side, executors, tmp, faults=plan, num_recycles=2,
                     max_wait_ms=500.0,
                     recycle_policy=s.RecyclePolicy(),
                     retry=s.RetryPolicy(max_attempts=3,
                                         backoff_base_s=0.01,
                                         checkpoint_every=1))
        with sched:
            tickets = [sched.submit(request(side, n, seed=40 + n))
                       for n in (13, 11)]
            settle(tickets)
        res = outcome(sched, tickets, tmp, side)
        res["recycles"] = [r.recycles for r in res["responses"]]
        return res

    ref, got = both(executors, tmp_path, scenario)
    assert_same(ref, got)
    assert [s[0] for s in got["summary"]] == ["ok", "ok"]
    assert got["recycles"] == [2, 2]
    assert got["counters"]["resilience.checkpoint_resumes"] == 1
    assert got["counters"]["resilience.recycles_lost"] == 0


def test_bulk_policy_is_refused_until_its_queue_is_ported(executors,
                                                          tmp_path):
    """The bulk tier's queue (serve/bulk.py) is not ported: a bulk policy
    is refused at construction, naming the missing module, instead of
    failing on an import once traffic arrives."""
    with pytest.raises(NotImplementedError, match="serve/bulk.py"):
        make("port", executors, tmp_path, bulk=object())
