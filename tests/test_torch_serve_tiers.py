"""The port's serving tiers (obs/slo, serve/bulk, serve/cascade with
config.draft_preset, serve/preemption) against the JAX package's, on
the CPU.

Both packages get the same inputs: the same latency and outcome
observations through `ServeMetrics` into each registry (the SLO reports
must be equal, so the port's serve_* metric names are the JAX ones);
the same bulk traffic through each `Scheduler` over the same weights
(admits, yields, rejects and coords at 5e-4); the same cascade traffic
under one scripted gate (accept, then escalate); and the same notices
through each `PreemptionWatcher` (file, signal, and a metadata URL on a
127.0.0.1 server). The executors come from test_torch_scheduler's
module fixture (dim 32, depth 1, heads 2, dim_head 16, bucket 16, 3 MSA
rows); a wrapper holds a fold at a chosen recycle so the burn signal can
flip while a loop is provably in flight.
"""

import dataclasses
import http.server
import json
import os
import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from alphafold2_tpu import config as jax_config
from alphafold2_tpu import obs as jax_obs
from alphafold2_tpu import serve as jax_serve
from alphafold2_tpu_torch import config as pt_config
from alphafold2_tpu_torch import obs as pt_obs
from alphafold2_tpu_torch import serve as pt_serve
from alphafold2_tpu_torch.weights import load_jax_params
from test_torch_scheduler import executors  # noqa: F401  (module fixture)
from test_torch_serve import N, ROWS, random_params
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)


FOLD_ATOL = 5e-4
SIDES = ("jax", "port")
SERVE = {"jax": jax_serve, "port": pt_serve}
OBS = {"jax": jax_obs, "port": pt_obs}


def tokens(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 20, n).astype(np.int32),
            rng.integers(0, 20, (ROWS, n)).astype(np.int32))


def request(side, n, seed, **kw):
    seq, msa = tokens(n, seed)
    return SERVE[side].FoldRequest(seq=seq, msa=msa, **kw)


def wait_for(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.005)
    raise AssertionError(f"timed out waiting for {what}")


# -- slo -------------------------------------------------------------------

def test_slo_reports_match_jax():
    """Seeded latencies and outcomes recorded through each package's
    ServeMetrics, evaluated by each SLOEngine under one fake clock over
    two windows: the reports and the slo_* gauges are equal."""
    rng = np.random.default_rng(0)
    lat = rng.lognormal(-2.0, 1.0, 300)
    buckets = rng.choice([16, 32, 64], 300)
    outcomes = rng.choice(["ok", "ok", "ok", "error", "shed", "poisoned"],
                          120)
    spec = "16=100,32=250,all=2000"
    reports = {}
    for side in SIDES:
        o, s = OBS[side], SERVE[side]
        clock = [100.0]
        reg = o.MetricsRegistry()
        metrics = s.ServeMetrics(registry=reg)
        engine = o.SLOEngine(o.SLOPolicy.parse(spec, window_s=60.0),
                             registry=reg, clock=lambda: clock[0])
        out = []
        for half in (slice(0, 150), slice(150, 300)):
            for b, v in zip(buckets[half], lat[half]):
                metrics.record_served(int(b), float(v))
            for name in outcomes[:60] if half.start == 0 else outcomes[60:]:
                {"error": metrics.record_error, "shed": metrics.record_shed,
                 "poisoned": metrics.record_poisoned}.get(
                     name, lambda: None)()
            clock[0] += 61.0
            out.append(engine.report())
        gauges = {k: v for k, v in reg.snapshot().items()
                  if k.startswith("slo_")}
        reports[side] = (out, gauges)
    assert reports["jax"] == reports["port"]
    first = reports["port"][0][0]["classes"]
    assert set(first) == {"bucket16", "bucket32", "all"}
    assert first["all"]["requests"] == 150
    assert first["all"]["availability"]["bad"] > 0


@pytest.mark.parametrize("spec", ["32=400,all=2000", "express=150",
                                  "64=auto,fleet=900"])
def test_slo_policy_parse_matches_jax(spec):
    got = {side: [dataclasses.asdict(c) for c in
                  OBS[side].SLOPolicy.parse(spec, window_s=30.0).classes]
           for side in SIDES}
    assert got["jax"] == got["port"]
    for side in SIDES:
        with pytest.raises(ValueError):
            OBS[side].SLOPolicy.parse("32=fast")


# -- bulk ------------------------------------------------------------------

class _Slo:
    """A burn-rate dial with the SLO engine's report shape."""

    def __init__(self, burn=0.0):
        self.burn = burn

    def report(self):
        return {"classes": {"online": {"latency":
                                       {"burn_rate": self.burn}}}}


class _Held:
    """The shared executor, with its step at `hold_at` blocking until
    `release` — everything else passes through."""

    def __init__(self, inner):
        self.inner = inner
        self.hold_at = None
        self.reached = threading.Event()
        self.release = threading.Event()
        self.steps = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def run_step(self, batch, state, recycle_index, **kw):
        if self.hold_at is not None and recycle_index == self.hold_at:
            self.hold_at = None
            self.reached.set()
            assert self.release.wait(60)
        self.steps += 1
        return self.inner.run_step(batch, state, recycle_index, **kw)


def bulk_scheduler(side, ex, *, num_recycles=2, spill=None, **kw):
    s = SERVE[side]
    reg = s.MetricsRegistry()
    retry = dict(backoff_base_s=0.0, jitter=0.0)
    if spill is not None:
        retry.update(checkpoint_every=1, checkpoint_spill=spill)
    return s.Scheduler(
        ex, s.BucketPolicy((N,)),
        s.SchedulerConfig(max_batch_size=2, max_wait_ms=5.0,
                          num_recycles=num_recycles, msa_depth=ROWS,
                          poll_ms=2.0),
        s.ServeMetrics(registry=reg), registry=reg,
        recycle_policy=s.RecyclePolicy(converge_tol=0.0),
        retry=s.RetryPolicy(**retry), **kw)


def bulk_counts(sched):
    b = sched.serve_stats()["bulk"]
    return {k: b[k] for k in ("admits", "yields", "pending", "rejected",
                              "gated")}


def test_bulk_founds_when_idle_as_jax(executors):  # noqa: F811
    got = {}
    for side in SIDES:
        executors[side].faults = None
        with bulk_scheduler(side, executors[side],
                            bulk=SERVE[side].BulkPolicy()) as sched:
            resp = sched.submit(request(side, 12, 1, qos="bulk")
                                ).result(timeout=120)
        got[side] = (resp, bulk_counts(sched))
    (ref, ref_counts), (port, counts) = got["jax"], got["port"]
    assert (port.status, port.source) == (ref.status, ref.source) == \
        ("ok", "fold")
    assert counts == ref_counts
    assert counts["admits"] == 1 and counts["yields"] == 0
    np.testing.assert_allclose(port.coords[:12], ref.coords[:12],
                               atol=FOLD_ATOL, rtol=0)


def test_bulk_yields_under_burn_and_resumes_as_jax(executors,  # noqa: F811
                                                   tmp_path):
    """A bulk loop held at recycle 1 sees online burn cross max_burn:
    it checkpoints and yields at the next gap (the gate closes, the
    row frees), resumes from its spilled checkpoint once the burn
    recedes, and finishes with no recycle run twice — in both
    packages, with the same counts and coords."""
    got = {}
    for side in SIDES:
        executors[side].faults = None
        held = _Held(executors[side])
        held.hold_at = 1
        slo = _Slo(0.0)
        sched = bulk_scheduler(
            side, held, num_recycles=4, spill=str(tmp_path / side),
            slo=slo, bulk=SERVE[side].BulkPolicy(max_burn=1.0,
                                                  check_interval_s=0.0))
        sched.start()
        try:
            ticket = sched.submit(request(side, 12, 2, qos="bulk"))
            assert held.reached.wait(60)
            slo.burn = 10.0
            held.release.set()
            wait_for(lambda: sched.serve_stats()["bulk"]["yields"] >= 1,
                     f"{side} bulk yield")
            mid = bulk_counts(sched)
            assert not ticket.done()
            slo.burn = 0.0
            resp = ticket.result(timeout=120)
        finally:
            sched.stop(drain=False)
        spill = sched.serve_stats()["resilience"]["checkpoint_spill"]
        got[side] = (resp, mid, bulk_counts(sched), held.steps,
                     spill["spill_resumes"])
    ref, port = got["jax"], got["port"]
    assert port[0].ok and ref[0].ok
    assert port[1:] == ref[1:]
    assert port[1]["gated"] and port[1]["pending"] == 1
    assert port[2]["yields"] == 1 and port[3] == 4 and port[4] >= 1
    np.testing.assert_allclose(port[0].coords[:12], ref[0].coords[:12],
                               atol=FOLD_ATOL, rtol=0)


def test_bulk_queue_bound_and_draining_stop_as_jax(executors):  # noqa: F811
    got = {}
    for side in SIDES:
        executors[side].faults = None
        s = SERVE[side]
        sched = bulk_scheduler(side, executors[side], slo=_Slo(10.0),
                               bulk=s.BulkPolicy(max_pending=1,
                                                 check_interval_s=0.0))
        sched.start()
        first = sched.submit(request(side, 10, 3, qos="bulk"))
        with pytest.raises(s.QueueFullError):
            sched.submit(request(side, 10, 4, qos="bulk"))
        wait_for(lambda: sched.serve_stats()["bulk"]["gated"],
                 f"{side} bulk gate")
        gated = bulk_counts(sched)
        sched.stop(drain=True)
        got[side] = (gated, first.result(timeout=120).status)
    assert got["port"] == got["jax"]
    assert got["port"] == ({"admits": 0, "yields": 0, "pending": 1,
                            "rejected": 1, "gated": True}, "ok")


# -- cascade ---------------------------------------------------------------

BASES = [dict(), dict(dim=32, depth=3, heads=2, dim_head=16,
                      structure_module_depth=2),
         dict(dim=3, depth=1, structure_module_depth=1)]


@pytest.mark.parametrize("base", BASES)
def test_draft_preset_matches_jax(base):
    ref = jax_config.draft_preset(jax_config.ModelConfig(**base))
    got = pt_config.draft_preset(pt_config.ModelConfig(**base))
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    if not base:
        assert (got.dim, got.depth, got.heads, got.dim_head,
                got.structure_module_depth) == (128, 2, 8, 64, 2)


@pytest.fixture(scope="module")
def draft_executors():
    """A draft-tier executor per side: `draft_preset` of a small
    flagship config (dim 16, depth 1), the JAX params drawn with numpy
    and bridged into the port's model."""
    base = dict(dim=32, depth=3, heads=2, dim_head=16,
                structure_module_depth=2, predict_coords=True,
                bfloat16=False)
    jcfg = jax_config.draft_preset(jax_config.ModelConfig(**base))
    pcfg = pt_config.draft_preset(pt_config.ModelConfig(**base))
    jm = jcfg.build()
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, N), jnp.int32),
                            msa=jnp.zeros((1, ROWS, N), jnp.int32),
                            mask=jnp.ones((1, N), bool),
                            msa_mask=jnp.ones((1, ROWS, N), bool)),
        jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.default_rng(5))
    pm = pcfg.build(device="cpu")
    load_jax_params(pm, params)
    return {"jax": jax_serve.FoldExecutor(jm, params, max_entries=4),
            "port": pt_serve.FoldExecutor(pm, max_entries=4)}


def scripted_gate(side, verdicts):
    class Scripted(SERVE[side].ConfidenceGate):
        def accepts(self, score):
            return verdicts.pop(0)
    return Scripted()


def test_cascade_accepts_then_escalates_as_jax(executors,  # noqa: F811
                                               draft_executors):
    got = {}
    for side in SIDES:
        s = SERVE[side]
        executors[side].faults = None
        cache = s.FoldCache()
        cfg = dict(max_batch_size=2, max_wait_ms=5.0, num_recycles=1,
                   msa_depth=ROWS, poll_ms=2.0)
        draft = s.build_draft_scheduler(
            draft_executors[side], s.BucketPolicy((N,)),
            config=s.SchedulerConfig(confidence_summary=True, **cfg),
            model_tag="v1#draft", cache=cache)
        reg = s.MetricsRegistry()
        policy = s.CascadePolicy(draft=draft,
                                 gate=scripted_gate(side, [True, False]))
        with s.Scheduler(executors[side], s.BucketPolicy((N,)),
                         s.SchedulerConfig(**cfg),
                         s.ServeMetrics(registry=reg), registry=reg,
                         cache=cache, model_tag="v1",
                         cascade=policy) as sched:
            resps = [sched.submit(request(side, 12, seed)
                                  ).result(timeout=120)
                     for seed in (6, 7)]
        casc = sched.serve_stats()["cascade"]
        got[side] = (resps, {k: v for k, v in casc.items()
                             if isinstance(v, int)})
    (ref, ref_casc), (port, casc) = got["jax"], got["port"]
    assert [(r.status, r.tier, r.escalated) for r in port] == \
        [(r.status, r.tier, r.escalated) for r in ref] == \
        [("ok", "draft", False), ("ok", "flagship", True)]
    assert casc == ref_casc
    assert casc["draft_accepted"] == 1 and casc["escalated"] == 1
    assert casc["cross_tier_hits"] == 0
    for a, b in zip(ref, port):
        np.testing.assert_allclose(b.coords[:12], a.coords[:12],
                                   atol=FOLD_ATOL, rtol=0)
        assert b.confidence_score == pytest.approx(a.confidence_score,
                                                   abs=1e-4)


def test_cascade_refuses_a_draft_on_the_flagship_tag(executors):  # noqa: F811
    for side in SIDES:
        s = SERVE[side]
        draft = s.build_draft_scheduler(executors[side], s.BucketPolicy((N,)),
                                        model_tag="same")
        with pytest.raises(ValueError, match="collides"):
            s.Scheduler(executors[side], s.BucketPolicy((N,)),
                        model_tag="same",
                        cascade=s.CascadePolicy(draft=draft))


# -- preemption ------------------------------------------------------------

def test_file_notice_puts_both_schedulers_in_reclaim(executors,  # noqa: F811
                                                     tmp_path):
    """A FileNoticeSource notice reaches `Scheduler.preempt_notice`
    through the watcher in both packages: same notice, reclaim mode,
    submits refused, and the same drain verdict."""
    got = {}
    for side in SIDES:
        s = SERVE[side]
        executors[side].faults = None
        path = str(tmp_path / f"{side}.notice")
        seen = []
        sched = bulk_scheduler(side, executors[side])
        sched.start()
        try:
            ok = sched.submit(request(side, 12, 8)).result(timeout=120)
            watcher = s.PreemptionWatcher(
                [s.FileNoticeSource(path, grace_s=9.0)], scheduler=sched,
                on_notice=seen.append, poll_s=0.01).start()
            assert watcher.check() is None
            with open(path, "w") as fh:
                json.dump({"grace_s": 4.0, "detail": "spot reclaim"}, fh)
            wait_for(lambda: bool(seen), f"{side} notice")
            watcher.stop()
            with pytest.raises(s.DrainingError):
                sched.submit(request(side, 12, 9))
            reclaim = sched.serve_stats()["preemption"]
            complete = sched.drain(grace_s=2.0)
        finally:
            sched.stop(drain=False)
        n = seen[0]
        got[side] = (ok.status, (n.source, n.grace_s, n.detail), len(seen),
                     {k: v for k, v in reclaim.items()
                      if isinstance(v, (bool, int, str))
                      and "_s" not in k}, complete)
    assert got["port"] == got["jax"]
    assert got["port"][1] == ("file", 4.0, "spot reclaim")


class _Metadata(http.server.BaseHTTPRequestHandler):
    body = b"FALSE"

    def do_GET(self):
        assert self.headers.get("Metadata-Flavor") == "Google"
        self.send_response(200)
        self.send_header("Content-Length", str(len(self.body)))
        self.end_headers()
        self.wfile.write(self.body)

    def log_message(self, *args):
        pass


def test_metadata_and_signal_sources_as_jax():
    """The metadata source polls a 127.0.0.1 stand-in (FALSE: no notice,
    TRUE: a notice, unreachable: no notice); the signal source chains
    the handler it replaced, so an owner's own SIGUSR1 handler still
    runs."""
    server = http.server.HTTPServer(("127.0.0.1", 0), _Metadata)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/preempted"
    results = {}
    try:
        for side in SIDES:
            s = SERVE[side]
            src = s.MetadataNoticeSource(url=url, grace_s=7.0)
            dead = s.MetadataNoticeSource(url="http://127.0.0.1:9/x",
                                          timeout_s=0.2)
            _Metadata.body = b"FALSE"
            quiet = src.poll()
            _Metadata.body = b"TRUE\n"
            notice = src.poll()
            results[side] = [quiet, dead.poll(),
                             (notice.source, notice.grace_s, notice.detail)]
    finally:
        server.shutdown()
        server.server_close()
    assert results["port"] == results["jax"]
    assert results["port"][2] == ("metadata", 7.0, url)

    owner_calls = []
    prev = signal.signal(signal.SIGUSR1,
                         lambda signum, frame: owner_calls.append(signum))
    try:
        for side in SIDES:
            src = SERVE[side].SignalNoticeSource(grace_s=3.0).install(
                signal.SIGUSR1)
            assert src.poll() is None
            os.kill(os.getpid(), signal.SIGUSR1)
            wait_for(lambda: src.poll() is not None, f"{side} signal")
            n = src.poll()
            results[side] = (n.source, n.grace_s, n.detail)
            signal.signal(signal.SIGUSR1, src._prev_handler)
    finally:
        signal.signal(signal.SIGUSR1, prev)
    assert results["port"] == results["jax"] == \
        ("signal", 3.0, f"signal {int(signal.SIGUSR1)}")
    assert owner_calls == [signal.SIGUSR1] * 2
