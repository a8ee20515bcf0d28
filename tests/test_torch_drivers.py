"""The port's serving tools against the JAX package's, on the CPU:
`obs_report` and `obs_fleet` (the same output on the same records, and
each package's `--check` passes on the other's trace files),
`cache_warm` (the synthetic profile is byte-equal, and a warm made by
the port is a hit for the JAX `FoldCache`), `bulk_submit` (both clients
against one port front door record the same fold keys and owners),
`serve_smoke.sh` at a tiny size, and the load test's multi-process mode.
"""

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from alphafold2_tpu import obs as jax_obs
from alphafold2_tpu.cache import FoldCache as JaxFoldCache
from alphafold2_tpu.cache import fold_key as jax_fold_key
from alphafold2_tpu_torch import fleet as pt_fleet
from alphafold2_tpu_torch import obs as pt_obs
from alphafold2_tpu_torch import serve as pt_serve
from alphafold2_tpu_torch.fleet.procfleet import replica_model
from alphafold2_tpu_torch.tools import bulk_submit as pt_bulk
from alphafold2_tpu_torch.tools import cache_warm as pt_warm
from alphafold2_tpu_torch.tools import obs_fleet as pt_fleet_obs
from alphafold2_tpu_torch.tools import obs_report as pt_report
from alphafold2_tpu_torch.tools import serve_loadtest as pt_lt
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tools():
    return {name: load_jax_tool(name) for name in
            ("obs_report", "obs_fleet", "cache_warm", "bulk_submit")}


def run_main(main, argv):
    """(exit code, stdout) of one in-process run."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


# -- records ------------------------------------------------------------

def fleet_records():
    """A client hop, the replica continuing it, a step-scheduled fold
    with kernel and occupancy attrs, a coalesced follower, and one
    request that failed."""
    client = {"schema": 1, "trace_id": "T1", "request_id": "req-1",
              "status": "ok", "source": "forwarded", "origin": "client",
              "duration_s": 1.0, "start_unix_s": 10.0,
              "spans": [{"name": "rpc", "start_s": 0.1, "dur_s": 0.8,
                         "attrs": {"peer": "http://r0", "route": "submit",
                                   "outcome": "ok", "span_id": "s0"}}],
              "events": []}
    replica = {"schema": 1, "trace_id": "T1", "request_id": "req-1",
               "status": "ok", "source": "fold", "origin": "r0",
               "duration_s": 0.6, "start_unix_s": 10.2,
               "parent_span_id": "s0", "parent_origin": "client",
               "spans": [{"name": "queue", "start_s": 0.0, "dur_s": 0.1},
                         {"name": "fold", "start_s": 0.1, "dur_s": 0.4,
                          "attrs": {"mesh": "1x1",
                                    "kernel": "blocksparse"}}],
               "events": []}
    stepped = {"schema": 1, "trace_id": "T2", "request_id": "req-2",
               "status": "ok", "source": "fold", "origin": "r1",
               "duration_s": 0.9, "start_unix_s": 11.0,
               "spans": [{"name": "submit", "start_s": 0.0, "dur_s": 0.01},
                         {"name": "fold", "start_s": 0.02, "dur_s": 0.3},
                         {"name": "recycle", "start_s": 0.33, "dur_s": 0.2,
                          "attrs": {"rows_live": 1, "rows_total": 2}},
                         {"name": "admit", "start_s": 0.55, "dur_s": 0.1,
                          "attrs": {"kernel": "dense"}}],
               "events": []}
    follower = {"schema": 1, "trace_id": "T3", "request_id": "req-3",
                "status": "ok", "source": "coalesced", "origin": "r1",
                "duration_s": 0.2, "start_unix_s": 11.1,
                "leader_trace_id": "T2",
                "spans": [{"name": "submit", "start_s": 0.0,
                           "dur_s": 0.01}], "events": []}
    failed = {"schema": 1, "trace_id": "T4", "request_id": "req-4",
              "status": "error", "source": "fold", "origin": "r1",
              "duration_s": 0.3, "start_unix_s": 12.0, "error": "boom",
              "spans": [{"name": "retry", "start_s": 0.0, "dur_s": 0.2}],
              "events": []}
    return [client, replica, stepped, follower, failed]


def prom_text(obs_pkg):
    reg = obs_pkg.MetricsRegistry()
    hist = reg.histogram("serve_request_latency_seconds", "latency",
                         ("bucket_len",))
    for v in (0.01, 0.2, 1.5):
        hist.observe(v, bucket_len="32")
    reg.gauge("slo_latency_burn_rate", "burn", ("objective",)).set(
        2.5, objective="bucket32")
    reg.counter("fleet_forwards_total", "fwd", ("peer",)).inc(3, peer="r1")
    return obs_pkg.prometheus_text(reg)


def write_jsonl(path, records):
    path.write_text("".join(json.dumps(r) + "\n" for r in records))
    return str(path)


def traced_file(obs_pkg, path):
    """Two requests traced through a package's own Tracer."""
    tracer = obs_pkg.Tracer(jsonl_path=str(path))
    for i, kernel in enumerate(("dense", "blocksparse")):
        trace = tracer.start_trace(f"req-{i}")
        with trace.span("queue"):
            pass
        with trace.span("fold", mesh="1x1", kernel=kernel):
            sum(range(1000))
        trace.event("cache", outcome="miss")
        trace.finish("ok")
    tracer.close()
    return str(path)


# -- obs_report ---------------------------------------------------------

def test_obs_report_matches_jax(jax_tools, tmp_path):
    jr = jax_tools["obs_report"]
    recs = fleet_records()
    assert pt_report.STAGE_ORDER == jr.STAGE_ORDER
    for fn in ("check_traces", "check_stage_order", "stage_stats",
               "mesh_fold_stats", "kernel_fold_stats",
               "rows_occupied_stats", "summarize"):
        assert getattr(pt_report, fn)(recs) == getattr(jr, fn)(recs), fn
    assert pt_report.render_slowest(recs, 3) == jr.render_slowest(recs, 3)
    stats = jr.stage_stats(recs)
    assert pt_report.render_waterfall(stats) == jr.render_waterfall(stats)
    assert pt_report.render_kernel_folds(jr.kernel_fold_stats(recs)) \
        == jr.render_kernel_folds(jr.kernel_fold_stats(recs))
    bad = recs + [{"schema": 1, "trace_id": "T9", "status": "ok",
                   "source": "fold", "duration_s": 0.1,
                   "spans": [{"name": "mystery", "start_s": 0.0,
                              "dur_s": 0.5}]}]
    assert pt_report.check_traces(bad) == jr.check_traces(bad) != []
    assert pt_report.check_stage_order(bad) \
        == jr.check_stage_order(bad) != []
    for text in (prom_text(pt_obs), prom_text(jax_obs), "x{a=b} 1\n"):
        assert pt_report.check_prometheus_text(text) \
            == jr.check_prometheus_text(text)
    path = write_jsonl(tmp_path / "t.jsonl", recs)
    outs = [run_main(m, [path, "--json"]) for m in (pt_report.main,
                                                     jr.main)]
    assert outs[0] == outs[1] and outs[0][0] == 0


def test_obs_report_check_crosses_packages(jax_tools, tmp_path):
    jr = jax_tools["obs_report"]
    files = {"port": traced_file(pt_obs, tmp_path / "port.jsonl"),
             "jax": traced_file(jax_obs, tmp_path / "jax.jsonl")}
    proms = {"port": tmp_path / "port.prom", "jax": tmp_path / "jax.prom"}
    proms["port"].write_text(prom_text(pt_obs))
    proms["jax"].write_text(prom_text(jax_obs))
    for side in ("port", "jax"):
        for main in (pt_report.main, jr.main):
            rc, _ = run_main(main, [files[side], "--check", "--prom",
                                    str(proms[side])])
            assert rc == 0, (side, main)
    broken = write_jsonl(tmp_path / "broken.jsonl",
                         [{"schema": 1, "trace_id": "x", "spans": []}])
    assert run_main(pt_report.main, [broken, "--check"])[0] == 1


# -- obs_fleet ----------------------------------------------------------

def test_obs_fleet_matches_jax(jax_tools, tmp_path):
    jf = jax_tools["obs_fleet"]
    run = tmp_path / "run"
    (run / "r0").mkdir(parents=True)
    recs = fleet_records()
    write_jsonl(run / "client.jsonl", recs[:1])
    write_jsonl(run / "r0" / "traces.jsonl", recs[1:])
    write_jsonl(run / "controller.decisions.jsonl", [
        {"event": "reconcile", "reconcile": 1, "healthy": 2,
         "endpoints": ["a", "b"], "joined": ["r1"],
         "decision": {"action": "scale_up", "reason": "quorum"},
         "actions": [{"verb": "scale_up", "replica": "r2"}]},
        {"event": "rollout", "tag": "v2", "converged": True,
         "stragglers": []}])
    write_jsonl(run / "r0" / "keys.jsonl", [{"digest": "d", "count": 1}])
    (run / "r0.prom").write_text(prom_text(pt_obs))
    (run / "r1.prom").write_text(prom_text(jax_obs))
    texts = {"r0": prom_text(pt_obs), "r1": prom_text(jax_obs)}
    assert pt_fleet_obs.gather_paths([str(run)]) \
        == jf.gather_paths([str(run)])
    for fn in ("slo_gauge_table", "merged_latency_histogram",
               "check_identity"):
        assert getattr(pt_fleet_obs, fn)(texts) == getattr(jf, fn)(texts)
    for text in texts.values():
        assert pt_fleet_obs.parse_prometheus(text) \
            == jf.parse_prometheus(text)
    st_pt, st_jax = pt_fleet_obs.stitch(recs), jf.stitch(recs)
    assert pt_fleet_obs.check_stitches(st_pt) == jf.check_stitches(st_jax)
    assert pt_fleet_obs.per_origin_latency(recs) \
        == jf.per_origin_latency(recs)
    assert [pt_fleet_obs.render_stitched(s) for s in st_pt.values()] \
        == [jf.render_stitched(s) for s in st_jax.values()]
    outs = [run_main(m, [str(run), "--json"])
            for m in (pt_fleet_obs.main, jf.main)]
    assert outs[0] == outs[1] and outs[0][0] == 0
    # an armed hop with no child is a broken stitch in both
    lone = write_jsonl(tmp_path / "lone.jsonl", recs[:1])
    for main in (pt_fleet_obs.main, jf.main):
        assert run_main(main, [lone, "--check"])[0] == 1


def test_obs_fleet_check_crosses_packages(jax_tools, tmp_path):
    jf = jax_tools["obs_fleet"]
    files = [traced_file(pt_obs, tmp_path / "port.jsonl"),
             traced_file(jax_obs, tmp_path / "jax.jsonl")]
    for main in (pt_fleet_obs.main, jf.main):
        assert run_main(main, files + ["--check"])[0] == 0


# -- cache_warm ---------------------------------------------------------

def test_cache_warm_profile_and_entries_cross_packages(jax_tools, tmp_path):
    jw = jax_tools["cache_warm"]
    args = ["--num", "5", "--lengths", "12,17", "--msa-depth", "2",
            "--total-requests", "100"]
    for name, main in (("port", pt_warm.main), ("jax", jw.main)):
        rc, _ = run_main(main, ["--emit-synthetic",
                                str(tmp_path / f"{name}.jsonl")] + args)
        assert rc == 0
    port_profile = (tmp_path / "port.jsonl").read_bytes()
    assert port_profile == (tmp_path / "jax.jsonl").read_bytes()

    cache_dir = tmp_path / "warm"
    warm = ["--freq", str(tmp_path / "port.jsonl"), "--cache-dir",
            str(cache_dir), "--model-tag", "warm@v1", "--msa-depth", "2",
            "--top", "3", "--out-dir", str(tmp_path / "pdb"),
            "--device", "cpu"]
    rc, out = run_main(pt_warm.main, warm)
    rep = json.loads(out.splitlines()[-1])
    assert rc == 0 and rep["warmed"] == 3 and rep["realized_hit_ratio"] == 0
    rc, out = run_main(pt_warm.main, warm)
    assert json.loads(out.splitlines()[-1])["skipped_already_cached"] == 3
    # the JAX package's cache reads the port's warm as hits
    jcache = JaxFoldCache(disk_dir=str(cache_dir))
    for line in port_profile.decode().splitlines()[:3]:
        rec = json.loads(line)
        key = jax_fold_key(np.asarray(rec["seq"], np.int32),
                           np.asarray(rec["msa"], np.int32),
                           num_recycles=0, model_tag="warm@v1")
        assert jcache.get(key) is not None
    assert jcache.stats.hits == 3


def test_cache_warm_needs_a_card_by_default(tmp_path, monkeypatch):
    profile = tmp_path / "p.jsonl"
    profile.write_text(json.dumps({"seq": "MKVL", "count": 1}) + "\n")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_warm.main(["--freq", str(profile), "--out-dir",
                      str(tmp_path / "pdb")])


# -- bulk_submit --------------------------------------------------------

def test_bulk_submit_ledgers_match_jax(jax_tools, tmp_path):
    manifest = tmp_path / "proteome.fasta"
    rng = np.random.default_rng(3)
    aas = "ACDEFGHIKLMNPQRSTVWY"
    manifest.write_text("".join(
        f">s{i}\n{''.join(rng.choice(list(aas), int(n)))}\n"
        for i, n in enumerate(rng.integers(10, 16, 6))))
    model = replica_model({"dim": 32, "depth": 1}, "cpu")
    sched = pt_serve.Scheduler(
        pt_serve.FoldExecutor(model), pt_serve.BucketPolicy((16,)),
        pt_serve.SchedulerConfig(max_batch_size=2, max_wait_ms=5),
        model_tag="bulk@v1")
    doors = []
    ledgers = {}
    with sched:
        try:
            doors = [pt_fleet.FrontDoorServer(sched, replica_id=rid)
                     .start() for rid in ("r0", "r1")]
            fleet = ",".join(f"{rid}={d.url}"
                             for rid, d in zip(("r0", "r1"), doors))
            for side, main in (("port", pt_bulk.main),
                               ("jax", jax_tools["bulk_submit"].main)):
                ledgers[side] = tmp_path / f"{side}.jsonl"
                argv = [str(manifest), "--fleet", fleet, "--ledger",
                        str(ledgers[side]), "--model-tag", "bulk@v1",
                        "--poll-budget-s", "60"]
                rc, out = run_main(main, argv)
                if side == "jax" and rc == 1:
                    # the JAX client may close its ledger before the
                    # last ticket's record lands (its tickets resolve
                    # before their callbacks run); its documented
                    # remedy is a re-run, which folds only what is
                    # missing
                    rc, out = run_main(main, argv)
                assert rc == 0, out
            # a re-run finds every sequence done
            rc, out = run_main(pt_bulk.main, [
                str(manifest), "--fleet", fleet, "--ledger",
                str(ledgers["port"]), "--model-tag", "bulk@v1"])
            assert rc == 0 and "6 already done" in out
        finally:
            for d in doors:
                d.stop()

    def records(path):
        """The latest record of each sequence (the ledger's own rule)."""
        latest = {}
        for ln in path.read_text().splitlines():
            r = json.loads(ln)
            latest[r["id"]] = (r["id"], r["fold_key"], r["replica"],
                               r["status"])
        return sorted(latest.values())
    assert records(ledgers["port"]) == records(ledgers["jax"])
    assert {r[2] for r in records(ledgers["port"])} == {"r0", "r1"}
    assert {r[3] for r in records(ledgers["port"])} == {"ok"}


# -- the multi-process tier (slow) --------------------------------------

@pytest.mark.slow
def test_serve_smoke_phases_1_to_3_on_the_cpu():
    env = dict(os.environ, SMOKE_DEVICE="cpu", SMOKE_PHASES="1,2,3",
               SMOKE_DURATION_S="2")
    proc = subprocess.run(
        ["bash", str(REPO / "alphafold2_tpu_torch" / "tools"
                     / "serve_smoke.sh")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stderr.count("OBS CHECK OK") == 2


@pytest.mark.slow
def test_loadtest_procs_mode(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = pt_lt.main([
            "--device", "cpu", "--procs", "2", "--requests", "10",
            "--lengths", "20,28", "--buckets", "32", "--max-batch", "2",
            "--msa-depth", "3", "--proc-kill-at", "0.3",
            "--rollout-at", "0.6", "--proc-run-dir", str(tmp_path / "run"),
            "--trace-path", str(tmp_path / "t.jsonl"), "--smoke"])
    rep = json.loads(out.getvalue().splitlines()[-1])
    assert rc == 0, rep["failures"]
    assert rep["statuses"] == {"ok": 10} and rep["lost"] == 0
    assert rep["stale_tag_hits"] == 0
    assert set(rep["tags"].values()) == {"procfleet@v1+rolled"}
    assert rep["span_counts"]["rpc"] >= 10
    assert pt_report.main([str(tmp_path / "t.jsonl"), "--check"]) == 0
    assert sys.modules["alphafold2_tpu_torch.tools.serve_loadtest"] is pt_lt
