"""Parity of the port's observability (`obs/export.py`, `obs/trace.py`,
`utils/profiling.trace`) with the JAX package.

The same operations drive a JAX and a port registry or tracer, and the
records are compared after scrubbing what carries a clock or a counter
(trace ids, times): span names and order, events, status, source,
attributes and schema must be equal. `tools/obs_report.py`'s checks
read the port's output.
"""

import importlib.util
import json
import os
import threading
import time
from pathlib import Path

import pytest
import torch

from alphafold2_tpu.obs import export as jax_export
from alphafold2_tpu.obs import registry as jax_registry
from alphafold2_tpu.obs import trace as jax_trace
from alphafold2_tpu_torch.obs import export as pt_export
from alphafold2_tpu_torch.obs import registry as pt_registry
from alphafold2_tpu_torch.obs import trace as pt_trace
from alphafold2_tpu.utils import logging as jax_logging
from alphafold2_tpu_torch.utils import logging as pt_logging
from alphafold2_tpu_torch.utils import profiling as pt_profiling

REPO = Path(__file__).resolve().parent.parent


def load_obs_report():
    spec = importlib.util.spec_from_file_location(
        "obs_report", REPO / "tools" / "obs_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


obs_report = load_obs_report()


def fill_registry(registry_mod):
    reg = registry_mod.MetricsRegistry()
    c = reg.counter("fold_cache_events_total", "outcomes", ("event",))
    c.inc(event="hits")
    c.inc(3, event="misses")
    reg.gauge("fold_cache_bytes_resident", "bytes").set(1234.5)
    g = reg.gauge("loss", 'a "quoted"\nhelp', ("phase",))
    g.set(float("nan"), phase="train")
    g.set(float("inf"), phase="eval")
    h = reg.histogram("serve_latency_seconds", "latency", ("bucket",))
    for v in (0.0004, 0.003, 0.2, 5.0, 5000.0):
        h.observe(v, bucket="256")
    return reg


def test_flatten_matches_jax():
    nested = {"cache": {"disk": {"hits": 3}, "ratio": 0.5}, "n": 1,
              "deep": {"a": {"b": {"c": None}}}}
    assert pt_export.flatten(nested) == jax_export.flatten(nested)
    assert pt_export.flatten(nested, sep="/", prefix="x") == \
        jax_export.flatten(nested, sep="/", prefix="x")


def test_metrics_logger_records_match_jax(tmp_path, capsys):
    """The training logger's JSONL records and printed line carry the one
    schema and the flattened keys of `obs/export.py`, as JAX's do."""
    scalars = dict(loss=torch.tensor(0.25), lr=1e-3,
                   cache={"disk": {"hits": 3}}, note="warm")
    lines = {}
    for name, mod in (("jax", jax_logging), ("port", pt_logging)):
        path = tmp_path / name / "log.jsonl"
        logger = mod.MetricsLogger(str(path))
        logger.log(step=7, **scalars)
        logger.close()
        record = json.loads(path.read_text())
        assert record.pop("wall_s") >= 0
        lines[name] = (record, capsys.readouterr().out.split(" ", 1)[1])
    assert lines["port"] == lines["jax"]
    assert lines["port"][0]["schema"] == pt_export.SCHEMA_VERSION
    assert "cache.disk.hits=3" in lines["port"][1]


def test_prometheus_text_equals_jax_and_parses(tmp_path):
    text = pt_export.prometheus_text(fill_registry(pt_registry))
    assert text == jax_export.prometheus_text(fill_registry(jax_registry))
    assert obs_report.check_prometheus_text(text) == []
    path = tmp_path / "sub" / "metrics.prom"
    assert pt_export.write_prometheus(str(path),
                                      fill_registry(pt_registry)) == text
    assert path.read_text() == text
    assert pt_export.prometheus_text(pt_registry.MetricsRegistry()) == ""


def test_registry_json_and_jsonl_match_jax(tmp_path):
    ref = jax_export.registry_json(fill_registry(jax_registry))
    out = pt_export.registry_json(fill_registry(pt_registry))
    assert out["schema"] == ref["schema"] == pt_export.SCHEMA_VERSION == 1
    assert json.dumps(out["metrics"], sort_keys=True) == \
        json.dumps(ref["metrics"], sort_keys=True)
    path = tmp_path / "m.jsonl"
    with pt_export.JsonlExporter(str(path)) as ex:
        ex.write_registry(fill_registry(pt_registry))
        ex.write({"event": "x", "schema": 7})
    with pytest.raises(ValueError):
        ex.write({"late": True})
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [x["schema"] for x in lines] == [1, 7]
    assert json.dumps(lines[0]["metrics"], sort_keys=True) == \
        json.dumps(out["metrics"], sort_keys=True)


def scrub(record):
    """A trace record without what carries a clock or an id counter."""
    rec = dict(record)
    for key in ("trace_id", "start_unix_s", "duration_s",
                "leader_trace_id", "parent_span_id"):
        rec.pop(key, None)
    rec["spans"] = [{k: v for k, v in s.items()
                     if k not in ("start_s", "dur_s")}
                    for s in rec["spans"]]
    rec["events"] = [{k: v for k, v in e.items() if k != "at_s"}
                     for e in rec["events"]]
    return rec


def drive_tracer(trace_mod, path, origin=""):
    """One scripted life of a tracer: the span kinds, events, links, a
    batch fan-out, an auto-closed span, an error, an idempotent finish
    and a continued remote hop."""
    tracer = trace_mod.Tracer(jsonl_path=str(path), slow_k=2, origin=origin)
    a = tracer.start_trace("req-a")
    with a.span("cache_lookup", batch=2):
        a.event("cache_miss")
    a.begin("queue")
    a.end("queue", depth=3)
    a.end("never-begun")
    b = tracer.start_trace("req-b")
    b.link(a.trace_id)
    multi = trace_mod.MultiTrace([a, b, trace_mod.NULL_TRACE])
    with multi.span("fold", batch=2):
        multi.event("admitted", rows=2)
    now = time.monotonic()
    multi.add_span("write", now, now)
    a.begin("writeback")                     # left open: auto-closed
    a.finish("ok", source="fold")
    a.finish("error", error="late")          # first finish wins
    a.event("after")                         # ignored after finish
    ctx = b.wire_context()
    b.finish("error", source="cache", error="boom")
    c = tracer.start_trace("req-c", context=trace_mod.TraceContext.
                           from_headers(ctx.to_headers()))
    c.finish("ok", source="cache")
    tracer.close()
    return tracer, a, b, c, ctx


@pytest.mark.parametrize("origin", ["", "replica-1"])
def test_tracer_records_match_jax(tmp_path, origin):
    out = drive_tracer(pt_trace, tmp_path / "p.jsonl", origin)
    ref = drive_tracer(jax_trace, tmp_path / "j.jsonl", origin)
    got = [json.loads(x) for x in (tmp_path / "p.jsonl").read_text()
           .splitlines()]
    want = [json.loads(x) for x in (tmp_path / "j.jsonl").read_text()
            .splitlines()]
    assert [scrub(r) for r in got] == [scrub(r) for r in want]
    assert [r["status"] for r in got] == ["ok", "error", "ok"]
    tracer, a, b, c, ctx = out
    assert tracer.completed == ref[0].completed == 3
    assert len(tracer.slowest()) == 2
    assert a.finished and a.status == "ok"
    assert got[1]["leader_trace_id"] == a.trace_id
    assert c.trace_id == b.trace_id == ctx.trace_id
    assert got[2]["parent_span_id"] == ctx.parent_span_id
    assert origin in a.trace_id
    assert ctx.to_headers().keys() == ref[4].to_headers().keys()
    assert obs_report.check_traces(got) == []
    assert obs_report.check_stage_order(got) == []


def test_null_tracer_is_inert():
    trace = pt_trace.NULL_TRACER.start_trace("x")
    assert trace is pt_trace.NULL_TRACE and not trace.enabled
    with trace.span("fold"):
        trace.event("e")
    trace.finish("ok")
    assert trace.wire_context() is None and not trace.finished
    assert pt_trace.NULL_TRACER.slowest() == []
    assert pt_trace.TraceContext.from_headers({}) is None


def test_trace_finish_is_thread_safe(tmp_path):
    """Many threads finish and write one trace at once: exactly one
    record, every span either in it or dropped after the finish."""
    tracer = pt_trace.Tracer(jsonl_path=str(tmp_path / "t.jsonl"))
    trace = tracer.start_trace("r")
    barrier = threading.Barrier(8)

    def worker(i):
        barrier.wait(timeout=10)
        for _ in range(50):
            trace.add_span("fold", 0.0, 0.0, worker=i)
        trace.finish("ok")

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    tracer.close()
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert len(lines) == 1 and tracer.completed == 1


def test_profiling_trace_writes_a_loadable_trace(tmp_path):
    log_dir = tmp_path / "prof"
    with pt_profiling.trace(str(log_dir)):
        with pt_profiling.annotate("af2_span"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = [f for f in os.listdir(log_dir) if f.endswith(".pt.trace.json")]
    assert len(files) == 1, os.listdir(log_dir)
    events = json.loads((log_dir / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "af2_span" for e in events)
