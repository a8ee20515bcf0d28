"""Fleet-level observability: merge N replicas' traces + metrics into
one report, and tripwire the stitching (counterpart of the JAX
package's `tools/obs_fleet.py`; it reads the traces, expositions and
decision logs of either package).

Per-replica observability (`obs_report`) explains one process.
A fleet request crosses processes — a forwarded fold, a raw job routed
by feature key, a peer-cache fetch, a transport-death failover — and
with cross-process trace propagation every hop's record
shares ONE trace id plus a `parent_span_id` naming the exact sender
span it hangs under. This tool merges the fleet's evidence and answers
the fleet-level questions:

- the K slowest STITCHED traces as cross-replica waterfalls: the root
  record's spans, with each child replica's segment anchored at the
  parent's rpc (or peer_fetch) span — child offsets stay relative to
  their own process's monotonic clock and are re-based onto the
  parent's span start, so wall clocks are never compared across hosts
  (monotonic clocks don't agree between machines; the parent's rpc
  span brackets the child by construction);
- per-replica vs fleet tail latency (grouped by each record's
  `origin`);
- the SLO attainment table: `slo_*` gauges parsed out of each
  replica's Prometheus exposition (`GET /metrics` scrape files), plus
  fleet-merged per-bucket latency histograms (the fixed exponential
  buckets merge bucket-for-bucket across processes);
- the CONTROLLER section: `*decisions.jsonl` records from
  `FleetController` render as why-the-fleet-scaled — every non-hold
  action with its recorded reason, membership churn (joined / left /
  TTL-swept), rollout convergence verdicts, stale scrapes refused,
  warm submissions;
- `--check`: exit 1 on a BROKEN STITCH — a hop that armed stitching
  (an rpc span carrying a `span_id` that completed `outcome="ok"`, or
  a peer_fetch hit) with no child record continuing that span — on a
  failover span left open (an `rpc`/`forward` span auto-closed at
  finish instead of explicitly ended with an outcome: a failover
  that leaves its hop dangling), on an IDENTITY violation (an exposition whose
  `fleet_replica_identity` doesn't pin exactly one live
  (replica_id, model_tag, incarnation) series at 1, or one replica_id
  scraped under two different incarnations — the stale-scrape hazard
  a controller must never act on), and on every per-replica violation
  obs_report --check would flag (schema, orphan spans, STAGE_ORDER
  drift, prom parse).

Inputs are files or directories: directories are scanned recursively
for `*.jsonl` trace files and `*.prom` exposition files — point it at
a `ProcFleet` run dir (each replica's `<rid>/traces.jsonl`) and the
`--obs-fleet-out` scrape dir, or pass one pre-merged trace file.
`keys.jsonl` (scheduler key-frequency telemetry) and `*decisions.jsonl`
(controller decisions) are routed to their own parsers, never the
trace parser. `--scrape URL,...` additionally pulls live
`<url>/metrics` endpoints.

  python -m alphafold2_tpu_torch.tools.obs_fleet procfleet_run --check
  python -m alphafold2_tpu_torch.tools.obs_fleet merged.jsonl \
      --prom-dir scrapes/ --top 5
  python -m alphafold2_tpu_torch.tools.obs_fleet run/ \
      --scrape http://127.0.0.1:8701 --json
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, List, Tuple

from alphafold2_tpu_torch.tools import obs_report
from alphafold2_tpu_torch.utils.profiling import percentile

# hop arming rules: (span name, outcome attr values) whose presence of
# a span_id attr promises a child record in a fleet-wide trace set.
# rpc "ok": the owner answered a terminal result, so its tracer (the
# aggregator's input is the whole fleet's trace dirs) emitted the
# continued record. transport_death/poll_exhausted/cancelled hops make
# no such promise — the owner may have died before finishing anything.
_STITCH_SPAN_OUTCOMES = {"rpc": ("ok",)}
# peer_fetch is an EVENT on the client side (the span wraps it one
# level up in cache.store); a "hit" proves the serving peer answered
_STITCH_EVENT_OUTCOMES = {"peer_fetch": ("hit",)}


# -- input gathering -----------------------------------------------------


def _classify_jsonl(name: str) -> str:
    """Not every fleet JSONL is a trace file: the controller's decision
    log (`*decisions.jsonl`) and the scheduler's key-frequency records
    (`keys.jsonl`) live in the same run dir and would otherwise be fed
    to the trace parser as schema violations."""
    if name == "keys.jsonl" or name.endswith(".keys.jsonl"):
        return "keys"
    if name.endswith("decisions.jsonl"):
        return "decisions"
    return "trace"


def gather_paths(paths: List[str]
                 ) -> Tuple[List[str], List[str], List[str], List[str]]:
    """(trace_jsonl_files, prom_files, decision_files, key_files) from
    a mix of files and dirs."""
    traces, proms, decisions, keys = [], [], [], []
    by_kind = {"trace": traces, "decisions": decisions, "keys": keys}
    for p in paths:
        if os.path.isdir(p):
            for root, _dirs, files in os.walk(p):
                for f in sorted(files):
                    full = os.path.join(root, f)
                    if f.endswith(".jsonl"):
                        by_kind[_classify_jsonl(f)].append(full)
                    elif f.endswith(".prom"):
                        proms.append(full)
        elif p.endswith(".prom"):
            proms.append(p)
        else:
            by_kind[_classify_jsonl(os.path.basename(p))].append(p)
    return traces, proms, decisions, keys


def load_all_traces(files: List[str]) -> Tuple[List[dict], List[str]]:
    """Merged, de-duplicated records. Duplicates happen by design: a
    ProcFleet run dir holds each replica's own JSONL and the load test
    may also have merged them into one file — feeding both must not
    double-count a record."""
    records, problems, seen = [], [], set()
    for path in files:
        try:
            recs, errors = obs_report.load_traces(path)
        except OSError as exc:
            problems.append(f"{path}: unreadable ({exc})")
            continue
        problems += [f"{path}: {e}" for e in errors]
        for rec in recs:
            key = (rec.get("trace_id"), rec.get("origin", ""),
                   rec.get("request_id"), rec.get("start_unix_s"),
                   rec.get("duration_s"))
            if key in seen:
                continue
            seen.add(key)
            records.append(rec)
    return records, problems


def scrape_metrics(urls: List[str], timeout_s: float = 5.0
                   ) -> Tuple[Dict[str, str], List[str]]:
    """GET <url>/metrics for each url; {url: text}, problems."""
    from urllib import request as urlrequest

    out, problems = {}, []
    for url in urls:
        target = url.rstrip("/") + "/metrics"
        try:
            with urlrequest.urlopen(target, timeout=timeout_s) as resp:
                out[url] = resp.read().decode("utf-8")
        except Exception as exc:
            problems.append(f"scrape {target}: {exc!r}")
    return out, problems


# -- Prometheus text parsing ---------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, List[Tuple[dict, float]]]:
    """{metric_name: [(labels, value), ...]} — enough structure to read
    gauges back and merge histogram `_bucket` series; not a full
    client. Unparseable values are skipped (the exposition is already
    format-validated by obs_report.check_prometheus_text)."""
    out: Dict[str, List[Tuple[dict, float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels = {k: v.replace(r"\"", '"').replace(r"\\", "\\")
                  for k, v in _LABEL_RE.findall(m.group("labels") or "")}
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


def slo_gauge_table(prom_by_source: Dict[str, str]) -> dict:
    """{objective: {source: {gauge_suffix: value}}} over every slo_*
    gauge in every exposition — the per-replica SLO attainment table."""
    table: dict = {}
    for source, text in prom_by_source.items():
        parsed = parse_prometheus(text)
        for name, samples in parsed.items():
            if not name.startswith("slo_"):
                continue
            for labels, value in samples:
                objective = labels.get("objective", "?")
                table.setdefault(objective, {}).setdefault(
                    source, {})[name[len("slo_"):]] = value
    return table


def merged_latency_histogram(prom_by_source: Dict[str, str]) -> dict:
    """Fleet-merged `serve_request_latency_seconds` buckets: the fixed
    exponential edges merge bucket-for-bucket across processes.
    {bucket_len: {"count": n, "buckets": {le: cum}}}."""
    merged: dict = {}
    for text in prom_by_source.values():
        parsed = parse_prometheus(text)
        for labels, value in parsed.get(
                "serve_request_latency_seconds_bucket", []):
            bucket_len = labels.get("bucket_len", "?")
            le = labels.get("le", "+Inf")
            slot = merged.setdefault(bucket_len,
                                     {"count": 0, "buckets": {}})
            slot["buckets"][le] = slot["buckets"].get(le, 0) + value
        for labels, value in parsed.get(
                "serve_request_latency_seconds_count", []):
            bucket_len = labels.get("bucket_len", "?")
            slot = merged.setdefault(bucket_len,
                                     {"count": 0, "buckets": {}})
            slot["count"] += value
    return merged


# -- controller decisions ------------------------------------------------


def load_decisions(files: List[str]) -> Tuple[List[dict], List[str]]:
    """Controller decision JSONL records (controlplane.FleetController
    `_log` output), merged in file order; torn lines are problems."""
    records, problems = [], []
    for path in files:
        try:
            with open(path) as fh:
                for lineno, line in enumerate(fh, 1):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        problems.append(
                            f"{path}:{lineno}: torn decision record")
                        continue
                    if not isinstance(rec, dict) or "event" not in rec:
                        problems.append(
                            f"{path}:{lineno}: decision record without "
                            f"an event field")
                        continue
                    records.append(rec)
        except OSError as exc:
            problems.append(f"{path}: unreadable ({exc})")
    return records, problems


def controller_summary(decisions: List[dict]) -> dict:
    """Why the fleet scaled, from the decision log: reconcile count,
    every non-hold action with its recorded reason, membership churn,
    rollout verdicts, warming volume."""
    recs = [d for d in decisions if d.get("event") == "reconcile"]
    actions = []
    for d in recs:
        for act in d.get("actions", ()):
            actions.append({"reconcile": d.get("reconcile"),
                            "verb": act.get("verb"),
                            "replica": act.get("replica"),
                            "error": act.get("error"),
                            "reason": (d.get("decision") or {}
                                       ).get("reason", "")})
    replicas_over_time = [
        {"reconcile": d.get("reconcile"),
         "healthy": d.get("healthy"),
         "endpoints": len(d.get("endpoints", ()))}
        for d in recs]
    return {
        "reconciles": len(recs),
        "errors": sum(1 for d in decisions
                      if d.get("event") == "reconcile_error"),
        "actions": actions,
        "joined": sorted({r for d in recs for r in d.get("joined", ())}),
        "left": sorted({r for d in recs for r in d.get("left", ())}),
        "swept": sorted({r for d in recs for r in d.get("swept", ())}),
        "stale_scrapes": sum(int(d.get("stale_scrapes", 0))
                             for d in recs),
        "warm_submissions": sum(int(d.get("warm_submissions", 0))
                                for d in recs),
        "resizes": sum(len(d.get("resized", {})) for d in recs),
        "rollouts": [{"tag": d.get("tag"),
                      "converged": d.get("converged"),
                      "stragglers": d.get("stragglers")}
                     for d in decisions if d.get("event") == "rollout"],
        "replicas_over_time": replicas_over_time,
    }


# -- identity consistency ------------------------------------------------


def check_identity(prom_by_source: Dict[str, str]) -> List[str]:
    """The stale-scrape tripwire: each exposition
    that exports `fleet_replica_identity` must pin EXACTLY ONE
    (replica_id, model_tag, incarnation) series at value 1 — that's the
    contract controlplane.parse_identity relies on to refuse acting on
    a mismatched scrape. Across the merged set, one replica_id showing
    two different incarnations means the input mixes scrapes of two
    lives of the same replica — a controller fed this set could act on
    the dead incarnation's numbers."""
    problems = []
    active: Dict[str, Dict[str, str]] = {}   # replica_id -> {inc: src}
    for source, text in sorted(prom_by_source.items()):
        samples = parse_prometheus(text).get("fleet_replica_identity")
        if samples is None:
            continue           # pre-fleet exposition: nothing to pin
        ones = [labels for labels, value in samples if value == 1.0]
        if len(ones) != 1:
            problems.append(
                f"{source}: fleet_replica_identity has {len(ones)} "
                f"series at value 1 (want exactly 1) — the scrape "
                f"does not name a single live incarnation")
            continue
        labels = ones[0]
        rid = labels.get("replica_id", "?")
        inc = labels.get("incarnation", "?")
        prev = active.setdefault(rid, {})
        if inc not in prev and prev:
            others = ", ".join(
                f"{i} ({src})" for i, src in sorted(prev.items()))
            problems.append(
                f"{source}: replica_id {rid!r} incarnation {inc!r} "
                f"conflicts with {others} — the input mixes scrapes "
                f"from different lives of the same replica (stale "
                f"scrape hazard)")
        prev.setdefault(inc, os.path.basename(str(source)))
    return problems


# -- stitching -----------------------------------------------------------


def _armed_hops(rec: dict) -> List[dict]:
    """Every hop in `rec` that promised a child record: spans/events
    carrying a span_id whose outcome is in the arming table. Each hop:
    {span_id, kind, name, outcome, anchor_start_s}."""
    hops = []
    for span in rec.get("spans", ()):
        attrs = span.get("attrs") or {}
        sid = attrs.get("span_id")
        outcomes = _STITCH_SPAN_OUTCOMES.get(span.get("name"))
        if sid and outcomes and attrs.get("outcome") in outcomes:
            hops.append({"span_id": str(sid), "kind": "span",
                         "name": span.get("name"),
                         "outcome": attrs.get("outcome"),
                         "anchor_start_s": float(
                             span.get("start_s", 0.0))})
    for ev in rec.get("events", ()):
        attrs = ev.get("attrs") or {}
        sid = attrs.get("span_id")
        outcomes = _STITCH_EVENT_OUTCOMES.get(ev.get("name"))
        if sid and outcomes and attrs.get("outcome") in outcomes:
            hops.append({"span_id": str(sid), "kind": "event",
                         "name": ev.get("name"),
                         "outcome": attrs.get("outcome"),
                         "anchor_start_s": float(ev.get("at_s", 0.0))})
    return hops


def _anchor_for(rec: dict, span_id: str) -> float:
    """Offset (in `rec`'s own timeline) a child continuing `span_id`
    anchors at: the tagged span's start when present, else the tagged
    event's time, else 0 — never a cross-host wall-clock delta."""
    for span in rec.get("spans", ()):
        if (span.get("attrs") or {}).get("span_id") == span_id:
            return float(span.get("start_s", 0.0))
    for ev in rec.get("events", ()):
        if (ev.get("attrs") or {}).get("span_id") == span_id:
            return float(ev.get("at_s", 0.0))
    return 0.0


class StitchedTrace:
    """One trace id's records assembled into a parent→children tree.

    Hop edges are keyed by (sender origin, span id), not span id
    alone: each process's continued trace mints its own s0, s1, ...
    sequence, so a 3-hop trace (client → r0 → r1) holds two distinct
    "s0" spans — the child record's `parent_origin` names whose s0 it
    continues."""

    def __init__(self, trace_id: str, records: List[dict]):
        self.trace_id = trace_id
        self.records = records
        by_parent: Dict[tuple, List[dict]] = {}
        hop_keys = set()
        for rec in records:
            origin = str(rec.get("origin", ""))
            for span in rec.get("spans", ()):
                sid = (span.get("attrs") or {}).get("span_id")
                if sid:
                    hop_keys.add((origin, str(sid)))
            for ev in rec.get("events", ()):
                sid = (ev.get("attrs") or {}).get("span_id")
                if sid:
                    hop_keys.add((origin, str(sid)))
        self.roots, self.unanchored = [], []
        for rec in records:
            parent = rec.get("parent_span_id")
            key = (str(rec.get("parent_origin", "")), str(parent))
            if not parent:
                self.roots.append(rec)
            elif key in hop_keys:
                by_parent.setdefault(key, []).append(rec)
            else:
                # child continuing a span nobody in the set recorded —
                # its sender's trace file is missing (or torn by a
                # kill -9 before the parent finished)
                self.unanchored.append(rec)
        self.children_of = by_parent

    @property
    def hops(self) -> int:
        return len(self.records)

    @property
    def origins(self) -> List[str]:
        return sorted({rec.get("origin", "?") for rec in self.records})

    @property
    def duration_s(self) -> float:
        if self.roots:
            return max(float(r.get("duration_s", 0.0))
                       for r in self.roots)
        return max((float(r.get("duration_s", 0.0))
                    for r in self.records), default=0.0)


def stitch(records: List[dict]) -> Dict[str, StitchedTrace]:
    by_trace: Dict[str, List[dict]] = {}
    for rec in records:
        by_trace.setdefault(str(rec.get("trace_id", "?")),
                            []).append(rec)
    return {tid: StitchedTrace(tid, recs)
            for tid, recs in by_trace.items()}


def check_stitches(stitched: Dict[str, StitchedTrace]) -> List[str]:
    """The fleet tripwire: every armed hop has its child; every
    rpc/forward span was explicitly closed (an auto_closed one is the
    dangling-failover-span bug the transports exist to prevent)."""
    problems = []
    for tid, st in stitched.items():
        child_parents = {(str(rec.get("parent_origin", "")),
                          str(rec.get("parent_span_id")))
                         for rec in st.records
                         if rec.get("parent_span_id")}
        for rec in st.records:
            origin = str(rec.get("origin", ""))
            where = (f"trace {tid} "
                     f"(origin {rec.get('origin', '?')}, "
                     f"request {rec.get('request_id', '?')})")
            for hop in _armed_hops(rec):
                if (origin, hop["span_id"]) not in child_parents:
                    problems.append(
                        f"{where}: BROKEN STITCH — {hop['name']} hop "
                        f"{hop['span_id']} completed "
                        f"outcome={hop['outcome']!r} but no record "
                        f"continues it (the receiver's segments don't "
                        f"share the trace)")
            for span in rec.get("spans", ()):
                attrs = span.get("attrs") or {}
                if span.get("name") in ("rpc", "forward") \
                        and attrs.get("auto_closed"):
                    problems.append(
                        f"{where}: {span['name']} span left open "
                        f"(auto-closed at finish — a dead-owner "
                        f"exchange must be explicitly ended with an "
                        f"outcome before failover re-submits)")
        # NOTE: unanchored children (a record continuing a span no
        # merged record contains) are deliberately NOT check failures:
        # a kill -9 tears exactly this way — the victim's in-flight
        # forward completes on the owner (child record emitted) while
        # the victim's own trace never reached finish(). The chaos the
        # fleet exists to survive must not fail its own tripwire; they
        # surface as warnings + a summary count instead.
    return problems


def unanchored_warnings(stitched: Dict[str, StitchedTrace]) -> List[str]:
    out = []
    for tid, st in stitched.items():
        for rec in st.unanchored:
            out.append(
                f"trace {tid}: record from "
                f"origin {rec.get('origin', '?')} continues span "
                f"{rec.get('parent_span_id')!r} that no merged record "
                f"contains (sender's trace torn — kill -9 / timeout — "
                f"or its file missing from the input set)")
    return out


# -- views ---------------------------------------------------------------


def per_origin_latency(records: List[dict]) -> dict:
    by_origin: Dict[str, List[float]] = {}
    alldurs: List[float] = []
    for rec in records:
        d = float(rec.get("duration_s", 0.0))
        by_origin.setdefault(rec.get("origin", "?"), []).append(d)
        alldurs.append(d)
    out = {origin: {"traces": len(durs),
                    "p50_s": percentile(durs, 50),
                    "p99_s": percentile(durs, 99)}
           for origin, durs in sorted(by_origin.items())}
    out["__fleet__"] = {"traces": len(alldurs),
                        "p50_s": percentile(alldurs, 50),
                        "p99_s": percentile(alldurs, 99)}
    return out


def render_stitched(st: StitchedTrace, indent: str = "") -> List[str]:
    """Cross-replica waterfall for one stitched trace: each record's
    spans at its own offsets; child records indented under the hop
    span they continue, their offsets re-based onto the parent's
    anchor (anchor + child offset) — a display convention, not a
    clock-sync claim."""
    lines = []

    def _render_record(rec, base_s, depth):
        pad = indent + "    " * depth
        origin = str(rec.get("origin", ""))
        head = (f"{pad}[{rec.get('origin', '?')}] "
                f"{rec.get('request_id', '?')} "
                f"{rec.get('status')}/{rec.get('source')} "
                f"dur={float(rec.get('duration_s', 0.0)):.4f}s")
        lines.append(head)
        for span in rec.get("spans", ()):
            t0 = base_s + float(span.get("start_s", 0.0))
            lines.append(
                f"{pad}  {t0:9.4f}s +{float(span.get('dur_s', 0.0)):.4f}s"
                f"  {span.get('name')}")
        sids = [str(sid) for sid in
                [(s.get("attrs") or {}).get("span_id")
                 for s in rec.get("spans", ())]
                + [(e.get("attrs") or {}).get("span_id")
                   for e in rec.get("events", ())]
                if sid]
        for sid in sids:
            for child in st.children_of.get((origin, sid), ()):
                _render_record(child,
                               base_s + _anchor_for(rec, sid),
                               depth + 1)

    lines.append(f"{indent}== trace {st.trace_id}: {st.hops} hop(s) "
                 f"across {st.origins}, {st.duration_s:.4f}s ==")
    for root in (st.roots or st.records[:1]):
        _render_record(root, 0.0, 0)
    return lines


def summarize(stitched: Dict[str, StitchedTrace],
              records: List[dict]) -> dict:
    multi = [st for st in stitched.values() if st.hops > 1]
    return {
        "records": len(records),
        "traces": len(stitched),
        "stitched_traces": len(multi),
        "max_hops": max((st.hops for st in stitched.values()),
                        default=0),
        "unanchored_records": sum(len(st.unanchored)
                                  for st in stitched.values()),
        "origins": sorted({rec.get("origin", "?") for rec in records}),
    }


# -- main ----------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+",
                    help="trace JSONL files, .prom files, or dirs "
                         "(scanned recursively; e.g. a ProcFleet "
                         "run dir)")
    ap.add_argument("--prom-dir", default="",
                    help="additional dir of .prom exposition files")
    ap.add_argument("--scrape", default="",
                    help="comma-separated replica base URLs to pull "
                         "live <url>/metrics from")
    ap.add_argument("--top", type=int, default=3,
                    help="slowest stitched traces to render")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on broken stitches, open failover "
                         "spans, or any per-replica obs violation")
    ap.add_argument("--json", action="store_true",
                    help="one JSON summary line instead of the human "
                         "report")
    ap.add_argument("--since", type=float, default=None, metavar="TS",
                    help="only consider controller decision records "
                         "with ts >= TS (unix seconds) — pairs with "
                         "the controller's decision-log retention so "
                         "a long-lived fleet's report reads one "
                         "window, not the whole history")
    args = ap.parse_args(argv)

    trace_files, prom_files, decision_files, _keys = gather_paths(
        args.paths)
    if args.prom_dir:
        _t, extra, _d, _k = gather_paths([args.prom_dir])
        prom_files += extra
    records, problems = load_all_traces(trace_files)
    if not records:
        problems.append(f"no trace records under {args.paths}")
    decisions, decision_problems = load_decisions(decision_files)
    problems += decision_problems
    if args.since is not None:
        decisions = [d for d in decisions
                     if float(d.get("ts", 0)) >= args.since]

    prom_by_source: Dict[str, str] = {}
    for path in prom_files:
        try:
            with open(path) as fh:
                prom_by_source[path] = fh.read()
        except OSError as exc:
            problems.append(f"{path}: unreadable ({exc})")
    if args.scrape:
        scraped, scrape_problems = scrape_metrics(
            [u for u in args.scrape.split(",") if u])
        prom_by_source.update(scraped)
        problems += scrape_problems

    # the per-replica rules still apply to the merged set: schema,
    # orphan spans, STAGE_ORDER drift, and each exposition must parse
    problems += obs_report.check_traces(records)
    problems += obs_report.check_stage_order(records)
    for source, text in prom_by_source.items():
        problems += [f"{source}: {p}"
                     for p in obs_report.check_prometheus_text(text)]
    problems += check_identity(prom_by_source)

    stitched = stitch(records)
    stitch_problems = check_stitches(stitched)
    problems += stitch_problems
    warnings = unanchored_warnings(stitched)

    summary = summarize(stitched, records)
    latency = per_origin_latency(records)
    slo_table = slo_gauge_table(prom_by_source)
    merged_hist = merged_latency_histogram(prom_by_source)
    slowest = sorted((st for st in stitched.values() if st.hops > 1),
                     key=lambda st: -st.duration_s)[:args.top]

    ctrl = controller_summary(decisions) if decisions else None

    if args.json:
        out = dict(summary)
        out["latency_by_origin"] = latency
        out["slo"] = slo_table
        out["merged_latency_buckets"] = merged_hist
        out["broken_stitches"] = len(stitch_problems)
        if ctrl is not None:
            out["controller"] = ctrl
        out["warnings"] = warnings[:20]
        out["problems"] = problems[:20]
        print(json.dumps(out))
    else:
        print(f"== fleet: {summary['records']} records, "
              f"{summary['traces']} traces "
              f"({summary['stitched_traces']} stitched, max "
              f"{summary['max_hops']} hops) from origins "
              f"{summary['origins']} ==")
        print("\n-- latency by origin --")
        for origin, s in latency.items():
            print(f"  {origin:>12}  {s['traces']:>6} traces  "
                  f"p50 {s['p50_s']:.4f}s  p99 {s['p99_s']:.4f}s")
        if slo_table:
            print("\n-- SLO attainment (slo_* gauges per source) --")
            for objective, by_source in sorted(slo_table.items()):
                for source, gauges in sorted(by_source.items()):
                    rendered = "  ".join(
                        f"{k}={v:.3f}" for k, v in sorted(gauges.items()))
                    print(f"  {objective:>12}  "
                          f"{os.path.basename(str(source)):>16}  "
                          f"{rendered}")
        if merged_hist:
            print("\n-- fleet-merged latency buckets (requests) --")
            for bucket_len, slot in sorted(merged_hist.items()):
                print(f"  bucket {bucket_len}: "
                      f"{int(slot['count'])} served")
        if ctrl is not None:
            print(f"\n-- controller: {ctrl['reconciles']} reconciles, "
                  f"{len(ctrl['actions'])} actions, "
                  f"{ctrl['stale_scrapes']} stale scrapes refused, "
                  f"{ctrl['warm_submissions']} warm submissions, "
                  f"{ctrl['resizes']} pool resizes --")
            for act in ctrl["actions"][:20]:
                what = act["replica"] or act["error"] or "?"
                print(f"  reconcile {act['reconcile']}: "
                      f"{act['verb']} {what}  ({act['reason']})")
            for ro in ctrl["rollouts"]:
                print(f"  rollout tag={ro['tag']} "
                      f"converged={ro['converged']} "
                      f"stragglers={ro['stragglers']}")
            if ctrl["joined"] or ctrl["left"] or ctrl["swept"]:
                print(f"  membership: joined={ctrl['joined']} "
                      f"left={ctrl['left']} swept={ctrl['swept']}")
        print(f"\n-- top {args.top} slowest stitched traces --")
        if not slowest:
            print("(no multi-hop traces)")
        for st in slowest:
            print("\n".join(render_stitched(st)))
        if warnings:
            print(f"\n-- {len(warnings)} warnings (not check "
                  f"failures) --")
            for w in warnings[:20]:
                print(f"  {w}")
        if problems:
            print(f"\n-- {len(problems)} problems --")
            for p in problems[:20]:
                print(f"  {p}")

    if args.check and problems:
        print(f"OBS FLEET CHECK FAIL: {len(problems)} violations "
              f"({problems[0]})", file=sys.stderr)
        return 1
    if args.check:
        print(f"OBS FLEET CHECK OK: {summary['records']} records, "
              f"{summary['stitched_traces']} stitched traces, "
              f"0 broken stitches, all rpc/forward spans closed",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
