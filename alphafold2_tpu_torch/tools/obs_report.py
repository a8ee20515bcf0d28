"""Render a per-stage latency waterfall + slowest traces from trace JSONL
(counterpart of the JAX package's `tools/obs_report.py`; the checks, the
stage order and the report are the same, so each package's `--check`
reads the other's traces).

Input is the file `alphafold2_tpu_torch.obs.Tracer(jsonl_path=...)`
appends to (one `"schema": 1` record per completed request trace). The
report answers the two questions stage-level timing exists for:

- WHERE does a typical request spend its time? -> the waterfall:
  p50/p90/p99 per stage (submit / queue / parked / batch_form /
  compile / fold / writeback), with proportional bars;
- WHICH requests were pathological? -> top-K slowest traces with their
  span breakdown, terminal status, and leader links.

`--check` turns the report into a tripwire (serve_smoke.sh's
observability phase): exit 1 when any record is missing its schema
version, any trace is incomplete (no terminal status), any span is an
orphan (negative timing or escaping its trace's window), any span name
is absent from STAGE_ORDER (the drift tripwire — a new serving stage
must be appended to the canonical order), or any accelerator-served
request (`source == "fold"`, status ok) lacks a non-zero `fold` span.
`--prom FILE` additionally validates that a Prometheus text exposition
(obs.export.prometheus_text / serve_loadtest --prom-path) parses.

  python -m alphafold2_tpu_torch.tools.obs_report traces.jsonl
  python -m alphafold2_tpu_torch.tools.obs_report traces.jsonl --top 10
  python -m alphafold2_tpu_torch.tools.obs_report traces.jsonl \
      --check --prom metrics.prom
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from typing import List, Optional, Tuple


from alphafold2_tpu_torch.obs.export import SCHEMA_VERSION
from alphafold2_tpu_torch.utils.profiling import percentile

# canonical stage order for the waterfall; unknown span names append.
# The spans, in the order the serving stack emits them: reconcile (a
# control-plane cycle); featurize (the CPU feature stage of a raw
# submission, ahead of submit); submit, forward (the fleet routing hop)
# and rpc (one front-door HTTP hop, client-measured: the submit POST or
# the whole forwarded exchange, with the outcome/span_id attrs the
# fleet stitcher reads); queue, parked, retry (backoff before a
# re-executed batch) and drain (time a request rode a graceful drain);
# batch_form; shard (placement onto the batch's device slice); compile
# and fold (fold spans carry a `mesh` attr the per-mesh section groups
# by, and a `kernel` attr under a kernel policy); recycle (one step of
# the scheduler-owned recycle loop; the init pass stays a `fold` span);
# admit (the continuous batcher's row admission: an admitted request's
# first accelerator pass, which the accelerator-time rule below accepts
# alongside fold/compile); watchdog (the killed window of a hung
# execution) and resume (a carry-checkpoint recovery); writeback;
# peer_fetch and peer_serve (the two sides of a peer-cache fetch);
# cache_lookup and write (fold_and_write); preempt and adopt (a spot
# reclaim and the orphan adoption after it).
# --check's orphan-span rules apply to all of them unchanged, which is
# how the chaos smokes prove recovery cost is fully accounted.
#
# This tuple is LOAD-BEARING and equals the JAX package's: span names
# are an interface between the two packages. check_stage_order() below
# hard-fails --check on any span name absent from it, so adding a span
# to the serving stack without appending it here trips the very next
# smoke phase instead of silently rendering at the bottom of the
# waterfall.
STAGE_ORDER = ("reconcile", "featurize", "submit", "forward", "rpc",
               "queue", "parked", "retry", "drain", "batch_form",
               "shard", "compile", "fold", "recycle", "admit",
               "watchdog", "resume", "writeback", "peer_fetch",
               "peer_serve", "cache_lookup", "write", "preempt",
               "adopt")

# span/trace boundary slack: start_s, dur_s, and duration_s are each
# INDEPENDENTLY rounded to 1e-6 when emitted, so a span auto-closed at
# finish time can legitimately show start+dur up to 1.5e-6 past the
# trace duration (three half-ulp roundings) before float noise — 1e-6
# exactly was a latent off-by-one-rounding flake
_EPS = 2e-6


def load_traces(path: str) -> Tuple[List[dict], List[str]]:
    """Parse a trace JSONL file. Returns (records, parse_errors)."""
    records, errors = [], []
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as exc:
                errors.append(f"line {lineno}: unparseable JSON ({exc})")
    return records, errors


def check_traces(records: List[dict]) -> List[str]:
    """Structural tripwire. Returns a list of violations (empty = ok)."""
    problems = []
    for i, rec in enumerate(records):
        where = f"record {i} ({rec.get('trace_id', '?')})"
        if rec.get("schema") != SCHEMA_VERSION:
            problems.append(f"{where}: missing/unknown schema version "
                            f"{rec.get('schema')!r}")
            continue
        status = rec.get("status")
        if not status:
            problems.append(f"{where}: incomplete trace (no terminal "
                            "status)")
            continue
        duration = rec.get("duration_s", 0.0)
        if duration < 0:
            problems.append(f"{where}: negative duration {duration}")
        for span in rec.get("spans", ()):
            name = span.get("name", "?")
            t0, dur = span.get("start_s"), span.get("dur_s")
            if t0 is None or dur is None or t0 < -_EPS or dur < 0:
                problems.append(f"{where}: orphan span {name!r} "
                                f"(start={t0}, dur={dur})")
            elif t0 + dur > duration + _EPS:
                problems.append(f"{where}: span {name!r} escapes its "
                                f"trace window ({t0}+{dur} > {duration})")
        if status == "ok" and rec.get("source") == "fold":
            # admit counts as accelerator time: a row-admitted request
            # (continuous batching) gets its first pass via
            # the row-masked init executable under an `admit` span, not
            # the batch-level `fold` span its founders carry
            fold_time = sum(s.get("dur_s", 0.0)
                            for s in rec.get("spans", ())
                            if s.get("name") in ("fold", "compile",
                                                 "admit"))
            if fold_time <= 0:
                problems.append(f"{where}: served from the accelerator "
                                "but has no non-zero fold span")
    return problems


def check_stage_order(records: List[dict]) -> List[str]:
    """STAGE_ORDER drift tripwire: a span name present in
    the traces but absent from the canonical order is a HARD failure
    under --check. Every recent serving feature added a span and
    hand-appended it to STAGE_ORDER; this makes forgetting impossible
    — the new span's first smoke run fails here with the exact name to
    append instead of silently sorting to the waterfall's tail."""
    known = set(STAGE_ORDER)
    unknown = sorted({str(span.get("name", "?"))
                      for rec in records
                      for span in rec.get("spans", ())} - known)
    return [f"span name {name!r} is not in STAGE_ORDER — a new serving "
            f"stage must be appended to tools/obs_report.py's "
            f"canonical order (and documented there)"
            for name in unknown]


def stage_stats(records: List[dict]) -> dict:
    """{stage: {count, p50_s, p90_s, p99_s, total_s}} over all spans."""
    by_stage = {}
    for rec in records:
        for span in rec.get("spans", ()):
            by_stage.setdefault(span.get("name", "?"), []).append(
                float(span.get("dur_s", 0.0)))
    out = {}
    names = [s for s in STAGE_ORDER if s in by_stage]
    names += sorted(set(by_stage) - set(STAGE_ORDER))
    for name in names:
        durs = by_stage[name]
        out[name] = {"count": len(durs),
                     "p50_s": percentile(durs, 50),
                     "p90_s": percentile(durs, 90),
                     "p99_s": percentile(durs, 99),
                     "total_s": sum(durs)}
    return out


def mesh_fold_stats(records: List[dict]) -> dict:
    """Per-mesh-shape fold latency: {mesh_label: {count, p50_s, p99_s}}.
    Fold spans without a `mesh` attr (the classic single-chip executor)
    group under "1x1", so a mixed mesh-on/off trace file still separates
    1-chip from 8-chip folds. Empty when no fold spans exist."""
    by_mesh = {}
    for rec in records:
        for span in rec.get("spans", ()):
            if span.get("name") != "fold":
                continue
            mesh = (span.get("attrs") or {}).get("mesh", "1x1")
            by_mesh.setdefault(str(mesh), []).append(
                float(span.get("dur_s", 0.0)))
    return {mesh: {"count": len(durs),
                   "p50_s": percentile(durs, 50),
                   "p99_s": percentile(durs, 99)}
            for mesh, durs in sorted(by_mesh.items())}


def kernel_fold_stats(records: List[dict]) -> dict:
    """Per-attention-kernel accelerator-span latency:
    {kernel_label: {count, p50_s, p99_s}} over fold/recycle/admit spans
    (the three accelerator stages a kernel choice governs). Spans
    without a `kernel` attr (every pre-kernel-policy trace, and every
    dense fold under a policy-less scheduler) group under "dense" —
    mirrors mesh_fold_stats' "1x1" convention, so a mixed trace file
    still separates dense from block-sparse executions. Empty when no
    accelerator spans exist."""
    by_kernel = {}
    for rec in records:
        for span in rec.get("spans", ()):
            if span.get("name") not in ("fold", "recycle", "admit"):
                continue
            kern = (span.get("attrs") or {}).get("kernel", "dense")
            by_kernel.setdefault(str(kern), []).append(
                float(span.get("dur_s", 0.0)))
    return {kern: {"count": len(durs),
                   "p50_s": percentile(durs, 50),
                   "p99_s": percentile(durs, 99)}
            for kern, durs in sorted(by_kernel.items())}


def render_kernel_folds(stats: dict) -> str:
    lines = [f"{'kernel':>20}  {'spans':>6}  {'p50':>9}  {'p99':>9}"]
    for kern, s in stats.items():
        lines.append(f"{kern:>20}  {s['count']:>6}  {s['p50_s']:>9.4f}  "
                     f"{s['p99_s']:>9.4f}")
    return "\n".join(lines)


def rows_occupied_stats(records: List[dict]) -> Optional[dict]:
    """Row-occupancy read back from recycle spans' rows_live/rows_total
    attrs (the continuous batcher tags every step): the
    span-weighted mean occupancy plus the span count. None when no
    span carries the attrs (non-continuous runs). Span-weighted on
    purpose — each live element of a step carries the span, so busy
    steps weigh more; the scheduler-side
    serve_stats()["recycle"]["rows_occupied_fraction"] is the
    step-weighted truth the smoke gates on."""
    fracs = []
    for rec in records:
        for span in rec.get("spans", ()):
            if span.get("name") != "recycle":
                continue
            attrs = span.get("attrs") or {}
            live, total = attrs.get("rows_live"), attrs.get("rows_total")
            if live is not None and total:
                fracs.append(float(live) / float(total))
    if not fracs:
        return None
    return {"spans": len(fracs),
            "mean_fraction": sum(fracs) / len(fracs)}


def render_mesh_folds(stats: dict) -> str:
    lines = [f"{'mesh':>12}  {'folds':>6}  {'p50':>9}  {'p99':>9}"]
    for mesh, s in stats.items():
        lines.append(f"{mesh:>12}  {s['count']:>6}  {s['p50_s']:>9.4f}  "
                     f"{s['p99_s']:>9.4f}")
    return "\n".join(lines)


def render_waterfall(stats: dict, width: int = 40) -> str:
    """ASCII waterfall: one bar per stage, scaled to the largest p90."""
    if not stats:
        return "(no spans)"
    scale = max(s["p90_s"] for s in stats.values()) or 1.0
    lines = [f"{'stage':>12}  {'count':>6}  {'p50':>9}  {'p90':>9}  "
             f"{'p99':>9}  waterfall(p90)"]
    for name, s in stats.items():
        bar = "#" * max(1, int(round(s["p90_s"] / scale * width))) \
            if s["p90_s"] > 0 else ""
        lines.append(f"{name:>12}  {s['count']:>6}  {s['p50_s']:>9.4f}  "
                     f"{s['p90_s']:>9.4f}  {s['p99_s']:>9.4f}  {bar}")
    return "\n".join(lines)


def render_slowest(records: List[dict], top: int = 5) -> str:
    ranked = sorted(records, key=lambda r: -float(r.get("duration_s", 0)))
    lines = []
    for rec in ranked[:top]:
        spans = " ".join(
            f"{s.get('name')}={s.get('dur_s', 0.0):.4f}s"
            for s in rec.get("spans", ()))
        link = (f" leader={rec['leader_trace_id']}"
                if rec.get("leader_trace_id") else "")
        err = f" error={rec['error']!r}" if rec.get("error") else ""
        lines.append(
            f"{rec.get('duration_s', 0.0):9.4f}s  "
            f"{rec.get('trace_id', '?'):>6}  {rec.get('request_id', '?')} "
            f"[{rec.get('status')}/{rec.get('source')}]{link}  "
            f"{spans}{err}")
    return "\n".join(lines) if lines else "(no traces)"


# one sample line of Prometheus text exposition format 0.0.4
_PROM_SAMPLE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"                 # metric name
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*\})?"
    r" [-+]?(?:[0-9.eE+-]+|Inf|NaN)$")


def check_prometheus_text(text: str) -> List[str]:
    """Validate exposition text; returns violations (empty = parses)."""
    problems = []
    samples = 0
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            if not re.match(r"^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* ",
                            line):
                problems.append(f"prom line {lineno}: malformed comment "
                                f"{line!r}")
            continue
        if not _PROM_SAMPLE.match(line):
            problems.append(f"prom line {lineno}: unparseable sample "
                            f"{line!r}")
        else:
            samples += 1
    if samples == 0:
        problems.append("prom exposition has no samples")
    return problems


def summarize(records: List[dict]) -> dict:
    by_status, by_source = {}, {}
    for rec in records:
        by_status[rec.get("status")] = by_status.get(rec.get("status"),
                                                     0) + 1
        by_source[rec.get("source")] = by_source.get(rec.get("source"),
                                                     0) + 1
    durs = [float(r.get("duration_s", 0.0)) for r in records]
    return {"traces": len(records), "by_status": by_status,
            "by_source": by_source,
            "p50_s": percentile(durs, 50), "p99_s": percentile(durs, 99),
            "linked_followers": sum(1 for r in records
                                    if r.get("leader_trace_id"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace_jsonl", help="Tracer JSONL file")
    ap.add_argument("--top", type=int, default=5,
                    help="slowest traces to list")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 on schema/orphan-span/empty-fold "
                         "violations")
    ap.add_argument("--prom", default="",
                    help="also validate this Prometheus exposition file")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON summary line instead of the "
                         "human report")
    args = ap.parse_args(argv)

    records, parse_errors = load_traces(args.trace_jsonl)
    problems = list(parse_errors)
    if not records:
        problems.append(f"no trace records in {args.trace_jsonl}")
    problems += check_traces(records)
    problems += check_stage_order(records)
    if args.prom:
        try:
            with open(args.prom) as fh:
                problems += check_prometheus_text(fh.read())
        except OSError as exc:
            problems.append(f"prom file unreadable: {exc}")

    if args.json:
        out = summarize(records)
        out["stages"] = stage_stats(records)
        out["mesh_folds"] = mesh_fold_stats(records)
        out["kernel_folds"] = kernel_fold_stats(records)
        out["rows_occupied"] = rows_occupied_stats(records)
        out["problems"] = problems[:20]
        print(json.dumps(out))
    else:
        s = summarize(records)
        print(f"== {args.trace_jsonl}: {s['traces']} traces "
              f"(status {s['by_status']}, source {s['by_source']}, "
              f"{s['linked_followers']} linked followers) ==")
        print(render_waterfall(stage_stats(records)))
        mesh = mesh_fold_stats(records)
        if len(mesh) > 1 or any(m != "1x1" for m in mesh):
            print("\n-- fold latency by mesh shape --")
            print(render_mesh_folds(mesh))
        kern = kernel_fold_stats(records)
        if len(kern) > 1 or any(k != "dense" for k in kern):
            print("\n-- accelerator latency by attention kernel --")
            print(render_kernel_folds(kern))
        occ = rows_occupied_stats(records)
        if occ is not None:
            print(f"\nrows occupied (continuous batching): "
                  f"{occ['mean_fraction']:.3f} span-weighted mean over "
                  f"{occ['spans']} recycle spans")
        print(f"\n-- top {args.top} slowest --")
        print(render_slowest(records, args.top))
        if problems:
            print(f"\n-- {len(problems)} problems --")
            for p in problems[:20]:
                print(f"  {p}")

    if args.check and problems:
        print(f"OBS CHECK FAIL: {len(problems)} violations "
              f"({problems[0]})", file=sys.stderr)
        return 1
    if args.check:
        print(f"OBS CHECK OK: {len(records)} complete traces, "
              "0 orphan spans", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
