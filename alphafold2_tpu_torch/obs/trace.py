"""Request-scoped tracing: follow one fold from submit to terminal
(counterpart of `alphafold2_tpu/obs/trace.py`; same JSONL schema, span
and event names, so `tools/obs_report.py` reads either package's traces).

A `Trace` is the per-request record: named spans (intervals), point
events (cache hit/miss/quarantine, coalescing), a link to a coalescing
leader's trace, and exactly one terminal `finish()`.

- zero cost when disabled: `NULL_TRACER.start_trace()` returns the
  `NULL_TRACE` singleton whose every method is a no-op and whose
  `span()` is one shared reusable context manager;
- spans cross threads: besides the `span()` context manager there are
  explicit `begin(name)`/`end(name)` for stage handoffs and
  `add_span(name, t0, t1)` for batch-level spans recorded once and
  fanned out to every member trace (`MultiTrace`);
- `finish()` is idempotent and auto-closes any still-open span (marked
  `auto_closed`), so every terminal path yields exactly one complete
  record, never an orphan;
- completed traces are emitted as one JSONL record each (`"schema": 1`,
  spans with offsets relative to trace start) and the K slowest are
  kept in a ring (`Tracer.slowest()`).

Cross-process propagation: `Trace.wire_context()` mints a
`TraceContext` (trace id + a fresh parent span id + this process's
origin) that travels as HTTP headers; the receiving process continues
the same trace via `Tracer.start_trace(request_id, context=ctx)`. Each
record's offsets stay relative to its own monotonic start.
`Tracer(origin=...)` makes trace ids globally unique (origin + a
per-boot nonce ride the id). No context goes on the wire unless tracing
is on (`NULL_TRACE.wire_context()` is None).

Span times are host-clock intervals. A span around work on the card
must end in a synchronising call (a device-to-host copy such as
`.cpu()`, or `torch.cuda.synchronize()`), or it times only the launches.
"""

from __future__ import annotations

import heapq
import itertools
import json
import os
import threading
import time
import uuid
from dataclasses import dataclass
from typing import IO, List, Optional

# the one schema tag every observability record carries (obs/export.py)
from alphafold2_tpu_torch.obs.export import SCHEMA_VERSION

_trace_counter = itertools.count()

# wire header names the trace context travels under (HttpTransport
# submit/submit_raw, PeerCacheClient fetches)
_HDR_TRACE_ID = "X-Trace-Id"
_HDR_PARENT_SPAN = "X-Parent-Span"
_HDR_ORIGIN = "X-Trace-Origin"


@dataclass(frozen=True)
class TraceContext:
    """The wire form of one cross-process trace hop: enough for the
    receiver to continue the SAME trace (trace_id), to name the exact
    sender span its segment hangs under (parent_span_id — the rpc or
    peer-fetch span the sender records with a matching `span_id`
    attr), and to attribute the hop (origin — the sender's replica
    id). Header-encoded; absent headers decode to None, so a
    peer without tracing (or a tracing-off sender) costs nothing."""

    trace_id: str
    parent_span_id: str
    origin: str = ""

    def to_headers(self) -> dict:
        h = {_HDR_TRACE_ID: self.trace_id,
             _HDR_PARENT_SPAN: self.parent_span_id}
        if self.origin:
            h[_HDR_ORIGIN] = self.origin
        return h

    @classmethod
    def from_headers(cls, headers) -> Optional["TraceContext"]:
        trace_id = headers.get(_HDR_TRACE_ID)
        if not trace_id:
            return None
        return cls(trace_id=str(trace_id),
                   parent_span_id=str(
                       headers.get(_HDR_PARENT_SPAN) or ""),
                   origin=str(headers.get(_HDR_ORIGIN) or ""))


class _NullContext:
    """Reusable no-op context manager (one instance per process)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullContext()


class _NullTrace:
    """Do-nothing stand-in so instrumented code never branches."""

    __slots__ = ()
    enabled = False
    trace_id = ""

    def wire_context(self):
        return None         # tracing off: nothing goes on the wire

    def begin(self, name):
        pass

    def end(self, name, **attrs):
        pass

    def span(self, name, **attrs):
        return _NULL_CTX

    def add_span(self, name, t0, t1, **attrs):
        pass

    def event(self, name, **attrs):
        pass

    def link(self, leader_trace_id):
        pass

    def finish(self, status, source="fold", error=None):
        pass

    @property
    def finished(self):
        return False


NULL_TRACE = _NullTrace()


class _SpanContext:
    __slots__ = ("_trace", "_name", "_attrs", "_t0")

    def __init__(self, trace, name, attrs):
        self._trace = trace
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._trace.add_span(self._name, self._t0, time.monotonic(),
                             **self._attrs)
        return False


class Trace:
    """One request's span tree. Thread-safe; finish() is idempotent."""

    __slots__ = ("trace_id", "request_id", "leader_trace_id", "status",
                 "source", "error", "parent_span_id", "parent_origin",
                 "_span_seq", "_hop_nonce", "_tracer", "_lock", "_t0",
                 "_t0_unix", "_end", "_spans", "_events", "_open",
                 "_finished")

    enabled = True

    def __init__(self, tracer: "Tracer", request_id: str):
        # origin-tagged tracers (one per fleet replica) mint GLOBALLY
        # unique ids — origin + a per-boot nonce ride the id, so two
        # replicas' (or a restarted replica's) local counters can
        # never collide in a merged fleet trace file. Origin-less
        # tracers keep the compact pre-fleet single-process ids.
        n = next(_trace_counter)
        origin = getattr(tracer, "origin", "")
        self.trace_id = (f"t{n}" if not origin
                         else f"t{n}.{origin}.{tracer._nonce}")
        self.request_id = request_id
        # set when this trace CONTINUES a remote hop (started with a
        # TraceContext): the sender's span this record hangs under
        self.parent_span_id: Optional[str] = None
        self.parent_origin: str = ""
        self._span_seq = itertools.count()
        self._hop_nonce: Optional[str] = None   # minted on first hop
        self.leader_trace_id: Optional[str] = None
        self.status: Optional[str] = None
        self.source = "fold"
        self.error: Optional[str] = None
        self._tracer = tracer
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._t0_unix = time.time()
        self._end: Optional[float] = None
        self._spans: List[dict] = []
        self._events: List[dict] = []
        self._open: dict = {}          # name -> start (monotonic)
        self._finished = False

    # -- spans / events --------------------------------------------------

    def begin(self, name: str):
        """Open a span that a different thread may close (stage handoff)."""
        now = time.monotonic()
        with self._lock:
            if not self._finished:
                self._open[name] = now

    def end(self, name: str, **attrs):
        """Close a `begin()` span. Tolerant: unknown name is a no-op (the
        race where a worker resolves an entry while submit's bookkeeping
        is mid-flight must never raise into serving)."""
        now = time.monotonic()
        with self._lock:
            t0 = self._open.pop(name, None)
            if t0 is None or self._finished:
                return
            self._append_span(name, t0, now, attrs)

    def span(self, name: str, **attrs) -> _SpanContext:
        """Same-thread scope: `with trace.span("fold"): ...`."""
        return _SpanContext(self, name, attrs)

    def add_span(self, name: str, t0: float, t1: float, **attrs):
        """Record a finished interval (batch-level spans measured once
        and fanned out to every member trace)."""
        with self._lock:
            if not self._finished:
                self._append_span(name, t0, t1, attrs)

    def _append_span(self, name, t0, t1, attrs):
        """Caller holds self._lock."""
        dur = max(t1 - t0, 0.0)
        # a REAL (positive) interval must never round to zero: spans
        # are emitted at microsecond resolution, and a sub-microsecond
        # fold (a stub executor, a trivially small batch) rounding to
        # 0.0 trips obs_report --check's "accelerator-served request
        # with no non-zero fold span" rule — the pre-existing
        # zero-duration-span flake. Clamp to one emission
        # quantum; a genuinely empty interval (t1 == t0) stays 0.0.
        span = {"name": name,
                "start_s": round(t0 - self._t0, 6),
                "dur_s": round(dur, 6) if dur >= 5e-7
                else (1e-6 if dur > 0.0 else 0.0)}
        if attrs:
            span["attrs"] = attrs
        self._spans.append(span)

    def event(self, name: str, **attrs):
        now = time.monotonic()
        with self._lock:
            if self._finished:
                return
            ev = {"name": name, "at_s": round(now - self._t0, 6)}
            if attrs:
                ev["attrs"] = attrs
            self._events.append(ev)

    def link(self, leader_trace_id: str):
        """Follower -> leader edge (coalesced requests)."""
        with self._lock:
            self.leader_trace_id = leader_trace_id

    def wire_context(self) -> Optional[TraceContext]:
        """Mint the context for ONE outbound hop: this trace's id plus
        a fresh span id the sender tags its rpc/peer-fetch span with
        (`span_id` attr), so the receiver's continued record can name
        exactly which sender span it hangs under. One context per hop
        — two forwards from one trace get two parent span ids. The
        per-Trace-OBJECT nonce keeps ids unique when one replica
        continues the SAME trace twice (a failover retry looping back
        after a restart): each continuation is a fresh Trace whose
        counter restarts at 0, and two hops both named (origin, "s0")
        would stitch ambiguously in the fleet aggregator."""
        with self._lock:
            if self._finished:
                return None
            if self._hop_nonce is None:
                self._hop_nonce = uuid.uuid4().hex[:4]
            sid = f"s{next(self._span_seq)}.{self._hop_nonce}"
        return TraceContext(trace_id=self.trace_id, parent_span_id=sid,
                            origin=getattr(self._tracer, "origin", ""))

    # -- terminal --------------------------------------------------------

    @property
    def finished(self) -> bool:
        with self._lock:
            return self._finished

    def finish(self, status: str, source: str = "fold",
               error: Optional[str] = None):
        """Terminal state; first call wins, later calls are no-ops.
        Auto-closes open spans so a trace can never leak an orphan."""
        now = time.monotonic()
        with self._lock:
            if self._finished:
                return
            self._finished = True
            self.status = status
            self.source = source
            self.error = error
            self._end = now
            for name, t0 in sorted(self._open.items(), key=lambda kv: kv[1]):
                self._append_span(name, t0, now, {"auto_closed": True})
            self._open.clear()
            record = self._record_locked()
        self._tracer._on_finish(record)

    def _record_locked(self) -> dict:
        record = {
            "schema": SCHEMA_VERSION,
            "trace_id": self.trace_id,
            "request_id": self.request_id,
            "status": self.status,
            "source": self.source,
            "start_unix_s": round(self._t0_unix, 6),
            "duration_s": round((self._end or self._t0) - self._t0, 6),
            "spans": list(self._spans),
            "events": list(self._events),
        }
        origin = getattr(self._tracer, "origin", "")
        if origin:
            record["origin"] = origin
        if self.parent_span_id:
            # the per-replica hop edge: which sender span (and whose)
            # this record's segments continue — the fleet aggregator
            # anchors child offsets at that span, never at wall clocks
            record["parent_span_id"] = self.parent_span_id
            if self.parent_origin:
                record["parent_origin"] = self.parent_origin
        if self.leader_trace_id is not None:
            record["leader_trace_id"] = self.leader_trace_id
        if self.error:
            record["error"] = str(self.error)
        return record

    def record(self) -> dict:
        """Snapshot of the (possibly unfinished) trace."""
        with self._lock:
            return self._record_locked()


class MultiTrace:
    """Fan one measurement out to many traces (a batch's members).

    The interval is measured ONCE (one clock read per edge) and appended
    to each member, so per-request cost stays O(1) appends."""

    __slots__ = ("_traces",)

    enabled = True

    def __init__(self, traces):
        self._traces = [t for t in traces if t.enabled]

    def span(self, name, **attrs):
        return _MultiSpanContext(self._traces, name, attrs)

    def add_span(self, name, t0, t1, **attrs):
        for t in self._traces:
            t.add_span(name, t0, t1, **attrs)

    def event(self, name, **attrs):
        for t in self._traces:
            t.event(name, **attrs)


class _MultiSpanContext:
    __slots__ = ("_traces", "_name", "_attrs", "_t0")

    def __init__(self, traces, name, attrs):
        self._traces = traces
        self._name = name
        self._attrs = attrs

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        t1 = time.monotonic()
        for t in self._traces:
            t.add_span(self._name, self._t0, t1, **self._attrs)
        return False


class _NullTracer:
    __slots__ = ()
    enabled = False
    origin = ""

    def start_trace(self, request_id, context=None):
        return NULL_TRACE

    def slowest(self):
        return []

    def _on_finish(self, record):
        pass

    def close(self):
        pass


NULL_TRACER = _NullTracer()


class Tracer:
    """Trace factory + sink: JSONL emission and a slowest-K ring.

    jsonl_path: append one record per completed trace (schema above);
        None disables the file sink (the ring still works).
    slow_k: how many slowest completed traces to retain for
        `slowest()`.
    origin: this process's replica id for fleet-wide stitching.
        When set, trace ids become globally unique
        (origin + a per-boot nonce ride the id), every emitted record
        carries an `origin` field, and outbound wire contexts name
        this replica as the hop's sender. "" (the default) is the
        single-process behavior.
    """

    enabled = True

    def __init__(self, jsonl_path: Optional[str] = None, slow_k: int = 16,
                 origin: str = ""):
        self.origin = str(origin)
        # per-boot nonce: a RESTARTED replica reuses its origin id but
        # must never reuse the dead boot's trace ids (its counter
        # restarts at 0)
        self._nonce = uuid.uuid4().hex[:6]
        self._lock = threading.Lock()
        self._fh: Optional[IO] = None
        if jsonl_path:
            d = os.path.dirname(os.path.abspath(jsonl_path))
            os.makedirs(d, exist_ok=True)
            self._fh = open(jsonl_path, "a")
        self.slow_k = max(0, int(slow_k))
        self._seq = itertools.count()   # heap tie-break, never compares dicts
        self._slow: list = []           # min-heap of (duration, seq, record)
        self.completed = 0

    def start_trace(self, request_id: str,
                    context: Optional[TraceContext] = None) -> Trace:
        """Start a trace; with `context` (a remote hop's wire headers,
        decoded by the receiving server) the new trace CONTINUES the
        sender's — same trace id, and the emitted record names the
        sender span it hangs under (`parent_span_id`/`parent_origin`)
        so the fleet aggregator can stitch the two halves into one
        waterfall."""
        t = Trace(self, request_id)
        if context is not None:
            t.trace_id = context.trace_id
            t.parent_span_id = context.parent_span_id or None
            t.parent_origin = context.origin
        return t

    def _on_finish(self, record: dict):
        # serialize OUTSIDE the lock: finish() runs on the serving
        # resolve path, and every completing request contends on this
        # one lock with serve_stats()
        try:
            line = json.dumps(record) if self._fh is not None else None
        except Exception:
            line = None     # unserializable span attr: keep the ring
        try:
            with self._lock:
                self.completed += 1
                if self.slow_k:
                    item = (record["duration_s"], next(self._seq), record)
                    if len(self._slow) < self.slow_k:
                        heapq.heappush(self._slow, item)
                    elif item[0] > self._slow[0][0]:
                        heapq.heapreplace(self._slow, item)
                if line is not None and self._fh is not None:
                    self._fh.write(line + "\n")
                    self._fh.flush()
        except Exception:
            pass        # the trace sink is observability, not serving

    def slowest(self) -> List[dict]:
        """Completed traces, slowest first."""
        with self._lock:
            return [rec for _, _, rec in
                    sorted(self._slow, key=lambda it: -it[0])]

    def close(self):
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.flush()
                    self._fh.close()
                finally:
                    self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
