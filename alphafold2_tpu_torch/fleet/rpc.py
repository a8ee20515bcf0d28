"""Forwarding transport: FoldTicket semantics over a process boundary.

Until now request forwarding rode an in-process callable
(`ReplicaInfo.submit` — the peer Scheduler's bound method), which means
a replica could never actually crash, hang, or partition away from its
peers. This module makes the transport an explicit seam:

- `LocalTransport` wraps a bound `Scheduler.submit` and IS the old
  behavior — same thread, same ticket object, zero copies. The
  in-process harness (`fleet.InProcessFleet`) and every existing test
  run through it unchanged.
- `HttpTransport` speaks the `fleet.frontdoor.FrontDoorServer` protocol
  (stdlib urllib, same trust model as the peer cache tier): submit is
  one POST carrying the request as npz bytes plus QoS headers
  (priority, deadline, forwarded, model tag); the result is long-polled
  on a daemon thread and resolves the LOCAL FoldTicket, so callers
  cannot tell a remote fold from a local one. Every transport-level
  failure after a successful submit resolves the ticket as
  `status="error"` with the `rpc_transport` marker — the scheduler's
  forwarding path recognizes that marker and FAILS OVER to folding
  locally (`fleet_failovers_total`) instead of surfacing a dead owner
  to the caller. A submit-time failure raises instead, which the
  scheduler already treats as "fold locally".

Cancellation: `FoldTicket.result(timeout=)` on a forwarded ticket arms
a timeout hook; on expiry the transport sends a best-effort
POST /v1/cancel to the owner (counted in `fleet_remote_cancels_total`)
so the remote side can drop the parked result instead of holding it
until TTL.

Wire format (the request/response analog of `cache.encode_fold`):
one npz payload per direction, self-identifying, validated on decode —
a corrupt or truncated body is a transport error, never a wrong fold.
The bytes and headers equal the JAX package's (`alphafold2_tpu/fleet/
rpc.py`), so replicas of the two packages forward to each other; a
tensor on the card is copied to the host before it is encoded.
"""

from __future__ import annotations

import io
import json
import threading
import time
from typing import Optional
from urllib import error as urlerror
from urllib import parse as urlparse
from urllib import request as urlrequest

import numpy as np

from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry
from alphafold2_tpu_torch.obs.trace import NULL_TRACE, TraceContext
from alphafold2_tpu_torch.serve.request import (FoldRequest, FoldResponse,
                                                FoldTicket)

# error marker the scheduler's failover path keys off: any forwarded
# response whose error carries it means "the TRANSPORT died, not the
# fold" — retry locally, the work is still viable
RPC_TRANSPORT_MARKER = "rpc_transport"

_HDR_REQUEST_ID = "X-Request-Id"
_HDR_PRIORITY = "X-Priority"
_HDR_DEADLINE = "X-Deadline-S"
_HDR_FORWARDED = "X-Forwarded"
_HDR_TAG = "X-Model-Tag"
_HDR_STATUS = "X-Status"
_HDR_SOURCE = "X-Source"
_HDR_ATTEMPTS = "X-Attempts"
_HDR_BUCKET = "X-Bucket-Len"
_HDR_ERROR = "X-Error"
_HDR_RECYCLES = "X-Recycles"         # step-mode: iterations executed
_HDR_RECYCLE = "X-Recycle"           # progressive result: its iteration
_HDR_QOS = "X-Qos"                   # "bulk" / "express" mark the
#                                      non-default tiers (absent ==
#                                      "online", so the bulk-less
#                                      wire is unchanged)
# cascade provenance — all absent outside a cascade, so the
# pre-cascade response wire is byte-identical
_HDR_TIER = "X-Tier"
_HDR_ESCALATED = "X-Escalated"
_HDR_CONFIDENCE = "X-Confidence-Score"


# -- wire format ---------------------------------------------------------

def _host(x, dtype) -> np.ndarray:
    """`x` as a host numpy array of `dtype`: a tensor (on the card or
    the CPU) is detached and copied to the host first."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
        x = x.float() if dtype == np.float32 else x
        x = x.numpy()
    return np.asarray(x, dtype)


def encode_request(request: FoldRequest) -> bytes:
    """One FoldRequest as npz bytes (seq + optional msa); QoS travels
    in headers, content in the body — the body alone is content-
    addressable the same way fold_key sees it."""
    buf = io.BytesIO()
    arrays = {"seq": _host(request.seq, np.int32)}
    if request.msa is not None:
        arrays["msa"] = _host(request.msa, np.int32)
    np.savez(buf, **arrays)
    return buf.getvalue()


def request_headers(request: FoldRequest, tag: str = "",
                    context: Optional[TraceContext] = None) -> dict:
    h = {_HDR_REQUEST_ID: request.request_id,
         _HDR_PRIORITY: str(int(request.priority)),
         _HDR_FORWARDED: "1" if request.forwarded else "0",
         "Content-Type": "application/octet-stream"}
    if request.deadline_s is not None:
        h[_HDR_DEADLINE] = repr(float(request.deadline_s))
    if getattr(request, "qos", "online") != "online":
        h[_HDR_QOS] = request.qos
    if tag:
        h[_HDR_TAG] = tag
    if context is not None:
        # cross-process trace propagation: the receiving
        # front door continues the SAME trace; absent when tracing is
        # off, so the off-switch leaves the wire byte-identical
        h.update(context.to_headers())
    return h


def decode_request(body: bytes, headers) -> FoldRequest:
    """Parse + validate a submit body/headers into a FoldRequest.
    Raises ValueError on anything wrong; the server turns that into a
    400, never a fold of garbage."""
    try:
        with np.load(io.BytesIO(body)) as z:
            seq = np.asarray(z["seq"], np.int32)
            msa = (np.asarray(z["msa"], np.int32)
                   if "msa" in z.files else None)
    except Exception as exc:
        raise ValueError(f"unreadable request body: {exc!r}")
    deadline = headers.get(_HDR_DEADLINE)
    kwargs = {}
    rid = headers.get(_HDR_REQUEST_ID)
    if rid:
        kwargs["request_id"] = rid
    # an unknown qos raises ValueError from FoldRequest itself -> 400
    return FoldRequest(
        seq=seq, msa=msa,
        priority=int(headers.get(_HDR_PRIORITY, "0") or 0),
        deadline_s=None if deadline is None else float(deadline),
        forwarded=headers.get(_HDR_FORWARDED, "0") == "1",
        qos=headers.get(_HDR_QOS) or "online",
        **kwargs)


def encode_raw_request(raw) -> tuple:
    """(body, headers) for one RAW submission (serve.features.
    RawFoldRequest): a JSON body — raw sequences are strings, which is
    exactly what JSON is for — with the same QoS headers as the token
    path plus Content-Type application/json, which is how the front
    door tells the two apart. Token-array inputs travel as int lists
    (the body stays self-contained; featurization happens replica-side
    either way)."""
    seq = raw.seq
    payload = {"seq": seq if isinstance(seq, str)
               else _host(seq, np.int32).tolist()}
    if raw.msa is not None:
        msa = raw.msa
        if not isinstance(msa, np.ndarray) and len(msa) > 0 \
                and all(isinstance(r, str) for r in msa):
            payload["msa"] = list(msa)
        else:
            payload["msa"] = _host(msa, np.int32).tolist()
    body = json.dumps(payload).encode("utf-8")
    headers = {_HDR_REQUEST_ID: raw.request_id,
               _HDR_PRIORITY: str(int(raw.priority)),
               _HDR_FORWARDED: "1" if raw.forwarded else "0",
               "Content-Type": "application/json"}
    if raw.deadline_s is not None:
        headers[_HDR_DEADLINE] = repr(float(raw.deadline_s))
    if getattr(raw, "qos", "online") != "online":
        headers[_HDR_QOS] = raw.qos
    return body, headers


def decode_raw_request(body: bytes, headers):
    """Parse + validate a raw (JSON) submit body into a
    serve.features.RawFoldRequest. Raises ValueError on anything wrong;
    the server turns that into a 400, never a featurize of garbage."""
    from alphafold2_tpu_torch.serve.features import RawFoldRequest

    try:
        payload = json.loads(body.decode("utf-8"))
        seq = payload["seq"]
        # every malformed-content failure must surface as ValueError —
        # np.asarray raises TypeError on null/dict payloads, and a
        # TypeError escaping here turns a bad CLIENT payload into a
        # 500 that failover layers would retry across the whole fleet
        if not isinstance(seq, str):
            seq = np.asarray(seq, np.int32)
            if seq.ndim != 1 or seq.shape[0] == 0:
                raise ValueError(
                    f"raw seq must be a string or non-empty 1-D token "
                    f"list, got shape {seq.shape}")
        msa = payload.get("msa")
        if msa is not None and not (
                isinstance(msa, list) and msa
                and all(isinstance(r, str) for r in msa)):
            msa = np.asarray(msa, np.int32)
            if msa.ndim != 2:
                raise ValueError(
                    f"raw msa must be aligned strings or a 2-D token "
                    f"list, got shape {msa.shape}")
    except ValueError:
        raise
    except Exception as exc:
        raise ValueError(f"unreadable raw request body: {exc!r}")
    deadline = headers.get(_HDR_DEADLINE)
    kwargs = {}
    rid = headers.get(_HDR_REQUEST_ID)
    if rid:
        kwargs["request_id"] = rid
    # an unknown qos raises ValueError from RawFoldRequest itself -> 400
    return RawFoldRequest(
        seq=seq, msa=msa,
        priority=int(headers.get(_HDR_PRIORITY, "0") or 0),
        deadline_s=None if deadline is None else float(deadline),
        forwarded=headers.get(_HDR_FORWARDED, "0") == "1",
        qos=headers.get(_HDR_QOS) or "online",
        **kwargs)


def encode_arrays(coords=None, confidence=None) -> bytes:
    """The ONE coords/confidence npz framing every result body uses —
    terminal responses here and the front door's progressive 206
    (frontdoor._result) share it, so the two wire encodings cannot
    drift."""
    buf = io.BytesIO()
    arrays = {}
    if coords is not None:
        arrays["coords"] = _host(coords, np.float32)
    if confidence is not None:
        arrays["confidence"] = _host(confidence, np.float32)
    np.savez(buf, **arrays) if arrays else np.savez(
        buf, empty=np.zeros(0, np.float32))
    return buf.getvalue()


def encode_response(response: FoldResponse) -> tuple:
    """(body_bytes, headers) for one terminal FoldResponse. Arrays in
    the npz body, everything else in headers — a non-ok response is an
    empty npz plus headers."""
    body = encode_arrays(response.coords, response.confidence)
    headers = {_HDR_REQUEST_ID: response.request_id,
               _HDR_STATUS: response.status,
               _HDR_SOURCE: response.source,
               _HDR_ATTEMPTS: str(int(response.attempts)),
               "Content-Type": "application/octet-stream"}
    if response.bucket_len is not None:
        headers[_HDR_BUCKET] = str(int(response.bucket_len))
    # getattr: older peers' responses have no recycles field
    recycles = getattr(response, "recycles", None)
    if recycles is not None:
        headers[_HDR_RECYCLES] = str(int(recycles))
    # getattr: older peers' responses have no cascade fields
    tier = getattr(response, "tier", "")
    if tier:
        headers[_HDR_TIER] = tier
    if getattr(response, "escalated", False):
        headers[_HDR_ESCALATED] = "1"
    confidence_score = getattr(response, "confidence_score", None)
    if confidence_score is not None:
        headers[_HDR_CONFIDENCE] = repr(float(confidence_score))
    if response.error:
        # headers must be latin-1-safe single-line; errors are ours
        headers[_HDR_ERROR] = str(response.error)[:512].replace(
            "\n", " ").encode("ascii", "replace").decode("ascii")
    return body, headers


def decode_response(body: bytes, headers) -> FoldResponse:
    """Parse a result body/headers back into a FoldResponse. Raises
    ValueError on malformed payloads (a transport error, not a result)."""
    status = headers.get(_HDR_STATUS)
    if not status:
        raise ValueError("result missing X-Status header")
    coords = confidence = None
    try:
        with np.load(io.BytesIO(body)) as z:
            if "coords" in z.files:
                coords = np.asarray(z["coords"], np.float32)
            if "confidence" in z.files:
                confidence = np.asarray(z["confidence"], np.float32)
    except Exception as exc:
        raise ValueError(f"unreadable result body: {exc!r}")
    if status == "ok" and (coords is None or confidence is None
                           or coords.ndim != 2 or coords.shape[1] != 3
                           or confidence.shape != (coords.shape[0],)):
        raise ValueError("ok result fails shape validation")
    bucket = headers.get(_HDR_BUCKET)
    recycles = headers.get(_HDR_RECYCLES)
    confidence_score = headers.get(_HDR_CONFIDENCE)
    return FoldResponse(
        request_id=headers.get(_HDR_REQUEST_ID, "?"),
        status=status, coords=coords, confidence=confidence,
        bucket_len=None if bucket is None else int(bucket),
        error=headers.get(_HDR_ERROR) or None,
        source=headers.get(_HDR_SOURCE, "fold"),
        attempts=int(headers.get(_HDR_ATTEMPTS, "1") or 1),
        recycles=None if recycles is None else int(recycles),
        tier=headers.get(_HDR_TIER) or "",
        escalated=headers.get(_HDR_ESCALATED, "0") == "1",
        confidence_score=(None if confidence_score is None
                          else float(confidence_score)))


# -- transports ----------------------------------------------------------

class LocalTransport:
    """The in-process transport: today's behavior behind the new seam.

    Wraps a bound `Scheduler.submit` (or any callable with that
    signature); `submit()` returns the peer scheduler's OWN ticket, so
    coalescing, tracing, and settlement semantics are byte-for-byte
    what `ReplicaInfo.submit` gave the router before transports
    existed."""

    def __init__(self, submit, submit_raw=None):
        self._submit = submit
        # optional raw-path seam (the peer Scheduler.submit_raw bound
        # method): feature-key routing forwards RAW jobs through it so
        # the OWNER featurizes. Absent on legacy wirings — the router's
        # forward_raw then raises and the pool featurizes locally.
        self._submit_raw = submit_raw

    def submit(self, request: FoldRequest, trace=NULL_TRACE) -> FoldTicket:
        return self._submit(request)

    def submit_raw(self, raw, trace=NULL_TRACE) -> FoldTicket:
        if self._submit_raw is None:
            raise RuntimeError("transport has no raw submit path")
        return self._submit_raw(raw)

    def healthz(self) -> Optional[dict]:
        return None              # in-process: the registry IS the truth


class HttpTransport:
    """Forwarding client for one replica's `FrontDoorServer`.

    submit() POSTs the request and returns a LOCAL FoldTicket that a
    daemon poll thread resolves from the owner's long-poll result
    endpoint. Failure contract:

    - submit-time transport trouble RAISES (the scheduler's existing
      forward-error fallback folds locally — nothing was accepted);
    - post-submit transport trouble (owner died mid-fold, partition,
      poll exhausted) resolves the ticket `status="error"` with the
      `rpc_transport` marker — the scheduler's failover path re-folds
      locally and counts `fleet_failovers_total`;
    - a terminal result resolves the ticket verbatim (status, source,
      attempts, error all travel).

    poll_wait_s is the server-side long-poll window per request;
    poll_budget_s bounds the total wait before the transport gives up
    and error-resolves with the transport marker (a hung owner must
    not hold forwarded tickets forever — the owner's own watchdog and
    deadline machinery should terminate folds long before this fires).

    One daemon poll thread (and one connection per poll round — the
    server speaks HTTP/1.0) per forwarded request is deliberate, the
    same call the peer cache tier makes: folds are seconds-granular
    and in-flight forwards are bounded by the sender's queue_limit, so
    thread/connect cost is noise next to one fold — and a shared
    multiplexing poller would be wedged by exactly the hung-peer case
    this transport exists to survive. Revisit only if forwarding ever
    carries sub-100ms work.
    """

    def __init__(self, base_url: str, timeout_s: float = 5.0,
                 poll_wait_s: float = 10.0, poll_budget_s: float = 600.0,
                 rollout=None,
                 metrics: Optional[MetricsRegistry] = None):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = float(timeout_s)
        self.poll_wait_s = float(poll_wait_s)
        self.poll_budget_s = float(poll_budget_s)
        self.rollout = rollout       # optional RolloutState: stamps tag
        reg = metrics or get_registry()
        self._m_rpc = reg.counter(
            "fleet_rpc_requests_total",
            "front-door RPCs by route and outcome (client side)",
            ("route", "outcome"))
        self._m_cancels = reg.counter(
            "fleet_remote_cancels_total",
            "best-effort cancels sent for timed-out forwarded tickets")
        self.cancels = 0

    # -- plumbing --------------------------------------------------------

    def _tag(self) -> str:
        return self.rollout.tag if self.rollout is not None else ""

    def _post(self, path: str, body: bytes, headers: dict,
              timeout: Optional[float] = None):
        req = urlrequest.Request(self.base_url + path, data=body,
                                 headers=headers, method="POST")
        return urlrequest.urlopen(req, timeout=timeout or self.timeout_s)

    # -- protocol --------------------------------------------------------

    def submit(self, request: FoldRequest, trace=NULL_TRACE) -> FoldTicket:
        """One forwarding hop. Raises on submit-time transport failure
        (caller folds locally); otherwise returns a ticket the poll
        thread resolves.

        The `rpc` span covers the WHOLE exchange — submit POST through
        terminal pickup — recorded as one completed interval (add_span)
        at whichever end the exchange reaches, with an `outcome` attr:
        "ok", "submit_error", "transport_death" (owner died/partitioned
        /restarted mid-fold — stamped BEFORE the ticket resolves, so a
        failover re-submission never inherits a dangling open span; the
        orphan fix), "poll_exhausted", or "cancelled". With
        tracing on, the request's TraceContext rides the submit headers
        and the span carries the matching `span_id`, so the receiving
        replica's continued trace stitches under exactly this span."""
        ctx = trace.wire_context()
        body = encode_request(request)
        headers = request_headers(request, tag=self._tag(), context=ctx)
        t0 = time.monotonic()
        try:
            with self._post("/v1/submit", body, headers) as resp:
                payload = json.loads(resp.read().decode("utf-8"))
            remote_ticket = payload["ticket"]
        except Exception:
            self._end_rpc(trace, t0, "submit", ctx, "submit_error")
            self._m_rpc.inc(route="submit", outcome="error")
            raise
        self._m_rpc.inc(route="submit", outcome="ok")
        return self._polled_ticket(remote_ticket, request, trace, t0,
                                   "submit", ctx)

    def submit_raw(self, raw, trace=NULL_TRACE) -> FoldTicket:
        """One RAW forwarding hop (feature-key routing): the
        owner featurizes replica-side and folds. Same failure contract
        (and rpc-span/trace-context lifecycle) as submit() —
        submit-time trouble raises (caller featurizes locally),
        post-submit trouble resolves with the transport marker (the
        feature pool then fails over to local featurization)."""
        ctx = trace.wire_context()
        body, headers = encode_raw_request(raw)
        tag = self._tag()
        if tag:
            headers[_HDR_TAG] = tag
        if ctx is not None:
            headers.update(ctx.to_headers())
        t0 = time.monotonic()
        try:
            with self._post("/v1/submit", body, headers) as resp:
                payload = json.loads(resp.read().decode("utf-8"))
            remote_ticket = payload["ticket"]
        except Exception:
            self._end_rpc(trace, t0, "submit_raw", ctx, "submit_error")
            self._m_rpc.inc(route="submit_raw", outcome="error")
            raise
        self._m_rpc.inc(route="submit_raw", outcome="ok")
        return self._polled_ticket(remote_ticket, raw, trace, t0,
                                   "submit_raw", ctx)

    def _end_rpc(self, trace, t0: float, route: str,
                 ctx: Optional[TraceContext], outcome: str):
        """Record the exchange's rpc span, exactly once per exchange,
        on every terminal path. add_span (a completed interval), never
        begin/end: the span can't be orphaned open by a dead owner, and
        a late poll-thread recording after the trace finished is
        silently dropped instead of colliding with a failover
        re-submission's fresh exchange."""
        attrs = {"peer": self.base_url, "route": route,
                 "outcome": outcome}
        if ctx is not None:
            attrs["span_id"] = ctx.parent_span_id
        trace.add_span("rpc", t0, time.monotonic(), **attrs)

    def _polled_ticket(self, remote_ticket: str, request, trace, t0,
                       route: str,
                       ctx: Optional[TraceContext]) -> FoldTicket:
        """Local ticket resolved by a daemon long-poll thread — the one
        pickup path both the token and raw submit hops share. `request`
        only needs a request_id (FoldRequest and RawFoldRequest both
        qualify)."""
        ticket = FoldTicket(request.request_id)
        # result(timeout=) expiry on the caller's side sends the owner a
        # best-effort cancel so the parked result is dropped, not leaked
        ticket._timeout_callback = lambda: self.cancel(remote_ticket)
        threading.Thread(
            target=self._poll,
            args=(remote_ticket, request, ticket, trace, t0, route, ctx),
            name=f"rpc-poll-{request.request_id}", daemon=True).start()
        return ticket

    def _transport_error(self, request: FoldRequest, detail: str
                         ) -> FoldResponse:
        return FoldResponse(
            request_id=request.request_id, status="error",
            error=f"{RPC_TRANSPORT_MARKER}: {detail}")

    def _poll(self, remote_ticket: str, request: FoldRequest,
              ticket: FoldTicket, trace, t0: float, route: str,
              ctx: Optional[TraceContext]):
        """Long-poll the owner until terminal; resolve the local ticket
        exactly once, with the transport marker on any failure. The
        exchange's rpc span is recorded (with its outcome) BEFORE the
        ticket resolves, so any failover path the resolution triggers
        re-submits against a trace whose dead-owner span is already
        closed — never auto-closed at finish, never spanning the
        retry."""
        deadline = time.monotonic() + self.poll_budget_s
        misses = 0
        while time.monotonic() < deadline:
            if ticket.done():
                # cancelled locally meanwhile (result-timeout path)
                self._end_rpc(trace, t0, route, ctx, "cancelled")
                return
            url = (f"{self.base_url}/v1/result/"
                   f"{urlparse.quote(remote_ticket, safe='')}"
                   f"?wait_s={self.poll_wait_s}")
            try:
                with urlrequest.urlopen(
                        url,
                        timeout=self.poll_wait_s + self.timeout_s) as resp:
                    if resp.status == 204:
                        misses += 1
                        continue     # still folding; poll again
                    body = resp.read()
                    response = decode_response(body, resp.headers)
            except urlerror.HTTPError as exc:
                outcome = ("unknown_ticket" if exc.code == 404
                           else "error")
                self._m_rpc.inc(route="result", outcome=outcome)
                # 404 = the owner restarted and forgot the ticket; both
                # cases mean the transport lost the fold, not the fold
                # failed — failover-eligible
                self._end_rpc(trace, t0, route, ctx, "transport_death")
                ticket._resolve(self._transport_error(
                    request, f"result fetch failed: HTTP {exc.code}"))
                return
            except Exception as exc:
                self._m_rpc.inc(route="result", outcome="error")
                self._end_rpc(trace, t0, route, ctx, "transport_death")
                ticket._resolve(self._transport_error(
                    request, f"result fetch failed: {exc!r}"))
                return
            self._m_rpc.inc(route="result", outcome="ok")
            self._end_rpc(trace, t0, route, ctx, "ok")
            ticket._resolve(response)
            return
        self._m_rpc.inc(route="result", outcome="poll_exhausted")
        self.cancel(remote_ticket)
        self._end_rpc(trace, t0, route, ctx, "poll_exhausted")
        ticket._resolve(self._transport_error(
            request, f"poll budget {self.poll_budget_s}s exhausted "
                     f"after {misses} empty polls"))

    def cancel(self, remote_ticket: str) -> bool:
        """Best-effort: tell the owner to drop the parked result."""
        try:
            path = ("/v1/cancel/"
                    + urlparse.quote(remote_ticket, safe=""))
            with self._post(path, b"", {}) as resp:
                ok = resp.status == 200
        except Exception:
            ok = False
        self.cancels += 1
        self._m_cancels.inc()
        self._m_rpc.inc(route="cancel", outcome="ok" if ok else "error")
        return ok

    def healthz(self) -> Optional[dict]:
        """The owner's /healthz payload, or None when unreachable."""
        try:
            with urlrequest.urlopen(self.base_url + "/healthz",
                                    timeout=self.timeout_s) as resp:
                if resp.status != 200:
                    return None
                return json.loads(resp.read().decode("utf-8"))
        except Exception:
            return None


def transport_of(info) -> Optional[object]:
    """The forwarding transport for one `ReplicaInfo`: the explicit
    `transport` when set, else the legacy `submit` callable wrapped in
    a LocalTransport (so pre-transport callers and tests that assign
    `info.submit` keep exactly their old semantics), else None."""
    if info is None:
        return None
    tr = getattr(info, "transport", None)
    if tr is not None:
        return tr
    if info.submit is not None:
        return LocalTransport(info.submit)
    return None
