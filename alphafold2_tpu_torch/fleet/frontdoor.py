"""Per-replica HTTP front door: full FoldTicket semantics over the wire.

One `FrontDoorServer` fronts one `Scheduler` (stdlib
ThreadingHTTPServer — the same zero-dependency trust model as the peer
cache tier in `fleet/peer.py`). The protocol is deliberately tiny:

    POST /v1/submit              npz body (seq[, msa]) + QoS headers
                                 -> 200 {"ticket": id}
                                 -> 409 model-tag mismatch
                                 -> 429 queue full     (retry elsewhere)
                                 -> 503 draining/stopped/partitioned
    GET  /v1/result/<id>?wait_s= long-poll; 200 npz + X-Status/X-Source/
                                 X-Attempts/X-Error when terminal
                                 (single pickup: the slot is freed),
                                 204 still in flight, 404 unknown.
                                 `&progress=1` opts into PROGRESSIVE
                                 results (step-mode scheduling,
                                 serve.recycle.RecyclePolicy(stream=
                                 True)): the long-poll returns 206 +
                                 the latest per-recycle coords/
                                 confidence npz with X-Recycle = its
                                 iteration index as soon as an update
                                 NEWER than `&after=<recycle>`
                                 (default -1) exists — poll again with
                                 after=<last X-Recycle> to stream; the
                                 slot stays parked and the terminal
                                 200 still follows
    POST /v1/cancel/<id>         best-effort: drop the parked slot
    GET  /healthz                the fleet's ONE health payload:
                                 replica, tag, epoch, breaker, queue
                                 depth, draining — the same shape the
                                 peer cache server serves, so the
                                 router's health walk and the recovery
                                 probe share one truth (a mesh-aware
                                 scheduler adds its device-slice
                                 occupancy under "mesh"; /admin/stats
                                 likewise carries serve_stats()["mesh"]
                                 — the passthrough needs no wiring here
                                 because both payloads come whole from
                                 the scheduler)
    GET  /metrics                Prometheus text exposition 0.0.4 of
                                 this process's MetricsRegistry
                                 (obs/export.py) — the scrape surface
                                 the SLO engine's slo_* gauges and
                                 every serve_*/fleet_* series ride;
                                 control-plane like /admin (served
                                 through an induced partition)
    POST /admin/rollout          {"tag": t} -> bump RolloutState
    GET  /admin/stats            serve_stats() as JSON, plus an
                                 "identity" block (replica_id /
                                 model_tag / incarnation boot nonce)
                                 mirrored by the /metrics
                                 fleet_replica_identity series — a
                                 controller cross-checks the two so a
                                 restarted replica's stale scrape is
                                 discarded, never acted on
    POST /admin/resize           {"workers": n} -> resize the
                                 scheduler's FeaturePool in place
                                 (400 when no pool is attached)
    POST /admin/peers            {"op": register|unregister|up|down,
                                 "peer": {...}} -> runtime membership
                                 verb against this replica's registry
                                 (epoch-bumped ring rebuild); 400
                                 unless the owner wired `peer_admin`
    POST /admin/partition        {"duration_s": f} -> data-plane 503s
                                 for f seconds (chaos: an induced
                                 network partition as every caller
                                 experiences it; admin stays reachable)
    POST /admin/adopt            {"replica_id": dead, "source":
                                 "notice"|"sweep", "orphans": [...]}
                                 -> the fleet controller assigns a dead
                                 replica's orphaned folds to THIS
                                 replica; it pulls each
                                 orphan's spilled checkpoint and
                                 resumes mid-loop; 400 unless the
                                 owner wired `adopt_handler`

A replica that has received a preemption notice reports
`"preempting": true` in /healthz (as a 503, so probes mark it down
immediately) and in the /v1/submit draining rejection body, so clients
fail over on the FIRST refusal instead of counting strikes.

Every terminal status travels verbatim — ok / shed / error / cancelled
/ degraded / poisoned, plus source cache/coalesced/forwarded — so a
remote caller sees exactly what an in-process caller would. Deadlines
and priorities propagate in headers and are re-anchored at the
receiving scheduler (the deadline clock restarts at the owner's
submit, matching the one-hop forwarding contract).

Parked results are TTL-bounded (`ticket_ttl_s`): a client that dies
between submit and pickup costs one slot for the TTL, never forever;
`/v1/cancel` (sent by `HttpTransport` when a forwarded ticket's
`result(timeout=)` expires) frees it early.
"""

from __future__ import annotations

import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib import parse as urlparse

from alphafold2_tpu_torch.fleet.rpc import (decode_raw_request, decode_request,
                                            encode_response, _HDR_TAG)
from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry
from alphafold2_tpu_torch.obs.trace import TraceContext


class _TicketSlot:
    """One submitted request's parked result."""

    __slots__ = ("ticket", "event", "response", "resolved_at",
                 "cancelled")

    def __init__(self, ticket):
        self.ticket = ticket
        self.event = threading.Event()
        self.response = None
        self.resolved_at = None      # set when the result parks
        self.cancelled = False


class FrontDoorServer:
    """Serve one Scheduler's submit/result surface over localhost HTTP.

    scheduler: the replica's `serve.Scheduler` (already started by the
        owner; this server never starts/stops it — except via `drain`
        wiring owned by the process, not the protocol).
    rollout: optional `fleet.RolloutState`; when set, submits carrying
        a different `X-Model-Tag` are refused 409 (the same rule the
        peer cache protocol enforces) and `/admin/rollout` bumps it.
    partition: optional `threading.Event`; while set, every data-plane
        request is refused 503 — the chaos harness's induced network
        partition. `/admin/partition` arms it on a timer. The same
        event can be shared with the replica's `PeerCacheServer` so a
        partition severs both planes at once.
    """

    def __init__(self, scheduler, rollout=None,
                 host: str = "127.0.0.1", port: int = 0,
                 replica_id: str = "", ticket_ttl_s: float = 300.0,
                 max_wait_s: float = 30.0,
                 partition: Optional[threading.Event] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.scheduler = scheduler
        self.rollout = rollout
        self.replica_id = replica_id
        self.ticket_ttl_s = float(ticket_ttl_s)
        self.max_wait_s = float(max_wait_s)
        self.partition = partition if partition is not None \
            else threading.Event()
        self._lock = threading.Lock()
        self._slots: dict = {}
        self._ticket_counter = [0]
        # boot nonce in every ticket id: a restarted replica reuses its
        # port, and without the nonce its counter would reissue the
        # dead process's ids — a pre-crash caller's stale poll could
        # then fetch (and mislabel) a NEW request's fold, and its
        # timed-out ticket's late cancel could drop one. With the
        # nonce both get a clean 404 -> transport-marker failover.
        self._boot_nonce = uuid.uuid4().hex[:8]
        self._partition_timer: Optional[threading.Timer] = None
        # optional zero-arg callable merged into /admin/stats under
        # "extra" — the owning process adds what the scheduler cannot
        # see (peer-client counters, front-door snapshot)
        self.extra_stats = None
        # optional zero-arg callable fired (best-effort) before each
        # GET /metrics render — the owning process refreshes gauges a
        # scrape should see fresh (the SLO engine's slo_* set, which
        # otherwise only update when serve_stats() runs)
        self.metrics_hook = None
        # optional callable(op, peer_dict) -> dict handling
        # POST /admin/peers (runtime membership): the owning
        # process registers/unregisters/marks peers in ITS registry so
        # a control plane can rebuild data-plane rings at runtime;
        # None = 400 (static-membership replicas take no peer verbs)
        self.peer_admin = None
        # optional callable(payload_dict) -> dict handling
        # POST /admin/adopt (orphan adoption): the owning
        # process resubmits a dead peer's manifest-listed folds into
        # ITS scheduler (resuming from the spilled checkpoints); None
        # = 400 (replicas without a checkpoint store adopt nothing)
        self.adopt_handler = None
        reg = metrics or get_registry()
        # the registry GET /metrics exposes — the same one the rpc
        # counter below reports into (the process default unless the
        # owner isolated one)
        self._registry = reg
        # distinct name from the client-side fleet_rpc_requests_total:
        # a procfleet replica both serves a front door and forwards via
        # HttpTransports on the same registry, and the registry dedups
        # by metric name — one shared name would silently sum sent and
        # served RPCs into a single series
        self._m_rpc = reg.counter(
            "fleet_rpc_served_total",
            "front-door RPCs served by this process, by route/outcome",
            ("route", "outcome"))
        # who-am-I series: every /metrics exposition carries
        # exactly one fleet_replica_identity sample at value 1 whose
        # labels name this replica, its CURRENT model tag, and this
        # process incarnation (the boot nonce) — a control plane that
        # polled a restarted replica can cross-check the scrape against
        # /admin/stats's identity block and discard a stale one instead
        # of acting on another incarnation's numbers. Superseded label
        # sets (pre-rollout tags) are zeroed, not removed, so exactly
        # one series is ever at 1.
        self._m_identity = reg.gauge(
            "fleet_replica_identity",
            "1 for this process's current identity "
            "(replica_id/model_tag/incarnation), 0 for superseded",
            ("replica_id", "model_tag", "incarnation"))
        self._identity_labels: Optional[dict] = None
        self._refresh_identity()
        server = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *args):
                pass

            def _reply(self, code: int, body: bytes = b"",
                       headers: Optional[dict] = None,
                       content_type: str = "application/json"):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    if k != "Content-Type":
                        self.send_header(k, v)
                self.end_headers()
                if body:
                    self.wfile.write(body)

            def _json(self, code: int, payload: dict):
                self._reply(code, json.dumps(payload).encode("utf-8"))

            def _body(self) -> bytes:
                n = int(self.headers.get("Content-Length", "0") or 0)
                return self.rfile.read(n) if n else b""

            def do_GET(self):
                try:
                    server._handle(self, "GET")
                except Exception as exc:
                    try:
                        self._json(500, {"error": repr(exc)})
                    except Exception:
                        pass

            def do_POST(self):
                try:
                    server._handle(self, "POST")
                except Exception as exc:
                    try:
                        self._json(500, {"error": repr(exc)})
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -------------------------------------------------------

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def start(self) -> "FrontDoorServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name=f"frontdoor-{self.replica_id or self.address[1]}")
            self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        with self._lock:
            if self._partition_timer is not None:
                self._partition_timer.cancel()
                self._partition_timer = None

    def __enter__(self) -> "FrontDoorServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- routing ---------------------------------------------------------

    def _handle(self, h, method: str):
        parsed = urlparse.urlsplit(h.path)
        path = parsed.path
        if path == "/healthz" and method == "GET":
            return self._healthz(h)
        if path == "/metrics" and method == "GET":
            # Prometheus scrape: control-plane like /admin —
            # served through an induced partition, because the chaos
            # window is exactly when an operator needs the numbers
            return self._metrics(h)
        if path.startswith("/admin/"):
            return self._admin(h, method, path)
        if self.partition.is_set():
            # induced partition: the data plane is unreachable exactly
            # the way a firewalled host is — callers time out or error,
            # mark this replica down, and fail over
            self._m_rpc.inc(route="data", outcome="partitioned")
            return h._json(503, {"error": "partitioned"})
        if path == "/v1/submit" and method == "POST":
            return self._submit(h)
        if path.startswith("/v1/result/") and method == "GET":
            return self._result(h, path[len("/v1/result/"):], parsed)
        if path.startswith("/v1/cancel/") and method == "POST":
            return self._cancel(h, path[len("/v1/cancel/"):])
        h._json(404, {"error": "not found"})

    # -- endpoints -------------------------------------------------------

    def _healthz(self, h):
        payload = {"replica": self.replica_id,
                   "tag": self.rollout.tag if self.rollout else "",
                   "epoch": self.rollout.epoch if self.rollout else 0,
                   "partitioned": self.partition.is_set()}
        health = getattr(self.scheduler, "health", None)
        if callable(health):
            try:
                payload.update(health())
            except Exception:
                pass
        if self.partition.is_set():
            # a partitioned replica is unreachable, health included —
            # the recovery probe must keep it marked down
            self._m_rpc.inc(route="healthz", outcome="partitioned")
            return h._reply(503, json.dumps(payload).encode("utf-8"))
        if payload.get("preempting"):
            # reclaim announced: this replica dies within
            # the grace window — 503 with the state in the body, so a
            # single probe marks it down AND tells the prober why
            self._m_rpc.inc(route="healthz", outcome="preempting")
            return h._reply(503, json.dumps(payload).encode("utf-8"))
        self._m_rpc.inc(route="healthz", outcome="ok")
        h._json(200, payload)

    def identity(self) -> dict:
        """This process's identity triple: who the scrape/stats came
        from. `incarnation` is the boot nonce — two boots of the same
        replica_id never share it, which is what lets a controller
        reject a stale scrape from a pre-restart incarnation."""
        return {"replica_id": self.replica_id,
                "model_tag": self.rollout.tag if self.rollout else "",
                "incarnation": self._boot_nonce}

    def _refresh_identity(self):
        """Keep exactly one fleet_replica_identity series at 1: the
        current triple. A rollout changes the tag label — the old
        series is zeroed (kept, so the flip is visible in a scrape)."""
        labels = self.identity()
        with self._lock:
            prev = self._identity_labels
            if prev == labels:
                return
            self._identity_labels = labels
        if prev is not None:
            self._m_identity.set(0, **prev)
        self._m_identity.set(1, **labels)

    def _metrics(self, h):
        """Prometheus text exposition of this process's registry (the
        0.0.4 format obs.export.prometheus_text renders) — the registry
        was previously only reachable as JSON through /admin/stats."""
        from alphafold2_tpu_torch.obs.export import prometheus_text

        if self.metrics_hook is not None:
            try:
                self.metrics_hook()
            except Exception:
                pass      # a broken refresher never breaks the scrape
        self._refresh_identity()
        try:
            text = prometheus_text(self._registry)
        except Exception as exc:
            self._m_rpc.inc(route="metrics", outcome="error")
            return h._json(500, {"error": repr(exc)})
        self._m_rpc.inc(route="metrics", outcome="ok")
        h._reply(200, text.encode("utf-8"),
                 content_type="text/plain; version=0.0.4")

    def _submit(self, h):
        from alphafold2_tpu_torch.serve.scheduler import (
            DrainingError, QueueFullError)

        tag = h.headers.get(_HDR_TAG, "")
        if self.rollout is not None and tag \
                and tag != self.rollout.tag:
            self._m_rpc.inc(route="submit", outcome="stale_tag")
            return h._json(409, {"error": "model tag mismatch",
                                 "tag": self.rollout.tag})
        # two body formats, told apart by Content-Type: npz = tokenized
        # FoldRequest (the classic path, and what forwarded hops carry),
        # application/json = a RAW job — sequence string (or
        # token list) + raw MSA, featurized REPLICA-SIDE through
        # scheduler.submit_raw (the feature pool when attached, inline
        # otherwise), so web clients never need a tokenizer
        ctype = (h.headers.get("Content-Type") or "").split(";")[0]
        raw_body = ctype.strip().lower() == "application/json"
        if raw_body and not callable(getattr(self.scheduler,
                                             "submit_raw", None)):
            self._m_rpc.inc(route="submit", outcome="bad_request")
            return h._json(400, {"error": "raw submissions unsupported "
                                          "by this replica"})
        try:
            request = (decode_raw_request(h._body(), h.headers)
                       if raw_body
                       else decode_request(h._body(), h.headers))
        except ValueError as exc:
            self._m_rpc.inc(route="submit", outcome="bad_request")
            return h._json(400, {"error": str(exc)})
        # cross-process trace continuation: a submit whose
        # headers carry a TraceContext — a forwarded fold, a raw job
        # routed by feature key, a traced client — continues the
        # SENDER's trace on this replica's tracer, so the fold stages
        # here stitch under the sender's rpc span instead of starting
        # a disconnected trace. No headers (or tracing off here) is
        # byte-for-byte the old path.
        trace = None
        ctx = TraceContext.from_headers(h.headers)
        if ctx is not None:
            tracer = getattr(self.scheduler, "tracer", None)
            if tracer is not None and getattr(tracer, "enabled", False):
                trace = tracer.start_trace(request.request_id,
                                           context=ctx)
        try:
            if trace is not None:
                ticket = (self.scheduler.submit_raw(request, trace=trace)
                          if raw_body
                          else self.scheduler.submit(request,
                                                     trace=trace))
            else:
                ticket = (self.scheduler.submit_raw(request) if raw_body
                          else self.scheduler.submit(request))
        except DrainingError:
            self._finish_trace(trace, "rejected", "draining")
            self._m_rpc.inc(route="submit", outcome="draining")
            body = {"error": "draining"}
            if getattr(self.scheduler, "preempting", False):
                # tell the refused caller WHY: a preempting
                # drain never heals, so the client marks this replica
                # down immediately instead of counting strikes
                body["preempting"] = True
            return h._json(503, body)
        except QueueFullError:
            self._finish_trace(trace, "rejected", "queue full")
            self._m_rpc.inc(route="submit", outcome="queue_full")
            return h._json(429, {"error": "queue full"})
        except ValueError as exc:
            # deterministic input problem (e.g. length exceeds the
            # largest bucket): the CLIENT's error, 400 — never 500,
            # which failover layers would misread as a server fault
            # and retry across the whole fleet
            self._finish_trace(trace, "rejected", str(exc))
            self._m_rpc.inc(route="submit", outcome="bad_request")
            return h._json(400, {"error": str(exc)})
        except RuntimeError as exc:
            # stopped scheduler: same caller story as draining —
            # this replica cannot take the work, go elsewhere
            self._finish_trace(trace, "error", str(exc))
            self._m_rpc.inc(route="submit", outcome="unavailable")
            return h._json(503, {"error": str(exc)})
        slot = _TicketSlot(ticket)
        with self._lock:
            self._ticket_counter[0] += 1
            ticket_id = f"{self.replica_id or 'fd'}-" \
                        f"{self._boot_nonce}-" \
                        f"{self._ticket_counter[0]}"
            self._gc_locked()
            self._slots[ticket_id] = slot

        def _on_done(response):
            slot.response = response
            slot.resolved_at = time.monotonic()
            slot.event.set()
            if slot.cancelled:
                with self._lock:
                    self._slots.pop(ticket_id, None)

        ticket.add_done_callback(_on_done)
        self._m_rpc.inc(route="submit", outcome="ok")
        h._json(200, {"ticket": ticket_id,
                      "request_id": request.request_id})

    def _result(self, h, ticket_id: str, parsed):
        ticket_id = urlparse.unquote(ticket_id)
        with self._lock:
            slot = self._slots.get(ticket_id)
        if slot is None:
            self._m_rpc.inc(route="result", outcome="unknown")
            return h._json(404, {"error": "unknown ticket"})
        try:
            wait_s = float(urlparse.parse_qs(parsed.query).get(
                "wait_s", ["0"])[0])
        except ValueError:
            wait_s = 0.0
        wait_s = max(0.0, min(wait_s, self.max_wait_s))
        query = urlparse.parse_qs(parsed.query)
        if query.get("progress", ["0"])[0] == "1":
            # progressive long-poll: return 206 + the latest
            # per-recycle update as soon as one NEWER than the
            # client's `after=<recycle>` cursor exists, instead of
            # sitting out the whole wait on the terminal event (a
            # streaming client would otherwise see at most one stale
            # update per window). Short wait slices: FoldTicket has no
            # progress event to block on, and recycles are
            # 10s-of-ms-granular.
            try:
                after = int(query.get("after", ["-1"])[0])
            except ValueError:
                after = -1
            deadline = time.monotonic() + wait_s
            while True:
                if slot.event.is_set():
                    break                        # terminal: 200 below
                latest = self._latest_progress(slot)
                if latest is not None and int(latest.recycle) > after:
                    from alphafold2_tpu_torch.fleet.rpc import encode_arrays
                    self._m_rpc.inc(route="result", outcome="progress")
                    return h._reply(
                        206, encode_arrays(latest.coords,
                                           latest.confidence),
                        headers={"X-Status": "running",
                                 "X-Recycle": str(int(latest.recycle))},
                        content_type="application/octet-stream")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._m_rpc.inc(route="result", outcome="pending")
                    return h._reply(204, b"")
                slot.event.wait(min(0.05, remaining))
        elif not slot.event.wait(wait_s):
            self._m_rpc.inc(route="result", outcome="pending")
            return h._reply(204, b"")
        body, headers = encode_response(slot.response)
        with self._lock:
            self._slots.pop(ticket_id, None)   # single pickup
        self._m_rpc.inc(route="result", outcome="ok")
        h._reply(200, body, headers=headers,
                 content_type="application/octet-stream")

    @staticmethod
    def _finish_trace(trace, status: str, error: str):
        """A continued trace refused at the door still owes the fleet
        one terminal record (the scheduler usually finishes it, but the
        pre-entry fail-fasts — bucket_for on an over-length sequence —
        raise before it adopts the trace). finish() is idempotent, so
        double cover costs nothing."""
        if trace is not None:
            try:
                trace.finish(status, error=error)
            except Exception:
                pass

    @staticmethod
    def _latest_progress(slot):
        getter = getattr(slot.ticket, "latest_progress", None)
        if not callable(getter):
            return None
        try:
            return getter()
        except Exception:
            return None

    def _cancel(self, h, ticket_id: str):
        ticket_id = urlparse.unquote(ticket_id)
        with self._lock:
            slot = self._slots.pop(ticket_id, None)
        if slot is not None:
            # the fold itself may already be batched — best-effort
            # means the RESULT slot is dropped (and a late resolution
            # self-cleans via the done callback), not that the
            # accelerator work is yanked back
            slot.cancelled = True
        self._m_rpc.inc(route="cancel",
                        outcome="ok" if slot is not None else "unknown")
        h._json(200, {"cancelled": slot is not None})

    def _admin(self, h, method: str, path: str):
        if path == "/admin/rollout" and method == "POST":
            if self.rollout is None:
                return h._json(400, {"error": "no rollout state"})
            try:
                payload = json.loads(h._body().decode("utf-8"))
                tag = payload["tag"]
            except Exception as exc:
                return h._json(400, {"error": f"bad payload: {exc!r}"})
            epoch = self.rollout.bump(str(tag))
            self._m_rpc.inc(route="admin_rollout", outcome="ok")
            return h._json(200, {"tag": self.rollout.tag,
                                 "epoch": epoch})
        if path == "/admin/stats" and method == "GET":
            try:
                stats = self.scheduler.serve_stats()
                if self.extra_stats is not None:
                    stats["extra"] = self.extra_stats()
                # identity rides every stats reply: a
                # controller cross-checks it against the /metrics
                # fleet_replica_identity series so a restarted
                # replica's stale scrape is discarded, never acted on
                stats["identity"] = self.identity()
                body = json.dumps(stats, default=float).encode("utf-8")
            except Exception as exc:
                return h._json(500, {"error": repr(exc)})
            self._m_rpc.inc(route="admin_stats", outcome="ok")
            return h._reply(200, body)
        if path == "/admin/resize" and method == "POST":
            pool = getattr(self.scheduler, "feature_pool", None)
            if pool is None or not hasattr(pool, "resize"):
                self._m_rpc.inc(route="admin_resize", outcome="error")
                return h._json(400, {"error": "no feature pool"})
            try:
                payload = json.loads(h._body().decode("utf-8"))
                workers = int(payload["workers"])
            except Exception as exc:
                self._m_rpc.inc(route="admin_resize", outcome="error")
                return h._json(400, {"error": f"bad payload: {exc!r}"})
            try:
                new = pool.resize(workers)
            except (ValueError, RuntimeError) as exc:
                self._m_rpc.inc(route="admin_resize", outcome="error")
                return h._json(400, {"error": str(exc)})
            self._m_rpc.inc(route="admin_resize", outcome="ok")
            return h._json(200, {"replica": self.replica_id,
                                 "workers": new})
        if path == "/admin/peers" and method == "POST":
            if self.peer_admin is None:
                self._m_rpc.inc(route="admin_peers", outcome="error")
                return h._json(400, {"error": "no peer admin"})
            try:
                payload = json.loads(h._body().decode("utf-8"))
                op = str(payload["op"])
                peer = dict(payload["peer"])
                if op not in ("register", "unregister", "up", "down"):
                    raise ValueError(f"unknown op {op!r}")
            except Exception as exc:
                self._m_rpc.inc(route="admin_peers", outcome="error")
                return h._json(400, {"error": f"bad payload: {exc!r}"})
            try:
                out = self.peer_admin(op, peer)
            except Exception as exc:
                self._m_rpc.inc(route="admin_peers", outcome="error")
                return h._json(500, {"error": repr(exc)})
            self._m_rpc.inc(route="admin_peers", outcome="ok")
            return h._json(200, dict(out or {}, op=op))
        if path == "/admin/adopt" and method == "POST":
            if self.adopt_handler is None:
                self._m_rpc.inc(route="admin_adopt", outcome="error")
                return h._json(400, {"error": "no adopt handler"})
            try:
                payload = json.loads(h._body().decode("utf-8"))
                if not isinstance(payload.get("orphans"), list):
                    raise ValueError("orphans must be a list")
            except Exception as exc:
                self._m_rpc.inc(route="admin_adopt", outcome="error")
                return h._json(400, {"error": f"bad payload: {exc!r}"})
            try:
                out = self.adopt_handler(payload)
            except Exception as exc:
                self._m_rpc.inc(route="admin_adopt", outcome="error")
                return h._json(500, {"error": repr(exc)})
            self._m_rpc.inc(route="admin_adopt", outcome="ok")
            return h._json(200, dict(out or {},
                                     replica=self.replica_id))
        if path == "/admin/partition" and method == "POST":
            try:
                payload = json.loads(h._body().decode("utf-8") or "{}")
                duration = float(payload.get("duration_s", 0.0))
            except Exception as exc:
                return h._json(400, {"error": f"bad payload: {exc!r}"})
            self.set_partition(duration)
            self._m_rpc.inc(route="admin_partition", outcome="ok")
            return h._json(200, {"partitioned": duration > 0,
                                 "duration_s": duration})
        h._json(404, {"error": "not found"})

    # -- partition / gc --------------------------------------------------

    def set_partition(self, duration_s: float):
        """Arm (duration_s > 0) or clear (<= 0) the induced partition;
        a positive duration auto-heals on a timer."""
        with self._lock:
            if self._partition_timer is not None:
                self._partition_timer.cancel()
                self._partition_timer = None
            if duration_s > 0:
                self.partition.set()
                self._partition_timer = threading.Timer(
                    duration_s, self.partition.clear)
                self._partition_timer.daemon = True
                self._partition_timer.start()
            else:
                self.partition.clear()

    def _gc_locked(self):
        """Drop RESOLVED slots unpicked for longer than the TTL (caller
        holds _lock). Unresolved slots are never evicted: they are
        in-flight scheduler work whose client may legitimately
        long-poll past any TTL (HttpTransport's poll budget exceeds
        it by design), and the scheduler owes every ticket a terminal
        state, so an unresolved slot always becomes collectable.
        Runs on the submit path, so an idle server holds stale slots
        until the next submit — fine: the TTL bounds memory, not
        correctness."""
        if not self._slots:
            return
        cutoff = time.monotonic() - self.ticket_ttl_s
        dead = [tid for tid, slot in self._slots.items()
                if slot.resolved_at is not None
                and slot.resolved_at < cutoff]
        for tid in dead:
            self._slots.pop(tid, None)

    def snapshot(self) -> dict:
        with self._lock:
            return {"replica": self.replica_id,
                    "address": list(self.address),
                    "parked_tickets": len(self._slots),
                    "partitioned": self.partition.is_set()}
