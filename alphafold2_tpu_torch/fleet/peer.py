"""Peer cache protocol: npz-over-HTTP between replicas, stdlib only.

One replica's `FoldCache` becomes fleet-readable through a
`PeerCacheServer` (stdlib `ThreadingHTTPServer`; GET
`/cache/<key>?tag=<model_tag>` returns the entry as `encode_fold` npz
bytes) and fleet-reading through a `PeerCacheClient` mounted as the
cache's third tier (`FoldCache(peer=client)`): on a local memory+disk
miss the client asks the key's consistent-hash owner, validates the
bytes with the same `decode_fold` the disk tier trusts, and hands back
a `CachedFold` for promotion into the local tiers.

Rollout safety is enforced at BOTH ends (HelixFold's rule that the
model version namespaces everything cached):

- the client stamps every fetch with its current `RolloutState` tag;
- the server 409s any fetch whose tag differs from its own current tag
  (`stale_tag` counters on both sides), so during a rollout a replica
  that has not switched yet and one that has can never exchange folds —
  the epoch bump invalidates peer lookups for the old tag atomically,
  without touching a single stored entry (keys already embed the tag,
  so old entries are unreachable garbage, not hazards).

Failure model: every client-side problem — connect refused, timeout,
HTTP error, corrupt bytes — is a MISS plus a counter, never an
exception into the serving path. `fail_threshold` consecutive transport
errors against one peer mark it down in the registry (bumping the
membership epoch, so routers stop selecting it); corrupt bytes
additionally count as `corrupt` but do NOT mark the peer down (its
other entries are likely fine).

Markdown is NOT forever: the client remembers which peers IT marked
down and, once `recovery_cooldown_s` has passed, half-open-probes the
peer's `/healthz` (at most one probe per peer per cooldown window,
triggered by the next get() but run on a daemon thread so a dead
host's connect timeout never delays a live request) — a 200 marks the
peer back up in the registry (`fleet_peer_recoveries_total`), so a
restarted replica rejoins the peer tier without operator action; a
failed probe resets the cooldown clock. A peer someone ELSE marked
down (an operator, a different client) is never resurrected from here.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib import error as urlerror
from urllib import parse as urlparse
from urllib import request as urlrequest

from alphafold2_tpu_torch.cache.store import CachedFold, decode_fold
from alphafold2_tpu_torch.fleet.registry import ReplicaRegistry, RolloutState
from alphafold2_tpu_torch.fleet.router import ConsistentHashRouter
from alphafold2_tpu_torch.obs.registry import MetricsRegistry, get_registry
from alphafold2_tpu_torch.obs.trace import NULL_TRACE, TraceContext

_TAG_HEADER = "X-Model-Tag"


class PeerCacheServer:
    """Serve one replica's FoldCache to its peers over localhost HTTP.

    Read-only by design: peers fetch what this replica folded; nothing
    is ever written through this surface, so a misbehaving peer can
    cost bandwidth but never poison the store. `port=0` binds an
    ephemeral port (the in-process harness registers the resolved
    address). `rollout=None` disables the tag check (single-tag
    deployments that never roll weights in place).
    """

    def __init__(self, cache, rollout: Optional[RolloutState] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 replica_id: str = "",
                 metrics: Optional[MetricsRegistry] = None,
                 health_source=None,
                 partition: Optional[threading.Event] = None):
        self.cache = cache
        self.rollout = rollout
        self.replica_id = replica_id
        # health_source: zero-arg callable merged into the /healthz
        # payload (Scheduler.health — breaker state, queue depth, drain
        # flag), so the recovery probe and the router's health walk
        # read the SAME truth the front door serves. Assignable after
        # construction (the in-process harness builds servers before
        # schedulers).
        self.health_source = health_source
        # partition: while set, every request (healthz included) is
        # refused 503 — the chaos harness's induced partition, shared
        # with the replica's FrontDoorServer so one event severs both
        # planes
        self.partition = partition
        # tracer: optional obs.Tracer (assignable after construction,
        # like health_source). When set and a fetch carries a
        # TraceContext, this server emits a tiny continued trace — one
        # `peer_serve` span sharing the requester's trace id — so a
        # peer-cache hit's two halves stitch into ONE fleet waterfall
        # instead of a client-side span with no server story
        self.tracer = None
        # metrics_hook: optional zero-arg callable run before each
        # GET /metrics render (same contract as FrontDoorServer's) —
        # wire it to SLOEngine.report so a scrape of THIS port reads
        # gauges as fresh as the front-door port's
        self.metrics_hook = None
        # checkpoint_source: optional duck-typed
        # `latest_raw(group) -> bytes | None`
        # (cache.checkpoints.CheckpointStore) behind the
        # `kind=checkpoint` route — a failover peer fetches a dead
        # replica's spilled mid-loop carry through the SAME wire the
        # fold cache uses. Assignable after construction
        # like health_source; None keeps the route a clean 404, so a
        # spill-off replica answers checkpoint probes with a miss,
        # never an error.
        self.checkpoint_source = None
        reg = metrics or get_registry()
        self._registry = reg      # GET /metrics exposes this registry
        m_served = reg.counter(
            "fleet_peer_served_total",
            "peer-protocol fetches served by this process, by outcome",
            ("replica", "outcome"))
        server = self

        class _Handler(BaseHTTPRequestHandler):
            # one fetch per connection is fine at fold granularity;
            # keep-alive would only pin threads
            protocol_version = "HTTP/1.0"

            def log_message(self, *args):      # stdlib default spams stderr
                pass

            def _count(self, outcome: str):
                m_served.inc(replica=server.replica_id, outcome=outcome)

            @staticmethod
            def _finish(trace, outcome: str, status: str):
                if trace is None:
                    return
                try:
                    trace.end("peer_serve", outcome=outcome)
                    trace.finish(status, source="peer")
                except Exception:
                    pass      # obs, never the fetch path

            def _reply(self, code: int, body: bytes,
                       content_type: str = "application/octet-stream"):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                if server.rollout is not None:
                    self.send_header(_TAG_HEADER, server.rollout.tag)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                trace = None
                try:
                    parsed = urlparse.urlsplit(self.path)
                    if parsed.path == "/metrics":
                        # the same scrape surface the front door grew
                        # — a cache-only deployment without
                        # a front door is still scrapeable. Served
                        # BEFORE the partition check, matching the
                        # front door's rule: the chaos window is
                        # exactly when an operator needs the numbers.
                        # Render failures stay OFF the peer-fetch
                        # error counter the chaos smokes gate on.
                        from alphafold2_tpu_torch.obs.export import \
                            prometheus_text
                        if server.metrics_hook is not None:
                            try:
                                server.metrics_hook()
                            except Exception:
                                pass
                        try:
                            text = prometheus_text(server._registry)
                        except Exception:
                            self._reply(500, b"metrics error",
                                        "text/plain")
                            return
                        self._reply(200, text.encode(),
                                    "text/plain; version=0.0.4")
                        return
                    if server.partition is not None \
                            and server.partition.is_set():
                        # induced partition: unreachable on every
                        # route, health included — probes must keep
                        # this replica marked down until it heals
                        self._reply(503, b"partitioned", "text/plain")
                        return
                    if parsed.path == "/healthz":
                        snap = {"replica": server.replica_id,
                                "tag": (server.rollout.tag
                                        if server.rollout else ""),
                                "epoch": (server.rollout.epoch
                                          if server.rollout else 0)}
                        if server.health_source is not None:
                            # one truth: the same Scheduler.health dict
                            # the front door serves (breaker state,
                            # queue depth, draining)
                            try:
                                snap.update(server.health_source())
                            except Exception:
                                pass
                        self._reply(200, json.dumps(snap).encode(),
                                    "application/json")
                        return
                    if not parsed.path.startswith("/cache/"):
                        self._reply(404, b"not found", "text/plain")
                        return
                    key = parsed.path[len("/cache/"):]
                    # continued trace for the fetch (tracing-on fleets
                    # only): one peer_serve span under the requester's
                    # peer_fetch hop
                    ctx = TraceContext.from_headers(self.headers)
                    if ctx is not None and server.tracer is not None \
                            and getattr(server.tracer, "enabled",
                                        False):
                        trace = server.tracer.start_trace(
                            f"peer:{key[:24]}", context=ctx)
                        trace.begin("peer_serve")
                    qs = urlparse.parse_qs(parsed.query)
                    tag = qs.get("tag", [""])[0]
                    if server.rollout is not None \
                            and tag != server.rollout.tag:
                        # cross-tag fetch: the requester and this
                        # replica disagree on the current weights —
                        # refuse, never guess (rollout invalidation)
                        self._count("stale_tag")
                        self._finish(trace, "stale_tag", "rejected")
                        self._reply(409, b"model tag mismatch",
                                    "text/plain")
                        return
                    if qs.get("kind", [""])[0] == "checkpoint":
                        # checkpoint artifact kind: <key>
                        # is a checkpoint GROUP digest; serve this
                        # replica's newest spilled carry for it. The
                        # decoded payload re-proves the tag client-
                        # side (decode_checkpoint), so the route
                        # shares the fold path's 409 gate above and
                        # needs no second check.
                        src = server.checkpoint_source
                        data = (None if src is None
                                else src.latest_raw(key))
                        if data is None:
                            self._count("ckpt_miss")
                            self._finish(trace, "ckpt_miss", "miss")
                            self._reply(404, b"miss", "text/plain")
                            return
                        self._count("ckpt_hit")
                        self._finish(trace, "ckpt_hit", "ok")
                        self._reply(200, data)
                        return
                    data = server.cache.read_raw(key)
                    if data is None:
                        self._count("miss")
                        self._finish(trace, "miss", "miss")
                        self._reply(404, b"miss", "text/plain")
                        return
                    self._count("hit")
                    self._finish(trace, "hit", "ok")
                    self._reply(200, data)
                except Exception:
                    # a broken fetch must cost the REQUESTER a miss,
                    # never wedge the serving replica's handler thread
                    self._count("error")
                    # a continued trace started before the failure
                    # still owes the fleet its serving-side record —
                    # the error outcome is the one an operator most
                    # needs the server half of
                    self._finish(trace, "error", "error")
                    try:
                        self._reply(500, b"peer error", "text/plain")
                    except Exception:
                        pass

        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        host, port = self._httpd.server_address[:2]
        return str(host), int(port)

    def start(self) -> "PeerCacheServer":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name=f"peer-cache-{self.replica_id or self.address[1]}")
            self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self) -> "PeerCacheServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class PeerCacheClient:
    """`FoldCache(peer=...)` tier that fetches from the key's owner.

    get(key) resolves the key's consistent-hash owner through `router`,
    skips the fetch when the owner is this replica (or unknown), and
    otherwise GETs the entry from the owner's PeerCacheServer with this
    replica's current rollout tag. Validation mirrors the disk tier
    (`decode_fold`); a response whose `X-Model-Tag` no longer matches
    ours is discarded as stale even on HTTP 200 (defense in depth — the
    server also 409s). Never raises out of get(); every outcome lands
    in `fleet_peer_fetch_total{peer,outcome}` and the fetch-latency
    histogram `fleet_peer_fetch_seconds`.
    """

    def __init__(self, registry: ReplicaRegistry, self_id: str,
                 router: Optional[ConsistentHashRouter] = None,
                 rollout: Optional[RolloutState] = None,
                 timeout_s: float = 2.0, fail_threshold: int = 3,
                 recovery_cooldown_s: float = 5.0,
                 metrics: Optional[MetricsRegistry] = None,
                 faults=None):
        self.registry = registry
        self.self_id = self_id
        self.router = router or ConsistentHashRouter(
            registry, self_id, metrics=metrics)
        self.rollout = rollout if rollout is not None else registry.rollout
        self.timeout_s = float(timeout_s)
        self.fail_threshold = max(1, int(fail_threshold))
        self.recovery_cooldown_s = float(recovery_cooldown_s)
        # optional serve.faults.FaultPlan: injected transport failures
        # (chaos) land in the same markdown/recovery machinery as real
        # ones
        self.faults = faults
        self._lock = threading.Lock()
        self._consecutive_failures: dict = {}
        self._down: dict = {}     # peer_id -> monotonic mark-down time
        self.recoveries = 0
        reg = metrics or get_registry()
        self._m_fetch = reg.counter(
            "fleet_peer_fetch_total",
            "peer-tier fetch attempts by owner and outcome",
            ("peer", "outcome"))
        self._m_latency = reg.histogram(
            "fleet_peer_fetch_seconds",
            "wall time of one peer-tier fetch attempt")
        self._m_recoveries = reg.counter(
            "fleet_peer_recoveries_total",
            "marked-down peers recovered by a half-open health probe")
        self.stale_tag_hits = 0   # 200s discarded on tag mismatch (== 0
        #                           unless a server is misbehaving)
        self.preempt_markdowns = 0  # peers marked down on a single
        #                             `preempting` 503

    def _note_preempting(self, peer_id: str, exc) -> bool:
        """Immediate mark-down on an announced reclaim: a
        503 whose JSON body carries `"preempting": true` is not a
        flaky transport earning strikes — the replica has TOLD us it
        dies within its grace window, and it will never heal in place.
        Mark it down on the first refusal (bypassing the
        `fail_threshold` count-up) so zero further fetches route at
        it. Returns True when the mark-down happened."""
        if getattr(exc, "code", None) != 503:
            return False
        try:
            snap = json.loads(exc.read().decode("utf-8"))
        except Exception:
            return False
        if not isinstance(snap, dict) or not snap.get("preempting"):
            return False
        with self._lock:
            self._consecutive_failures.pop(peer_id, None)
            self._down[peer_id] = time.monotonic()
            self.preempt_markdowns += 1
        self.registry.mark(peer_id, up=False)
        return True

    def _note_transport_failure(self, peer_id: str):
        with self._lock:
            n = self._consecutive_failures.get(peer_id, 0) + 1
            if n >= self.fail_threshold:
                # reset on trip: when something marks the peer back up
                # it gets its full strike tolerance again, not a
                # hair-trigger leftover count
                self._consecutive_failures.pop(peer_id, None)
                self._down[peer_id] = time.monotonic()
            else:
                self._consecutive_failures[peer_id] = n
        if n >= self.fail_threshold:
            # stop routing at it until something marks it back up; the
            # registry bump makes every router rebuild its ring view
            self.registry.mark(peer_id, up=False)

    def _note_transport_ok(self, peer_id: str):
        with self._lock:
            self._consecutive_failures.pop(peer_id, None)

    def _maybe_probe_down_peers(self):
        """Half-open recovery: for each peer THIS client marked down
        whose cooldown elapsed, probe its /healthz once and mark it
        back up on a 200. Triggered by get() but probed on a short-
        lived daemon thread — a dead host answers a health probe with
        a full connect timeout, and that wait must tax the probe, not
        the live fold request that happened to trip it. The cooldown
        bookkeeping (one probe per peer per window, stamped before the
        thread starts) bounds the threads the same way it bounded the
        inline probes."""
        if not self._down:
            return
        now = time.monotonic()
        with self._lock:
            due = [pid for pid, t in self._down.items()
                   if now - t >= self.recovery_cooldown_s]
            for pid in due:
                self._down[pid] = now       # one probe per window
        for pid in due:
            threading.Thread(target=self._probe_peer, args=(pid,),
                             name=f"peer-probe-{pid}",
                             daemon=True).start()

    def _probe_peer(self, peer_id: str):
        info = self.registry.get(peer_id)
        if info is None or info.peer_addr is None \
                or self.registry.is_healthy(peer_id):
            # deregistered, unprobeable, or already recovered elsewhere:
            # stop tracking it either way
            with self._lock:
                self._down.pop(peer_id, None)
            return
        host, port = info.peer_addr
        try:
            if self.faults is not None:
                self.faults.on_peer_fetch(peer_id)
            with urlrequest.urlopen(f"http://{host}:{port}/healthz",
                                    timeout=self.timeout_s) as resp:
                ok = resp.status == 200
                if ok:
                    ok = self._probe_payload_healthy(resp.read())
        except Exception:
            ok = False                  # still down; cooldown restarts
        if ok:
            with self._lock:
                self._down.pop(peer_id, None)
                self.recoveries += 1
            self.registry.mark(peer_id, up=True)
            self._m_recoveries.inc()

    @staticmethod
    def _probe_payload_healthy(body: bytes) -> bool:
        """A 200 alone does not prove a replica serves: the unified
        health payload (Scheduler.health via the server's
        health_source) may say the breaker is OPEN — the process
        answers HTTP but fast-sheds every novel fold — or that it is
        draining/stopped. Both count as still-down; pre-unification
        payloads (no such fields) keep the old 200-is-up behavior."""
        try:
            snap = json.loads(body.decode("utf-8"))
        except Exception:
            return True           # not JSON: legacy probe, 200 wins
        if snap.get("breaker") == "open":
            return False
        if snap.get("draining") or snap.get("running") is False:
            return False
        if snap.get("preempting"):
            # announced reclaim: the process dies within
            # its grace window — never mark it back up
            return False
        return True

    def get(self, key: str, trace=NULL_TRACE) -> Optional[CachedFold]:
        self._maybe_probe_down_peers()
        owner = self.router.owner_for(key)
        if owner is None or owner == self.self_id:
            return None
        info = self.registry.get(owner)
        if info is None or info.peer_addr is None:
            return None
        tag = self.rollout.tag if self.rollout is not None else ""
        host, port = info.peer_addr
        url = (f"http://{host}:{port}/cache/"
               f"{urlparse.quote(key, safe='')}"
               f"?tag={urlparse.quote(tag, safe='')}")
        # cross-process stitching: the fetch carries the
        # request trace's context so the owner's PeerCacheServer can
        # emit a continued peer_serve record under this hop; the
        # span_id lands on the peer_fetch event below so the fleet
        # aggregator can match the two. Nothing on the wire when
        # tracing is off.
        ctx = trace.wire_context()
        t0 = time.monotonic()
        outcome, value = "error", None
        try:
            if self.faults is not None:
                # injected transport failure: caught by the generic
                # handler below, so chaos exercises the real
                # markdown/recovery machinery
                self.faults.on_peer_fetch(owner)
            req = urlrequest.Request(
                url, headers=ctx.to_headers() if ctx is not None else {})
            with urlrequest.urlopen(req, timeout=self.timeout_s) as resp:
                served_tag = resp.headers.get(_TAG_HEADER)
                body = resp.read()
            if served_tag is not None and served_tag != tag:
                with self._lock:
                    self.stale_tag_hits += 1
                outcome = "stale_tag"
            else:
                value = decode_fold(key, body)
                outcome = "hit"
            self._note_transport_ok(owner)
        except urlerror.HTTPError as exc:
            # 404 = clean miss, 409 = rollout tag mismatch; both prove
            # the transport is alive
            outcome = ("miss" if exc.code == 404
                       else "stale_tag" if exc.code == 409 else "error")
            self._note_transport_ok(owner)
            if outcome == "error":
                if self._note_preempting(owner, exc):
                    outcome = "preempting"
                else:
                    self._note_transport_failure(owner)
        except ValueError:
            outcome = "corrupt"       # decode_fold: bad bytes, live peer
            self._note_transport_ok(owner)
        except Exception:
            outcome = "error"         # refused/timeout/reset
            self._note_transport_failure(owner)
        self._m_latency.observe(time.monotonic() - t0)
        self._m_fetch.inc(peer=owner, outcome=outcome)
        if ctx is not None:
            trace.event("peer_fetch", peer=owner, outcome=outcome,
                        span_id=ctx.parent_span_id)
        else:
            trace.event("peer_fetch", peer=owner, outcome=outcome)
        return value

    # max healthy peers one checkpoint probe sweeps: the probe runs
    # once per orphaned fold (boot/admission, not per request), so a
    # small bound keeps failover cheap on wide fleets while still
    # covering every peer of the 2-4 replica deployments the smoke
    # harness runs
    CKPT_PROBE_LIMIT = 4

    def fetch_checkpoint(self, group: str,
                         model_tag: str = "") -> Optional[bytes]:
        """Checkpoint-tier fetch: ask live peers for the
        newest spilled carry under `group` (a checkpoint GROUP digest,
        cache.checkpoints.checkpoint_group). Unlike get(), there is no
        owner to route to — the replica that spilled the checkpoint is
        the one that just died, and the group digest has no ring
        position — so this probes up to CKPT_PROBE_LIMIT healthy peers
        (never itself) and returns the first hit's raw bytes for the
        caller (CheckpointStore._peer_fetch) to validate with
        decode_checkpoint. Every outcome lands in the same
        fleet_peer_fetch_total{peer,outcome} counter as fold fetches
        (ckpt_hit/ckpt_miss/ckpt_error) and transport failures feed
        the same markdown machinery; never raises."""
        tag = model_tag or (self.rollout.tag
                            if self.rollout is not None else "")
        probed = 0
        for pid in self.registry.member_ids():
            if probed >= self.CKPT_PROBE_LIMIT:
                break
            if pid == self.self_id or not self.registry.is_healthy(pid):
                continue
            info = self.registry.get(pid)
            if info is None or info.peer_addr is None:
                continue
            probed += 1
            host, port = info.peer_addr
            url = (f"http://{host}:{port}/cache/"
                   f"{urlparse.quote(group, safe='')}"
                   f"?kind=checkpoint&tag={urlparse.quote(tag, safe='')}")
            t0 = time.monotonic()
            outcome, body = "ckpt_error", None
            try:
                if self.faults is not None:
                    self.faults.on_peer_fetch(pid)
                with urlrequest.urlopen(url,
                                        timeout=self.timeout_s) as resp:
                    body = resp.read()
                outcome = "ckpt_hit"
                self._note_transport_ok(pid)
            except urlerror.HTTPError as exc:
                # 404 = this peer never saw the fold; 409 = it runs a
                # different tag — both are live-transport misses
                outcome = ("ckpt_miss" if exc.code in (404, 409)
                           else "ckpt_error")
                self._note_transport_ok(pid)
                if outcome == "ckpt_error":
                    if self._note_preempting(pid, exc):
                        outcome = "ckpt_preempting"
                    else:
                        self._note_transport_failure(pid)
            except Exception:
                self._note_transport_failure(pid)
            self._m_latency.observe(time.monotonic() - t0)
            self._m_fetch.inc(peer=pid, outcome=outcome)
            if body is not None:
                return body
        return None
