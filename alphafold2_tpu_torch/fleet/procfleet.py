"""Multi-process fleet harness: N REAL replica processes, one front
door each, and the failure modes a single process cannot have.

`fleet.InProcessFleet` is the fleet's executable spec, but everything
in it shares one Python process — a replica there can never crash,
hang, or partition away from its peers. This module runs the SAME
stack (FoldExecutor + FoldCache + PeerCacheServer + router + Scheduler)
as separate OS processes wired by `fleet.rpc.HttpTransport` against
each replica's `fleet.frontdoor.FrontDoorServer`, so the chaos the
ROADMAP's north star is defined by becomes inducible:

- kill -9 one replica mid-run: its in-flight forwarded tickets
  error-resolve with the transport marker and FAIL OVER to local folds
  on the replicas that forwarded them; client-side submits to the dead
  front door retry on the next replica (`FleetClient`, backed by the
  same `serve.RetryPolicy` classification/backoff the scheduler uses);
- partition one replica (`POST /admin/partition`): both its planes
  (front door AND peer cache, one shared event) refuse with 503 for a
  window — callers mark it down and route around it; the recovery
  probe heals it when the window closes, and `breaker=open` or
  `draining` in the unified health payload keeps a sick-but-listening
  replica marked down;
- rolling drain-restart: SIGTERM wires to `Scheduler.drain()` — stop
  admitting (503 to callers, who go elsewhere), let outstanding
  forwards resolve, fold everything queued, let parked results be
  picked up, exit 0. On restart the replica rejoins at the PERSISTED
  rollout epoch (`<state>/rollout.json`) with its PERSISTED poison
  quarantine (`<state>/quarantine.jsonl`) — no stale-tag serving, no
  re-bisecting known poisons.

`tests/test_torch_fleet_control.py` runs two replicas on the CPU
(`device="cpu"`), and `chip_smoke.py`'s procfleet phase two on the card.
The replica child is this module's `__main__` (`python -m
alphafold2_tpu_torch.fleet.procfleet --config <json-file>`); its config
names its device (`"device": "cpu"`; absent or null is the card).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional
from urllib import request as urlrequest

from alphafold2_tpu_torch.fleet.rpc import RPC_TRANSPORT_MARKER, HttpTransport
from alphafold2_tpu_torch.obs.trace import NULL_TRACE

_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


def _free_port() -> int:
    """An ephemeral port the OS just considered free. Classic
    check-then-use race, acceptable for a localhost harness: the
    window is microseconds and a collision fails loudly at bind."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- parent: the process fleet -------------------------------------------

class ReplicaHandle:
    """One spawned replica process + its addresses and state dirs."""

    def __init__(self, index: int, config: dict, config_path: str):
        self.index = index
        self.config = config
        self.config_path = config_path
        self.proc: Optional[subprocess.Popen] = None
        self.log_path = os.path.join(
            os.path.dirname(config_path), "replica.log")

    @property
    def replica_id(self) -> str:
        return self.config["replica_id"]

    @property
    def frontdoor_url(self) -> str:
        return (f"http://{self.config['host']}:"
                f"{self.config['frontdoor_port']}")

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


class ProcFleet:
    """Spawn, address, and torment N replica processes.

    run_dir: every replica gets `<run_dir>/<rid>/` holding its config,
        log, state (rollout.json / quarantine.jsonl), cache dir, and
        trace JSONL — kill -9 loses the process, never the state.
    model: dict of tiny-model knobs the child builds its executor from
        (dim, depth, msa_depth — the JAX package's synthetic serving
        model: heads 2, dim_head 16, weights from a seeded generator).
    device: where each replica folds — None (the default) is the CUDA
        card and fails at boot without one; "cpu" runs the plain
        PyTorch path. A replica never falls back to the CPU on its own.
    """

    def __init__(self, n_replicas: int, run_dir: str,
                 model_tag: str = "procfleet@v1",
                 buckets: tuple = (32, 64),
                 max_batch: int = 2, max_wait_ms: float = 25.0,
                 num_recycles: int = 0,
                 model: Optional[dict] = None,
                 retry: bool = True,
                 host: str = "127.0.0.1",
                 mesh_policy: str = "",
                 mesh_hbm_gb: float = 16.0,
                 recycle: Optional[dict] = None,
                 feature_pool: Optional[dict] = None,
                 slo: str = "",
                 slo_window_s: float = 60.0,
                 key_log: bool = False,
                 controller: Optional[dict] = None,
                 checkpoint_spill: bool = False,
                 bulk: Optional[dict] = None,
                 cascade: Optional[dict] = None,
                 preemption: bool = False,
                 device: Optional[str] = None):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.run_dir = os.path.abspath(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        self.replicas: List[ReplicaHandle] = []
        self.host = host
        self._n_boot = n_replicas
        # knobs every replica config (boot-time AND runtime-added)
        # inherits — add_replica() writes configs from the same dict
        self._knobs = dict(
            model_tag=model_tag, buckets=list(buckets),
            max_batch=int(max_batch), max_wait_ms=float(max_wait_ms),
            num_recycles=int(num_recycles),
            model=dict(model or {"dim": 32, "depth": 1,
                                 "msa_depth": 3}),
            mesh_policy=str(mesh_policy),
            mesh_hbm_gb=float(mesh_hbm_gb),
            recycle=(None if recycle is None else dict(recycle)),
            feature_pool=(None if feature_pool is None
                          else dict(feature_pool)),
            slo=str(slo), slo_window_s=float(slo_window_s),
            retry=bool(retry), key_log=bool(key_log),
            # durable mid-loop checkpoints: each replica
            # spills step-loop carries under its state dir and serves
            # them to failover peers over the checkpoint artifact kind.
            # preemption implies it: a grace-budgeted drain
            # with nowhere to spill could only cancel.
            checkpoint_spill=bool(checkpoint_spill) or bool(preemption),
            # spot-preemptible serving: each replica runs a
            # PreemptionWatcher on a file notice source, mirrors its
            # spills + orphan manifest into <run_dir>/shared_checkpoints,
            # and takes /admin/adopt assignments; the preempt() chaos
            # verb and the controller's adoption step ride this knob
            preemption=bool(preemption),
            # bulk tier: serve.BulkPolicy kwargs; None =
            # no BulkQueue, qos="bulk" submits fold as plain online
            bulk=(None if bulk is None else dict(bulk)),
            # speculative cascade: each replica builds a
            # small DRAFT model + scheduler (its own registry, shared
            # fold cache under a distinct model_tag) and serves
            # interactive traffic draft-first behind a confidence
            # gate. Keys: model (draft model dims, default dim 16 /
            # depth 1), num_recycles, accept_plddt, max_entropy,
            # escalation_priority, draft_deadline_s. None = no
            # cascade, byte-identical replicas
            cascade=(None if cascade is None else dict(cascade)),
            device=device)
        # optional control plane (OFF when None — the
        # default, byte-identical to a controller-less fleet): dict of
        # fleet.ScalingPolicy knobs + FleetController kwargs; start()
        # builds and runs the reconcile loop against THIS fleet's
        # spawn/drain verbs, stop() stops it first
        self.controller_cfg = (None if controller is None
                               else dict(controller))
        self.controller = None
        ports = [(_free_port(), _free_port()) for _ in range(n_replicas)]
        peer_rows = [{"replica_id": f"r{i}", "host": host,
                      "frontdoor_port": fd, "peer_port": pp}
                     for i, (fd, pp) in enumerate(ports)]
        for i, row in enumerate(peer_rows):
            self._add_handle(i, row, peer_rows, n_replicas)

    def _add_handle(self, i: int, row: dict, all_rows: List[dict],
                    n_total: int) -> "ReplicaHandle":
        """Write replica i's config.json from `row` + the shared knobs
        and append its handle. `all_rows` is the full membership the
        config's static `peers` list is cut from; `n_total` sizes the
        mesh device share."""
        k = self._knobs
        rdir = os.path.join(self.run_dir, row["replica_id"])
        os.makedirs(rdir, exist_ok=True)
        config = dict(
            row,
            model_tag=k["model_tag"],
            state_dir=os.path.join(rdir, "state"),
            cache_dir=os.path.join(rdir, "cache"),
            trace_path=os.path.join(rdir, "traces.jsonl"),
            buckets=list(k["buckets"]),
            max_batch=k["max_batch"],
            max_wait_ms=k["max_wait_ms"],
            num_recycles=k["num_recycles"],
            model=dict(k["model"]),
            # per-replica mesh serving: the spec string rides the
            # config and each replica PROCESS builds its own
            # MeshPolicy over its own device pool at boot
            # (serve.MeshPolicy.parse: "", "auto", or
            # "BUCKET=CHIPS,..."; shapes wider than the pool clamp
            # cleanly, so one fleet config serves 1-device CI and
            # 8-chip hosts alike)
            mesh_policy=k["mesh_policy"],
            mesh_hbm_gb=k["mesh_hbm_gb"],
            # each replica claims the i-th 1/N share of whatever
            # device pool its PROCESS sees: co-hosted replicas must
            # not double-book chips (separate hosts see disjoint
            # pools anyway, so the share is the whole pool there)
            mesh_device_share=[i, n_total],
            # optional step-mode recycle scheduling knobs
            # (serve.RecyclePolicy kwargs); None = opaque folds
            recycle=(None if k["recycle"] is None
                     else dict(k["recycle"])),
            # optional feature pipeline: e.g.
            # {"workers": 2, "latency_ms": 0} builds a per-replica
            # serve.FeaturePool + disk-tiered FeatureCache, so raw
            # (JSON) front-door submissions featurize off the hot
            # path; None = inline featurize (today's behavior)
            feature_pool=(None if k["feature_pool"] is None
                          else dict(k["feature_pool"])),
            # optional SLO objectives: the
            # obs.slo.SLOPolicy.parse spec string; each replica
            # builds its own engine over its own registry, so the
            # slo_* gauges ride its GET /metrics scrape and
            # serve_stats()["slo"] reports its window
            slo=k["slo"],
            slo_window_s=k["slo_window_s"],
            retry=k["retry"],
            checkpoint_spill=k.get("checkpoint_spill", False),
            bulk=(None if k.get("bulk") is None else dict(k["bulk"])),
            cascade=(None if k.get("cascade") is None
                     else dict(k["cascade"])),
            device=k["device"],
            peers=[p for p in all_rows
                   if p["replica_id"] != row["replica_id"]])
        if k["key_log"]:
            # served-key frequency telemetry: the profile
            # the controller's telemetry-driven warming (and
            # cache_warm --from-serve-log) reads
            config["key_log_path"] = os.path.join(rdir, "keys.jsonl")
        if k.get("preemption"):
            # spot-preemptible serving: the file the
            # preempt() verb writes its notice to, and the shared
            # backend every replica mirrors checkpoints + manifests
            # into (what survives the process is what gets adopted)
            config["preemption"] = True
            config["preempt_notice_path"] = os.path.join(
                rdir, "preempt.notice")
            config["shared_checkpoints"] = os.path.join(
                self.run_dir, "shared_checkpoints")
        config_path = os.path.join(rdir, "config.json")
        with open(config_path, "w") as fh:
            json.dump(config, fh, indent=1)
        handle = ReplicaHandle(i, config, config_path)
        self.replicas.append(handle)
        return handle

    # -- lifecycle -------------------------------------------------------

    def spawn(self, index: int) -> ReplicaHandle:
        h = self.replicas[index]
        if h.alive():
            return h
        log = open(h.log_path, "a")
        h.proc = subprocess.Popen(
            [sys.executable, "-m", "alphafold2_tpu_torch.fleet.procfleet",
             "--config", h.config_path],
            cwd=_REPO,
            stdout=log, stderr=subprocess.STDOUT)
        log.close()          # the child holds the fd
        return h

    def start(self, timeout_s: float = 180.0) -> "ProcFleet":
        for i in range(len(self.replicas)):
            self.spawn(i)
        self.wait_ready(timeout_s=timeout_s)
        if self.controller_cfg is not None and self.controller is None:
            self.controller = self._build_controller().start()
        return self

    def _build_controller(self):
        """FleetController over THIS fleet's verbs: policy knobs are
        split out of the config dict by ScalingPolicy's field names;
        the rest pass through to the controller. min/max default to
        [boot size, boot size + 2] so an unconfigured controller holds
        the fleet it was given rather than shrinking it to 1."""
        import dataclasses

        from alphafold2_tpu_torch.fleet.controlplane import FleetController
        from alphafold2_tpu_torch.fleet.scaling import ScalingPolicy
        from alphafold2_tpu_torch.obs.trace import Tracer

        cfg = dict(self.controller_cfg or {})
        policy_fields = {f.name for f in
                         dataclasses.fields(ScalingPolicy)}
        policy_kwargs = {key: cfg.pop(key) for key in list(cfg)
                         if key in policy_fields}
        policy_kwargs.setdefault("min_replicas", self._n_boot)
        policy_kwargs.setdefault(
            "max_replicas",
            max(policy_kwargs["min_replicas"], self._n_boot + 2))
        cfg.setdefault("decisions_path", os.path.join(
            self.run_dir, "controller.decisions.jsonl"))
        if self._knobs.get("preemption"):
            # orphan adoption: the controller reads dead
            # replicas' manifests from the same shared backend the
            # replicas mirror their spills into
            from alphafold2_tpu_torch.fleet.object_store import \
                FilesystemObjectStore
            cfg.setdefault("orphan_store", FilesystemObjectStore(
                os.path.join(self.run_dir, "shared_checkpoints")))
        cfg.setdefault("tracer", Tracer(
            jsonl_path=os.path.join(self.run_dir,
                                    "controller-traces.jsonl"),
            origin="controller"))
        return FleetController(self,
                               policy=ScalingPolicy(**policy_kwargs),
                               **cfg)

    def wait_ready(self, indices: Optional[List[int]] = None,
                   timeout_s: float = 180.0):
        """Block until each replica's /healthz answers 200 with
        running=True (warm executor, both servers up)."""
        deadline = time.monotonic() + timeout_s
        for i in (indices if indices is not None
                  else range(len(self.replicas))):
            h = self.replicas[i]
            while True:
                if not h.alive():
                    raise RuntimeError(
                        f"{h.replica_id} exited rc={h.proc.poll()} "
                        f"before ready (log: {h.log_path})")
                snap = self.healthz(i)
                if snap is not None and snap.get("running"):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{h.replica_id} not ready in {timeout_s}s "
                        f"(log: {h.log_path})")
                time.sleep(0.2)

    def stop(self, timeout_s: float = 60.0):
        """SIGTERM every live replica (graceful drain) and reap;
        escalate to SIGKILL past the timeout. The controller (if any)
        stops FIRST — a reconcile racing the teardown would respawn
        what this is tearing down."""
        if self.controller is not None:
            self.controller.stop()
            tracer = self.controller.tracer
            if tracer is not None:
                try:
                    tracer.close()
                except Exception:
                    pass
        for h in self.replicas:
            if h.alive():
                h.proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + timeout_s
        for h in self.replicas:
            if h.proc is None:
                continue
            try:
                h.proc.wait(max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                h.proc.kill()
                h.proc.wait(10)

    def __enter__(self) -> "ProcFleet":
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- chaos verbs -----------------------------------------------------

    def kill(self, index: int) -> int:
        """kill -9: the crash no handler sees. Returns the (negative)
        returncode."""
        h = self.replicas[index]
        h.proc.kill()
        return h.proc.wait(30)

    def sigterm(self, index: int, timeout_s: float = 60.0) -> int:
        """Graceful drain via SIGTERM; returns the exit code (the
        drain contract is exit 0)."""
        h = self.replicas[index]
        h.proc.send_signal(signal.SIGTERM)
        return h.proc.wait(timeout_s)

    def restart(self, index: int, timeout_s: float = 180.0):
        """Respawn a dead replica on its ORIGINAL ports/state (crash
        recovery: persisted rollout epoch + quarantine load at boot)."""
        self.spawn(index)
        self.wait_ready([index], timeout_s=timeout_s)

    def preempt(self, index: int, grace_s: float = 5.0) -> None:
        """Spot reclaim: deliver a preemption notice with a
        grace window, then hard-kill (-9) whatever is still alive when
        the window closes — exactly the cloud's contract. The replica's
        PreemptionWatcher polls the notice file; a well-behaved replica
        spills its in-flight loops, publishes its orphan manifest, and
        exits clean before the kill lands. Requires preemption=True.

        Returns immediately; the kill runs on a daemon timer so the
        test/loadtest can keep driving the survivors through the grace
        window (where the interesting behavior is)."""
        h = self.replicas[index]
        path = h.config.get("preempt_notice_path")
        if not path:
            raise RuntimeError(
                f"{h.replica_id} has no preempt_notice_path "
                f"(ProcFleet(preemption=True) required)")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"grace_s": float(grace_s),
                       "detail": "procfleet.preempt"}, f)
        os.replace(tmp, path)

        def _kill():
            if h.alive():
                h.proc.kill()
                try:
                    h.proc.wait(30)
                except Exception:
                    pass

        t = threading.Timer(float(grace_s), _kill)
        t.daemon = True
        t.start()

    def partition(self, index: int, duration_s: float) -> bool:
        """Induce a network partition: both the replica's planes refuse
        for `duration_s`, then auto-heal."""
        return self._admin_post(
            index, "/admin/partition",
            {"duration_s": float(duration_s)}) is not None

    def rollout(self, new_tag: str) -> Dict[str, Optional[int]]:
        """Bump the model tag on every LIVE replica (the deployment's
        rollout verb). Dead/partitioned replicas are skipped — they
        rejoin at the right tag from their persisted epoch or are
        409-fenced until an operator rolls them."""
        out = {}
        for i, h in enumerate(self.replicas):
            resp = self._admin_post(i, "/admin/rollout",
                                    {"tag": new_tag})
            out[h.replica_id] = (None if resp is None
                                 else resp.get("epoch"))
        return out

    # -- control-plane actuator surface -----------------------

    def add_replica(self) -> int:
        """Provision a NEW replica slot at runtime (fresh id, ports,
        state dirs; static `peers` = the whole current membership so
        its boot registry sees everyone). Returns its index — spawn()
        it to bring it up. Existing replicas learn about it through
        the controller's /admin/peers fan-out, not their configs."""
        i = len(self.replicas)
        row = {"replica_id": f"r{i}", "host": self.host,
               "frontdoor_port": _free_port(),
               "peer_port": _free_port()}
        all_rows = [{"replica_id": h.replica_id,
                     "host": h.config["host"],
                     "frontdoor_port": h.config["frontdoor_port"],
                     "peer_port": h.config["peer_port"]}
                    for h in self.replicas] + [row]
        self._add_handle(i, row, all_rows, len(all_rows))
        return i

    def scale_up(self) -> Optional[str]:
        """Controller verb: provision + spawn one replica; returns its
        id immediately (readiness shows up on the endpoint watch when
        the executor is warm — the controller never blocks on it)."""
        i = self.add_replica()
        self.spawn(i)
        return self.replicas[i].replica_id

    def scale_down(self, replica_id: str) -> bool:
        """Controller verb: graceful drain (SIGTERM — the same drain
        contract rolling restarts use) WITHOUT blocking; the exit is
        reaped in the background. Never kills: drain-before-kill is
        the policy, and the policy layer already refused sub-quorum
        targets."""
        for h in self.replicas:
            if h.replica_id == replica_id and h.alive():
                h.proc.send_signal(signal.SIGTERM)
                threading.Thread(target=h.proc.wait,
                                 name=f"reap-{replica_id}",
                                 daemon=True).start()
                return True
        return False

    def endpoints(self) -> Dict[str, str]:
        """Live replicas' front-door base URLs — the controller's
        endpoint-watch source. A dead process drops out here, which is
        what unregisters it from the controller's membership."""
        return {h.replica_id: h.frontdoor_url
                for h in self.replicas if h.alive()}

    def peer_rows(self) -> List[dict]:
        """Full address rows for every provisioned replica — what the
        controller fans out to /admin/peers on join."""
        return [{"replica_id": h.replica_id,
                 "host": h.config["host"],
                 "frontdoor_port": h.config["frontdoor_port"],
                 "peer_port": h.config["peer_port"]}
                for h in self.replicas]

    def key_log_paths(self) -> Dict[str, str]:
        """Served-key frequency files (empty unless key_log=True)."""
        return {h.replica_id: h.config["key_log_path"]
                for h in self.replicas
                if h.config.get("key_log_path")}

    # -- views -----------------------------------------------------------

    def healthz(self, index: int) -> Optional[dict]:
        return self._get_json(index, "/healthz")

    def stats(self, index: int) -> Optional[dict]:
        return self._get_json(index, "/admin/stats")

    def _get_json(self, index: int, path: str,
                  timeout_s: float = 5.0) -> Optional[dict]:
        url = self.replicas[index].frontdoor_url + path
        try:
            with urlrequest.urlopen(url, timeout=timeout_s) as resp:
                if resp.status != 200:
                    return None
                return json.loads(resp.read().decode("utf-8"))
        except Exception:
            return None

    def _admin_post(self, index: int, path: str, payload: dict,
                    timeout_s: float = 5.0) -> Optional[dict]:
        url = self.replicas[index].frontdoor_url + path
        req = urlrequest.Request(
            url, data=json.dumps(payload).encode("utf-8"),
            headers={"Content-Type": "application/json"},
            method="POST")
        try:
            with urlrequest.urlopen(req, timeout=timeout_s) as resp:
                return json.loads(resp.read().decode("utf-8"))
        except Exception:
            return None

    def merge_traces(self, out_path: str, extra_paths: tuple = ()):
        """Concatenate every replica's trace JSONL (plus extra files,
        e.g. the client's own) into one file for obs_report. A replica
        killed -9 mid-write can leave a torn tail line — skipped here
        (a torn line is the crash's signature, not an obs bug)."""
        paths = [h.config["trace_path"] for h in self.replicas]
        paths += list(extra_paths)
        with open(out_path, "w") as out:
            for p in paths:
                try:
                    with open(p) as fh:
                        for line in fh:
                            line = line.strip()
                            if not line:
                                continue
                            try:
                                json.loads(line)
                            except ValueError:
                                continue      # torn tail from kill -9
                            out.write(line + "\n")
                except OSError:
                    continue


class FleetClient:
    """The client-side front-door load balancer with failover.

    One `HttpTransport` per replica; `fold()` submits round-robin from
    a caller-chosen seat and retries on the NEXT replica whenever the
    chosen one cannot take or finish the work: refused/draining/queue-
    full submit, transport-marker error resolution (owner died or
    partitioned mid-fold), or a result timeout (which also fires the
    remote cancel). Classification and backoff come from the same
    `serve.RetryPolicy` the scheduler uses — the fleet has ONE notion
    of what is transient. A request only errors out when every replica
    in turn failed it `max_rounds` times — with one induced failure at
    a time and N >= 2 that never happens, which is exactly the
    zero-lost-requests property."""

    def __init__(self, urls: List[str], retry=None,
                 result_timeout_s: float = 120.0, max_rounds: int = 3,
                 metrics=None):
        from alphafold2_tpu_torch.serve.resilience import RetryPolicy

        if not urls:
            raise ValueError("FleetClient needs at least one URL")
        self._metrics = metrics
        self.transports = [HttpTransport(u, metrics=metrics)
                           for u in urls]
        self.retry = retry or RetryPolicy(
            max_attempts=4, backoff_base_s=0.1, backoff_max_s=1.0)
        self.result_timeout_s = float(result_timeout_s)
        self.max_rounds = int(max_rounds)
        self._lock = threading.Lock()
        self.submit_retries = 0       # submit refused, went elsewhere
        self.failovers = 0            # terminal transport-marker errors
        self.timeouts = 0             # result timeouts (remote-cancelled)
        self.preempt_markdowns = 0    # replicas skipped on announced
        #                               reclaim
        self.preempt_failovers = 0    # "preempted" terminals resubmitted
        self._preempting: set = set()  # base_urls marked preempting

    def _count(self, field: str):
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)

    def _note_preempting(self, transport, exc) -> bool:
        """503 with `"preempting": true` in the body: the
        replica announced its own death — mark it out of the rotation
        NOW (no strike count-up, no backoff) and return True. Any
        other refusal returns False and takes the normal retry path."""
        if getattr(exc, "code", None) != 503:
            return False
        try:
            snap = json.loads(exc.read().decode("utf-8"))
        except Exception:
            return False
        if not isinstance(snap, dict) or not snap.get("preempting"):
            return False
        self._mark_preempting(transport)
        return True

    def _mark_preempting(self, transport):
        with self._lock:
            if transport.base_url not in self._preempting:
                self._preempting.add(transport.base_url)
                self.preempt_markdowns += 1

    def _pick(self, seat: int):
        """The round-robin seat, skipping replicas marked preempting —
        unless every replica is marked, in which case the raw seat
        stands (a wrong guess beats refusing to try)."""
        n = len(self.transports)
        with self._lock:
            marked = set(self._preempting)
        if marked:
            for off in range(n):
                t = self.transports[(seat + off) % n]
                if t.base_url not in marked:
                    return t
        return self.transports[seat % n]

    def set_urls(self, urls: List[str]):
        """Grow the failover set at runtime (a controller-
        scaled fleet should receive client traffic on its NEW replicas
        too). Add-only: a URL that died just keeps failing over — the
        fold loop already routes around it — so removal would only
        race in-flight seat arithmetic for no benefit."""
        with self._lock:
            known = {t.base_url for t in self.transports}
            fresh = [u for u in urls
                     if u.rstrip("/") not in known]
        for u in fresh:
            # append is atomic; fold()'s modulo seat math tolerates
            # growth between attempts
            self.transports.append(
                HttpTransport(u, metrics=self._metrics))

    def fold(self, request, hint: int = 0, trace=NULL_TRACE):
        """Submit `request` and block for its terminal FoldResponse,
        failing over across replicas. Raises RuntimeError only when
        every replica failed it repeatedly."""
        from urllib.error import HTTPError

        n = len(self.transports)
        last = None
        for attempt in range(self.max_rounds * n):
            transport = self._pick(hint + attempt)
            try:
                ticket = transport.submit(request, trace=trace)
            except HTTPError as exc:
                if self._note_preempting(transport, exc):
                    # announced reclaim: skip this replica
                    # for good and go straight at the next seat — no
                    # backoff, the refusal was authoritative, not flaky
                    last = exc
                    self._count("submit_retries")
                    continue
                if exc.code < 500 and exc.code != 429:
                    # deterministic client error (400 bad request,
                    # 409 tag fence): every replica will refuse it the
                    # same way — surface it, don't burn a failover
                    # round per replica
                    raise
                last = exc
                self._count("submit_retries")
                time.sleep(self.retry.delay_s(attempt + 1))
                continue
            except Exception as exc:
                # dead / draining / partitioned / full front door:
                # nothing was accepted, the next replica takes it
                last = exc
                self._count("submit_retries")
                time.sleep(self.retry.delay_s(attempt + 1))
                continue
            try:
                resp = ticket.result(timeout=self.result_timeout_s)
            except TimeoutError as exc:
                # result(timeout=) already sent the remote cancel
                last = exc
                self._count("timeouts")
                continue
            if resp.status == "error" and resp.error \
                    and RPC_TRANSPORT_MARKER in resp.error:
                # owner died mid-fold: at-least-once beats lost
                last = RuntimeError(resp.error)
                self._count("failovers")
                time.sleep(self.retry.delay_s(attempt + 1))
                continue
            if resp.status == "preempted":
                # the replica spilled this fold's mid-loop checkpoint
                # and is exiting: resubmit IMMEDIATELY on a
                # survivor — the survivor's submit consult resumes from
                # the spilled recycle, so the retry pays only the
                # recycles since the last checkpoint, and no backoff is
                # owed (the terminal was an announcement, not a fault)
                last = RuntimeError(resp.error or "replica preempted")
                self._count("preempt_failovers")
                self._mark_preempting(transport)
                continue
            return resp
        raise RuntimeError(
            f"all {n} replicas failed {request.request_id} "
            f"({self.max_rounds} rounds; last: {last!r})")

    def snapshot(self) -> dict:
        with self._lock:
            out = {"submit_retries": self.submit_retries,
                   "failovers": self.failovers,
                   "timeouts": self.timeouts}
            if self.preempt_markdowns or self.preempt_failovers:
                # keys absent until a reclaim happened, so baseline
                # loadtest reports compare byte-identical
                out["preempt_markdowns"] = self.preempt_markdowns
                out["preempt_failovers"] = self.preempt_failovers
            return out


# -- child: one replica process ------------------------------------------

def replica_model(mcfg: dict, device, seed: int = 0):
    """One replica's serving model: the JAX child's widths (heads 2,
    dim_head 16, one structure-module layer, dims from the config),
    weights drawn from a generator seeded `seed` — every replica of a
    fleet holds the same weights, as every JAX replica inits from one
    PRNGKey."""
    import torch

    from alphafold2_tpu_torch.model.alphafold2 import Alphafold2

    return Alphafold2(dim=int(mcfg["dim"]), depth=int(mcfg["depth"]),
                      heads=2, dim_head=16, predict_coords=True,
                      structure_module_depth=1, device=device,
                      generator=torch.Generator().manual_seed(seed))


def replica_main(config: dict) -> int:
    """Build and serve one full replica from a ProcFleet config dict;
    blocks until SIGTERM (graceful drain, exit 0). The replica folds
    on `config["device"]`: None is the CUDA card (no card raises at
    boot), "cpu" the plain PyTorch path."""
    from alphafold2_tpu_torch import obs, serve
    from alphafold2_tpu_torch.device import resolve_device
    from alphafold2_tpu_torch.fleet.frontdoor import FrontDoorServer
    from alphafold2_tpu_torch.fleet.peer import (PeerCacheClient,
                                                 PeerCacheServer)
    from alphafold2_tpu_torch.fleet.registry import ReplicaRegistry
    from alphafold2_tpu_torch.fleet.router import ConsistentHashRouter

    device = resolve_device(config.get("device"))

    rid = config["replica_id"]
    host = config["host"]
    state_dir = config["state_dir"]
    os.makedirs(state_dir, exist_ok=True)

    # membership: fed from the deployment config (the control plane of
    # this harness); rollout state is DURABLE so a crashed/drained
    # replica rejoins at the tag the fleet rolled to, not its boot tag
    registry = ReplicaRegistry(
        model_tag=config["model_tag"],
        rollout_persist_path=os.path.join(state_dir, "rollout.json"))
    rollout = registry.rollout

    policy = serve.BucketPolicy(config["buckets"])
    mcfg = config["model"]
    model = replica_model(mcfg, device, seed=0)
    msa_depth = int(mcfg["msa_depth"])
    executor = serve.FoldExecutor(model, max_entries=policy.num_buckets)

    from alphafold2_tpu_torch.cache import FoldCache
    cache = FoldCache(disk_dir=config["cache_dir"])
    router = ConsistentHashRouter(registry, rid)
    client = PeerCacheClient(registry, rid, router=router,
                             rollout=rollout)
    cache.peer = client

    registry.register(rid)
    for peer in config["peers"]:
        registry.register(
            peer["replica_id"],
            peer_addr=(peer["host"], int(peer["peer_port"])),
            transport=HttpTransport(
                f"http://{peer['host']}:{peer['frontdoor_port']}",
                rollout=rollout))

    # origin-tagged tracer: globally unique trace ids +
    # an `origin` field on every record, so N replicas' JSONL merges
    # into one stitchable fleet set — and inbound submits carrying a
    # TraceContext continue the sender's trace on this tracer
    tracer = obs.Tracer(jsonl_path=config["trace_path"], origin=rid)
    retry = None
    if config.get("retry", True):
        retry_kw = dict(max_attempts=4, backoff_base_s=0.02,
                        backoff_max_s=0.5)
        if config.get("checkpoint_spill"):
            # durable spill rides the carry-checkpoint cadence under
            # the replica's state dir: kill -9 loses the process, the
            # restarted replica resumes survivors at their spilled age
            retry_kw.update(
                checkpoint_every=1,
                checkpoint_spill=os.path.join(state_dir, "checkpoints"))
        retry = serve.RetryPolicy(**retry_kw)
    # optional step-mode recycle scheduling from the fleet config:
    # the same RecyclePolicy knobs the loadtest's --recycle-sched sets
    recycle_cfg = config.get("recycle")
    recycle_policy = (None if not recycle_cfg
                      else serve.RecyclePolicy(**recycle_cfg))
    # optional feature pipeline from the fleet config: the pool's
    # feature cache gets its own disk tier NEXT TO the fold cache (same
    # crash-recovery story — a restarted replica re-reads its features)
    feat_cfg = config.get("feature_pool")
    feature_pool = None
    if feat_cfg:
        from alphafold2_tpu_torch.cache import FeatureCache
        feature_pool = serve.FeaturePool(
            workers=int(feat_cfg.get("workers", 2)),
            cache=FeatureCache(disk_dir=os.path.join(
                config["cache_dir"], "features")),
            latency_s=float(feat_cfg.get("latency_ms", 0.0)) / 1000.0,
            # featurize executor backend: "process" runs
            # the pure featurize computation on a ProcessPoolExecutor
            # (the GIL prerequisite for real jackhmmer/mmseqs)
            executor=str(feat_cfg.get("executor", "thread")),
            # express lane: the deterministic stub embedder
            # stands in for a pretrained embedding-injection model, so
            # qos="express" raw submits skip MSA prep entirely
            express=(serve.StubEmbedder(
                dim=int(feat_cfg.get("express_dim", 16)))
                if feat_cfg.get("express") else None),
            express_deadline_s=(
                float(feat_cfg["express_deadline_ms"]) / 1000.0
                if feat_cfg.get("express_deadline_ms") else None))
    # per-replica mesh policy from the fleet config: the port serves
    # on one device, so the replica's pool is its own device (a wider
    # shape clamps to it)
    mesh_devices = [device] if config.get("mesh_policy") else None
    mesh_policy = serve.MeshPolicy.parse(
        config.get("mesh_policy", ""), model=model, params=None,
        buckets=policy, max_batch=int(config["max_batch"]),
        msa_depth=msa_depth,
        hbm_gb=float(config.get("mesh_hbm_gb", 16.0)),
        devices=mesh_devices,
        carry_recyclables=recycle_policy is not None,
        continuous=bool(recycle_policy is not None
                        and recycle_policy.continuous))
    # optional SLO engine: per-QoS-class objectives over
    # this process's default registry — the same one every serve_*
    # metric mirrors into and GET /metrics renders
    slo_engine = None
    if config.get("slo"):
        slo_engine = obs.SLOEngine(obs.SLOPolicy.parse(
            config["slo"],
            window_s=float(config.get("slo_window_s", 60.0))))
    # optional served-key frequency telemetry: ingress
    # submits aggregate into a cache_warm-format profile the control
    # plane's telemetry-driven warming tails
    key_log = None
    if config.get("key_log_path"):
        from alphafold2_tpu_torch.serve.metrics import KeyFrequencyLog
        key_log = KeyFrequencyLog(config["key_log_path"])
    # speculative cascade: a small draft model + scheduler
    # on an ISOLATED registry (draft series must not sum into this
    # replica's scrape), SHARING the fold cache under a distinct
    # model_tag — tier isolation is by cache key construction
    casc_cfg = config.get("cascade")
    cascade_policy = None
    draft_scheduler = None
    if casc_cfg:
        dcfg = dict(casc_cfg.get("model") or {"dim": 16, "depth": 1})
        draft_model = replica_model(
            {"dim": dcfg.get("dim", 16), "depth": dcfg.get("depth", 1)},
            device, seed=1)
        draft_executor = serve.FoldExecutor(
            draft_model, max_entries=policy.num_buckets)
        draft_scheduler = serve.build_draft_scheduler(
            draft_executor, policy,
            config=serve.SchedulerConfig(
                max_batch_size=int(config["max_batch"]),
                max_wait_ms=float(config["max_wait_ms"]),
                num_recycles=int(casc_cfg.get("num_recycles", 0)),
                msa_depth=msa_depth,
                confidence_summary=True),
            model_tag=f"{rollout.tag}#draft",
            cache=cache)
        cascade_policy = serve.CascadePolicy(
            draft=draft_scheduler,
            gate=serve.ConfidenceGate(
                accept_plddt=float(casc_cfg.get("accept_plddt", 0.70)),
                max_entropy=casc_cfg.get("max_entropy")),
            escalation_priority=int(
                casc_cfg.get("escalation_priority", 10)),
            draft_deadline_s=casc_cfg.get("draft_deadline_s"))
    scheduler = serve.Scheduler(
        executor, policy,
        serve.SchedulerConfig(
            max_batch_size=int(config["max_batch"]),
            max_wait_ms=float(config["max_wait_ms"]),
            num_recycles=int(config["num_recycles"]),
            msa_depth=msa_depth),
        cache=cache, model_tag=rollout.tag, tracer=tracer,
        router=router, retry=retry,
        quarantine_path=os.path.join(state_dir, "quarantine.jsonl"),
        mesh_policy=mesh_policy, recycle_policy=recycle_policy,
        feature_pool=feature_pool, slo=slo_engine, key_log=key_log,
        bulk=(None if not config.get("bulk")
              else serve.BulkPolicy(**config["bulk"])),
        cascade=cascade_policy)
    # fleet tiers for the durable checkpoint store: this
    # replica's spills become fetchable by failover peers
    # (checkpoint_source below), and ITS resume path can pull a dead
    # peer's spill through the same client that fetches fold results
    if scheduler.checkpoint_store is not None:
        scheduler.checkpoint_store.peer = client
        if config.get("shared_checkpoints"):
            # spot preemption: mirror spills + the orphan
            # manifest into the fleet-shared backend — what survives
            # the reclaimed PROCESS is what the controller can hand a
            # survivor to adopt after the hard kill lands
            from alphafold2_tpu_torch.fleet.object_store import \
                FilesystemObjectStore
            scheduler.checkpoint_store.backend = FilesystemObjectStore(
                config["shared_checkpoints"])
    # a rollout re-tags the executor, which orphans every program
    # built under the previous tag (the staleness fix) —
    # re-warm in the BACKGROUND so a rolled replica rebuilds its
    # serving shapes eagerly instead of on the first unlucky request
    # (the cost exists either way; paying it off the request path is
    # what keeps a controller-driven rollout invisible to latency)
    rewarm = threading.Event()

    def _on_rollout(tag, epoch):
        scheduler.model_tag = tag    # O(1) under the state lock
        if draft_scheduler is not None:
            # the draft tier follows the rollout under its derived
            # tag, so cross-tier key distinctness survives re-tagging
            draft_scheduler.model_tag = f"{tag}#draft"
        rewarm.set()

    rollout.subscribe(_on_rollout)

    def _rewarm_loop():
        while True:
            rewarm.wait()
            rewarm.clear()
            try:
                scheduler.warmup()
            except Exception:
                pass             # cold-serve fallback: build on use

    threading.Thread(target=_rewarm_loop, daemon=True,
                     name=f"{rid}-rewarm").start()

    partition = threading.Event()
    frontdoor = FrontDoorServer(scheduler, rollout=rollout,
                                host=host,
                                port=int(config["frontdoor_port"]),
                                replica_id=rid, partition=partition)
    peer_server = PeerCacheServer(cache, rollout=rollout, host=host,
                                  port=int(config["peer_port"]),
                                  replica_id=rid,
                                  health_source=scheduler.health,
                                  partition=partition)
    # checkpoint artifact kind: peers resuming this
    # replica's orphaned folds fetch its spilled carries here
    peer_server.checkpoint_source = scheduler.checkpoint_store
    frontdoor.extra_stats = lambda: {
        "peer": {"stale_tag_hits": client.stale_tag_hits,
                 "recoveries": client.recoveries},
        "frontdoor": frontdoor.snapshot(),
        "rollout": {"tag": rollout.tag, "epoch": rollout.epoch}}

    # runtime membership verbs: the control plane's
    # /admin/peers fan-out rebuilds THIS replica's ring at runtime —
    # a mid-run join starts receiving forwards, a swept member stops
    def _peer_admin(op: str, peer: dict) -> dict:
        pid = str(peer["replica_id"])
        if pid == rid:
            return {"replicas": registry.member_ids()}  # not my own row
        if op == "register":
            registry.register(
                pid,
                peer_addr=(peer["host"], int(peer["peer_port"])),
                transport=HttpTransport(
                    f"http://{peer['host']}:{peer['frontdoor_port']}",
                    rollout=rollout))
        elif op == "unregister":
            registry.unregister(pid)
        elif op in ("up", "down"):
            registry.mark(pid, op == "up")
        return {"replicas": registry.member_ids(),
                "epoch": registry.epoch}

    frontdoor.peer_admin = _peer_admin

    # orphan adoption: the controller POSTs a dead peer's
    # manifest rows here; each fold resumes from its spilled
    # checkpoint (shared backend / peer artifact tier) at the spilled
    # recycle age instead of refolding from zero — the fold_key is
    # content-derived, so the resumed result is byte-equal to an
    # uninterrupted fold of the same request
    def _adopt(payload: dict) -> dict:
        import numpy as np
        store = scheduler.checkpoint_store
        if store is None:
            raise RuntimeError("no checkpoint store: cannot adopt")
        adopted = failed = 0
        dead = str(payload.get("replica_id") or "?")
        for rec in payload.get("orphans") or []:
            fk = str((rec or {}).get("fold_key") or "")
            ck = store.latest(fk) if fk else None
            if ck is None or ck.seq is None:
                failed += 1
                continue
            trace = tracer.start_trace(f"adopt-{fk[:12]}")
            trace.begin("adopt")
            req = serve.FoldRequest(
                seq=np.asarray(ck.seq),
                msa=None if ck.msa is None else np.asarray(ck.msa),
                request_id=f"adopt-{dead}-{fk[:12]}")
            scheduler.submit(req, trace=trace)
            trace.end("adopt", source=dead, age=int(ck.age))
            adopted += 1
        return {"adopted": adopted, "failed": failed}

    if config.get("preemption"):
        frontdoor.adopt_handler = _adopt
    # peer-cache fetches served here emit continued trace records
    # under the requester's peer_fetch hop
    peer_server.tracer = tracer
    if slo_engine is not None:
        # a /metrics scrape refreshes the slo_* gauges first, so the
        # scraped window is as fresh as a serve_stats() poll's —
        # whichever of the two ports the scraper targets
        frontdoor.metrics_hook = slo_engine.report
        peer_server.metrics_hook = slo_engine.report

    scheduler.warmup()
    scheduler.start()
    peer_server.start()
    frontdoor.start()

    stop_event = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop_event.set())
    signal.signal(signal.SIGINT, lambda *a: stop_event.set())

    # preemption watcher: a file notice (the preempt()
    # chaos verb; in real deployments the metadata/signal sources)
    # flips the scheduler into reclaim mode on the watcher thread,
    # then wakes the main thread to run the grace-budgeted shutdown.
    # SIGTERM stays the GRACEFUL drain (the scale-down contract) —
    # the notice file is the reclaim channel.
    notice_box: List = []
    watcher = None
    if config.get("preemption") and config.get("preempt_notice_path"):
        from alphafold2_tpu_torch.serve.preemption import (
            FileNoticeSource, PreemptionWatcher)

        def _on_notice(n):
            notice_box.append(n)
            stop_event.set()

        watcher = PreemptionWatcher(
            [FileNoticeSource(config["preempt_notice_path"])],
            scheduler=scheduler, on_notice=_on_notice,
            poll_s=0.1).start()
    print(json.dumps({"ready": rid,
                      "frontdoor": list(frontdoor.address),
                      "peer": list(peer_server.address),
                      "tag": rollout.tag,
                      "epoch": rollout.epoch,
                      "device": str(device)}), flush=True)

    stop_event.wait()

    if notice_box:
        # spot reclaim: the grace window buys a MIGRATION,
        # not a finish — spill every loop the budget can't fit,
        # publish the orphan manifest into the shared backend, and be
        # gone before the hard kill lands. The last second of grace is
        # reserved for the manifest + the exit itself.
        notice = notice_box[0]
        if watcher is not None:
            watcher.stop()
        if feature_pool is not None:
            feature_pool.stop()
        budget = max(0.5, notice.deadline_s - time.monotonic() - 1.0)
        complete = scheduler.drain(grace_s=budget)
        manifest = None
        if scheduler.checkpoint_store is not None:
            try:
                manifest = scheduler.checkpoint_store.publish_manifest(
                    rid)
            except Exception:
                manifest = None
        # no graceful stop of the two HTTP servers here: shutdown waits
        # out each serve loop's poll interval and closing joins the
        # handlers of in-flight long-polls, which overran the reserve
        # on the card and turned a clean exit into -9; os._exit below
        # closes their sockets anyway
        tracer.close()
        print(json.dumps({
            "preempted": rid, "complete": complete,
            "grace_s": notice.grace_s,
            "orphans": (0 if not manifest
                        else len(manifest.get("orphans", [])))}),
            flush=True)
        # _exit, not return: interpreter teardown joins every lingering
        # thread (spilled-but-stuck step loops, executor atexit hooks)
        # and can outlive the reclaim deadline — everything durable
        # (manifest, traces, stdout) is already flushed, so die now
        # rather than let the hard kill turn a clean exit into -9
        sys.stdout.flush()
        os._exit(0)

    # graceful drain: refuse new work, finish what we owe, let parked
    # results be picked up, then exit 0 — the SIGTERM contract a
    # rolling restart relies on
    if watcher is not None:
        watcher.stop()
    if feature_pool is not None:
        # featurize workers submit into the scheduler: drain them
        # first so the scheduler's drain sees every owed fold
        feature_pool.stop()
    complete = scheduler.drain()
    grace_deadline = time.monotonic() + 10.0
    while (frontdoor.snapshot()["parked_tickets"] > 0
           and time.monotonic() < grace_deadline):
        time.sleep(0.05)
    frontdoor.stop()
    peer_server.stop()
    tracer.close()
    print(json.dumps({"drained": rid, "complete": complete}),
          flush=True)
    return 0


def _main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="one procfleet replica process")
    ap.add_argument("--config", required=True,
                    help="path to the replica's config.json")
    args = ap.parse_args(argv)
    with open(args.config) as fh:
        config = json.load(fh)
    return replica_main(config)


if __name__ == "__main__":
    sys.exit(_main())
