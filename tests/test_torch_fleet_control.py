"""The port's control plane (fleet/scaling, fleet/controlplane,
fleet/procfleet) against the JAX package's, on the CPU.

The scaling functions are pure: seeded signals must give the same
decisions. The controller reconciles an in-process actuator of real
front doors over stub schedulers, one per package, under a fake clock:
the same join / quorum-restore / sweep / leave history gives the same
records. Warming from telemetry is checked without the race of the JAX
package's own test: the warm fold is held by an event until both
reconciles have run, so the dedup is read before the ticket can finish.
Last, two replica processes of the port (`"device": "cpu"`) take a
request through the front doors, a killed one is replaced by a
reconcile, and the survivors drain with exit 0.
"""

import threading

import numpy as np
import pytest

from alphafold2_tpu import fleet as jax_fleet
from alphafold2_tpu import serve as jax_serve
from alphafold2_tpu.fleet import controlplane as jax_cp
from alphafold2_tpu.fleet import scaling as jax_scaling
from alphafold2_tpu.obs.registry import MetricsRegistry as JaxRegistry
from alphafold2_tpu.serve.metrics import KeyFrequencyLog as JaxKeyLog
from alphafold2_tpu_torch import fleet as pt_fleet
from alphafold2_tpu_torch import serve as pt_serve
from alphafold2_tpu_torch.fleet import controlplane as pt_cp
from alphafold2_tpu_torch.fleet import scaling as pt_scaling
from alphafold2_tpu_torch.obs.registry import MetricsRegistry as PtRegistry
from alphafold2_tpu_torch.serve.metrics import KeyFrequencyLog as PtKeyLog
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)


SIDES = ("jax", "port")
FLEET = {"jax": jax_fleet, "port": pt_fleet}
SERVE = {"jax": jax_serve, "port": pt_serve}
CP = {"jax": jax_cp, "port": pt_cp}
SCALING = {"jax": jax_scaling, "port": pt_scaling}
REG = {"jax": JaxRegistry, "port": PtRegistry}
KEYLOG = {"jax": JaxKeyLog, "port": PtKeyLog}
MSA_DEPTH = 3


# -- scaling ---------------------------------------------------------------

def _signals(side, rng, n, quiet=False):
    """n replicas' signals; a `quiet` fleet is healthy, idle and under
    budget (the scale-down side of the band)."""
    S = SCALING[side].ReplicaSignals
    if quiet:
        return [S(replica_id=f"r{i}", queue_depth=int(rng.integers(0, 4)),
                  burn_rate=float(rng.choice([0.0, 0.2, 0.6])),
                  idle_fraction=float(0.7 + 0.3 * rng.random()))
                for i in range(n)]
    return [S(replica_id=f"r{i}",
              healthy=bool(rng.random() > 0.05),
              draining=bool(rng.random() < 0.05),
              preempting=bool(rng.random() < 0.03),
              queue_depth=int(rng.integers(0, 6)),
              served=int(rng.integers(0, 50)),
              burn_rate=float(rng.choice([0.0, 0.0, 0.1, 0.3, 0.7, 1.2,
                                          3.0, np.inf])),
              idle_fraction=float(rng.choice([rng.random(), 0.95])),
              featurize_queue_depth=int(rng.integers(0, 12)),
              featurize_workers=int(rng.integers(1, 4)))
            for i in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_scaling_decisions_match_jax(seed):
    """200 seeded fleets through decide_scale (with cooldown and pending
    spawns), drain_target and decide_feature_workers."""
    out = {}
    for side in SIDES:
        sc = SCALING[side]
        policy = sc.ScalingPolicy(min_replicas=2, max_replicas=5,
                                  up_burn_rate=1.0, down_burn_rate=0.5,
                                  down_idle_fraction=0.8, cooldown_s=30.0)
        rng = np.random.default_rng(seed)
        rows = []
        for i in range(200):
            sigs = _signals(side, rng, int(rng.integers(1, 6)),
                            quiet=i % 3 == 0)
            last = (None if rng.random() < 0.5
                    else float(100.0 - rng.integers(0, 60)))
            d = sc.decide_scale(policy, sigs, now=100.0,
                                last_action_s=last,
                                pending=int(rng.integers(0, 2)))
            rows.append((d.action, d.reason, d.drain_target, d.healthy,
                         d.pending, d.fleet_burn, d.fleet_idle,
                         sc.drain_target(sigs),
                         [sc.decide_feature_workers(policy, s)
                          for s in sigs]))
        out[side] = rows
    assert out["jax"] == out["port"]
    actions = {r[0] for r in out["port"]}
    assert actions == {"hold", "scale_up", "scale_down"}


# -- the reconcile cycle ---------------------------------------------------

class _Executor:
    """Opaque-fold stand-in; `hold` (set by default) gates every fold."""

    def __init__(self):
        self.hold = threading.Event()
        self.hold.set()
        self.calls = 0

    def run(self, batch, num_recycles, trace=None, **kw):
        assert self.hold.wait(60)
        self.calls += 1
        seq = batch["seq"]
        b, n = tuple(seq.shape)

        class R:
            coords = np.zeros((b, n, 3), np.float32)
            confidence = np.full((b, n), 0.5, np.float32)
        return R()

    def stats(self):
        return {"calls": self.calls}


class _CpuModel:
    device = "cpu"


class _Mini:
    """In-process actuator: one real FrontDoorServer per replica over a
    stub scheduler of `side`; the fleet verbs are method calls."""

    def __init__(self, side, tmp_path=None, executor=None):
        self.side = side
        self.tmp_path = tmp_path
        self.executor = executor
        self.doors = {}
        self.extra = {}
        self._next = 0

    def spawn(self):
        s, f = SERVE[self.side], FLEET[self.side]
        rid = f"r{self._next}"
        self._next += 1
        ex = self.executor or _Executor()
        if self.side == "port":
            ex.model = _CpuModel()
        reg = REG[self.side]()
        sched = s.Scheduler(ex, s.BucketPolicy((16,)),
                            s.SchedulerConfig(max_batch_size=2,
                                              max_wait_ms=5.0, poll_ms=2.0,
                                              msa_depth=MSA_DEPTH),
                            s.ServeMetrics(registry=reg), model_tag="cp",
                            registry=reg)
        door = f.FrontDoorServer(
            sched, rollout=f.RolloutState("v1", registry=REG[self.side]()),
            replica_id=rid, metrics=reg)
        sched.start()
        door.start()
        self.doors[rid] = (sched, door)
        return rid

    def endpoints(self):
        out = {rid: d.url for rid, (_, d) in self.doors.items()}
        out.update(self.extra)
        return out

    def scale_up(self):
        return self.spawn()

    def scale_down(self, rid):
        return self.remove(rid)

    def remove(self, rid):
        pair = self.doors.pop(rid, None)
        if pair is None:
            return self.extra.pop(rid, None) is not None
        sched, door = pair
        door.stop()
        sched.stop(drain=False)
        return True

    def key_log_paths(self):
        if self.tmp_path is None:
            return {}
        return {rid: str(self.tmp_path / f"{self.side}-{rid}.keys.jsonl")
                for rid in self.doors}

    def stop(self):
        for rid in list(self.doors):
            self.remove(rid)


def _controller(side, mini, clk, **kw):
    kw.setdefault("policy", SCALING[side].ScalingPolicy(
        min_replicas=2, max_replicas=4, cooldown_s=5.0))
    return CP[side].FleetController(
        mini, clock=lambda: clk[0], registry=REG[side](),
        heartbeat_timeout_s=5.0, probe_timeout_s=5.0, **kw)


def _summary(rec):
    return {"joined": rec["joined"], "left": rec["left"],
            "swept": rec["swept"], "healthy": rec["healthy"],
            "action": rec["decision"]["action"],
            "reason": rec["decision"]["reason"],
            "verbs": [a["verb"] for a in rec["actions"]]}


def test_reconcile_records_match_jax():
    """Quorum restore, hold, a wedged replica swept by the TTL, its
    endpoint gone (leave) and the quorum restored again."""
    out = {}
    for side in SIDES:
        mini, clk = _Mini(side), [100.0]
        try:
            mini.spawn()
            ctrl = _controller(side, mini, clk)
            recs = [ctrl.reconcile()]
            clk[0] += 1.0
            recs.append(ctrl.reconcile())
            _, door = mini.doors["r1"]
            url = door.url
            mini.remove("r1")
            mini.extra["r1"] = url
            clk[0] += 6.0
            recs.append(ctrl.reconcile())
            del mini.extra["r1"]
            clk[0] += 1.0
            recs.append(ctrl.reconcile())
            snap = ctrl.snapshot()
        finally:
            mini.stop()
        out[side] = ([_summary(r) for r in recs],
                     {k: snap[k] for k in ("scale_ups", "scale_downs",
                                           "reconciles")})
    assert out["jax"] == out["port"]
    recs = out["port"][0]
    assert recs[0]["verbs"] == ["scale_up"] and recs[1]["action"] == "hold"
    assert recs[2]["swept"] == ["r1"] and recs[3]["left"] == ["r1"]


def test_warm_from_telemetry_dedups_without_a_race(tmp_path):
    """The counterpart of the JAX package's racy warm test: the warm fold
    is held until both reconciles have read the dedup, then released and
    awaited on the ticket the first reconcile made."""
    out = {}
    for side in SIDES:
        ex = _Executor()
        mini, clk = _Mini(side, tmp_path=tmp_path, executor=ex), [100.0]
        try:
            rid = mini.spawn()
            log = KEYLOG[side](mini.key_log_paths()[rid], flush_every=1)
            hot = np.arange(12, dtype=np.int32)
            log.observe(hot)
            log.observe(hot)
            log.observe(np.ones(12, np.int32))
            ex.hold.clear()
            ctrl = _controller(
                side, mini, clk, warm=True, warm_top_k=4, warm_min_count=2,
                policy=SCALING[side].ScalingPolicy(min_replicas=1,
                                                   max_replicas=2,
                                                   cooldown_s=5.0))
            first = ctrl.reconcile()["warm_submissions"]
            (ticket,) = ctrl._warm_tickets
            clk[0] += 1.0
            second = ctrl.reconcile()["warm_submissions"]
            assert not ticket.done()
            ex.hold.set()
            resp = ticket.result(timeout=60)
            out[side] = (first, second, resp.status,
                         resp.request_id[:5], ctrl.snapshot()["warmed"],
                         len(ctrl._warmed))
        finally:
            ex.hold.set()
            mini.stop()
    assert out["jax"] == out["port"] == (1, 0, "ok", "warm-", 1, 1)


def test_content_digest_and_identity_helpers_match_jax():
    rng = np.random.default_rng(2)
    seq = rng.integers(0, 20, 14).astype(np.int32)
    msa = rng.integers(0, 20, (3, 14)).astype(np.int32)
    for args in ((seq, None), (seq, msa)):
        assert pt_cp.content_digest(*args) == jax_cp.content_digest(*args)
    text = ('fleet_replica_identity{replica_id="r0",model_tag="v1",'
            'incarnation="abc"} 1\n')
    assert pt_cp.parse_identity(text) == jax_cp.parse_identity(text)


# -- procfleet -------------------------------------------------------------

def test_replica_model_has_the_jax_childs_widths():
    """`replica_model` builds the JAX replica's architecture: the JAX
    child's parameter tree (heads 2, dim_head 16) bridges onto it with
    no missing or extra leaf."""
    import jax
    import jax.numpy as jnp

    from alphafold2_tpu import Alphafold2 as JaxAlphafold2
    from alphafold2_tpu_torch.fleet.procfleet import replica_model
    from alphafold2_tpu_torch.weights import load_jax_params
    from test_torch_serve import random_params

    jm = JaxAlphafold2(dim=32, depth=1, heads=2, dim_head=16,
                       predict_coords=True, structure_module_depth=1)
    shapes = jax.eval_shape(
        lambda key: jm.init(key, jnp.zeros((1, 32), jnp.int32),
                            msa=jnp.zeros((1, 3, 32), jnp.int32),
                            mask=jnp.ones((1, 32), bool),
                            msa_mask=jnp.ones((1, 3, 32), bool)),
        jax.random.PRNGKey(0))
    pm = replica_model({"dim": 32, "depth": 1}, "cpu", seed=0)
    assert pm.heads == 2 and pm.predict_coords
    load_jax_params(pm, random_params(shapes, np.random.default_rng(0)))
    twin = dict(replica_model({"dim": 32, "depth": 1}, "cpu",
                              seed=0).named_parameters())
    fresh = dict(replica_model({"dim": 32, "depth": 1}, "cpu",
                               seed=0).named_parameters())
    assert fresh.keys() == twin.keys()
    assert all(bool((p == twin[n]).all()) for n, p in fresh.items())


def test_procfleet_cpu_replicas_serve_restore_and_drain(tmp_path):
    """Two replica processes on the CPU answer a fold through the front
    doors; a replica killed with -9 is replaced by one reconcile of a
    FleetController; SIGTERM drains the live ones with exit 0."""
    from alphafold2_tpu_torch.fleet.procfleet import FleetClient, ProcFleet

    fleet = ProcFleet(2, str(tmp_path / "run"), buckets=(32,),
                      model={"dim": 16, "depth": 1, "msa_depth": 0},
                      device="cpu")
    rcs = None
    try:
        fleet.start(timeout_s=120)
        client = FleetClient([h.frontdoor_url for h in fleet.replicas],
                             result_timeout_s=60)
        seq = np.random.default_rng(0).integers(0, 20, 24).astype(np.int32)
        resp = client.fold(pt_serve.FoldRequest(seq=seq))
        assert resp.ok and resp.coords.shape == (24, 3)
        assert np.isfinite(resp.coords).all()
        assert fleet.kill(1) < 0
        clk = [100.0]
        ctrl = pt_cp.FleetController(
            fleet, policy=pt_scaling.ScalingPolicy(
                min_replicas=2, max_replicas=3, cooldown_s=5.0),
            clock=lambda: clk[0], registry=PtRegistry(),
            probe_timeout_s=5.0)
        rec = ctrl.reconcile()
        assert rec["decision"]["action"] == "scale_up"
        assert [a["verb"] for a in rec["actions"]] == ["scale_up"]
        fleet.wait_ready([2], timeout_s=120)
        clk[0] += 1.0
        assert ctrl.reconcile()["healthy"] == 2
        for i in (0, 2):
            assert fleet.healthz(i)["running"]
    finally:
        fleet.stop(timeout_s=60)
        rcs = [h.proc.returncode for h in fleet.replicas]
    assert rcs[0] == 0 and rcs[2] == 0 and rcs[1] < 0
