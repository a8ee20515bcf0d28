"""The port's fleet tier (alphafold2_tpu_torch/fleet/: registry, rpc,
router, peer, local, frontdoor) against the JAX package's, on the CPU.

The wire, the ring and the peer entries must be interchangeable: a
request encoded by one package decodes in the other (and the bytes are
equal), both rings give the same owner for 1,000 seeded fold keys, and
a peer cache entry served by one package's `PeerCacheServer` is
fetched by the other's `PeerCacheClient`, with a 409 across rollout
tags. The two-replica `InProcessFleet` of each package folds the same
requests over the same weights (JAX params drawn with numpy, bridged
with `load_jax_params`): coords agree within 1e-4 at real residues,
and forwards, peer hits and statuses are equal. Small size: dim 32,
depth 1, heads 2, dim_head 16, bucket 16, 3 MSA rows.
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from alphafold2_tpu import fleet as jax_fleet
from alphafold2_tpu import serve as jax_serve
from alphafold2_tpu.cache import FoldCache as JaxFoldCache
from alphafold2_tpu.cache import fold_key as jax_fold_key
from alphafold2_tpu.cache.store import CachedFold as JaxCachedFold
from alphafold2_tpu.fleet import rpc as jax_rpc
from alphafold2_tpu.obs.registry import MetricsRegistry as JaxRegistry
from alphafold2_tpu_torch import fleet as pt_fleet
from alphafold2_tpu_torch import serve as pt_serve
from alphafold2_tpu_torch.cache import FoldCache as PtFoldCache
from alphafold2_tpu_torch.cache import fold_key as pt_fold_key
from alphafold2_tpu_torch.cache.store import CachedFold as PtCachedFold
from alphafold2_tpu_torch.fleet import rpc as pt_rpc
from alphafold2_tpu_torch.obs.registry import MetricsRegistry as PtRegistry
from test_torch_scheduler import executors  # noqa: F401  (module fixture)
from test_torch_serve import N, ROWS
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)


COORD_ATOL = 1e-4
SIDES = ("jax", "port")
FLEET = {"jax": jax_fleet, "port": pt_fleet}
SERVE = {"jax": jax_serve, "port": pt_serve}
RPC = {"jax": jax_rpc, "port": pt_rpc}
REG = {"jax": JaxRegistry, "port": PtRegistry}
CACHE = {"jax": JaxFoldCache, "port": PtFoldCache}
CACHED = {"jax": JaxCachedFold, "port": PtCachedFold}


def tokens(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 20, n).astype(np.int32),
            rng.integers(0, 20, (ROWS, n)).astype(np.int32))


def other(side):
    return SIDES[1 - SIDES.index(side)]


# -- registry --------------------------------------------------------------

def test_registry_and_rollout_match_jax(tmp_path):
    """The same membership history gives the same snapshot, and a
    rollout persisted by either package boots the other at its tag and
    epoch."""
    snaps = {}
    for side in SIDES:
        f = FLEET[side]
        reg = f.ReplicaRegistry(model_tag="v1", registry=REG[side](),
                                rollout_persist_path=str(
                                    tmp_path / f"{side}.json"))
        seen = []
        reg.rollout.subscribe(lambda tag, epoch: seen.append((tag, epoch)))
        for rid, port in (("a", 7001), ("b", 7002), ("c", None)):
            reg.register(rid, peer_addr=(None if port is None
                                         else ("127.0.0.1", port)))
        reg.mark("a", up=False)
        reg.mark("a", up=False)
        reg.heartbeat("b")
        reg.deregister("c")
        assert reg.rollout.bump("v2") == 1
        assert reg.rollout.bump("v2") == 1
        assert reg.rollout.bump("v3") == 2
        snaps[side] = (reg.snapshot(), seen, reg.member_ids())
    assert snaps["jax"] == snaps["port"]
    for side in SIDES:
        booted = FLEET[other(side)].RolloutState(
            "boot", registry=REG[other(side)](),
            persist_path=str(tmp_path / f"{side}.json"))
        assert booted.current() == ("v3", 2)


# -- rpc -------------------------------------------------------------------

def _request(side, seed, **kw):
    seq, msa = tokens(12, seed)
    return SERVE[side].FoldRequest(seq=seq, msa=msa, **kw)


@pytest.mark.parametrize("sender", SIDES)
def test_wire_is_byte_equal_and_decodes_across_packages(sender):
    """A request and a response encoded by `sender` decode in the other
    package; both packages encode the same bytes and headers. The
    port's response carries tensors (as made on the card) and is copied
    to the host by the encoder."""
    kw = dict(priority=3, deadline_s=2.5, qos="bulk",
              request_id="rq-1", forwarded=True)
    reqs = {side: _request(side, 5, **kw) for side in SIDES}
    bodies = {side: RPC[side].encode_request(reqs[side]) for side in SIDES}
    heads = {side: RPC[side].request_headers(reqs[side], tag="v1")
             for side in SIDES}
    assert bodies["jax"] == bodies["port"]
    assert heads["jax"] == heads["port"]
    got = RPC[other(sender)].decode_request(bodies[sender], heads[sender])
    assert np.array_equal(got.seq, reqs[sender].seq)
    assert np.array_equal(got.msa, reqs[sender].msa)
    assert (got.priority, got.deadline_s, got.qos, got.request_id,
            got.forwarded) == (3, 2.5, "bulk", "rq-1", True)

    rng = np.random.default_rng(7)
    coords = rng.normal(size=(12, 3)).astype(np.float32)
    conf = rng.uniform(size=12).astype(np.float32)
    resp = {}
    for side in SIDES:
        c, p = ((torch.from_numpy(coords), torch.from_numpy(conf))
                if side == "port" else (coords, conf))
        resp[side] = RPC[side].encode_response(SERVE[side].FoldResponse(
            request_id="rq-1", status="ok", coords=c, confidence=p,
            bucket_len=16, source="fold", attempts=2, recycles=3,
            tier="draft", confidence_score=0.625))
    assert resp["jax"] == resp["port"]
    back = RPC[other(sender)].decode_response(*resp[sender])
    assert back.ok and back.attempts == 2 and back.recycles == 3
    assert back.tier == "draft" and back.confidence_score == 0.625
    np.testing.assert_array_equal(back.coords, coords)
    np.testing.assert_array_equal(back.confidence, conf)

    raw = {side: RPC[side].encode_raw_request(
        SERVE[side].RawFoldRequest(seq="MKTAYIAK", msa=["MKTAYIAK",
                                                        "MRTAYIAK"],
                                   request_id="raw-1", qos="express"))
        for side in SIDES}
    assert raw["jax"] == raw["port"]
    got = RPC[other(sender)].decode_raw_request(*raw[sender])
    assert (got.seq, list(got.msa), got.qos) == \
        ("MKTAYIAK", ["MKTAYIAK", "MRTAYIAK"], "express")


# -- router ----------------------------------------------------------------

def test_ring_owners_match_jax_for_1000_keys():
    routers = {}
    for side in SIDES:
        reg = FLEET[side].ReplicaRegistry(registry=REG[side]())
        for rid in ("r0", "r1", "r2"):
            reg.register(rid)
        routers[side] = (reg, FLEET[side].ConsistentHashRouter(
            reg, "r0", metrics=REG[side]()))
    rng = np.random.default_rng(11)
    keys = []
    for _ in range(1000):
        n = int(rng.integers(8, 40))
        seq = rng.integers(0, 20, n).astype(np.int32)
        msa = rng.integers(0, 20, (ROWS, n)).astype(np.int32)
        k = pt_fold_key(seq, msa, msa_depth=ROWS, num_recycles=1,
                        model_tag="v1")
        assert k == jax_fold_key(seq, msa, msa_depth=ROWS, num_recycles=1,
                                 model_tag="v1")
        keys.append(k)
    owners = {side: [r.owner_for(k) for k in keys]
              for side, (_, r) in routers.items()}
    assert owners["jax"] == owners["port"]
    assert set(owners["port"]) == {"r0", "r1", "r2"}
    routes = {side: [dataclasses.astuple(d) for d in map(r.route, keys[:50])]
              for side, (_, r) in routers.items()}
    assert routes["jax"] == routes["port"]
    for side, (reg, _) in routers.items():
        reg.mark("r1", up=False)
    owners = {side: [r.owner_for(k) for k in keys]
              for side, (_, r) in routers.items()}
    assert owners["jax"] == owners["port"] and "r1" not in owners["port"]


# -- peer ------------------------------------------------------------------

@pytest.mark.parametrize("server_side", SIDES)
def test_peer_entries_cross_packages_with_409_across_tags(server_side):
    """`server_side` holds an entry; the other package's client fetches
    it through the ring, byte-for-byte; a client on another rollout tag
    gets a 409 (stale_tag) and no entry."""
    client_side = other(server_side)
    rng = np.random.default_rng(3)
    value = CACHED[server_side](
        rng.normal(size=(10, 3)).astype(np.float32),
        rng.uniform(size=10).astype(np.float32))
    cache = CACHE[server_side]()
    server_reg = REG[server_side]()
    server_rollout = FLEET[server_side].RolloutState(
        "v1", registry=REG[server_side]())
    server = FLEET[server_side].PeerCacheServer(
        cache, rollout=server_rollout, replica_id="owner",
        metrics=server_reg).start()
    try:
        creg = FLEET[client_side].ReplicaRegistry(
            model_tag="v1", registry=REG[client_side]())
        creg.register("me")
        creg.register("owner", peer_addr=server.address)
        router = FLEET[client_side].ConsistentHashRouter(
            creg, "me", metrics=REG[client_side]())
        key, missing = [k for k in (f"key{i}" for i in range(100))
                        if router.owner_for(k) == "owner"][:2]
        cache.put(key, value.coords, value.confidence)
        client_reg = REG[client_side]()
        client = FLEET[client_side].PeerCacheClient(
            creg, "me", router=router, metrics=client_reg)
        got = client.get(key)
        assert got is not None
        np.testing.assert_array_equal(got.coords, value.coords)
        np.testing.assert_array_equal(got.confidence, value.confidence)
        assert client.get(missing) is None

        stale = FLEET[client_side].PeerCacheClient(
            creg, "me", router=router, metrics=client_reg,
            rollout=FLEET[client_side].RolloutState(
                "v0", registry=REG[client_side]()))
        assert stale.get(key) is None
        assert stale.stale_tag_hits == 0
        fetched = {s["labels"]["outcome"]: s["value"] for s in
                   client_reg.counter("fleet_peer_fetch_total", "",
                                      ("peer", "outcome")).samples()}
        assert fetched == {"hit": 1, "miss": 1, "stale_tag": 1}
        served = {s["labels"]["outcome"]: s["value"] for s in
                  server_reg.counter("fleet_peer_served_total", "",
                                     ("replica", "outcome")).samples()}
        assert served["stale_tag"] == 1 and served["hit"] == 1
    finally:
        server.stop()


# -- frontdoor -------------------------------------------------------------

class _Device:
    device = torch.device("cpu")


class _GatedExecutor:
    """Opaque-fold stand-in: per-residue coords from the tokens, made as
    tensors on the port side and numpy on the JAX side; `hold` blocks a
    fold until released (a parked result during a drain)."""

    def __init__(self, side):
        self.side = side
        self.hold = threading.Event()
        self.hold.set()
        self.entered = threading.Event()
        if side == "port":
            self.model = _Device()

    def run(self, batch, num_recycles, trace=None, **kw):
        self.entered.set()
        assert self.hold.wait(60)
        seq = np.asarray(batch["seq"].cpu() if hasattr(batch["seq"], "cpu")
                         else batch["seq"]).astype(np.float32)
        coords = np.stack([seq, seq * 0.5, -seq], -1)
        conf = np.full(seq.shape, 0.75, np.float32)
        if self.side == "port":
            coords, conf = torch.from_numpy(coords), torch.from_numpy(conf)

        class R:
            pass
        r = R()
        r.coords, r.confidence = coords, conf
        return r

    def stats(self):
        return {}


def _door_scheduler(side, executor, reg, tag="v1"):
    s = SERVE[side]
    return s.Scheduler(executor, s.BucketPolicy((16,)),
                       s.SchedulerConfig(max_batch_size=2,
                                         max_wait_ms=5.0, poll_ms=2.0,
                                         msa_depth=ROWS),
                       s.ServeMetrics(registry=reg), model_tag=tag,
                       registry=reg)


@pytest.mark.parametrize("door_side", SIDES)
def test_frontdoor_serves_the_other_packages_transport(door_side):
    """A front door of `door_side` serves submits and results to the
    other package's `HttpTransport`; /healthz and /metrics answer with
    the serve_* series; a drain resolves a parked fold instead of
    dropping it."""
    client_side = other(door_side)
    ex = _GatedExecutor(door_side)
    reg = REG[door_side]()
    sched = _door_scheduler(door_side, ex, reg)
    door = FLEET[door_side].FrontDoorServer(sched, replica_id="fd0",
                                            metrics=reg)
    sched.start()
    door.start()
    try:
        url = f"http://{door.address[0]}:{door.address[1]}"
        transport = FLEET[client_side].HttpTransport(
            url, metrics=REG[client_side]())
        req = _request(client_side, 21)
        resp = transport.submit(req).result(timeout=60)
        assert resp.ok and resp.source == "fold"
        seq = req.seq.astype(np.float32)
        np.testing.assert_array_equal(
            resp.coords, np.stack([seq, seq * 0.5, -seq], -1))
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            health = json.loads(r.read().decode())
        assert health["running"] and health["replica"] == "fd0"
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            text = r.read().decode()
        assert "serve_requests_total" in text
        assert "fleet_replica_identity" in text

        ex.hold.clear()
        ex.entered.clear()
        parked = transport.submit(_request(client_side, 22))
        assert ex.entered.wait(30)
        drainer = threading.Thread(target=sched.drain, daemon=True)
        drainer.start()
        deadline = time.monotonic() + 30
        while not sched.health()["draining"]:
            assert time.monotonic() < deadline, "the drain never began"
            time.sleep(0.005)
        with pytest.raises(urllib.error.HTTPError) as refused:
            transport.submit(_request(client_side, 23))
        assert refused.value.code == 503
        ex.hold.set()
        drainer.join(60)
        assert parked.result(timeout=60).ok
    finally:
        ex.hold.set()
        door.stop()
        sched.stop(drain=False)


# -- local -----------------------------------------------------------------

def _fleet(side, executors, registry=None, **kw):  # noqa: F811
    s = SERVE[side]
    reg = registry if registry is not None else REG[side]()
    ex = executors[side]
    ex.faults = None
    return FLEET[side].InProcessFleet(
        lambda: ex, s.BucketPolicy((N,)),
        s.SchedulerConfig(max_batch_size=2, max_wait_ms=5.0,
                          num_recycles=1, msa_depth=ROWS, poll_ms=2.0),
        n_replicas=2, model_tag="v1", registry=reg, **kw)


def _fleet_run(side, executors):  # noqa: F811
    """Two requests owned by r1 submitted at r0 (forwarded), their twins
    through r1, one owned by r0 folded at r0 then looked up from r1's
    cache (peer hit), and a rollout after which the old-tag key misses."""
    reg = REG[side]()
    with _fleet(side, executors, registry=reg) as fl:
        router = fl.replicas[0].router
        s = SERVE[side]
        cfg = fl.replicas[0].scheduler.config

        def key(seq, msa):
            return (jax_fold_key if side == "jax" else pt_fold_key)(
                seq, msa, msa_depth=cfg.msa_depth,
                num_recycles=cfg.num_recycles, model_tag="v1")

        inputs = [tokens(int(n), seed) for seed, n in
                  enumerate(np.random.default_rng(4).integers(8, N + 1,
                                                              40))]
        owned = {rid: [t for t in inputs if router.owner_for(key(*t)) == rid]
                 for rid in ("r0", "r1")}
        remote = owned["r1"][:2]
        resps = [fl.submit(s.FoldRequest(seq=q, msa=m), replica=0)
                 .result(timeout=120) for q, m in remote]
        resps += [fl.submit(s.FoldRequest(seq=q, msa=m), replica=1)
                  .result(timeout=120) for q, m in remote]
        local = owned["r0"][0]
        resps.append(fl.submit(s.FoldRequest(seq=local[0], msa=local[1]),
                               replica=0).result(timeout=120))
        peer_value = fl.replicas[1].cache.get(key(*local))
        fl.bump_model_tag("v2")
        straggler = FLEET[side].PeerCacheClient(
            fl.registry, "r1", metrics=REG[side](),
            rollout=FLEET[side].RolloutState("v1", registry=REG[side]()))
        old_tag_miss = straggler.get(key(*local))
        served = {smp["labels"]["outcome"]: smp["value"] for smp in
                  reg.counter("fleet_peer_served_total", "",
                              ("replica", "outcome")).samples()}
    stats = fl.stats()
    return {"summary": [(r.status, r.source) for r in resps],
            "coords": [(r.coords, q) for r, (q, _) in
                       zip(resps, remote + remote + [local])],
            "peer_value": peer_value, "old_tag_miss": old_tag_miss,
            "served": served,
            "aggregate": stats["aggregate"],
            "forwards": sum(v.get("forwards", 0) for v in
                            (rep.get("router", {}) for rep in
                             stats["replicas"].values())),
            "tags": [r.scheduler.model_tag for r in fl.replicas]}


def test_in_process_fleet_matches_jax(executors):  # noqa: F811
    got = {side: _fleet_run(side, executors) for side in SIDES}
    ref, port = got["jax"], got["port"]
    assert port["summary"] == ref["summary"]
    assert [src for _, src in port["summary"][:2]] == ["forwarded"] * 2
    assert all(st == "ok" for st, _ in port["summary"])
    for (a, seq), (b, _) in zip(ref["coords"], port["coords"]):
        n = len(seq)
        np.testing.assert_allclose(b[:n], a[:n], atol=COORD_ATOL, rtol=0)
    assert port["peer_value"] is not None
    np.testing.assert_allclose(port["peer_value"].coords,
                               ref["peer_value"].coords, atol=COORD_ATOL,
                               rtol=0)
    assert port["old_tag_miss"] is None and ref["old_tag_miss"] is None
    assert port["served"] == ref["served"]
    assert port["served"]["stale_tag"] == 1
    assert port["aggregate"] == ref["aggregate"]
    assert port["aggregate"]["peer_hits"] == 1
    assert port["forwards"] == ref["forwards"]
    assert port["tags"] == ref["tags"] == ["v2", "v2"]


def test_unwired_fleet_baseline_has_no_router_or_peer(executors):  # noqa: F811
    for side in SIDES:
        with _fleet(side, executors, fleet=False) as fl:
            assert all(r.router is None and r.peer_server is None
                       for r in fl.replicas)
            q, m = tokens(12, 1)
            assert fl.submit(SERVE[side].FoldRequest(seq=q, msa=m),
                             replica=1).result(timeout=120).source == "fold"
