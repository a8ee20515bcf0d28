"""Parity of the port's cache tier and `predict.fold_and_write` with the
JAX package: digests and keys byte-equal, the same store behaviour for
the same operations (`ByteStore`, `FoldCache`, `FeatureCache`,
`InflightRegistry`, `CheckpointStore`, the object store), disk entries
readable across packages both ways, and `fold_and_write` coords within
COORDS_ATOL of the JAX package's on bridged weights (fp32, dim 32, depth
1), with PDB text byte-equal across the packages through one cache
directory. The JAX `fold_and_write` reference runs once per module.
"""

import json
import os
import time
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from alphafold2_tpu import cache as jax_cache
from alphafold2_tpu import predict as jax_predict
from alphafold2_tpu.cache import bytestore as jax_bytestore
from alphafold2_tpu.cache import checkpoints as jax_ckpt
from alphafold2_tpu.fleet import object_store as jax_objstore
from alphafold2_tpu.model import alphafold2 as jax_af2
from alphafold2_tpu.obs import registry as jax_registry
from alphafold2_tpu.obs import trace as jax_trace
from alphafold2_tpu.utils.hashing import stable_digest as jax_digest
from alphafold2_tpu_torch import cache as pt_cache
from alphafold2_tpu_torch import predict as pt_predict
from alphafold2_tpu_torch.cache import bytestore as pt_bytestore
from alphafold2_tpu_torch.cache import checkpoints as pt_ckpt
from alphafold2_tpu_torch.fleet import object_store as pt_objstore
from alphafold2_tpu_torch.model import alphafold2 as pt_af2
from alphafold2_tpu_torch.obs import registry as pt_registry
from alphafold2_tpu_torch.obs import trace as pt_trace
from alphafold2_tpu_torch.ops.block_sparse import KernelSpec
from alphafold2_tpu_torch.utils.hashing import stable_digest as pt_digest
from alphafold2_tpu_torch.weights import load_jax_params
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)


COORDS_ATOL = 1e-3
JAX = types.SimpleNamespace(cache=jax_cache, bytestore=jax_bytestore,
                            ckpt=jax_ckpt, objstore=jax_objstore,
                            registry=jax_registry, trace=jax_trace)
PORT = types.SimpleNamespace(cache=pt_cache, bytestore=pt_bytestore,
                             ckpt=pt_ckpt, objstore=pt_objstore,
                             registry=pt_registry, trace=pt_trace)


def both(scenario, tmp_path):
    """Run `scenario(pkg, dir)` on each package; their observations must
    be equal."""
    Clock.start = time.time()
    ref = scenario(JAX, tmp_path / "jax")
    out = scenario(PORT, tmp_path / "port")
    assert out == ref
    return out


class Clock:
    """A settable wall clock (disk TTLs compare it with file times). Every
    clock of one `both()` call starts at the wall time that call began:
    the two packages see the same times, and a start fixed when the module
    was imported would fall behind the files' times by however long the
    tests before it ran (a TTL then never expires)."""

    start = time.time()

    def __init__(self):
        self.now = Clock.start

    def __call__(self):
        return self.now


# -- digests and keys ---------------------------------------------------------

_RNG = np.random.default_rng(0)
_TOKENS = _RNG.integers(0, 21, (3, 7))
DIGEST_CASES = {
    "scalars": (None, b"ab", "ab", True, 3, np.int64(3), 2.5,
                np.float32(0.1)),
    "nested": (("a", ("b",)), ["a", "b"], ()),
    "int32": (_TOKENS.astype(np.int32),),
    "int64": (_TOKENS,),
    "float32": (_RNG.normal(size=(2, 3)).astype(np.float32),),
    "bool": (_TOKENS > 9,),
}


@pytest.mark.parametrize("case", sorted(DIGEST_CASES))
def test_stable_digest_equals_jax(case):
    parts = DIGEST_CASES[case]
    assert pt_digest(*parts) == jax_digest(*parts)
    assert pt_digest(*parts, digest_size=8) == \
        jax_digest(*parts, digest_size=8)


@pytest.mark.parametrize("case", ["int32", "int64", "float32", "bool"])
def test_cpu_tensor_digests_as_its_numpy_array(case):
    (arr,) = DIGEST_CASES[case]
    assert pt_digest(torch.from_numpy(arr), "x") == jax_digest(arr, "x")


def test_unhashable_parts_raise():
    for part in (np.array([{}], dtype=object), torch.zeros(2).bfloat16()):
        with pytest.raises(TypeError):
            pt_digest(part)


FOLD_KEY_CASES = {
    "plain": dict(),
    "msa": dict(msa=_TOKENS[:, :5]),
    "msa_depth": dict(msa=_TOKENS[:, :5], msa_depth=2),
    "msa_free": dict(msa=_TOKENS[:, :5], msa_depth=0),
    "extras": dict(num_recycles=3, model_tag="w1",
                   extras=((("flag", True),), _TOKENS[:2, :5] > 3)),
}


@pytest.mark.parametrize("case", sorted(FOLD_KEY_CASES))
@pytest.mark.parametrize("tokens", ["int32", "int64", "tensor"])
def test_fold_key_equals_jax(case, tokens):
    kw = dict(FOLD_KEY_CASES[case])
    seq = _TOKENS[0, :5]
    ref = jax_cache.fold_key(seq.astype(np.int32), **kw)
    if tokens == "int32":
        seq = seq.astype(np.int32)
    elif tokens == "tensor":
        seq = torch.from_numpy(seq)
        if "msa" in kw:
            kw["msa"] = torch.from_numpy(kw["msa"])
    assert pt_cache.fold_key(seq, **kw) == ref


@pytest.mark.parametrize("seq,msa", [
    ("mkv", None), ("MKV", ["MKV", "M-V"]),
    (np.array([1, 2, 3]), np.array([[1, 2, 3], [0, 2, 3]]))])
def test_feature_key_equals_jax(seq, msa):
    kw = dict(config_digest="cfg")
    assert pt_cache.feature_key(seq, msa, **kw) == \
        jax_cache.feature_key(seq, msa, **kw)


def test_key_schemas_equal_jax():
    assert pt_cache.KEY_SCHEMA == jax_cache.KEY_SCHEMA
    assert pt_cache.FEATURE_KEY_SCHEMA == jax_cache.FEATURE_KEY_SCHEMA
    assert pt_ckpt.CHECKPOINT_SCHEMA == jax_ckpt.CHECKPOINT_SCHEMA
    assert pt_ckpt.MANIFEST_SCHEMA == jax_ckpt.MANIFEST_SCHEMA


# -- stores: the same operations, the same observations -----------------------


def fold_value(pkg, n, seed):
    rng = np.random.default_rng(seed)
    return pkg.cache.CachedFold(rng.normal(size=(n, 3)).astype(np.float32),
                                rng.random(n).astype(np.float32))


def view(hit):
    """A lookup's result as plain data (the packages' value classes
    differ)."""
    if hit is None:
        return None
    value, tier = hit
    return value.coords.tolist(), value.confidence.tolist(), tier


def test_bytestore_behaves_as_jax(tmp_path):
    def scenario(pkg, root):
        clock = Clock()
        events = []
        store = pkg.bytestore.ByteStore(
            encode=pkg.cache.encode_fold, decode=pkg.cache.decode_fold,
            max_bytes=200, max_entries=3, ttl_s=50.0, disk_dir=str(root),
            clock=clock, on_event=lambda f, n=1: events.append((f, n)))
        obs = []
        for i, key in enumerate(["aa1", "ab2", "bc3", "bd4"]):
            value = fold_value(pkg, 4 + i, i)
            store.mem_put(key, value)
            store.disk_put(key, value)
            obs.append((len(store), store.bytes_resident))
        obs.append(view(store.lookup("aa1")))     # evicted: from disk
        obs.append(view(store.lookup("bd4")))
        clock.now += 30
        store.disk_put("ce5", fold_value(pkg, 3, 9))
        clock.now += 30                            # aa1..bd4 expire
        obs.append(view(store.lookup("bd4")))
        obs.append(store.keys())
        with open(store.path("ce5"), "wb") as fh:
            fh.write(b"not an npz")
        obs.append(view(store.lookup("ce5")))
        obs.append(sorted(os.listdir(root / "ce")))
        obs.append([(k, v.coords.tolist()) for k, v in store.scan()])
        obs.append(events)
        return obs

    both(scenario, tmp_path)


def test_fold_cache_behaves_as_jax(tmp_path):
    def scenario(pkg, root):
        clock = Clock()
        reg = pkg.registry.MetricsRegistry()
        cache = pkg.cache.FoldCache(max_bytes=1 << 20, max_entries=2,
                                    ttl_s=100.0, disk_dir=str(root),
                                    clock=clock, registry=reg)
        tracer = pkg.trace.Tracer()
        trace = tracer.start_trace("r")
        obs = []
        for i in range(3):
            value = fold_value(pkg, 5, i)
            cache.put(f"k{i}", value.coords, value.confidence)
        obs.append(cache.get("k0", trace=trace).coords.tolist())  # disk
        obs.append(cache.get("k1", trace=trace) is not None)
        obs.append(cache.get("nope", trace=trace))
        obs.append(cache.read_raw("k2") is not None)
        obs.append(cache.invalidate("k2"))
        obs.append(cache.get("k2"))
        clock.now += 200
        obs.append(cache.get("k0"))
        snap = cache.snapshot()
        snap.pop("disk_dir")
        obs.append(snap)
        trace.finish("ok")
        rec = tracer.slowest()[0]
        obs.append([(e["name"], e.get("attrs")) for e in rec["events"]])
        obs.append({m.name: (m.kind, m.label_names) for m in reg.metrics()})
        return obs

    both(scenario, tmp_path)


def test_fold_cache_disk_entries_cross_packages(tmp_path):
    """A directory written by either package's FoldCache reads as hits
    in the other's, with equal arrays; a corrupt entry is quarantined."""
    value = fold_value(PORT, 7, 3)
    for writer, reader in ((JAX, PORT), (PORT, JAX)):
        root = tmp_path / writer.cache.__name__
        writer.cache.FoldCache(disk_dir=str(root)).put(
            "key0", value.coords, value.confidence)
        got = reader.cache.FoldCache(disk_dir=str(root)).get("key0")
        np.testing.assert_array_equal(got.coords, value.coords)
        np.testing.assert_array_equal(got.confidence, value.confidence)
        assert writer.cache.encode_fold("key0", value) == \
            reader.cache.encode_fold("key0", got)
    bad = tmp_path / "bad"
    cache = pt_cache.FoldCache(disk_dir=str(bad))
    cache.put("key1", value.coords, value.confidence)
    Path(cache._path("key1")).write_bytes(
        jax_cache.encode_fold("other", jax_cache.CachedFold(
            value.coords, value.confidence)))
    fresh = pt_cache.FoldCache(disk_dir=str(bad))
    assert fresh.get("key1") is None
    assert fresh.stats.disk_errors == 1
    assert os.path.exists(cache._path("key1") + ".quarantined")


def test_feature_cache_behaves_as_jax(tmp_path):
    def scenario(pkg, root):
        reg = pkg.registry.MetricsRegistry()
        cache = pkg.cache.FeatureCache(max_entries=1, disk_dir=str(root),
                                       registry=reg)
        seq = np.arange(6)
        msa = np.arange(12).reshape(2, 6) % 21
        obs = []
        key = pkg.cache.feature_key(seq, msa, config_digest="c")
        cache.put(key, seq, msa)
        cache.put("other", seq)
        got = cache.get(key)                       # evicted: disk
        obs.append((got.seq.tolist(), got.msa.tolist(), got.nbytes))
        obs.append(cache.get("absent"))
        raw = Path(root / key[:2] / f"{key}.npz").read_bytes()
        obs.append(len(raw))
        snap = cache.snapshot()
        snap.pop("disk_dir")
        obs.append(snap)
        obs.append({m.name: (m.kind, m.label_names) for m in reg.metrics()})
        return obs

    both(scenario, tmp_path)
    key = jax_cache.feature_key(np.arange(6), None)
    jax_cache.FeatureCache(disk_dir=str(tmp_path / "x")).put(key,
                                                             np.arange(6))
    got = pt_cache.FeatureCache(disk_dir=str(tmp_path / "x")).get(key)
    assert got.seq.tolist() == list(range(6)) and got.msa is None


def test_inflight_registry_behaves_as_jax(tmp_path):
    def scenario(pkg, root):
        reg = pkg.registry.MetricsRegistry()
        inflight = pkg.cache.InflightRegistry(registry=reg)
        linked = []
        obs = [inflight.attach("k", "lead"),
               inflight.attach_with_leader("k", "f1",
                                           on_follower=linked.append),
               inflight.attach_follower("k", "f2"),
               inflight.attach_follower("none", "f3"),
               inflight.attach("j", "lead-j")]
        obs.append(inflight.evict_followers(lambda f: f == "f2"))
        obs.append(inflight.promote("k", lambda fs: fs[0]))
        obs.append(inflight.promote("j", lambda fs: fs[0]))
        obs.append(inflight.attach_with_leader("k", "f4"))
        obs.append(inflight.settle("k"))
        obs.append((inflight.inflight(), inflight.waiting(),
                    inflight.snapshot(), linked))
        obs.append({m.name: (m.kind, m.label_names, m.samples())
                    for m in reg.metrics()})
        return obs

    both(scenario, tmp_path)


# -- checkpoints and the object store -----------------------------------------


def carry_entries(seed=1, b=2, n=5):
    rng = np.random.default_rng(seed)
    return [("dev", rng.normal(size=(b, n, 3)).astype(np.float32), None),
            ("dev", rng.random((b, n)).astype(np.float32), None),
            ("dev", rng.normal(size=(b, n, n, 4)).astype(np.float32), None),
            ("ref", 7, None), ("ref", "tag", None)]


def ckpt_view(ckpt):
    if ckpt is None:
        return None
    return (ckpt.fold_key, ckpt.model_tag, ckpt.age, ckpt.seq.tolist(),
            None if ckpt.msa is None else ckpt.msa.tolist(),
            [(k, v.tolist() if k == "dev" else v, s)
             for k, v, s in ckpt.leaves], ckpt.nbytes)


def test_checkpoint_store_behaves_as_jax(tmp_path):
    def scenario(pkg, root):
        clock = Clock()
        reg = pkg.registry.MetricsRegistry()
        backend = pkg.objstore.FilesystemObjectStore(str(root / "shared"))
        store = pkg.ckpt.CheckpointStore(str(root / "disk"), model_tag="v1",
                                         backend=backend, registry=reg,
                                         clock=clock)
        seq = np.arange(5, dtype=np.int32)
        snap = (None, carry_entries())
        obs = []
        for age in (1, 3):
            row = pkg.ckpt.row_checkpoint(snap, 1, fold_key="fk",
                                          model_tag="v1", age=age, seq=seq,
                                          msa=np.stack([seq, seq]),
                                          clock=clock)
            obs.append(store.put_row(row))
        obs.append(store.store.keys())
        obs.append(ckpt_view(store.latest("fk")))
        obs.append([(k, ckpt_view(c)) for k, c in store.survivors()])
        obs.append(store.publish_manifest("replica-0"))
        obs.append(pkg.ckpt.read_manifest(backend, "replica-0"))
        obs.append(pkg.ckpt.clear_manifest(backend, "replica-0"))
        other = pkg.ckpt.CheckpointStore(str(root / "disk"),
                                         model_tag="v2", registry=reg)
        obs.append(ckpt_view(other.latest("fk")))
        for key in store.store.keys():
            os.remove(store.store.path(key))
        obs.append(ckpt_view(store.latest("fk")))    # from the mirror
        obs.append(store.sweep_orphans(["fk", "absent"]))
        obs.append(store.snapshot()["stats"])
        obs.append({m.name: (m.kind, m.label_names, m.samples())
                    for m in reg.metrics()})
        with pytest.raises(ValueError):
            pkg.ckpt.row_checkpoint((None, [("ref", object(), None)]), 0,
                                    fold_key="x", model_tag="", age=0,
                                    seq=seq)
        return obs

    both(scenario, tmp_path)


def test_checkpoint_payloads_cross_packages(tmp_path):
    key = jax_ckpt.checkpoint_key("fk", "v1", 4)
    seq = np.arange(5, dtype=np.int32)
    for writer, reader in ((JAX, PORT), (PORT, JAX)):
        row = writer.ckpt.row_checkpoint((None, carry_entries()), 0,
                                         fold_key="fk", model_tag="v1",
                                         age=4, seq=seq, clock=lambda: 5.0)
        data = writer.ckpt.encode_checkpoint(key, row)
        back = reader.ckpt.decode_checkpoint(key, data)
        assert ckpt_view(back) == ckpt_view(row)
        assert reader.ckpt.encode_checkpoint(key, back) == data
    leaves = pt_ckpt.decode_checkpoint(key, data).restore_leaves("cpu")
    assert [type(x) for x in leaves] == [torch.Tensor] * 3 + [int, str]
    np.testing.assert_array_equal(leaves[2].numpy(),
                                  carry_entries()[2][1][:1])


def test_named_mesh_spec_restore_raises():
    spec = {"kind": "named", "axes": ["data"], "sizes": [2],
            "spec": ["data"]}
    row = pt_ckpt.RowCheckpoint(
        fold_key="fk", model_tag="", age=0, seq=np.arange(3, dtype=np.int32),
        leaves=[("dev", np.zeros((1, 3), np.float32), spec)])
    key = pt_ckpt.checkpoint_key("fk", "", 0)
    back = pt_ckpt.decode_checkpoint(key, pt_ckpt.encode_checkpoint(key,
                                                                    row))
    assert back.leaves[0][2] == spec
    with pytest.raises(NotImplementedError, match="item 10"):
        back.restore_leaves("cpu")
    assert pt_ckpt.sharding_spec(torch.device("cpu")) is None


def test_object_store_peer_behaves_as_jax(tmp_path):
    def scenario(pkg, root):
        reg = pkg.registry.MetricsRegistry()
        backend = pkg.objstore.FilesystemObjectStore(str(root))
        peer = pkg.objstore.ObjectStorePeer(backend, metrics=reg)
        cache = pkg.cache.FoldCache(peer=peer, peer_write_through=True,
                                    registry=reg)
        value = fold_value(pkg, 4, 5)
        cache.put("k1", value.coords, value.confidence)
        fresh = pkg.cache.FoldCache(peer=peer, registry=reg)
        obs = [len(backend), fresh.get("k1").coords.tolist()]
        backend.put("k2", b"garbage")
        obs += [fresh.get("k2"), len(backend), peer.get("k3")]
        obs.append({m.name: (m.kind, m.label_names, m.samples())
                    for m in reg.metrics()})
        return obs

    both(scenario, tmp_path)
    value = fold_value(JAX, 4, 6)
    jax_objstore.ObjectStorePeer(jax_objstore.FilesystemObjectStore(
        str(tmp_path / "x"))).put("k", value)
    got = pt_objstore.ObjectStorePeer(pt_objstore.FilesystemObjectStore(
        str(tmp_path / "x"))).get("k")
    np.testing.assert_array_equal(got.coords, value.coords)


# -- fold_and_write -----------------------------------------------------------

MODEL_KW = dict(dim=32, depth=1, heads=2, dim_head=16, predict_coords=True,
                structure_module_depth=1)
N, ROWS, RECYCLES = 16, 3, 1


def random_params(shapes, rng):
    """Parameters on the init's shapes, drawn with numpy: LayerNorm
    scales near 1, Dense kernels N(0, 1/fan_in), everything else small
    noise (so no output projection is zero)."""
    def fill(path, x):
        name = str(path[-1].key)
        if name == "scale":
            a = 1 + 0.05 * rng.standard_normal(x.shape)
        elif name == "kernel":
            a = rng.standard_normal(x.shape) / np.sqrt(x.shape[-2])
        else:
            a = 0.05 * rng.standard_normal(x.shape)
        return np.asarray(a, x.dtype)
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def folded(tmp_path_factory):
    """The JAX model on random params and the port's bridged from them,
    a batch of two (the second padded to 12), and one JAX
    fold_and_write miss and hit through a disk FoldCache with a
    tracer: the module's only JAX folds."""
    rng = np.random.default_rng(12)
    seq = rng.integers(0, 20, (2, N))
    msa = rng.integers(0, 20, (2, ROWS, N))
    mask = np.ones((2, N), bool)
    mask[1, 12:] = False
    msa_mask = np.broadcast_to(mask[:, None], (2, ROWS, N)).copy()
    batch = dict(msa=msa, mask=mask, msa_mask=msa_mask,
                 num_recycles=RECYCLES)
    jm = jax_af2.Alphafold2(**MODEL_KW)
    shapes = jax.eval_shape(
        lambda key: jm.init(key, seq, msa=msa, mask=mask,
                            msa_mask=msa_mask), jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.default_rng(13))
    pm = pt_af2.Alphafold2(**MODEL_KW, device="cpu")
    load_jax_params(pm, jax.tree.map(np.asarray, params))

    root = tmp_path_factory.mktemp("jax_fold")
    cache = jax_cache.FoldCache(disk_dir=str(root / "cache"))
    tracer = jax_trace.Tracer(jsonl_path=str(root / "traces.jsonl"))
    calls = []
    real_fold = jax_predict.fold
    # the JAX fold compiled once (fold is jit-safe); eager op-by-op
    # dispatch of the same fold costs ~3x the time on the CPU
    jitted = jax.jit(real_fold, static_argnums=(0,),
                     static_argnames=("num_recycles",))

    def counting_fold(*args, **kw):
        calls.append(1)
        return jitted(*args, **kw)

    jax_predict.fold = counting_fold
    try:
        ref_pdbs = [jax_predict.fold_and_write(
            jm, params, seq, str(root / f"{tag}.pdb"), cache=cache,
            model_tag="w", tracer=tracer, **batch) for tag in ("m", "h")]
    finally:
        jax_predict.fold = real_fold
    tracer.close()
    assert len(calls) == 1                   # the hit did not fold
    return types.SimpleNamespace(
        pm=pm, jm=jm, params=params, seq=seq, batch=batch, root=root,
        ref_pdbs=ref_pdbs, ref_cache=cache,
        ref_traces=[json.loads(x) for x in
                    (root / "traces.jsonl").read_text().splitlines()])


def scrub(record):
    rec = {k: v for k, v in record.items()
           if k not in ("trace_id", "start_unix_s", "duration_s",
                        "request_id")}
    rec["spans"] = [{k: v for k, v in s.items()
                     if k not in ("start_s", "dur_s")}
                    for s in rec["spans"]]
    rec["events"] = [{k: v for k, v in e.items() if k != "at_s"}
                     for e in rec["events"]]
    return rec


def load_obs_report():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "obs_report", Path(__file__).resolve().parent.parent / "tools"
        / "obs_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fold_and_write_matches_jax(folded, tmp_path):
    """Miss then hit through a port FoldCache: coords within
    COORDS_ATOL of the JAX fold, the same keys and PDB file names as the
    JAX run, the hit's PDBs byte-equal to the miss's, and JAX's trace
    structure."""
    f = folded
    cache = pt_cache.FoldCache(disk_dir=str(tmp_path / "cache"))
    tracer = pt_trace.Tracer(jsonl_path=str(tmp_path / "t.jsonl"))
    paths = [pt_predict.fold_and_write(
        f.pm, f.seq, str(tmp_path / f"{tag}.pdb"), cache=cache,
        model_tag="w", tracer=tracer, device="cpu", **f.batch)
        for tag in ("m", "h")]
    tracer.close()
    assert [len(p) for p in paths] == [2, 2]
    assert [os.path.basename(p) for p in paths[0]] == \
        [os.path.basename(p) for p in f.ref_pdbs[0]]
    for miss, hit in zip(*paths):
        assert Path(miss).read_bytes() == Path(hit).read_bytes()
    # the same keys, so the two directories hold the same file names
    names = lambda d: sorted(p.name for p in d.rglob("*.npz"))  # noqa
    assert names(tmp_path / "cache") == names(f.root / "cache")
    assert cache.stats.puts == 2 and cache.stats.hits == 2
    for k in range(2):
        valid = f.batch["mask"][k]
        key = pt_cache.fold_key(f.seq[k][valid], f.batch["msa"][k][:, valid],
                                num_recycles=RECYCLES, model_tag="w")
        got, ref = cache.get(key), f.ref_cache.get(key)
        assert got.coords.shape == (valid.sum(), 3)
        np.testing.assert_allclose(got.coords, ref.coords,
                                   atol=COORDS_ATOL, rtol=0)
        np.testing.assert_allclose(got.confidence, ref.confidence,
                                   atol=COORDS_ATOL, rtol=0)
    records = [json.loads(x) for x in
               (tmp_path / "t.jsonl").read_text().splitlines()]
    assert [r["source"] for r in records] == ["fold", "cache"]
    assert [scrub(r) for r in records] == [scrub(r) for r in f.ref_traces]
    obs_report = load_obs_report()
    assert obs_report.check_traces(records) == []
    assert obs_report.check_stage_order(records) == []


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_one_cache_directory_serves_both_packages(folded, tmp_path,
                                                  monkeypatch, direction):
    """A store written by one package's fold_and_write gives the other's
    an all-hit call: no fold, and PDB text byte-equal to the writer's."""
    f = folded
    if direction == "jax_to_port":
        root, ref = f.root / "cache", f.ref_pdbs[0]
    else:
        root = tmp_path / "port_cache"
        ref = pt_predict.fold_and_write(
            f.pm, f.seq, str(tmp_path / "w.pdb"),
            cache=pt_cache.FoldCache(disk_dir=str(root)), model_tag="w",
            device="cpu", **f.batch)

    def no_fold(*args, **kwargs):
        raise AssertionError("an all-hit call folded")

    out = str(tmp_path / "r.pdb")
    if direction == "jax_to_port":
        monkeypatch.setattr(pt_predict, "fold", no_fold)
        paths = pt_predict.fold_and_write(
            f.pm, torch.from_numpy(f.seq), out,
            cache=pt_cache.FoldCache(disk_dir=str(root)), model_tag="w",
            device="cpu", **f.batch)
    else:
        monkeypatch.setattr(jax_predict, "fold", no_fold)
        paths = jax_predict.fold_and_write(
            f.jm, f.params, f.seq, out,
            cache=jax_cache.FoldCache(disk_dir=str(root)), model_tag="w",
            **f.batch)
    for got, want in zip(paths, ref):
        assert Path(got).read_bytes() == Path(want).read_bytes()


def test_fold_and_write_keying(folded, tmp_path, monkeypatch):
    """The keys follow the JAX package's rules: an all-True msa_mask keys
    as none, `device` never enters a key, a KernelSpec disables caching,
    and a partial hit folds the whole batch once and refreshes the
    store."""
    f = folded
    calls = []
    real_fold = pt_predict.fold

    def counting_fold(*args, **kw):
        calls.append(kw.get("kernel"))
        return real_fold(*args, **kw)

    monkeypatch.setattr(pt_predict, "fold", counting_fold)
    cache = pt_cache.FoldCache()
    one = dict(f.batch, mask=f.batch["mask"][:1], msa=f.batch["msa"][:1],
               msa_mask=f.batch["msa_mask"][:1])
    out = str(tmp_path / "x.pdb")
    pt_predict.fold_and_write(f.pm, f.seq[:1], out, cache=cache,
                              device="cpu", **one)
    no_mask = {k: v for k, v in one.items() if k != "msa_mask"}
    pt_predict.fold_and_write(f.pm, f.seq[:1], out, cache=cache,
                              device="cpu", **no_mask)
    assert len(calls) == 1 and cache.stats.hits == 1
    spec = KernelSpec.banded(N, 16)
    pt_predict.fold_and_write(f.pm, f.seq[:1], out, cache=cache,
                              device="cpu", kernel=spec, **one)
    assert calls[-1] is spec and cache.stats.puts == 1
    paths = pt_predict.fold_and_write(f.pm, f.seq, out, cache=cache,
                                      device="cpu", **f.batch)
    assert len(calls) == 3 and cache.stats.puts == 2
    assert cache.stats.hits == 2 and len(paths) == 2


def test_fold_and_write_error_finishes_the_trace(folded, tmp_path):
    tracer = pt_trace.Tracer()
    with pytest.raises(TypeError):
        pt_predict.fold_and_write(folded.pm, folded.seq,
                                  str(tmp_path / "e.pdb"), tracer=tracer,
                                  device="cpu", not_an_input=1)
    (rec,) = tracer.slowest()
    assert rec["status"] == "error" and "not_an_input" in rec["error"]
