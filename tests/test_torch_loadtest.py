"""The port's load test (`alphafold2_tpu_torch.tools.serve_loadtest`)
against the JAX package's (`tools/serve_loadtest.py`), on the CPU.

Both tools run in-process with the same arguments and serve the same
weights: the JAX tool's tiny model (dim 32, depth 1, heads 2, dim_head
16) on its init's shapes with numpy-drawn values, handed to the JAX tool
through its model builder and to the port's through `load_jax_params`.
Both draw the same traffic (the port reproduces the JAX package's
threefry draws). The reports must have the same nested keys and the
same seeded counts; counts that depend on thread timing are held by
invariant. Then the port's tool alone in the modes whose JAX tests pin
their report (features, cascade and express, step scheduling with early
exit, cross-bucket admission, a mesh policy on one device), and its
refusals.
"""

import contextlib
import importlib.util
import io
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from alphafold2_tpu.model.alphafold2 import Alphafold2 as JaxAlphafold2
from alphafold2_tpu_torch import load_jax_params
from alphafold2_tpu_torch.fleet.procfleet import replica_model
from alphafold2_tpu_torch.tools import serve_loadtest as pt_lt
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]

# one bucket, few requests: the JAX side builds one fold program per
# mode and shares it across the cases through its compile cache
BASE = ["--requests", "8", "--lengths", "20,28", "--buckets", "32",
        "--concurrency", "2", "--max-batch", "2", "--msa-depth", "3",
        "--smoke"]


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def random_params(shapes, rng):
    """Parameters on the init's shapes, drawn with numpy: LayerNorm
    scales near 1, Dense kernels N(0, 1/fan_in), the rest small noise."""
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
def tools():
    """(JAX tool module, its model, params): the JAX model's params are
    traced abstractly (every branch exists, as `init` makes them) and
    drawn once for the module."""
    jax_lt = load_jax_tool("serve_loadtest")
    jm = JaxAlphafold2(dim=32, depth=1, heads=2, dim_head=16,
                       predict_coords=True, structure_module_depth=1)
    n = 32
    shapes = jax.eval_shape(
        lambda key: jm.init(key, np.zeros((1, n), np.int32),
                            msa=np.zeros((1, 3, n), np.int32),
                            mask=np.ones((1, n), bool),
                            msa_mask=np.ones((1, 3, n), bool)),
        jax.random.PRNGKey(0))
    params = random_params(shapes, np.random.default_rng(0))
    return jax_lt, jm, params


@pytest.fixture
def same_weights(tools, monkeypatch):
    """Both tools serve the module's weights."""
    jax_lt, jm, params = tools
    host = jax.tree.map(np.asarray, params)

    def port_model(args, device, seed=0, draft=False):
        model = replica_model({"dim": 32, "depth": 1}, device)
        load_jax_params(model, host)
        return model

    monkeypatch.setattr(jax_lt, "_build_tiny_model",
                        lambda args, jax, jnp, policy: (jm, params))
    monkeypatch.setattr(pt_lt, "build_model", port_model)
    return jax_lt


def run_tool(main, argv):
    """(exit code, the report) of one in-process run."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("{")]
    return rc, json.loads(lines[-1])


def key_tree(x, data_keyed=(), path=""):
    """The nested key structure of a report; the dicts at `data_keyed`
    paths are keyed by data (statuses, fired injections), so only their
    presence counts."""
    if not isinstance(x, dict):
        return None
    if path in data_keyed:
        return "data"
    return {k: key_tree(v, data_keyed, f"{path}/{k}")
            for k, v in x.items()}


def both(same_weights, tmp_path, argv):
    jax_lt = same_weights
    out = {}
    for side, main in (("jax", jax_lt.main), ("port", pt_lt.main)):
        d = tmp_path / side
        d.mkdir()
        extra = ["--metrics-path", str(d / "m.jsonl")]
        extra += ["--device", "cpu"] if side == "port" else []
        if "--trace" in argv:
            extra += ["--trace-path", str(d / "t.jsonl"),
                      "--prom-path", str(d / "m.prom")]
        out[side] = run_tool(main, BASE + [a for a in argv
                                           if a != "--trace"] + extra)
    return out


SEEDED = ("metric", "requests", "unique_requests", "served", "shed",
          "errors", "rejected", "poisoned", "dup_rate", "cache_enabled",
          "bucket_edges")
DATA_KEYED = ("/statuses", "/chaos/injected", "/chaos/injected_by_variant",
              "/kernel/folds", "/per_replica", "/latency_by_bucket",
              "/kernel/buckets")

CASES = {
    "plain-traced": ["--trace"],
    "dup-cache-chaos": ["--dup-rate", "0.5", "--cache", "on", "--chaos"],
    "blocksparse-continuous": ["--kernel-policy", "blocksparse",
                               "--sparse-block", "8", "--continuous",
                               "--num-recycles", "1"],
    "fleet-rollout": ["--replicas", "2", "--rollout-at", "0.5",
                      "--dup-rate", "0.5"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_loadtest_report_matches_jax(case, same_weights, tmp_path):
    out = both(same_weights, tmp_path, CASES[case])
    (jrc, jrep), (prc, prep) = out["jax"], out["port"]
    assert jrc == prc == 0, (jrep.get("failures"), prep.get("failures"))
    assert key_tree(prep, DATA_KEYED) == key_tree(jrep, DATA_KEYED)
    assert jrep["platform"] == prep["platform"] == "cpu"
    for key in SEEDED:
        # across two replicas, whether a twin folds again before its
        # owner's entry lands depends on the threads' timing
        if key in jrep and not (key == "served" and case == "fleet-rollout"):
            assert prep[key] == jrep[key], key
    # how requests group into batches depends on the threads' timing;
    # the step count per batch does not
    for rep in (jrep, prep):
        if "recycle" in rep:
            assert rep["executor_steps"] == rep["batches"] \
                + rep["recycle"]["recycles_executed"]
        elif "executor_steps" in rep:
            assert rep["executor_steps"] == rep["batches"]
    if case == "plain-traced":
        assert prep["latency_by_bucket"].keys() \
            == jrep["latency_by_bucket"].keys()
        assert prep["traces_completed"] == jrep["traces_completed"] == 8
    if case == "dup-cache-chaos":
        # the duplicates never folded again: each was a store hit or
        # coalesced onto its leader, whatever the threads' timing
        for rep in (jrep, prep):
            assert rep["executor_calls_avoided"] == \
                rep["requests"] - rep["unique_requests"]
            assert rep["cache_store"]["hits"] >= 1
        jc, pc = jrep["chaos"], prep["chaos"]
        for key in ("seed", "rates", "poison_registered", "poison_mode"):
            assert pc[key] == jc[key], key
        assert [p["status"] for p in pc["poison_results"]] \
            == [p["status"] for p in jc["poison_results"]] == ["poisoned"]
        # every execution of a batch holding the poison fired it
        for c in (jc, pc):
            assert c["injected"]["poison_raise"] \
                == c["poison_results"][0]["attempts"] >= 1
    if case == "blocksparse-continuous":
        jk, pk = jrep["kernel"], prep["kernel"]
        assert pk["folds"].keys() == jk["folds"].keys() \
            == {"blocksparse:32"}
        assert pk["folds"]["blocksparse:32"]["served"] \
            == jk["folds"]["blocksparse:32"]["served"] == 8
        assert pk["buckets"] == jk["buckets"]
        for rep in (jrep, prep):
            assert rep["kernel"]["numerics_max_diff"]["32"] <= 1e-3
    if case == "fleet-rollout":
        for rep in (jrep, prep):
            assert rep["rollout"]["stale_tag_hits"] == 0
            assert rep["rollout"]["stale_probe"] == {
                "returned_value": False, "refusals_409": 1}
            assert rep["hit_ratio"] * rep["requests"] == pytest.approx(
                rep["cache_hits"] + rep["coalesced"], abs=1e-2)
        assert prep["rollout"]["at_request"] == jrep["rollout"]["at_request"]


def run_port(tmp_path, argv):
    return run_tool(pt_lt.main, BASE + argv + [
        "--device", "cpu", "--metrics-path", str(tmp_path / "m.jsonl")])


PORT_ALONE = {
    # the feature pipeline: every unique raw key featurized once
    "features": ["--feature-latency-ms", "2", "--feature-pool", "2",
                 "--feature-dup-rate", "0.5"],
    # the cascade (scripted gate) with the express lane
    "cascade-express": ["--cascade", "--express-rate", "0.3",
                        "--draft-accept-rate", "0.5"],
    # step scheduling with injected convergence: every element retires
    # after its first recycle
    "recycle-sched": ["--recycle-sched", "--converge-tol", "1e9",
                      "--num-recycles", "2", "--stream"],
    # cross-bucket admission: freed 64-bucket rows admit 32-bucket folds
    "cross-bucket": ["--lengths", "24,24,24,60", "--buckets", "32,64",
                     "--cross-bucket", "--eager-form", "--num-recycles",
                     "3", "--converge-percentile", "50"],
    # a 4-chip slice asked for on one device clamps to it
    "mesh-one-device": ["--buckets", "32,64", "--lengths", "20,50",
                        "--mesh-policy", "32=1,64=4"],
}


@pytest.mark.parametrize("case", list(PORT_ALONE))
def test_loadtest_modes_of_the_port(case, tmp_path):
    rc, rep = run_port(tmp_path, PORT_ALONE[case])
    assert rc == 0, rep.get("failures")
    assert rep["platform"] == "cpu"
    if case == "features":
        assert rep["metric"] == "serve_loadtest_features"
        feat = rep["featurize"]
        assert feat["executions"] == rep["unique_raw_keys"]
        assert feat["cache_hits"] + feat["coalesced"] >= 1
        assert rep["served"] == 8
    if case == "cascade-express":
        casc = rep["cascade"]
        assert casc["cross_tier_hits"] == 0
        assert casc["draft_accepted"] >= 1 and casc["escalated"] >= 1
        assert casc["flagship_folds"] == rep["served"] \
            - casc["draft_accepted"]
        assert casc["accel_seconds"]["total"] > 0
        assert rep["express"]["served"] >= 1
        assert set(rep["latency_by_lane"]) == {"express", "online"}
        assert set(rep["latency_by_tier"]) <= {"draft", "flagship"}
    if case == "recycle-sched":
        rec = rep["recycle"]
        assert rec["recycles_skipped"] > 0
        assert rep["recycles_saved"] == rec["recycles_skipped"]
        assert rep["executor_steps"] == rep["batches"] \
            + rec["recycles_executed"]
        assert rep["executor_steps"] < rep["batches"] * 3
        assert rep["progress_updates"] >= rep["served"]
    if case == "cross-bucket":
        assert rep["cross_bucket"] is True and rep["continuous"] is True
        assert rep["cross_bucket_admissions"] >= 1
        assert "converge_tol_calibrated" in rep
        assert 0 < rep["rows_occupied_fraction"] <= 1
    if case == "mesh-one-device":
        assert rep["devices"] == 1
        assert rep["mesh"]["folds"].keys() == {"1x1"}
        assert rep["too_large"] == 0


def test_loadtest_refusals(tmp_path, monkeypatch):
    rc = pt_lt.main(["--kernel-backend", "pallas", "--device", "cpu"])
    assert rc == 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt_lt.main(["--requests", "1",
                    "--metrics-path", str(tmp_path / "m.jsonl")])
