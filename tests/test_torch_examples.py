"""The port's runners held against the JAX side on the CPU: the 1H22
memorization demo (`scripts/train_1h22.py` against
`examples/train_1h22.py`), the tiny trainer (`scripts/train_tiny.py`
against the loop of `examples/train_tiny.py`) and the memory probe
(`tools/memory_probe.py` against `tools/memory_probe.py`'s state).

Cheap by design: the JAX runners' `main`s never run. The demo's scores
are compared on one numpy-seeded prediction of the 1H22 CA trace
(within 1e-4 A for the RMSD, 1e-5 for the unitless scores); the port's
demo runs 2 steps on the CPU and its outputs are held to the keys of the
JAX runner's committed artifacts; the tiny trainer's first three losses
and skipped flags are compared on bridged weights with one injected MLM
draw on both sides (loss within 1e-5 relative), the JAX step jitted once
per module; the probe's state bytes are compared exactly with the JAX
`TrainState`'s parameters and Adam moments from `jax.eval_shape`
(nothing compiled).
"""

import importlib.util
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu.core import geometry as jgeo
from alphafold2_tpu.model import alphafold2 as jax_af2
from alphafold2_tpu.model import mlm as jax_mlm
from alphafold2_tpu.train import loop as jax_loop
from alphafold2_tpu.train import state as jax_state
from alphafold2_tpu.train.guard import guarded_train_step
from alphafold2_tpu_torch.data import native
from alphafold2_tpu_torch.model import mlm as pt_mlm
from alphafold2_tpu_torch.scripts import train_1h22, train_tiny
from alphafold2_tpu_torch.tools import memory_probe
from alphafold2_tpu_torch.train import CheckpointManager, TrainState, adam
from alphafold2_tpu_torch.weights import load_jax_params
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)
from test_torch_serve import random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RMSD_ATOL = 1e-4
SCORE_ATOL = 1e-5
TINY_STEPS = 3


def _load(relpath, name):
    """A JAX-side runner module loaded by path (its `main` not run)."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, relpath))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def t(x):
    return torch.from_numpy(np.array(x))


def key_tree(x):
    """The nested keys of a JSON value (lists of dicts by their first)."""
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items()}
    return None


# ---------------------------------------------------------------------------
# the 1H22 demo
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["noisy", "constant_confidence"])
def test_1h22_metrics_match_jax(case):
    """`_metrics` of both runners on one prediction of the 1H22 CA trace
    (numpy noise, two residues masked): every score within its
    tolerance; the Pearson correlation None on both sides where the
    confidence is constant."""
    jax_demo = _load("examples/train_1h22.py", "jax_train_1h22")
    with open(train_1h22.PDB) as f:
        _, coords14, atom_mask = native.parse_pdb(f.read())
    rng = np.random.default_rng(15)
    ca = coords14[None, :, 1].astype(np.float32)
    mask = atom_mask[None, :, 1].copy()
    mask[0, [5, 40]] = False
    pred = (ca + rng.normal(scale=1.5, size=ca.shape)).astype(np.float32)
    conf = rng.random(mask.shape).astype(np.float32)
    if case == "constant_confidence":
        conf[:] = 0.7
    # the JAX geometry under jit: one compile a function, not one per
    # primitive (a reflection, which jitted Kabsch can miss on XLA:CPU,
    # would show as a failure, and this prediction needs none)
    geometry = types.SimpleNamespace(**{
        name: jax.jit(getattr(jgeo, name))
        for name in ("kabsch_rmsd", "kabsch_tm", "kabsch_gdt", "lddt_ca")})
    ref = jax_demo._metrics(geometry, jnp.asarray(pred), jnp.asarray(ca),
                            jnp.asarray(mask), jnp.asarray(conf))
    out = train_1h22._metrics(t(pred), t(ca), t(mask), t(conf))
    assert set(out) == set(ref)
    for key, want in ref.items():
        if want is None:
            assert out[key] is None, key
            continue
        tol = RMSD_ATOL if key == "kabsch_rmsd" else SCORE_ATOL
        assert abs(out[key] - want) <= tol, (key, out[key], want)
    assert (ref["confidence_lddt_pearson"] is None) == \
        (case == "constant_confidence")


def test_1h22_runner_writes_the_jax_artifacts(tmp_path):
    """Two steps of the port's demo on the CPU: its metrics JSON has the
    committed JAX artifact's keys (nested), its log rows the JAX log's
    row keys, and its checkpoint restores (step, update count and
    trained weights) into a fresh state."""
    out = train_1h22.main(["--steps", "2", "--eval-every", "1",
                           "--log-every", "1", "--train-recycles", "3",
                           "--device", "cpu", "--out-dir", str(tmp_path)])
    with open(os.path.join(ROOT, "examples", "eval_1h22_metrics.json")) as f:
        committed = json.load(f)
    with open(tmp_path / "eval_1h22_metrics.json") as f:
        written = json.load(f)
    assert key_tree(written) == key_tree(committed) == key_tree(out)
    assert written["train_steps"] == 2 and written["train_recycles"] == 3
    assert written["config"] == committed["config"]

    def row_keys(path):
        with open(path) as f:
            return {tuple(sorted(json.loads(line))) for line in f}
    assert row_keys(tmp_path / "train_1h22_full_log.jsonl") == row_keys(
        os.path.join(ROOT, "examples", "train_1h22_full_log.jsonl"))

    # restored into the runner's own initial weights: every parameter
    # the two Adam steps reached (a nonzero moment) has moved
    model = train_1h22.build_model("cpu", seed=0)
    initial = [p.detach().clone() for p in model.parameters()]
    state = CheckpointManager(written["checkpoint"]).restore(
        TrainState.create(model, adam(1e-3), seed=2))
    assert state.step == 2 and state.optimizer.count == 2
    moved = [not torch.equal(a, b) for a, b in zip(initial,
                                                   model.parameters())]
    reached = state.optimizer.reached
    assert sum(reached) > 100 and moved == reached
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_runners_refuse_the_cpu_unless_asked(monkeypatch):
    """Without --device the runners resolve the CUDA card, which this
    machine lacks: they raise before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (lambda: train_1h22.main(["--steps", "1"]),
                 lambda: train_tiny.main(["1"]),
                 lambda: memory_probe.main(["--depths", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main()


# ---------------------------------------------------------------------------
# the tiny trainer
# ---------------------------------------------------------------------------

TINY_KW = dict(dim=32, depth=2, heads=2, dim_head=16)


@pytest.fixture(scope="module")
def tiny_reference():
    """The JAX loop of `examples/train_tiny.py` (guarded, jitted once)
    over TINY_STEPS steps on the port's batch, from numpy-drawn params
    on the init's shapes, with one MLM draw injected; returns the
    params, the noise and the JAX losses and skipped flags."""
    batch = {k: v.numpy() for k, v in train_tiny.make_batch("cpu").items()}
    jm = jax_af2.Alphafold2(**TINY_KW)
    shapes = jax.eval_shape(
        lambda key: jm.init({"params": key, "mlm": key}, batch["seq"],
                            msa=batch["msa"], mask=batch["mask"],
                            msa_mask=batch["msa_mask"], train=True),
        jax.random.PRNGKey(1))
    rng = np.random.default_rng(16)
    params = random_params(shapes, rng)
    # one MLM draw for both sides (any draw: the losses are compared
    # given it): ~15 % of the MSA replaced, a third of those by a random
    # amino acid, the rest by the mask token
    replaced = (rng.random(batch["msa"].shape) < 0.15) & batch["msa_mask"]
    tokens = np.where(rng.random(replaced.shape) < 1 / 3,
                      rng.integers(1, 21, replaced.shape), 21)
    noise = (np.where(replaced, tokens, batch["msa"]), replaced)
    tx = jax_state.adam(1e-3, warmup_steps=5, decay_steps=TINY_STEPS)
    # the optimizer's zero state on its traced shapes (an eager
    # `tx.init` compiles one op per leaf)
    opt_state = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                             jax.eval_shape(tx.init, params))
    state = jax_state.TrainState(
        step=0, apply_fn=jm.apply, params=params, tx=tx,
        opt_state=opt_state, rng=jax.random.PRNGKey(3))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses, skipped = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mlm.MLM, "noise",
                   lambda self, rng, seq, mask: tuple(map(jnp.asarray,
                                                          noise)))
        step = jax.jit(guarded_train_step(jax_loop.make_train_step(jm)))
        for _ in range(TINY_STEPS):
            state, metrics = step(state, jbatch)
            losses.append(float(metrics["loss"]))
            skipped.append(int(metrics["skipped"]))
    return params, noise, losses, skipped


def test_train_tiny_matches_the_jax_loop(tiny_reference, monkeypatch):
    params, noise, losses, skipped = tiny_reference
    noised, replaced = (t(a) for a in noise)
    monkeypatch.setattr(pt_mlm.MLM, "noise",
                        lambda self, seq, mask, generator=None:
                        (noised, replaced))
    build = train_tiny.build_model

    def bridged(device):
        model = build(device)
        load_jax_params(model, jax.tree.map(np.asarray, params))
        return model

    monkeypatch.setattr(train_tiny, "build_model", bridged)
    history = train_tiny.main([str(TINY_STEPS), "--device", "cpu"])
    assert [h["skipped"] for h in history] == skipped == [0] * TINY_STEPS
    for got, want in zip([h["loss"] for h in history], losses, strict=True):
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    # the warm-up's first rate is 0 and the second is not
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)
    assert abs(losses[2] - losses[1]) > 1e-4 * abs(losses[1])


# ---------------------------------------------------------------------------
# the memory probe
# ---------------------------------------------------------------------------

def jax_state_bytes(depth, seq_len, dim):
    """The bytes of the JAX probe's TrainState at `depth` that the port's
    state holds as tensors: its floating leaves, the parameters and Adam
    moments (the step, key and Adam count are host integers in the
    port), from shapes traced abstractly."""
    jm = jax_af2.Alphafold2(dim=dim, depth=depth, heads=8, dim_head=64,
                            dtype=jnp.bfloat16)
    seq = jnp.zeros((1, seq_len), jnp.int32)
    msa = jnp.zeros((1, 5, seq_len), jnp.int32)
    mask = jnp.ones((1, seq_len), bool)

    def make():
        params = jm.init(jax.random.PRNGKey(1), seq, msa=msa, mask=mask,
                         msa_mask=jnp.ones((1, 5, seq_len), bool))
        return jax_state.TrainState.create(
            apply_fn=jm.apply, params=params, tx=jax_state.adam(3e-4),
            rng=jax.random.PRNGKey(2))
    leaves = jax.tree.leaves(jax.eval_shape(make))
    return sum(int(np.prod(x.shape)) * x.dtype.itemsize for x in leaves
               if jnp.issubdtype(x.dtype, jnp.floating))


def test_memory_probe_rows_match_the_jax_probe():
    """Depths 1 and 2 at 16 residues, dim 32, on the CPU: the JAX probe's
    row keys less the device ones, the state's bytes equal to the JAX
    TrainState's parameters and Adam moments, byte for byte, and a
    finite loss."""
    rows = memory_probe.main(["--depths", "1,2", "--len", "16", "--dim",
                              "32", "--run", "--device", "cpu"])
    jax_keys = {"depth", "seq_len", "dim", "reversible", "use_scan",
                "platform", "argument_size_mb", "output_size_mb", "loss"}
    for depth, row in zip((1, 2), rows, strict=True):
        assert set(row) == jax_keys, set(row) ^ jax_keys
        assert (row["depth"], row["seq_len"], row["dim"], row["platform"],
                row["use_scan"], row["reversible"]) == \
            (depth, 16, 32, "cpu", True, False)
        state = TrainState.create(
            memory_probe.zero_model(depth, 32, False, True, "cpu"),
            adam(3e-4))
        got = memory_probe.state_bytes(state)
        assert got == jax_state_bytes(depth, 16, 32)
        assert row["argument_size_mb"] == round(got / 2 ** 20, 1), row
        assert row["output_size_mb"] >= row["argument_size_mb"]
        assert np.isfinite(row["loss"])
