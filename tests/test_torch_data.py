"""Parity of the port's host-side data leaves and step-state snapshots
with the JAX package: featurize, the native A3M/PDB parse (library and
Python fallback), PDB writing, the quaternion/rigid gaps, and
`predict.snapshot_step_state` / `restore_step_state`.

Inputs are drawn with numpy from a seed and cross as numpy arrays.
Integer and text outputs must be equal; the float geometry agrees
within 1e-5 (fp32, sums in another order); a restored carry is
byte-equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import constants as jax_constants
from alphafold2_tpu import predict as jax_predict
from alphafold2_tpu.cache import checkpoints as jax_ckpt
from alphafold2_tpu.data import featurize as jax_feat
from alphafold2_tpu.data import native as jax_native
from alphafold2_tpu.data import pdb_io as jax_pdb
from alphafold2_tpu.model import alphafold2 as jax_af2
from alphafold2_tpu_torch import constants as pt_constants
from alphafold2_tpu_torch import predict as pt_predict
from alphafold2_tpu_torch.cache import checkpoints as pt_ckpt
from alphafold2_tpu_torch.data import featurize as pt_feat
from alphafold2_tpu_torch.data import native as pt_native
from alphafold2_tpu_torch.data import pdb_io as pt_pdb
from alphafold2_tpu_torch.model import alphafold2 as pt_af2

REPO = Path(__file__).resolve().parent.parent
PDB_FILE = REPO / "tests" / "data" / "1h22_head.pdb"
A3M = """>query
ARNDCQEGHILK
>hit1 some description
ARNDCaaQEGHILK
>hit2
-RND.CQEGHIL-
>hit3
XBNDCQEGHZLK
"""


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("name", [
    "NUM_COORDS_PER_RES", "AA_ALPHABET", "ONE_TO_THREE", "THREE_TO_ONE",
    "SIDECHAIN_ATOMS", "BACKBONE_ATOMS"])
def test_data_constants_match(name):
    assert getattr(pt_constants, name) == getattr(jax_constants, name)


# -- featurize ----------------------------------------------------------------


def test_tokenize_detokenize_match_jax():
    for s in ("ARNDCQEGHILKMFPSTWYV", "mkv-x.ZB", ""):
        np.testing.assert_array_equal(pt_feat.tokenize(s),
                                      jax_feat.tokenize(s))
        tok = jax_feat.tokenize(s)
        assert pt_feat.tokenize(s).dtype == tok.dtype
        assert pt_feat.detokenize(tok) == jax_feat.detokenize(tok)


@pytest.mark.parametrize("rows,max_rows", [(3, 5), (12, 5)])
def test_subsample_msa_matches_jax(rows, max_rows):
    msa = np.random.default_rng(1).integers(0, 21, (rows, 9))
    np.testing.assert_array_equal(
        pt_feat.subsample_msa(msa, max_rows, np.random.default_rng(2)),
        jax_feat.subsample_msa(msa, max_rows, np.random.default_rng(2)))


@pytest.mark.parametrize("length,crop", [(10, 16), (40, 16)])
def test_contiguous_crop_matches_jax(length, crop):
    assert pt_feat.contiguous_crop(length, crop, np.random.default_rng(3)) \
        == jax_feat.contiguous_crop(length, crop, np.random.default_rng(3))


@pytest.mark.parametrize("mode", ["ca", "cb"])
def test_distance_targets_match_jax(mode):
    seq, coords, mask = jax_native._parse_pdb_py(PDB_FILE.read_text())
    resolved = mask[:, :3].all(-1)
    np.testing.assert_array_equal(
        pt_feat.distance_map_targets(coords, seq, resolved, mode=mode),
        jax_feat.distance_map_targets(coords, seq, resolved, mode=mode))
    np.testing.assert_allclose(
        pt_feat.virtual_cb(coords[:, 0], coords[:, 1], coords[:, 2]),
        jax_feat.virtual_cb(coords[:, 0], coords[:, 1], coords[:, 2]),
        rtol=0, atol=1e-5)


def test_collate_matches_jax():
    rng = np.random.default_rng(4)
    seq, coords, _ = jax_native._parse_pdb_py(PDB_FILE.read_text())
    samples = [{"seq": seq[:30], "msa": rng.integers(0, 21, (7, 30)),
                "coords": coords[:30]},
               {"seq": seq[30:50]}]
    ref = jax_feat.collate(samples, 24, max_msa_rows=4,
                           rng=np.random.default_rng(5))
    out = pt_feat.collate(samples, 24, max_msa_rows=4,
                          rng=np.random.default_rng(5))
    assert sorted(out) == sorted(ref)
    for key in ref:
        assert out[key].dtype == ref[key].dtype, key
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


# -- native parse -------------------------------------------------------------


def test_native_library_builds_into_the_port():
    lib = pt_native.load_library()
    assert lib is not None, "g++ build of native/af2data.cc failed"
    assert pt_native.library_path().parent == REPO / \
        "alphafold2_tpu_torch" / "_build"


@pytest.mark.parametrize("backend", ["native", "python"])
def test_parse_a3m_matches_jax(backend):
    parse = pt_native.parse_a3m if backend == "native" \
        else pt_native._parse_a3m_py
    out = parse(A3M)
    assert out.dtype == np.int8
    np.testing.assert_array_equal(out, jax_native._parse_a3m_py(A3M))
    with pytest.raises(ValueError):
        parse(">a\nARND\n>b\nARNDC\n")


@pytest.mark.parametrize("backend,chain", [
    ("native", None), ("python", None), ("native", "A")])
def test_parse_pdb_matches_jax(backend, chain):
    text = PDB_FILE.read_text()
    parse = pt_native.parse_pdb if backend == "native" \
        else pt_native._parse_pdb_py
    out = parse(text, chain)
    ref = jax_native._parse_pdb_py(text, chain)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# -- PDB writing --------------------------------------------------------------


@pytest.mark.parametrize("trace", ["ca", "atoms14"])
def test_coords2pdb_text_equals_jax(tmp_path, trace):
    seq, coords, mask = jax_native._parse_pdb_py(PDB_FILE.read_text())
    seq = seq.copy()
    seq[3] = jax_feat.AA_INDEX["_"]          # a padding residue is skipped
    if trace == "ca":
        coords, mask = coords[:, 1] + np.float32(0.0004), None
    jp = jax_pdb.coords2pdb(seq, coords, mask, name=str(tmp_path / "j.pdb"))
    pp = pt_pdb.coords2pdb(seq, coords, mask, name=str(tmp_path / "p.pdb"))
    assert Path(pp).read_bytes() == Path(jp).read_bytes()
    # and it reads back to the coordinates written, to the file's 3 decimals
    _, back, back_mask = pt_native.parse_pdb(Path(pp).read_text())
    ca = coords if trace == "ca" else coords[:, 1]
    keep = seq != jax_feat.AA_INDEX["_"]
    np.testing.assert_allclose(back[:, 1], ca[keep], atol=5e-4, rtol=0)


def test_clean_pdb_equals_jax(tmp_path):
    text = PDB_FILE.read_text() + \
        "ATOM      1  N   TRP B   1       0.000   0.000   0.000  1.00" \
        "  0.00           N\n"
    src = tmp_path / "in.pdb"
    src.write_text(text)
    for chain in (None, "B"):
        jax_pdb.clean_pdb(str(src), str(tmp_path / "j.pdb"), chain=chain)
        pt_pdb.clean_pdb(str(src), str(tmp_path / "p.pdb"), chain=chain)
        assert (tmp_path / "p.pdb").read_bytes() == \
            (tmp_path / "j.pdb").read_bytes()


# -- quaternion / rigid -------------------------------------------------------


def test_quaternion_invert_rotate_and_compose_update_match_jax():
    from alphafold2_tpu.core import quaternion as jq
    from alphafold2_tpu.core.rigid import Rigid as JaxRigid
    from alphafold2_tpu_torch.core import quaternion as pq
    from alphafold2_tpu_torch.core.rigid import Rigid as PortRigid

    rng = np.random.default_rng(6)
    q = rng.normal(size=(3, 5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(3, 5, 3)).astype(np.float32)
    dq = rng.normal(size=(3, 5, 4)).astype(np.float32)
    dt = rng.normal(size=(3, 5, 3)).astype(np.float32)
    tr = rng.normal(size=(3, 5, 3)).astype(np.float32)

    def close(a, b):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)

    close(jq.quaternion_invert(q), pq.quaternion_invert(t(q)))
    close(jq.rotate_vector(q, v), pq.rotate_vector(t(q), t(v)))
    ref = JaxRigid(jnp.asarray(q), jnp.asarray(tr)).compose_update(dq, dt)
    out = PortRigid(t(q), t(tr)).compose_update(t(dq), t(dt))
    close(ref.quaternions, out.quaternions)
    close(ref.translations, out.translations)


# -- step-state snapshots ----------------------------------------------------


def state_arrays(seed=7, b=2, n=6, dim=4):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return (f(b, n, 3), f(b, n), f(b, n, n, 5),
            (f(b, n, 3), f(b, n, dim), f(b, n, n, dim)))


def jax_state(arrays):
    c, conf, d, rec = arrays
    return jax_predict.FoldStepState(
        jnp.asarray(c), jnp.asarray(conf), jnp.asarray(d),
        jax_af2.Recyclables(*map(jnp.asarray, rec)))


def port_state(arrays):
    c, conf, d, rec = arrays
    return pt_predict.FoldStepState(t(c), t(conf), t(d),
                                    pt_af2.Recyclables(*map(t, rec)))


def test_snapshot_leaf_order_is_jax_tree_flatten_order():
    arrays = state_arrays()
    ref_leaves, _ = jax.tree_util.tree_flatten(jax_state(arrays))
    _, snap = pt_predict.snapshot_step_state(port_state(arrays))
    assert len(snap) == len(ref_leaves) == 6
    for (kind, val, device), ref in zip(snap, ref_leaves):
        assert kind == "dev" and device == torch.device("cpu")
        assert val.dtype == np.float32
        np.testing.assert_array_equal(val, np.asarray(ref))


def test_snapshot_restore_round_trip_is_byte_equal():
    state = port_state(state_arrays())
    state = state._replace(distogram=state.distogram.bfloat16())
    expect = [x.clone() for x in pt_predict.tree_flatten(state)[0]]
    snap = pt_predict.snapshot_step_state(state)
    state.coords.add_(1.0)            # the copy is detached from the carry
    back = pt_predict.restore_step_state(snap)
    assert type(back) is pt_predict.FoldStepState
    assert type(back.recyclables) is pt_af2.Recyclables
    got = pt_predict.tree_flatten(back)[0]
    assert len(got) == len(expect) == 6
    for a, b in zip(got, expect):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def test_snapshot_keeps_reference_leaves_and_drops_none():
    opaque = object()
    tree = {"b": [torch.zeros(2), None, opaque], "a": (1.5, "x")}
    treedef, snap = pt_predict.snapshot_step_state(tree)
    assert [k for k, _, _ in snap] == ["ref", "ref", "dev", "ref"]
    assert snap[3][1] is opaque
    back = pt_predict.restore_step_state((treedef, snap))
    assert back["a"] == (1.5, "x") and back["b"][1] is None
    assert back["b"][2] is opaque


def test_restore_on_a_missing_card_raises_not_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    treedef, snap = pt_predict.snapshot_step_state([torch.zeros(2)])
    snap = [(kind, val, torch.device("cuda", 0)) for kind, val, _ in snap]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_predict.restore_step_state((treedef, snap))


def test_jax_row_checkpoint_restores_into_the_port_carry():
    """A JAX snapshot's row checkpoint, encoded by the JAX package,
    decodes in the port with equal arrays and restores (on the CPU)
    into leaves that rebuild the port's carry row."""
    arrays = state_arrays()
    snap = jax_predict.snapshot_step_state(jax_state(arrays))
    key = jax_ckpt.checkpoint_key("fk", "tag", 2)
    seq = np.arange(6, dtype=np.int32)
    row = jax_ckpt.row_checkpoint(snap, 1, fold_key="fk", model_tag="tag",
                                  age=2, seq=seq)
    ckpt = pt_ckpt.decode_checkpoint(key, jax_ckpt.encode_checkpoint(key,
                                                                     row))
    leaves = ckpt.restore_leaves(device="cpu")
    treedef, _ = pt_predict.snapshot_step_state(port_state(arrays))
    back = pt_predict.tree_unflatten(treedef, leaves)
    ref = port_state(arrays)
    for a, b in zip(pt_predict.tree_flatten(back)[0],
                    pt_predict.tree_flatten(ref)[0]):
        assert torch.equal(a, b[1:2])
