"""The PyTorch port's geometry and decode helpers held against the JAX
package on the CPU: the atom tables, `data/scn`, `data/graph`,
`core/nerf`, `core/mds`, `relax` and `model/rotary`.

Inputs are drawn with numpy from a seed and cross as numpy arrays; both
sides compute in fp32 (conftest pins JAX matmuls to float32). Masks,
tokens, indices and adjacency are compared exactly. Tolerances, absolute:
1e-5 for functions of O(1) values (rotary, NeRF placement, dihedral
fractions); 1e-4 for coordinates of O(10) A built through a chain of
NeRF placements, for MDS distances and stress, and for the relaxed
coordinates and energies (sums over O(100) atom pairs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alphafold2_tpu import constants as jc
from alphafold2_tpu import relax as jrelax
from alphafold2_tpu.core import mds as jmds
from alphafold2_tpu.core import nerf as jnerf
from alphafold2_tpu.data import graph as jgraph
from alphafold2_tpu.data import scn as jscn
from alphafold2_tpu.model import rotary as jrot
from alphafold2_tpu_torch import constants as pc
from alphafold2_tpu_torch import core as pcore
from alphafold2_tpu_torch import relax as prelax
from alphafold2_tpu_torch.core import geometry as pgeo
from alphafold2_tpu_torch.core import mds as pmds
from alphafold2_tpu_torch.core import nerf as pnerf
from alphafold2_tpu_torch.data import graph as pgraph
from alphafold2_tpu_torch.data import scn as pscn
from alphafold2_tpu_torch.model import rotary as prot
from test_torch_serve import _torch_threads_per_worker  # noqa: F401  (autouse)

B, L = 2, 7
SMALL_ATOL = 1e-5
COORDS_ATOL = 1e-4

# the JAX references with a scan inside run jitted (the scaffold build is
# cheaper eagerly: its unrolled slots take seconds to compile)
j_mds = jax.jit(jmds.mds, static_argnames=("iters", "tol", "eigen_only"))
j_relax = jax.jit(jrelax.gradient_relax, static_argnames=("steps",))


def t(x):
    return torch.from_numpy(np.array(x))


def close(jax_out, port_out, atol=SMALL_ATOL):
    a = np.asarray(jax_out, np.float64)
    b = port_out.detach().double().numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    err = float(np.abs(a - b).max()) if a.size else 0.0
    assert err <= atol, f"max abs err {err} > {atol}"


def equal(jax_out, port_out):
    a, b = np.asarray(jax_out), port_out.numpy()
    assert a.shape == b.shape and (a == b).all()


def tokens(rng, b=B, l=L):
    # every standard residue type appears across the draws; 20 = "_"
    return rng.integers(0, 21, (b, l))


def test_atom_tables_match_jax():
    for name in ("CLOUD_MASK_TABLE", "ATOM_ID_TABLE",
                 "BOND_ADJACENCY_TABLE"):
        a, b = getattr(jc, name), getattr(pc, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert pc.ATOM_IDS == jc.ATOM_IDS
    assert pc.NUM_ATOM_TOKENS == jc.NUM_ATOM_TOKENS
    assert pc.AA_DATA == jc.AA_DATA
    assert pc.ESM_MODEL_PATH == jc.ESM_MODEL_PATH
    assert pc.MSA_MODEL_PATH == jc.MSA_MODEL_PATH
    assert pc.CUSTOM_INFO.keys() == jc.CUSTOM_INFO.keys()
    for aa, info in jc.CUSTOM_INFO.items():
        for key, value in info.items():
            assert np.array_equal(pc.CUSTOM_INFO[aa][key], value), (aa, key)


def test_scn_matches_jax():
    rng = np.random.default_rng(0)
    seq = tokens(rng)
    equal(jscn.scn_cloud_mask(seq), pscn.scn_cloud_mask(t(seq)))
    coords = rng.normal(size=(B, L, 14, 3)).astype(np.float32)
    coords[rng.random((B, L, 14)) < 0.3] = 0.0
    for c in (coords, coords.reshape(B, L * 14, 3)):
        equal(jscn.scn_cloud_mask(seq, c), pscn.scn_cloud_mask(t(seq), t(c)))
    for boolean in (True, False):
        for a, b in zip(jscn.scn_backbone_mask(seq, boolean),
                        pscn.scn_backbone_mask(t(seq), boolean)):
            equal(a, b)
    for a, b in zip(jscn.backbone_indices(L), pscn.backbone_indices(L)):
        equal(a, b)
    equal(np.asarray(jscn.scn_atom_embedd(seq)).astype(np.int64),
          pscn.scn_atom_embedd(t(seq)))
    x = rng.normal(size=(B, L, 5)).astype(np.float32)
    cloud = np.asarray(jscn.scn_cloud_mask(seq))
    close(jscn.chain2atoms(x, cloud), pscn.chain2atoms(t(x), t(cloud)))
    close(jscn.chain2atoms(x), pscn.chain2atoms(t(x)))


@pytest.mark.parametrize("peptide", [True, False])
def test_graph_matches_jax(peptide):
    rng = np.random.default_rng(1)
    seq = tokens(rng)
    adj = pgraph.prot_covalent_bond(t(seq), include_peptide_bonds=peptide)
    equal(jgraph.prot_covalent_bond(seq, include_peptide_bonds=peptide),
          adj)
    for a, b in zip(jgraph.covalent_neighbor_table(seq, peptide),
                    pgraph.covalent_neighbor_table(t(seq), peptide)):
        equal(np.asarray(a).astype(b.numpy().dtype), b)
    for a, b in zip(jgraph.nth_deg_adjacency(adj.numpy(), 3),
                    pgraph.nth_deg_adjacency(adj, 3)):
        equal(a, b)
    x = rng.normal(size=(B, L * 14, 3)).astype(np.float32)
    mask = rng.random((B, L * 14)) < 0.8
    for a, b in zip(jgraph.mat_input_to_masked(x, mask, adj.numpy()),
                    pgraph.mat_input_to_masked(t(x), t(mask), adj)):
        equal(a, b)
    got = pgraph.mat_input_to_masked(t(x))
    equal(jgraph.mat_input_to_masked(x)[1], got[1])
    assert got[2] is None and got[3] is None


def backbones(rng, atoms, b=B, l=L):
    """A chain of residues whose N/CA/C(/O) are spread like a backbone."""
    steps = rng.normal(size=(b, l, 1, 3)) + np.array([3.0, 0.0, 0.0])
    local = rng.normal(size=(b, l, atoms, 3)) * 0.9
    return (np.cumsum(steps, axis=1) + local).astype(np.float32)


def test_nerf_place_matches_jax():
    # the per-residue build tables (ancestors, lengths, angles, torsion
    # offsets) are the JAX package's
    for name in ("_PARENT", "_GRAND", "_GREAT", "_LENGTH", "_ANGLE",
                 "_BUILD", "_TORSION_OFF"):
        assert np.array_equal(getattr(pnerf, name), getattr(jnerf, name))
    rng = np.random.default_rng(2)
    a, b, c = (rng.normal(size=(5, 3)).astype(np.float32) for _ in range(3))
    length = rng.uniform(1.2, 1.6, 5).astype(np.float32)
    angle = rng.uniform(1.7, 2.2, 5).astype(np.float32)
    tors = rng.uniform(-3, 3, 5).astype(np.float32)
    close(jnerf.nerf_place(a, b, c, length, angle, tors),
          pnerf.nerf_place(t(a), t(b), t(c), t(length), t(angle), t(tors)))
    # scalars broadcast
    close(jnerf.nerf_place(a, b, c, 1.5, 2.0, np.pi),
          pnerf.nerf_place(t(a), t(b), t(c), 1.5, 2.0, np.pi))
    close(jnerf.place_o(a, b, c), pnerf.place_o(t(a), t(b), t(c)))


@pytest.mark.parametrize("atoms", [1, 3, 4], ids=["ca", "n_ca_c", "n_ca_c_o"])
def test_sidechain_container_matches_jax(atoms):
    """Forward with chi torsions and the cloud mask; for the CA-only
    input (the atom refiner's, differentiated in training) also the
    gradient of a fixed projection of the scaffold."""
    rng = np.random.default_rng(3 + atoms)
    seq = tokens(rng)
    bb = backbones(rng, atoms)
    chi = rng.normal(size=(B, L, 14)).astype(np.float32)
    cloud = np.asarray(jscn.scn_cloud_mask(seq))
    w = rng.normal(size=(B, L, 14, 3)).astype(np.float32)
    close(jnerf.sidechain_container(bb, seq, chi, cloud),
          pnerf.sidechain_container(t(bb), t(seq), t(chi), t(cloud)),
          atol=COORDS_ATOL)
    close(jnerf.sidechain_container(bb, seq),
          pcore.sidechain_container(t(bb), t(seq)), atol=COORDS_ATOL)
    if atoms != 1:
        return
    ref = jax.grad(lambda x: (jnerf.sidechain_container(x, seq) * w).sum())(
        jnp.asarray(bb))
    leaf = t(bb).requires_grad_()
    (grad,) = torch.autograd.grad(
        (pnerf.sidechain_container(leaf, t(seq)) * t(w)).sum(), leaf)
    close(ref, grad, atol=COORDS_ATOL)


def test_ca_only_two_residues_are_collinear_as_in_jax():
    """A JAX fault kept for parity (ROADMAP queue 3): a CA-only trace of
    two residues gives both residues the one chain step, so their
    virtual N, CA and C are collinear and the NeRF frame of their first
    sidechain atom is degenerate. Both packages build the same backbone
    slots, collinear, and finite sidechain slots."""
    rng = np.random.default_rng(4)
    seq = np.array([[0, 3]])
    ca = rng.normal(size=(1, 2, 1, 3)).astype(np.float32) * 3
    ref = np.asarray(jnerf.sidechain_container(ca, seq))
    out = pnerf.sidechain_container(t(ca), t(seq)).numpy()
    close(ref[:, :, :3], t(out[:, :, :3]), atol=SMALL_ATOL)
    for coords in (ref, out):
        n_at, ca_at, c_at = coords[0, :, 0], coords[0, :, 1], coords[0, :, 2]
        normal = np.cross(n_at - ca_at, c_at - ca_at)
        assert np.abs(normal).max() < 1e-4, normal
        assert np.isfinite(coords).all()


def distances(coords):
    return pgeo.cdist(coords, coords)


def mds_inputs(rng, n=12):
    x = np.cumsum(rng.normal(size=(B, n, 3)) * 2, axis=1)
    d = np.sqrt(((x[:, :, None] - x[:, None]) ** 2).sum(-1))
    noise = rng.normal(size=d.shape) * 0.1
    d = d + (noise + noise.transpose(0, 2, 1)) / 2
    d[:, np.arange(n), np.arange(n)] = 0.0
    w = rng.uniform(0.5, 1.0, d.shape)
    return d.astype(np.float32), ((w + w.transpose(0, 2, 1)) / 2).astype(
        np.float32)


def test_mds_matches_jax():
    """An SVD fixes each singular vector up to its sign, so coordinates
    are compared through their distances; the stress history and the
    mirror fix (on given coordinates) directly."""
    rng = np.random.default_rng(5)
    d, w = mds_inputs(rng)
    close(distances(t(np.asarray(jmds.eigen_init(d)))),
          distances(pmds.eigen_init(t(d))), atol=COORDS_ATOL)
    for weights in (None, w):
        ref = j_mds(d, weights=weights, iters=6)
        out = pmds.mds(t(d), weights=None if weights is None else t(w),
                       iters=6)
        close(distances(t(np.asarray(ref.coords))), distances(out.coords),
              atol=COORDS_ATOL)
        close(ref.stress_history, out.stress_history, atol=COORDS_ATOL)
    # a tolerance that freezes every element after its first iteration
    close(j_mds(d, iters=4, tol=1e6).stress_history,
          pmds.mds(t(d), iters=4, tol=1e6).stress_history,
          atol=COORDS_ATOL)
    assert pmds.mds(t(d), eigen_only=True).stress_history.shape == (0, B)

    # the mirror fix on a backbone cloud and on its mirror image
    cloud = backbones(rng, 14).reshape(B, L * 14, 3)
    idx = pscn.backbone_indices(L)
    for c in (cloud, cloud * np.array([1, 1, -1], np.float32)):
        close(jmds.mirror_fix(c, *(i.numpy() for i in idx)),
              pmds.mirror_fix(t(c), *idx))


def test_mdscaling_fixes_the_mirror_as_jax():
    rng = np.random.default_rng(6)
    cloud = backbones(rng, 3, l=6).reshape(B, 18, 3)
    d = np.sqrt(((cloud[:, :, None] - cloud[:, None]) ** 2).sum(-1))
    idx = [torch.arange(6) * 3 + k for k in range(3)]
    ref = jmds.mdscaling(d, iters=5, n_idx=idx[0].numpy(),
                         ca_idx=idx[1].numpy(), c_idx=idx[2].numpy())
    out = pmds.mdscaling(t(d), iters=5, n_idx=idx[0], ca_idx=idx[1],
                         c_idx=idx[2])
    close(distances(t(np.asarray(ref.coords))), distances(out.coords),
          atol=COORDS_ATOL)
    for coords in (t(np.asarray(ref.coords)), out.coords):
        frac = pgeo.fraction_negative_phis(*(coords[:, i] for i in idx))
        assert (frac >= 0.5).all()
    close(ref.stress_history, out.stress_history, atol=COORDS_ATOL)
    with pytest.raises(ValueError, match="N/CA/C"):
        pmds.mdscaling(t(d), iters=1)
    assert isinstance(pcore.mdscaling(t(d), iters=1, fix_mirror=False),
                      pcore.MDSResult)


def test_relax_matches_jax():
    rng = np.random.default_rng(7)
    seq = tokens(rng, b=1, l=4)
    cloud = np.asarray(jscn.scn_cloud_mask(seq))
    coords = np.asarray(jnerf.sidechain_container(backbones(rng, 3, b=1, l=4), seq,
                                    cloud_mask=cloud))
    coords = (coords + rng.normal(size=coords.shape) * 0.2 *
              cloud[..., None]).astype(np.float32)
    flat = coords.reshape(1, -1, 3)
    bonds = np.asarray(jgraph.prot_covalent_bond(seq))
    mask = cloud.reshape(1, -1)
    close(jrelax.restraint_energy(flat, bonds, mask),
          prelax.restraint_energy(t(flat), t(bonds), t(mask)),
          atol=COORDS_ATOL)
    for cm in (None, cloud):
        ref = j_relax(coords, seq, cloud_mask=cm, steps=4)
        out = prelax.gradient_relax(t(coords), t(seq),
                                    None if cm is None else t(cm), steps=4)
        close(ref.coords, out.coords, atol=COORDS_ATOL)
        close(ref.energy_history, out.energy_history, atol=COORDS_ATOL)
    assert out.energy_history[-1] < prelax.restraint_energy(
        t(flat), t(bonds), t(mask))


def test_pyrosetta_paths_raise_without_it():
    try:
        import pyrosetta  # noqa: F401
        pytest.skip("pyrosetta is installed")
    except ImportError:
        pass
    for fn, args in ((prelax.pdb2rosetta, ("x.pdb",)),
                     (prelax.rosetta2pdb, (None, "x.pdb")),
                     (prelax.run_fast_relax, ("a.pdb", "b.pdb"))):
        with pytest.raises(RuntimeError, match="pyrosetta"):
            fn(*args)
        with pytest.raises(RuntimeError, match="pyrosetta"):
            getattr(jrelax, fn.__name__)(*args)


def test_rotary_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 6, 8)).astype(np.float32)
    close(jrot.rotate_every_two(x), prot.rotate_every_two(t(x)))
    for dim in (8, 4):
        sin, cos = jrot.fixed_positional_embedding(6, dim)
        psin, pcos = prot.fixed_positional_embedding(6, dim)
        close(sin, psin)
        close(cos, pcos)
        close(jrot.apply_rotary_pos_emb(x, (sin, cos)),
              prot.apply_rotary_pos_emb(t(x), (psin, pcos)))
    for a, b in zip(jrot.axial_rotary_embedding(3, 5, 8),
                    prot.axial_rotary_embedding(3, 5, 8)):
        close(a, b)
    with pytest.raises(ValueError, match="dim % 4"):
        prot.axial_rotary_embedding(3, 5, 6)
