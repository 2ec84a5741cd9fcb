"""Port parity: CHARMM parameters with CMAP, the ``cmap`` term and the
repulsion variants, against the JAX package in float64.

- ``CharmmPrm`` on a written ``.prm`` with two CMAP maps: every parsed
  table and getter equal to JAX's;
- ``bicubic_coefficients`` equal to JAX's, and exact at the grid nodes;
- ``_cmap_energy`` and its forces within 1e-10 of JAX's on jittered states
  of the 104-atom deca-alanine carrying a map on its eight interior
  residues, and on a planar chain whose phi and psi are exactly +-pi (the
  grid coordinate G, which wraps to cell 0);
- ``ff.builder``'s CMAP rows (PSF ``!NCRTERM`` rows, else derived per
  (segment, res_id) with no link across a chain break or a res_id gap) and
  the tables it attaches, equal to JAX's;
- ``tile_ff_params`` with CMAP, and ``convert`` carrying JAX's CMAP tables;
- ``repulsion`` and ``repulsioncg`` against JAX.
"""

import math
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from molecular_dynamics_tpu import energy as jenergy
from molecular_dynamics_tpu import io as jio
from molecular_dynamics_tpu.ff import build_ff_params as jbuild
from molecular_dynamics_tpu.ff import builder as jbuilder
from molecular_dynamics_tpu.ff import params as jparams
from molecular_dynamics_tpu.topology import Topology as JTopology
from molecular_dynamics_tpu_torch import convert as tconvert
from molecular_dynamics_tpu_torch import energy as tenergy
from molecular_dynamics_tpu_torch import io as tio
from molecular_dynamics_tpu_torch.ff import build_ff_params as tbuild
from molecular_dynamics_tpu_torch.ff import builder as tbuilder
from molecular_dynamics_tpu_torch.ff import params as tparams
from molecular_dynamics_tpu_torch.topology import Topology as TTopology

import torch_files
from torch_parity import ff_to_numpy, jax_system, t, torch_system

ALA = ("C", "NH1", "CT1", "C", "NH1", "CT1", "C", "NH1")
GLY = ("C", "NH1", "CT2", "C", "NH1", "CT2", "C", "NH1")
E_ATOL = 1e-10
F_ATOL = 1e-10
FULL_NPZ = (pathlib.Path(__file__).resolve().parents[1] / "molecular_dynamics_tpu_torch"
            / "examples" / "data" / "full_da.npz")


def _leaves(ff):
    return {k: v.numpy() for k, v in vars(ff).items() if v is not None}


def _assert_same_ff(tff, jff, rtol=1e-14):
    got, want = _leaves(tff), ff_to_numpy(jff)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=0, err_msg=k)


@pytest.fixture(scope="module")
def prm_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("prm") / "bb.prm"
    torch_files.write_charmm_prm(path, {ALA: torch_files.smooth_cmap(24, seed=0),
                                        GLY: torch_files.smooth_cmap(24, seed=1, scale=1.0)})
    return str(path)


def test_charmm_prm_tables_match_jax(prm_path):
    tprm, jprm = tio.CharmmPrm(prm_path), jio.CharmmPrm(prm_path)
    for table in ("bonds", "angles", "ubs", "dihedrals", "impropers", "nonbonded",
                  "nonbonded14", "masses"):
        assert getattr(tprm, table) == getattr(jprm, table), table
    assert set(tprm.cmaps) == set(jprm.cmaps) == {ALA, GLY}
    for key, grid in jprm.cmaps.items():
        assert grid.shape == (24, 24) and np.array_equal(tprm.cmaps[key], grid)
        assert tprm.get_cmap(key) is tprm.cmaps[key]
    assert tprm.get_cmap(ALA[::-1]) is None and jprm.get_cmap(ALA[::-1]) is None
    for query in (("NH1", "CT1", "C", "NH1"), ("C", "NH1", "CT1", "C"), ("H", "NH1", "C", "O")):
        assert tprm.get_dihedral(*query) == jprm.get_dihedral(*query)
        assert tprm.get_14(*query) == jprm.get_14(*query)
    assert tprm.get_angle("CT1", "C", "NH1") == jprm.get_angle("CT1", "C", "NH1")
    assert tprm.get_urey_bradley("C", "CT1", "NH1") == jprm.get_urey_bradley("C", "CT1", "NH1")
    assert tprm.get_improper("O", "CT1", "NH1", "C") == jprm.get_improper("O", "CT1", "NH1", "C")
    assert list(tprm.get_atom_types()) == list(jprm.get_atom_types())
    for at in ("C", "CT1", "H"):
        assert tprm.get_LJ(at) == jprm.get_LJ(at) and tprm.get_LJ14(at) == jprm.get_LJ14(at)
    with pytest.raises(KeyError, match="charges"):
        tprm.get_charge("C")


def test_bicubic_coefficients_match_jax_and_interpolate():
    grid = torch_files.smooth_cmap(24, seed=3) + np.random.default_rng(0).normal(0, 0.1, (24, 24))
    a = tparams.bicubic_coefficients(grid)
    assert a.shape == (24, 24, 4, 4)
    assert np.array_equal(a, jparams.bicubic_coefficients(grid))
    # at the node (t, u) = (0, 0) the cell's polynomial is its corner value;
    # at t = 1 it meets the next cell's corner
    np.testing.assert_allclose(a[:, :, 0, 0], grid, rtol=0, atol=1e-12)
    np.testing.assert_allclose(a.sum(axis=2)[:, :, 0], np.roll(grid, -1, 0), atol=1e-12)


def _full_da_topologies():
    with np.load(FULL_NPZ) as raw:
        kw = dict(atom_types=raw["atom_types"].astype(object),
                  atom_names=raw["atom_names"].astype(object),
                  res_names=raw["res_names"].astype(object), res_ids=raw["res_ids"],
                  charges=raw["ff_charges"].astype(np.float64),
                  masses=raw["ff_masses"].astype(np.float64))
    return TTopology(**kw), JTopology(**kw)


@pytest.fixture(scope="module")
def cmap_systems(prm_path):
    """The 104-atom system with the ALA map on the rows ``ff.builder`` derives
    for it: (JAX FFParams, port FFParams, coordinates), float64."""
    ttop, jtop = _full_da_topologies()
    rows_t = tbuilder._backbone_cross_terms(ttop)
    assert np.array_equal(rows_t, jbuilder._backbone_cross_terms(jtop))
    tprm = tio.CharmmPrm(prm_path)
    rows, grids, gids = tbuilder._cmap_tables(ttop, tprm, np.asarray(ttop.atom_types))
    assert len(rows) == 8 and len(grids) == 1  # the interior residues 2..9
    jff, coords = jax_system("full_da")
    tff, _ = torch_system("full_da")
    jff = jparams.attach_cmap_params(jff, rows, grids, gids)
    tff = tparams.attach_cmap_params(tff, rows, grids, gids)
    return jff, tff, coords


def _states(coords, n=4, seed=21):
    rng = np.random.default_rng(seed)
    return coords[None] + rng.normal(0.0, 0.3, (n,) + coords.shape)


def _jax_terms_and_forces(pos, jff, cfg):
    fn = jax.jit(jax.vmap(lambda p, ff: jenergy.energy_and_forces(p, ff, config=cfg),
                          in_axes=(0, None)))
    terms, forces = fn(jnp.asarray(pos), jff)
    return {k: np.asarray(v) for k, v in terms.items()}, np.asarray(forces)


CMAP_TERM_SETS = (("cmap",), tenergy.DEFAULT_TERMS + ("cmap",))


@pytest.fixture(scope="module")
def jax_cmap_results(cmap_systems):
    """JAX's terms and forces on ``_states`` for each of CMAP_TERM_SETS."""
    jff, _, coords = cmap_systems
    pos = _states(coords)
    return pos, {terms: _jax_terms_and_forces(pos, jff, jenergy.EnergyConfig(terms=terms))
                 for terms in CMAP_TERM_SETS}


def test_cmap_energy_and_forces_match_jax(cmap_systems, jax_cmap_results):
    _, tff, _ = cmap_systems
    pos, results = jax_cmap_results
    for terms in CMAP_TERM_SETS:
        jterms, jforces = results[terms]
        tterms, tforces = tenergy.energy_and_forces(
            t(pos), tff, config=tenergy.EnergyConfig(terms=terms))
        assert set(tterms) == set(jterms)
        for k, v in jterms.items():
            np.testing.assert_allclose(tterms[k].numpy(), v, rtol=0, atol=E_ATOL, err_msg=k)
        np.testing.assert_allclose(tforces.numpy(), jforces, rtol=0, atol=F_ATOL)
    assert np.abs(jterms["cmap"]).max() > 0.5


def test_cmap_at_plus_minus_pi_matches_jax():
    """A planar zigzag chain: each dihedral reads exactly +pi or -pi (the
    sign of a zero sine), so x = (phi + pi) / h lands on 0 or on G, where
    ``floor`` and ``remainder`` wrap to cell 0 with t = 0."""
    n = 6
    xy = np.array([[1.5 * k, 0.8 * (k % 2), 0.0] for k in range(n)])
    zero = dict(bonds=np.zeros((0, 2), np.int64), bond_params=np.zeros((0, 2)),
                angles=np.zeros((0, 3), np.int64), angle_params=np.zeros((0, 2)),
                dihedrals=np.zeros((0, 4), np.int64), dihedral_terms=[],
                impropers=np.zeros((0, 4), np.int64), improper_terms=[],
                idx14=np.zeros((0, 2), np.int64), nb14_params=np.zeros((0, 4)),
                lj_a_pair=np.zeros((n, n)), lj_b_pair=np.zeros((n, n)))
    masses, charges = np.full(n, 12.0), np.zeros(n)
    rows = np.array([[0, 1, 2, 3, 1, 2, 3, 4], [1, 2, 3, 4, 2, 3, 4, 5]])
    grids = [torch_files.smooth_cmap(24, seed=4), torch_files.smooth_cmap(24, seed=5)]
    jff = jparams.attach_cmap_params(
        jparams.finalize_ff_params(masses=masses, charges=charges, dtype=jnp.float64, **zero),
        rows, grids, np.array([0, 1]))
    tff = tparams.attach_cmap_params(
        tparams.finalize_ff_params(masses=masses, charges=charges, dtype=torch.float64,
                                   device="cpu", **zero),
        rows, grids, np.array([0, 1]))
    mirrored = xy * np.array([1.0, -1.0, -1.0])
    pos = np.stack([xy, mirrored, xy + np.array([0.0, 0.0, 1e-9]) * np.arange(n)[:, None]])
    phi = tenergy.dihedral_angles(t(pos), tff.cmap_idx[:, :4]).numpy()
    assert np.all(np.abs(np.abs(phi[:2]) - math.pi) == 0.0)
    cfg = dict(terms=("cmap",))
    jterms, jforces = _jax_terms_and_forces(pos, jff, jenergy.EnergyConfig(**cfg))
    tterms, tforces = tenergy.energy_and_forces(t(pos), tff, config=tenergy.EnergyConfig(**cfg))
    np.testing.assert_allclose(tterms["cmap"].numpy(), jterms["cmap"], rtol=0, atol=E_ATOL)
    np.testing.assert_allclose(tforces.numpy(), jforces, rtol=0, atol=F_ATOL)
    # at phi = psi = +-pi every map reads its corner node (cell 0, t = u = 0)
    np.testing.assert_allclose(tterms["cmap"][:2].numpy(), grids[0][0, 0] + grids[1][0, 0],
                               atol=1e-12)


def test_cmap_term_needs_tables():
    tff, coords = torch_system("diala")
    with pytest.raises(ValueError, match="CMAP"):
        tenergy.energy_terms(t(coords), tff, config=tenergy.EnergyConfig(terms=("cmap",)))


BACKBONE_PSFS = {
    # two segments, res_ids restarting: one interior residue each, chain B of
    # CT2 (the GLY map)
    "two_chains": ([("A", r, "CT1") for r in (1, 2, 3)]
                   + [("B", r, "CT2") for r in (1, 2, 3)], ()),
    # residue 3 missing: nothing pairs across the gap (residue 5 does)
    "res_id_gap": ([("A", r, "CT1") for r in (1, 2, 4, 5, 6)], ()),
    # explicit !NCRTERM rows win over the derivation
    "ncrterm": ([("A", r, "CT1") for r in (1, 2, 3, 4)], ((2, 3, 4, 5, 3, 4, 5, 6),)),
}


@pytest.mark.parametrize("case", sorted(BACKBONE_PSFS))
def test_builder_cmap_rows_match_jax(tmp_path, prm_path, case):
    residues, cross = BACKBONE_PSFS[case]
    psf = tmp_path / f"{case}.psf"
    torch_files.write_backbone_psf(psf, residues, cross)
    ttop, jtop = tio.read_psf(str(psf)), jio.read_psf(str(psf))
    assert np.array_equal(ttop.cross_terms, jtop.cross_terms)
    assert np.array_equal(tbuilder._backbone_cross_terms(ttop),
                          jbuilder._backbone_cross_terms(jtop))
    terms = ("bonds", "lj")
    tff = tbuild(ttop, tio.CharmmPrm(prm_path), terms=terms, dtype=torch.float64, device="cpu")
    jff = jbuild(jtop, jio.CharmmPrm(prm_path), terms=terms, dtype=jnp.float64)
    _assert_same_ff(tff, jff)
    if case == "two_chains":
        rows = tff.cmap_idx.numpy()
        assert rows.shape == (2, 8) and all((r < 9).all() or (r >= 9).all() for r in rows)
        assert tff.cmap_grid_id.tolist() == [0, 1]
    elif case == "res_id_gap":
        # only residue 5 has both neighbours; nothing reaches across 2 | 4
        assert tff.cmap_idx.tolist() == [[8, 9, 10, 11, 9, 10, 11, 12]]
    else:
        assert tff.cmap_idx.tolist() == [list(cross[0])]


def test_tile_ff_params_with_cmap_matches_jax(cmap_systems):
    jff, tff, coords = cmap_systems
    got = tparams.tile_ff_params(tff, 3)
    want = ff_to_numpy(jparams.tile_ff_params(jff, 3))
    got_l = _leaves(got)
    assert set(got_l) == set(want)
    for k in ("cmap_idx", "cmap_grid_id", "cmap_coeffs"):
        assert np.array_equal(got_l[k], want[k]), k
    assert got.cmap_coeffs is tff.cmap_coeffs  # the coefficients are shared
    pos = np.concatenate([coords + [60.0 * k, 0.0, 0.0] for k in range(3)])
    cfg = tenergy.EnergyConfig(terms=("dihedrals", "cmap"))
    one = tenergy.energy_terms(t(coords), tff, config=cfg)["cmap"]
    three = tenergy.energy_terms(t(pos), got, config=cfg)["cmap"]
    np.testing.assert_allclose(float(three), 3 * float(one), rtol=1e-12)


def test_convert_carries_jax_cmap_tables(cmap_systems, jax_cmap_results):
    jff = cmap_systems[0]
    tff = tconvert.ff_params_from_numpy(ff_to_numpy(jff), device="cpu", dtype=torch.float64)
    assert tff.has_cmap and tff.cmap_idx.dtype == torch.int64
    pos, results = jax_cmap_results
    cfg = CMAP_TERM_SETS[1]
    jterms, _ = results[cfg]
    tterms = tenergy.energy_terms(t(pos), tff, config=tenergy.EnergyConfig(terms=cfg))
    for k, v in jterms.items():
        np.testing.assert_allclose(tterms[k].numpy(), v, rtol=0, atol=E_ATOL, err_msg=k)


@pytest.mark.parametrize("system,kw", [
    ("full_da", dict(cutoff=9.0, rfa=True, switch_dist=7.5)), ("diala", dict())],
    ids=["full_da_9A", "diala_no_cutoff"])
def test_repulsion_terms_match_jax(system, kw):
    jff, coords = jax_system(system)
    tff, _ = torch_system(system)
    pos = _states(coords, n=3, seed=9)
    terms = ("bonds", "angles", "repulsion", "repulsioncg")
    jterms, jforces = _jax_terms_and_forces(pos, jff, jenergy.EnergyConfig(terms=terms, **kw))
    tterms, tforces = tenergy.energy_and_forces(
        t(pos), tff, config=tenergy.EnergyConfig(terms=terms, **kw))
    assert set(tterms) == set(jterms)
    for k, v in jterms.items():
        np.testing.assert_allclose(tterms[k].numpy(), v, rtol=1e-12, atol=E_ATOL, err_msg=k)
    np.testing.assert_allclose(tforces.numpy(), jforces, rtol=0, atol=F_ATOL)
    assert (jterms["repulsion"] > 0).all() and (jterms["repulsioncg"] > 0).all()
