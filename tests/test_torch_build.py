"""Port parity: the force-field builder against the JAX package.

``build_ff_params`` on the golden backbone PSF + ``param_bb-3.0.yaml`` and
on the generated backbone + ``BACKBONE_FF_PRM`` gives every ``FFParams``
field of the JAX builder (float64: to 1e-12; indices and masks exactly),
for each ``charges_from`` and two term sets. The port's whole
io -> ff -> energy stack on the golden system meets the recorded TorchMD
energies (1e-4 kcal/mol) and forces of ``tests/test_golden.py``.
"""

import dataclasses
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from molecular_dynamics_tpu import build as jbuild
from molecular_dynamics_tpu import examples as jexamples
from molecular_dynamics_tpu import ff as jff
from molecular_dynamics_tpu import io as jio
from molecular_dynamics_tpu_torch import build as tbuild
from molecular_dynamics_tpu_torch import examples as texamples
from molecular_dynamics_tpu_torch import ff as tff
from molecular_dynamics_tpu_torch import io as tio
from molecular_dynamics_tpu_torch.energy import REFERENCE_CONFIG, energy_terms, force_fn

from test_golden import GOLD_ENERGIES, GOLD_FORCES

GOLDENS = pathlib.Path(__file__).parent / "goldens"
PSF = str(GOLDENS / "backbone-no-improp.psf")
PDB = str(GOLDENS / "backbone.pdb")
YAML = str(GOLDENS / "param_bb-3.0.yaml")

TERM_SETS = {
    "default": ("bonds", "angles", "dihedrals", "impropers", "1-4", "lj"),
    "bonds_angles_lj": ("bonds", "angles", "lj"),
}


def _system(pkg_io, pkg_examples, pkg_ff, name):
    """(Topology, force-field source) of one of the two systems."""
    if name == "golden_psf_yaml":
        return pkg_io.read_psf(PSF), pkg_ff.YamlForceField(YAML)
    top, _ = pkg_examples.decaalanine_backbone()
    return top, pkg_ff.YamlForceField(pkg_examples.BACKBONE_FF_PRM)


def assert_ff_equal(tparams, jparams, atol):
    names = [f.name for f in dataclasses.fields(jparams)
             if getattr(jparams, f.name) is not None]
    assert names == [f.name for f in dataclasses.fields(tparams)
                     if getattr(tparams, f.name) is not None]
    for name in names:
        j = np.asarray(getattr(jparams, name))
        t = getattr(tparams, name).numpy()
        assert t.shape == j.shape, name
        if j.dtype.kind in "iub":
            assert np.array_equal(t, j), name
        else:
            assert t.dtype == j.dtype, name
            np.testing.assert_allclose(t, j, rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("terms", sorted(TERM_SETS))
@pytest.mark.parametrize("charges_from", ["auto", "topology", "ff"])
@pytest.mark.parametrize("system", ["golden_psf_yaml", "backbone"])
def test_build_ff_params_matches_jax(system, charges_from, terms):
    jtop, jsrc = _system(jio, jexamples, jff, system)
    ttop, tsrc = _system(tio, texamples, tff, system)
    kw = dict(terms=TERM_SETS[terms], charges_from=charges_from)
    jparams = jff.build_ff_params(jtop, jsrc, dtype=jnp.float64, **kw)
    tparams = tff.build_ff_params(ttop, tsrc, dtype=torch.float64, device="cpu", **kw)
    assert tparams.has_gb and not tparams.has_cmap
    assert_ff_equal(tparams, jparams, atol=1e-12)


def test_build_ff_params_float32_is_bit_equal():
    """In float32 the tables are computed in float32 on both sides (qq
    included), so they agree bit for bit."""
    jtop, jsrc = _system(jio, jexamples, jff, "backbone")
    ttop, tsrc = _system(tio, texamples, tff, "backbone")
    jparams = jff.build_ff_params(jtop, jsrc, dtype=jnp.float32)
    tparams = tff.build_ff_params(ttop, tsrc, device="cpu")
    assert tparams.masses.dtype == torch.float32
    assert_ff_equal(tparams, jparams, atol=0.0)


def test_generated_backbone_matches_jax():
    (jtop, jcoords), (ttop, tcoords) = jexamples.decaalanine_backbone(), texamples.decaalanine_backbone()
    assert np.array_equal(tcoords, jcoords)
    for name in ("atom_types", "atom_names", "res_names", "res_ids", "charges", "masses",
                 "bonds", "angles", "dihedrals", "impropers"):
        assert np.array_equal(getattr(ttop, name), getattr(jtop, name)), name
    assert texamples.BACKBONE_FF_PRM == jexamples.BACKBONE_FF_PRM
    assert texamples.BACKBONE_COLVAR == jexamples.BACKBONE_COLVAR
    # a branched bond graph: every angle and dihedral, in the same order
    bonds = np.array([[0, 1], [1, 2], [2, 3], [1, 4], [4, 5], [2, 6], [6, 7], [6, 8]])
    assert np.array_equal(tbuild.angles_from_bonds(bonds, 9), jbuild.angles_from_bonds(bonds, 9))
    assert np.array_equal(tbuild.dihedrals_from_bonds(bonds, 9),
                          jbuild.dihedrals_from_bonds(bonds, 9))


def test_yaml_lookups_match_jax():
    """Wildcards, reversed keys and improper permutations resolve to the
    same entries, and a missing one raises the same KeyError."""
    prm = dict(jexamples.BACKBONE_FF_PRM)
    prm["dihedrals"] = {**prm["dihedrals"], "(X, C, N, X)": {
        "terms": {"t1": {"phi_k": 1.0, "per": 2, "phase": 180.0},
                  "t2": {"phi_k": 0.5, "per": 3, "phase": 0.0}}}}
    j, t = jff.YamlForceField(prm), tff.YamlForceField(prm)
    for query in (("N", "CA", "C", "N"), ("N", "C", "CA", "N"), ("O", "C", "N", "O"),
                  ("CA", "C", "N", "CA")):
        assert t.get_dihedral(*query) == j.get_dihedral(*query)
        assert t.get_14(*query) == j.get_14(*query)
    assert t.get_improper("N", "O", "C", "CA") == j.get_improper("N", "O", "C", "CA")
    assert t.get_angle("C", "CA", "N") == j.get_angle("C", "CA", "N")
    assert list(t.get_atom_types()) == list(j.get_atom_types())
    with pytest.raises(KeyError, match="No bonds parameters"):
        t.get_bond("N", "O")


def test_cmap_source_raises():
    """A parameter source with CMAP grids raises instead of dropping the
    term silently."""
    top, _ = texamples.decaalanine_backbone()

    class WithCmap(tff.YamlForceField):
        cmaps = {"grid": np.zeros((24, 24))}

        def get_cmap(self, types):
            return self.cmaps["grid"]

    with pytest.raises(NotImplementedError, match="CMAP"):
        tff.build_ff_params(top, WithCmap(texamples.BACKBONE_FF_PRM), device="cpu")
    with pytest.raises(ValueError, match="charges_from"):
        tff.build_ff_params(top, tff.YamlForceField(texamples.BACKBONE_FF_PRM),
                            charges_from="psf", device="cpu")


@pytest.fixture(scope="module")
def golden_port_system():
    top = tio.read_psf(PSF)
    coords = tio.read_pdb(PDB)[0]
    params = tff.build_ff_params(top, tff.YamlForceField(YAML), dtype=torch.float64,
                                 device="cpu")
    return params, torch.as_tensor(coords, dtype=torch.float64)


def test_golden_energies_match_recorded_torchmd(golden_port_system):
    params, pos = golden_port_system
    terms = energy_terms(pos, params, config=REFERENCE_CONFIG)
    for name, gold in GOLD_ENERGIES.items():
        got = float(terms[name])
        assert abs(got - gold) <= 1e-4, f"{name}: {got!r} vs recorded {gold!r}"
    np.testing.assert_allclose(float(params.charges.sum()), -4.32, atol=1e-6)


def test_golden_forces_match_recorded_torchmd(golden_port_system):
    params, pos = golden_port_system
    forces = force_fn(REFERENCE_CONFIG)(pos, params)
    np.testing.assert_allclose(forces.numpy(), GOLD_FORCES, rtol=5e-4, atol=5e-3)


def test_backbone_tables_take_the_pair_layout():
    """The builder's tables of the generated backbone (40 atoms: a chunk of
    32 and a tail of 8; 4 LJ types from the swapped YAML fields; no
    hydrogens) go through the per-atom layout every pair kernel reads, and
    its pair sum is the dense tables' one."""
    from molecular_dynamics_tpu_torch.ops import nonbonded, ring
    from test_torch_pairops import _layout_pair_math

    top, coords = texamples.decaalanine_backbone()
    params = tff.build_ff_params(top, tff.YamlForceField(texamples.BACKBONE_FF_PRM),
                                 device="cpu")
    tabs = nonbonded.build_pair_tables(params)
    assert tabs.n_lj_types == 4 and nonbonded.chunk_count(40) == 2
    assert tabs.n_special == len(params.bonds) + len(params.idx14)
    pos = torch.as_tensor(coords[None] + np.random.default_rng(5).normal(0, 0.05, (3, 40, 3)))
    e_l, f_l = _layout_pair_math(pos, tabs, nonbonded.pair_constants(
        9.0, 7.5, True, REFERENCE_CONFIG.solvent_dielectric))
    e_p, f_p = ring.pair_forces_reference(pos, tabs, cutoff=9.0, switch_dist=7.5, rfa=True)
    np.testing.assert_allclose(f_l.numpy(), f_p.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(e_l.numpy(), e_p.numpy(), rtol=1e-6, atol=1e-4)
