"""Port parity: ``energy`` against the JAX package, term by term, in f64.

Same force-field arrays (carried across as numpy through ``convert``), same
coordinates, on the packaged 104-atom deca-alanine and 22-atom di-alanine,
at the vacuum reference config (9 A, reaction field, switch 7.5 A) and at
the 16 A / no reaction field / switch 15 A config that exposed the halfway-
row fault of the ring tables. Tolerances: 1e-8 kcal/mol per term, 1e-7
kcal/mol/A on forces (both sides are float64; the sums run in another order).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from molecular_dynamics_tpu import energy as jenergy
from molecular_dynamics_tpu_torch import energy as tenergy

from torch_parity import SYSTEMS, jax_system, t, torch_system

CONFIG_KW = {
    "reference": dict(cutoff=9.0, rfa=True, switch_dist=7.5),
    "gbis16_vacuum": dict(cutoff=16.0, rfa=False, switch_dist=15.0, solvent_dielectric=80.0),
}
TERMS = ("electrostatics", "lj", "bonds", "angles", "dihedrals", "1-4", "impropers", "urey_bradley")
E_ATOL = 1e-8
F_ATOL = 1e-7


def _perturbed(coords, seed=11):
    rng = np.random.default_rng(seed)
    return coords + rng.normal(0.0, 0.05, coords.shape)


@pytest.fixture(scope="module")
def evaluated():
    """(system, config) -> JAX and port per-term energies and forces."""
    out = {}
    for system in SYSTEMS:
        jff, coords = jax_system(system)
        tff, _ = torch_system(system)
        pos = _perturbed(coords)
        for cname, kw in CONFIG_KW.items():
            jcfg = jenergy.EnergyConfig(**kw)
            jterms, jforces = jax.jit(
                lambda p, ff, cfg=jcfg: jenergy.energy_and_forces(p, ff, config=cfg)
            )(jnp.asarray(pos), jff)
            tterms, tforces = tenergy.energy_and_forces(
                t(pos), tff, config=tenergy.EnergyConfig(**kw)
            )
            out[(system, cname)] = (
                {k: float(v) for k, v in jterms.items()}, np.asarray(jforces),
                {k: float(v) for k, v in tterms.items()}, tforces.numpy(),
            )
    return out


@pytest.mark.parametrize("term", TERMS)
@pytest.mark.parametrize("cname", list(CONFIG_KW))
@pytest.mark.parametrize("system", SYSTEMS)
def test_energy_term_matches_jax(evaluated, system, cname, term):
    jterms, _, tterms, _ = evaluated[(system, cname)]
    assert set(jterms) == set(tterms)
    if term not in jterms:
        assert term == "urey_bradley"  # a force field without UB springs
        return
    assert abs(jterms[term] - tterms[term]) <= E_ATOL, (jterms[term], tterms[term])


@pytest.mark.parametrize("cname", list(CONFIG_KW))
@pytest.mark.parametrize("system", SYSTEMS)
def test_forces_match_jax(evaluated, system, cname):
    _, jforces, _, tforces = evaluated[(system, cname)]
    assert np.abs(jforces).max() > 10.0
    np.testing.assert_allclose(tforces, jforces, atol=F_ATOL, rtol=0)


def test_urey_bradley_is_on_by_default_and_switchable():
    tff, coords = torch_system("full_da")
    pos = t(coords)
    auto = tenergy.energy_terms(pos, tff)
    off = tenergy.energy_terms(
        pos, tff, config=dataclasses.replace(tenergy.REFERENCE_CONFIG, urey_bradley=False)
    )
    assert float(auto["urey_bradley"]) > 1.0 and "urey_bradley" not in off
    assert tenergy.resolve_urey_bradley(tenergy.REFERENCE_CONFIG, tff)
    no_ub = dataclasses.replace(tff, ub_bonds=tff.ub_bonds[:0], ub_params=tff.ub_params[:0])
    assert not tenergy.resolve_urey_bradley(tenergy.REFERENCE_CONFIG, no_ub)
    forced = dataclasses.replace(tenergy.REFERENCE_CONFIG, urey_bradley=True)
    assert not tenergy.resolve_urey_bradley(forced, no_ub)


def test_batched_energy_equals_per_replica():
    tff, coords = torch_system("diala")
    batch = torch.stack([t(_perturbed(coords, seed=s)) for s in range(3)])
    e_batch = tenergy.total_energy(batch, tff)
    f_batch = tenergy.force_fn()(batch, tff)
    assert e_batch.shape == (3,) and f_batch.shape == batch.shape
    for r in range(3):
        assert abs(float(e_batch[r]) - float(tenergy.total_energy(batch[r], tff))) < 1e-9
        np.testing.assert_allclose(
            f_batch[r].numpy(), tenergy.force_fn()(batch[r], tff).numpy(), atol=1e-9
        )


def test_pbc_energy_matches_jax():
    jff, coords = jax_system("diala")
    tff, _ = torch_system("diala")
    box = np.array([14.0, 15.0, 16.0])
    cfg_kw = dict(cutoff=6.0, rfa=True, switch_dist=5.0)
    je = jax.jit(
        lambda p, ff, b: jenergy.total_energy(p, ff, box=b, config=jenergy.EnergyConfig(**cfg_kw))
    )(jnp.asarray(coords), jff, jnp.asarray(box))
    te = tenergy.total_energy(t(coords), tff, box=t(box), config=tenergy.EnergyConfig(**cfg_kw))
    assert abs(float(je) - float(te)) <= E_ATOL
    # a per-replica box broadcasts over a batch
    tb = tenergy.total_energy(
        t(coords)[None].repeat(2, 1, 1), tff, box=t(box)[None].repeat(2, 1),
        config=tenergy.EnergyConfig(**cfg_kw),
    )
    np.testing.assert_allclose(tb.numpy(), float(te), atol=1e-9)


def test_wrap_displacement_matches_jax():
    rng = np.random.default_rng(3)
    delta = rng.normal(0, 20, (50, 3))
    box = np.array([10.0, 0.0, 7.5])
    ref = np.asarray(jenergy.wrap_displacement(jnp.asarray(delta), jnp.asarray(box)))
    np.testing.assert_allclose(
        tenergy.wrap_displacement(t(delta), t(box)).numpy(), ref, atol=1e-12
    )
    assert tenergy.wrap_displacement(t(delta), None) is not None


@pytest.mark.parametrize("term", ["gb", "sasa", "cmap", "repulsion", "repulsioncg"])
def test_deferred_terms_raise_by_name(term):
    """Every term the configs may name evaluates. ``gb`` and ``sasa`` raise
    by name only where the force field carries no GB tables, ``cmap`` (JAX's
    ValueError) only where it carries no CMAP tables; ``repulsion`` and
    ``repulsioncg`` need no table beyond the LJ pairs."""
    from molecular_dynamics_tpu_torch.ff.params import attach_cmap_params

    tff, coords = torch_system("diala")
    terms = ("dihedrals", term)
    if term in ("gb", "sasa"):
        bare = dataclasses.replace(
            tff, gb_radii=None, gb_screen=None, sasa_radii=None, sasa_params=None
        )
        with pytest.raises(ValueError, match="(?i)" + term):
            tenergy.energy_terms(t(coords), bare, config=tenergy.EnergyConfig(terms=terms))
    elif term == "cmap":
        with pytest.raises(ValueError, match="(?i)" + term):
            tenergy.energy_terms(t(coords), tff, config=tenergy.EnergyConfig(terms=terms))
        grid = np.cos(np.linspace(-np.pi, np.pi, 24, endpoint=False))[:, None] * np.ones(24)
        rows = tff.dihedrals[:2].reshape(1, 8).numpy()
        tff = attach_cmap_params(tff, rows, [grid], np.zeros(1, np.int64))
    out = tenergy.energy_terms(t(coords), tff, config=tenergy.EnergyConfig(terms=terms))
    assert np.isfinite(float(out[term])) and float(out[term]) != 0.0


def test_config_validation_matches_jax():
    for kw in (dict(terms=("bogus",)), dict(terms=("1-4", "lj"))):
        with pytest.raises(ValueError):
            jenergy.EnergyConfig(**kw)
        with pytest.raises(ValueError):
            tenergy.EnergyConfig(**kw)
    for name in ("REFERENCE_CONFIG", "GBIS_CONFIG", "GBIS_POLAR_CONFIG"):
        assert dataclasses.asdict(getattr(tenergy, name)) == dataclasses.asdict(
            getattr(jenergy, name)
        )
    assert tenergy.DEFAULT_TERMS == jenergy.DEFAULT_TERMS
