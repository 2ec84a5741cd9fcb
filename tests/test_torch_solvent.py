"""Port parity: ``solvent`` (GB-OBC II + LCPO SASA) against the JAX package.

Same force-field arrays (carried across as numpy through ``convert``), same
jittered coordinates, float64 on both sides, on the packaged 104-atom
deca-alanine and 22-atom di-alanine. Each function is held against the JAX
function of the same name and, where there is one, against the scalar-loop
oracle of ``tests/oracle.py``. Tolerance: 1e-8 relative (both sides are
float64; the sums run in another order), forces 1e-8 of the largest force.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oracle
from molecular_dynamics_tpu import energy as jenergy
from molecular_dynamics_tpu import solvent as jsolvent
from molecular_dynamics_tpu_torch import energy as tenergy
from molecular_dynamics_tpu_torch import examples as texamples
from molecular_dynamics_tpu_torch import solvent as tsolvent

from torch_parity import SYSTEMS, jax_system, t, torch_system

RTOL = 1e-8
#: (solvent dielectric, salt molarity): no salt, and the campaign's 0.1 M
GB_CASES = {"kappa0": (80.0, 0.0), "salt0.1M": (80.0, 0.1)}


def _jittered(coords, seed=17):
    return coords + np.random.default_rng(seed).normal(0.0, 0.05, coords.shape)


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for name in SYSTEMS:
        jff, coords = jax_system(name)
        tff, _ = torch_system(name)
        out[name] = dict(jff=jff, tff=tff, pos=_jittered(coords))
    return out


def _close(ours, ref, rtol=RTOL):
    ours, ref = np.asarray(ours), np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.mark.parametrize("system", SYSTEMS)
def test_born_radii_match_jax_and_oracle(worlds, system):
    w = worlds[system]
    ours = tsolvent.born_radii(t(w["pos"]), w["tff"]).numpy()
    ref = jax.jit(jsolvent.born_radii)(jnp.asarray(w["pos"]), w["jff"])
    _close(ours, ref)
    _close(ours, oracle.oracle_born_radii(w["pos"], w["jff"]))
    assert ours.min() > 1.0 and ours.max() < 10.0  # Angstrom, sane radii


@pytest.mark.parametrize("case", list(GB_CASES))
@pytest.mark.parametrize("system", SYSTEMS)
def test_gb_energy_and_forces_match_jax(worlds, system, case):
    w = worlds[system]
    eps, salt = GB_CASES[case]
    jfun = lambda p, ff: jsolvent.gb_energy(p, ff, eps, salt)
    je, jg = jax.jit(jax.value_and_grad(jfun))(jnp.asarray(w["pos"]), w["jff"])
    tfun = lambda p: tsolvent.gb_energy(p, w["tff"], eps, salt)
    te = tfun(t(w["pos"]))
    assert abs(float(te) - float(je)) <= RTOL * abs(float(je))
    _close(tenergy._neg_grad(tfun, t(w["pos"])).numpy(), -np.asarray(jg))
    if system == "diala":  # the scalar loops are slow: the small system only
        want = oracle.oracle_gb_energy(w["pos"], w["jff"], eps, salt)
        assert abs(float(te) - want) <= RTOL * abs(want)


@pytest.mark.parametrize("system", SYSTEMS)
def test_sasa_matches_jax_and_oracle(worlds, system):
    w = worlds[system]
    ours = tsolvent.sasa(t(w["pos"]), w["tff"]).numpy()
    _close(ours, jax.jit(jsolvent.sasa)(jnp.asarray(w["pos"]), w["jff"]))
    _close(ours, oracle.oracle_sasa(w["pos"], w["jff"]))
    heavy = np.asarray(w["jff"].sasa_radii) > 0
    assert not ours[~heavy].any() and ours[heavy].sum() > 100.0


@pytest.mark.parametrize("system", SYSTEMS)
def test_sasa_energy_and_forces_match_jax(worlds, system):
    w = worlds[system]
    jfun = lambda p, ff: jsolvent.sasa_energy(p, ff, 0.005)
    je, jg = jax.jit(jax.value_and_grad(jfun))(jnp.asarray(w["pos"]), w["jff"])
    tfun = lambda p: tsolvent.sasa_energy(p, w["tff"], 0.005)
    assert abs(float(tfun(t(w["pos"]))) - float(je)) <= RTOL * abs(float(je))
    _close(tenergy._neg_grad(tfun, t(w["pos"])).numpy(), -np.asarray(jg))


@pytest.fixture(scope="module")
def gbis_terms(worlds):
    out = {}
    for system, w in worlds.items():
        for cname in ("GBIS_CONFIG", "GBIS_POLAR_CONFIG"):
            jt, jf = jax.jit(
                lambda p, ff, cfg=getattr(jenergy, cname): jenergy.energy_and_forces(
                    p, ff, config=cfg)
            )(jnp.asarray(w["pos"]), w["jff"])
            tt, tf = tenergy.energy_and_forces(
                t(w["pos"]), w["tff"], config=getattr(tenergy, cname)
            )
            out[(system, cname)] = (
                {k: float(v) for k, v in jt.items()}, np.asarray(jf),
                {k: float(v) for k, v in tt.items()}, tf.numpy(),
            )
    return out


GBIS_TERMS = tenergy.DEFAULT_TERMS + ("gb", "sasa", "urey_bradley")


@pytest.mark.parametrize("term", GBIS_TERMS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_gbis_config_term_matches_jax(gbis_terms, system, term):
    jt, _, tt, _ = gbis_terms[(system, "GBIS_CONFIG")]
    assert set(jt) == set(tt)
    if term not in jt:
        assert term == "urey_bradley"  # a force field without UB springs
        return
    assert abs(jt[term] - tt[term]) <= RTOL * max(1.0, abs(jt[term])), (jt[term], tt[term])


@pytest.mark.parametrize("cname", ["GBIS_CONFIG", "GBIS_POLAR_CONFIG"])
@pytest.mark.parametrize("system", SYSTEMS)
def test_gbis_total_energy_and_force_match_jax(gbis_terms, system, cname):
    jt, jf, tt, tf = gbis_terms[(system, cname)]
    assert ("sasa" in tt) == (cname == "GBIS_CONFIG") and tt["gb"] < -5.0
    je, te = sum(jt.values()), sum(tt.values())
    assert abs(je - te) <= RTOL * abs(je)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=RTOL * np.abs(jf).max())


def test_batched_solvent_energy_equals_per_replica(worlds):
    tff = worlds["diala"]["tff"]
    coords = worlds["diala"]["pos"]
    batch = torch.stack([t(_jittered(coords, seed=s)) for s in range(3)]).reshape(3, 1, 22, 3)
    born = tsolvent.born_radii(batch, tff)
    e_gb = tsolvent.gb_energy(batch, tff, 80.0, 0.1)
    areas = tsolvent.sasa(batch, tff)
    e_sa = tsolvent.sasa_energy(batch, tff)
    assert born.shape == areas.shape == (3, 1, 22) and e_gb.shape == e_sa.shape == (3, 1)
    for r in range(3):
        one = batch[r, 0]
        np.testing.assert_allclose(born[r, 0].numpy(), tsolvent.born_radii(one, tff).numpy(), rtol=1e-12)
        assert abs(float(e_gb[r, 0]) - float(tsolvent.gb_energy(one, tff, 80.0, 0.1))) < 1e-10
        assert abs(float(e_sa[r, 0]) - float(tsolvent.sasa_energy(one, tff))) < 1e-12


@pytest.mark.parametrize("system", SYSTEMS)
def test_converted_ff_gives_the_loaders_solvent_energies(worlds, system):
    """A JAX ``FFParams`` carried through ``convert`` and the port's own
    loader give the same GB and SASA energies (the GB/LCPO tables cross)."""
    w = worlds[system]
    loader = {"full_da": texamples.decaalanine_full, "diala": texamples.dialanine}[system]
    own, _, _ = loader(device="cpu", dtype=torch.float64)
    pos = t(w["pos"])
    for name in ("gb_radii", "gb_screen", "sasa_radii", "sasa_params"):
        np.testing.assert_allclose(
            getattr(own, name).numpy(), getattr(w["tff"], name).numpy(), rtol=1e-6, err_msg=name
        )
    for fn in (lambda ff: tsolvent.gb_energy(pos, ff, 80.0, 0.1), lambda ff: tsolvent.sasa_energy(pos, ff)):
        assert abs(float(fn(own)) - float(fn(w["tff"]))) <= 1e-5 * abs(float(fn(own)))


def test_debye_kappa_and_missing_tables(worlds):
    assert tsolvent.debye_kappa(0.0, 80.0) == 0.0
    want = jsolvent.KAPPA_FACTOR * (0.1 / (80.0 * 300.0)) ** 0.5
    assert abs(tsolvent.debye_kappa(0.1, 80.0) - want) < 1e-15
    w = worlds["diala"]
    bare = dataclasses.replace(
        w["tff"], gb_radii=None, gb_screen=None, sasa_radii=None, sasa_params=None
    )
    assert not bare.has_gb
    for terms in (("gb",), ("sasa",)):
        with pytest.raises(ValueError, match="GB tables"):
            tenergy.energy_terms(t(w["pos"]), bare, config=tenergy.EnergyConfig(terms=terms))
