"""Port parity: ``system``, ``bias`` and ``integrate`` against the JAX package.

Deterministic steps (T = 0, velocity-Verlet, FIRE) are compared directly.
At T = 300 K both sides are fed the same numpy normals: the JAX step's
``_normal_like`` is replaced inside the test, the port takes a ``noise``
argument. Positions agree to 1e-5 A in float32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from molecular_dynamics_tpu import bias as jbias
from molecular_dynamics_tpu import energy as jenergy
from molecular_dynamics_tpu import integrate as jintegrate
from molecular_dynamics_tpu import system as jsystem
from molecular_dynamics_tpu_torch import bias as tbias
from molecular_dynamics_tpu_torch import energy as tenergy
from molecular_dynamics_tpu_torch import integrate as tintegrate
from molecular_dynamics_tpu_torch import system as tsystem
from molecular_dynamics_tpu_torch import units

from torch_parity import jax_system, t, thermal_velocities, torch_system

POS_ATOL = 1e-5  # A, float32
VEL_ATOL = 1e-4


# -- bias ---------------------------------------------------------------------

BIAS_KW = dict(n_atoms=22, group1=[0, 1], group2=[20, 21], fk=1.5, cent_0=5.0, cent_1=9.0, T=100.0)


@pytest.mark.parametrize("step", [0, 37, 100, 250])
def test_bias_center_energy_colvar(step):
    _, coords = jax_system("diala")
    jb = jbias.HarmonicSMDBias.create(dtype=jnp.float64, **BIAS_KW)
    tb = tbias.HarmonicSMDBias.create(dtype=torch.float64, device="cpu", **BIAS_KW)
    pos = t(coords)
    assert abs(float(jb.center(step)) - float(tb.center(step))) < 1e-12
    assert abs(float(jb.colvar(jnp.asarray(coords))) - float(tb.colvar(pos))) < 1e-12
    assert abs(float(jb.energy(jnp.asarray(coords), step)) - float(tb.energy(pos, step))) < 1e-10
    if step > BIAS_KW["T"]:
        assert float(tb.center(step)) == BIAS_KW["cent_1"]  # held past T


def test_bias_batched_and_force():
    _, coords = jax_system("diala")
    jb = jbias.HarmonicSMDBias.create(dtype=jnp.float64, **BIAS_KW)
    tb = tbias.HarmonicSMDBias.create(dtype=torch.float64, device="cpu", **BIAS_KW)
    batch = t(np.stack([coords, coords * 1.1]))
    steps = torch.tensor([3, 60])
    e = tb.energy(batch, steps)
    assert e.shape == (2,)
    assert abs(float(e[1]) - float(jb.energy(jnp.asarray(coords * 1.1), 60))) < 1e-10
    jf = -jax.grad(jb.energy)(jnp.asarray(coords), 10)
    tf = tenergy._neg_grad(lambda p: tb.energy(p, 10), t(coords))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-10)
    d = tbias.end_to_end_distance(batch)
    np.testing.assert_allclose(
        d.numpy(), np.asarray(jbias.end_to_end_distance(jnp.asarray(batch.numpy()))), atol=1e-12
    )


# -- state ----------------------------------------------------------------------


def test_system_init_and_replicate():
    pos = np.arange(15.0).reshape(5, 3)
    st = tsystem.system_init(pos, device="cpu", key=9)
    assert st.pos.dtype == torch.float32 and st.n_atoms == 5
    assert int(st.step) == 0 and int(st.key) == 9
    assert float(st.vel.abs().sum()) == 0 and st.box.tolist() == [0, 0, 0]
    ens = tsystem.replicate(st, 6, seed=4)
    assert ens.pos.shape == (6, 5, 3) and ens.step.shape == (6,) and ens.box.shape == (6, 3)
    assert len(set(ens.key.tolist())) == 6  # one thermostat seed a replica
    assert ens.key.tolist() == tsystem.replicate(st, 6, seed=4).key.tolist()
    assert ens.key.tolist() != tsystem.replicate(st, 6, seed=5).key.tolist()
    jst = jsystem.system_init(jnp.asarray(pos))
    np.testing.assert_array_equal(np.asarray(jst.pos), st.pos.numpy())


def test_wrap_positions_matches_jax():
    rng = np.random.default_rng(5)
    pos = rng.normal(0, 15, (12, 3))
    box = np.array([10.0, 0.0, 8.0])
    ref = np.asarray(jsystem.wrap_positions(jnp.asarray(pos), jnp.asarray(box)))
    np.testing.assert_allclose(tsystem.wrap_positions(t(pos), t(box)).numpy(), ref, atol=1e-12)


def test_mix_seed_separates_segments_and_runs():
    seeds = {tintegrate.mix_seed(k, s) for k in range(20) for s in range(0, 1000, 50)}
    assert len(seeds) == 400
    assert all(0 <= s < 2**63 for s in seeds)


# -- kinetic quantities ---------------------------------------------------------


def test_kinetic_energy_and_temperature():
    jff, _ = jax_system("full_da")
    vel = thermal_velocities(np.asarray(jff.masses), 3).astype(np.float64)
    jk = jintegrate.kinetic_energy(jnp.asarray(vel), jff.masses)
    tk = tintegrate.kinetic_energy(t(vel), t(np.asarray(jff.masses)))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-13)
    np.testing.assert_allclose(
        tintegrate.temperature(tk, 104).numpy(),
        np.asarray(jintegrate.temperature(jk, 104)), rtol=1e-13,
    )


def test_maxwell_boltzmann_statistics():
    masses = torch.tensor([1.008, 12.011, 15.999] * 2000, dtype=torch.float64)
    gen = torch.Generator().manual_seed(3)
    vel = tintegrate.maxwell_boltzmann(gen, masses, 300.0)
    assert vel.shape == (6000, 3)
    temp = float(tintegrate.temperature(tintegrate.kinetic_energy(vel, masses), 6000))
    assert abs(temp - 300.0) < 10.0
    gen.manual_seed(3)
    assert torch.equal(vel, tintegrate.maxwell_boltzmann(gen, masses, 300.0))


# -- integrator steps -----------------------------------------------------------


@pytest.fixture(scope="module")
def diala_f32():
    jff, coords = jax_system("diala", f64=False)
    tff, _ = torch_system("diala", f64=False)
    vel = thermal_velocities(np.asarray(jff.masses), 1, seed=2)[0]
    jforce = lambda p, b: jenergy.force_fn()(p, jff, None)
    tforce = lambda p, b: tenergy.force_fn()(p, tff, None)
    jst = jsystem.system_init(jnp.asarray(coords, jnp.float32), vel=jnp.asarray(vel))
    jst = jax.jit(lambda s: jintegrate.initialize_forces(s, jforce))(jst)
    tst = tsystem.system_init(coords, vel=vel, device="cpu")
    tst = tintegrate.initialize_forces(tst, tforce)
    return jff, tff, jst, tst, jforce, tforce


def _close(tst, jst):
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos), atol=POS_ATOL)
    np.testing.assert_allclose(tst.vel.numpy(), np.asarray(jst.vel), atol=VEL_ATOL)
    np.testing.assert_allclose(tst.forces.numpy(), np.asarray(jst.forces), atol=5e-3)
    assert int(tst.step) == int(jst.step)


def test_initialize_forces_matches_jax(diala_f32):
    _, _, jst, tst, _, _ = diala_f32
    np.testing.assert_allclose(tst.forces.numpy(), np.asarray(jst.forces), atol=2e-3)


def test_velocity_verlet_step_matches_jax(diala_f32):
    jff, tff, jst, tst, jforce, tforce = diala_f32
    jstep = jax.jit(lambda s: jintegrate.velocity_verlet_step(s, jforce, jff.masses, 1.0))
    for _ in range(3):
        jst = jstep(jst)
        tst = tintegrate.velocity_verlet_step(tst, tforce, tff.masses, 1.0)
    _close(tst, jst)


@pytest.mark.parametrize("temperature", [0.0, 300.0])
def test_langevin_step_matches_jax(diala_f32, monkeypatch, temperature):
    jff, tff, jst, tst, jforce, tforce = diala_f32
    noise = np.random.default_rng(8).normal(size=(22, 3)).astype(np.float32)
    # the JAX step draws its normals through _normal_like: hand it ours
    monkeypatch.setattr(jintegrate, "_normal_like", lambda key, tmpl: jnp.asarray(noise))
    jstep = jax.jit(
        lambda s: jintegrate.langevin_step(s, jforce, jff.masses, 2.0, temperature, 1.0)
    )
    for _ in range(2):
        jst = jstep(jst)
        tst = tintegrate.langevin_step(
            tst, tforce, tff.masses, 2.0, temperature, 1.0, noise=t(noise)
        )
    _close(tst, jst)


def test_langevin_noise_sources():
    tff, coords = torch_system("diala", f64=False)
    tforce = lambda p, b: tenergy.force_fn()(p, tff, None)
    st = tintegrate.initialize_forces(tsystem.system_init(coords, device="cpu", key=5), tforce)
    step = lambda s, **kw: tintegrate.langevin_step(s, tforce, tff.masses, 2.0, 300.0, **kw)
    # seeded from the state's own (key, step): reproducible, and it moves on
    a, b = step(st), step(st)
    assert torch.equal(a.pos, b.pos)
    assert not torch.equal(step(a).vel - a.vel, a.vel - st.vel)
    other = step(st.replace(key=torch.tensor(6)))
    assert not torch.equal(a.pos, other.pos)
    # an explicit generator is consumed
    gen = torch.Generator().manual_seed(1)
    c, d = step(st, generator=gen), step(st, generator=gen)
    assert not torch.equal(c.pos, d.pos)


def test_minimize_fire_matches_jax():
    jff, coords = jax_system("full_da", f64=False)
    tff, _ = torch_system("full_da", f64=False)
    kw = dict(n_steps=50, dt_start=1e-3, dt_max=1e-2)
    jforce = lambda p: jenergy.force_fn()(p, jff, None)
    jpos = jax.jit(lambda p: jintegrate.minimize_fire(p, jforce, **kw))(
        jnp.asarray(coords, jnp.float32)
    )
    tforce = tenergy.force_fn()
    tpos = tintegrate.minimize_fire(
        torch.as_tensor(coords, dtype=torch.float32), lambda p: tforce(p, tff), **kw
    )
    assert float(np.abs(np.asarray(jpos) - coords).max()) > 1e-2  # it moved
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), atol=1e-4)


def test_minimize_fire_max_disp_clamps():
    tff, coords = torch_system("diala", f64=False)
    tforce = tenergy.force_fn()
    start = torch.as_tensor(coords, dtype=torch.float32)
    start[0] = start[1] + 0.2  # a clash: forces in the 1e5 range
    out = tintegrate.minimize_fire(
        start, lambda p: tforce(p, tff), n_steps=5, dt_start=0.02, max_disp=0.05
    )
    assert float((out - start).abs().max()) <= 5 * 0.05 + 1e-6
    assert bool(torch.isfinite(out).all())


def test_units_time_conversion():
    assert abs(2.0 / units.TIMEFACTOR - 0.0409) < 1e-4


# -- minimize_lbfgs and minimize_gd ----------------------------------------------


@pytest.fixture(scope="module")
def backbone_pair():
    """The 40-atom backbone in float64: JAX FFParams, port FFParams, start
    coordinates (each package builds its own from the same source)."""
    from molecular_dynamics_tpu import examples as jexamples
    from molecular_dynamics_tpu.ff import YamlForceField, build_ff_params
    from molecular_dynamics_tpu_torch import examples as texamples
    from molecular_dynamics_tpu_torch import ff as tff

    top, coords = jexamples.decaalanine_backbone()
    jff = build_ff_params(top, YamlForceField(jexamples.BACKBONE_FF_PRM), dtype=jnp.float64)
    ttop, _ = texamples.decaalanine_backbone()
    tparams = tff.build_ff_params(ttop, tff.YamlForceField(texamples.BACKBONE_FF_PRM),
                                  dtype=torch.float64, device="cpu")
    return jff, tparams, np.asarray(coords)


def test_minimize_lbfgs_quadratic_exact():
    """On a quadratic bowl L-BFGS converges to the minimum (the JAX test's
    bowl)."""
    target = t(np.random.default_rng(0).normal(size=(7, 3)), torch.float64)
    scale = t(np.random.default_rng(1).uniform(0.5, 4.0, size=(7, 3)), torch.float64)
    x = tintegrate.minimize_lbfgs(
        torch.zeros((7, 3), dtype=torch.float64),
        lambda p: torch.sum(scale * (p - target) ** 2), n_steps=60)
    np.testing.assert_allclose(x.numpy(), target.numpy(), atol=1e-6)


def test_minimize_lbfgs_iterates_match_jax(backbone_pair):
    """The first 20 iterates on the backbone equal the JAX ones in float64
    (same directions, same line-search decisions, same buffer)."""
    jff, tparams, coords = backbone_pair
    cfg_j, cfg_t = jenergy.REFERENCE_CONFIG, tenergy.REFERENCE_CONFIG
    run_j = jax.jit(lambda p, n: jintegrate.minimize_lbfgs(
        p, lambda q: jenergy.total_energy(q, jff, config=cfg_j), n_steps=n))
    energy_t = lambda q: tenergy.total_energy(q, tparams, config=cfg_t)
    pos0 = t(coords, torch.float64)
    for n in range(1, 21):
        x_j = np.asarray(run_j(jnp.asarray(coords), n))
        x_t = tintegrate.minimize_lbfgs(pos0, energy_t, n_steps=n).numpy()
        np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-8, err_msg=f"iterate {n}")


def test_minimize_lbfgs_beats_fire_on_the_backbone(backbone_pair):
    """Same step budget: L-BFGS ends below FIRE, which ends below the start."""
    _, tparams, coords = backbone_pair
    cfg = tenergy.REFERENCE_CONFIG
    energy = lambda q: tenergy.total_energy(q, tparams, config=cfg)
    force = tenergy.force_fn(cfg)
    pos0 = t(coords, torch.float64)
    p_fire = tintegrate.minimize_fire(pos0, lambda p: force(p, tparams), n_steps=150,
                                      dt_start=0.001, dt_max=0.01)
    p_lbfgs = tintegrate.minimize_lbfgs(pos0, energy, n_steps=150)
    e_start, e_fire, e_lbfgs = (float(energy(p)) for p in (pos0, p_fire, p_lbfgs))
    assert np.isfinite(e_lbfgs)
    assert e_lbfgs < e_fire < e_start


def test_minimize_gd_matches_jax(backbone_pair):
    jff, tparams, coords = backbone_pair
    cfg_j = jenergy.REFERENCE_CONFIG
    force_j = lambda p: -jax.grad(lambda q: jenergy.total_energy(q, jff, config=cfg_j))(p)
    x_j = jax.jit(lambda p: jintegrate.minimize_gd(p, force_j, n_steps=30))(jnp.asarray(coords))
    force_t = tenergy.force_fn(tenergy.REFERENCE_CONFIG)
    x_t = tintegrate.minimize_gd(t(coords, torch.float64), lambda p: force_t(p, tparams),
                                 n_steps=30)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0, atol=1e-9)
