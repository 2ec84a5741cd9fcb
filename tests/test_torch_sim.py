"""Port parity: ``sim`` — the slice as a whole.

``simulate_ensemble`` with ``fused_campaign=True`` (T = 0, 4 replicas, 2
saves of 5 steps) against the JAX ``simulate_ensemble``, whose campaign
kernel runs in interpret mode here (the replacement of its factory lives in
this test; nothing in the JAX package changes). Frames agree to 1e-4 A.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import molecular_dynamics_tpu.ops.fused_step as jfused
from molecular_dynamics_tpu import bias as jbias
from molecular_dynamics_tpu import energy as jenergy
from molecular_dynamics_tpu import integrate as jintegrate
from molecular_dynamics_tpu import sim as jsim
from molecular_dynamics_tpu import system as jsystem
from molecular_dynamics_tpu_torch import bias as tbias
from molecular_dynamics_tpu_torch import energy as tenergy
from molecular_dynamics_tpu_torch import integrate as tintegrate
from molecular_dynamics_tpu_torch import sim as tsim
from molecular_dynamics_tpu_torch import system as tsystem
from molecular_dynamics_tpu_torch.ops import fused_step as tfused

from torch_parity import jax_system, minimized_full_da, t, thermal_velocities, torch_system

R = 4


@pytest.fixture(scope="module")
def world():
    jff, _ = jax_system("full_da", f64=False)
    tff, _ = torch_system("full_da", f64=False)
    pos = minimized_full_da()
    vel = thermal_velocities(np.asarray(jff.masses), 1, seed=12)[0]
    d0 = float(np.linalg.norm(pos[-1] - pos[0]))
    bkw = dict(n_atoms=104, group1=[0], group2=[103], fk=1.0, cent_0=d0, cent_1=d0 + 22.0, T=500_000.0)
    jb = jbias.HarmonicSMDBias.create(**bkw)
    tb = tbias.HarmonicSMDBias.create(device="cpu", **bkw)

    jforce = lambda p, b: -jax.grad(
        lambda q: jenergy.total_energy(q, jff, config=jenergy.REFERENCE_CONFIG) + jb.energy(q, 0)
    )(p)
    jst = jsystem.system_init(jnp.asarray(pos), vel=jnp.asarray(vel), key=jax.random.PRNGKey(1))
    jst = jax.jit(lambda s: jintegrate.initialize_forces(s, jforce))(jst)
    jens = jsystem.replicate(jst, R, seed=3)

    tforce = lambda p, b: tenergy._neg_grad(
        lambda q: tenergy.total_energy(q, tff) + tb.energy(q, 0), p
    )
    tst = tintegrate.initialize_forces(tsystem.system_init(pos, vel=vel, device="cpu", key=1), tforce)
    tens = tsystem.replicate(tst, R, seed=3)
    return dict(jff=jff, tff=tff, jb=jb, tb=tb, jens=jens, tens=tens)


def test_simulate_ensemble_campaign_matches_jax(world, monkeypatch):
    orig = jfused.make_fused_campaign_op
    monkeypatch.setattr(
        jfused, "make_fused_campaign_op",
        lambda *a, **k: orig(*a, **{**k, "interpret": True, "block_r": 8}),
    )
    kw = dict(dt_fs=2.0, temperature=0.0, fused_campaign=True, constrain_h_bonds=True)
    jfinal, jframes, jlog = jsim.simulate_ensemble(
        world["jens"], world["jff"], n_steps=10, save_every=5,
        config=jsim.SimulationConfig(**kw), bias=world["jb"],
    )
    tfinal, tframes, tlog = tsim.simulate_ensemble(
        world["tens"], world["tff"], n_steps=10, save_every=5,
        config=tsim.SimulationConfig(**kw), bias=world["tb"],
    )
    assert tuple(tframes.shape) == jframes.shape == (2, R, 104, 3)
    np.testing.assert_allclose(tframes.numpy(), np.asarray(jframes), atol=1e-4)
    np.testing.assert_allclose(tfinal.vel.numpy(), np.asarray(jfinal.vel), atol=5e-3)
    assert tfinal.step.tolist() == np.asarray(jfinal.step).tolist() == [10] * R
    assert set(tlog) == set(jlog)
    for key in ("epot", "ekin", "T", "colvar_center", "colvar_value", "colvar_energy"):
        assert tuple(tlog[key].shape) == jlog[key].shape == (2, R)
        np.testing.assert_allclose(
            tlog[key].numpy(), np.asarray(jlog[key]), rtol=2e-3, atol=2e-3, err_msg=key
        )


def test_simulate_ensemble_composed_matches_jax(world):
    """The autograd force path, unconstrained, T = 0: 2 saves of 2 steps."""
    kw = dict(dt_fs=1.0, temperature=0.0)
    _, jframes, _ = jsim.simulate_ensemble(
        world["jens"], world["jff"], n_steps=4, save_every=2,
        config=jsim.SimulationConfig(**kw), bias=world["jb"],
    )
    _, tframes, _ = tsim.simulate_ensemble(
        world["tens"], world["tff"], n_steps=4, save_every=2,
        config=tsim.SimulationConfig(**kw), bias=world["tb"],
    )
    np.testing.assert_allclose(tframes.numpy(), np.asarray(jframes), atol=1e-5)


@pytest.mark.parametrize("constrain", [False, True])
def test_fused_nonbonded_path_equals_autograd_path(world, constrain):
    """2-body terms from ops.ring.pair_forces, the rest from autograd: the
    same trajectory as all-autograd (same generator seed on both)."""
    run = lambda **kw: tsim.simulate_ensemble(
        world["tens"], world["tff"], n_steps=4, save_every=2,
        config=tsim.SimulationConfig(dt_fs=2.0, constrain_h_bonds=constrain, **kw),
        bias=world["tb"],
    )
    _, plain, log = run()
    _, fused, _ = run(fused_nonbonded=True)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), atol=1e-5)
    assert float(log["T"].mean()) > 50.0  # the thermostat is on (300 K)


def test_campaign_path_options(world):
    cfg = tsim.SimulationConfig(dt_fs=2.0, temperature=300.0, fused_campaign=True, constrain_h_bonds=True)
    run = lambda **kw: tsim.simulate_ensemble(
        world["tens"], world["tff"], n_steps=8, save_every=2, config=cfg, bias=world["tb"], **kw
    )
    final, frames, log = run()
    final2, frames2, log2, forces = run(obs_every=2, save_forces=True)
    assert torch.equal(frames, frames2) and torch.equal(final.vel, final2.vel)
    assert tuple(log["T"].shape) == (4, R) and tuple(log2["T"].shape) == (2, R)
    assert torch.equal(log["T"][1::2], log2["T"])
    assert torch.equal(forces[-1], final2.forces) and tuple(forces.shape) == (4, R, 104, 3)
    # replicas share a start and decorrelate through the noise
    assert float((frames[-1, 0] - frames[-1, 1]).abs().max()) > 1e-4
    # a second segment continues the stream instead of reusing it
    cont, frames_c, _ = tsim.simulate_ensemble(
        final, world["tff"], n_steps=2, save_every=2, config=cfg, bias=world["tb"]
    )
    assert cont.step.tolist() == [10] * R
    assert not torch.equal(frames_c[0] - final.pos, frames[-1] - frames[-2])
    with pytest.raises(ValueError, match="obs_every"):
        run(obs_every=3)


def test_campaign_path_raises_instead_of_falling_back(world, monkeypatch):
    cfg = tsim.SimulationConfig(fused_campaign=True)
    monkeypatch.setattr(tfused, "SHARED_LIMIT_BYTES", 1024)
    with pytest.raises(ValueError, match="shared memory"):
        tsim.simulate_ensemble(world["tens"], world["tff"], n_steps=2, save_every=2, config=cfg)
    monkeypatch.undo()
    # the implicit-solvent campaign: no GB tables, or a cadence that does not
    # tile the segment, raises; nothing runs the composed path instead
    gb_cfg = tsim.SimulationConfig(fused_campaign=True, energy=tenergy.GBIS_CONFIG)
    bare = dataclasses.replace(
        world["tff"], gb_radii=None, gb_screen=None, sasa_radii=None, sasa_params=None
    )
    with pytest.raises(ValueError, match="gb"):
        tsim.simulate_ensemble(world["tens"], bare, n_steps=2, save_every=2, config=gb_cfg)
    with pytest.raises(ValueError, match="sasa_every"):
        tsim.simulate_ensemble(
            world["tens"], world["tff"], n_steps=2, save_every=2,
            config=dataclasses.replace(gb_cfg, sasa_every=5),
        )


_REDUCED_TERMS = tenergy.EnergyConfig(terms=("bonds", "angles"))


@pytest.mark.parametrize(
    "flag, option, match",
    [
        ("fused_campaign", dict(pbc=True), "pbc"),
        ("fused_campaign", dict(energy=_REDUCED_TERMS), "term set"),
        ("fused_campaign", dict(integrator="nve"), "integrator"),
        ("fused_nonbonded", dict(pbc=True), "pbc"),
        ("fused_nonbonded", dict(energy=_REDUCED_TERMS), "term set"),
    ],
)
def test_kernel_flags_raise_on_options_the_kernels_do_not_cover(world, flag, option, match):
    """A kernel flag never gives way to the autograd path."""
    cfg = tsim.SimulationConfig(**{flag: True}, **option)
    with pytest.raises(ValueError, match=match):
        tsim.simulate_ensemble(world["tens"], world["tff"], n_steps=2, save_every=2, config=cfg)


def test_single_system_step_honours_fused_nonbonded(world):
    single = tsystem.MDState(**{
        f.name: getattr(world["tens"], f.name)[0] for f in dataclasses.fields(world["tens"])
    })
    kw = dict(dt_fs=0.2, integrator="nve")
    plain = tsim.make_step_fn(world["tff"], tsim.SimulationConfig(**kw))(single)
    fused = tsim.make_step_fn(world["tff"], tsim.SimulationConfig(fused_nonbonded=True, **kw))(single)
    np.testing.assert_allclose(fused.pos.numpy(), plain.pos.numpy(), atol=1e-5)
    np.testing.assert_allclose(fused.forces.numpy(), plain.forces.numpy(), atol=2e-3)
    with pytest.raises(ValueError, match="pbc"):
        tsim.make_step_fn(world["tff"], tsim.SimulationConfig(fused_nonbonded=True, pbc=True))


def test_simulate_single_system_and_nve(world):
    single = tsystem.MDState(**{
        f.name: getattr(world["tens"], f.name)[0] for f in dataclasses.fields(world["tens"])
    })
    cfg = tsim.SimulationConfig(dt_fs=0.2, integrator="nve")
    final, frames, log = tsim.simulate(single, world["tff"], n_steps=6, save_every=3, config=cfg)
    assert tuple(frames.shape) == (2, 104, 3) and int(final.step) == 6
    assert abs(float(log["etot"][1] - log["etot"][0])) < 0.05  # NVE holds the energy
    step_fn = tsim.make_step_fn(world["tff"], cfg)
    assert int(step_fn(single).step) == 1


def test_smd_campaign_config_matches_jax():
    for kw in (dict(), dict(implicit_solvent=True), dict(implicit_solvent=True, sasa=False)):
        jcfg, jcol = jsim.smd_campaign_config(**kw)
        tcfg, tcol = tsim.smd_campaign_config(**kw)
        assert jcol == tcol
        jd, td = dataclasses.asdict(jcfg), dataclasses.asdict(tcfg)
        jd.pop("kernel_block_r")  # TPU tuning
        assert jd == td


# -- the composed, differentiable pair-op path ----------------------------------


@pytest.fixture(scope="module")
def tiled_world():
    """Two tiled copies (208 atoms) in float64, 2 replicas jittered from a
    seed, with velocities and the initial forces (the JAX package's) as
    numpy: the same inputs for both packages."""
    from molecular_dynamics_tpu.examples import tiled_decaalanine as jtiled
    from molecular_dynamics_tpu_torch import convert as tconvert
    from molecular_dynamics_tpu_torch.examples import tiled_decaalanine

    jff, coords, _ = jtiled(2, dtype=jnp.float64)
    tff, _, _ = tiled_decaalanine(2, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(17)
    pos = np.asarray(coords)[None] + rng.normal(0.0, 0.02, (2,) + np.shape(coords))
    vel = thermal_velocities(np.asarray(jff.masses), 2, seed=4).astype(np.float64)
    frc = np.array(jax.jit(jax.vmap(jax.grad(
        lambda q: -jenergy.total_energy(q, jff, config=jenergy.REFERENCE_CONFIG))))(jnp.asarray(pos)))
    jens = jsystem.replicate(
        jsystem.system_init(jnp.asarray(pos[0]), key=jax.random.PRNGKey(0), dtype=jnp.float64), 2
    ).replace(pos=jnp.asarray(pos), vel=jnp.asarray(vel), forces=jnp.asarray(frc))
    tens = tconvert.state_from_numpy(pos, vel=vel, forces=frc, device="cpu", dtype=torch.float64)
    return dict(jff=jff, tff=tff, jens=jens, tens=tens)


@pytest.fixture(scope="module")
def jax_composed_tiled(tiled_world):
    """JAX ``simulate_ensemble`` on its XLA composed path: T = 0, 1 fs, 2
    saves of 2 steps, with the forces of each save."""
    cfg = jsim.SimulationConfig(dt_fs=1.0, temperature=0.0)
    _, frames, _, forces = jsim.simulate_ensemble(
        tiled_world["jens"], tiled_world["jff"], n_steps=4, save_every=2, config=cfg,
        obs_every=2, save_forces=True,
    )
    return np.asarray(frames), np.asarray(forces)


@pytest.mark.parametrize("variant", tsim.KERNEL_VARIANTS)
def test_composed_pair_op_path_matches_jax_on_tiled_system(tiled_world, jax_composed_tiled, variant):
    """``fused_nonbonded`` (pair op + angle-torsion op) at 208 atoms against
    the JAX package's XLA composed path, float64. The pair forces come from
    float32 tables on one side and float64 parameters on the other: frames to
    1e-6 A, forces to 1e-4 kcal/mol/A."""
    cfg = tsim.SimulationConfig(dt_fs=1.0, temperature=0.0, fused_nonbonded=True, kernel_variant=variant)
    _, frames, log, forces = tsim.simulate_ensemble(
        tiled_world["tens"], tiled_world["tff"], n_steps=4, save_every=2, config=cfg,
        obs_every=2, save_forces=True,
    )
    jframes, jforces = jax_composed_tiled
    assert tuple(frames.shape) == jframes.shape == (2, 2, 208, 3)
    np.testing.assert_allclose(frames.numpy(), jframes, atol=1e-6)
    np.testing.assert_allclose(forces.numpy(), jforces, atol=1e-4)
    assert tuple(log["T"].shape) == (1, 2)


def _two_step_gradient(world_f64, fused, variant="ring"):
    """d loss / d pos0 through two BAOAB steps at T = 0 (2 fs), loss a fixed
    weighted sum of the final positions and velocities."""
    tff, pos0, vel0, frc0, w_pos, w_vel = world_f64
    cfg = tsim.SimulationConfig(
        dt_fs=2.0, temperature=0.0, fused_nonbonded=fused, kernel_variant=variant)
    step_fn = tsim.make_ensemble_step_fn(tff, cfg)
    pos = pos0.clone().requires_grad_(True)
    st = tsystem.MDState(
        pos=pos, vel=vel0, forces=frc0, box=torch.zeros(2, 3, dtype=torch.float64),
        key=torch.zeros(2, dtype=torch.int64), step=torch.zeros(2, dtype=torch.int64))
    for _ in range(2):
        st = step_fn(st)
    loss = (w_pos * st.pos).sum() + (w_vel * st.vel).sum()
    (g,) = torch.autograd.grad(loss, pos)
    return g


@pytest.fixture(scope="module")
def world_f64():
    tff, _ = torch_system("full_da")
    rng = np.random.default_rng(23)
    pos = t(minimized_full_da()[None] + rng.normal(0.0, 0.02, (2, 104, 3)))
    vel = t(thermal_velocities(tff.masses.numpy(), 2, seed=5)).double()
    frc = tenergy.force_fn()(pos, tff)
    return tff, pos, vel, frc, t(rng.normal(size=(2, 104, 3))), t(rng.normal(size=(2, 104, 3)))


@pytest.mark.parametrize("variant", tsim.KERNEL_VARIANTS)
def test_fused_nonbonded_keeps_the_pair_gradient(world_f64, variant):
    """A rollout differentiated through ``fused_nonbonded`` has the gradient
    of the all-autograd path: the pair op's backward carries the 2-body part
    (LJ, Coulomb, bonds, Urey-Bradley, 1-4) instead of dropping it. Float64,
    2 replicas, two steps; the pair forces' float32 tables bound the match."""
    want = _two_step_gradient(world_f64, fused=False)
    got = _two_step_gradient(world_f64, fused=True, variant=variant)
    scale = float(want.abs().max())
    assert scale > 1.0
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-7 * scale)


def test_kernel_variant_is_checked():
    assert tsim.SimulationConfig().kernel_variant == "ring"
    with pytest.raises(ValueError, match="kernel_variant"):
        tsim.SimulationConfig(kernel_variant="chunked")
