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
        for dropped in ("kernel_variant", "kernel_block_r"):  # TPU tuning
            jd.pop(dropped)
        assert jd == td
