"""Port parity: ``constraints`` (SHAKE/RATTLE) against the JAX package.

Equal sweep counts must give equal Jacobi iterates (up to float32 rounding:
1e-5 A), for the per-system projections of the JAX package and for its
batched matmul projectors alike, since the port has one batched
implementation for both. Default sweep counts of the campaign op (6 SHAKE,
3 RATTLE) must hold violations under 1e-6 A.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from molecular_dynamics_tpu import constraints as jcons
from molecular_dynamics_tpu import energy as jenergy
from molecular_dynamics_tpu import integrate as jintegrate
from molecular_dynamics_tpu import system as jsystem
from molecular_dynamics_tpu_torch import constraints as tcons
from molecular_dynamics_tpu_torch import convert
from molecular_dynamics_tpu_torch import energy as tenergy
from molecular_dynamics_tpu_torch import integrate as tintegrate
from molecular_dynamics_tpu_torch import system as tsystem

from torch_parity import jax_system, minimized_full_da, t, thermal_velocities, torch_system

ATOL = 1e-5  # A (positions) and A per AKMA time (velocities), float32


@pytest.fixture(scope="module")
def setup():
    jff, _ = jax_system("full_da", f64=False)
    tff, _ = torch_system("full_da", f64=False)
    jc = jcons.hydrogen_bond_constraints(jff)
    tc = tcons.hydrogen_bond_constraints(tff)
    pos = minimized_full_da()
    rng = np.random.default_rng(21)
    moved = (pos[None] + rng.normal(0, 0.02, (3,) + pos.shape)).astype(np.float32)
    vel = thermal_velocities(np.asarray(jff.masses), 3, seed=4)
    return jff, tff, jc, tc, pos, moved, vel


def test_hydrogen_bond_constraints_equal_jax(setup):
    _, tff, jc, tc, *_ = setup
    assert tc.n_constraints == jc.n_constraints == 53
    np.testing.assert_array_equal(tc.pairs.numpy(), np.asarray(jc.pairs))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    np.testing.assert_allclose(tc.inv_mass.numpy(), np.asarray(jc.inv_mass), rtol=1e-7)
    allc = tcons.all_bond_constraints(tff)
    assert allc.n_constraints == 103
    carried = convert.constraints_from_numpy(
        np.asarray(jc.pairs), np.asarray(jc.lengths), np.asarray(jc.inv_mass), device="cpu"
    )
    assert torch.equal(carried.pairs, tc.pairs) and torch.equal(carried.lengths, tc.lengths)


@pytest.mark.parametrize("with_ref", [True, False])
@pytest.mark.parametrize("n_iter", [1, 6, 30])
def test_shake_iterates_equal_jax(setup, n_iter, with_ref):
    _, _, jc, tc, pos, moved, _ = setup
    ref = pos if with_ref else None
    jout = jax.jit(
        jax.vmap(
            lambda p: jcons.apply_position_constraints(
                p, jc, n_iter, pos_ref=None if ref is None else jnp.asarray(ref)
            )
        )
    )(jnp.asarray(moved))
    tout = tcons.apply_position_constraints(
        t(moved), tc, n_iter, pos_ref=None if ref is None else t(ref)
    )
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)
    if n_iter == 1:
        assert float(np.abs(np.asarray(jout) - moved).max()) > 1e-3  # it projects


@pytest.mark.parametrize("n_iter", [1, 3, 15])
def test_rattle_iterates_equal_jax(setup, n_iter):
    _, _, jc, tc, _, moved, vel = setup
    jout = jax.jit(
        jax.vmap(lambda v, p: jcons.apply_velocity_constraints(v, p, jc, n_iter))
    )(jnp.asarray(vel), jnp.asarray(moved))
    tout = tcons.apply_velocity_constraints(t(vel), t(moved), tc, n_iter)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=ATOL)


def test_projections_equal_jax_matmul_projectors(setup):
    _, _, jc, tc, pos, moved, vel = setup
    shake, rattle = jcons.make_matmul_projectors(jc, 104)
    ref = np.broadcast_to(pos, moved.shape)
    jp = jax.jit(lambda p, r: shake(p, r, 6))(jnp.asarray(moved), jnp.asarray(ref))
    jv = jax.jit(lambda v, p: rattle(v, p, 3))(jnp.asarray(vel), jnp.asarray(moved))
    tp = tcons.apply_position_constraints(t(moved), tc, 6, pos_ref=t(ref.copy()))
    tv = tcons.apply_velocity_constraints(t(vel), t(moved), tc, 3)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)


def test_default_sweeps_converge(setup):
    """6 SHAKE sweeps along reference directions: violations < 1e-6 A; 3
    RATTLE sweeps (contraction ~0.08 a sweep on X-H stars) take raw thermal
    velocities' along-bond component down by more than a factor 1000."""
    _, _, _, tc, pos, _, vel = setup
    start = tcons.apply_position_constraints(t(pos), tc, 30)  # on the manifold
    drifted = start[None] + 0.5 * (2.0 / 48.88821) * t(vel)
    out = tcons.apply_position_constraints(drifted, tc, 6, pos_ref=start)
    i, j = tc.pairs[:, 0], tc.pairs[:, 1]
    d = torch.linalg.norm(out[:, i] - out[:, j], dim=-1)
    assert float((d - tc.lengths).abs().max()) < 1e-6
    v0 = t(vel)
    v = tcons.apply_velocity_constraints(v0, out, tc, 3)
    dhat = (out[:, i] - out[:, j]) / d[..., None]
    along = lambda w: torch.sum((w[:, i] - w[:, j]) * dhat, dim=-1).abs().max()
    assert float(along(v)) < 1e-3 * float(along(v0))


def test_constrained_temperature_matches_jax():
    ek = np.array([10.0, 20.0])
    np.testing.assert_allclose(
        tcons.constrained_temperature(t(ek), 104, 53).numpy(),
        np.asarray(jcons.constrained_temperature(jnp.asarray(ek), 104, 53)), rtol=1e-14,
    )


@pytest.fixture(scope="module")
def states(setup):
    jff, tff, jc, tc, pos, _, vel = setup
    jforce = lambda p, b: jenergy.force_fn()(p, jff, None)
    tforce = lambda p, b: tenergy.force_fn()(p, tff, None)
    jst = jsystem.system_init(jnp.asarray(pos), vel=jnp.asarray(vel[0]))
    jst = jax.jit(lambda s: jintegrate.initialize_forces(s, jforce))(jst)
    tst = tintegrate.initialize_forces(
        tsystem.system_init(pos, vel=vel[0], device="cpu"), tforce
    )
    return jst, tst, jforce, tforce


@pytest.mark.parametrize("temperature", [0.0, 300.0])
def test_constrained_langevin_step_matches_jax(setup, states, monkeypatch, temperature):
    jff, tff, jc, tc, *_ = setup
    jst, tst, jforce, tforce = states
    noise = np.random.default_rng(9).normal(size=(104, 3)).astype(np.float32)
    monkeypatch.setattr(jintegrate, "_normal_like", lambda key, tmpl: jnp.asarray(noise))
    jstep = jax.jit(
        lambda s: jcons.constrained_langevin_step(
            s, jforce, jff.masses, jc, 2.0, temperature, 1.0, n_iter=30
        )
    )
    for _ in range(2):
        jst = jstep(jst)
        tst = tcons.constrained_langevin_step(
            tst, tforce, tff.masses, tc, 2.0, temperature, 1.0, n_iter=30, noise=t(noise)
        )
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos), atol=ATOL)
    np.testing.assert_allclose(tst.vel.numpy(), np.asarray(jst.vel), atol=1e-4)
    assert int(tst.step) == int(jst.step) == 2


def test_batched_step_equals_single(setup, states):
    _, tff, _, tc, *_ = setup
    _, tst, _, tforce = states
    ens = tsystem.replicate(tst, 3, seed=0)
    step = tcons.make_batched_constrained_langevin_step(tforce, tff.masses, tc, 2.0, 0.0)
    out = step(ens)
    single = tcons.constrained_langevin_step(tst, tforce, tff.masses, tc, 2.0, 0.0)
    for r in range(3):
        np.testing.assert_allclose(out.pos[r].numpy(), single.pos.numpy(), atol=1e-6)


def test_constrained_velocity_verlet_matches_jax(setup, states):
    jff, tff, jc, tc, *_ = setup
    jst, tst, jforce, tforce = states
    jout = jax.jit(
        lambda s: jcons.constrained_velocity_verlet_step(s, jforce, jff.masses, jc, 2.0)
    )(jst)
    tout = tcons.constrained_velocity_verlet_step(tst, tforce, tff.masses, tc, 2.0)
    np.testing.assert_allclose(tout.pos.numpy(), np.asarray(jout.pos), atol=ATOL)
    np.testing.assert_allclose(tout.vel.numpy(), np.asarray(jout.vel), atol=1e-4)
