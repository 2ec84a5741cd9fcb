"""Port parity: the two pair-terms ops, ``ops.nonbonded.make_nonbonded_op``
(dense, B5) and ``ops.ring.make_pair_ring_op`` (each pair once, B6).

On the CPU each op's forward is the plain version of its kernel
(``dense_pair_math``); the kernels themselves are held against it on the
card by ``chip_smoke.py``. Here the ops are held against the JAX ops:

- in float64 against the JAX ops' XLA references, at 104 and 208 atoms, at
  9 A with the reaction field and at 16 A without it, to 1e-4 kcal/mol/A
  and kcal/mol (the port's tables are float32, the reference reads the
  float64 parameters: that bounds the agreement, not round-off);
- against the JAX kernels in interpret mode in float32, at the JAX tests'
  own tolerances (tests/test_sim.py): the dense one at 104 atoms, the ring
  one on its chunked path at 208 atoms (at 104 atoms it is held against the
  port in tests/test_torch_ops.py);
- with bonds or 1-4 terms switched off;
- their backward against the JAX ops' backward in float64, for the energy's
  and the forces' cotangent, to 1e-8 (both run through their package's
  reference energy).
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from molecular_dynamics_tpu.examples import tiled_decaalanine as jtiled
from molecular_dynamics_tpu.ops import make_nonbonded_op as jmake_nonbonded_op
from molecular_dynamics_tpu.ops.ring import make_pair_ring_op as jmake_pair_ring_op
from molecular_dynamics_tpu_torch.examples import tiled_decaalanine
from molecular_dynamics_tpu_torch.ops import nonbonded as tnonbonded
from molecular_dynamics_tpu_torch.ops import ring as tring
from molecular_dynamics_tpu_torch.ops.nonbonded import make_nonbonded_op
from molecular_dynamics_tpu_torch.ops.ring import make_pair_ring_op

from torch_parity import jax_system, t, torch_system

R = 2
CASES = {
    "9A_rf": dict(cutoff=9.0, switch_dist=7.5, rfa=True),
    "16A_norf": dict(cutoff=16.0, switch_dist=15.0, rfa=False, solvent_dielectric=80.0),
}
VARIANTS = {"dense": make_nonbonded_op, "ring": make_pair_ring_op}


@functools.lru_cache(maxsize=None)
def systems(m: int):
    """(JAX ff, port ff, positions (R, 104 m, 3)) in float64: the packaged
    system (m = 1) or m tiled copies, positions jittered from a seed."""
    if m == 1:
        jff, coords = jax_system("full_da")
        tff, _ = torch_system("full_da")
    else:
        jff, coords, _ = jtiled(m, dtype=jnp.float64)
        tff, _, _ = tiled_decaalanine(m, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(40 + m)
    pos = np.asarray(coords)[None] + rng.normal(0.0, 0.02, (R,) + np.shape(coords))
    return jff, tff, pos


@functools.lru_cache(maxsize=None)
def jax_reference(m: int, case: str, **flags):
    """The JAX op's reference energy and forces at ``systems(m)``'s positions."""
    jff, _, pos = systems(m)
    op = jmake_nonbonded_op(jff, **CASES[case], **flags)
    p = jnp.asarray(pos)
    return np.asarray(jax.jit(op.reference_energy)(p)), np.asarray(jax.jit(op.reference_forces)(p))


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("m", [1, 2], ids=["104_atoms", "208_atoms"])
def test_op_matches_jax_reference_f64(m, case, variant):
    _, tff, pos = systems(m)
    je, jf = jax_reference(m, case)
    op = VARIANTS[variant](tff, **CASES[case])
    te, tf = op(t(pos))
    assert te.shape == (R,) and tf.shape == (R, 104 * m, 3) and tf.dtype == torch.float64
    np.testing.assert_allclose(tf.numpy(), jf, atol=1e-4)
    np.testing.assert_allclose(te.numpy(), je, atol=1e-4)
    # the op's own references are the port's float64 energy of the same terms
    np.testing.assert_allclose(op.reference_energy(t(pos)).numpy(), je, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(op.reference_forces(t(pos)).numpy(), jf, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize(
    "flags", [dict(include_bonds=False), dict(include_14=False),
              dict(include_bonds=False, include_14=False, include_ub=False)],
    ids=["no_bonds", "no_14", "nonbonded_only"],
)
def test_op_term_switches_match_jax(flags):
    """The forward against the JAX dense kernel (interpret mode, float32,
    tests/test_sim.py's bounds), the reference against the JAX reference
    (float64). The switches zero the same tables as the JAX op, the spring
    tables with the bonds (the Urey-Bradley springs share them)."""
    jff32, _ = jax_system("full_da", f64=False)
    tff32, _ = torch_system("full_da", f64=False)
    _, tff, pos = systems(1)
    pos32 = pos.astype(np.float32)
    je, jf = jax.jit(jmake_nonbonded_op(jff32, interpret=True, **flags))(jnp.asarray(pos32))
    je_ref, _ = jax_reference(1, "9A_rf", **flags)
    full_e = make_nonbonded_op(tff32)(t(pos32))[0]
    for make in VARIANTS.values():
        te, tf = make(tff32, **flags)(t(pos32))
        np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=2e-3)
        np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-3)
        op = make(tff, **flags)
        np.testing.assert_allclose(op.reference_energy(t(pos)).numpy(), je_ref, rtol=1e-12, atol=1e-9)
    assert float((full_e - te).abs().min()) > 1.0  # the switch takes terms away
    dense = op.tables.dense
    assert dense[4:6].any() == flags.get("include_bonds", True)
    assert dense[6:9].any() == flags.get("include_14", True)


def test_dense_op_matches_jax_interpret_kernel_f32():
    """The JAX dense kernel (interpret mode, float32), 104 atoms, 2
    replicas, and the gradient through it (tests/test_sim.py's bounds)."""
    jff, _ = jax_system("full_da", f64=False)
    tff, _ = torch_system("full_da", f64=False)
    pos = systems(1)[2].astype(np.float32)
    jop = jmake_nonbonded_op(jff, interpret=True)
    je, jf = jax.jit(jop)(jnp.asarray(pos))
    op = make_nonbonded_op(tff)
    te, tf = op(t(pos))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=2e-3)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-3)
    jg = jax.jit(jax.grad(lambda p: jnp.sum(jop(p)[0])))(jnp.asarray(pos))
    p = t(pos).requires_grad_(True)
    (tg,) = torch.autograd.grad(op(p)[0].sum(), p)
    # the gradient of the energy is minus the forces: the forces' bound
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-3)


def _cotangents(cotangent):
    rng = np.random.default_rng(7)
    pos = systems(1)[2]
    g_e = rng.normal(size=R) if cotangent == "energy" else np.zeros(R)
    g_f = rng.normal(size=pos.shape) if cotangent == "forces" else np.zeros(pos.shape)
    return g_e, g_f


@functools.lru_cache(maxsize=None)
def _jax_backward(cotangent):
    """The JAX ops' backward rule (their custom_vjp: the vjp of the reference
    energy plus that of the reference forces) in float64 at 104 atoms, 9 A.
    Their forward returns a float32 energy, so a float64 energy cotangent
    cannot pass through ``jax.grad`` of the op itself; the rule is applied
    directly."""
    jff, _, pos = systems(1)
    op = jmake_nonbonded_op(jff, **CASES["9A_rf"])
    g_e, g_f = (jnp.asarray(g) for g in _cotangents(cotangent))

    def grad(p):
        _, vjp_e = jax.vjp(op.reference_energy, p)
        _, vjp_f = jax.vjp(op.reference_forces, p)
        return vjp_e(g_e)[0] + vjp_f(g_f)[0]

    return np.asarray(jax.jit(grad)(jnp.asarray(pos)))


@pytest.mark.parametrize("cotangent", ["energy", "forces"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_op_backward_matches_jax(variant, cotangent):
    _, tff, pos = systems(1)
    g_e, g_f = _cotangents(cotangent)
    jg = _jax_backward(cotangent)
    op = VARIANTS[variant](tff)
    p = t(pos).requires_grad_(True)
    e, f = op(p)
    (tg,) = torch.autograd.grad((e * t(g_e)).sum() + (f * t(g_f)).sum(), p)
    assert float(np.abs(jg).max()) > 1.0
    np.testing.assert_allclose(tg.numpy(), jg, atol=1e-8, rtol=1e-10)


def test_ring_op_matches_jax_interpret_kernel_at_208_atoms():
    """The JAX ring kernel on its chunked path (interpret mode, float32,
    16-shift chunks), 208 atoms, 2 replicas, at tests/test_sim.py's bounds
    for that path."""
    jff, _, _ = jtiled(2)
    tff, _, _ = tiled_decaalanine(2, device="cpu")
    pos = systems(2)[2].astype(np.float32)
    jop = jmake_pair_ring_op(jff, interpret=True, block_r=8, shift_chunk=16)
    je, jf = jax.jit(jop)(jnp.asarray(pos))
    te, tf = make_pair_ring_op(tff)(t(pos))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=0.02)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=0.01)


def test_cpu_tensors_take_the_plain_version():
    """The CUDA wrappers take their plain version on a CPU tensor and launch
    nothing; the pair-tile scratch holds a tile's worth of partials."""
    _, tff, pos = systems(2)
    tables = tnonbonded.build_pair_tables(tff)
    consts = tnonbonded.pair_constants(9.0, 7.5, True, 78.5)
    before = (tnonbonded.nonbonded_rows.launches, tring.pair_tiles.launches)
    want = tnonbonded.dense_pair_math(t(pos), tables.dense, consts)
    for fn in (tnonbonded.nonbonded_rows, tring.pair_tiles):
        got = fn(t(pos), tables, consts)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (tnonbonded.nonbonded_rows.launches, tring.pair_tiles.launches) == before == (0, 0)
    assert [tring.tile_pair_count(n) for n in (104, 128, 129, 416, 1040)] == [1, 1, 3, 10, 45]
    with pytest.raises(ValueError, match="CUDA"):
        tnonbonded.check_pair_kernel_inputs(t(pos).float(), tables)
