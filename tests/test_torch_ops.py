"""Port parity: the two kernel modules, ``ops.ring`` and ``ops.fused_step``.

On the CPU a wrapper takes its kernel's plain PyTorch version, so these
tests hold the plain versions (and the host-side tables the kernels read)
against the JAX package: the dense pair tables, the ring pair op in interpret
mode, the composed BAOAB step, and the fused campaign kernel in interpret
mode. The CUDA kernels themselves are held against the plain versions on the
card by ``chip_smoke.py``.

Tolerances follow tests/test_fused_campaign.py: positions 1e-4 A, velocities
5e-3, forces 0.15 kcal/mol/A after a float32 step; pair forces 2e-3 and
energies 5e-3 in float32.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from molecular_dynamics_tpu import bias as jbias
from molecular_dynamics_tpu import constraints as jcons
from molecular_dynamics_tpu import energy as jenergy
from molecular_dynamics_tpu import system as jsystem
from molecular_dynamics_tpu.ops import fused_step as jfused
from molecular_dynamics_tpu.ops import nonbonded as jnonbonded
from molecular_dynamics_tpu.ops import ring as jring
from molecular_dynamics_tpu_torch import bias as tbias
from molecular_dynamics_tpu_torch import constraints as tcons
from molecular_dynamics_tpu_torch import energy as tenergy
from molecular_dynamics_tpu_torch.ops import fused_step as tfused
from molecular_dynamics_tpu_torch.ops import nonbonded as tnonbonded
from molecular_dynamics_tpu_torch.ops import ring as tring

from torch_parity import jax_system, minimized_full_da, t, thermal_velocities, torch_system

R = 4
PAIR_CASES = {
    "reference": dict(cutoff=9.0, switch_dist=7.5, rfa=True),
    "gbis16_vacuum": dict(cutoff=16.0, switch_dist=15.0, rfa=False),
}


@pytest.fixture(scope="module")
def sysm():
    jff, _ = jax_system("full_da", f64=False)
    tff, _ = torch_system("full_da", f64=False)
    pos = minimized_full_da()
    rng = np.random.default_rng(31)
    pos_b = (pos[None] + rng.normal(0, 0.02, (R,) + pos.shape)).astype(np.float32)
    vel_b = thermal_velocities(np.asarray(jff.masses), R, seed=6)
    d0 = float(np.linalg.norm(pos[-1] - pos[0]))
    bkw = dict(n_atoms=104, group1=[0], group2=[103], fk=1.0, cent_0=d0, cent_1=d0 + 22.0, T=500_000.0)
    return dict(
        jff=jff, tff=tff, pos=pos, pos_b=pos_b, vel_b=vel_b,
        jbias=jbias.HarmonicSMDBias.create(**bkw),
        tbias=tbias.HarmonicSMDBias.create(device="cpu", **bkw),
        jcons=jcons.hydrogen_bond_constraints(jff),
        tcons=tcons.hydrogen_bond_constraints(tff),
    )


# -- host tables ----------------------------------------------------------------


@pytest.fixture(scope="module")
def tables(sysm):
    ours = tnonbonded._build_pair_tables(sysm["tff"])
    ref = [np.asarray(x)[:104, :104] for x in jnonbonded._build_pair_tables(sysm["jff"], None, 128)]
    return ours, ref


@pytest.mark.parametrize("index", range(9), ids=tnonbonded.PAIR_TABLE_NAMES)
def test_pair_table_equals_jax(tables, index):
    ours, ref = tables
    assert ours[index].shape == (104, 104) and ours[index].dtype == np.float32
    # off the diagonal, which no pair loop reads (the port leaves it zero)
    off = ~np.eye(104, dtype=bool)
    np.testing.assert_allclose(ours[index][off], ref[index][off], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(ours[index], ours[index].T)
    assert not ours[index][~off].any()


def test_pair_table_counts(tables):
    ours, _ = tables
    names = tnonbonded.PAIR_TABLE_NAMES
    assert int(ours[names.index("mask")].sum()) == 2 * 4820
    assert int((ours[names.index("kb")] > 0).sum()) == 2 * (103 + 65)  # bonds + UB


def test_harmonic_pair_collision_is_refused(sysm):
    import dataclasses

    tff = sysm["tff"]
    clash = dataclasses.replace(tff, ub_bonds=tff.bonds[:1], ub_params=tff.bond_params[:1])
    with pytest.raises(ValueError, match="collision"):
        tnonbonded._build_pair_tables(clash)
    assert tnonbonded._resolve_ub(tff, None) and not tnonbonded._resolve_ub(tff, False)


def test_gather_lists_reproduce_the_scatter(sysm):
    """The per-atom gather lists the kernel reads give the same sums as the
    scatter they replace (angles, torsions, constraints)."""
    tab = tfused.build_campaign_tables(
        sysm["tff"], 2.0, 300.0, 1.0, bias=sysm["tbias"], constraints=sysm["tcons"]
    )
    tt = {k: v.numpy() for k, v in tab.tensors.items()}
    rng = np.random.default_rng(2)

    def gathered(prefix, buf):
        start, src, w = tt[f"{prefix}_start"], tt[f"{prefix}_src"], tt[f"{prefix}_w"]
        assert start[0] == 0 and start[-1] == len(src) == len(w)
        out = np.zeros((104, 3))
        for a in range(104):
            for e in range(start[a], start[a + 1]):
                out[a] += w[e] * buf[src[e]]
        return out

    n_a, n_t, n_c = tab.n_angles, tab.n_tors, tab.n_cons
    buf = rng.normal(size=(2 * n_a, 3))
    want = np.zeros((104, 3))
    ai = tt["ang_idx"]
    np.add.at(want, ai[:, 0], buf[:n_a])
    np.add.at(want, ai[:, 1], -buf[:n_a] - buf[n_a:])
    np.add.at(want, ai[:, 2], buf[n_a:])
    np.testing.assert_allclose(gathered("ang", buf), want, atol=1e-12)

    buf = rng.normal(size=(3 * n_t, 3))
    f0v, s, f3v = buf[:n_t], buf[n_t:2 * n_t], buf[2 * n_t:]
    want = np.zeros((104, 3))
    ti = tt["tor_idx"]
    np.add.at(want, ti[:, 0], -f0v)
    np.add.at(want, ti[:, 1], f0v + s)
    np.add.at(want, ti[:, 2], f3v - s)
    np.add.at(want, ti[:, 3], -f3v)
    np.testing.assert_allclose(gathered("tor", buf), want, atol=1e-12)

    buf = rng.normal(size=(n_c, 3))
    want = np.zeros((104, 3))
    ci = tt["cons_idx"]
    np.add.at(want, ci[:, 0], -tt["cons_wi"][:, None] * buf)
    np.add.at(want, ci[:, 1], tt["cons_wj"][:, None] * buf)
    np.testing.assert_allclose(gathered("cons", buf), want, atol=1e-6)
    assert (n_a, n_t, tab.max_t, n_c, tab.n_bias) == (183, 273, 2, 53, 2)
    assert tfused.campaign_shared_bytes(104, n_a, n_t, n_c) == 4 * (936 + 24 + 1098 + 2457 + 477)
    for name in tfused.TABLE_SLOTS[len(tnonbonded.PAIR_LAYOUT_SLOTS):]:
        want_dtype = torch.int32 if name.endswith(("idx", "start", "src")) else torch.float32
        assert tab.tensors[name].dtype == want_dtype and tab.tensors[name].is_contiguous(), name


# -- ops.ring ---------------------------------------------------------------------


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pair_forces_reference_vs_jax_ring_kernel(sysm, case):
    """The JAX ring kernel in interpret mode (16-shift chunks: the same pair
    sum as its monolithic body, tests/test_sim.py, at a quarter of the
    compile time) against the plain version of K2 and the port's ring op."""
    kw = PAIR_CASES[case]
    op = jring.make_pair_ring_op(sysm["jff"], block_r=8, interpret=True, shift_chunk=16, **kw)
    je, jf = jax.jit(op)(jnp.asarray(sysm["pos_b"]))
    tabs = tnonbonded.build_pair_tables(sysm["tff"])
    te, tf = tring.pair_forces_reference(t(sysm["pos_b"]), tabs, **kw)
    assert te.shape == (R,) and tf.shape == (R, 104, 3) and tf.dtype == torch.float32
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-3)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=5e-3)
    te, tf = tring.make_pair_ring_op(sysm["tff"], **kw)(t(sysm["pos_b"]))
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=2e-3)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=5e-3)


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pair_forces_reference_vs_f64_autograd(sysm, case):
    """Against the f64 autograd force of the same 2-body terms. The tables
    are float32, which bounds the agreement (relative 6e-8 of forces ~1e2)."""
    kw = PAIR_CASES[case]
    tff64 = sysm["tff"].to(dtype=torch.float64)
    ecfg = tenergy.EnergyConfig(terms=("electrostatics", "lj", "bonds", "dihedrals", "1-4"), **kw)

    def two_body(p):
        terms = tenergy.energy_terms(p, tff64, config=ecfg)
        return sum(v for k, v in terms.items() if k != "dihedrals")

    pos = t(sysm["pos_b"]).double()
    te, tf = tring.pair_forces_reference(pos, tnonbonded.build_pair_tables(sysm["tff"]), **kw)
    np.testing.assert_allclose(te.numpy(), two_body(pos).numpy(), atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), tenergy._neg_grad(two_body, pos).numpy(), atol=1e-4)
    # float32 against float64, the bound the card is held to as well
    te32, tf32 = tring.pair_forces_reference(pos.float(), tnonbonded.build_pair_tables(sysm["tff"]), **kw)
    np.testing.assert_allclose(tf32.numpy(), tf.numpy(), atol=2e-3)
    np.testing.assert_allclose(te32.numpy(), te.numpy(), atol=5e-3)


def test_pair_tables_options(sysm):
    pos = t(sysm["pos_b"])
    full = tring.pair_forces_reference(pos, tnonbonded.build_pair_tables(sysm["tff"]))[0]
    no_ub = tring.pair_forces_reference(pos, tnonbonded.build_pair_tables(sysm["tff"], include_ub=False))[0]
    assert float((full - no_ub).min()) > 0.1
    e_nocut, _ = tring.pair_forces_reference(pos, tnonbonded.build_pair_tables(sysm["tff"]), cutoff=None)
    assert bool(torch.isfinite(e_nocut).all())
    assert tnonbonded.pair_constants(None, 7.5, True, 78.5) == (1e30, 0.0, 0.0, 1e15, 0.0)


def test_cpu_tensors_take_the_plain_version(sysm):
    pos = t(sysm["pos_b"])
    tabs = tnonbonded.build_pair_tables(sysm["tff"])
    before = tring.pair_forces.launches, tfused.campaign_advance.launches
    e, f = tring.pair_forces(pos, tabs)
    e_ref, f_ref = tring.pair_forces_reference(pos, tabs)
    assert torch.equal(e, e_ref) and torch.equal(f, f_ref)
    adv = tfused.make_fused_campaign_op(sysm["tff"], n_inner=1, temperature=0.0)
    out = adv(pos, t(sysm["vel_b"]), torch.zeros_like(pos), 0, 1)
    assert all(o.shape == pos.shape for o in out)
    assert (tring.pair_forces.launches, tfused.campaign_advance.launches) == before == (0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tnonbonded.check_kernel_input("pos", pos, pos.shape)


# -- thermostat noise ----------------------------------------------------------


@pytest.mark.parametrize(
    "counter,key,want",
    [
        ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
         (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ],
)
def test_philox_known_answers(counter, key, want):
    """Random123's known-answer vectors for philox4x32-10."""
    out = tfused.philox4x32_10(tuple(torch.tensor([c], dtype=torch.int64) for c in counter), key)
    assert tuple(int(o) for o in out) == want


def test_philox_normals_statistics_and_keying():
    g = tfused.philox_normals(7, 100, 50, 32, 104)
    assert g.shape == (50, 32, 104, 3) and g.dtype == torch.float32
    assert abs(float(g.mean())) < 0.01 and abs(float(g.var()) - 1.0) < 0.02
    corr = lambda a, b: float(torch.corrcoef(torch.stack([a.flatten(), b.flatten()]))[0, 1])
    assert abs(corr(g[:, 0], g[:, 1])) < 0.05 and abs(corr(g[0], g[1])) < 0.05
    assert abs(corr(g[..., 0], g[..., 1])) < 0.05 and abs(corr(g[..., 0], g[..., 2])) < 0.05
    assert float((g - tfused.philox_normals(8, 100, 50, 32, 104)).abs().max()) > 1.0
    # one call of 50 steps draws what calls of 25 and 25 draw ...
    two = torch.cat([tfused.philox_normals(7, 100, 25, 32, 104),
                     tfused.philox_normals(7, 125, 25, 32, 104)])
    assert torch.equal(g, two)
    # ... and a draw does not depend on how many replicas or atoms there are
    assert torch.equal(tfused.philox_normals(7, 100, 3, 5, 9), g[:3, :5, :9])
    big = tfused.philox_normals(2**63 + 5, 2**33, 2, 2, 2)
    assert bool(torch.isfinite(big).all()) and float(big.abs().max()) < 6.0


# -- ops.fused_step ---------------------------------------------------------------


def _jax_composed(sysm, n_steps, with_bias, with_cons, n_iter=30):
    """n_steps of the JAX composed BAOAB step at T = 0 from (pos_b, vel_b)."""
    jff = sysm["jff"]
    bias = sysm["jbias"] if with_bias else None

    def force_at(step):
        def pot(q):
            e = jenergy.total_energy(q, jff, config=jenergy.REFERENCE_CONFIG)
            return e + bias.energy(q, step) if bias is not None else e
        return lambda p, b: -jax.grad(pot)(p)

    def one(pos, vel):
        from molecular_dynamics_tpu import integrate as jintegrate

        st = jsystem.system_init(pos, vel=vel)
        st = st.replace(forces=force_at(0)(pos, None))
        f0 = st.forces
        for i in range(n_steps):
            if with_cons:
                st = jcons.constrained_langevin_step(
                    st, force_at(i), jff.masses, sysm["jcons"], 2.0, 0.0, 1.0, n_iter=n_iter
                )
            else:
                st = jintegrate.langevin_step(st, force_at(i), jff.masses, 2.0, 0.0, 1.0)
        return f0, st.pos, st.vel, st.forces

    return jax.jit(jax.vmap(one))(jnp.asarray(sysm["pos_b"]), jnp.asarray(sysm["vel_b"]))


@pytest.mark.parametrize("with_cons", [False, True], ids=["bias", "bias+constraints"])
@pytest.mark.parametrize("n_inner", [1, 2])
def test_campaign_reference_vs_jax_composed_step(sysm, n_inner, with_cons):
    f0, jp, jv, jf = _jax_composed(sysm, n_inner, True, with_cons)
    adv = tfused.make_fused_campaign_op(
        sysm["tff"], n_inner=n_inner, dt_fs=2.0, temperature=0.0, bias=sysm["tbias"],
        constraints=sysm["tcons"] if with_cons else None,
        shake_iters=30, rattle_iters=15,
    )
    tp, tv, tf = adv(t(sysm["pos_b"]), t(sysm["vel_b"]), t(f0), 0, 1)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=5e-3)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=0.15)
    if with_cons:
        i, j = sysm["tcons"].pairs.T
        d = torch.linalg.norm(tp[:, i] - tp[:, j], dim=-1)
        assert float((d - sysm["tcons"].lengths).abs().max()) < 1e-5


def test_campaign_reference_vs_jax_pallas_kernel(sysm):
    """The JAX campaign kernel body itself, in interpret mode: bias,
    constraints, default sweep counts, T = 0, one step."""
    f0 = _jax_composed(sysm, 0, True, True)[0]
    jadv = jfused.make_fused_campaign_op(
        sysm["jff"], n_inner=1, dt_fs=2.0, temperature=0.0, bias=sysm["jbias"],
        constraints=sysm["jcons"], block_r=8, interpret=True,
    )
    jp, jv, jf = jax.jit(lambda a, b, c: jadv(a, b, c, jnp.int32(0), jnp.int32(1)))(
        jnp.asarray(sysm["pos_b"]), jnp.asarray(sysm["vel_b"]), f0
    )
    tadv = tfused.make_fused_campaign_op(
        sysm["tff"], n_inner=1, dt_fs=2.0, temperature=0.0, bias=sysm["tbias"],
        constraints=sysm["tcons"],
    )
    tp, tv, tf = tadv(t(sysm["pos_b"]), t(sysm["vel_b"]), t(np.asarray(f0)), 0, 1)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-4)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=5e-3)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=0.15)


def test_campaign_smd_centre_uses_the_start_index(sysm):
    """The post-drift force of step i sees the centre at t0 + i, and the
    centre is held past T."""
    tab = tfused.build_campaign_tables(sysm["tff"], 2.0, 0.0, 1.0, bias=sysm["tbias"])
    pc = tnonbonded.pair_constants(9.0, 7.5, True, 78.5)
    pos = t(sysm["pos_b"])
    fk, c0, slope, tmax = 1.0, 10.0, 0.5, 8.0
    f = lambda step: tfused.campaign_forces_reference(pos, tab, pc, (fk, c0, slope, tmax), step)
    no_bias = tfused.campaign_forces_reference(pos, tab, pc, (0.0, 0.0, 0.0, 0.0), 0)
    dist = torch.linalg.norm(pos[:, 103] - pos[:, 0], dim=-1)
    for step, center in ((0, 10.0), (4, 12.0), (8, 14.0), (50, 14.0)):
        pull = (f(step) - no_bias)[:, 103]  # force on the pulled end
        unit = (pos[:, 103] - pos[:, 0]) / dist[:, None]
        np.testing.assert_allclose(
            torch.sum(pull * unit, -1).numpy(), (-fk * (dist - center)).numpy(), atol=1e-4
        )


def test_campaign_default_sweeps_hold_the_bonds(sysm):
    adv = tfused.make_fused_campaign_op(
        sysm["tff"], n_inner=5, dt_fs=2.0, temperature=0.0, constraints=sysm["tcons"]
    )
    pos = t(np.broadcast_to(sysm["pos"], sysm["pos_b"].shape).copy())
    f0 = tenergy.force_fn()(pos, sysm["tff"])
    tp, tv, _ = adv(pos, t(sysm["vel_b"]), f0, 0, 1)
    i, j = sysm["tcons"].pairs.T
    d = torch.linalg.norm(tp[:, i] - tp[:, j], dim=-1)
    assert float((d - sysm["tcons"].lengths).abs().max()) < 1e-6
    dhat = (tp[:, i] - tp[:, j]) / d[..., None]
    assert float(torch.sum((tv[:, i] - tv[:, j]) * dhat, -1).abs().max()) < 5e-5


def test_campaign_noise_argument_and_default_stream(sysm):
    adv = tfused.make_fused_campaign_op(
        sysm["tff"], n_inner=3, dt_fs=2.0, temperature=300.0, constraints=sysm["tcons"]
    )
    pos, vel = t(sysm["pos_b"]), t(sysm["vel_b"])
    f0 = tenergy.force_fn()(pos, sysm["tff"])
    drawn = adv(pos, vel, f0, 40, 13)
    fed = adv(pos, vel, f0, 40, 13, noise=tfused.philox_normals(13, 40, 3, R, 104))
    assert all(torch.equal(a, b) for a, b in zip(drawn, fed))
    other = adv(pos, vel, f0, 40, 14)
    assert float((drawn[0] - other[0]).abs().max()) > 1e-4
    # 3 steps in one call = 1 step + 2 steps, with the stream keyed on t0 + i
    one = tfused.make_fused_campaign_op(
        sysm["tff"], n_inner=1, dt_fs=2.0, temperature=300.0, constraints=sysm["tcons"])
    two = tfused.make_fused_campaign_op(
        sysm["tff"], n_inner=2, dt_fs=2.0, temperature=300.0, constraints=sysm["tcons"])
    split = two(*one(pos, vel, f0, 40, 13), 41, 13)
    assert all(torch.equal(a, b) for a, b in zip(drawn, split))
    assert adv.n_inner == 3


@pytest.mark.parametrize("flag", ["gb", "sasa"])
def test_campaign_solvent_flags_raise(sysm, flag):
    """``gb=True`` / ``sasa=True`` raise by name where the force field has no
    GB tables, and build the op where it has them."""
    import dataclasses

    bare = dataclasses.replace(
        sysm["tff"], gb_radii=None, gb_screen=None, sasa_radii=None, sasa_params=None
    )
    with pytest.raises(ValueError, match=f"{flag}=True needs"):
        tfused.make_fused_campaign_op(bare, **{flag: True})
    adv = tfused.make_fused_campaign_op(sysm["tff"], **{flag: True})
    assert (adv.tables.gb is not None) == (flag == "gb")
    assert (adv.tables.sasa is not None) == (flag == "sasa")


def test_campaign_shared_memory_limit_raises(sysm, monkeypatch):
    """The kernel opts in to the card's 227 KB a CTA: the 416-atom system
    (70.5 KB unconstrained) and the 1,040-atom one (176.2 KB) fit, 13 copies
    (229.1 KB) do not."""
    from molecular_dynamics_tpu_torch.examples import tiled_decaalanine

    assert tfused.SHARED_LIMIT_BYTES == 232448
    counts = dict(n_angles=183, n_tors=273, n_cons=0)
    need = {m: tfused.campaign_shared_bytes(104 * m, *(m * c for c in counts.values()))
            for m in (4, 10, 13)}
    assert need == {4: 72168, 10: 180432, 13: 234564}
    ff13, _, _ = tiled_decaalanine(13, device="cpu")
    with pytest.raises(ValueError, match="shared memory"):
        tfused.make_fused_campaign_op(ff13)
    monkeypatch.setattr(tfused, "SHARED_LIMIT_BYTES", 1024)
    with pytest.raises(ValueError, match="shared memory"):
        tfused.make_fused_campaign_op(sysm["tff"])


def _pair_loop_threads(n):
    """Threads a CTA of the pair loop's kernels for ``n`` atoms, by the rule
    of ``csrc/pair_loop.cuh`` ``pair_loop_shape`` with its constants read
    from the source."""
    import re
    from molecular_dynamics_tpu_torch.ops import _build

    src = (_build.CSRC / "pair_loop.cuh").read_text()
    k = {name: int(v) for name, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    if n <= k["kSmallAtoms"]:
        return k["kSmallThreads"]
    return k["kMediumThreads"] if n <= k["kMediumAtoms"] else k["kLargeThreads"]


@pytest.mark.parametrize("m, threads, kb", [
    (1, 128, 17.6), (4, 512, 70.5), (8, 1024, 141.0), (10, 1024, 176.2), (12, 1024, 211.4)])
def test_campaign_cta_shape_at_the_tier_sizes(m, threads, kb):
    """The CTA of the campaign kernel (and of the pair-forces kernel, which
    takes the same shape) follows the system: 128 threads up to 128 atoms,
    512 up to 512, 1024 above, and no warp owns more chunks of the pair loop
    than its instantiation keeps in registers (one, two at 1024 threads);
    the unconstrained tiled systems' shared memory fits the 227 KB a CTA may
    opt in to up to 12 copies, and their atoms the vacuum kernel's limit."""
    n = 104 * m
    assert _pair_loop_threads(n) == threads
    nc = tnonbonded.chunk_count(n)
    assert nc <= (threads // 32) * (2 if threads == 1024 else 1)
    assert tnonbonded.chunk_size(n) * nc >= n and tnonbonded.chunk_size(n) <= 32
    need = tfused.campaign_shared_bytes(n, 183 * m, 273 * m, 0)
    assert round(need / 1024, 1) == kb and need <= tfused.SHARED_LIMIT_BYTES
    assert n <= tfused.campaign_max_atoms(solvent=False) == tnonbonded.PAIR_LOOP_MAX_ATOMS
    assert (n <= tfused.campaign_max_atoms(solvent=True)) == (m <= 2)


def test_campaign_atom_limit_raises(sysm, monkeypatch):
    """The campaign op refuses a system past what its instantiation holds:
    2,048 atoms in vacuum, 256 with GB or LCPO."""
    assert tfused.campaign_max_atoms(False) == 2048 and tfused.campaign_max_atoms(True) == 256
    monkeypatch.setattr(tfused, "PAIR_LOOP_MAX_ATOMS", 103)
    with pytest.raises(ValueError, match="104 atoms; the kernel holds 103$"):
        tfused.make_fused_campaign_op(sysm["tff"])
