"""Port parity: the implicit-solvent campaign (``ops.gb``, ``ops.sasa``, the
GB/SASA half of ``ops.fused_step`` and ``sim``) against the JAX package.

On the CPU a wrapper takes its kernel's plain PyTorch version, so these tests
hold the plain versions against the JAX package: the HCT integral and its
derivative against the JAX kernel's own ``_hct_pair``/``_hct_pair_both``
(pure ``jnp`` functions), the analytic GB and LCPO forces against ``-grad``
of the JAX energies, one BAOAB step of the campaign op against the composed
JAX step, the two cadence structures against the same blocks rolled from the
JAX package's force functions and integrator steps, and ``simulate_ensemble`` under
``GBIS_CONFIG`` as a whole. The CUDA kernels themselves are held against the
plain versions on the card by ``chip_smoke.py``.

Tolerances, each stated where it is used: float64 against float64 1e-7
kcal/mol/A (another summation order), plain float32 within 5e-3 of float64
(the JAX kernel's own pin), a float32 BAOAB step 1e-5 A / 5e-3 / 0.15
kcal/mol/A as ``tests/test_fused_gb.py``.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from molecular_dynamics_tpu import bias as jbias
from molecular_dynamics_tpu import constraints as jconstraints
from molecular_dynamics_tpu import energy as jenergy
from molecular_dynamics_tpu import integrate as jintegrate
from molecular_dynamics_tpu import sim as jsim
from molecular_dynamics_tpu import solvent as jsolvent
from molecular_dynamics_tpu import system as jsystem
from molecular_dynamics_tpu.ops.fused_step import _hct_pair, _hct_pair_both
from molecular_dynamics_tpu_torch import bias as tbias
from molecular_dynamics_tpu_torch import constraints as tcons
from molecular_dynamics_tpu_torch import energy as tenergy
from molecular_dynamics_tpu_torch import integrate as tintegrate
from molecular_dynamics_tpu_torch import sim as tsim
from molecular_dynamics_tpu_torch import solvent as tsolvent
from molecular_dynamics_tpu_torch import system as tsystem
from molecular_dynamics_tpu_torch import units as tunits
from molecular_dynamics_tpu_torch.ops import fused_step as tfused
from molecular_dynamics_tpu_torch.ops._build import SHARED_OPT_IN_BYTES
from molecular_dynamics_tpu_torch.ops import gb as tgb
from molecular_dynamics_tpu_torch.ops import sasa as tsasa

from torch_parity import SYSTEMS, jax_system, minimized_full_da, t, thermal_velocities, torch_system

R = 4
GBIS = tenergy.GBIS_CONFIG
GB_CONSTS = tgb.gb_constants(GBIS.solvent_dielectric, GBIS.ion_concentration)
#: the campaign op's arguments under GBIS_CONFIG
GBIS_OP = dict(
    cutoff=GBIS.cutoff, switch_dist=GBIS.switch_dist, rfa=GBIS.rfa,
    solvent_dielectric=GBIS.solvent_dielectric, ion_concentration=GBIS.ion_concentration,
    surface_tension=GBIS.surface_tension,
)


@pytest.fixture(scope="module")
def sysm():
    jff, _ = jax_system("full_da", f64=False)
    tff, _ = torch_system("full_da", f64=False)
    pos = minimized_full_da()
    rng = np.random.default_rng(41)
    pos_b = (pos[None] + rng.normal(0, 0.02, (R,) + pos.shape)).astype(np.float32)
    vel_b = thermal_velocities(np.asarray(jff.masses), R, seed=8)
    d0 = float(np.linalg.norm(pos[-1] - pos[0]))
    # a centre that moves 0.05 A a step and stops after 6: the step index shows
    bkw = dict(n_atoms=104, group1=[0], group2=[103], fk=5.0, cent_0=d0, cent_1=d0 + 0.3, T=6.0)
    return dict(
        jff=jff, tff=tff, pos=pos, pos_b=pos_b, vel_b=vel_b, bias_kw=bkw,
        tbias=tbias.HarmonicSMDBias.create(device="cpu", **bkw),
        tcons=tcons.hydrogen_bond_constraints(tff),
    )


# -- the HCT integral and its derivative ------------------------------------------


def test_hct_pair_matches_jax_across_the_branches():
    """d swept through every piecewise region for s_j below, near and above
    rho_i, with points 1e-3 either side of d = s_j +- rho_i and d = rho_i -
    s_j (the boundaries of use_rho, inside and contrib)."""
    rho = 1.41
    for s in (0.3, 1.0, 1.405, 2.5, 4.0):
        edges = [abs(s - rho), s + rho, abs(rho - s)]
        d = np.concatenate(
            [np.linspace(0.15, 8.0, 80), [max(e + x, 0.05) for e in edges for x in (-1e-3, 1e-3)]]
        )
        live = np.ones_like(d, dtype=bool)
        ji, jd = _hct_pair(
            jnp.asarray(d), jnp.asarray(1.0 / d), jnp.float64(rho), jnp.float64(1.0 / rho),
            jnp.float64(s), jnp.asarray(live), True,
        )
        ti, td = tgb.hct_pair(
            t(d), t(1.0 / d), torch.tensor(rho, dtype=torch.float64),
            torch.tensor(1.0 / rho, dtype=torch.float64),
            torch.tensor(s, dtype=torch.float64), t(live),
        )
        # the JAX function forms 1/lo and 1/up from one shared reciprocal
        np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=1e-12, atol=1e-14, err_msg=str(s))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-11, atol=1e-13, err_msg=str(s))
        assert np.count_nonzero(ti.numpy()) > 40  # the sweep is not all dead pairs


@pytest.mark.parametrize("system", SYSTEMS)
def test_hct_pair_matches_jax_both_directions_on_real_geometry(system):
    """Dense (N, N) evaluation, float32 as the kernels run it, dead diagonal
    included: forward and reverse directions against ``_hct_pair_both``."""
    jff, coords = jax_system(system, f64=False)
    n = len(coords)
    rho = np.asarray(jff.gb_radii, np.float32) - np.float32(jsolvent.GB_OFFSET)
    s = np.asarray(jff.gb_screen, np.float32) * rho
    pos = coords.astype(np.float32)
    off = ~np.eye(n, dtype=bool)
    delta = pos[:, None] - pos[None]
    d = np.sqrt(np.where(off, (delta * delta).sum(-1), 1.0)).astype(np.float32)
    dinv = (1.0 / d).astype(np.float32)
    col, row = (lambda v: v[:, None]), (lambda v: v[None, :])
    ref = _hct_pair_both(
        jnp.asarray(d), jnp.asarray(dinv), col(rho), col(1 / rho), col(s),
        row(rho), row(1 / rho), row(s), jnp.asarray(off), True,
    )
    fwd = tgb.hct_pair(t(d), t(dinv), t(col(rho)), t(col(1 / rho)), t(row(s)), t(off))
    rev = tgb.hct_pair(t(d), t(dinv), t(row(rho)), t(row(1 / rho)), t(col(s)), t(off))
    for ours, theirs in zip(fwd + rev, ref):
        assert ours.dtype == torch.float32
        # float32 rounding of two reciprocals against one shared reciprocal
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=2e-5, atol=2e-7)
    assert not fwd[0].numpy()[~off].any() and not fwd[1].numpy()[~off].any()


# -- host tables --------------------------------------------------------------------


def test_gb_and_sasa_tables(sysm):
    tff = sysm["tff"]
    gt = tgb.build_gb_tables(tff)
    assert gt.atom.shape == (104, 5) and gt.atom.dtype == torch.float32 and gt.atom.is_contiguous()
    assert gt.atom64.dtype == torch.float64 and gt.n_atoms == 104
    rho, rho_inv, s, rad_inv, qe = gt.atom64.numpy().T
    radii = tff.gb_radii.double().numpy()
    np.testing.assert_allclose(rho, radii - tsolvent.GB_OFFSET, rtol=1e-12)
    np.testing.assert_allclose(rho * rho_inv, 1.0, rtol=1e-12)
    np.testing.assert_allclose(s, tff.gb_screen.double().numpy() * rho, rtol=1e-12)
    np.testing.assert_allclose(rad_inv * radii, 1.0, rtol=1e-12)
    np.testing.assert_allclose(
        qe[:, None] * qe[None, :],
        tunits.ELEC_FACTOR * np.outer(tff.charges.double().numpy(), tff.charges.double().numpy()),
        rtol=1e-12, atol=1e-12,
    )
    st = tsasa.build_sasa_tables(tff)
    heavy = np.flatnonzero(tff.sasa_radii.numpy() > 0)
    assert st.n_compact == 51 == len(heavy) and st.n_atoms == 104
    assert st.idx.dtype == torch.int32 and st.idx.numpy().tolist() == heavy.tolist()
    assert st.atom.shape == (51, 5) and st.atom.dtype == torch.float32
    r, a0, p2, p3, p4 = st.atom64.numpy().T
    np.testing.assert_allclose(r, tff.sasa_radii.double().numpy()[heavy], rtol=1e-12)
    np.testing.assert_allclose(
        a0, tff.sasa_params.double().numpy()[heavy, 0] * 4 * np.pi * r * r, rtol=1e-12)
    np.testing.assert_allclose(
        np.stack([p2, p3, p4], -1), tff.sasa_params.double().numpy()[heavy, 1:], rtol=1e-12)
    assert tgb.gb_constants(80.0, 0.0)[:2] == (1.0 / 80.0, 0.0)
    assert abs(GB_CONSTS[1] - 50.29216 * (0.1 / (80.0 * 300.0)) ** 0.5) < 1e-12
    assert GB_CONSTS[2:] == (1.0, 0.8, 4.85)
    # what the kernels carve out of shared memory: 50 list entries a heavy
    # atom (three floats and a 16-bit index each) beside per-atom vectors;
    # GB's three vectors and its dI cache (104 rows of 103); the campaign
    # kernel's state, its slow force with a cadence, the pair loop's chunk
    # boxes (6 floats for each of 4 chunks), and one region as large as its
    # largest tenant, the GB scratch here
    assert tsasa.sasa_shared_bytes(51) == 4 * (
        3 * 51 * 50 + 6 * 51 + 2 * 51 * 2 + 2 * 51 + 2 + 51 * 50 // 2) == 38156
    assert tgb.gb_shared_bytes(104) == 4 * (3 * 104 + 104 * 103) == 44096
    base = tfused.campaign_shared_bytes(104, 183, 273, 53)
    assert tfused.campaign_shared_bytes(104, 183, 273, 53, gb=True) == (
        4 * 9 * 104 + 4 * 24 + tgb.gb_shared_bytes(104)) > base
    need = tfused.campaign_shared_bytes(104, 183, 273, 53, gb=True, n_sasa=51, slow_buffer=True)
    assert need == 4 * 12 * 104 + 4 * 24 + tgb.gb_shared_bytes(104) == 49184
    # four CTAs an SM: 228 KB a Hopper SM, 1 KB of it reserved for each CTA
    assert 4 * (need + 1024) <= 228 * 1024
    bare = dataclasses.replace(tff, gb_radii=None, gb_screen=None, sasa_radii=None, sasa_params=None)
    with pytest.raises(ValueError, match="gb=True needs GB tables"):
        tgb.build_gb_tables(bare)
    with pytest.raises(ValueError, match="sasa=True needs LCPO tables"):
        tsasa.build_sasa_tables(bare)


@pytest.mark.parametrize("scale", [1.0, 0.4])
@pytest.mark.parametrize("system", SYSTEMS)
def test_sasa_lists_hold_every_overlap(system, scale):
    """The kernels' neighbour lists hold the most overlapping heavy atoms any
    atom has: the packaged systems jittered by 0.05 A, and compressed to 0.4
    about their centre (as fault C5's probe does), where full_da's atoms
    overlap all 50 others."""
    from molecular_dynamics_tpu_torch.examples import decaalanine_full, dialanine

    ff, coords, _ = {"full_da": decaalanine_full, "diala": dialanine}[system](device="cpu")
    tab = tsasa.build_sasa_tables(ff)
    c = np.asarray(coords, np.float64)
    c = c.mean(0) + scale * (c - c.mean(0))
    pos = t(c[None] + np.random.default_rng(5).normal(0.0, 0.05, (16,) + c.shape))
    degree = int(tsasa.sasa_overlaps(pos, tab).sum(-1).max())
    assert 0 < degree <= tsasa.sasa_capacity(tab.n_compact) == tab.n_compact - 1
    assert not tsasa.overflow_possible(tab.n_compact)


@pytest.mark.parametrize("flag", [0, 1])
@pytest.mark.parametrize("n_compact", [51, 102])
def test_sasa_overflow_flag_raises(n_compact, flag):
    """A kernel that could not list an atom's neighbours sets its flag; the
    wrappers read it wherever a list can overflow (above 65 heavy atoms)
    and raise."""
    assert tsasa.overflow_possible(n_compact) == (n_compact > 65)
    assert tsasa.sasa_capacity(n_compact) == min(n_compact - 1, tsasa.SASA_MAX_NEIGHBOURS)
    overflow = torch.tensor([flag], dtype=torch.int32)
    if flag:
        with pytest.raises(RuntimeError, match=f"more than {tsasa.SASA_MAX_NEIGHBOURS} others"):
            tsasa.raise_on_overflow(overflow, n_compact, "sasa_forces")
    else:
        tsasa.raise_on_overflow(overflow, n_compact, "sasa_forces")


def _cuh_words(name):
    """The word count ``name(nc)`` of ``csrc/sasa_terms.cuh`` as a Python
    function, read from the source: its ``const size_t`` declarations and its
    return expression, with integer division."""
    import re
    from molecular_dynamics_tpu_torch.ops import _build

    src = (_build.CSRC / "sasa_terms.cuh").read_text()
    body = re.search(rf"size_t {name}\(int nc\) \{{\n(.*?)\n\}}", src, re.S).group(1)
    body = re.sub(r"static_cast<size_t>\((\w+)\)", r"\1", body).replace("/", "//")
    decl = re.search(r"const size_t (.*?);", body)
    ret = re.search(r"return (.*?);", body).group(1)

    def words(nc):
        scope = {"nc": nc, "sasa_capacity": tsasa.sasa_capacity,
                 "sasa_words": lambda k: (k + 31) // 32}
        for part in re.split(r",\s*(?=\w+ = )", decl.group(1)) if decl else ():
            key, value = part.split(" = ", 1)
            scope[key] = eval(value, scope)
        return eval(ret, scope)

    return words


@pytest.mark.parametrize("nc", [1, 2, 51, 65, 66, 102, 204, 230, 244])
def test_sasa_scratch_splits_into_lists_and_per_atom_part(nc):
    """The LCPO scratch in two parts: the lists (``sasa_list_bytes``: 14
    bytes an entry, rounded up to a word) and the per-atom part, which alone
    stays in shared memory where the lists live in global memory. Together
    they are the single count of before the split, and each equals the
    formula of ``csrc/sasa_terms.cuh`` the kernels carve by. The wrapper's
    workspace holds R replicas' lists."""
    cap, words = tsasa.sasa_capacity(nc), (nc + 31) // 32
    whole = 4 * (3 * nc * cap + 6 * nc + 2 * nc * words + 2 * nc + 2 + (nc * cap + 1) // 2)
    lists, per_atom = tsasa.sasa_list_bytes(nc), tsasa.sasa_shared_bytes(nc, lists_global=True)
    assert lists + per_atom == tsasa.sasa_shared_bytes(nc) == whole
    assert lists == 4 * ((14 * nc * cap + 3) // 4)
    assert (lists, per_atom) == (4 * _cuh_words("sasa_list_words")(nc),
                                 4 * _cuh_words("sasa_atom_words")(nc))
    assert tsasa.list_workspace(3, nc, "cpu").numel() * 4 == 3 * lists


#: system -> (the solvent instantiation, its shared bytes with rigid X-H
#: bonds and a cadence under GBIS_CONFIG, where the LCPO lists live), or None
#: where the kernel does not hold it: m tiled deca-alanines, or "diala_xk",
#: di-alanine tiled k times (484 and 506 atoms, 220 and 230 heavy atoms:
#: their lists, 197,120 and 206,080 bytes a replica, cannot share the CTA's
#: 227 KB with the rest)
GBIS_TIER_SHAPES = {1: ("campaign_solvent", 49184, "shared"),
                    2: ("campaign_solvent_large", 108080, "shared"),
                    4: ("campaign_solvent_large", 221024, "shared"),
                    "diala_x22": ("campaign_solvent_large", 87768, "global"),
                    "diala_x23": ("campaign_solvent_large", 91740, "global"),
                    5: None, 8: None, 10: None}


def _gbis_tier_system(key):
    """The system of a GBIS_TIER_SHAPES key and its sizes (atoms, angles,
    torsions, X-H constraints, LCPO atoms)."""
    from molecular_dynamics_tpu_torch.examples import dialanine, tiled_decaalanine
    from molecular_dynamics_tpu_torch.ff.params import tile_ff_params

    if str(key).startswith("diala_x"):
        k = int(key[len("diala_x"):])
        ff = tile_ff_params(dialanine(device="cpu")[0], k)
        return ff, (22 * k, 36 * k, 45 * k, 12 * k, 10 * k)
    ff, _, _ = tiled_decaalanine(key, device="cpu")
    return ff, (104 * key, 183 * key, 273 * key, 53 * key, 51 * key)


@pytest.mark.parametrize("m", list(GBIS_TIER_SHAPES))
def test_gbis_campaign_shared_memory_at_the_tier_sizes(m):
    """The GBIS campaign op holds the tiled systems up to 512 atoms: 104 in
    the 256-thread instantiation with GB's dI cache, 208 and 416 in the
    512-thread one without it, where the LCPO lists set the shared memory
    (221 KB at 416 atoms), and the tiled di-alanines of 484 and 506 atoms
    (220 and 230 heavy atoms) with the lists in a global workspace, the rest
    of the CTA in 87.8 and 91.7 KB. At 520 atoms and above
    the op raises, naming the limit, and ``campaign_holds`` says no before
    any table is built."""
    ff, (n, n_a, n_t, n_c, n_sasa) = _gbis_tier_system(m)
    cons = tcons.hydrogen_bond_constraints(ff)
    assert (ff.n_atoms, int(ff.angles.shape[0]), cons.n_constraints) == (n, n_a, n_c)
    assert int(ff.dihedrals.shape[0]) + int(ff.impropers.shape[0]) == n_t
    sizes = (n, n_a, n_t, n_c)
    need = tfused.campaign_shared_bytes(*sizes, gb=True, n_sasa=n_sasa, slow_buffer=True)
    lists_global = tfused.campaign_sasa_lists_global(*sizes, True, n_sasa, True)
    cfg = tsim.SimulationConfig(energy=GBIS, fused_campaign=True, constrain_h_bonds=True,
                                sasa_every=5)
    holds = tsim.campaign_holds(ff, cfg)
    misfit = tfused.campaign_misfit(*sizes, True, n_sasa, True)
    assert holds == (misfit is None)
    assert holds == (GBIS_TIER_SHAPES[m] is not None)
    # up to 512 atoms the lists leave shared memory only where the CTA could
    # not hold them
    with_lists = need + (tsasa.sasa_list_bytes(n_sasa) if lists_global else 0)
    if n <= 512:
        assert lists_global == (with_lists > tfused.SHARED_LIMIT_BYTES)
    build = lambda: tfused.make_fused_campaign_op(
        ff, gb=True, sasa=True, sasa_every=5, constraints=cons, **GBIS_OP)
    if holds:
        op = build()
        assert (op.instantiation, op.shared_bytes, op.sasa_lists) == GBIS_TIER_SHAPES[m]
        assert op.shared_bytes == need <= tfused.SHARED_LIMIT_BYTES
        assert op.gb_cached == (op.instantiation == "campaign_solvent")
        assert op.sasa_workspace_bytes == (tsasa.sasa_list_bytes(n_sasa) if lists_global else 0)
    else:
        assert n > tfused.campaign_max_atoms(solvent=True)
        with pytest.raises(ValueError, match=f"{n} atoms; the kernel holds 512 with GB or LCPO"):
            build()


# -- the analytic forces against -grad of the JAX energies -----------------------


@pytest.fixture(scope="module")
def force_worlds():
    out = {}
    for name in SYSTEMS:
        jff, coords = jax_system(name)
        tff, _ = torch_system(name)
        rng = np.random.default_rng(23)
        pos = coords[None] + rng.normal(0.0, 0.05, (3,) + coords.shape)
        out[name] = dict(jff=jff, tff=tff, pos=pos)
    return out


@pytest.mark.parametrize("salt", [0.0, 0.1], ids=["kappa0", "salt0.1M"])
@pytest.mark.parametrize("system", SYSTEMS)
def test_gb_forces_reference_matches_jax_grad(force_worlds, system, salt):
    w = force_worlds[system]
    jfun = lambda p, ff: jsolvent.gb_energy(p, ff, 80.0, salt)
    je, jg = jax.jit(jax.vmap(jax.value_and_grad(jfun), in_axes=(0, None)))(
        jnp.asarray(w["pos"]), w["jff"])
    consts = tgb.gb_constants(80.0, salt)
    tables = tgb.build_gb_tables(w["tff"])
    f, e, born = tgb.gb_forces_reference(t(w["pos"]), tables, consts)
    assert f.shape == w["pos"].shape and e.shape == (3,) and born.shape == w["pos"].shape[:2]
    np.testing.assert_allclose(f.numpy(), -np.asarray(jg), rtol=0, atol=1e-7)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=0, atol=1e-7)
    np.testing.assert_allclose(
        born.numpy(), tsolvent.born_radii(t(w["pos"]), w["tff"]).numpy(), rtol=1e-10)
    # float32 plain within 5e-3 of float64, forces of O(10) and energies of O(50)
    f32, e32, _ = tgb.gb_forces_reference(t(w["pos"]).float(), tables, consts)
    assert f32.dtype == torch.float32 and np.abs(np.asarray(jg)).max() > 3.0
    np.testing.assert_allclose(f32.numpy(), f.numpy(), rtol=0, atol=5e-3)
    np.testing.assert_allclose(e32.numpy(), e.numpy(), rtol=0, atol=5e-3)


@pytest.mark.parametrize("gated", [False, True], ids=["as_is", "gated"])
@pytest.mark.parametrize("system", SYSTEMS)
def test_sasa_forces_reference_matches_jax_grad(force_worlds, system, gated):
    """At the packaged geometries, jittered or squeezed, no atom's LCPO area
    is gated to zero (the smallest is 2.8 A^2). The gated case therefore cuts
    P1 of every third heavy atom to a tenth: those atoms reach a negative
    area, the relu zeroes them, and the cotangent W has to carry the gate."""
    w = force_worlds[system]
    jff, tff = w["jff"], w["tff"]
    if gated:
        params = np.asarray(jff.sasa_params).copy()
        heavy = np.flatnonzero(np.asarray(jff.sasa_radii) > 0)
        params[heavy[::3], 0] *= 0.1
        jff = jff.replace(sasa_params=jnp.asarray(params))
        tff = dataclasses.replace(tff, sasa_params=t(params))
    pos = w["pos"]
    jfun = lambda p, ff: jsolvent.sasa_energy(p, ff, 0.005)
    je, jg = jax.jit(jax.vmap(jax.value_and_grad(jfun), in_axes=(0, None)))(jnp.asarray(pos), jff)
    tables = tsasa.build_sasa_tables(tff)
    f, e = tsasa.sasa_forces_reference(t(pos), tables, 0.005)
    np.testing.assert_allclose(f.numpy(), -np.asarray(jg), rtol=0, atol=1e-7)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), rtol=0, atol=1e-7)
    hydrogens = tff.sasa_radii.numpy() == 0
    assert not f.numpy()[:, hydrogens].any() and np.abs(f.numpy()).max() > 0.02
    areas = tsolvent.sasa(t(pos), tff).numpy()[:, ~hydrogens]
    assert bool((areas == 0).any()) == gated and bool((areas > 0).any())
    f32, e32 = tsasa.sasa_forces_reference(t(pos).float(), tables, 0.005)
    np.testing.assert_allclose(f32.numpy(), f.numpy(), rtol=0, atol=5e-3)
    np.testing.assert_allclose(e32.numpy(), e.numpy(), rtol=0, atol=5e-3)
    overlaps = tsasa.sasa_overlaps(t(pos), tables)
    assert overlaps.shape == (3, tables.n_compact, tables.n_compact)
    assert torch.equal(overlaps, overlaps.transpose(-1, -2)) and bool(overlaps.any())


def test_campaign_forces_reference_equals_autograd_of_gbis_energy(sysm):
    """The whole per-step force of the campaign op, pair tables in float32:
    1e-4 kcal/mol/A of the float64 autograd force of GBIS_CONFIG + bias."""
    tff64 = sysm["tff"].to(dtype=torch.float64)
    tab = tfused.build_campaign_tables(sysm["tff"], 2.0, 0.0, 1.0, bias=sysm["tbias"], gb=True, sasa=True)
    pc = tfused.pair_constants(GBIS.cutoff, GBIS.switch_dist, GBIS.rfa, GBIS.solvent_dielectric)
    bias = sysm["tbias"]
    bc = (float(bias.fk), float(bias.cent_0), float((bias.cent_1 - bias.cent_0) / bias.T), float(bias.T))
    bias = tbias.HarmonicSMDBias.create(
        n_atoms=104, group1=[0], group2=[103], fk=bc[0], cent_0=bc[1], cent_1=float(bias.cent_1),
        T=bc[3], dtype=torch.float64, device="cpu")
    pos = t(sysm["pos_b"]).double()
    for step in (0, 3):
        ours = tfused.campaign_forces_reference(pos, tab, pc, bc, step, GB_CONSTS, GBIS.surface_tension)
        want = tenergy._neg_grad(
            lambda p: tenergy.total_energy(p, tff64, config=GBIS) + bias.energy(p, step), pos)
        np.testing.assert_allclose(ours.numpy(), want.numpy(), rtol=0, atol=1e-4)
    solvent_only = tfused.campaign_solvent_forces_reference(pos, tab, GB_CONSTS, None)
    np.testing.assert_allclose(
        solvent_only.numpy(), tgb.gb_forces_reference(pos, tab.gb, GB_CONSTS)[0].numpy(), atol=1e-12)
    assert not tfused.campaign_solvent_forces_reference(pos, tab).any()


# -- one BAOAB step against the composed JAX step -------------------------------


@pytest.fixture(scope="module")
def jax_one_step(sysm):
    """(f0, pos, vel, forces) after one unconstrained T = 0 BAOAB step of 1 fs
    with autograd forces of the JAX energy, float64, per config."""
    jff64, _ = jax_system("full_da", f64=True)
    dt = 1.0 / tunits.TIMEFACTOR
    c1 = float(np.exp(-1.0 * (tunits.TIMEFACTOR / 1000.0) * dt))
    m = np.asarray(jff64.masses)[:, None]

    def run(cfg):
        # one jitted force, called at both ends of the step; the step's
        # arithmetic in numpy (float64 throughout)
        jforce = jax.jit(jax.vmap(
            lambda p: -jax.grad(lambda q: jenergy.total_energy(q, jff64, config=cfg))(p)))
        force = lambda p: np.asarray(jforce(jnp.asarray(p)))
        pos = np.asarray(sysm["pos_b"], np.float64)
        f0 = force(pos)
        vv = np.asarray(sysm["vel_b"], np.float64) + 0.5 * dt * f0 / m
        xx = pos + 0.5 * dt * vv
        vv = c1 * vv
        xx = xx + 0.5 * dt * vv
        f1 = force(xx)
        return [f0, xx, vv + 0.5 * dt * f1 / m, f1]

    return {"gb": run(jenergy.GBIS_POLAR_CONFIG), "gb+sasa": run(jenergy.GBIS_CONFIG)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("terms", ["gb", "gb+sasa"])
def test_campaign_step_with_solvent_matches_jax_composed(sysm, jax_one_step, terms, dtype):
    f0, jp, jv, jf = jax_one_step[terms]
    adv = tfused.make_fused_campaign_op(
        sysm["tff"], n_inner=1, dt_fs=1.0, temperature=0.0, gb=True,
        sasa=terms == "gb+sasa", **GBIS_OP,
    )
    tp, tv, tf = adv(t(sysm["pos_b"], dtype), t(sysm["vel_b"], dtype), t(f0, dtype), 0, 1)
    assert tp.dtype == dtype
    # float32: the JAX kernel's own pins; float64: what the float32 pair and
    # bonded tables leave (stiff bonds turn their 1e-7 into 1e-4 kcal/mol/A)
    tol_p, tol_v, tol_f = (1e-5, 5e-3, 0.15) if dtype == torch.float32 else (1e-8, 1e-6, 2e-4)
    np.testing.assert_allclose(tp.numpy(), jp, rtol=0, atol=tol_p)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=tol_v)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=tol_f)


# -- cadences -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_blocks(sysm):
    """The pieces a cadence block is rolled from, all of the JAX package and
    float64: ``-jax.grad`` of its energy without the solvent terms (+ bias at
    the step's starting index), of ``solvent.gb_energy`` and of
    ``solvent.sasa_energy``; its ``langevin_step`` and
    ``constrained_langevin_step`` at T = 0 and its RATTLE projection. Each is
    jitted once and vmapped over replicas; which solvent force a step adds is
    a traced 0/1 weight, so every cadence shares the compiled steps."""
    # the float32 parameters the port's tables are built from, widened
    jff = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        sysm["jff"])
    jcons = jconstraints.hydrogen_bond_constraints(jff)
    jb = jbias.HarmonicSMDBias.create(**sysm["bias_kw"])
    fast_cfg = jenergy.EnergyConfig(
        cutoff=GBIS.cutoff, switch_dist=GBIS.switch_dist, solvent_dielectric=GBIS.solvent_dielectric)
    gb = lambda p: -jax.grad(
        lambda q: jsolvent.gb_energy(q, jff, GBIS.solvent_dielectric, GBIS.ion_concentration))(p)
    sasa = lambda p: -jax.grad(lambda q: jsolvent.sasa_energy(q, jff, GBIS.surface_tension))(p)

    def step_of(with_cons):
        def one(pos, vel, frc, step, w_gb, w_sasa, held):
            force = lambda p, box: held + w_gb * gb(p) + w_sasa * sasa(p) - jax.grad(
                lambda q: jenergy.total_energy(q, jff, config=fast_cfg) + jb.energy(q, step))(p)
            st = jsystem.system_init(
                pos, vel=vel, key=jax.random.PRNGKey(0), dtype=jnp.float64
            ).replace(forces=frc, step=step)
            if with_cons:
                st = jconstraints.constrained_langevin_step(
                    st, force, jff.masses, jcons, 2.0, 0.0, 1.0, n_iter=30)
            else:
                st = jintegrate.langevin_step(st, force, jff.masses, 2.0, 0.0, 1.0)
            return st.pos, st.vel, st.forces

        return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, None, None, None, 0)))

    return dict(
        step={False: step_of(False), True: step_of(True)},
        slow=jax.jit(jax.vmap(lambda p, w_sasa: gb(p) + w_sasa * sasa(p), in_axes=(0, None))),
        sasa=jax.jit(jax.vmap(sasa)),
        rattle=jax.jit(jax.vmap(
            lambda v, p: jconstraints.apply_velocity_constraints(v, p, jcons, 15))),
        m=np.asarray(jff.masses)[:, None],
    )


def _rolled_from_jax(jx, sysm, n_inner, sasa_every, gb_every, use_sasa, with_cons, f0):
    """The two cadence structures written out block by block over the JAX
    pieces of ``jax_blocks``: the impulse block of ``gb_every`` (slow force
    peeled off the incoming total, half-block kicks of ``0.5 k dt`` each
    followed by RATTLE, k fast steps between, slow force put back at the end)
    and the held-force block of ``sasa_every`` (LCPO force of the block's
    first positions added to each of its steps)."""
    dt = 2.0 / tunits.TIMEFACTOR
    pos, vel = jnp.asarray(sysm["pos_b"], jnp.float64), jnp.asarray(sysm["vel_b"], jnp.float64)
    frc = jnp.asarray(f0.numpy())
    zero = jnp.zeros_like(pos)
    step_fn = jx["step"][with_cons]
    step = 0

    def kick(vel, pos, slow, k):
        vel = vel + 0.5 * k * dt * slow / jx["m"]
        return jx["rattle"](vel, pos) if with_cons else vel

    if gb_every > 1:
        sasa_is_slow = use_sasa and sasa_every > 1
        w_slow = 1.0 if sasa_is_slow else 0.0
        w_fast = 1.0 if (use_sasa and not sasa_is_slow) else 0.0
        slow = jx["slow"](pos, w_slow)
        frc = frc - slow
        for _ in range(n_inner // gb_every):
            vel = kick(vel, pos, slow, gb_every)
            for _ in range(gb_every):
                pos, vel, frc = step_fn(pos, vel, frc, step, 0.0, w_fast, zero)
                step += 1
            slow = jx["slow"](pos, w_slow)
            vel = kick(vel, pos, slow, gb_every)
        frc = frc + slow
    elif sasa_every == 1:  # no block: every force at the step's new positions
        for step in range(n_inner):
            pos, vel, frc = step_fn(pos, vel, frc, step, 1.0, float(use_sasa), zero)
    else:
        for _ in range(n_inner // sasa_every):
            held = jx["sasa"](pos)
            for _ in range(sasa_every):
                pos, vel, frc = step_fn(pos, vel, frc, step, 1.0, 0.0, held)
                step += 1
    return [np.asarray(x) for x in (pos, vel, frc)]


CADENCES = {
    "sasa_every=2": dict(sasa_every=2),
    "sasa_every=4": dict(sasa_every=4),
    "gb_every=2": dict(gb_every=2),
    "gb_every=2,sasa_every=2": dict(gb_every=2, sasa_every=2),
    "gb_every=4,polar": dict(gb_every=4, sasa=False),
}


@pytest.mark.parametrize("with_cons", [False, True], ids=["free", "constrained"])
@pytest.mark.parametrize("case", list(CADENCES))
def test_cadence_blocks_match_blocks_rolled_from_jax(sysm, jax_blocks, case, with_cons):
    """Both cadence structures of the port's op against the same blocks
    rolled from the JAX package's force functions and integrator steps
    (``_rolled_from_jax``; the JAX campaign kernel itself, in interpret mode
    with GB and SASA, takes minutes a call here)."""
    kw = dict(CADENCES[case])
    use_sasa = kw.pop("sasa", True)
    adv = tfused.make_fused_campaign_op(
        sysm["tff"], n_inner=4, dt_fs=2.0, temperature=0.0, bias=sysm["tbias"],
        constraints=sysm["tcons"] if with_cons else None, shake_iters=30, rattle_iters=15,
        gb=True, sasa=use_sasa, **GBIS_OP, **kw,
    )
    s = adv.settings
    pos, vel = t(sysm["pos_b"]).double(), t(sysm["vel_b"]).double()
    f0 = tfused.campaign_forces_reference(
        pos, adv.tables, s["pair_consts"], s["bias_consts"], 0, s["gb_consts"], s["surface_tension"])
    got = adv(pos, vel, f0, 0, 1)
    want = _rolled_from_jax(
        jax_blocks, sysm, 4, kw.get("sasa_every", 1), kw.get("gb_every", 1), use_sasa, with_cons, f0)
    plain = tfused.make_fused_campaign_op(
        sysm["tff"], n_inner=4, dt_fs=2.0, temperature=0.0, bias=sysm["tbias"],
        constraints=sysm["tcons"] if with_cons else None, shake_iters=30, rattle_iters=15,
        gb=True, sasa=use_sasa, **GBIS_OP,
    )(pos, vel, f0, 0, 1)
    # float64 on both sides and the same float32-representable parameters;
    # what is left is the port's float32 pair and bonded tables: 6e-9 A,
    # 8e-8 and 6e-6 kcal/mol/A measured over these 4 steps. Holding the LCPO
    # force for 2 steps moves positions by 3e-6 A, so a cadence off by one
    # step stands 100 times above the tolerance
    for ours, theirs, tol in zip(got, want, (2e-8, 3e-7, 2e-5)):
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=tol)
    # and the cadence matters: the every-step op gives another trajectory
    assert float((plain[0] - got[0]).abs().max()) > 2e-6


def test_cadence_one_is_the_plain_path_and_stale_cadences_are_ignored(sysm):
    kw = dict(n_inner=3, dt_fs=2.0, temperature=300.0, bias=sysm["tbias"],
              constraints=sysm["tcons"], gb=True, **GBIS_OP)
    pos, vel = t(sysm["pos_b"]), t(sysm["vel_b"])
    f0 = tenergy.force_fn(GBIS)(pos, sysm["tff"])
    base = tfused.make_fused_campaign_op(sysm["tff"], sasa=True, **kw)(pos, vel, f0, 5, 9)
    ones = tfused.make_fused_campaign_op(
        sysm["tff"], sasa=True, sasa_every=1, gb_every=1, **kw)(pos, vel, f0, 5, 9)
    assert all(torch.equal(a, b) for a, b in zip(base, ones))
    # a cadence of a term that is off is dropped, as the JAX op drops it
    polar = tfused.make_fused_campaign_op(sysm["tff"], sasa=False, **kw)
    stale = tfused.make_fused_campaign_op(sysm["tff"], sasa=False, sasa_every=7, **kw)
    assert stale.settings["sasa_every"] == 1
    assert all(torch.equal(a, b) for a, b in zip(polar(pos, vel, f0, 5, 9), stale(pos, vel, f0, 5, 9)))
    vac = tfused.make_fused_campaign_op(sysm["tff"], n_inner=3, gb_every=2)
    assert vac.settings["gb_every"] == 1 and vac.settings["gb_consts"] is None
    # 3 steps in one call = 1 + 2 with GB and SASA on (noise keyed on t0 + i)
    one = tfused.make_fused_campaign_op(sysm["tff"], sasa=True, **{**kw, "n_inner": 1})
    two = tfused.make_fused_campaign_op(sysm["tff"], sasa=True, **{**kw, "n_inner": 2})
    split = two(*one(pos, vel, f0, 5, 9), 6, 9)
    assert all(torch.equal(a, b) for a, b in zip(base, split))


@pytest.mark.parametrize(
    "kw, match",
    [
        (dict(sasa=True, sasa_every=0), "sasa_every must be >= 1"),
        (dict(sasa=True, sasa_every=7), "sasa_every=7 must divide n_inner=50"),
        (dict(gb_every=0), "gb_every must be >= 1"),
        (dict(gb_every=3), "gb_every=3 must divide n_inner=50"),
        (dict(sasa=True, sasa_every=5, gb_every=2), "combined cadences must align"),
    ],
)
def test_invalid_cadences_raise(sysm, kw, match):
    with pytest.raises(ValueError, match=match):
        tfused.make_fused_campaign_op(sysm["tff"], n_inner=50, gb=True, **kw)


def test_cpu_tensors_take_the_plain_versions(sysm):
    pos = t(sysm["pos_b"])
    gt, st = tgb.build_gb_tables(sysm["tff"]), tsasa.build_sasa_tables(sysm["tff"])
    before = tgb.gb_forces.launches, tsasa.sasa_forces.launches, tfused.campaign_advance.launches
    for a, b in zip(tgb.gb_forces(pos, gt, GB_CONSTS), tgb.gb_forces_reference(pos, gt, GB_CONSTS)):
        assert torch.equal(a, b)
    for a, b in zip(tsasa.sasa_forces(pos, st, 0.005), tsasa.sasa_forces_reference(pos, st, 0.005)):
        assert torch.equal(a, b)
    adv = tfused.make_fused_campaign_op(sysm["tff"], n_inner=1, temperature=0.0, gb=True, sasa=True)
    assert adv.shared_bytes == tfused.campaign_shared_bytes(104, 183, 273, 0, gb=True, n_sasa=51)
    assert all(o.shape == pos.shape for o in adv(pos, t(sysm["vel_b"]), torch.zeros_like(pos), 0, 1))
    after = tgb.gb_forces.launches, tsasa.sasa_forces.launches, tfused.campaign_advance.launches
    assert before == after == (0, 0, 0)


# -- the slice as a whole -------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    jff, _ = jax_system("full_da", f64=False)
    tff, _ = torch_system("full_da", f64=False)
    pos = minimized_full_da()
    vel = thermal_velocities(np.asarray(jff.masses), 1, seed=14)[0]
    d0 = float(np.linalg.norm(pos[-1] - pos[0]))
    bkw = dict(n_atoms=104, group1=[0], group2=[103], fk=1.0, cent_0=d0, cent_1=d0 + 22.0, T=500_000.0)
    jb = jbias.HarmonicSMDBias.create(**bkw)
    tb = tbias.HarmonicSMDBias.create(device="cpu", **bkw)
    # the start's forces from the port's energy, the same numbers for both
    tforce = lambda p, b: tenergy._neg_grad(
        lambda q: tenergy.total_energy(q, tff, config=GBIS) + tb.energy(q, 0), p)
    tst = tintegrate.initialize_forces(tsystem.system_init(pos, vel=vel, device="cpu", key=1), tforce)
    jst = jsystem.system_init(jnp.asarray(pos), vel=jnp.asarray(vel), key=jax.random.PRNGKey(1))
    jst = jst.replace(forces=jnp.asarray(tst.forces.numpy()))
    return dict(jff=jff, tff=tff, jb=jb, tb=tb, jens=jsystem.replicate(jst, R, seed=3),
                tens=tsystem.replicate(tst, R, seed=3))


#: the composed GBIS run both packages are held to below: T = 0, rigid X-H
COMPOSED_GBIS = dict(dt_fs=2.0, temperature=0.0, constrain_h_bonds=True)


@pytest.fixture(scope="module")
def jax_gbis_composed(world):
    """The JAX ``simulate_ensemble`` under GBIS_CONFIG on its composed path
    (``COMPOSED_GBIS``, 2 saves of 2 steps), run once for the tests that
    hold the port's campaign op and its composed path to it."""
    return jsim.simulate_ensemble(
        world["jens"], world["jff"], n_steps=4, save_every=2,
        config=jsim.SimulationConfig(energy=jenergy.GBIS_CONFIG, **COMPOSED_GBIS), bias=world["jb"])


def test_simulate_ensemble_gbis_campaign_matches_jax_composed(world, jax_gbis_composed):
    """``simulate_ensemble`` under GBIS_CONFIG with ``fused_campaign=True``
    (T = 0, rigid X-H, 4 replicas, 2 saves of 2 steps) against the JAX
    ``simulate_ensemble`` on its composed path (``fused_campaign=False``,
    same config): the JAX campaign kernel with GB and SASA in interpret mode
    takes minutes here, its composed path seconds. Frames within 1e-4 A."""
    jfinal, jframes, jlog = jax_gbis_composed
    tfinal, tframes, tlog = tsim.simulate_ensemble(
        world["tens"], world["tff"], n_steps=4, save_every=2,
        config=tsim.SimulationConfig(energy=GBIS, fused_campaign=True, **COMPOSED_GBIS),
        bias=world["tb"],
    )
    assert tuple(tframes.shape) == jframes.shape == (2, R, 104, 3)
    np.testing.assert_allclose(tframes.numpy(), np.asarray(jframes), atol=1e-4)
    np.testing.assert_allclose(tfinal.vel.numpy(), np.asarray(jfinal.vel), atol=5e-3)
    np.testing.assert_allclose(tfinal.forces.numpy(), np.asarray(jfinal.forces), atol=0.15)
    assert tfinal.step.tolist() == [4] * R
    for key in ("epot", "ekin", "colvar_value", "colvar_energy"):
        np.testing.assert_allclose(
            tlog[key].numpy(), np.asarray(jlog[key]), rtol=2e-3, atol=2e-3, err_msg=key)


def _start_both(pos, vel, tff, tb):
    """Two replicas of one start in both packages, with the start's forces
    (GBIS_CONFIG + the bias at step 0) from the port's energy: the same
    numbers on both sides."""
    f0 = tenergy._neg_grad(
        lambda q: tenergy.total_energy(q, tff, config=GBIS) + tb.energy(q, 0), t(pos))
    jst = jsystem.system_init(jnp.asarray(pos), vel=jnp.asarray(vel), key=jax.random.PRNGKey(1))
    jens = jsystem.replicate(jst.replace(forces=jnp.asarray(f0.numpy())), 2, seed=3)
    tens = tsystem.replicate(tsystem.system_init(
        pos, vel=vel, device="cpu", key=1).replace(forces=f0), 2, seed=3)
    return jens, tens


def test_simulate_ensemble_gbis_campaign_416_atoms_matches_jax_composed():
    """The 416-atom tier (four copies 50 A apart) through the campaign op's
    512-thread instantiation, which evaluates the GB derivatives again
    instead of caching them: ``simulate_ensemble`` under GBIS_CONFIG with
    ``fused_campaign=True`` (T = 0, rigid X-H, 2 replicas, 2 steps, the SMD
    bias on copy 0's ends) against the JAX ``simulate_ensemble`` on its
    composed path, from the same state, as at 104 atoms: frames within 1e-4
    A. On the CPU the op runs its plain version, which the kernel is held
    against on the card."""
    from molecular_dynamics_tpu.examples import tiled_decaalanine as jtiled
    from torch_parity import ff_to_numpy
    from molecular_dynamics_tpu_torch import convert as tconvert

    jff, _, _ = jtiled(4, dtype=jnp.float32)
    tff = tconvert.ff_params_from_numpy(ff_to_numpy(jff), device="cpu", dtype=torch.float32)
    pos = np.concatenate([minimized_full_da() + np.float32([50.0 * k, 0.0, 0.0]) for k in range(4)])
    vel = thermal_velocities(np.asarray(jff.masses), 1, seed=15)[0]
    d0 = float(np.linalg.norm(pos[103] - pos[0]))
    bkw = dict(n_atoms=416, group1=[0], group2=[103], fk=1.0, cent_0=d0, cent_1=d0 + 22.0, T=500_000.0)
    jb = jbias.HarmonicSMDBias.create(**bkw)
    tb = tbias.HarmonicSMDBias.create(device="cpu", **bkw)
    jens, tens = _start_both(pos, vel, tff, tb)
    kw = dict(dt_fs=2.0, temperature=0.0, constrain_h_bonds=True)
    cfg = tsim.SimulationConfig(energy=GBIS, fused_campaign=True, **kw)
    assert tsim.campaign_holds(tff, cfg)
    jfinal, jframes, _ = jsim.simulate_ensemble(
        jens, jff, n_steps=2, save_every=2,
        config=jsim.SimulationConfig(energy=jenergy.GBIS_CONFIG, **kw), bias=jb)
    calls = []
    real = tfused.campaign_advance_reference
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfused, "campaign_advance_reference", lambda *a, **k: calls.append(1) or real(*a, **k))
        tfinal, tframes, _ = tsim.simulate_ensemble(tens, tff, n_steps=2, save_every=2, config=cfg, bias=tb)
    assert calls == [1] and tuple(tframes.shape) == jframes.shape == (1, 2, 416, 3)
    np.testing.assert_allclose(tframes.numpy(), np.asarray(jframes), atol=1e-4)
    np.testing.assert_allclose(tfinal.vel.numpy(), np.asarray(jfinal.vel), atol=5e-3)
    np.testing.assert_allclose(tfinal.forces.numpy(), np.asarray(jfinal.forces), atol=0.15)


@functools.lru_cache(maxsize=None)
def minimized_diala() -> np.ndarray:
    """FIRE-minimised float32 coordinates of the 22-atom di-alanine under
    the reference config (300 steps, the campaign's settings), from the
    port's minimiser."""
    from molecular_dynamics_tpu_torch.energy import force_fn
    from molecular_dynamics_tpu_torch.integrate import minimize_fire

    tff, coords = torch_system("diala", f64=False)
    force = force_fn()
    return minimize_fire(torch.as_tensor(coords, dtype=torch.float32), lambda p: force(p, tff),
                         n_steps=300, dt_start=1e-3, dt_max=1e-2).numpy()


def grid_offsets(m: int, spacing: float = 50.0) -> np.ndarray:
    """Offsets ``(m, 3)`` of ``m`` copies on a cubic grid ``spacing`` A apart
    about the origin (at most 27). In a line along x, 23 copies reach 1,100
    A, where float32 resolves 1.2e-4 A, more than the 1e-4 A the trajectories
    are held to; on the grid they stay within 50 A of the origin."""
    ax = spacing * (np.arange(3) - 1.0)
    return np.stack(np.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)[:m]


def test_simulate_ensemble_gbis_campaign_506_atoms_matches_jax_composed():
    """The 506-atom tiled di-alanine (23 copies on a grid 50 A apart, 230
    heavy atoms),
    whose LCPO lists the campaign kernel keeps in a global workspace:
    ``simulate_ensemble`` under GBIS_CONFIG with ``fused_campaign=True`` (T =
    0, rigid X-H, 2 replicas, 2 steps, the SMD bias on copy 0 between its
    first and last heavy atom) runs the campaign op without a warning, and
    its frames equal the JAX ``simulate_ensemble`` on its composed path from
    the same state within 1e-4 A, as at 416 atoms."""
    import warnings

    from molecular_dynamics_tpu.examples import dialanine as jdiala
    from molecular_dynamics_tpu.ff.params import tile_ff_params as jtile
    from torch_parity import ff_to_numpy
    from molecular_dynamics_tpu_torch import convert as tconvert

    jff = jtile(jdiala(dtype=jnp.float32)[0], 23)
    tff = tconvert.ff_params_from_numpy(ff_to_numpy(jff), device="cpu", dtype=torch.float32)
    one = minimized_diala()
    pos = (grid_offsets(23)[:, None] + (one - one.mean(0))).reshape(-1, 3).astype(np.float32)
    heavy = np.flatnonzero(np.asarray(jff.sasa_radii)[:22] > 0)
    g1, g2 = int(heavy[0]), int(heavy[-1])
    vel = thermal_velocities(np.asarray(jff.masses), 1, seed=16)[0]
    d0 = float(np.linalg.norm(pos[g2] - pos[g1]))
    bkw = dict(n_atoms=506, group1=[g1], group2=[g2], fk=1.0, cent_0=d0, cent_1=d0 + 22.0,
               T=500_000.0)
    jb = jbias.HarmonicSMDBias.create(**bkw)
    tb = tbias.HarmonicSMDBias.create(device="cpu", **bkw)
    jens, tens = _start_both(pos, vel, tff, tb)
    kw = dict(dt_fs=2.0, temperature=0.0, constrain_h_bonds=True)
    cfg = tsim.SimulationConfig(energy=GBIS, fused_campaign=True, **kw)
    assert tsim.campaign_holds(tff, cfg)
    jfinal, jframes, _ = jsim.simulate_ensemble(
        jens, jff, n_steps=2, save_every=2,
        config=jsim.SimulationConfig(energy=jenergy.GBIS_CONFIG, **kw), bias=jb)
    calls = []
    real = tfused.campaign_advance_reference
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("error")
        mp.setattr(tfused, "campaign_advance_reference", lambda *a, **k: calls.append(1) or real(*a, **k))
        tfinal, tframes, _ = tsim.simulate_ensemble(tens, tff, n_steps=2, save_every=2, config=cfg, bias=tb)
    assert calls == [1] and tuple(tframes.shape) == jframes.shape == (1, 2, 506, 3)
    np.testing.assert_allclose(tframes.numpy(), np.asarray(jframes), atol=1e-4)
    np.testing.assert_allclose(tfinal.vel.numpy(), np.asarray(jfinal.vel), atol=5e-3)
    np.testing.assert_allclose(tfinal.forces.numpy(), np.asarray(jfinal.forces), atol=0.15)


@pytest.mark.parametrize("energy, m", [(GBIS, 5), (tenergy.GBIS_POLAR_CONFIG, 6)],
                         ids=["gbis_520_atoms", "polar_624_atoms"])
def test_campaign_dispatch_by_size_warns_and_runs_composed(energy, m):
    """A system the campaign kernel does not hold (520 atoms under
    GBIS_CONFIG, 624 under GBIS_POLAR_CONFIG: past the 512 atoms of the
    solvent instantiation, as the JAX kernel is past its design point)
    makes ``simulate_ensemble(fused_campaign=True)`` warn and run the
    composed path, decided by ``campaign_holds`` before anything is built:
    its trajectory equals ``fused_campaign=False`` bit for bit (T = 0, 2
    replicas, 2 steps). The same op called directly still raises."""
    from molecular_dynamics_tpu_torch.examples import tiled_decaalanine

    ff, coords, _ = tiled_decaalanine(m, device="cpu")
    ens = tsystem.replicate(tsystem.system_init(coords, device="cpu", key=1), 2, seed=3)
    cfg = tsim.SimulationConfig(energy=energy, fused_campaign=True, temperature=0.0, dt_fs=1.0)
    assert not tsim.campaign_holds(ff, cfg)
    built = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfused, "build_campaign_tables", lambda *a, **k: built.append(1))
        with pytest.warns(UserWarning, match=f"does not hold this system \\({104 * m} atoms"):
            flagged = tsim.simulate_ensemble(ens, ff, n_steps=2, save_every=2, config=cfg)
    plain = tsim.simulate_ensemble(ens, ff, n_steps=2, save_every=2,
                                   config=dataclasses.replace(cfg, fused_campaign=False))
    assert built == []
    assert torch.equal(flagged[1], plain[1]) and torch.equal(flagged[0].forces, plain[0].forces)
    with pytest.raises(ValueError, match="the kernel holds"):
        tfused.make_fused_campaign_op(ff, gb=True, sasa="sasa" in energy.terms)


@pytest.mark.parametrize(
    "cfg_kw",
    [dict(), dict(sasa_every=2), dict(gb_every=2, sasa_every=2), dict(energy=tenergy.GBIS_POLAR_CONFIG, gb_every=2)],
    ids=["every_step", "sasa_every=2", "gb_every=2", "polar,gb_every=2"],
)
def test_simulate_ensemble_gbis_runs_and_logs_solvent_energy(world, cfg_kw):
    cfg = tsim.SimulationConfig(**{
        **dict(energy=GBIS, fused_campaign=True, constrain_h_bonds=True, dt_fs=2.0), **cfg_kw})
    final, frames, log = tsim.simulate_ensemble(
        world["tens"], world["tff"], n_steps=4, save_every=2, config=cfg, bias=world["tb"])
    assert bool(torch.isfinite(frames).all()) and final.step.tolist() == [4] * R
    assert float((frames[-1, 0] - frames[-1, 1]).abs().max()) > 1e-5  # 300 K noise
    # epot carries GB (+ SASA): far below the vacuum energy of the same frames
    vacuum = tenergy.total_energy(frames[-1], world["tff"], config=tenergy.EnergyConfig(
        cutoff=16.0, switch_dist=15.0, solvent_dielectric=80.0))
    assert float((log["epot"][-1] - vacuum).max()) < -20.0
    pairs = tcons.hydrogen_bond_constraints(world["tff"])
    d = torch.linalg.norm(frames[-1][:, pairs.pairs[:, 0]] - frames[-1][:, pairs.pairs[:, 1]], dim=-1)
    assert float((d - pairs.lengths).abs().max()) < 1e-5


def test_smd_campaign_config_implicit_solvent_is_runnable(world):
    cfg, colvar = tsim.smd_campaign_config(implicit_solvent=True)
    assert cfg.energy == GBIS and cfg.fused_campaign and cfg.constrain_h_bonds
    _, frames, _ = tsim.simulate_ensemble(
        world["tens"], world["tff"], n_steps=2, save_every=2,
        config=dataclasses.replace(cfg, sasa_every=2), bias=world["tb"])
    assert bool(torch.isfinite(frames).all()) and colvar["save_every"] == 50
    with pytest.raises(ValueError, match="sasa_every=7 must divide n_inner=50"):
        tsim.simulate_ensemble(
            world["tens"], world["tff"], n_steps=50, save_every=50,
            config=dataclasses.replace(cfg, sasa_every=7), bias=world["tb"])


# -- the dispatch repair ---------------------------------------------------------------

_D = tenergy.DEFAULT_TERMS


@pytest.mark.parametrize(
    "terms",
    [
        _D + ("sasa",),
        ("gb", "sasa"),
        ("bonds", "angles", "gb"),
        tuple(x for x in _D if x != "impropers") + ("gb", "sasa"),
    ],
    ids=["default+sasa", "gb+sasa_alone", "reduced+gb", "no_impropers+gb+sasa"],
)
def test_fused_campaign_refuses_uncovered_term_sets(world, terms):
    """A term set that merely contains gb or sasa is not covered: only the
    default set, default + gb and default + gb + sasa are. The campaign
    refuses it before anything is built, warns, and the run is the unflagged
    composed one bit for bit (300 K: both draw the same noise stream), as
    the JAX package dispatches it (fault C11)."""
    cfg = tsim.SimulationConfig(fused_campaign=True, energy=tenergy.EnergyConfig(terms=terms))
    run = lambda c: tsim.simulate_ensemble(world["tens"], world["tff"], n_steps=2, save_every=2, config=c)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfused, "build_campaign_tables", lambda *a, **k: pytest.fail("built the campaign op"))
        with pytest.warns(UserWarning, match="does not cover the term set"):
            flagged = run(cfg)
    plain = run(dataclasses.replace(cfg, fused_campaign=False))
    assert torch.equal(flagged[1], plain[1]) and torch.equal(flagged[0].forces, plain[0].forces)


@pytest.mark.parametrize("cname", ["GBIS_CONFIG", "GBIS_POLAR_CONFIG"])
def test_kernel_flags_and_solvent_term_sets(world, cname):
    ecfg = getattr(tenergy, cname)
    # fused_nonbonded covers the default terms only: with a solvent term set
    # it warns and the step is the unflagged one, bit for bit (fault C11)
    run = lambda **kw: tsim.simulate_ensemble(
        world["tens"], world["tff"], n_steps=2, save_every=2,
        config=tsim.SimulationConfig(energy=ecfg, **kw))
    with pytest.warns(UserWarning, match="fused_nonbonded requested, but .* the term set"):
        flagged = run(fused_nonbonded=True)
    plain = run()
    assert torch.equal(flagged[1], plain[1]) and torch.equal(flagged[0].forces, plain[0].forces)
    # the campaign covers it only with GB tables on the force field
    bare = dataclasses.replace(
        world["tff"], gb_radii=None, gb_screen=None, sasa_radii=None, sasa_params=None)
    with pytest.raises(ValueError, match="GB tables"):
        tsim.simulate_ensemble(
            world["tens"], bare, n_steps=2, save_every=2,
            config=tsim.SimulationConfig(fused_campaign=True, energy=ecfg))
    with pytest.raises(ValueError, match="gb=True needs GB tables"):
        tfused.make_fused_campaign_op(bare, gb=True)
    with pytest.raises(ValueError, match="sasa=True needs LCPO tables"):
        tfused.make_fused_campaign_op(bare, sasa=True)


# -- the composed path: analytic solvent forces -------------------------------------


@pytest.mark.parametrize("cname", ["GBIS_CONFIG", "GBIS_POLAR_CONFIG"])
def test_composed_step_takes_analytic_solvent_forces_unless_differentiated(
    world, cname, monkeypatch
):
    """Without a graph the composed step takes the GB (+ LCPO) forces from
    ``gb_forces``/``sasa_forces`` and the rest from autograd; positions that
    require grad keep every force on autograd and the step stays
    differentiable. Both give the same step: 1e-9 A in float64."""
    ecfg = getattr(tenergy, cname)
    tff = world["tff"].to(dtype=torch.float64)
    cfg = tsim.SimulationConfig(dt_fs=2.0, temperature=0.0, constrain_h_bonds=True, energy=ecfg)
    step_fn = tsim.make_ensemble_step_fn(tff, cfg)
    ens = world["tens"]
    ens = ens.replace(pos=ens.pos.double(), vel=ens.vel.double(), forces=ens.forces.double())
    calls = []
    real = tgb.gb_forces_reference
    monkeypatch.setattr(tgb, "gb_forces_reference", lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        analytic = step_fn(ens)
    assert len(calls) == 1
    leaf = ens.pos.clone().requires_grad_(True)
    graph = step_fn(ens.replace(pos=leaf))
    assert len(calls) == 1 and not analytic.pos.requires_grad
    (dpos,) = torch.autograd.grad(graph.pos.sum(), leaf)
    assert bool(torch.isfinite(dpos).all()) and float(dpos.abs().max()) > 0.5
    np.testing.assert_allclose(analytic.pos.numpy(), graph.pos.detach().numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(analytic.forces.numpy(), graph.forces.detach().numpy(), rtol=0, atol=1e-6)


def test_composed_gbis_path_matches_jax_composed(world, jax_gbis_composed):
    """``simulate_ensemble`` on the composed path (``fused_campaign=False``)
    under GBIS_CONFIG, T = 0, rigid X-H, float32, against the JAX package's
    composed path: frames within 1e-4 A over 4 steps."""
    _, jframes, jlog = jax_gbis_composed
    final, tframes, tlog = tsim.simulate_ensemble(
        world["tens"], world["tff"], n_steps=4, save_every=2,
        config=tsim.SimulationConfig(energy=GBIS, **COMPOSED_GBIS), bias=world["tb"])
    np.testing.assert_allclose(tframes.numpy(), np.asarray(jframes), atol=1e-4)
    np.testing.assert_allclose(tlog["epot"].numpy(), np.asarray(jlog["epot"]), rtol=2e-3, atol=2e-3)
    assert final.step.tolist() == [4] * R


def test_composed_path_without_gb_tables_raises(world):
    bare = dataclasses.replace(
        world["tff"], gb_radii=None, gb_screen=None, sasa_radii=None, sasa_params=None)
    with pytest.raises(ValueError, match="GB tables"):
        tsim.simulate_ensemble(
            world["tens"], bare, n_steps=2, save_every=2, config=tsim.SimulationConfig(energy=GBIS))


# -- which solvent forces the unflagged step takes analytic (fault C8) ----------------


@pytest.mark.parametrize("m", [1, 2, 4], ids=["104_atoms", "208_atoms", "416_atoms"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_solvent_kernel_predicates(m, dtype):
    """The GB kernel holds float32 with its dI cache up to 236 atoms and
    without it up to 6,456 (36 bytes an atom), the LCPO kernel float32 up to
    the heavy-atom count whose per-atom scratch, coordinates and forces fit
    a CTA's shared memory (804 heavy atoms of deca-alanine's mix), with its
    lists beside them where they fit too (204 heavy atoms of the 416-atom
    system do) and in global memory where not (230 of the 506-atom tiled
    di-alanine); a CPU input goes to the plain versions at any dtype and
    size. Deca-alanine has 51 heavy atoms a copy."""
    n, nc = 104 * m, 51 * m
    f32 = dtype == torch.float32
    assert tgb.gb_forces_holds("cuda", dtype, n) == f32
    assert tsasa.sasa_forces_holds("cuda", dtype, n, nc) == f32
    assert tgb.gb_forces_holds("cpu", dtype, n) and tsasa.sasa_forces_holds("cpu", dtype, n, nc)
    assert not tsasa.sasa_lists_global(n, nc)
    for n_k, nc_k, lists_global in ((506, 230, True), (1640, 804, True), (1644, 806, True)):
        assert tsasa.sasa_lists_global(n_k, nc_k) == lists_global == (
            tsasa.sasa_shared_bytes(nc_k) + 24 * n_k > SHARED_OPT_IN_BYTES)
        assert tsasa.sasa_forces_holds("cuda", dtype, n_k, nc_k) == (f32 and nc_k <= 804) == (
            f32 and tsasa.sasa_shared_bytes(nc_k, lists_global=True) + 24 * n_k
            <= SHARED_OPT_IN_BYTES)
    # the size rule is the shared memory a CTA may opt in to, in one place
    cached = tgb.gb_cached(n)
    assert cached == (n <= tgb.GB_CACHE_MAX_ATOMS)
    assert tgb.gb_forces_holds("cuda", torch.float32, n) == (
        tgb.gb_shared_bytes(n, cached) + 24 * n <= SHARED_OPT_IN_BYTES)
    assert tgb.gb_shared_bytes(n, False) == 12 * n < tgb.gb_shared_bytes(n, True)
    assert tgb.GB_CACHE_MAX_ATOMS <= 236 and tgb.gb_shared_bytes(236) + 24 * 236 <= SHARED_OPT_IN_BYTES
    assert not tgb.gb_shared_bytes(237) + 24 * 237 <= SHARED_OPT_IN_BYTES
    assert tgb.gb_forces_holds("cuda", torch.float32, 6456)
    assert not tgb.gb_forces_holds("cuda", torch.float32, 6457)


def test_unflagged_gbis_step_off_the_kernels_matches_jax(world, monkeypatch):
    """With both predicates false (what a float64 CUDA state, or one above the
    kernels' sizes, gives) the unflagged step takes the GB and LCPO forces
    from autograd of the energy and never calls the analytic wrappers; three
    float64 steps under GBIS_CONFIG (T = 0, 2 replicas, no constraints, so
    that only the forces can differ) agree with JAX ``make_ensemble_step_fn``
    from the same state to 1e-9 A."""
    jff64, _ = jax_system("full_da", f64=True)
    tff64, _ = torch_system("full_da", f64=True)
    pos = minimized_full_da().astype(np.float64)
    vel = thermal_velocities(np.asarray(jff64.masses), 2, seed=21).astype(np.float64)
    # the start's forces from the port's float64 energy, for both packages
    f0 = tenergy.force_fn(GBIS)(torch.as_tensor(np.stack([pos, pos])), tff64).numpy()
    kw = dict(dt_fs=2.0, temperature=0.0)
    jst = jsystem.replicate(jsystem.system_init(
        jnp.asarray(pos), key=jax.random.PRNGKey(1), dtype=jnp.float64), 2, seed=3)
    jst = jst.replace(vel=jnp.asarray(vel), forces=jnp.asarray(f0))
    jstep = jax.jit(jsim.make_ensemble_step_fn(
        jff64, jsim.SimulationConfig(energy=jenergy.GBIS_CONFIG, **kw)))
    tst = tsystem.replicate(tsystem.system_init(
        torch.as_tensor(pos), device="cpu", key=1, dtype=torch.float64), 2, seed=3)
    tst = tst.replace(vel=torch.as_tensor(vel), forces=torch.as_tensor(f0))

    monkeypatch.setattr(tgb, "gb_forces_holds", lambda *a: False)
    monkeypatch.setattr(tsasa, "sasa_forces_holds", lambda *a: False)
    calls = []
    for mod, name in ((tgb, "gb_forces_reference"), (tsasa, "sasa_forces_reference")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real: calls.append(1) or real(*a))
    tstep = tsim.make_ensemble_step_fn(tff64, tsim.SimulationConfig(energy=GBIS, **kw))
    with torch.no_grad():
        for _ in range(3):
            jst, tst = jstep(jst), tstep(tst)
    assert calls == [] and tst.pos.dtype == torch.float64
    np.testing.assert_allclose(tst.pos.numpy(), np.asarray(jst.pos), rtol=0, atol=1e-9)
    np.testing.assert_allclose(tst.vel.numpy(), np.asarray(jst.vel), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tst.forces.numpy(), np.asarray(jst.forces), rtol=0, atol=1e-6)
