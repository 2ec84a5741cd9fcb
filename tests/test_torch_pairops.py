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
from molecular_dynamics_tpu_torch import units
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
    nothing; the pair-tile kernel runs a group for each pair of 4-chunk
    tiles."""
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
    # the dense-row kernel opts in above 48 KB: 4,096 atoms take 52 KB
    assert tnonbonded.nonbonded_rows_shared_bytes(4096) == 52224
    with pytest.raises(ValueError, match="CUDA"):
        tnonbonded.check_pair_kernel_inputs(t(pos).float(), tables)


# -- the per-atom pair layout of the campaign and pair-forces kernels ------------


@functools.lru_cache(maxsize=None)
def layout_case(m: int):
    """The port's pair tables of system ``systems(m)`` and the JAX package's
    dense tables of the same system (float32, n x n)."""
    from molecular_dynamics_tpu.ops import nonbonded as jnonbonded

    jff, tff, _ = systems(m)
    n = tff.n_atoms
    jtabs = [np.asarray(x)[:n, :n] for x in jnonbonded._build_pair_tables(jff, None, n)]
    return tnonbonded.build_pair_tables(tff), jtabs


@pytest.mark.parametrize("m", [1, 4])
def test_lj_types_reproduce_the_jax_tables(m):
    """The LJ tables factored into per-atom types give back every
    off-diagonal entry of the JAX package's lj_a / lj_b tables bit for bit,
    with 8 types for deca-alanine and its tiled copies."""
    tabs, jtabs = layout_case(m)
    lay = {k: v.numpy() for k, v in tabs.layout.items()}
    n = lay["lj_type"].shape[0]
    full = lay["lj_table"][lay["lj_type"][:, None], lay["lj_type"][None, :]]
    off = ~np.eye(n, dtype=bool)
    assert lay["lj_table"].shape == (8, 8, 2) and lay["lj_type"].dtype == np.int32
    assert np.array_equal(full[..., 0][off], jtabs[1][off])
    assert np.array_equal(full[..., 1][off], jtabs[2][off])
    # the charge product is the pair's qq to float32 rounding (ROADMAP C1)
    qq = lay["charge"][:, None] * lay["charge"][None, :]
    np.testing.assert_allclose(qq[off], np.triu(jtabs[0], 1)[off] + np.triu(jtabs[0], 1).T[off],
                               rtol=3e-7, atol=0)


@pytest.mark.parametrize("m", [1, 4])
def test_special_and_exclusion_lists(m):
    """The special pairs are exactly the pairs i < j with w >= 2 (a bond,
    Urey-Bradley or 1-4 entry of the JAX tables), with the tables' own
    numbers, and each atom's list holds exactly its special pairs, those
    where it is i first; the exclusion bits are set exactly where the pair
    is itself, special, masked (mask 0) or past the chunk or the end."""
    tabs, jtabs = layout_case(m)
    qq, aa, bb, msym, kb, d0, a14, b14, qq14 = jtabs
    lay = {k: v.numpy() for k, v in tabs.layout.items()}
    n = msym.shape[0]
    special = (kb > 0) | (a14 != 0) | (b14 != 0) | (qq14 != 0)
    i, j = lay["sp_idx"].T
    assert np.array_equal(np.stack(np.nonzero(np.triu(special, 1))), lay["sp_idx"].T)
    assert np.array_equal(lay["sp_a"], np.stack([qq[i, j], aa[i, j], bb[i, j], msym[i, j]], -1))
    assert np.array_equal(lay["sp_b"], np.stack([kb, d0, a14, b14], -1)[i, j])
    assert np.array_equal(lay["sp_c"], qq14[i, j])
    start, src = lay["sp_start"], lay["sp_src"]
    assert start[0] == 0 and start[-1] == len(src) == 2 * tabs.n_special
    for a in range(n):
        mine = src[start[a]:start[a + 1]]
        assert list(mine) == list(np.flatnonzero(i == a)) + list(np.flatnonzero(j == a))

    cs, nc = tnonbonded.chunk_size(n), tnonbonded.chunk_count(n)
    words = lay["excl"].view(np.uint32)
    assert words.shape == (n, nc) and cs * nc >= n > cs * (nc - 1)
    bits = (words[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    col = np.arange(nc)[:, None] * cs + np.arange(32)
    inside = (np.arange(32) < cs) & (col < n)
    skip = (msym == 0) | special | np.eye(n, dtype=bool)
    assert np.array_equal(bits[:, ~inside], np.ones((n, int((~inside).sum())), np.uint32))
    assert np.array_equal(bits[:, inside].astype(bool), skip[:, col[inside]])


def _layout_pair_math(pos, tabs, consts):
    """The 2-body sum the kernels' pair loop computes, from the layout alone:
    plain pairs from types, charges and exclusion bits, special pairs from
    their lists (the dense tables rebuilt and handed to the plain math)."""
    lay = tabs.layout
    n = pos.shape[-2]
    cs = tnonbonded.chunk_size(n)
    bits = (lay["excl"].long() & 0xFFFFFFFF)[..., None] >> torch.arange(32)
    col = torch.arange(tnonbonded.chunk_count(n))[:, None] * cs + torch.arange(32)
    inside = (torch.arange(32) < cs) & (col < n)
    skip = torch.ones(n, n, dtype=torch.bool)
    skip[:, col[inside]] = (bits[:, inside] & 1).bool()
    t_ = lay["lj_type"].long()
    dense = torch.zeros_like(tabs.dense)
    dense[0] = lay["charge"][:, None] * lay["charge"][None, :]
    dense[1:3] = lay["lj_table"][t_[:, None], t_[None, :]].permute(2, 0, 1)
    dense[3] = (~skip).to(dense.dtype)
    i, j = lay["sp_idx"].long().T
    for a, b in ((i, j), (j, i)):
        dense[0:4, a, b] = lay["sp_a"].T
        dense[4:8, a, b] = lay["sp_b"].T
        dense[8, a, b] = lay["sp_c"]
    return tnonbonded.dense_pair_math(pos, dense, consts)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("m", [1, 2, 4], ids=["104_atoms", "208_atoms", "416_atoms"])
def test_layout_pair_sum_matches_jax(m, case):
    """The layout carries every 2-body term: its pair sum in float64 against
    the JAX dense op's reference, to the float32 tables' 1e-4. Every pair
    kernel reads this layout; 416 atoms are 13 chunks, four tiles of the
    pair-tile kernel."""
    _, _, pos = systems(m)
    kw = CASES[case]
    tabs, _ = layout_case(m)
    e, f = _layout_pair_math(t(pos), tabs, tnonbonded.pair_constants(
        kw["cutoff"], kw["switch_dist"], kw["rfa"],
        kw.get("solvent_dielectric", units.SOLVENT_DIELECTRIC)))
    je, jf = jax_reference(m, case)
    np.testing.assert_allclose(f.numpy(), jf, atol=1e-4)
    if m <= 2:
        np.testing.assert_allclose(e.numpy(), je, atol=1e-4)
    else:
        # the energy is extensive: the float32 tables' error adds up over the
        # copies (5.4e-5 kcal/mol a copy at 16 A), so it is held a copy
        np.testing.assert_allclose(e.numpy() / m, je / m, atol=1e-4)


def test_layout_is_built_on_first_use():
    """The per-atom layout is built only when a kernel asks for it, once:
    the plain pair version and the campaign op's plain path on CPU tensors
    leave it unbuilt."""
    from molecular_dynamics_tpu_torch.ops import fused_step as tfused

    jff, tff, pos = systems(1)
    tabs = tnonbonded.build_pair_tables(tff)
    tring.pair_forces_reference(t(pos).float(), tabs)
    assert "layout" not in vars(tabs)
    op = tfused.make_fused_campaign_op(tff, n_inner=1, temperature=0.0)
    p0 = t(pos).float()[:1].contiguous()
    op(p0, torch.zeros_like(p0), torch.zeros_like(p0), 0, 1)
    assert "layout" not in vars(op.tables.pair)
    lay = tabs.layout
    assert tabs.layout is lay and tabs.n_lj_types == 8
    assert torch.equal(tabs.charges, tff.charges)


def _task_pairs(n, i_chunk, j_chunk):
    """The atom pairs (row, column) that one task (I, J) of the pair loop
    meets (``chunk_task`` in csrc/pair_loop.cuh): lane l of row chunk I
    against column (l + s) mod C at step s, on the diagonal the shifts
    1..C/2 with an even C's halfway shift on the lower half of the lanes."""
    cs = tnonbonded.chunk_size(n)
    lane = np.arange(cs)
    diag = i_chunk == j_chunk
    rows_out, cols_out = [], []
    for s in range(1, cs // 2 + 1) if diag else range(cs):
        rows = lane if not (diag and 2 * s == cs) else lane[: cs // 2]
        a, b = i_chunk * cs + rows, j_chunk * cs + (rows + s) % cs
        keep = (a < n) & (b < n)
        rows_out.append(a[keep])
        cols_out.append(b[keep])
    return np.concatenate(rows_out), np.concatenate(cols_out)


@pytest.mark.parametrize("n", [22, 40, 104, 416])
def test_pair_loop_schedule_meets_every_pair_once(n):
    """The pair loop's tasks as csrc/pair_loop.cuh runs them (the diagonal
    with its halfway shift, then the rounds of (I, I + k)) meet every
    unordered pair of atoms exactly once, and no round gives two tasks the
    same column chunk."""
    nc = tnonbonded.chunk_count(n)
    met = np.zeros((n, n), int)

    def task(i_chunk, j_chunk):
        np.add.at(met, _task_pairs(n, i_chunk, j_chunk), 1)

    for c in range(nc):
        task(c, c)
    for k in range(1, nc // 2 + 1):
        rows = [c for c in range(nc) if not (2 * k == nc and c >= k)]
        cols = [(c + k) % nc for c in rows]
        assert len(set(cols)) == len(cols)
        for c, d in zip(rows, cols):
            task(c, d)
    assert np.array_equal(met + met.T, 1 - np.eye(n, dtype=int))


@functools.lru_cache(maxsize=None)
def schedule_system(n: int) -> np.ndarray:
    """Coordinates of an n-atom system for the schedule models: di-alanine
    (22 atoms) or n / 104 tiled copies of deca-alanine, 50 A apart."""
    if n == 22:
        return np.asarray(torch_system("diala")[1], np.float64)
    return np.asarray(tiled_decaalanine(n // 104, device="cpu")[1], np.float64)


def _near_chunks(pos, cutoff):
    """near[I, J]: the bounding boxes of chunks I and J (``chunk_boxes``: a
    lane past the end stands on the last atom) lie within the cutoff
    (``boxes_apart`` with its margin)."""
    n = len(pos)
    cs, nc = tnonbonded.chunk_size(n), tnonbonded.chunk_count(n)
    chunks = pos[np.minimum(np.arange(nc * cs), n - 1)].reshape(nc, cs, 3)
    lo, hi = chunks.min(1), chunks.max(1)
    gap = np.maximum(0.0, np.maximum(lo[None] - hi[:, None], lo[:, None] - hi[None]))
    return (gap * gap).sum(-1) <= cutoff * cutoff * 1.0001


@functools.lru_cache(maxsize=None)
def _within(n, cutoff):
    """within[i, j]: atoms i != j of ``schedule_system(n)`` lie within the
    cutoff (kept for both schedules' tests: at 2,496 atoms the distance
    matrix takes a second)."""
    pos = schedule_system(n)
    d2 = ((pos[:, None] - pos[None]) ** 2).sum(-1)
    return (d2 <= cutoff * cutoff) & ~np.eye(n, dtype=bool)


SCHEDULE_SIZES = [22, 104, 416, 2496]


@pytest.mark.parametrize("n", SCHEDULE_SIZES)
def test_pair_tiles_schedule_meets_every_near_pair_once(n):
    """The pair-tile kernel's schedule (csrc/pair_tiles.cu): groups of tile
    pairs A <= B of ``TILE_CHUNKS`` chunks, a group whose chunk pairs all
    lie beyond the cutoff skipped whole; in the diagonal group row chunk w
    meets itself and then chunk (w + k) mod chunks for k = 1..chunks/2 (at
    the halfway k of an even count only w < k), in an off-diagonal group
    every chunk of the other tile; far tasks skipped. At 9 A and at 16 A it
    meets every pair within the cutoff exactly once and no pair twice, and
    the group count is the wrapper's ``tile_pair_count``."""
    pos = schedule_system(n)
    nc, tc = tnonbonded.chunk_count(n), tring.TILE_CHUNKS
    nt = -(-nc // tc)
    for cutoff in (9.0, 16.0):
        near = _near_chunks(pos, cutoff)
        met = np.zeros((n, n), np.int16)

        def task(i_chunk, j_chunk):
            if near[i_chunk, j_chunk]:
                np.add.at(met, _task_pairs(n, i_chunk, j_chunk), 1)

        groups = live = 0
        for A in range(nt):
            for B in range(A, nt):
                groups += 1
                ca, cb = A * tc, B * tc
                na, nb = min(tc, nc - ca), min(tc, nc - cb)
                if A != B and not near[ca:ca + na, cb:cb + nb].any():
                    continue
                live += 1
                for w in range(na):
                    if A == B:
                        task(ca + w, ca + w)
                        for k in range(1, na // 2 + 1):
                            if not (2 * k == na and w >= k):
                                task(ca + w, ca + (w + k) % na)
                    else:
                        for j in range(nb):
                            task(ca + w, cb + j)
        pairs = met + met.T
        assert groups == tring.tile_pair_count(n)
        assert pairs.max() <= 1
        within = _within(n, cutoff)
        assert np.array_equal(pairs[within], np.ones(int(within.sum())))
        if n == 2496:
            assert live < groups  # the tiles of far copies meet nothing


@pytest.mark.parametrize("n", SCHEDULE_SIZES)
def test_nonbonded_rows_schedule_meets_every_near_pair_once_from_its_row(n):
    """The dense-row kernel's schedule (csrc/nonbonded_rows.cu): every row
    chunk walks the column chunks in order, skipping those whose box lies
    beyond the cutoff from its own, and each of its lanes meets every atom
    of a near chunk but itself. At 9 A and at 16 A every ordered pair within
    the cutoff is met exactly once, from its row."""
    pos = schedule_system(n)
    cs, nc = tnonbonded.chunk_size(n), tnonbonded.chunk_count(n)
    for cutoff in (9.0, 16.0):
        near = _near_chunks(pos, cutoff)
        met = np.zeros((n, n), np.int16)
        for i_chunk in range(nc):
            rows = np.arange(i_chunk * cs, min(n, (i_chunk + 1) * cs))
            for j_chunk in np.flatnonzero(near[i_chunk]):
                cols = np.arange(j_chunk * cs, min(n, (j_chunk + 1) * cs))
                met[np.ix_(rows, cols)] += 1
        np.fill_diagonal(met, 0)  # an atom's own exclusion bit
        within = _within(n, cutoff)
        assert met.max() <= 1
        assert np.array_equal(met[within], np.ones(int(within.sum())))
        if n == 2496:
            assert met.sum() < n * (n - 1) // 4  # far chunks are skipped
