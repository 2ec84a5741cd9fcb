"""Port parity: the tiled systems (``ff.params.tile_ff_params``,
``examples.tiled_decaalanine``) and the angle-torsion op
(``ops.bonded.make_angle_torsion_op``), the two pieces of the composed
force path besides the pair ops.

- ``tile_ff_params`` against the JAX function array for array at m = 2 and
  3 (exact for ints and bools, 1e-12 relative for floats), and
  ``tiled_decaalanine`` against the JAX coordinates and metadata at m = 2;
- the oracle of tests/test_tiled.py: the composite energy is m times the
  single copy's, term for term, to 1e-8 relative in float64;
- the angle-torsion op against the JAX op (float64, full-precision matmuls)
  at 104 and 208 atoms, to 1e-9.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from molecular_dynamics_tpu.examples import tiled_decaalanine as jtiled
from molecular_dynamics_tpu.ff.params import tile_ff_params as jtile_ff_params
from molecular_dynamics_tpu.ops.bonded import make_angle_torsion_op as jmake_angle_torsion_op
from molecular_dynamics_tpu_torch import energy as tenergy
from molecular_dynamics_tpu_torch.examples import decaalanine_full, tiled_decaalanine
from molecular_dynamics_tpu_torch.ff.params import BOOL_FIELDS, INT_FIELDS, tile_ff_params
from molecular_dynamics_tpu_torch.ops.bonded import make_angle_torsion_op

from torch_parity import ff_to_numpy, jax_system, t, torch_system


@pytest.mark.parametrize("m", [2, 3])
def test_tile_ff_params_matches_jax(m):
    jff, _ = jax_system("full_da")
    tff, _ = torch_system("full_da")
    want = ff_to_numpy(jtile_ff_params(jff, m))
    got = tile_ff_params(tff, m)
    assert got.n_atoms == 104 * m
    for f in dataclasses.fields(got):
        value = getattr(got, f.name)
        if value is None:
            assert f.name not in want or f.name.startswith("cmap"), f.name
            continue
        ours = value.numpy()
        assert ours.shape == want[f.name].shape, f.name
        if f.name in INT_FIELDS or f.name in BOOL_FIELDS:
            np.testing.assert_array_equal(ours, want[f.name], err_msg=f.name)
        else:
            np.testing.assert_allclose(ours, want[f.name], rtol=1e-12, atol=0, err_msg=f.name)


def test_tiled_decaalanine_matches_jax():
    _, jcoords, jmeta = jtiled(2, dtype=jnp.float64)
    tff, coords, meta = tiled_decaalanine(2, dtype=torch.float64, device="cpu")
    assert tff.n_atoms == 208 and tff.masses.dtype == torch.float64
    np.testing.assert_array_equal(coords, np.asarray(jcoords))
    assert set(meta) == set(jmeta) and meta["tiled_copies"] == jmeta["tiled_copies"] == 2
    for k in ("atom_names", "atom_types", "res_names", "res_ids"):
        np.testing.assert_array_equal(np.asarray(meta[k]), np.asarray(jmeta[k]), err_msg=k)
    # the copies sit 50 A apart along x
    np.testing.assert_allclose(coords[104:] - coords[:104], np.tile([50.0, 0.0, 0.0], (104, 1)))


@pytest.mark.parametrize(
    "config, m, spacing", [("REFERENCE_CONFIG", 4, 60.0), ("GBIS_CONFIG", 3, 80.0)]
)
def test_tiled_energy_is_m_times_the_single_copy(config, m, spacing):
    """Every pair term between the copies is cut off (at 9 A, and at 16 A
    under GBIS_CONFIG), the LCPO overlaps and the Born integrals are local;
    only the uncut Still pair sum of the GB term reaches across, as the
    screened dipole-dipole tail between neutral copies (bounded at 0.05
    kcal/mol of -425 at 80 A, as tests/test_tiled.py bounds it)."""
    cfg = getattr(tenergy, config)
    ff1, c1, _ = decaalanine_full(dtype=torch.float64, device="cpu")
    ffm, cm, _ = tiled_decaalanine(m, spacing=spacing, dtype=torch.float64, device="cpu")
    t1 = tenergy.energy_terms(t(c1), ff1, config=cfg)
    tm = tenergy.energy_terms(t(cm), ffm, config=cfg)
    assert set(t1) == set(tm)
    for k, v in t1.items():
        atol = 0.05 if k == "gb" else 1e-7
        np.testing.assert_allclose(float(tm[k]), m * float(v), rtol=1e-8, atol=atol, err_msg=k)


def test_tile_ff_params_refuses_what_it_cannot_tile():
    """CMAP tables tile as JAX tiles them (the rows offset per copy, the
    grid ids repeated, the coefficients shared); ``m`` below 1 raises."""
    from molecular_dynamics_tpu.ff.params import attach_cmap_params as jattach
    from molecular_dynamics_tpu_torch.ff.params import attach_cmap_params

    tff, _ = torch_system("full_da")
    jff, _ = jax_system("full_da")
    rows = np.array([[9, 11, 13, 19, 11, 13, 19, 21], [19, 21, 23, 29, 21, 23, 29, 31]])
    grids = [np.outer(np.cos(np.arange(24) * np.pi / 12), np.ones(24)), np.eye(24)]
    cmap = attach_cmap_params(tff, rows, grids, np.array([1, 0]))
    got = tile_ff_params(cmap, 2)
    want = jtile_ff_params(jattach(jff, rows, grids, np.array([1, 0])), 2)
    for k in ("cmap_idx", "cmap_grid_id", "cmap_coeffs"):
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k))), k
    assert got.cmap_idx.tolist() == rows.tolist() + (rows + 104).tolist()
    with pytest.raises(ValueError, match="m must be"):
        tile_ff_params(tff, 0)
    assert tile_ff_params(tff, 1).nb_mask.equal(tff.nb_mask)


@pytest.mark.parametrize("m", [1, 2], ids=["104_atoms", "208_atoms"])
def test_angle_torsion_op_matches_jax(m):
    if m == 1:
        jff, coords = jax_system("full_da")
        tff, _ = torch_system("full_da")
    else:
        jff, coords, _ = jtiled(m, dtype=jnp.float64)
        tff, _, _ = tiled_decaalanine(m, dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(5 + m)
    pos = np.asarray(coords)[None] + rng.normal(0.0, 0.05, (3,) + np.shape(coords))
    jop = jmake_angle_torsion_op(jff, dtype=jnp.float64)
    je, jf = jax.jit(jop)(jnp.asarray(pos))
    op = make_angle_torsion_op(tff, dtype=torch.float64)
    te, tf = op(t(pos))
    assert te.shape == (3,) and tf.shape == pos.shape and tf.dtype == torch.float64
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(op.energy(t(pos)).numpy(), np.asarray(je), rtol=1e-12, atol=1e-9)
    # the angle, dihedral and improper terms of the energy, nothing else
    cfg = tenergy.EnergyConfig(terms=("angles", "dihedrals", "impropers"), urey_bradley=False)
    np.testing.assert_allclose(
        te.numpy(), tenergy.total_energy(t(pos), tff, config=cfg).numpy(), rtol=1e-12)
    # a float32 op on float64 positions computes in float32, returns float64
    e32, f32 = make_angle_torsion_op(tff)(t(pos))
    assert e32.dtype == torch.float32 and f32.dtype == torch.float64
    np.testing.assert_allclose(f32.numpy(), np.asarray(jf), atol=2e-2)
    # forces carry a graph where the positions require grad
    p = t(pos).requires_grad_(True)
    (g,) = torch.autograd.grad((op(p)[1] * t(pos)).sum(), p)
    assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 1.0
