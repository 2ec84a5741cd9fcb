"""Port parity: package boundary, units, loaders, FFParams and ``convert``.

Every field the port's loaders produce is held against the JAX loader's
(exact for ints and bools, 1e-6 relative for floats), and the port's sources
are walked to show that it imports neither JAX nor the JAX package.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import molecular_dynamics_tpu as mdx_jax
import molecular_dynamics_tpu_torch as mdx
from molecular_dynamics_tpu_torch import convert
from molecular_dynamics_tpu_torch.examples import decaalanine_full, dialanine
from molecular_dynamics_tpu_torch.ff.params import BOOL_FIELDS, INT_FIELDS

from torch_parity import SYSTEMS, ff_to_numpy, jax_system, torch_system

ROOT = pathlib.Path(__file__).resolve().parent.parent
FF_FIELDS = convert.FF_ARRAY_FIELDS + ("gb_radii", "gb_screen", "sasa_radii", "sasa_params")
FORBIDDEN = ("jax", "flax", "optax", "molecular_dynamics_tpu")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax():
    sources = sorted((ROOT / "molecular_dynamics_tpu_torch").rglob("*.py"))
    sources.append(ROOT / "chip_smoke.py")
    assert len(sources) > 15
    bad = [
        (str(p.relative_to(ROOT)), mod)
        for p in sources
        for mod in _imported_modules(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert not bad, bad


def test_tf32_is_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize(
    "name",
    ["ELEC_FACTOR", "BOLTZMANN", "TIMEFACTOR", "SOLVENT_DIELECTRIC", "AMBER_CHARGE_FACTOR"],
)
def test_units_equal(name):
    assert getattr(mdx.units, name) == getattr(mdx_jax.units, name)


@pytest.fixture(scope="module")
def loaded():
    out = {}
    for name, loader in (("full_da", decaalanine_full), ("diala", dialanine)):
        ff, coords, meta = loader(device="cpu")
        out[name] = (ff, coords, meta)
    return out


@pytest.mark.parametrize("field", FF_FIELDS)
@pytest.mark.parametrize("system", SYSTEMS)
def test_loader_field_equals_jax(loaded, system, field):
    ours = getattr(loaded[system][0], field)
    ref = np.asarray(getattr(jax_system(system, f64=False)[0], field))
    assert tuple(ours.shape) == ref.shape
    if field in INT_FIELDS:
        assert ours.dtype == torch.int64
        np.testing.assert_array_equal(ours.numpy(), ref)
    elif field in BOOL_FIELDS:
        assert ours.dtype == torch.bool
        np.testing.assert_array_equal(ours.numpy(), ref)
    else:
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-6, atol=0)


@pytest.mark.parametrize("system", SYSTEMS)
def test_loader_coords_and_meta_equal_jax(loaded, system):
    from molecular_dynamics_tpu.examples import decaalanine_full as jfull, dialanine as jdi

    _, coords, meta = loaded[system]
    _, jcoords, jmeta = {"full_da": jfull, "diala": jdi}[system]()
    np.testing.assert_array_equal(coords, np.asarray(jcoords))
    for key in ("atom_names", "atom_types", "res_ids", "res_names"):
        np.testing.assert_array_equal(meta[key], jmeta[key])


def test_system_sizes(loaded):
    ff = loaded["full_da"][0]
    assert (ff.n_atoms, ff.bonds.shape[0], ff.ub_bonds.shape[0]) == (104, 103, 65)
    assert (ff.angles.shape[0], ff.dihedrals.shape[0], ff.impropers.shape[0]) == (183, 251, 22)
    assert (ff.idx14.shape[0], int(ff.nb_mask.sum())) == (250, 4820)
    assert ff.has_gb and not ff.has_cmap
    assert loaded["diala"][0].n_atoms == 22


def test_loader_runs_on_the_card_by_default():
    # device=None means CUDA: on a machine without a card the loader raises
    # instead of quietly taking the CPU
    if torch.cuda.is_available():
        assert decaalanine_full()[0].masses.is_cuda
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            decaalanine_full()


@pytest.mark.parametrize("system", SYSTEMS)
def test_convert_ff_roundtrip(system):
    jff, _ = jax_system(system, f64=True)
    tff, _ = torch_system(system, f64=True)
    for name, ref in ff_to_numpy(jff).items():
        ours = getattr(tff, name)
        if name in INT_FIELDS or name in BOOL_FIELDS:
            np.testing.assert_array_equal(ours.numpy(), ref)
        else:
            assert ours.dtype == torch.float64
            np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-15, atol=0)


def test_ffparams_to_casts_floats_only(loaded):
    ff = loaded["diala"][0].to(dtype=torch.float64)
    for f in dataclasses.fields(ff):
        v = getattr(ff, f.name)
        if v is None:
            continue
        want = (
            torch.int64 if f.name in INT_FIELDS
            else torch.bool if f.name in BOOL_FIELDS else torch.float64
        )
        assert v.dtype == want, f.name


def test_convert_missing_field_raises():
    arrays = ff_to_numpy(jax_system("diala")[0])
    del arrays["bonds"]
    with pytest.raises(KeyError, match="bonds"):
        convert.ff_params_from_numpy(arrays, device="cpu")


def test_convert_state_bias_constraints():
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(3, 5, 3))
    st = convert.state_from_numpy(pos, vel=2 * pos, step=7, key=[1, 2, 3], device="cpu")
    assert st.pos.shape == (3, 5, 3) and st.pos.dtype == torch.float32
    assert st.n_atoms == 5
    np.testing.assert_allclose(st.vel.numpy(), (2 * pos).astype(np.float32))
    assert st.step.tolist() == [7, 7, 7] and st.key.tolist() == [1, 2, 3]
    assert st.box.shape == (3, 3) and float(st.forces.abs().sum()) == 0.0

    from molecular_dynamics_tpu.bias import HarmonicSMDBias as JBias

    jb = JBias.create(n_atoms=5, group1=[0], group2=[3, 4], fk=2.0, cent_0=3.0, cent_1=9.0, T=100.0)
    tb = convert.bias_from_numpy(
        {f.name: np.asarray(getattr(jb, f.name)) for f in dataclasses.fields(jb)},
        device="cpu",
    )
    np.testing.assert_allclose(tb.group2_w.numpy(), [0, 0, 0, 0.5, 0.5])
    assert float(tb.fk) == 2.0 and float(tb.T) == 100.0

    cons = convert.constraints_from_numpy([[0, 1], [2, 3]], [1.0, 1.1], np.ones(5), device="cpu")
    assert cons.n_constraints == 2 and cons.pairs.dtype == torch.int64
