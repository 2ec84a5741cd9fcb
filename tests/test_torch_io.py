"""Port parity: the host I/O (``topology``, ``io``) against the JAX package.

Readers: the golden backbone PSF and PDB give arrays equal to the JAX
readers' (exactly: ints, strings and floats alike). Writers: for the same
seeded arrays the port's DCD, XYZ and PDB files are byte for byte the JAX
writers', and each package reads the other's files back.
"""

import pathlib

import numpy as np
import pytest

from molecular_dynamics_tpu import io as jio
from molecular_dynamics_tpu import topology as jtopology
from molecular_dynamics_tpu_torch import io as tio
from molecular_dynamics_tpu_torch import topology as ttopology

GOLDENS = pathlib.Path(__file__).parent / "goldens"
PSF = str(GOLDENS / "backbone-no-improp.psf")
PDB = str(GOLDENS / "backbone.pdb")

TOPOLOGY_FIELDS = ("atom_types", "atom_names", "res_names", "res_ids", "charges",
                   "masses", "bonds", "angles", "dihedrals", "impropers", "seg_ids",
                   "cross_terms")


def assert_same_array(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b)


def test_read_psf_matches_jax():
    jt, tt = jio.read_psf(PSF), tio.read_psf(PSF)
    assert isinstance(tt, ttopology.Topology)
    for name in TOPOLOGY_FIELDS:
        assert_same_array(getattr(tt, name), getattr(jt, name))
    assert tt.coords is None and jt.coords is None
    assert tt.n_atoms == 40 and tt.describe() == jt.describe()


def test_read_pdb_matches_jax():
    for a, b in zip(tio.read_pdb(PDB), jio.read_pdb(PDB)):
        assert_same_array(a, b)


def test_topology_validation_matches_jax():
    """Same checks, same messages: a column of the wrong length, an index
    out of range."""
    kw = dict(atom_types=np.array(["C", "O"], object), atom_names=np.array(["C", "O"], object),
              res_names=np.array(["A", "A"], object), res_ids=np.array([1, 1]),
              charges=np.zeros(2), masses=np.ones(2))
    for bad in (dict(masses=np.ones(3)), dict(bonds=np.array([[0, 2]]))):
        msgs = []
        for mod in (jtopology, ttopology):
            with pytest.raises(ValueError) as exc:
                mod.Topology(**{**kw, **bad})
            msgs.append(str(exc.value))
        assert msgs[0] == msgs[1]
    good = ttopology.Topology(**kw, bonds=[0, 1])
    assert good.bonds.dtype == np.int64 and good.bonds.shape == (1, 2)


@pytest.fixture()
def frames():
    return np.random.default_rng(7).normal(0.0, 8.0, (5, 12, 3))


def _write_both(tmp_path, name, write_j, write_t):
    pj, pt = tmp_path / f"jax_{name}", tmp_path / f"torch_{name}"
    write_j(str(pj))
    write_t(str(pt))
    assert pt.read_bytes() == pj.read_bytes()
    return str(pj), str(pt)


@pytest.mark.parametrize("with_cell", [False, True])
def test_dcd_bytes_and_cross_read(tmp_path, frames, with_cell):
    cell = np.tile(np.array([30.0, 90.0, 31.0, 90.0, 90.0, 32.0]), (5, 1)) if with_cell else None
    pj, pt = _write_both(
        tmp_path, "traj.dcd",
        lambda p: jio.write_dcd(p, frames, cell=cell, step=50),
        lambda p: tio.write_dcd(p, frames, cell=cell, step=50),
    )
    for reader, path in ((tio.read_dcd, pj), (jio.read_dcd, pt)):
        coords, cells = reader(path)
        assert coords.dtype == np.float32 and coords.shape == (5, 12, 3)
        assert np.array_equal(coords, frames.astype(np.float32))
        if with_cell:
            assert np.array_equal(cells, cell)
        else:
            assert cells is None


def test_xyz_bytes_and_cross_read(tmp_path, frames):
    symbols = ["N", "CA", "C", "O"] * 3
    pj, pt = _write_both(
        tmp_path, "traj.xyz",
        lambda p: jio.write_xyz(p, frames, symbols=symbols),
        lambda p: tio.write_xyz(p, frames, symbols=symbols),
    )
    for reader, path in ((tio.read_xyz, pj), (jio.read_xyz, pt)):
        back = reader(path)
        assert back.shape == frames.shape
        np.testing.assert_allclose(back, frames, atol=5e-7)
    # one frame, default symbols
    _write_both(tmp_path, "one.xyz", lambda p: jio.write_xyz(p, frames[0]),
                lambda p: tio.write_xyz(p, frames[0]))


@pytest.mark.parametrize("models", [1, 3])
def test_pdb_bytes_and_cross_read(tmp_path, frames, models):
    names = np.array(["N", "CA", "C", "O"] * 3, object)
    resids = np.repeat(np.arange(1, 4), 4)
    coords = frames[:models] if models > 1 else frames[0]
    pj, pt = _write_both(
        tmp_path, "traj.pdb",
        lambda p: jio.write_pdb(p, coords, names, resnames=np.array(["ALA"] * 12), resids=resids),
        lambda p: tio.write_pdb(p, coords, names, resnames=np.array(["ALA"] * 12), resids=resids),
    )
    for reader, path in ((tio.read_pdb, pj), (jio.read_pdb, pt)):
        back, back_names, resnames, back_resids = reader(path)
        assert back.shape == np.shape(coords)
        np.testing.assert_allclose(back, coords, atol=5e-4)
        assert list(back_names) == list(names) and list(back_resids) == list(resids)
        assert set(resnames) == {"ALA"}


def test_psf_errors(tmp_path):
    bad = tmp_path / "bad.psf"
    bad.write_text("not a psf\n")
    with pytest.raises(ValueError, match="not a PSF file"):
        tio.read_psf(str(bad))
    empty = tmp_path / "empty.psf"
    empty.write_text("PSF\n\n       0 !NTITLE\n")
    with pytest.raises(ValueError, match="No NATOM section"):
        tio.read_psf(str(empty))
