"""Port parity: the prmtop reader, the trajectory codecs, mol2 / sdf / xsc
and the command line on them, against the JAX package in float64.

The files are written here: two small chain prmtops (chamber with the wide
charge field and Fortran ``D`` exponents; plain AMBER with periodic
impropers and no scale-factor sections, so the 1.2 / 2.0 defaults hold) and
the packaged 104-atom deca-alanine through the numpy writer
``torch_files.write_prmtop``. Both readers read the same file: the tables
equal field by field, the energies within 1e-10 kcal/mol. The port's native
codec (built from ``native/mdx_native.cpp``) writes the JAX library's bytes
and reads what the pure-Python decoder reads.
"""

import ast
import hashlib
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from molecular_dynamics_tpu import cli as jcli
from molecular_dynamics_tpu import energy as jenergy
from molecular_dynamics_tpu import io as jio
from molecular_dynamics_tpu.io import native as jnative
from molecular_dynamics_tpu.io import xtc as jxtc
from molecular_dynamics_tpu_torch import cli as tcli
from molecular_dynamics_tpu_torch import energy as tenergy
from molecular_dynamics_tpu_torch import io as tio
from molecular_dynamics_tpu_torch.io import native as tnative
from molecular_dynamics_tpu_torch.io import xtc as txtc

import torch_files
from torch_parity import ff_to_numpy, t

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "tests" / "goldens"
FULL_NPZ = ROOT / "molecular_dynamics_tpu_torch" / "examples" / "data" / "full_da.npz"
GOLDEN_XTC_SHA256 = "77ba35f14e78995e568fbdfd66a68714c4bd2257168498527967fec8ee1d4d51"
E_ATOL = 1e-10
F_ATOL = 1e-10


def _full_da():
    with np.load(FULL_NPZ) as raw:
        tables = {k[3:]: raw[k] for k in raw.files if k.startswith("ff_")}
        meta = {k: raw[k] for k in ("atom_names", "atom_types", "res_ids", "res_names", "coords")}
    return tables, meta


@pytest.fixture(scope="module")
def prmtops(tmp_path_factory):
    """name -> (path, coordinates) of the three prmtops."""
    d = tmp_path_factory.mktemp("prmtop")
    out = {}
    rng = np.random.default_rng(5)
    tables, names, types, res_ids, res_names = torch_files.chain_tables(
        7, seed=1, impropers_periodic=False)
    torch_files.write_prmtop(d / "chain_chamber.prmtop", tables, names, types, res_ids,
                             res_names, chamber=True, exponent="D")
    out["chain_chamber"] = (str(d / "chain_chamber.prmtop"), rng.normal(0, 2.0, (7, 3)))
    tables, names, types, res_ids, res_names = torch_files.chain_tables(6, seed=2)
    torch_files.write_prmtop(d / "chain_amber.prmtop", tables, names, types, res_ids,
                             res_names, chamber=False, scale_factors=False)
    out["chain_amber"] = (str(d / "chain_amber.prmtop"), rng.normal(0, 2.0, (6, 3)))
    tables, meta = _full_da()
    torch_files.write_prmtop(d / "full_da.prmtop", tables, meta["atom_names"],
                             meta["atom_types"], meta["res_ids"], meta["res_names"])
    out["full_da"] = (str(d / "full_da.prmtop"),
                      meta["coords"] + rng.normal(0, 0.05, meta["coords"].shape))
    return out


@pytest.fixture(scope="module")
def prmtop_ffs(prmtops):
    """name -> (JAX FFParams leaves, port FFParams), float64."""
    return {
        name: (ff_to_numpy(jio.prmtop_to_ff_params(path, dtype=jnp.float64)),
               tio.prmtop_to_ff_params(path, dtype=torch.float64, device="cpu"))
        for name, (path, _) in prmtops.items()
    }


@pytest.mark.parametrize("name", ["chain_chamber", "chain_amber", "full_da"])
def test_read_prmtop_matches_jax(prmtops, name):
    path, _ = prmtops[name]
    jtop, jraw = jio.read_prmtop(path)
    ttop, traw = tio.read_prmtop(path)
    assert set(jraw) == set(traw)
    for k, v in jraw.items():
        assert traw[k].dtype == v.dtype and np.array_equal(traw[k], v), k
    for field in ("atom_types", "atom_names", "res_names", "res_ids", "charges", "masses",
                  "bonds", "angles", "dihedrals", "impropers"):
        assert np.array_equal(np.asarray(getattr(ttop, field)), np.asarray(getattr(jtop, field))), field
    assert ttop.coords is None and jtop.coords is None
    if name == "chain_chamber":
        assert "CHARMM_IMPROPERS" in traw and abs(traw["CHARGE"]).max() > 0


@pytest.mark.parametrize("name", ["chain_chamber", "chain_amber", "full_da"])
def test_prmtop_to_ff_params_matches_jax(prmtop_ffs, name):
    jleaves, tff = prmtop_ffs[name]
    tleaves = {k: v.numpy() for k, v in vars(tff).items() if v is not None}
    assert set(tleaves) == set(jleaves)
    for k, v in jleaves.items():
        np.testing.assert_allclose(tleaves[k], v, rtol=1e-14, atol=0, err_msg=k)
    if name == "chain_amber":
        # no SCEE/SCNB sections: AMBER's 1/2.0 and 1/1.2 defaults
        assert np.all(tleaves["nb14_params"][:, 2:] == [2.0, 1.2])
        assert tleaves["ub_bonds"].shape == (0, 2)
    if name == "chain_chamber":
        assert tleaves["ub_bonds"].shape[0] and np.all(tleaves["improper_params"][..., 2] == 0)


@pytest.mark.parametrize("name", ["chain_chamber", "chain_amber", "full_da"])
def test_prmtop_energies_match_jax(prmtops, prmtop_ffs, name):
    _, pos = prmtops[name]
    jff = jio.prmtop_to_ff_params(prmtops[name][0], dtype=jnp.float64)
    _, tff = prmtop_ffs[name]
    configs = ["REFERENCE_CONFIG"] + (["GBIS_CONFIG"] if name == "full_da" else [])
    for cname in configs:
        jcfg, tcfg = getattr(jenergy, cname), getattr(tenergy, cname)
        jterms, jforces = jax.jit(
            lambda p, ff, cfg=jcfg: jenergy.energy_and_forces(p, ff, config=cfg))(
            jnp.asarray(pos), jff)
        tterms, tforces = tenergy.energy_and_forces(t(pos), tff, config=tcfg)
        assert set(tterms) == set(jterms)
        for k, v in jterms.items():
            assert abs(float(tterms[k]) - float(v)) <= E_ATOL, (cname, k)
        np.testing.assert_allclose(tforces.numpy(), np.asarray(jforces), rtol=0, atol=F_ATOL)


def test_prmtop_writer_rebuilds_example_full(prmtop_ffs):
    """The 104-atom prmtop the writer makes holds the packaged tables: the
    same rows up to their order (dihedrals and 1-4 pairs oriented), the
    same exclusion mask, and the pair tables to the text's precision."""
    from molecular_dynamics_tpu_torch.examples import decaalanine_full

    _, tff = prmtop_ffs["full_da"]
    ref, _, _ = decaalanine_full(dtype=torch.float64, device="cpu")

    def rows(idx, params):
        idx, params = idx.numpy(), params.numpy().reshape(len(idx), -1)
        flip = idx[:, 0] > idx[:, -1]
        idx = np.where(flip[:, None], idx[:, ::-1], idx)
        # the text's 9 significant digits give back each float32 of the npz
        return sorted((tuple(i), tuple(p.astype(np.float32))) for i, p in zip(idx, params))

    for idx, par in (("bonds", "bond_params"), ("angles", "angle_params"),
                     ("ub_bonds", "ub_params"), ("idx14", "nb14_params"),
                     ("impropers", "improper_params")):
        assert rows(getattr(tff, idx), getattr(tff, par)) == rows(
            getattr(ref, idx), getattr(ref, par)), idx
    live = lambda ff: [(tuple(d if d[0] < d[3] else d[::-1]),  # noqa: E731
                        tuple(sorted(tuple(p.astype(np.float32)) for p, m in zip(ps, ms) if m)))
                       for d, ps, ms in zip(ff.dihedrals.numpy(), ff.dihedral_params.numpy(),
                                            ff.dihedral_term_mask.numpy())]
    assert sorted(live(tff)) == sorted(live(ref))
    assert torch.equal(tff.nb_mask, ref.nb_mask)
    for k in ("charges", "masses", "lj_a_pair", "lj_b_pair"):
        np.testing.assert_allclose(getattr(tff, k), getattr(ref, k), rtol=1e-7, err_msg=k)
    # the packaged qq_pair is a float32 product, this one float64's
    np.testing.assert_allclose(tff.qq_pair, ref.qq_pair, rtol=3e-7, atol=0)
    for k in ("gb_radii", "gb_screen", "sasa_radii", "sasa_params"):
        assert torch.equal(getattr(tff, k), getattr(ref, k)), k


# -- trajectories --------------------------------------------------------------


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(7)
    return {
        "generic": rng.normal(0, 8, (4, 104, 3)).astype(np.float32),
        "clustered": (np.repeat(rng.normal(0, 5, (35, 3)), 3, axis=0)[None]
                      + rng.normal(0, 0.02, (3, 105, 3))).astype(np.float32),
        "few_atoms": rng.normal(0, 8, (2, 9, 3)).astype(np.float32),
    }


def test_golden_xtc_decoders_and_reencoding(tmp_path):
    golden = GOLDENS / "golden.xtc"
    blob = golden.read_bytes()
    assert hashlib.sha256(blob).hexdigest() == GOLDEN_XTC_SHA256
    coords = np.load(GOLDENS / "golden_xtc_coords.npy")
    a, steps, times = txtc.read_xtc(str(golden), with_meta=True)
    b = txtc.read_xtc_py(str(golden))
    assert np.array_equal(a, b)
    assert np.array_equal(b, jxtc.read_xtc_py(str(golden)))
    ja, jsteps, jtimes = jnative.xtc_read(str(golden), with_meta=True)
    assert np.array_equal(a, ja) and np.array_equal(steps, jsteps) and np.array_equal(times, jtimes)
    assert np.abs(a - coords).max() < 0.011
    out = tmp_path / "again.xtc"
    txtc.write_xtc(str(out), coords, precision=1000.0)
    assert out.read_bytes() == blob


@pytest.mark.parametrize("codec", ["xtc", "mdxtc", "dcd"])
def test_native_writers_byte_equal_jax(tmp_path, frames, codec):
    # xtc at GROMACS's 1000 / nm (0.01 A), mdxtc at 10000 / nm (1e-3 A)
    kw = {"xtc": {"precision": 1000.0}, "mdxtc": {"precision": 10000.0}, "dcd": {}}[codec]
    for case, f in frames.items():
        tp, jp = str(tmp_path / f"t_{case}.{codec}"), str(tmp_path / f"j_{case}.{codec}")
        getattr(tnative, f"{codec}_write")(tp, f, **kw)
        getattr(jnative, f"{codec}_write")(jp, f, **kw)
        assert pathlib.Path(tp).read_bytes() == pathlib.Path(jp).read_bytes(), case
        back = getattr(tnative, f"{codec}_read")(tp)
        assert np.array_equal(back, getattr(jnative, f"{codec}_read")(jp)), case
        if codec == "xtc":
            assert np.array_equal(back, txtc.read_xtc_py(tp)), case
        if codec == "dcd" or (codec == "xtc" and f.shape[1] <= 9):  # stored as floats
            np.testing.assert_allclose(back, f, rtol=1e-6)
        else:
            assert np.abs(back - f).max() < (0.011 if codec == "xtc" else 0.0011), case


@pytest.mark.parametrize("fmt", ["raw", "dcd"])
def test_async_sink_matches_jax(tmp_path, frames, fmt):
    f = frames["generic"]
    paths = {}
    for name, mod in (("torch", tnative), ("jax", jnative)):
        paths[name] = tmp_path / f"{name}.{fmt}"
        with mod.AsyncTrajectorySink(str(paths[name]), f.shape[1], fmt=fmt) as sink:
            for frame in f:
                sink.push(frame)
            assert sink.close() == len(f)
    assert paths["torch"].read_bytes() == paths["jax"].read_bytes()
    if fmt == "raw":
        back = np.fromfile(paths["torch"], np.float32).reshape(f.shape)
    else:
        back = tnative.dcd_read(str(paths["torch"]))
    assert np.array_equal(back, f)


def test_native_library_is_the_ports_own():
    """The port builds its own library under build/, named apart from the
    JAX package's, and both load in one process."""
    path = tnative.build()
    assert path.parent == tnative.BUILD_DIR and path.name.startswith("libmdx_native_torch_")
    assert path != jnative._LIB_PATH
    assert tnative.available() and tnative._load().mdx_abi_version() == 2


# -- mol2, sdf, xsc -------------------------------------------------------------


def test_mol2_files_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    coords = rng.normal(0, 5, (6, 3)).round(4)
    names = np.array(["C1", "C2", "N1", "O1", "H1", "H2"], object)
    kw = dict(atom_types=np.array(["C.3", "C.ar", "N.am", "O.2", "H", "H"], object),
              charges=np.array([0.1, -0.2, 0.3, -0.4, 0.05, 0.15]),
              bonds=np.array([[0, 1], [1, 2], [2, 3], [0, 4], [0, 5]]),
              bond_types=np.array(["1", "ar", "am", "1", "1"], object),
              resnames=np.array(["LIG"] * 6, object), resids=np.arange(1, 7))
    tio.write_mol2(str(tmp_path / "t.mol2"), coords, names, **kw)
    jio.write_mol2(str(tmp_path / "j.mol2"), coords, names, **kw)
    assert (tmp_path / "t.mol2").read_bytes() == (tmp_path / "j.mol2").read_bytes()
    tio.write_mol2(str(tmp_path / "t0.mol2"), coords, names)
    jio.write_mol2(str(tmp_path / "j0.mol2"), coords, names)
    assert (tmp_path / "t0.mol2").read_bytes() == (tmp_path / "j0.mol2").read_bytes()
    two = tmp_path / "two.mol2"
    two.write_text(
        "# comment\n@<TRIPOS>MOLECULE\nm1\n2 1 0 0 0\nSMALL\nNO_CHARGES\n"
        "@<TRIPOS>ATOM\n1 CA 0.0 0.0 0.0 C.3 1 ALA 0.0\n2 CB 1.5 0.0 0.0 C.3\n"
        "@<TRIPOS>BOND\n1 1 2\n@<TRIPOS>MOLECULE\nm2\n1 0 0 0 0\nSMALL\nNO_CHARGES\n"
        "@<TRIPOS>ATOM\n1 X 9.0 9.0 9.0 C.3 1 UNK 0.0\n")
    for path in (tmp_path / "t.mol2", two):
        got, want = tio.read_mol2(str(path)), jio.read_mol2(str(path))
        assert set(got) == set(want)
        for k, v in want.items():
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_sdf_and_xsc_match_jax(tmp_path):
    rec1 = ("ring\n  mdx\n\n  3  2  0  0  0  0  0  0  0  0999 V2000\n"
            "    0.0000    0.0000    0.0000 C   0  0  0  0  0  0\n"
            "    1.4000    0.0000    0.0000 N   0  3  0  0  0  0\n"
            "   -1.4000    0.0000    0.0000 O   0  5  0  0  0  0\n"
            "  1  2  1  0\n  1  3  2  0\nM  END\n$$$$\n")
    rec2 = ("chg\n  mdx\n\n  2  1  0  0  0  0  0  0  0  0999 V2000\n"
            "    0.0000    0.0000    0.0000 S   0  1  0  0  0  0\n"
            "    2.0000    0.0000    0.0000 K   0  0  0  0  0  0\n"
            "  1  2  1  0\nM  CHG  2   1  -1   2   1\nM  END\n")
    sdf = tmp_path / "t.sdf"
    sdf.write_text(rec1 + rec2)
    got, want = tio.read_sdf(str(sdf)), jio.read_sdf(str(sdf))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k, v in w.items():
            assert np.array_equal(np.asarray(g[k]), np.asarray(v)), k
    xsc = tmp_path / "t.xsc"
    xsc.write_text("# NAMD extended system configuration\n#$LABELS step a_x a_y a_z\n"
                   "0 30.5 0 0 0 31.25 0 0 0 29.0 1.5 -2.0 0.25\n"
                   "500 30.6 0.1 0 0 31.3 0 0 0 29.1 1.5 -2.0 0.5 0 0 0\n")
    short = tmp_path / "short.xsc"
    short.write_text("0 30.5 0 0 0 31.25 0 0 0 29.0\n")
    for path in (xsc, short):
        for g, w in zip(tio.read_xsc(str(path)), jio.read_xsc(str(path))):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    bad = tmp_path / "bad.xsc"
    bad.write_text("0 1 2 3\n")
    with pytest.raises(ValueError, match="fields"):
        tio.read_xsc(str(bad))


# -- the command line on them ---------------------------------------------------


@pytest.mark.parametrize("name", ["chain_chamber", "full_da"])
def test_cli_energy_on_prmtop_matches_jax(tmp_path, capsys, prmtops, name):
    path, pos = prmtops[name]
    frames = tmp_path / "frames.npy"
    np.save(frames, pos[None])
    assert tcli.main(["energy", "--device", "cpu", "--topology", path,
                      "--frames", str(frames)]) == 0
    got = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main(["energy", "--topology", path, "--frames", str(frames)]) == 0
    want = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == set(want)
    for k, v in want.items():
        assert abs(got[k] - v) <= max(1e-3 * abs(v), 1e-3), (k, got[k], v)


@pytest.mark.parametrize("codec", ["xtc", "mdxtc"])
def test_cli_convert_trajectories_matches_jax(tmp_path, capsys, frames, codec):
    src = str(tmp_path / f"in.{codec}")
    getattr(jnative, f"{codec}_write")(src, frames["generic"])
    for main, name in ((tcli.main, "torch"), (jcli.main, "jax")):
        assert main(["convert", src, str(tmp_path / f"{name}.npy")]) == 0
    assert (tmp_path / "torch.npy").read_bytes() == (tmp_path / "jax.npy").read_bytes()
    capsys.readouterr()
