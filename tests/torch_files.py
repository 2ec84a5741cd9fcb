"""Small molecular files written from numpy tables, for the I/O tests and
for ``chip_smoke.py`` (which loads this file by path).

numpy only: no import of either package, so the same writer serves the
parity tests on the CPU and the smoke run on the card.

``write_prmtop`` writes an AMBER prmtop from dense force-field tables (the
field names of ``FFParams``): CHARMM chamber flavour by default, plain AMBER
with ``chamber=False``. Every atom gets its own Lennard-Jones type, so the
``LENNARD_JONES_*COEF`` tables (and the chamber 1-4 tables) hold each pair's
own value and a reader rebuilds the pair tables exactly.
"""

from __future__ import annotations

import math

import numpy as np

AMBER_CHARGE_FACTOR = 18.2223

#: (per line, width, decimals) of the real formats used below
_REAL_FORMATS = {"5E16.8": (5, 16, 8), "3E24.16": (3, 24, 16)}


def _section(name, fmt, values, exponent="E"):
    """One ``%FLAG`` block: ``fmt`` is ``"10I8"``, ``"20a4"`` or a key of
    ``_REAL_FORMATS``."""
    out = [f"%FLAG {name}", f"%FORMAT({fmt})"]
    values = list(values)
    if fmt == "20a4":
        per, cell = 20, lambda v: f"{str(v)[:4]:<4s}"
    elif fmt == "10I8":
        per, cell = 10, lambda v: f"{int(v):8d}"
    else:
        per, width, dec = _REAL_FORMATS[fmt]
        cell = lambda v: f"{float(v):{width}.{dec}E}".replace("E", exponent)  # noqa: E731
    for k in range(0, len(values), per):
        out.append("".join(cell(v) for v in values[k : k + per]))
    if not values:
        out.append("")
    return "\n".join(out) + "\n"


def _pair_index(i, j):
    """1-based index of the unordered type pair (i, j) (0-based types) in
    the triangular ``LENNARD_JONES_*COEF`` tables."""
    i, j = min(i, j), max(i, j)
    return j * (j + 1) // 2 + i + 1


def _is_h(masses, atoms):
    return bool(np.any(np.asarray(masses)[list(atoms)] < 1.5))


def write_prmtop(path, tables, names, types, res_ids, res_names, chamber=True,
                 charge_format=None, exponent="E", scale_factors=True):
    """Write ``tables`` (numpy arrays named as the fields of ``FFParams``:
    masses, charges, bonds, bond_params, angles, angle_params, dihedrals,
    dihedral_params, dihedral_term_mask, impropers, improper_params,
    improper_term_mask, idx14, nb14_params, lj_a_pair, lj_b_pair, and for a
    chamber file ub_bonds, ub_params) as a prmtop.

    Each dihedral term is one row. A dihedral whose end pair is in
    ``idx14`` carries the pair on its first row only; every other row has a
    negative third atom, so a reader builds each 1-4 pair once. A row with
    atom 0 third or fourth (where the sign flag cannot sit) is written
    reversed. A chamber file holds the impropers as harmonic CHARMM
    impropers and the 1-4 pairs' A and B in its own 1-4 tables; a plain
    AMBER file holds the impropers as dihedral rows with a negative fourth
    atom, and its 1-4 pairs take the ordinary tables.
    ``charge_format`` defaults to the chamber's wider ``3E24.16`` or to
    ``5E16.8``; ``exponent="D"`` writes Fortran exponents;
    ``scale_factors=False`` leaves out ``SCEE/SCNB_SCALE_FACTOR``."""
    t = {k: np.asarray(v) for k, v in tables.items()}
    n = len(t["masses"])
    masses = t["masses"].astype(np.float64)
    charges = t["charges"].astype(np.float64)
    charge_format = charge_format or ("3E24.16" if chamber else "5E16.8")

    # dihedral rows: one per term; the 1-4 pair on the first row of its
    # dihedral, where the pair is in idx14
    pair14 = {}
    for (i, j), row in zip(t["idx14"], t["nb14_params"]):
        pair14.setdefault((min(i, j), max(i, j)), row)
    taken = set()
    dih_rows, dih_types = [], []  # (a, b, c, d, type), (k, per, phase, scee, scnb)

    def add_row(atoms, k, phase, per, improper):
        a = [int(x) for x in atoms]
        if a[2] == 0 or a[3] == 0:
            a = a[::-1]
        key = (min(a[0], a[3]), max(a[0], a[3]))
        with14 = not improper and key in pair14 and key not in taken
        if with14:
            taken.add(key)
        scnb, scee = (pair14[key][2], pair14[key][3]) if key in pair14 else (2.0, 1.2)
        dih_types.append((k, per, phase, scee, scnb))
        row = [3 * a[0], 3 * a[1], 3 * a[2], 3 * a[3], len(dih_types)]
        if not with14:
            row[2] = -row[2]
        if improper:
            row[3] = -row[3]
        dih_rows.append((_is_h(masses, a), row))

    for d, params, mask in zip(t["dihedrals"], t["dihedral_params"], t["dihedral_term_mask"]):
        for (k, phase, per), live in zip(params, mask):
            if live:
                add_row(d, k, phase, per, improper=False)
    if not chamber:
        for d, params, mask in zip(t["impropers"], t["improper_params"],
                                   t["improper_term_mask"]):
            for (k, phase, per), live in zip(params, mask):
                if live:
                    add_row(d, k, phase, per, improper=True)
    missing = set(pair14) - taken
    if missing:
        raise ValueError(f"1-4 pairs on no dihedral: {sorted(missing)[:5]}")

    bond_rows = [(_is_h(masses, b), [3 * int(b[0]), 3 * int(b[1]), k + 1])
                 for k, b in enumerate(t["bonds"])]
    angle_rows = [(_is_h(masses, a), [3 * int(a[0]), 3 * int(a[1]), 3 * int(a[2]), k + 1])
                  for k, a in enumerate(t["angles"])]

    def split(rows):
        with_h = [v for r in rows if r[0] for v in r[1]]
        without_h = [v for r in rows if not r[0] for v in r[1]]
        return with_h, without_h

    bonds_h, bonds_n = split(bond_rows)
    angles_h, angles_n = split(angle_rows)
    dih_h, dih_n = split(dih_rows)

    # one Lennard-Jones type per atom
    npairs = n * (n + 1) // 2
    acoef, bcoef = np.zeros(npairs), np.zeros(npairs)
    a14, b14 = np.zeros(npairs), np.zeros(npairs)
    nb_index = np.zeros((n, n), np.int64)
    for i in range(n):
        for j in range(n):
            nb_index[i, j] = _pair_index(i, j)
    iu, ju = np.triu_indices(n)
    acoef[nb_index[iu, ju] - 1] = t["lj_a_pair"][iu, ju]
    bcoef[nb_index[iu, ju] - 1] = t["lj_b_pair"][iu, ju]
    for (i, j), row in pair14.items():
        a14[nb_index[i, j] - 1], b14[nb_index[i, j] - 1] = row[0], row[1]

    res_start = [0] + [k for k in range(1, n) if res_ids[k] != res_ids[k - 1]]
    res_labels = [res_names[k] for k in res_start]
    n_imp = len(t["impropers"]) if chamber else 0
    pointers = [
        n, n, len(bonds_h) // 3, len(bonds_n) // 3, len(angles_h) // 4, len(angles_n) // 4,
        len(dih_h) // 5, len(dih_n) // 5, 0, 0, 0, len(res_start), len(bonds_n) // 3,
        len(angles_n) // 4, len(dih_n) // 5, len(t["bonds"]), len(t["angles"]),
        len(dih_types), n, 0, 0, 0, 0, 0, 0, 0, 0, 0,
        max(np.diff(res_start + [n])), 0, 0,
    ]

    def real(name, values, fmt="5E16.8"):
        return _section(name, fmt, values, exponent)

    blocks = ["%VERSION  VERSION_STAMP = V0001.000  DATE = 01/01/26  00:00:00\n"]
    if chamber:
        blocks.append(_section("CTITLE", "20a4", ["MDX"]))
        blocks.append("%FLAG FORCE_FIELD_TYPE\n%FORMAT(i2,a78)\n"
                      " 1 CHARMM  22       *>>>>>>>>CHARMM22 All-Hydrogen Topology File\n")
    else:
        blocks.append(_section("TITLE", "20a4", ["MDX"]))
    blocks += [
        _section("POINTERS", "10I8", pointers),
        _section("ATOM_NAME", "20a4", names),
        real("CHARGE", charges * AMBER_CHARGE_FACTOR, charge_format),
        _section("ATOMIC_NUMBER", "10I8", [0] * n),
        real("MASS", masses),
        _section("ATOM_TYPE_INDEX", "10I8", range(1, n + 1)),
        _section("NUMBER_EXCLUDED_ATOMS", "10I8", [1] * n),
        _section("NONBONDED_PARM_INDEX", "10I8", nb_index.ravel()),
        _section("RESIDUE_LABEL", "20a4", res_labels),
        _section("RESIDUE_POINTER", "10I8", [k + 1 for k in res_start]),
        real("BOND_FORCE_CONSTANT", t["bond_params"][:, 0]),
        real("BOND_EQUIL_VALUE", t["bond_params"][:, 1]),
        real("ANGLE_FORCE_CONSTANT", t["angle_params"][:, 0]),
        real("ANGLE_EQUIL_VALUE", t["angle_params"][:, 1]),
        real("DIHEDRAL_FORCE_CONSTANT", [d[0] for d in dih_types]),
        real("DIHEDRAL_PERIODICITY", [d[1] for d in dih_types]),
        real("DIHEDRAL_PHASE", [d[2] for d in dih_types]),
    ]
    if scale_factors:
        blocks += [real("SCEE_SCALE_FACTOR", [d[3] for d in dih_types]),
                   real("SCNB_SCALE_FACTOR", [d[4] for d in dih_types])]
    blocks += [
        real("LENNARD_JONES_ACOEF", acoef),
        real("LENNARD_JONES_BCOEF", bcoef),
    ]
    if chamber:
        blocks += [real("LENNARD_JONES_14_ACOEF", a14), real("LENNARD_JONES_14_BCOEF", b14)]
    blocks += [
        _section("BONDS_INC_HYDROGEN", "10I8", bonds_h),
        _section("BONDS_WITHOUT_HYDROGEN", "10I8", bonds_n),
        _section("ANGLES_INC_HYDROGEN", "10I8", angles_h),
        _section("ANGLES_WITHOUT_HYDROGEN", "10I8", angles_n),
        _section("DIHEDRALS_INC_HYDROGEN", "10I8", dih_h),
        _section("DIHEDRALS_WITHOUT_HYDROGEN", "10I8", dih_n),
        _section("AMBER_ATOM_TYPE", "20a4", types),
    ]
    if chamber:
        ub = t.get("ub_bonds", np.zeros((0, 2), np.int64))
        ubp = t.get("ub_params", np.zeros((0, 2)))
        blocks += [
            _section("CHARMM_UREY_BRADLEY_COUNT", "10I8", [len(ub), len(ub)]),
            _section("CHARMM_UREY_BRADLEY", "10I8",
                     [v for k, (i, j) in enumerate(ub) for v in (i + 1, j + 1, k + 1)]),
            real("CHARMM_UREY_BRADLEY_FORCE_CONSTANT", ubp[:, 0]),
            real("CHARMM_UREY_BRADLEY_EQUIL_VALUE", ubp[:, 1]),
            _section("CHARMM_NUM_IMPROPERS", "10I8", [n_imp]),
            _section("CHARMM_IMPROPERS", "10I8",
                     [v for k, d in enumerate(t["impropers"])
                      for v in (*(int(x) + 1 for x in d), k + 1)]),
            _section("CHARMM_NUM_IMPR_TYPES", "10I8", [n_imp]),
            real("CHARMM_IMPROPER_FORCE_CONSTANT", t["improper_params"][:, 0, 0]),
            real("CHARMM_IMPROPER_PHASE", t["improper_params"][:, 0, 1]),
        ]
    with open(path, "w") as fh:
        fh.write("".join(blocks))


def chain_tables(n=6, seed=0, impropers_periodic=True):
    """Force-field tables of a small unbranched chain of ``n`` atoms (every
    third a hydrogen by mass), made from ``seed``: the bonded tables of the
    chain, one periodic improper, 1-4 pairs on every dihedral with the
    ordinary LJ values and AMBER's 1/2.0 and 1/1.2 scalings, and a
    Urey-Bradley spring per angle. Returns (tables, names, types, res_ids,
    res_names)."""
    rng = np.random.default_rng(seed)
    masses = np.where(np.arange(n) % 3 == 2, 1.008, 12.011)
    charges = rng.normal(0.0, 0.3, n)
    bonds = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    angles = np.stack([np.arange(n - 2), np.arange(1, n - 1), np.arange(2, n)], 1)
    dihedrals = np.stack([np.arange(n - 3) + k for k in range(4)], 1)
    nd = len(dihedrals)
    dih_params = np.zeros((nd, 2, 3))
    dih_params[:, :, 2] = 1.0
    dih_params[:, 0] = np.stack([rng.uniform(0.1, 1.0, nd), np.full(nd, math.pi),
                                 rng.integers(1, 4, nd)], 1)
    dih_mask = np.zeros((nd, 2), bool)
    dih_mask[:, 0] = True
    dih_params[0, 1] = (0.3, 0.0, 3.0)  # a two-term dihedral
    dih_mask[0, 1] = True
    sig = rng.uniform(1.5, 2.0, n)
    eps = rng.uniform(0.05, 0.2, n)
    s = 0.5 * (sig[:, None] + sig[None, :])
    e = np.sqrt(eps[:, None] * eps[None, :])
    lj_a, lj_b = 4 * e * s**12, 4 * e * s**6
    idx14 = dihedrals[:, [0, 3]]
    nb14 = np.stack([lj_a[idx14[:, 0], idx14[:, 1]], lj_b[idx14[:, 0], idx14[:, 1]],
                     np.full(nd, 2.0), np.full(nd, 1.2)], 1)
    impropers = np.array([[0, 2, 1, 3]])
    improper_params = (np.array([[[1.1, math.pi, 2.0]]]) if impropers_periodic
                       else np.array([[[20.0, 0.1, 0.0]]]))
    tables = dict(
        masses=masses, charges=charges, bonds=bonds,
        bond_params=np.stack([rng.uniform(200, 400, n - 1), rng.uniform(1.0, 1.5, n - 1)], 1),
        angles=angles,
        angle_params=np.stack([rng.uniform(30, 60, n - 2), rng.uniform(1.8, 2.0, n - 2)], 1),
        dihedrals=dihedrals, dihedral_params=dih_params, dihedral_term_mask=dih_mask,
        impropers=impropers, improper_params=improper_params,
        improper_term_mask=np.ones((1, 1), bool),
        idx14=idx14, nb14_params=nb14, lj_a_pair=lj_a, lj_b_pair=lj_b,
        ub_bonds=angles[:, [0, 2]],
        ub_params=np.stack([rng.uniform(5, 20, n - 2), rng.uniform(2.0, 2.5, n - 2)], 1),
    )
    names = np.array([("H" if m < 1.5 else "C") + str(k) for k, m in enumerate(masses)])
    types = np.array([("HA" if m < 1.5 else "CT") for m in masses])
    res_ids = np.arange(n) // 3 + 1
    res_names = np.array(["ALA"] * n)
    return tables, names, types, res_ids, res_names


#: the backbone parameters ``write_charmm_prm`` writes (CHARMM22-like
#: values; wildcards, a two-term dihedral, 1-4 overrides on some types)
_PRM_BODY = """* backbone test parameters
*

BONDS
C     NH1   370.000   1.3450
NH1   CT1   320.000   1.4300
NH1   CT2   320.000   1.4300
CT1   C     250.000   1.4900
CT2   C     250.000   1.4900
C     O     620.000   1.2300
NH1   H     440.000   0.9970
CT1   HB    330.000   1.0800

ANGLES
C     NH1   CT1    50.000   120.00
C     NH1   CT2    50.000   120.00
NH1   CT1   C      50.000   107.00   20.00   2.4000
NH1   CT2   C      50.000   107.00
CT1   C     NH1    80.000   116.50
CT2   C     NH1    80.000   116.50
X     NH1   X      34.000   117.00
X     C     X      40.000   120.00   30.00   2.3500

DIHEDRALS
C     NH1   CT1   C        0.2000  1   180.00
C     NH1   CT1   C        0.3000  3     0.00
X     CT1   NH1   X        0.0000  1     0.00
X     CT2   NH1   X        0.0000  1     0.00
X     C     CT1   X        0.0000  1     0.00
X     C     CT2   X        0.0000  1     0.00
X     NH1   C     X        2.5000  2   180.00

IMPROPER
O     X     X     C      120.0000  0     0.0000
NH1   C     CT1   H       20.0000  0     0.0000

"""

_PRM_NONBONDED = """NONBONDED nbxmod  5 atom cdiel shift vatom vdistance vswitch -
cutnb 14.0 ctofnb 12.0 ctonnb 10.0 eps 1.0 e14fac 1.0 wmin 1.5

C        0.000000  -0.110000     2.000000
CT1      0.000000  -0.020000     2.275000   0.000000  -0.010000     1.900000
CT2      0.000000  -0.055000     2.175000   0.000000  -0.010000     1.900000
NH1      0.000000  -0.200000     1.850000   0.000000  -0.200000     1.550000
O        0.000000  -0.120000     1.700000   0.000000  -0.120000     1.400000
H        0.000000  -0.046000     0.224500
HB       0.000000  -0.022000     1.320000

END
"""


def write_charmm_prm(path, cmaps):
    """A small CHARMM parameter file for a protein backbone (types C, NH1,
    CT1, CT2, O, H, HB): bonds, angles with Urey-Bradley terms, dihedrals
    with wildcards and a two-term entry, impropers, nonbonded entries with
    1-4 overrides, and a CMAP section holding ``cmaps`` (8-type key -> (G,
    G) grid), each map a header of the 8 types and G, then one block of
    five values a line for each phi, as CHARMM writes them."""
    lines = [_PRM_BODY, "CMAP", ""]
    for key, grid in cmaps.items():
        g = grid.shape[0]
        lines += [" ".join(key) + f" {g}", ""]
        for i in range(g):
            lines.append(f"!phi = {-180.0 + i * 360.0 / g:.1f}")
            for k in range(0, g, 5):
                lines.append(" ".join(f"{v:.6f}" for v in grid[i, k : k + 5]))
            lines.append("")
    lines += ["", _PRM_NONBONDED]
    with open(path, "w") as fh:
        fh.write("\n".join(lines))


def write_backbone_psf(path, residues, cross_terms=()):
    """A PSF of backbone atoms N, CA, C per residue. ``residues`` lists
    (segment, res_id, CA type); N is NH1 and C is C. Bonds run along each
    segment between residues of consecutive res_ids. ``cross_terms`` (rows
    of 8 0-based atoms) become the ``!NCRTERM`` section."""
    atoms, bonds = [], []
    for k, (seg, rid, ca_type) in enumerate(residues):
        base = 3 * k
        for name, typ, q, m in (("N", "NH1", -0.47, 14.007), ("CA", ca_type, 0.07, 12.011),
                                ("C", "C", 0.51, 12.011)):
            atoms.append((seg, rid, name, typ, q, m))
        bonds += [(base, base + 1), (base + 1, base + 2)]
        if k and residues[k - 1][0] == seg and residues[k - 1][1] == rid - 1:
            bonds.append((base - 1, base))
    out = ["PSF", "", "       1 !NTITLE", " REMARKS test backbone", "",
           f"{len(atoms):8d} !NATOM"]
    for i, (seg, rid, name, typ, q, m) in enumerate(atoms):
        out.append(f"{i + 1:8d} {seg:<4s} {rid:<4d} ALA  {name:<4s} {typ:<4s} "
                   f"{q:10.6f} {m:13.4f}           0")
    out += ["", f"{len(bonds):8d} !NBOND: bonds"]
    flat = [v + 1 for b in bonds for v in b]
    for k in range(0, len(flat), 8):
        out.append("".join(f"{v:8d}" for v in flat[k : k + 8]))
    out += ["", "       0 !NTHETA: angles", "", "       0 !NPHI: dihedrals", "",
            "       0 !NIMPHI: impropers", ""]
    rows = [v + 1 for r in cross_terms for v in r]
    out.append(f"{len(cross_terms):8d} !NCRTERM: cross-terms")
    for k in range(0, len(rows), 8):
        out.append("".join(f"{v:8d}" for v in rows[k : k + 8]))
    out.append("")
    with open(path, "w") as fh:
        fh.write("\n".join(out) + "\n")


def smooth_cmap(g=24, seed=0, scale=2.0):
    """A smooth periodic (G, G) correction map in kcal/mol: a few cosines
    of phi, psi and phi + psi, of amplitude ``scale``, made from ``seed``."""
    rng = np.random.default_rng(seed)
    ang = -math.pi + 2 * math.pi * np.arange(g) / g
    phi, psi = np.meshgrid(ang, ang, indexing="ij")
    out = np.zeros((g, g))
    for a, b in ((1, 0), (0, 1), (1, 1), (2, 1), (1, -2)):
        amp, ph = rng.uniform(0.2, 1.0) * scale, rng.uniform(0, 2 * math.pi)
        out += amp * np.cos(a * phi + b * psi + ph)
    return out
