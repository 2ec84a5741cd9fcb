"""AMBER PRMTOP topology/parameter reader: plain AMBER and CHARMM chamber.

The prmtop is both the topology and the parameter source. This reader
parses the ``%FORMAT`` descriptors directly, so both flavours work as they
are (a chamber file's ``CHARGE`` field is wider than plain AMBER's: numeric
sections are split on whitespace, only the ``a`` sections are cut by their
width), and converts straight to dense ``FFParams``.

Conventions handled:
- CHARGE is stored scaled by 18.2223 (AMBER internal units),
- bond/angle/dihedral atom entries are ``3 * atom_index``; in dihedral rows a
  negative 3rd atom suppresses the 1-4 pair (multi-term duplicates / rings)
  and a negative 4th atom marks an improper,
- DIHEDRAL_PHASE is already in radians,
- LJ lookups go through NONBONDED_PARM_INDEX (1-based, ntypes x ntypes),
- chamber files add harmonic CHARMM impropers, Urey-Bradley 1-3 springs and
  dedicated 1-4 LJ tables (scnb/scee are 1.0 there).
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

from molecular_dynamics_tpu_torch import units
from molecular_dynamics_tpu_torch.ff.params import FFParams, finalize_ff_params
from molecular_dynamics_tpu_torch.topology import Topology

_FORMAT_RE = re.compile(r"%FORMAT\((\d*)([aIEF])(\d+)(?:\.\d+)?\)", re.IGNORECASE)


def _parse_raw(path: str) -> Dict[str, np.ndarray]:
    """Parse every %FLAG section into a numpy array (str/int/float)."""
    sections: Dict[str, np.ndarray] = {}
    with open(path) as fh:
        text = fh.read()
    for block in text.split("%FLAG")[1:]:
        lines = block.split("\n")
        name = lines[0].strip().split()[0]
        fmt_line = next((ln for ln in lines[1:] if ln.startswith("%FORMAT")), None)
        if fmt_line is None:
            continue
        m = _FORMAT_RE.match(fmt_line.strip())
        if not m:
            continue
        kind, width = m.group(2).upper(), int(m.group(3))
        data_lines = [ln for ln in lines[1:] if ln.strip() and not ln.startswith("%")]
        if kind == "A":
            vals: List[str] = []
            for ln in data_lines:
                vals += [ln[i : i + width].strip() for i in range(0, len(ln.rstrip()), width)]
            sections[name] = np.array(vals, object)
        else:
            tokens: List[str] = []
            for ln in data_lines:
                tokens += ln.split()
            dtype = np.int64 if kind == "I" else np.float64
            sections[name] = np.array(
                [t.replace("D", "E") for t in tokens], dtype=np.float64
            ).astype(dtype)
    return sections


def _rows(s: Dict[str, np.ndarray], with_h: str, without_h: str, width: int) -> np.ndarray:
    """The rows of a ``*_INC_HYDROGEN`` and a ``*_WITHOUT_HYDROGEN`` section,
    in that order, as (rows, width) int64."""
    return np.concatenate([
        np.asarray(s.get(with_h, []), np.int64).reshape(-1, width),
        np.asarray(s.get(without_h, []), np.int64).reshape(-1, width),
    ])


def read_prmtop(path: str):
    """Read a prmtop; returns (Topology, raw-section dict)."""
    s = _parse_raw(path)
    natom = int(s["POINTERS"][0])

    charges = s["CHARGE"][:natom] / units.AMBER_CHARGE_FACTOR
    masses = s["MASS"][:natom]
    names = s["ATOM_NAME"][:natom]
    types = s["AMBER_ATOM_TYPE"][:natom]

    res_labels = s["RESIDUE_LABEL"]
    res_ptr = s["RESIDUE_POINTER"].astype(np.int64) - 1
    res_names = np.empty(natom, object)
    res_ids = np.zeros(natom, np.int64)
    bounds = list(res_ptr) + [natom]
    for r in range(len(res_labels)):
        res_names[bounds[r] : bounds[r + 1]] = res_labels[r]
        res_ids[bounds[r] : bounds[r + 1]] = r + 1

    bond_rows = _rows(s, "BONDS_INC_HYDROGEN", "BONDS_WITHOUT_HYDROGEN", 3)
    angle_rows = _rows(s, "ANGLES_INC_HYDROGEN", "ANGLES_WITHOUT_HYDROGEN", 4)
    dih_rows = _rows(s, "DIHEDRALS_INC_HYDROGEN", "DIHEDRALS_WITHOUT_HYDROGEN", 5)
    propers = dih_rows[dih_rows[:, 3] >= 0]
    impropers = dih_rows[dih_rows[:, 3] < 0]

    top = Topology(
        atom_types=types.copy(),
        atom_names=names.copy(),
        res_names=res_names,
        res_ids=res_ids,
        charges=charges,
        masses=masses,
        bonds=bond_rows[:, :2] // 3,
        angles=angle_rows[:, :3] // 3,
        dihedrals=np.abs(propers[:, :4]) // 3,
        impropers=np.abs(impropers[:, :4]) // 3,
    )
    return top, s


def prmtop_to_ff_params(path: str, dtype=None, device=None) -> FFParams:
    """Build dense ``FFParams`` straight from a prmtop (both flavours).

    ``dtype`` (default float32) and ``device`` (``None``: the CUDA device)
    place the tensors; the GB/SASA per-atom tables ride along."""
    if dtype is None:
        dtype = torch.float32
    top, s = read_prmtop(path)
    ntypes = int(s["POINTERS"][1])
    chamber = "CHARMM_IMPROPERS" in s or "FORCE_FIELD_TYPE" in s

    # bonds / angles with per-instance parameters
    bond_rows = _rows(s, "BONDS_INC_HYDROGEN", "BONDS_WITHOUT_HYDROGEN", 3)
    bonds = bond_rows[:, :2] // 3
    bt = bond_rows[:, 2] - 1
    bond_params = np.stack([s["BOND_FORCE_CONSTANT"][bt], s["BOND_EQUIL_VALUE"][bt]], axis=1)

    angle_rows = _rows(s, "ANGLES_INC_HYDROGEN", "ANGLES_WITHOUT_HYDROGEN", 4)
    angles = angle_rows[:, :3] // 3
    at = angle_rows[:, 3] - 1
    angle_params = np.stack(
        [s["ANGLE_FORCE_CONSTANT"][at], s["ANGLE_EQUIL_VALUE"][at]], axis=1)

    # dihedrals: group multi-term entries by atom 4-tuple
    dih_rows = _rows(s, "DIHEDRALS_INC_HYDROGEN", "DIHEDRALS_WITHOUT_HYDROGEN", 5)
    proper = dih_rows[dih_rows[:, 3] >= 0]
    improper = dih_rows[dih_rows[:, 3] < 0]

    k_arr = s["DIHEDRAL_FORCE_CONSTANT"]
    per_arr = s["DIHEDRAL_PERIODICITY"]
    phase_arr = s["DIHEDRAL_PHASE"]
    scee_arr = s.get("SCEE_SCALE_FACTOR", np.full(len(k_arr), 1.2))
    scnb_arr = s.get("SCNB_SCALE_FACTOR", np.full(len(k_arr), 2.0))

    groups: Dict[tuple, List] = {}
    pairs14: List[tuple] = []
    for row in proper:
        atoms = tuple(np.abs(row[:4]) // 3)
        t = row[4] - 1
        groups.setdefault(atoms, []).append((k_arr[t], phase_arr[t], per_arr[t]))
        if row[2] >= 0:  # 1-4 pair not suppressed
            pairs14.append((atoms[0], atoms[3], t))
    dihedrals = np.array(list(groups), np.int64).reshape(-1, 4)
    dihedral_terms = list(groups.values())

    # LJ tables through NONBONDED_PARM_INDEX
    type_idx = np.asarray(s["ATOM_TYPE_INDEX"], np.int64) - 1
    nb_parm = np.asarray(s["NONBONDED_PARM_INDEX"], np.int64).reshape(ntypes, ntypes)
    acoef, bcoef = s["LENNARD_JONES_ACOEF"], s["LENNARD_JONES_BCOEF"]
    ico = nb_parm[type_idx[:, None], type_idx[None, :]]
    valid = ico > 0
    idx = np.where(valid, ico - 1, 0)
    lj_a_pair = np.where(valid, acoef[idx], 0.0)
    lj_b_pair = np.where(valid, bcoef[idx], 0.0)

    # 1-4 pairs
    if chamber and "LENNARD_JONES_14_ACOEF" in s:
        a14_tab, b14_tab = s["LENNARD_JONES_14_ACOEF"], s["LENNARD_JONES_14_BCOEF"]
    else:
        a14_tab, b14_tab = acoef, bcoef
    idx14 = np.array([(i, j) for i, j, _ in pairs14], np.int64).reshape(-1, 2)
    nb14 = []
    for i, j, t in pairs14:
        c = nb_parm[type_idx[i], type_idx[j]]
        a14, b14 = (a14_tab[c - 1], b14_tab[c - 1]) if c > 0 else (0.0, 0.0)
        nb14.append((a14, b14, scnb_arr[t], scee_arr[t]))
    nb14 = np.array(nb14).reshape(-1, 4)

    # impropers
    if chamber and "CHARMM_IMPROPERS" in s:
        imp_rows = np.asarray(s["CHARMM_IMPROPERS"], np.int64).reshape(-1, 5)
        imp_idx = imp_rows[:, :4] - 1  # chamber stores plain 1-based atoms
        it = imp_rows[:, 4] - 1
        ik = s["CHARMM_IMPROPER_FORCE_CONSTANT"][it]
        iph = s["CHARMM_IMPROPER_PHASE"][it]
        improper_terms = [[(k, p, 0.0)] for k, p in zip(ik, iph)]  # harmonic
    else:
        imp_idx = np.abs(improper[:, :4]) // 3
        improper_terms = [[(k_arr[t], phase_arr[t], per_arr[t])] for t in improper[:, 4] - 1]

    # chamber Urey-Bradley 1-3 springs
    ub_bonds = np.zeros((0, 2), np.int64)
    ub_params = np.zeros((0, 2))
    if chamber and "CHARMM_UREY_BRADLEY" in s and int(
        s.get("CHARMM_UREY_BRADLEY_COUNT", [0])[0]
    ):
        ub_rows = np.asarray(s["CHARMM_UREY_BRADLEY"], np.int64).reshape(-1, 3)
        ub_bonds = ub_rows[:, :2] - 1
        ut = ub_rows[:, 2] - 1
        ub_params = np.stack([
            s["CHARMM_UREY_BRADLEY_FORCE_CONSTANT"][ut],
            s["CHARMM_UREY_BRADLEY_EQUIL_VALUE"][ut],
        ], axis=1)

    from molecular_dynamics_tpu_torch.solvent import attach_gb_params, infer_elements

    params = finalize_ff_params(
        masses=top.masses,
        charges=top.charges,
        bonds=bonds,
        bond_params=bond_params,
        angles=angles,
        angle_params=angle_params,
        dihedrals=dihedrals,
        dihedral_terms=dihedral_terms,
        impropers=imp_idx,
        improper_terms=improper_terms,
        idx14=idx14,
        nb14_params=nb14,
        lj_a_pair=lj_a_pair,
        lj_b_pair=lj_b_pair,
        ub_bonds=ub_bonds,
        ub_params=ub_params,
        dtype=dtype,
        device=device,
    )
    # GB/SASA tables (inert until "gb"/"sasa" terms are enabled)
    return attach_gb_params(params, elements=infer_elements(top.masses, top.atom_names))
