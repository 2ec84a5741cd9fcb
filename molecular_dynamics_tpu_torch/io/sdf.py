"""MDL SDF (V2000 ctab) reader.

Multi-record SD files with V2000 connection tables, fixed-column atom/bond
blocks, atom-block charge codes, and ``M  CHG`` property overrides, into
plain numpy like every other reader of ``io``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# V2000 atom-block charge column code -> formal charge (0 = uncharged,
# 4 = doublet radical, which carries no charge)
_CHG_CODE = {0: 0, 1: 3, 2: 2, 3: 1, 4: 0, 5: -1, 6: -2, 7: -3}


def _read_record(lines: List[str]) -> Dict[str, np.ndarray]:
    counts = lines[3]
    n_atoms = int(counts[0:3])
    n_bonds = int(counts[3:6])
    coords = np.empty((n_atoms, 3), np.float64)
    elements = np.empty(n_atoms, object)
    charges = np.zeros(n_atoms, np.int64)
    for i in range(n_atoms):
        ln = lines[4 + i]
        coords[i] = (float(ln[0:10]), float(ln[10:20]), float(ln[20:30]))
        elements[i] = ln[31:34].strip()
        code = int(ln[36:39]) if len(ln) >= 39 and ln[36:39].strip() else 0
        charges[i] = _CHG_CODE.get(code, 0)
    bonds = np.empty((n_bonds, 2), np.int64)
    bond_types = np.empty(n_bonds, object)
    for k in range(n_bonds):
        ln = lines[4 + n_atoms + k]
        bonds[k] = (int(ln[0:3]) - 1, int(ln[3:6]) - 1)
        bond_types[k] = ln[6:9].strip()
    # property block: M  CHG supersedes ALL atom-block charge columns
    m_chg_seen = False
    for ln in lines[4 + n_atoms + n_bonds :]:
        if ln.startswith("M  CHG"):
            if not m_chg_seen:
                charges[:] = 0
                m_chg_seen = True
            f = ln.split()
            for a, c in zip(f[3::2], f[4::2]):
                charges[int(a) - 1] = int(c)
        elif ln.startswith("M  END"):
            break
    return {
        "coords": coords,
        "elements": elements,
        "charges": charges,
        "bonds": bonds,
        "bond_types": bond_types,
        "name": lines[0].strip(),
    }


def read_sdf(path: str) -> List[Dict[str, np.ndarray]]:
    """Parse every record of an SD file.

    Returns a list of dicts, one per ``$$$$``-terminated record, each with
    ``coords`` (N, 3) float64, ``elements`` (N,) object, ``charges`` (N,)
    int64 formal charges, ``bonds`` (B, 2) int64 0-based, ``bond_types``
    (B,) object (``1`` single / ``2`` double / ``3`` triple / ``4``
    aromatic), and ``name`` (header line 1).
    """
    records: List[Dict[str, np.ndarray]] = []
    chunk: List[str] = []
    with open(path) as fh:
        for raw in fh:
            if raw.startswith("$$$$"):
                if len(chunk) >= 4:
                    records.append(_read_record(chunk))
                chunk = []
            else:
                chunk.append(raw.rstrip("\n"))
    if len(chunk) >= 4 and chunk[3][0:3].strip().isdigit():
        records.append(_read_record(chunk))  # unterminated final record
    return records
