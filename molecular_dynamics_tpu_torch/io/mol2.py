"""Tripos MOL2 reader/writer.

Protein/ligand MOL2 files with ATOM/BOND/MOLECULE record-type-indicator
blocks, parsed per the Tripos MOL2 spec into plain numpy like every other
reader of ``io``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def read_mol2(path: str) -> Dict[str, np.ndarray]:
    """Parse the first molecule of a MOL2 file.

    Returns a dict with ``coords`` (N, 3) float64, ``names`` /
    ``atom_types`` / ``resnames`` (N,) object, ``resids`` (N,) int64,
    ``charges`` (N,) float64, ``elements`` (N,) object (SYBYL type before
    the dot), ``bonds`` (B, 2) int64 0-based, and ``bond_types`` (B,)
    object (``1``/``2``/``3``/``am``/``ar``/``du``/``un``/``nc``).
    """
    section = None
    coords: List[List[float]] = []
    names: List[str] = []
    atom_types: List[str] = []
    resnames: List[str] = []
    resids: List[int] = []
    charges: List[float] = []
    bonds: List[List[int]] = []
    bond_types: List[str] = []
    n_molecules = 0
    with open(path) as fh:
        for raw in fh:
            line = raw.strip()
            if line.startswith("@<TRIPOS>"):
                section = line[9:].upper()
                if section == "MOLECULE":
                    n_molecules += 1
                    if n_molecules > 1:
                        break  # first molecule only
                continue
            if not line or line.startswith("#") or section is None:
                continue
            if section == "ATOM":
                # id name x y z type [subst_id [subst_name [charge]]]
                f = line.split()
                names.append(f[1])
                coords.append([float(f[2]), float(f[3]), float(f[4])])
                atom_types.append(f[5])
                resids.append(int(f[6]) if len(f) > 6 else 1)
                resnames.append(f[7] if len(f) > 7 else "UNK")
                charges.append(float(f[8]) if len(f) > 8 else 0.0)
            elif section == "BOND":
                # id origin target type
                f = line.split()
                bonds.append([int(f[1]) - 1, int(f[2]) - 1])
                bond_types.append(f[3] if len(f) > 3 else "1")
    elements = [t.split(".")[0] for t in atom_types]
    return {
        "coords": np.array(coords, np.float64).reshape(-1, 3),
        "names": np.array(names, object),
        "atom_types": np.array(atom_types, object),
        "elements": np.array(elements, object),
        "resnames": np.array(resnames, object),
        "resids": np.array(resids, np.int64),
        "charges": np.array(charges, np.float64),
        "bonds": np.array(bonds, np.int64).reshape(-1, 2),
        "bond_types": np.array(bond_types, object),
    }


def write_mol2(
    path: str,
    coords: np.ndarray,
    names: np.ndarray,
    atom_types: Optional[np.ndarray] = None,
    charges: Optional[np.ndarray] = None,
    bonds: Optional[np.ndarray] = None,
    bond_types: Optional[np.ndarray] = None,
    resnames: Optional[np.ndarray] = None,
    resids: Optional[np.ndarray] = None,
    mol_name: str = "MOL",
):
    """Write a single-molecule MOL2 file (SMALL / USER_CHARGES)."""
    coords = np.asarray(coords, np.float64).reshape(-1, 3)
    n = len(coords)
    names = np.asarray(names, object)
    if atom_types is None:
        atom_types = names
    if charges is None:
        charges = np.zeros(n)
    if bonds is None:
        bonds = np.zeros((0, 2), np.int64)
    bonds = np.asarray(bonds, np.int64).reshape(-1, 2)
    if bond_types is None:
        bond_types = np.array(["1"] * len(bonds), object)
    if resnames is None:
        resnames = np.array(["UNK"] * n, object)
    if resids is None:
        resids = np.ones(n, np.int64)
    with open(path, "w") as fh:
        fh.write("@<TRIPOS>MOLECULE\n")
        fh.write(f"{mol_name}\n")
        fh.write(f"{n} {len(bonds)} 0 0 0\n")
        fh.write("SMALL\nUSER_CHARGES\n")
        fh.write("@<TRIPOS>ATOM\n")
        for i in range(n):
            x, y, z = coords[i]
            fh.write(
                f"{i + 1:>7d} {names[i]:<8s} {x:>10.4f} {y:>10.4f} "
                f"{z:>10.4f} {atom_types[i]:<8s} {int(resids[i]):>4d} "
                f"{resnames[i]:<8s} {float(charges[i]):>10.4f}\n"
            )
        fh.write("@<TRIPOS>BOND\n")
        for k, (i, j) in enumerate(bonds):
            fh.write(
                f"{k + 1:>6d} {int(i) + 1:>5d} {int(j) + 1:>5d} "
                f"{bond_types[k]:>4s}\n"
            )
