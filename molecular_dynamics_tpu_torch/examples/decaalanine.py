"""Deca-alanine backbone example system (40 atoms), fully self-contained.

The source project's primary workload: the 40-atom backbone representation
of deca-alanine. The topology is *generated* (same atom ordering, bond
graph, impropers and CHARMM-derived backbone parameters as the source's
``backbone.psf`` + ``param_bb-4.0.yaml``), so nothing outside the package is
read. Pure numpy, equal to the JAX package's ``examples.decaalanine``.

Atom ordering matches the source PSF: residues 1-9 are (N, CA, C, O);
residue 10 is (C, O, N, CA), so the end-to-end colvar groups are atoms 0
and 39.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from molecular_dynamics_tpu_torch.topology import Topology
from molecular_dynamics_tpu_torch.build import angles_from_bonds, dihedrals_from_bonds

#: CHARMM-derived backbone force-field parameters in the YAML force-field
#: schema (same physical constants as param_bb-4.0.yaml; pure data).
BACKBONE_FF_PRM = {
    "atomtypes": ["N", "CA", "C", "O"],
    "bonds": {
        "(N, CA)": {"k0": 320.0, "req": 1.43},
        "(C, CA)": {"k0": 250.0, "req": 1.49},
        "(C, N)": {"k0": 370.0, "req": 1.345},
        "(O, C)": {"k0": 620.0, "req": 1.23},
    },
    "angles": {
        "(N, CA, C)": {"k0": 50.0, "theta0": 107.0},
        "(O, C, CA)": {"k0": 80.0, "theta0": 121.0},
        "(O, C, N)": {"k0": 80.0, "theta0": 122.5},
        "(CA, N, C)": {"k0": 50.0, "theta0": 120.0},
        "(CA, C, N)": {"k0": 80.0, "theta0": 116.5},
    },
    "dihedrals": {
        "(N, CA, C, N)": {"terms": {"term1": {"phi_k": 0.4, "per": 1, "phase": 0.0}}},
        "(N, CA, C, O)": {"terms": {"term1": {"phi_k": 0.0, "per": 1, "phase": 0.0}}},
        "(CA, C, N, CA)": {"terms": {"term1": {"phi_k": 1.6, "per": 1, "phase": 0.0}}},
        "(C, N, CA, C)": {"terms": {"term1": {"phi_k": 0.2, "per": 1, "phase": 180.0}}},
        "(O, C, N, CA)": {"terms": {"term1": {"phi_k": 2.5, "per": 2, "phase": 180.0}}},
    },
    "impropers": {
        "(O, CA, N, C)": {"phi_k": 45.0, "per": 0, "phase": 0.0},
        "(CA, O, C, N)": {"phi_k": 45.0, "per": 0, "phase": 0.0},
    },
    "lj": {
        # CHARMM-style values in the source's (swapped) yaml fields, fed
        # through the same Lorentz-Berthelot A/B formula for parity.
        "N": {"sigma": -0.2, "epsilon": 3.7, "epsilon14": -0.2, "sigma14": 3.1},
        "CA": {"sigma": -0.032, "epsilon": 4.0, "epsilon14": -0.01, "sigma14": 3.8},
        "C": {"sigma": -0.11, "epsilon": 4.0, "epsilon14": -0.01, "sigma14": 3.8},
        "O": {"sigma": -0.12, "epsilon": 3.4, "epsilon14": -0.12, "sigma14": 2.8},
    },
    "electrostatics": {
        "N": {"charge": -0.47},
        "CA": {"charge": 0.07},
        "C": {"charge": 0.51},
        "O": {"charge": -0.51},
    },
    "masses": {"N": 12.011, "CA": 12.011, "C": 12.011, "O": 15.999},
}

#: The source project's canonical SMD colvar configuration.
BACKBONE_COLVAR = {
    "name": "E2End Harm",
    "fk": 1.0,
    "cent_0": 12.0,
    "cent_1": 34.0,
    "T": 500000 / 50,
    "group1": [0],
    "group2": [39],
}

_N_RES = 10


def _backbone_connectivity() -> Tuple[np.ndarray, np.ndarray]:
    """Atom metadata + bond list in the source PSF's atom ordering."""
    names = []
    res_ids = []
    # residues 1..9: N CA C O; residue 10: C O N CA
    for r in range(1, _N_RES):
        names += ["N", "CA", "C", "O"]
        res_ids += [r] * 4
    names += ["C", "O", "N", "CA"]
    res_ids += [_N_RES] * 4

    idx = {}  # (resid, name) -> atom index
    for i, (r, nm) in enumerate(zip(res_ids, names)):
        idx[(r, nm)] = i

    bonds = []
    for r in range(1, _N_RES + 1):
        bonds.append((idx[(r, "N")], idx[(r, "CA")]))
        bonds.append((idx[(r, "CA")], idx[(r, "C")]))
        bonds.append((idx[(r, "C")], idx[(r, "O")]))
        if r < _N_RES:
            bonds.append((idx[(r, "C")], idx[(r + 1, "N")]))
    return (
        np.array(names, object),
        np.array(res_ids, np.int64),
        np.array(bonds, np.int64),
        idx,
    )


def _backbone_impropers(idx) -> np.ndarray:
    """Carbonyl planarity impropers, one per peptide bond: (C, CA, N+1, O)
    matching the source PSF's NIMPHI pattern (3 2 5 4, 1-based)."""
    rows = []
    for r in range(1, _N_RES):
        rows.append(
            (idx[(r, "C")], idx[(r, "CA")], idx[(r + 1, "N")], idx[(r, "O")])
        )
    return np.array(rows, np.int64)


def _ideal_coordinates(n_atoms: int) -> np.ndarray:
    """Compact helical starting coordinates with reasonable bond geometry.

    A gentle helix whose end-to-end distance lands near the SMD start
    (~12 A), built from per-residue backbone offsets. Meant to be relaxed by
    ``minimize_fire`` before dynamics, like NAMD's ``minimize 500``.
    """
    # local offsets of N, CA, C, O within one residue (A)
    local = {
        "N": np.array([0.0, 0.0, 0.0]),
        "CA": np.array([1.20, 0.70, 0.30]),
        "C": np.array([2.40, 0.00, 0.90]),
        "O": np.array([2.50, -1.20, 0.80]),
    }
    rise, turn_deg, radius = 1.5, 100.0, 2.3  # alpha-helix-like
    coords = np.zeros((n_atoms, 3))
    names, res_ids, _, idx = _backbone_connectivity()
    for i, (nm, r) in enumerate(zip(names, res_ids)):
        t = np.radians(turn_deg) * (r - 1)
        origin = np.array(
            [radius * np.cos(t), radius * np.sin(t), rise * (r - 1)]
        )
        rot = np.array(
            [[np.cos(t), -np.sin(t), 0.0], [np.sin(t), np.cos(t), 0.0], [0, 0, 1.0]]
        )
        coords[i] = origin + rot @ local[nm]
    return coords


def decaalanine_backbone() -> Tuple[Topology, np.ndarray]:
    """Build the 40-atom deca-alanine backbone: (Topology, start coords)."""
    names, res_ids, bonds, idx = _backbone_connectivity()
    n = len(names)
    angles = angles_from_bonds(bonds, n)
    dihedrals = dihedrals_from_bonds(bonds, n)
    impropers = _backbone_impropers(idx)

    charge_by = BACKBONE_FF_PRM["electrostatics"]
    mass_by = BACKBONE_FF_PRM["masses"]
    top = Topology(
        atom_types=names.copy(),
        atom_names=names.copy(),
        res_names=np.array(["ALA"] * n, object),
        res_ids=res_ids,
        charges=np.array([charge_by[t]["charge"] for t in names]),
        masses=np.array([mass_by[t] for t in names]),
        bonds=bonds,
        angles=angles,
        dihedrals=dihedrals,
        impropers=impropers,
    )
    return top, _ideal_coordinates(n)
