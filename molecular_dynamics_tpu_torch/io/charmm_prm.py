"""CHARMM parameter-file (.prm / .par) reader.

The NAMD pairing is a PSF topology + CHARMM PRM parameters. This parser
reads the BONDS / ANGLES / DIHEDRALS / IMPROPER / NONBONDED / CMAP sections
(including Urey-Bradley terms on angles and 1-4 NONBONDED overrides) and
exposes the same type-keyed getter protocol as
:class:`~molecular_dynamics_tpu_torch.ff.yaml_ff.YamlForceField`, so
``build_ff_params(read_psf(psf), CharmmPrm(prm))`` assembles a system
exactly like the YAML path.

CHARMM conventions handled:
- bonds:    Kb (kcal/mol/A^2), b0 — E = Kb (b - b0)^2
- angles:   Ktheta, Theta0 (deg) [+ optional Kub, S0 Urey-Bradley]
- dihedrals: Kchi, n (periodicity), delta (deg) — multi-line multi-term
- impropers: Kpsi, (0), psi0 (deg) — harmonic (per = 0 branch)
- nonbonded: eps (negative), Rmin/2 [+ optional eps14, Rmin14/2]; the
  Lennard-Jones A/B use eps_ij = sqrt(eps_i eps_j), Rmin_ij = Rmin/2_i +
  Rmin/2_j: A = eps Rmin^12, B = 2 eps Rmin^6
- CMAP: 2D phi/psi cross-term correction grids (24x24 at 15 deg in the
  CHARMM27 maps) keyed by the 8 atom types of the two dihedrals; a header
  of the 8 types and the resolution G, then G x G values. The "cmap"
  energy term interpolates them bicubically
- wildcard ``X`` matching with the usual specificity ordering
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

_SECTIONS = (
    "BONDS", "ANGLES", "DIHEDRALS", "IMPROPER", "IMPROPERS", "NONBONDED",
    "CMAP", "HBOND", "NBFIX", "END", "ATOMS",
)


def _tokens(line: str) -> List[str]:
    line = line.split("!")[0].strip()
    return line.split()


class CharmmPrm:
    """Type-keyed CHARMM parameter lookup (YamlForceField-compatible)."""

    def __init__(self, path: str, masses: Optional[Dict[str, float]] = None):
        self.bonds: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self.angles: Dict[tuple, Tuple[float, float]] = {}
        self.ubs: Dict[tuple, Tuple[float, float]] = {}
        self.dihedrals: Dict[tuple, List[Tuple[float, float, float]]] = {}
        self.impropers: Dict[tuple, Tuple[float, float, float]] = {}
        self.nonbonded: Dict[str, Tuple[float, float]] = {}
        self.nonbonded14: Dict[str, Tuple[float, float]] = {}
        self.masses: Dict[str, float] = dict(masses or {})
        #: 8-type keys -> (G, G) grid of correction energies (kcal/mol) on
        #: [-180, 180) x [-180, 180); grid[i, j] = E(phi_i, psi_j)
        self.cmaps: Dict[tuple, np.ndarray] = {}
        self._parse(path)

    def _parse(self, path: str):
        section = None
        cmap_key, cmap_res, cmap_vals = None, 0, []
        with open(path) as fh:
            for raw in fh:
                toks = _tokens(raw)
                if not toks:
                    continue
                head = toks[0].upper()
                if head in _SECTIONS:
                    section = "IMPROPER" if head.startswith("IMPROPER") else head
                    continue
                if section == "CMAP":
                    if toks[0][0].isalpha() and len(toks) >= 9:
                        # new map header: 8 atom types + grid resolution
                        cmap_key = tuple(toks[:8])
                        cmap_res = int(toks[8])
                        cmap_vals = []
                        continue
                    if cmap_key is not None:
                        try:
                            cmap_vals.extend(float(t) for t in toks)
                        except ValueError:
                            continue
                        if len(cmap_vals) >= cmap_res * cmap_res:
                            self.cmaps[cmap_key] = np.array(
                                cmap_vals[: cmap_res * cmap_res], np.float64
                            ).reshape(cmap_res, cmap_res)
                            cmap_key = None
                    continue
                if head in ("CUTNB", "NONBFIX") or head.startswith("!"):
                    continue
                if section == "ATOMS" and head == "MASS" and len(toks) >= 4:
                    self.masses[toks[2]] = float(toks[3])
                elif section == "BONDS" and len(toks) >= 4:
                    key = (toks[0], toks[1])
                    self.bonds[key] = (float(toks[2]), float(toks[3]))
                elif section == "ANGLES" and len(toks) >= 5:
                    key = (toks[0], toks[1], toks[2])
                    self.angles[key] = (float(toks[3]), float(toks[4]))
                    if len(toks) >= 7:
                        try:
                            self.ubs[key] = (float(toks[5]), float(toks[6]))
                        except ValueError:
                            pass
                elif section == "DIHEDRALS" and len(toks) >= 7:
                    key = tuple(toks[:4])
                    term = (float(toks[4]), float(toks[6]), float(toks[5]))
                    # accumulate multi-term entries (Kchi, delta_deg, n)
                    self.dihedrals.setdefault(key, [])
                    if term not in self.dihedrals[key]:
                        self.dihedrals[key].append(term)
                elif section == "IMPROPER" and len(toks) >= 7:
                    key = tuple(toks[:4])
                    self.impropers[key] = (
                        float(toks[4]),
                        float(toks[6]),
                        float(toks[5]),
                    )
                elif section == "NONBONDED" and len(toks) >= 4:
                    try:
                        eps = float(toks[2])
                        rmin2 = float(toks[3])
                    except ValueError:
                        continue
                    self.nonbonded[toks[0]] = (eps, rmin2)
                    if len(toks) >= 7:
                        try:
                            self.nonbonded14[toks[0]] = (
                                float(toks[5]),
                                float(toks[6]),
                            )
                        except ValueError:
                            pass

    # --- wildcard lookup -----------------------------------------------------

    @staticmethod
    def _match(key: tuple, types: tuple) -> bool:
        return all(k == "X" or k == t for k, t in zip(key, types))

    def _lookup(self, table: dict, types: tuple, reversible=True):
        candidates = []
        for key, val in table.items():
            if self._match(key, types) or (
                reversible and self._match(key, types[::-1])
            ):
                candidates.append((sum(k == "X" for k in key), val))
        if not candidates:
            raise KeyError(f"no CHARMM parameters for {types}")
        return min(candidates, key=lambda c: c[0])[1]

    # --- YamlForceField-compatible getters ------------------------------------

    def get_atom_types(self) -> np.ndarray:
        return np.array(sorted(self.nonbonded))

    def get_charge(self, at: str) -> float:
        raise KeyError(
            "CHARMM PRM files carry no charges — use per-atom charges from "
            "the PSF (build_ff_params(..., charges_from='topology'))"
        )

    def get_mass(self, at: str) -> float:
        if at in self.masses:
            return float(self.masses[at])
        raise KeyError(
            f"no MASS entry for {at} — pass masses or use the PSF column"
        )

    def get_LJ(self, at: str) -> Tuple[float, float]:
        """(sigma, epsilon) in torchmd's convention: sigma = Rmin * 2^(-1/6)
        so that 4 eps sigma^12/6 reproduces eps Rmin^12 / 2 eps Rmin^6."""
        eps, rmin2 = self.nonbonded[at]
        rmin = 2.0 * rmin2
        return rmin * 2.0 ** (-1.0 / 6.0), abs(eps)

    def get_LJ14(self, at: str) -> Tuple[float, float]:
        eps, rmin2 = self.nonbonded14.get(at, self.nonbonded[at])
        rmin = 2.0 * rmin2
        return rmin * 2.0 ** (-1.0 / 6.0), abs(eps)

    def get_bond(self, at1, at2) -> Tuple[float, float]:
        return self._lookup(self.bonds, (at1, at2))

    def get_angle(self, at1, at2, at3) -> Tuple[float, float]:
        k, theta0 = self._lookup(self.angles, (at1, at2, at3))
        return k, math.radians(theta0)

    def get_urey_bradley(self, at1, at2, at3):
        try:
            return self._lookup(self.ubs, (at1, at2, at3))
        except KeyError:
            return None

    def get_dihedral(self, at1, at2, at3, at4):
        terms = self._lookup(self.dihedrals, (at1, at2, at3, at4))
        return [(k, math.radians(delta), per) for k, delta, per in terms]

    def get_14(self, at1, at2, at3, at4):
        s1, e1 = self.get_LJ14(at1)
        s4, e4 = self.get_LJ14(at4)
        return 1.0, 1.0, s1, e1, s4, e4

    def get_cmap(self, types8: tuple):
        """(G, G) correction grid for the 8 atom types of a phi/psi
        cross-term, or None when no map covers it."""
        key = tuple(types8)
        if key in self.cmaps:
            return self.cmaps[key]
        return None

    def get_improper(self, at1, at2, at3, at4) -> Tuple[float, float, float]:
        candidates = []
        types = (at1, at2, at3, at4)
        for key, val in self.impropers.items():
            for perm in (types, types[::-1]):
                if self._match(key, perm):
                    candidates.append((sum(k == "X" for k in key), val))
        if not candidates:
            raise KeyError(f"no improper parameters for {types}")
        k, psi0, per = min(candidates, key=lambda c: c[0])[1]
        return k, math.radians(psi0), 0.0  # CHARMM harmonic branch
