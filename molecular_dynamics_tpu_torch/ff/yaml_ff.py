"""YAML force-field source.

The custom YAML force-field schema of the source project's
``param_bb-*.yaml`` files: sections ``atomtypes``, ``bonds``, ``angles``,
``dihedrals`` (with nested ``terms``), ``impropers``, ``lj``,
``electrostatics`` and ``masses``. Multi-atom keys are formatted
``"(A, B, C)"``; the wildcard type ``X`` matches anything.

Lookup precedence: candidate keys are all X-substitution variants of the
query types ordered by wildcard count (fewest X first), trying the forward
orientation before the reversed one for bonds/angles/dihedrals, and for
impropers all permutations that keep position 2 (the improper centre) fixed.
First hit wins.

PyYAML is imported only where a YAML file is read, so a force field given
as a dict needs no YAML parser.
"""

from __future__ import annotations

import itertools
import math
from typing import List, Sequence, Tuple

import numpy as np


class YamlForceField:
    """Type-keyed parameter lookup over a YAML force-field file."""

    def __init__(self, path_or_dict):
        if isinstance(path_or_dict, dict):
            self.prm = path_or_dict
        else:
            import yaml

            with open(path_or_dict) as fh:
                self.prm = yaml.safe_load(fh)

    # -- key generation -----------------------------------------------------

    @staticmethod
    def _wildcard_variants(types: np.ndarray) -> List[np.ndarray]:
        """All ways of replacing a subset of types with X, fewest X first."""
        n = len(types)
        masks = sorted(itertools.product((False, True), repeat=n), key=sum)
        out = []
        for m in masks:
            v = types.copy()
            v[np.array(m, bool)] = "X"
            out.append(v)
        return out

    def _candidates(self, term: str, types: Sequence[str]) -> List[np.ndarray]:
        types = np.array(list(types), dtype=object)
        cands = self._wildcard_variants(types)
        if term in ("bonds", "angles", "dihedrals"):
            cands += self._wildcard_variants(types[::-1])
        elif term == "impropers":
            for perm in itertools.permutations(range(4)):
                if perm[2] == 2 and perm != (0, 1, 2, 3):
                    cands += self._wildcard_variants(types[list(perm)])
            # the identity permutation is already in `cands`
        # stable sort: fewest wildcards first, forward orientation preferred
        return sorted(cands, key=lambda v: int(np.sum(v == "X")))

    @staticmethod
    def _key(types: Sequence[str]) -> str:
        joined = ", ".join(types)
        return f"({joined})" if len(types) > 1 else joined

    def get_parameters(self, term: str, types: Sequence[str]) -> dict:
        section = self.prm[term]
        for cand in self._candidates(term, types):
            key = self._key(list(cand))
            if key in section:
                return section[key]
        raise KeyError(f"No {term} parameters for types {list(types)}")

    # -- typed getters (torchmd _ForceFieldBase protocol) --------------------

    def get_atom_types(self) -> np.ndarray:
        return np.unique(self.prm["atomtypes"])

    def get_charge(self, at: str) -> float:
        return float(self.get_parameters("electrostatics", [at])["charge"])

    def get_mass(self, at: str) -> float:
        return float(self.prm["masses"][at])

    def get_LJ(self, at: str) -> Tuple[float, float]:
        p = self.get_parameters("lj", [at])
        return float(p["sigma"]), float(p["epsilon"])

    def get_bond(self, at1: str, at2: str) -> Tuple[float, float]:
        p = self.get_parameters("bonds", [at1, at2])
        return float(p["k0"]), float(p["req"])

    def get_angle(self, at1: str, at2: str, at3: str) -> Tuple[float, float]:
        p = self.get_parameters("angles", [at1, at2, at3])
        return float(p["k0"]), math.radians(float(p["theta0"]))

    def get_dihedral(self, at1, at2, at3, at4) -> List[Tuple[float, float, float]]:
        """All periodic terms of a dihedral as (phi_k, phase_rad, per).

        ``params["terms"]`` is a dict of named sub-terms, taken in its
        order.
        """
        p = self.get_parameters("dihedrals", [at1, at2, at3, at4])
        out = []
        for name in p["terms"]:
            t = p["terms"][name]
            out.append(
                (float(t["phi_k"]), math.radians(float(t["phase"])), float(t["per"]))
            )
        return out

    def get_14(self, at1, at2, at3, at4):
        """1-4 scaling + LJ14 parameters: (scnb, scee, s14_1, e14_1, s14_4, e14_4)."""
        p = self.get_parameters("dihedrals", [at1, at2, at3, at4])
        lj1 = self.get_parameters("lj", [at1])
        lj4 = self.get_parameters("lj", [at4])
        return (
            float(p.get("scnb", 1)),
            float(p.get("scee", 1)),
            float(lj1["sigma14"]),
            float(lj1["epsilon14"]),
            float(lj4["sigma14"]),
            float(lj4["epsilon14"]),
        )

    def get_improper(self, at1, at2, at3, at4) -> Tuple[float, float, float]:
        p = self.get_parameters("impropers", [at1, at2, at3, at4])
        return float(p["phi_k"]), math.radians(float(p["phase"])), float(p["per"])
