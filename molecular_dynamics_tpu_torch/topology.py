"""Host-side molecular topology container.

Atom metadata plus the bonded index tables (bonds/angles/dihedrals/
impropers) that the parameter builder (``ff.builder.build_ff_params``) turns
into the tensors of ``FFParams``.

Pure numpy: the readers in ``io`` fill every field at load time. The port's
own copy of the JAX package's ``Topology``, field for field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Topology:
    """Atoms + connectivity of one molecular system (0-based indices)."""

    #: per-atom type string, e.g. "N", "CA", "CT1" — parameter lookup key
    atom_types: np.ndarray  # (N,) dtype=object/str
    #: per-atom names as in the source file (N, HN, CA, ...)
    atom_names: np.ndarray  # (N,) str
    #: residue names per atom
    res_names: np.ndarray  # (N,) str
    #: residue ids per atom (int)
    res_ids: np.ndarray  # (N,) int
    #: per-atom charges as given by the topology file (may be overridden by FF)
    charges: np.ndarray  # (N,) float64
    #: per-atom masses as given by the topology file (may be overridden by FF)
    masses: np.ndarray  # (N,) float64

    bonds: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int64)
    )
    angles: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 3), np.int64)
    )
    dihedrals: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 4), np.int64)
    )
    impropers: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 4), np.int64)
    )
    #: segment names per atom (optional)
    seg_ids: Optional[np.ndarray] = None
    #: reference coordinates if the source carried them (PDB/inpcrd), (N,3)
    coords: Optional[np.ndarray] = None
    #: CMAP cross-terms (C, 8): two consecutive dihedrals per row (CHARMM
    #: PSF !NCRTERM section); empty when the PSF predates CMAP
    cross_terms: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 8), np.int64)
    )

    @property
    def n_atoms(self) -> int:
        return len(self.atom_types)

    def __post_init__(self):
        n = self.n_atoms
        for name in ("atom_names", "res_names", "res_ids", "charges", "masses"):
            arr = getattr(self, name)
            if len(arr) != n:
                raise ValueError(f"{name} has length {len(arr)}, expected {n}")
        for name, width in (
            ("bonds", 2),
            ("angles", 3),
            ("dihedrals", 4),
            ("impropers", 4),
        ):
            arr = np.asarray(getattr(self, name), dtype=np.int64).reshape(-1, width)
            if arr.size and (arr.min() < 0 or arr.max() >= n):
                raise ValueError(f"{name} contains out-of-range atom indices")
            setattr(self, name, arr)

    def describe(self) -> str:
        return (
            f"Topology(n_atoms={self.n_atoms}, bonds={len(self.bonds)}, "
            f"angles={len(self.angles)}, dihedrals={len(self.dihedrals)}, "
            f"impropers={len(self.impropers)})"
        )
