"""The plain reference's view of a system: every parameter worked out from
the raw arrays of the system's ``.npz`` file, in any float dtype.

Nothing here reads the program under test. The element rules, the GB-OBC
radii and screening factors and the LCPO weight classes are a frozen copy of
the published tables the program also follows (Onufriev, Bashford and Case
2004; Weiser, Shenkin and Still 1999), so that a change to the program's own
tables shows as a difference from this file.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

#: intrinsic GB radii by element (mbondi2-style set), A
GB_RADII = {"H": 1.20, "C": 1.70, "N": 1.55, "O": 1.50, "S": 1.80, "P": 1.85}
#: HCT descreening scale factors by element
GB_SCREEN = {"H": 0.85, "C": 0.72, "N": 0.79, "O": 0.85, "S": 0.96, "P": 0.86}
#: LCPO atomic radii before the probe is added, A; hydrogen is united out
LCPO_RADII = {"C": 1.70, "N": 1.65, "O": 1.60, "S": 1.90, "P": 1.90, "H": 0.0}
PROBE_RADIUS = 1.4
#: LCPO weights P1..P4 by (element, heavy-neighbour count)
LCPO_PARAMS = {
    ("C", 1): (0.77887, -0.28063, -1.2968e-3, 3.9328e-4),
    ("C", 2): (0.56482, -0.19608, -1.0219e-3, 2.6580e-4),
    ("C", 3): (0.23348, -0.072627, -2.0079e-4, 7.9670e-5),
    ("C", 4): (0.00000, 0.00000, 0.00000, 0.00000),
    ("N", 1): (0.73511, -0.22116, -8.9148e-4, 2.5230e-4),
    ("N", 2): (0.41102, -0.12254, -7.5448e-5, 1.1804e-4),
    ("N", 3): (0.062577, -0.017874, -8.3120e-5, 1.9849e-5),
    ("O", 1): (0.77914, -0.25262, -1.6056e-3, 3.5071e-4),
    ("O", 2): (0.49392, -0.24486, -1.7508e-3, 4.3193e-4),
    ("S", 1): (0.7722, -0.26393, 1.0629e-3, 2.1790e-4),
    ("S", 2): (0.54581, -0.19477, -1.2873e-3, 2.9247e-4),
    ("P", 3): (0.3865, -0.18249, -3.6598e-3, 4.2640e-4),
    ("P", 4): (0.03873, -0.0089339, 8.3582e-6, 3.0381e-6),
}
_ELEMENT_MASSES = (
    ("H", 1.008), ("C", 12.011), ("N", 14.007),
    ("O", 15.999), ("P", 30.974), ("S", 32.06),
)
#: a bond with an atom lighter than this is a bond to hydrogen (rigid X-H)
HYDROGEN_MASS_CUTOFF = 3.5


def elements(masses: np.ndarray, atom_names: np.ndarray) -> list:
    """Element symbols: the leading letter of the atom name where it names a
    supported element consistent with the mass, else the nearest by mass."""
    out = []
    for name, m in zip(atom_names, np.asarray(masses, float)):
        by_mass = min(_ELEMENT_MASSES, key=lambda em: abs(em[1] - m))[0]
        lead = str(name).strip()[:1].upper()
        out.append(lead if lead in GB_RADII and not (lead == "H" and m > 2.5) else by_mass)
    return out


def _lcpo_row(element: str, n_heavy: int):
    if element == "H":
        return (0.0, 0.0, 0.0, 0.0)
    if (element, n_heavy) in LCPO_PARAMS:
        return LCPO_PARAMS[(element, n_heavy)]
    avail = sorted(k[1] for k in LCPO_PARAMS if k[0] == element)
    if not avail:
        return LCPO_PARAMS[("C", min(max(n_heavy, 1), 4))]
    return LCPO_PARAMS[(element, min(avail, key=lambda c: abs(c - n_heavy)))]


@dataclasses.dataclass(frozen=True)
class System:
    """Parameters of one system as tensors on one device; float parameters
    in the dtype the system was loaded in, indices int64."""

    tensors: Dict[str, torch.Tensor]
    n_atoms: int
    #: the rigid X-H constraints: pairs (C, 2) and lengths (C,)
    n_constraints: int

    def __getattr__(self, name):
        try:
            return self.__dict__["tensors"][name]
        except KeyError:
            raise AttributeError(name) from None

    def to(self, dtype) -> "System":
        cast = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in self.tensors.items()}
        return dataclasses.replace(self, tensors=cast)


def load_arrays(path) -> Dict[str, np.ndarray]:
    """The raw arrays of a system file, as stored."""
    with np.load(path, allow_pickle=False) as raw:
        return {k: raw[k] for k in raw.files}


def build_system(arrays: Dict[str, np.ndarray], device, dtype=torch.float64) -> System:
    """Every parameter of the force field, the implicit solvent and the
    constraints, from the raw arrays alone."""
    ff = {k[3:]: v for k, v in arrays.items() if k.startswith("ff_")}
    masses = ff["masses"].astype(np.float64)
    els = elements(masses, arrays["atom_names"])
    heavy = np.array([e != "H" for e in els])
    n_heavy = np.zeros(len(els), np.int64)
    for a, b in ff["bonds"]:
        n_heavy[a] += heavy[b]
        n_heavy[b] += heavy[a]
    derived = {
        "gb_radii": np.array([GB_RADII.get(e, 1.5) for e in els]),
        "gb_screen": np.array([GB_SCREEN.get(e, 0.80) for e in els]),
        "sasa_radii": np.array([LCPO_RADII.get(e, 1.7) + PROBE_RADIUS if e != "H" else 0.0
                                for e in els]),
        "sasa_params": np.array([_lcpo_row(e, c) for e, c in zip(els, n_heavy)]),
    }
    bonds = ff["bonds"].astype(np.int64)
    is_h = masses < HYDROGEN_MASS_CUTOFF
    rigid = is_h[bonds[:, 0]] | is_h[bonds[:, 1]]
    derived["cons_pairs"] = bonds[rigid]
    derived["cons_lengths"] = ff["bond_params"][rigid, 1].astype(np.float64)

    tensors = {}
    for k, v in {**ff, **derived}.items():
        v = np.asarray(v)
        if v.dtype == bool:
            t = torch.as_tensor(v)
        elif np.issubdtype(v.dtype, np.integer):
            t = torch.as_tensor(v.astype(np.int64))
        else:
            t = torch.as_tensor(v.astype(np.float64)).to(dtype)
        tensors[k] = t.to(device)
    return System(tensors=tensors, n_atoms=len(masses), n_constraints=int(rigid.sum()))
