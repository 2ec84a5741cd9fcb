"""Implicit-solvent parameter tables (host side).

The GB-OBC II / LCPO SASA model constants and the numpy table building
that the example loaders call: element inference and the per-atom
``gb_radii``/``gb_screen``/``sasa_radii``/``sasa_params`` tables on
``FFParams``. The energy functions (``born_radii``, ``gb_energy``,
``sasa``, ``sasa_energy``) belong to the implicit-solvent slice of the
port and are not here yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

# -- model constants ---------------------------------------------------------

#: GB dielectric offset (A) — standard OBC value.
GB_OFFSET = 0.09
#: OBC II tanh-rescaling coefficients (Onufriev, Bashford, Case 2004).
OBC_ALPHA, OBC_BETA, OBC_GAMMA = 1.0, 0.8, 4.85
#: Debye screening: kappa [1/A] = KAPPA_FACTOR * sqrt(I[M] / (eps_s * T[K]))
#: (the standard electrolyte constant, == 0.329 sqrt(I) in water at 298 K).
KAPPA_FACTOR = 50.29216
#: solvent-probe radius for SASA (A).
PROBE_RADIUS = 1.4
#: NAMD's default surface tension for ``sasa on`` (kcal/mol/A^2).
SURFACE_TENSION = 0.005

#: intrinsic GB radii by element (mbondi2-style set), A.
GB_RADII = {"H": 1.20, "C": 1.70, "N": 1.55, "O": 1.50, "S": 1.80, "P": 1.85}
#: HCT descreening scale factors by element.
GB_SCREEN = {"H": 0.85, "C": 0.72, "N": 0.79, "O": 0.85, "S": 0.96, "P": 0.86}
#: LCPO atomic radii (vdW, before adding the probe), A; H is united out.
LCPO_RADII = {"C": 1.70, "N": 1.65, "O": 1.60, "S": 1.90, "P": 1.90, "H": 0.0}

#: LCPO weights (P1..P4) by (element, heavy-neighbor count), Weiser/Shenkin/
#: Still 1999 parameter set (the table AMBER's gbsa=2 uses), collapsed onto
#: the (element, connectivity) classes present in protein systems.
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
    ("H", 0): (0.0, 0.0, 0.0, 0.0),
}

_ELEMENT_MASSES = (
    ("H", 1.008), ("C", 12.011), ("N", 14.007),
    ("O", 15.999), ("P", 30.974), ("S", 32.06),
)


def element_from_mass(mass: float) -> str:
    """Nearest standard element by atomic mass (H/C/N/O/P/S)."""
    return min(_ELEMENT_MASSES, key=lambda em: abs(em[1] - float(mass)))[0]


def infer_elements(
    masses: Sequence[float], atom_names: Optional[Sequence[str]] = None
) -> np.ndarray:
    """Per-atom element symbols.

    Prefers the leading letter of the atom name (the PDB/PSF convention the
    reference's topologies follow) when it names a supported element and is
    consistent with the mass; falls back to nearest-mass otherwise.
    """
    out = []
    for i, m in enumerate(np.asarray(masses, float)):
        by_mass = element_from_mass(m)
        el = by_mass
        if atom_names is not None:
            lead = str(atom_names[i]).strip()[:1].upper()
            if lead in GB_RADII and not (lead == "H" and m > 2.5):
                el = lead
        out.append(el)
    return np.array(out, object)


def _heavy_neighbor_counts(
    bonds: np.ndarray, elements: np.ndarray
) -> np.ndarray:
    n = len(elements)
    counts = np.zeros(n, np.int64)
    heavy = elements != "H"
    for a, b in np.asarray(bonds).reshape(-1, 2):
        if heavy[b]:
            counts[a] += 1
        if heavy[a]:
            counts[b] += 1
    return counts


def _lcpo_row(element: str, n_heavy: int):
    if element == "H":
        return LCPO_PARAMS[("H", 0)]
    key = (element, int(n_heavy))
    if key in LCPO_PARAMS:
        return LCPO_PARAMS[key]
    # clamp connectivity onto the nearest parameterized class
    avail = sorted(k[1] for k in LCPO_PARAMS if k[0] == element)
    if not avail:
        return LCPO_PARAMS[("C", min(max(n_heavy, 1), 4))]
    nearest = min(avail, key=lambda c: abs(c - n_heavy))
    return LCPO_PARAMS[(element, nearest)]


def attach_gb_params(ff, elements: Optional[Sequence[str]] = None):
    """Return ``ff`` with GB/SASA per-atom tables attached.

    ``elements`` defaults to nearest-mass inference from ``ff.masses``;
    loader paths that know atom names should pass
    ``infer_elements(masses, atom_names)`` instead. Heavy-neighbor counts
    for the LCPO weight classes come from ``ff.bonds``.
    """
    masses = ff.masses.detach().cpu().numpy()
    if elements is None:
        elements = np.array([element_from_mass(m) for m in masses], object)
    else:
        elements = np.asarray(elements, object)

    gb_radii = np.array([GB_RADII.get(e, 1.5) for e in elements])
    gb_screen = np.array([GB_SCREEN.get(e, 0.80) for e in elements])

    n_heavy = _heavy_neighbor_counts(ff.bonds.cpu().numpy(), elements)
    sasa_radii = np.array(
        [
            (LCPO_RADII.get(e, 1.7) + PROBE_RADIUS) if e != "H" else 0.0
            for e in elements
        ]
    )
    sasa_params = np.array(
        [_lcpo_row(e, c) for e, c in zip(elements, n_heavy)]
    )

    def as_tensor(a):
        return torch.as_tensor(a, dtype=ff.masses.dtype, device=ff.masses.device)

    return dataclasses.replace(
        ff,
        gb_radii=as_tensor(gb_radii),
        gb_screen=as_tensor(gb_screen),
        sasa_radii=as_tensor(sasa_radii),
        sasa_params=as_tensor(sasa_params),
    )
