"""Generalized-Born implicit solvent (GB-OBC II) + LCPO SASA nonpolar term.

The physics of NAMD's ``gbis on`` / ``sasa on`` (Onufriev-Bashford-Case II
Born radii from HCT pairwise descreening, the Still pair energy with Debye
screening, and the LCPO surface area) as dense pairwise sums over
``(..., N, N)``: no cutoff on the GB sums and no neighbour lists, which at
N <= a few hundred is cheaper than masking and strictly more accurate.

Two halves:

- host side: the model constants and the numpy table building that the
  example loaders call (element inference and the per-atom
  ``gb_radii``/``gb_screen``/``sasa_radii``/``sasa_params`` tables on
  ``FFParams``);
- the energy functions ``born_radii``, ``gb_energy``, ``sasa`` and
  ``sasa_energy``: plain functions on tensors of any float dtype, batched
  over leading replica axes, differentiable by autograd. ``energy_terms``
  calls them for the ``"gb"``/``"sasa"`` terms; the analytic forces the
  kernels evaluate live in ``ops.gb`` and ``ops.sasa`` and are held against
  autograd of these.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from molecular_dynamics_tpu_torch import units

Tensor = torch.Tensor

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


# -- pairwise geometry helpers ------------------------------------------------


def _pair_distances(pos: Tensor):
    """``(..., N, N)`` distances with a grad-safe masked diagonal, and the
    off-diagonal mask ``(N, N)``."""
    delta = pos.unsqueeze(-2) - pos.unsqueeze(-3)
    n = pos.shape[-2]
    off = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    d2 = torch.sum(delta * delta, dim=-1)
    d = torch.sqrt(torch.where(off, d2, torch.ones_like(d2)))
    return torch.where(off, d, torch.zeros_like(d)), off


# -- Born radii (HCT descreening + OBC II rescaling) --------------------------


def born_radii(pos: Tensor, ff) -> Tensor:
    """Effective Born radii ``(..., N)``, OBC II.

    HCT pairwise-descreening integral accumulated over the dense pair
    matrix, then the OBC tanh rescaling:
    ``R_i = 1 / (1/rho_i - tanh(a*psi - b*psi^2 + g*psi^3) / r_i)`` with
    ``psi = rho_i * 0.5 * sum_j I_ij`` and ``rho_i = r_i - offset``.
    """
    radii = ff.gb_radii.to(pos.dtype)
    rho = radii - GB_OFFSET  # (N,)
    d, off = _pair_distances(pos)
    one = torch.ones_like(d)
    zero = torch.zeros_like(d)
    d_safe = torch.where(off, d, one)

    s_j = (ff.gb_screen.to(pos.dtype) * rho)[None, :]  # (1, N)
    rho_i = rho[:, None]  # (N, 1)

    upper = d + s_j
    lower = torch.maximum(torch.abs(d - s_j), rho_i.expand_as(d))
    # pair contributes only when the descreening sphere reaches past rho_i
    contrib = off & (rho_i < upper)
    # where before log/divide: a NaN in a masked lane would poison autograd
    lo = torch.where(contrib, lower, one)
    up = torch.where(contrib, upper, one)

    integral = (
        1.0 / lo
        - 1.0 / up
        + 0.25 * (d_safe - s_j * s_j / d_safe) * (1.0 / (up * up) - 1.0 / (lo * lo))
        + 0.5 * torch.log(lo / up) / d_safe
    )
    # atom i fully inside j's descreening sphere
    inside = contrib & (rho_i < s_j - d)
    integral = integral + torch.where(inside, 2.0 * (1.0 / rho_i - 1.0 / lo), zero)
    integral = torch.where(contrib, integral, zero)

    psi = 0.5 * rho * torch.sum(integral, dim=-1)
    tanh_arg = psi * (OBC_ALPHA + psi * (-OBC_BETA + OBC_GAMMA * psi))
    inv_r = 1.0 / rho - torch.tanh(tanh_arg) / radii
    return 1.0 / inv_r


def debye_kappa(
    ion_concentration: float, solvent_dielectric: float, temperature: float = 300.0
) -> float:
    """Debye screening constant (1/A) of a salt molarity; 0 without salt."""
    if ion_concentration <= 0.0:
        return 0.0
    return KAPPA_FACTOR * (ion_concentration / (solvent_dielectric * temperature)) ** 0.5


def gb_energy(
    pos: Tensor,
    ff,
    solvent_dielectric: float = 80.0,
    ion_concentration: float = 0.0,
    temperature: float = 300.0,
    solute_dielectric: float = 1.0,
) -> Tensor:
    """Still-equation GB polarization energy ``(...)`` (kcal/mol), incl. self
    terms.

    ``E = -1/2 sum_ij k_e (1/eps_in - exp(-kappa f_ij)/eps_s) q_i q_j / f_ij``
    with ``f_ij = sqrt(d^2 + R_i R_j exp(-d^2 / 4 R_i R_j))``; the i==j
    diagonal gives the Born self energies. The Debye ``kappa`` follows the
    ``ionconcentration``/``solventDielectric`` inputs of the NAMD protocol.
    """
    born = born_radii(pos, ff)
    delta = pos.unsqueeze(-2) - pos.unsqueeze(-3)
    d2 = torch.sum(delta * delta, dim=-1)
    bb = born.unsqueeze(-1) * born.unsqueeze(-2)
    f = torch.sqrt(d2 + bb * torch.exp(-d2 / (4.0 * bb)))

    kappa = debye_kappa(ion_concentration, solvent_dielectric, temperature)
    if kappa > 0.0:
        screen = torch.exp(-kappa * f) / solvent_dielectric
    else:
        screen = 1.0 / solvent_dielectric
    pref = units.ELEC_FACTOR * (1.0 / solute_dielectric - screen)
    q = ff.charges.to(pos.dtype)
    qq = q[:, None] * q[None, :]
    return -0.5 * torch.sum(pref * qq / f, dim=(-2, -1))


# -- LCPO solvent-accessible surface area ------------------------------------


def sasa(pos: Tensor, ff) -> Tensor:
    """Per-atom solvent-accessible surface areas ``(..., N)`` (A^2), LCPO.

    ``A_i = P1 S1 + P2 sum_j A_ij + P3 sum_jk A_jk + P4 sum_j A_ij sum_k A_jk``
    over neighbours = overlapping probe-inflated spheres; the three- and
    four-body sums contract as (N, N) x (N, N) products.
    """
    radii = ff.sasa_radii.to(pos.dtype)  # probe-inflated, 0 for H (united out)
    active = radii > 0.0
    d, off = _pair_distances(pos)
    d_safe = torch.where(off, d, torch.ones_like(d))

    ri, rj = radii[:, None], radii[None, :]
    overlap = (
        off
        & active[:, None]
        & active[None, :]
        & (d < ri + rj)
        & (d > torch.abs(ri - rj))  # neither sphere engulfed
    )
    # pairwise buried area of sphere i by sphere j (Weiser eq. 3)
    a_ij = (
        2.0 * math.pi * ri
        * (ri - d_safe / 2.0 - (ri * ri - rj * rj) / (2.0 * d_safe))
    )
    a_ij = torch.where(overlap, a_ij, torch.zeros_like(a_ij))
    o = overlap.to(pos.dtype)

    s1 = 4.0 * math.pi * radii * radii
    term2 = torch.sum(a_ij, dim=-1)
    # sum over j,k both neighbours of i with j,k overlapping: O_ij O_ik A_jk
    # (a_ij is already masked by the overlap)
    term3 = torch.einsum("...ij,...jk,...ik->...i", o, a_ij, o)
    # sum_j A_ij * (sum_k O_ik A_jk O_jk)
    term4 = torch.einsum("...ij,...jk,...ik->...i", a_ij, a_ij, o)

    p1, p2, p3, p4 = (ff.sasa_params[:, k].to(pos.dtype) for k in range(4))
    area = p1 * s1 + p2 * term2 + p3 * term3 + p4 * term4
    return torch.where(active, torch.clamp_min(area, 0.0), torch.zeros_like(area))


def sasa_energy(pos: Tensor, ff, surface_tension: float = SURFACE_TENSION) -> Tensor:
    """Nonpolar solvation energy ``(...)`` = surface tension x total SASA
    (NAMD ``sasa on`` semantics)."""
    return surface_tension * torch.sum(sasa(pos, ff), dim=-1)
