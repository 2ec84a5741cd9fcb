"""Differentiable classical force-field energy terms (PyTorch).

Harmonic bonds/angles, AMBER periodic + CHARMM harmonic torsions, impropers,
scaled 1-4 LJ/Coulomb, 12-6 Lennard-Jones with a cubic switching function,
plain or reaction-field Coulomb and Urey-Bradley springs, as plain functions
over dense tensors:

- positions are ``(..., N, 3)``: any leading batch axes (a replica ensemble)
  are carried through and every energy comes back with shape ``(...)``;
- the nonbonded terms run on a dense masked ``(..., N, N)`` pair matrix;
- forces come from ``torch.autograd.grad`` of the total energy, so they are
  always consistent with the energy.

Periodic boundaries use minimum-image wrapping over a rectangular box; pass
``box=None`` (or zeros) for vacuum.

The implicit-solvent terms ``gb`` (GB-OBC II) and ``sasa`` (LCPO) come from
``solvent`` and need the GB tables on the ``FFParams``
(``solvent.attach_gb_params``).

Not ported yet: ``cmap`` (with the CHARMM parameter reader, ROADMAP A8) and
the ``repulsion``/``repulsioncg`` variants (ROADMAP A8). Asking for one
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from molecular_dynamics_tpu_torch.ff.params import FFParams
from molecular_dynamics_tpu_torch import units

Tensor = torch.Tensor

BONDED_TERMS = ("bonds", "angles", "dihedrals", "impropers", "1-4")
NONBONDED_TERMS = ("electrostatics", "lj", "repulsion", "repulsioncg")
SOLVENT_TERMS = ("gb", "sasa")
CMAP_TERMS = ("cmap",)
ALL_TERMS = BONDED_TERMS + NONBONDED_TERMS + SOLVENT_TERMS + CMAP_TERMS
DEFAULT_TERMS = (
    "electrostatics",
    "lj",
    "bonds",
    "angles",
    "dihedrals",
    "1-4",
    "impropers",
)

#: terms the configs may name but this port does not evaluate yet, with the
#: slice that brings each
_DEFERRED_TERMS = {
    "cmap": "the CHARMM parameter reader with CMAP (ROADMAP A8)",
    "repulsion": "the CG repulsion variants (ROADMAP A8)",
    "repulsioncg": "the CG repulsion variants (ROADMAP A8)",
}


@dataclasses.dataclass(frozen=True)
class EnergyConfig:
    """Static (hashable) evaluation options."""

    terms: Tuple[str, ...] = DEFAULT_TERMS
    cutoff: Optional[float] = None
    rfa: bool = False
    solvent_dielectric: float = units.SOLVENT_DIELECTRIC
    switch_dist: Optional[float] = None
    #: Urey-Bradley 1-3 springs: None (default) = on whenever the FF carries
    #: UB terms, True/False = force on/off
    urey_bradley: Optional[bool] = None
    #: evaluate the dense all-vs-all nonbonded matrix here. Set False when a
    #: pair kernel (``ops.ring.pair_forces``) supplies those terms instead.
    dense_nonbonded: bool = True
    #: salt molarity for GB Debye screening (only used by the "gb" term)
    ion_concentration: float = 0.0
    #: kcal/mol/A^2 for the SASA nonpolar term
    surface_tension: float = 0.005

    def __post_init__(self):
        object.__setattr__(self, "terms", tuple(t.lower() for t in self.terms))
        for t in self.terms:
            if t not in ALL_TERMS:
                raise ValueError(f"Force term {t} is not implemented.")
        if "1-4" in self.terms and "dihedrals" not in self.terms:
            raise ValueError("1-4 interactions require dihedrals to be enabled.")


#: vacuum reference physics: cutoff 9 A, reaction field, LJ switch at 7.5 A
REFERENCE_CONFIG = EnergyConfig(cutoff=9.0, rfa=True, switch_dist=7.5)

#: the NAMD GBIS data-generation protocol: plain Coulomb, LJ switched
#: 15->16 A, solvent dielectric 80, 0.1 M salt, GB + SASA
GBIS_CONFIG = EnergyConfig(
    terms=DEFAULT_TERMS + ("gb", "sasa"),
    cutoff=16.0,
    rfa=False,
    switch_dist=15.0,
    solvent_dielectric=80.0,
    ion_concentration=0.1,
)

#: GBIS polar-only variant (``gbis on`` without ``sasa on``)
GBIS_POLAR_CONFIG = EnergyConfig(
    terms=DEFAULT_TERMS + ("gb",),
    cutoff=16.0,
    rfa=False,
    switch_dist=15.0,
    solvent_dielectric=80.0,
    ion_concentration=0.1,
)


# ---------------------------------------------------------------------------
# geometry primitives
# ---------------------------------------------------------------------------


def wrap_displacement(delta: Tensor, box: Optional[Tensor]) -> Tensor:
    """Minimum-image wrap of displacement vectors over a rectangular box.

    ``box`` is a (3,) diagonal (or broadcastable to ``delta``); zero/None
    components disable wrapping on that axis.
    """
    if box is None:
        return delta
    box = torch.as_tensor(box, dtype=delta.dtype, device=delta.device)
    safe_box = torch.where(box > 0, box, torch.ones_like(box))
    wrapped = delta - safe_box * torch.round(delta / safe_box)
    return torch.where(box > 0, wrapped, delta)


def _pair_box(box: Optional[Tensor], pos: Tensor) -> Optional[Tensor]:
    """Reshape a per-replica box ``(..., 3)`` to broadcast over ``(..., K, 3)``."""
    if box is None:
        return None
    box = torch.as_tensor(box, dtype=pos.dtype, device=pos.device)
    return box.unsqueeze(-2) if box.ndim > 1 else box


def pair_displacements(pos: Tensor, idx: Tensor, box: Optional[Tensor]) -> Tensor:
    """Displacement ``pos[idx[:,0]] - pos[idx[:,1]]``, minimum-image wrapped."""
    return wrap_displacement(
        pos[..., idx[:, 0], :] - pos[..., idx[:, 1], :], _pair_box(box, pos)
    )


def _safe_norm(vec: Tensor, eps: float = 1e-12) -> Tensor:
    """Gradient-safe Euclidean norm over the last axis (no NaN at zero)."""
    return torch.sqrt(torch.clamp_min(torch.sum(vec * vec, dim=-1), eps))


def torsion_angle(b1: Tensor, b2: Tensor, b3: Tensor) -> Tensor:
    """Dihedral angle from the three bond vectors ``b1 = p0-p1``,
    ``b2 = p1-p2``, ``b3 = p2-p3``: ``-atan2`` of the plane normals."""
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    sin_num = torch.sum(b2 * torch.linalg.cross(n1, n2), dim=-1) / _safe_norm(b2)
    cos_num = torch.sum(n1 * n2, dim=-1)
    return -torch.atan2(sin_num, cos_num)


def dihedral_angles(pos: Tensor, idx: Tensor, box: Optional[Tensor] = None) -> Tensor:
    """Torsion angles phi for each 4-tuple in ``idx`` (rad)."""
    pbox = _pair_box(box, pos)
    p = [pos[..., idx[:, k], :] for k in range(4)]
    b1 = wrap_displacement(p[0] - p[1], pbox)
    b2 = wrap_displacement(p[1] - p[2], pbox)
    b3 = wrap_displacement(p[2] - p[3], pbox)
    return torsion_angle(b1, b2, b3)


# ---------------------------------------------------------------------------
# per-term energies
# ---------------------------------------------------------------------------


def _harmonic_pair_energy(pos, idx, params, box) -> Tensor:
    d = _safe_norm(pair_displacements(pos, idx, box))
    k0, d0 = params[:, 0], params[:, 1]
    return torch.sum(k0 * (d - d0) ** 2, dim=-1)


def _bond_energy(pos, ff: FFParams, box) -> Tensor:
    return _harmonic_pair_energy(pos, ff.bonds, ff.bond_params, box)


def _urey_bradley_energy(pos, ff: FFParams, box) -> Tensor:
    return _harmonic_pair_energy(pos, ff.ub_bonds, ff.ub_params, box)


def _angle_energy(pos, ff: FFParams, box) -> Tensor:
    a = ff.angles
    pbox = _pair_box(box, pos)
    r21 = wrap_displacement(pos[..., a[:, 0], :] - pos[..., a[:, 1], :], pbox)
    r23 = wrap_displacement(pos[..., a[:, 2], :] - pos[..., a[:, 1], :], pbox)
    # atan2 form of the angle: equals arccos(clamped cos) but with a finite
    # gradient at straight/degenerate configurations
    cross = torch.linalg.cross(r21, r23)
    theta = torch.atan2(_safe_norm(cross), torch.sum(r21 * r23, dim=-1))
    k0, theta0 = ff.angle_params[:, 0], ff.angle_params[:, 1]
    return torch.sum(k0 * (theta - theta0) ** 2, dim=-1)


def _torsion_energy(pos, idx, params, term_mask, box) -> Tensor:
    """Multi-term torsion energy (dihedrals and impropers share this).

    Per term: AMBER periodic ``k(1+cos(per*phi - phi0))`` when per > 0, else
    CHARMM harmonic ``k*wrap(phi-phi0)^2``.
    """
    phi = dihedral_angles(pos, idx, box)  # (..., T)
    k0 = params[..., 0]
    phi0 = params[..., 1]
    per = params[..., 2]
    phi_b = phi.unsqueeze(-1)

    amber = k0 * (1.0 + torch.cos(per * phi_b - phi0))
    delta = phi_b - phi0
    delta = delta - 2.0 * math.pi * torch.round(delta / (2.0 * math.pi))
    charmm = k0 * delta * delta
    e = torch.where(per > 0, amber, charmm)
    return torch.sum(torch.where(term_mask, e, torch.zeros_like(e)), dim=(-2, -1))


def _nb14_energies(pos, ff: FFParams, box, cfg: EnergyConfig):
    """Scaled 1-4 LJ and Coulomb across dihedral end pairs.
    Returns (lj14, elec14)."""
    d = _safe_norm(pair_displacements(pos, ff.idx14, box))
    a14, b14 = ff.nb14_params[:, 0], ff.nb14_params[:, 1]
    scnb, scee = ff.nb14_params[:, 2], ff.nb14_params[:, 3]
    inv = 1.0 / d
    inv6 = inv**6
    lj14 = torch.sum((a14 * inv6 * inv6 - b14 * inv6) / scnb, dim=-1)
    q1 = ff.charges[ff.idx14[:, 0]]
    q2 = ff.charges[ff.idx14[:, 1]]
    # plain Coulomb regardless of cutoff/rfa
    elec14 = torch.sum(units.ELEC_FACTOR * q1 * q2 * inv / scee, dim=-1)
    return lj14, elec14


def _nonbonded_energies(pos, ff: FFParams, box, cfg: EnergyConfig) -> Dict[str, Tensor]:
    """All-vs-all nonbonded terms on a dense masked (..., N, N) pair matrix.

    Pairs beyond the cutoff contribute zero; the LJ switching function and
    RFA Coulomb both decay to zero at the cutoff so the truncation stays
    smooth and grad-safe.
    """
    pbox = None if box is None else _pair_box(box, pos)
    if pbox is not None and pbox.ndim > 1:
        pbox = pbox.unsqueeze(-2)
    delta = wrap_displacement(pos.unsqueeze(-2) - pos.unsqueeze(-3), pbox)
    dist_sq = torch.sum(delta * delta, dim=-1)
    mask = ff.nb_mask
    if cfg.cutoff is not None:
        mask = mask & (dist_sq <= cfg.cutoff**2)
    safe_d = torch.sqrt(torch.where(mask, dist_sq, torch.ones_like(dist_sq)))
    inv = 1.0 / safe_d
    inv6 = inv**6
    inv12 = inv6 * inv6
    zero = torch.zeros_like(dist_sq)

    out: Dict[str, Tensor] = {}
    if "electrostatics" in cfg.terms:
        if cfg.rfa and cfg.cutoff is not None:
            # generalized reaction field (Tironi et al. 1995)
            eps_s = cfg.solvent_dielectric
            denom = 2.0 * eps_s + 1.0
            krf = (eps_s - 1.0) / (denom * cfg.cutoff**3)
            crf = 3.0 * eps_s / (denom * cfg.cutoff)
            pot = ff.qq_pair * (inv + krf * safe_d**2 - crf)
        else:
            pot = ff.qq_pair * inv
        out["electrostatics"] = torch.sum(torch.where(mask, pot, zero), dim=(-2, -1))

    if "lj" in cfg.terms:
        pot = ff.lj_a_pair * inv12 - ff.lj_b_pair * inv6
        if cfg.switch_dist is not None and cfg.cutoff is not None:
            # cubic switching between switch_dist and cutoff
            t = (safe_d - cfg.switch_dist) / (cfg.cutoff - cfg.switch_dist)
            sw = 1.0 + t * t * t * (-10.0 + t * (15.0 - t * 6.0))
            pot = torch.where(safe_d > cfg.switch_dist, pot * sw, pot)
        out["lj"] = torch.sum(torch.where(mask, pot, zero), dim=(-2, -1))
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def resolve_urey_bradley(config: EnergyConfig, ff: FFParams) -> bool:
    """Concrete UB on/off for this (config, force field) pair.

    ``urey_bradley=None`` auto-enables UB exactly when the FF carries 1-3
    springs (chamber prmtops do); an explicit True/False always wins.
    """
    has_ub = bool(ff.ub_bonds.shape[0])
    if config.urey_bradley is None:
        return has_ub
    return bool(config.urey_bradley) and has_ub


def energy_terms(
    pos: Tensor,
    ff: FFParams,
    box: Optional[Tensor] = None,
    config: EnergyConfig = REFERENCE_CONFIG,
    external: Optional[Callable[[Tensor], Tensor]] = None,
) -> Dict[str, Tensor]:
    """Per-term potential energies, kcal/mol.

    ``pos`` is ``(..., N, 3)``; every value in the returned dict has shape
    ``(...)``: one live tensor per enabled term plus ``"external"`` when an
    external potential/bias is attached.
    """
    cfg = config
    for t in cfg.terms:
        if t in _DEFERRED_TERMS:
            raise NotImplementedError(
                f"energy term {t!r} is not ported yet: it comes with "
                f"{_DEFERRED_TERMS[t]}"
            )
    zero = torch.zeros(pos.shape[:-2], dtype=pos.dtype, device=pos.device)
    out: Dict[str, Tensor] = {t: zero for t in cfg.terms}

    if "bonds" in cfg.terms and ff.bonds.shape[0]:
        out["bonds"] = _bond_energy(pos, ff, box)
    if "angles" in cfg.terms and ff.angles.shape[0]:
        out["angles"] = _angle_energy(pos, ff, box)
    if "dihedrals" in cfg.terms and ff.dihedrals.shape[0]:
        out["dihedrals"] = _torsion_energy(
            pos, ff.dihedrals, ff.dihedral_params, ff.dihedral_term_mask, box
        )
    if "impropers" in cfg.terms and ff.impropers.shape[0]:
        out["impropers"] = _torsion_energy(
            pos, ff.impropers, ff.improper_params, ff.improper_term_mask, box
        )
    if "1-4" in cfg.terms and ff.idx14.shape[0]:
        lj14, elec14 = _nb14_energies(pos, ff, box, cfg)
        if "lj" in cfg.terms:
            out["lj"] = out.get("lj", zero) + lj14
        if "electrostatics" in cfg.terms:
            out["electrostatics"] = out.get("electrostatics", zero) + elec14
        out["1-4"] = zero  # stays 0: folded into lj/electrostatics

    if cfg.dense_nonbonded and any(t in NONBONDED_TERMS for t in cfg.terms):
        nb = _nonbonded_energies(pos, ff, box, cfg)
        for k, v in nb.items():
            out[k] = out.get(k, zero) + v

    if resolve_urey_bradley(cfg, ff):
        out["urey_bradley"] = _urey_bradley_energy(pos, ff, box)

    if "gb" in cfg.terms or "sasa" in cfg.terms:
        from molecular_dynamics_tpu_torch import solvent

        if not ff.has_gb:
            raise ValueError(
                "GB/SASA terms requested but the FFParams carry no GB "
                "tables: attach them with solvent.attach_gb_params(ff)"
            )
        if "gb" in cfg.terms:
            out["gb"] = solvent.gb_energy(
                pos,
                ff,
                solvent_dielectric=cfg.solvent_dielectric,
                ion_concentration=cfg.ion_concentration,
            )
        if "sasa" in cfg.terms:
            out["sasa"] = solvent.sasa_energy(
                pos, ff, surface_tension=cfg.surface_tension
            )

    if external is not None:
        out["external"] = external(pos)
    return out


def total_energy(
    pos: Tensor,
    ff: FFParams,
    box: Optional[Tensor] = None,
    config: EnergyConfig = REFERENCE_CONFIG,
    external: Optional[Callable[[Tensor], Tensor]] = None,
) -> Tensor:
    """Total potential energy (sum of :func:`energy_terms`), shape ``(...)``."""
    terms = energy_terms(pos, ff, box, config, external)
    return torch.sum(torch.stack(list(terms.values())), dim=0)


def _neg_grad(energy_of: Callable[[Tensor], Tensor], pos: Tensor) -> Tensor:
    """``-d sum(energy_of(p)) / dp`` at ``pos``. Batch entries are
    independent, so the gradient of the sum is each entry's own gradient.
    The result stays differentiable when ``pos`` already requires grad."""
    keep_graph = torch.is_grad_enabled() and pos.requires_grad
    with torch.enable_grad():
        p = pos if keep_graph else pos.detach().requires_grad_(True)
        (grad,) = torch.autograd.grad(
            energy_of(p).sum(), p, create_graph=keep_graph
        )
    return -grad


def force_fn(
    config: EnergyConfig = REFERENCE_CONFIG,
    external: Optional[Callable[[Tensor], Tensor]] = None,
) -> Callable[[Tensor, FFParams, Optional[Tensor]], Tensor]:
    """Return ``forces(pos, ff, box) = -dE/dpos`` for the given config."""

    def forces(pos, ff, box=None):
        return _neg_grad(
            lambda p: total_energy(p, ff, box, config, external), pos
        )

    return forces


def energy_and_forces(
    pos: Tensor,
    ff: FFParams,
    box: Optional[Tensor] = None,
    config: EnergyConfig = REFERENCE_CONFIG,
    external: Optional[Callable[[Tensor], Tensor]] = None,
) -> Tuple[Dict[str, Tensor], Tensor]:
    """Per-term energies and forces in one evaluation."""
    terms = energy_terms(pos, ff, box, config, external)
    forces = force_fn(config, external)(pos, ff, box)
    return terms, forces
