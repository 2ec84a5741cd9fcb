"""The reference potential: plain PyTorch on dense ``(..., N, N)`` pair
matrices, in the dtype of the positions, batched over leading axes.

A frozen copy of the physics the configuration states: harmonic bonds,
Urey-Bradley springs and angles, AMBER periodic and CHARMM harmonic torsions
and impropers, scaled 1-4 Lennard-Jones and plain Coulomb, 12-6 LJ with the
cubic switch and reaction-field or plain Coulomb within the cutoff, GB-OBC
II with Debye screening, LCPO surface area, and the moving harmonic SMD
restraint. Forces are minus the autograd gradient of this energy.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

Tensor = torch.Tensor

# CODATA 2018, in the AKMA units the configuration works in
_E, _EPS0, _NA, _CAL, _ANG, _KB = (
    1.602176634e-19, 8.8541878128e-12, 6.02214076e23, 4.184, 1e-10, 1.380649e-23)
#: Coulomb constant, kcal/mol A / e^2
ELEC_FACTOR = 1.0 / (4.0 * math.pi * _EPS0) * _E**2 / _ANG * _NA / (1e3 * _CAL)
#: Boltzmann constant, kcal/mol/K
BOLTZMANN = _KB * _NA / (1e3 * _CAL)
#: femtoseconds per AKMA time unit
TIMEFACTOR = math.sqrt(1e-3 / (1e3 * _CAL)) / 1e-15 * _ANG
#: GB-OBC II: dielectric offset (A), tanh rescaling, Debye factor
GB_OFFSET = 0.09
OBC_ALPHA, OBC_BETA, OBC_GAMMA = 1.0, 0.8, 4.85
KAPPA_FACTOR = 50.29216
_EPS = 1e-12


def _norm(v: Tensor) -> Tensor:
    return torch.sqrt(torch.clamp_min(torch.sum(v * v, -1), _EPS))


def _pairs(pos: Tensor, idx: Tensor) -> Tensor:
    return pos[..., idx[:, 0], :] - pos[..., idx[:, 1], :]


def _torsion(pos, idx, params, mask) -> Tensor:
    p = [pos[..., idx[:, k], :] for k in range(4)]
    b1, b2, b3 = p[0] - p[1], p[1] - p[2], p[2] - p[3]
    n1 = torch.linalg.cross(b1, b2)
    n2 = torch.linalg.cross(b2, b3)
    sin_num = torch.sum(b2 * torch.linalg.cross(n1, n2), -1) / _norm(b2)
    phi = -torch.atan2(sin_num, torch.sum(n1 * n2, -1)).unsqueeze(-1)
    k, phi0, per = params[..., 0], params[..., 1], params[..., 2]
    amber = k * (1.0 + torch.cos(per * phi - phi0))
    dp = phi - phi0
    dp = dp - 2.0 * math.pi * torch.round(dp / (2.0 * math.pi))
    e = torch.where(per > 0, amber, k * dp * dp)
    return torch.sum(torch.where(mask, e, torch.zeros_like(e)), dim=(-2, -1))


def bonded(pos: Tensor, s) -> Dict[str, Tensor]:
    """Bonds, Urey-Bradley, angles, dihedrals, impropers and the scaled 1-4
    pairs (LJ and plain Coulomb, no cutoff)."""
    out = {}
    for name, idx, par in (("bonds", s.bonds, s.bond_params), ("urey_bradley", s.ub_bonds,
                                                                s.ub_params)):
        d = _norm(_pairs(pos, idx))
        out[name] = torch.sum(par[:, 0] * (d - par[:, 1]) ** 2, -1)
    a = s.angles
    r21 = pos[..., a[:, 0], :] - pos[..., a[:, 1], :]
    r23 = pos[..., a[:, 2], :] - pos[..., a[:, 1], :]
    theta = torch.atan2(_norm(torch.linalg.cross(r21, r23)), torch.sum(r21 * r23, -1))
    out["angles"] = torch.sum(s.angle_params[:, 0] * (theta - s.angle_params[:, 1]) ** 2, -1)
    out["dihedrals"] = _torsion(pos, s.dihedrals, s.dihedral_params, s.dihedral_term_mask)
    out["impropers"] = _torsion(pos, s.impropers, s.improper_params, s.improper_term_mask)
    d = _norm(_pairs(pos, s.idx14))
    inv6 = (1.0 / d) ** 6
    p = s.nb14_params
    q = s.charges
    out["lj14"] = torch.sum((p[:, 0] * inv6 * inv6 - p[:, 1] * inv6) / p[:, 2], -1)
    out["elec14"] = torch.sum(
        ELEC_FACTOR * q[s.idx14[:, 0]] * q[s.idx14[:, 1]] / d / p[:, 3], -1)
    return out


def nonbonded(pos: Tensor, s, e: dict) -> Dict[str, Tensor]:
    """LJ with the cubic switch and Coulomb (reaction field where ``rfa``)
    over the unexcluded pairs within the cutoff: each unordered pair once,
    as the mask of the system file holds it."""
    delta = pos.unsqueeze(-2) - pos.unsqueeze(-3)
    d2 = torch.sum(delta * delta, -1)
    rc = e["cutoff"]
    mask = s.nb_mask & (d2 <= rc * rc)
    d = torch.sqrt(torch.where(mask, d2, torch.ones_like(d2)))
    inv = 1.0 / d
    inv6 = inv**6
    zero = torch.zeros_like(d2)
    if e["rfa"]:
        eps_s = e["solvent_dielectric"]
        krf = (eps_s - 1.0) / ((2.0 * eps_s + 1.0) * rc**3)
        crf = 3.0 * eps_s / ((2.0 * eps_s + 1.0) * rc)
        pot_e = s.qq_pair * (inv + krf * d * d - crf)
    else:
        pot_e = s.qq_pair * inv
    pot_l = s.lj_a_pair * inv6 * inv6 - s.lj_b_pair * inv6
    sw_on = e["switch_dist"]
    t = (d - sw_on) / (rc - sw_on)
    sw = 1.0 + t * t * t * (-10.0 + t * (15.0 - t * 6.0))
    pot_l = torch.where(d > sw_on, pot_l * sw, pot_l)
    return {"electrostatics": torch.sum(torch.where(mask, pot_e, zero), (-2, -1)),
            "lj": torch.sum(torch.where(mask, pot_l, zero), (-2, -1))}


def _distances(pos: Tensor):
    delta = pos.unsqueeze(-2) - pos.unsqueeze(-3)
    n = pos.shape[-2]
    off = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    d2 = torch.sum(delta * delta, -1)
    d = torch.sqrt(torch.where(off, d2, torch.ones_like(d2)))
    return torch.where(off, d, torch.zeros_like(d)), off, d2


def born_radii(pos: Tensor, s) -> Tensor:
    """OBC II effective Born radii from HCT pairwise descreening, every pair
    (no cutoff)."""
    radii = s.gb_radii
    rho = radii - GB_OFFSET
    d, off, _ = _distances(pos)
    one = torch.ones_like(d)
    d_safe = torch.where(off, d, one)
    s_j = (s.gb_screen * rho)[None, :]
    rho_i = rho[:, None]
    upper = d + s_j
    lower = torch.maximum(torch.abs(d - s_j), rho_i.expand_as(d))
    live = off & (rho_i < upper)
    lo = torch.where(live, lower, one)
    up = torch.where(live, upper, one)
    integral = (1.0 / lo - 1.0 / up
                + 0.25 * (d_safe - s_j * s_j / d_safe) * (1.0 / (up * up) - 1.0 / (lo * lo))
                + 0.5 * torch.log(lo / up) / d_safe)
    inside = live & (rho_i < s_j - d)
    integral = integral + torch.where(inside, 2.0 * (1.0 / rho_i - 1.0 / lo),
                                      torch.zeros_like(d))
    integral = torch.where(live, integral, torch.zeros_like(d))
    psi = 0.5 * rho * torch.sum(integral, -1)
    arg = psi * (OBC_ALPHA + psi * (-OBC_BETA + OBC_GAMMA * psi))
    return 1.0 / (1.0 / rho - torch.tanh(arg) / radii)


def gb(pos: Tensor, s, e: dict) -> Tensor:
    """The Still GB polarisation energy with its self terms and Debye
    screening of the stated salt at the stated temperature."""
    born = born_radii(pos, s)
    _, _, d2 = _distances(pos)
    bb = born.unsqueeze(-1) * born.unsqueeze(-2)
    f = torch.sqrt(d2 + bb * torch.exp(-d2 / (4.0 * bb)))
    eps_s = e["solvent_dielectric"]
    kappa = KAPPA_FACTOR * math.sqrt(e["ion_concentration"] / (eps_s * e["gb_temperature"]))
    pref = ELEC_FACTOR * (1.0 - torch.exp(-kappa * f) / eps_s)
    q = s.charges
    return -0.5 * torch.sum(pref * q[:, None] * q[None, :] / f, (-2, -1))


def sasa(pos: Tensor, s, e: dict) -> Tensor:
    """Surface tension times the LCPO surface area of the heavy atoms."""
    r = s.sasa_radii
    active = r > 0.0
    d, off, _ = _distances(pos)
    d_safe = torch.where(off, d, torch.ones_like(d))
    ri, rj = r[:, None], r[None, :]
    overlap = (off & active[:, None] & active[None, :] & (d < ri + rj)
               & (d > torch.abs(ri - rj)))
    a = 2.0 * math.pi * ri * (ri - d_safe / 2.0 - (ri * ri - rj * rj) / (2.0 * d_safe))
    a = torch.where(overlap, a, torch.zeros_like(a))
    o = overlap.to(pos.dtype)
    p = s.sasa_params
    area = (p[:, 0] * 4.0 * math.pi * r * r + p[:, 1] * torch.sum(a, -1)
            + p[:, 2] * torch.einsum("...ij,...jk,...ik->...i", o, a, o)
            + p[:, 3] * torch.einsum("...ij,...jk,...ik->...i", a, a, o))
    area = torch.where(active, torch.clamp_min(area, 0.0), torch.zeros_like(area))
    return e["surface_tension"] * torch.sum(area, -1)


def potential_terms(pos: Tensor, s, e: dict) -> Dict[str, Tensor]:
    """Every term of the configuration's potential, each of shape ``(...)``."""
    out = {**bonded(pos, s), **nonbonded(pos, s, e)}
    if "gb" in e["terms"]:
        out["gb"] = gb(pos, s, e)
    if "sasa" in e["terms"]:
        out["sasa"] = sasa(pos, s, e)
    return out


def potential(pos: Tensor, s, e: dict) -> Tensor:
    return torch.stack(list(potential_terms(pos, s, e).values())).sum(0)


class Bias:
    """The moving harmonic restraint on the distance between the centres of
    two atom groups: ``0.5 fk (centre(t) - dist)^2``, the centre moving
    linearly from ``cent_0`` by ``pull`` over ``pull_steps`` and held there."""

    def __init__(self, n_atoms, group1, group2, fk, cent_0, pull, pull_steps, device, dtype):
        w = torch.zeros(n_atoms, dtype=torch.float64)
        w[list(group2)] += 1.0 / len(group2)
        w[list(group1)] -= 1.0 / len(group1)
        self.wdiff = w.to(device=device, dtype=dtype)
        self.fk, self.cent_0, self.pull, self.pull_steps = fk, cent_0, pull, pull_steps

    def centre(self, step: Tensor) -> Tensor:
        t = torch.clamp(step.to(torch.float64), max=float(self.pull_steps))
        return self.cent_0 + self.pull / self.pull_steps * t

    def colvar(self, pos: Tensor) -> Tensor:
        com = torch.einsum("n,...nd->...d", self.wdiff, pos)
        return torch.sqrt(torch.clamp_min(torch.sum(com * com, -1), _EPS))

    def energy(self, pos: Tensor, step: Tensor) -> Tensor:
        c = self.centre(step).to(pos.dtype)
        return 0.5 * self.fk * (c - self.colvar(pos)) ** 2


def forces(pos: Tensor, s, e: dict, bias: Bias = None, step: Tensor = None,
           terms=None) -> Tensor:
    """Minus the gradient of the potential (of ``terms`` alone where given),
    plus the restraint at ``step`` (one per row), by autograd."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        parts = potential_terms(p, s, e)
        if terms is not None:
            parts = {k: v for k, v in parts.items() if k in terms}
        total = torch.stack(list(parts.values())).sum(0) if parts else (p * 0.0).sum((-2, -1))
        if bias is not None:
            total = total + bias.energy(p, step)
        (g,) = torch.autograd.grad(total.sum(), p)
    return -g
