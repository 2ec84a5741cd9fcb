"""The reference's log entry of a state: the quantities a campaign logs at a
save, from positions, velocities and the step alone."""

from __future__ import annotations

import torch

from mdbench.reference import energy as E


def observables(pos, vel, step, s, cfg: dict, bias) -> dict:
    """``epot``, ``ekin``, ``etot``, ``T`` and the colvar's centre, value and
    energy of every row; ``T`` counts 3N less one degree of freedom per
    rigid bond."""
    epot = E.potential(pos, s, cfg["energy"])
    ekin = 0.5 * torch.sum(s.masses[:, None] * vel * vel, (-2, -1))
    dof = 3 * s.n_atoms - (s.n_constraints if cfg["integrator"]["constrain_h_bonds"] else 0)
    return {
        "step": step,
        "epot": epot,
        "ekin": ekin,
        "etot": epot + ekin,
        "T": 2.0 * ekin / (dof * E.BOLTZMANN),
        "colvar_center": bias.centre(step).to(pos.dtype),
        "colvar_value": bias.colvar(pos),
        "colvar_energy": bias.energy(pos, step),
    }
