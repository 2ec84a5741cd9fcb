"""Angle and torsion terms of a replica batch as one op.

``make_angle_torsion_op(ff)`` returns ``angle_torsion(pos (R, N, 3)) ->
(energy (R,), forces (R, N, 3))`` over the angles, dihedrals and impropers
(multi-term, AMBER where ``per > 0`` else CHARMM), with an ``.energy``
attribute. The composed force path (``sim``, ``fused_nonbonded``) takes every
3- and 4-body force from it and the 2-body ones from a pair op.

The JAX package's ``molecular_dynamics_tpu/ops/bonded.py`` turns the index
gathers into products with +-1 difference matrices on the MXU and has a
``precision`` for them. That is no kernel, and its form suits the TPU: here
the same ``atan2`` formulas run on index gathers (``energy._angle_energy``,
``energy._torsion_energy``) in full ``dtype`` arithmetic (TF32 is off), and
the forces come from autograd. They carry a graph where ``pos`` requires
grad, so the op is differentiable.
"""

from __future__ import annotations

from typing import Tuple

import torch

from molecular_dynamics_tpu_torch.energy import _angle_energy, _torsion_energy
from molecular_dynamics_tpu_torch.ff.params import FFParams

Tensor = torch.Tensor


def make_angle_torsion_op(ff: FFParams, dtype=torch.float32):
    """Build ``angle_torsion(pos) -> (energy (R,), forces (R, N, 3))``,
    evaluated in ``dtype``; the forces come back in the dtype of ``pos``."""
    ffd = ff.to(dtype=dtype)

    def energy(pos: Tensor) -> Tensor:
        """Angle + dihedral + improper energy per replica, ``(R,)``."""
        pos = pos.to(dtype)
        e = torch.zeros(pos.shape[:-2], dtype=dtype, device=pos.device)
        if ffd.angles.shape[0]:
            e = e + _angle_energy(pos, ffd, None)
        for idx, par, msk in (
            (ffd.dihedrals, ffd.dihedral_params, ffd.dihedral_term_mask),
            (ffd.impropers, ffd.improper_params, ffd.improper_term_mask),
        ):
            if idx.shape[0]:
                e = e + _torsion_energy(pos, idx, par, msk, None)
        return e

    def energy_forces(pos: Tensor) -> Tuple[Tensor, Tensor]:
        keep_graph = torch.is_grad_enabled() and pos.requires_grad
        with torch.enable_grad():
            p = pos if keep_graph else pos.detach().requires_grad_(True)
            e = energy(p)
            (grad,) = torch.autograd.grad(e.sum(), p, create_graph=keep_graph)
        return (e if keep_graph else e.detach()), -grad

    energy_forces.energy = energy
    return energy_forces
