"""Physics-informed and geometric training losses (all batched).

Potential-energy losses with optional per-term weights, SMD-bias losses,
distance-matrix and kNN-masked distance losses, torsion-angle losses and
Kabsch-RMSD pretraining losses. Each takes a ``(B, N, 3)`` batch and makes
one batched call where the reference maps a per-sample function over it.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from molecular_dynamics_tpu_torch.energy import (
    EnergyConfig,
    REFERENCE_CONFIG,
    dihedral_angles,
    energy_terms,
)
from molecular_dynamics_tpu_torch.features import aligned_rmsd, distance_matrix
from molecular_dynamics_tpu_torch.ff.params import FFParams

Tensor = torch.Tensor


def potential_loss(
    coords: Tensor,  # (batch, N, 3)
    ff: FFParams,
    config: EnergyConfig = REFERENCE_CONFIG,
    term_weights: Optional[Dict[str, float]] = None,
) -> Tensor:
    """Mean (optionally per-term-weighted) potential energy of a batch: one
    batched ``energy_terms`` call."""
    terms = energy_terms(coords, ff, config=config)
    if term_weights is None:
        per_sample = sum(terms.values())
    else:
        per_sample = sum(terms[k] * w for k, w in term_weights.items())
    return torch.mean(per_sample)


def bias_energy_loss(coords: Tensor, bias, steps: Tensor) -> Tensor:
    """Mean SMD-bias energy of generated structures at their steps ``(B,)``."""
    return torch.mean(bias.energy(coords, steps))


def distance_matrix_loss(pred: Tensor, target: Tensor, mask: Optional[Tensor] = None) -> Tensor:
    """MSE between pairwise distance matrices; with ``mask`` (N, N) it is
    the banded kNN loss."""
    se = (distance_matrix(pred) - distance_matrix(target)) ** 2
    if mask is not None:
        return torch.sum(se * mask) / (torch.sum(mask) * pred.shape[0] + 1e-12)
    return torch.mean(se)


def torsion_loss(pred: Tensor, target: Tensor, idx: Tensor) -> Tensor:
    """MSE over torsion angles of two coordinate batches, with periodic
    wrapping of the difference."""
    idx = torch.as_tensor(idx, device=pred.device)
    d = dihedral_angles(pred, idx) - dihedral_angles(target, idx)
    d = d - 2 * math.pi * torch.round(d / (2 * math.pi))
    return torch.mean(d * d)


def rmsd_loss(pred: Tensor, target: Tensor) -> Tensor:
    """Mean Kabsch-aligned RMSD over a batch."""
    return torch.mean(aligned_rmsd(pred, target))


def window_composite_loss(
    pred: Tensor,
    target: Tensor,
    phi_idx: Tensor,
    psi_idx: Tensor,
    knn: Tensor,
    w_pos: float = 1.0,
    w_phi: float = 1.0,
    w_psi: float = 1.0,
    w_dist: float = 1.0,
) -> Tensor:
    """Position MSE + phi MSE + psi MSE + kNN-masked distance-matrix MSE."""
    pos_mse = torch.mean((pred - target) ** 2)
    return (
        w_pos * pos_mse
        + w_phi * torsion_loss(pred, target, phi_idx)
        + w_psi * torsion_loss(pred, target, psi_idx)
        + w_dist * distance_matrix_loss(pred, target, knn)
    )
