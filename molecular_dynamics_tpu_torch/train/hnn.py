"""HNN training: derivative regression and potential-informed steps.

Nine of ten steps are plain L2 on the predicted phase-space derivative;
every tenth adds the force-field potential of the *advanced* structure
(x + dx_hat), with per-term weights, backpropagated through the energy and
through the HNN's input gradient (second-order autograd). The recurrent
variant advances ``seq_len`` steps autoregressively and takes the L2
against the dx sequence.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from molecular_dynamics_tpu_torch.energy import REFERENCE_CONFIG, EnergyConfig
from molecular_dynamics_tpu_torch.ff.params import FFParams
from molecular_dynamics_tpu_torch.models.hnn import time_derivative
from molecular_dynamics_tpu_torch.train.common import ClippedAdam, descend
from molecular_dynamics_tpu_torch.train.losses import potential_loss

Tensor = torch.Tensor

#: the reference's potential term weights
DEFAULT_TERM_WEIGHTS = {
    "bonds": 1.0,
    "angles": 1.0,
    "dihedrals": 1.0,
    "impropers": 1.0,
    "lj": 1.0,
    "electrostatics": 1.0,
}


@dataclasses.dataclass(frozen=True)
class HNNTrainConfig:
    lr: float = 1e-3
    clip_norm: float = 1.0
    potential_every: int = 10  # every 10th step adds the energy term
    potential_weight: float = 1e-3
    dt: float = 0.005  # rollout integration factor
    seq_len: int = 1  # > 1 enables the recurrent unroll


def l2_loss(model, x: Tensor, dx: Tensor) -> Tensor:
    """Mean squared error of the predicted derivative on rows ``(B, D)``."""
    return torch.mean((time_derivative(model, x) - dx) ** 2)


def informed_loss(model, ff: FFParams, x: Tensor, dx: Tensor,
                  energy_config: EnergyConfig = REFERENCE_CONFIG,
                  term_weights: Optional[Dict[str, float]] = None,
                  potential_weight: float = 1e-3):
    """(L2 + weight * potential of x + dx_hat, (L2, potential)): the
    position half of the advanced rows as ``(B, N, 3)`` through one batched
    energy call."""
    dx_hat = time_derivative(model, x)
    l2 = torch.mean((dx_hat - dx) ** 2)
    new_x = x + dx_hat
    coords = new_x[..., : new_x.shape[-1] // 2].reshape(x.shape[0], -1, 3)
    pot = potential_loss(coords, ff, config=energy_config,
                         term_weights=term_weights or DEFAULT_TERM_WEIGHTS)
    return l2 + potential_weight * pot, (l2, pot)


def unroll_loss(model, x0: Tensor, dx_seq: Tensor) -> Tensor:
    """Recurrent rollout loss: advance ``x += dx_hat`` along ``dx_seq``
    ``(B, S, D)``, the mean of the S step losses. The chain stays
    differentiable through every step."""
    x, losses = x0, []
    for s in range(dx_seq.shape[1]):
        dx_hat = time_derivative(model, x)
        losses.append(torch.mean((dx_hat - dx_seq[:, s]) ** 2))
        x = x + dx_hat
    return torch.mean(torch.stack(losses))


def make_hnn_trainer(
    model,
    ff: Optional[FFParams] = None,
    energy_config: EnergyConfig = REFERENCE_CONFIG,
    config: HNNTrainConfig = HNNTrainConfig(),
    term_weights: Optional[Dict[str, float]] = None,
):
    """Returns ``(opt, l2_step, informed_step, unroll_step)``.

    ``x`` / ``dx`` batches are phase-space rows ``(B, 2 * N * 3)``; the
    informed step needs ``ff`` to score x + dx_hat through the force field.
    Each step updates ``model`` in place and returns its loss (0-dim tensors
    on the device; the informed step also its ``(l2, potential)``)."""
    opt = ClippedAdam(model.parameters(), lr=config.lr, clip_norm=config.clip_norm)

    def l2_step(x, dx):
        loss = l2_loss(model, x, dx)
        descend(opt, loss)
        return loss.detach()

    def informed_step(x, dx):
        loss, (l2, pot) = informed_loss(model, ff, x, dx, energy_config, term_weights,
                                        config.potential_weight)
        descend(opt, loss)
        return loss.detach(), (l2.detach(), pot.detach())

    def unroll_step(x0, dx_seq):
        loss = unroll_loss(model, x0, dx_seq)
        descend(opt, loss)
        return loss.detach()

    return opt, l2_step, informed_step, unroll_step
