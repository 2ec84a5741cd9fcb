"""Trainers of the flow and VAE families.

- ``make_flow_trainer``: conditional-NLL RealNVP training.
- ``make_vae_trainer``: MSE + KLD conditional VAE training; the
  reparameterisation draw is an argument of the step.

Each returns its ``ClippedAdam`` (Adam after optax's global-norm clip,
``clip_norm`` always applied) and a step that updates the model in place and
returns the loss (a 0-dim tensor on the device).
"""

from __future__ import annotations

import torch

from molecular_dynamics_tpu_torch.models.flows import RealNVP
from molecular_dynamics_tpu_torch.models.vae import ConditionalVAE, vae_loss
from molecular_dynamics_tpu_torch.train.common import ClippedAdam, stepper

Tensor = torch.Tensor


def flow_loss(model: RealNVP, x: Tensor, cond: Tensor) -> Tensor:
    """The mean negative log-likelihood of ``x`` at ``cond``."""
    return -torch.mean(model.log_prob(x, cond))


def make_flow_trainer(model: RealNVP, lr: float = 1e-4, clip_norm: float = 1.0):
    """``(opt, step(x, cond))``."""
    opt = ClippedAdam(model.parameters(), lr=lr, clip_norm=clip_norm)
    return opt, stepper(opt, lambda x, c: flow_loss(model, x, c))


def vae_step_loss(model: ConditionalVAE, eps: Tensor, x: Tensor, bucket: Tensor,
                  beta: float = 1.0) -> Tensor:
    """``vae_loss`` of ``model(x, bucket, eps)``."""
    recon, mu, logvar = model(x, bucket, eps)
    return vae_loss(recon, x.to(recon.dtype), mu, logvar, beta)


def make_vae_trainer(model: ConditionalVAE, lr: float = 1e-4, beta: float = 1.0,
                     clip_norm: float = 1.0):
    """``(opt, step(eps, x, bucket))``, ``eps (B, latent_dim)`` the
    reparameterisation's standard normal draw."""
    opt = ClippedAdam(model.parameters(), lr=lr, clip_norm=clip_norm)
    return opt, stepper(opt, lambda e, x, b: vae_step_loss(model, e, x, b, beta))
