"""Neural SDE-GAN training: Wasserstein critic (weight clipping or a
gradient penalty), moment and quantile matching, stochastic weight
averaging and force-field potential injection.

The generator maximises the critic on generated paths; the critic's
Lipschitz constraint is a clamp of its weights (``gp_weight == 0``) or the
WGAN-GP penalty, a double backward through the critic at random
interpolates of real and generated paths; every ``potential_every`` updates
the generator also minimises the potential energy of its generated
structures through the differentiable energy. Adadelta optimizes, or bare
Adam (``adam=True``, the driver's choice). Every random draw (the paths'
``z0`` and ``dw``, the interpolation weights ``eps``) is an argument of the
steps: the caller draws them from its ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from molecular_dynamics_tpu_torch.energy import EnergyConfig, REFERENCE_CONFIG
from molecular_dynamics_tpu_torch.ff.params import FFParams
from molecular_dynamics_tpu_torch.models.sde import CDEDiscriminator, SDEGenerator
from molecular_dynamics_tpu_torch.train.common import Adadelta, ClippedAdam, descend
from molecular_dynamics_tpu_torch.train.losses import potential_loss

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SDEGANConfig:
    lr_g: float = 1e-2
    lr_d: float = 5e-2
    #: > 0 switches the critic constraint from weight clipping to a WGAN-GP
    #: gradient penalty
    gp_weight: float = 0.0
    adam: bool = False  # Adam instead of the reference's Adadelta
    #: per-feature moment matching: the mean and the standard deviation
    #: (ddof 0) of the generated batch against the real batch's, per time step
    moment_weight: float = 0.0
    #: empirical-Wasserstein marginal matching: the mean of |sorted generated
    #: batch - sorted real batch| per (time, feature)
    quantile_weight: float = 0.0
    weight_decay: float = 0.01  # Adadelta's weight decay
    #: the critic clamp: each 2-D weight to +-1/out_features, else every
    #: parameter to +-weight_clip
    per_layer_clip: bool = False
    weight_clip: float = 0.98
    swa_decay: float = 0.99
    potential_every: int = 10
    potential_weight: float = 1e-3
    #: the generator's initial weights scaled by scope: ``initial`` by
    #: init_mult_initial, ``drift`` and ``diffusion`` by init_mult_func
    init_mult_initial: float = 1.0
    init_mult_func: float = 1.0


def scale_init(generator: SDEGenerator, config: SDEGANConfig) -> None:
    """The init scaling, in place, by parameter name."""
    with torch.no_grad():
        for name, p in generator.named_parameters():
            if "initial" in name:
                p.mul_(config.init_mult_initial)
            elif "drift" in name or "diffusion" in name:
                p.mul_(config.init_mult_func)


def generator_loss(generator: SDEGenerator, discriminator: CDEDiscriminator, ts: Tensor,
                   z0: Tensor, dw: Tensor, real: Tensor, cond: Optional[Tensor] = None,
                   config: SDEGANConfig = SDEGANConfig()) -> Tensor:
    """The critic's negated mean on generated paths, plus the moment and
    quantile terms where their weights are positive."""
    fake = generator(ts, z0, dw, cond)
    real = real.to(fake.dtype)
    loss = -torch.mean(discriminator(fake, ts, cond))
    if config.moment_weight > 0.0:
        mean_gap = torch.mean((fake.mean(dim=0) - real.mean(dim=0)) ** 2)
        std_gap = torch.mean((torch.std(fake, dim=0, correction=0)
                              - torch.std(real, dim=0, correction=0)) ** 2)
        loss = loss + config.moment_weight * (mean_gap + std_gap)
    if config.quantile_weight > 0.0:
        loss = loss + config.quantile_weight * torch.mean(torch.abs(
            torch.sort(fake, dim=0).values - torch.sort(real, dim=0).values))
    return loss


def critic_loss(discriminator: CDEDiscriminator, generator: SDEGenerator, ts: Tensor, z0: Tensor,
                dw: Tensor, eps: Tensor, real: Tensor, cond: Optional[Tensor] = None,
                config: SDEGANConfig = SDEGANConfig()) -> Tensor:
    """The Wasserstein gap ``mean D(fake) - mean D(real)`` (the fakes made
    without a graph to the generator), plus, when ``gp_weight > 0``, the
    gradient penalty ``mean((|grad D(mid)| - 1)^2)`` at ``mid = eps * real +
    (1 - eps) * fake``, ``eps (B, 1, 1)``: its input gradient is taken with
    ``create_graph=True``, so the critic's gradient differentiates it again."""
    with torch.no_grad():
        fake = generator(ts, z0, dw, cond)
    real = real.to(fake.dtype)
    loss = torch.mean(discriminator(fake, ts, cond)) - torch.mean(discriminator(real, ts, cond))
    if config.gp_weight > 0.0:
        eps = eps.to(fake.dtype)
        mid = (eps * real + (1.0 - eps) * fake).requires_grad_(True)
        g = _input_gradient(discriminator(mid, ts, cond), mid)
        gn = torch.sqrt(torch.sum(g.reshape(len(g), -1) ** 2, dim=-1) + 1e-12)
        loss = loss + config.gp_weight * torch.mean((gn - 1.0) ** 2)
    return loss


def _input_gradient(scores: Tensor, paths: Tensor) -> Tensor:
    """The gradient of the summed ``scores`` with respect to ``paths``,
    itself differentiable (``create_graph=True``)."""
    (g,) = torch.autograd.grad(torch.sum(scores), paths, create_graph=True)
    return g


@torch.no_grad()
def clip_critic(discriminator: CDEDiscriminator, config: SDEGANConfig) -> None:
    """The weight clamp, in place: each 2-D weight ``(out, in)`` to
    ``+-1/out`` (``per_layer_clip``; biases untouched), else every parameter
    to ``+-weight_clip``."""
    for p in discriminator.parameters():
        if not config.per_layer_clip:
            p.clamp_(-config.weight_clip, config.weight_clip)
        elif p.ndim == 2:
            p.clamp_(-1.0 / p.shape[0], 1.0 / p.shape[0])


def informed_loss(generator: SDEGenerator, ff: FFParams, ts: Tensor, z0: Tensor, dw: Tensor,
                  cond: Optional[Tensor] = None, config: SDEGANConfig = SDEGANConfig(),
                  energy_config: EnergyConfig = REFERENCE_CONFIG,
                  unwhiten: Optional[Tuple[Tensor, Tensor]] = None) -> Tensor:
    """``potential_weight`` x the mean potential energy of the generated
    paths' frames ``(B*T, N, 3)``; ``unwhiten = (mean, std)`` maps whitened
    paths to Angstrom first (differentiably)."""
    fake = generator(ts, z0, dw, cond)
    if unwhiten is not None:
        fake = fake * unwhiten[1].to(fake.dtype) + unwhiten[0].to(fake.dtype)
    coords = fake.reshape(-1, ff.n_atoms, 3)
    return config.potential_weight * potential_loss(coords, ff, config=energy_config)


@torch.no_grad()
def swa_update(avg: torch.nn.Module, model: torch.nn.Module, n_averaged: int) -> None:
    """Uniform running average, in place: ``a += (p - a) / (n_averaged + 1)``."""
    for a, p in zip(avg.parameters(), model.parameters()):
        a.copy_(a + (p - a) / (n_averaged + 1.0))


def make_sde_gan_trainer(generator: SDEGenerator, discriminator: CDEDiscriminator, ts: Tensor,
                         ff: Optional[FFParams] = None,
                         energy_config: EnergyConfig = REFERENCE_CONFIG,
                         config: SDEGANConfig = SDEGANConfig(),
                         unwhiten: Optional[Tuple[Tensor, Tensor]] = None):
    """``(init_fn, (opt_g, opt_d), g_step, d_step, informed_step, swa_update)``.

    ``init_fn()`` scales the generator's initial weights (``scale_init``);
    ``g_step(z0, dw, real, cond)``, ``d_step(z0, dw, eps, real, cond)`` (then
    the clamp, when there is no gradient penalty) and ``informed_step(z0,
    dw, cond)`` update in place and return the loss; the generator's two
    steps share ``opt_g``."""
    if config.adam:
        opt_g = ClippedAdam(generator.parameters(), lr=config.lr_g, clip_norm=None)
        opt_d = ClippedAdam(discriminator.parameters(), lr=config.lr_d, clip_norm=None)
    else:
        opt_g = Adadelta(generator.parameters(), config.lr_g, weight_decay=config.weight_decay)
        opt_d = Adadelta(discriminator.parameters(), config.lr_d,
                         weight_decay=config.weight_decay)

    def init_fn():
        scale_init(generator, config)

    def g_step(z0, dw, real, cond=None):
        loss = generator_loss(generator, discriminator, ts, z0, dw, real, cond, config)
        descend(opt_g, loss)
        return loss.detach()

    def d_step(z0, dw, eps, real, cond=None):
        loss = critic_loss(discriminator, generator, ts, z0, dw, eps, real, cond, config)
        descend(opt_d, loss)
        if config.gp_weight <= 0.0:
            clip_critic(discriminator, config)
        return loss.detach()

    def informed_step(z0, dw, cond=None):
        loss = informed_loss(generator, ff, ts, z0, dw, cond, config, energy_config, unwhiten)
        descend(opt_g, loss)
        return loss.detach()

    return init_fn, (opt_g, opt_d), g_step, d_step, informed_step, swa_update
