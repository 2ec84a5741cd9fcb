"""Physics-informed conditional-GAN training (the flagship training loop).

The reference's three-phase loop:

1. **G adversarial**: the generator fools D on (t, features(G(z, t))),
2. **D**: BCE on real against generated features,
3. **informed**: the generator minimizes the force-field potential of its
   structures plus a weighted SMD-bias term, backpropagating through the
   energy into the generator's weights,

plus the **decoder pretrain** recipe: potential + distance-matrix MSE +
Kabsch RMSD, with an alpha curriculum on the potential set by the caller.

Each phase's gradient is ``torch.autograd.grad`` over the stepped module's
parameters only: G's adversarial loss runs through D, and no ``.grad`` of
D's carries that pass into D's own update. The G and informed phases keep
two separate Adam states over the same generator parameters. The latent
``z`` is an argument of every step: the caller draws it from an explicit
``torch.Generator`` (or passes the reference's own draws).

In a data-parallel run (``parallel.data``) the trainers take the modules'
``DistributedDataParallel`` wrappers: each phase then descends through
``loss.backward()``, which all-reduces the stepped module's gradients. The
G phase runs the discriminator's own module, not its wrapper, so that no
reduction of D waits on a phase that does not step D; the gradients that
pass leaves on D's parameters are cleared after it.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.nn import functional as F

from molecular_dynamics_tpu_torch.ff.params import FFParams
from molecular_dynamics_tpu_torch.models.cgan import Discriminator, Generator
from molecular_dynamics_tpu_torch.train.common import ClippedAdam, descend, is_data_parallel
from molecular_dynamics_tpu_torch.train.losses import (
    bias_energy_loss,
    distance_matrix_loss,
    potential_loss,
    rmsd_loss,
)

Tensor = torch.Tensor


#: every phase clips its gradient at this global norm, as the reference does
CLIP_NORM = 1.0
#: the informed loss's weight on the SMD bias energy (the reference's 200x
#: end-to-end weight); the potential's weight is 1
W_BIAS = 200.0


@dataclasses.dataclass(frozen=True)
class CGANConfig:
    """Learning rates of the three phases. The latent width is the
    generator's ``latent_dim``."""

    lr_g: float = 1e-4
    lr_d: float = 1e-4
    lr_informed: float = 1e-5


def bce_logits(logits: Tensor, labels: Tensor) -> Tensor:
    return F.binary_cross_entropy_with_logits(logits, labels)


def generated_coords(generator, z: Tensor, t: Tensor) -> Tensor:
    """``Generator.coords`` through ``generator``'s forward, so that a
    ``DistributedDataParallel`` wrapper of it sees the call."""
    flat = generator(z, t)
    return flat.reshape(flat.shape[:-1] + (flat.shape[-1] // 3, 3))


def _module(m):
    return m.module if is_data_parallel(m) else m


#: the bias schedule's steps at t = 1: normalized times t in [0, 1] become
#: bias step counts as in the reference's trainer
BIAS_TOTAL_STEPS = 10000.0


class CGANTrainer:
    """The three update phases over a generator and a discriminator (the
    reference's ``make_cgan_trainer``). The discriminator sees flattened
    positions; the informed loss is the potential under
    ``REFERENCE_CONFIG``. Each step updates its module in place and returns
    its loss (a 0-dim tensor on the device: reading it is a host
    synchronisation, left to the caller). ``generator`` and
    ``discriminator`` may both be ``DistributedDataParallel`` wrappers.
    """

    def __init__(
        self,
        generator: Generator,
        discriminator: Discriminator,
        ff: FFParams,
        bias=None,
        config: CGANConfig = CGANConfig(),
    ):
        self.generator = generator
        self.discriminator = discriminator
        self.ff = ff
        self.bias = bias
        self.config = config
        self.opt_d = ClippedAdam(discriminator.parameters(), config.lr_d, CLIP_NORM,
                                 backward=is_data_parallel(discriminator))
        self.reset_generator_optimizers()

    def reset_generator_optimizers(self) -> None:
        """Fresh Adam states for the G and informed phases."""
        cfg = self.config
        reduced = is_data_parallel(self.generator)
        self.opt_g = ClippedAdam(self.generator.parameters(), cfg.lr_g, CLIP_NORM,
                                 backward=reduced)
        self.opt_i = ClippedAdam(self.generator.parameters(), cfg.lr_informed, CLIP_NORM,
                                 backward=reduced)

    def generate(self, z: Tensor, t: Tensor) -> Tensor:
        return generated_coords(self.generator, z, t)

    def critic(self, coords: Tensor, t: Tensor, discriminator=None) -> Tensor:
        """The discriminator's logits on a coordinate batch (B, N, 3)."""
        d = self.discriminator if discriminator is None else discriminator
        return d(coords.reshape(coords.shape[0], -1), t)

    def g_loss(self, z: Tensor, t: Tensor) -> Tensor:
        logits = self.critic(self.generate(z, t), t, _module(self.discriminator))
        return bce_logits(logits, torch.ones_like(logits))

    def d_loss(self, z: Tensor, real_coords: Tensor, t: Tensor) -> Tensor:
        with torch.no_grad():
            fake = self.generate(z, t)
        logit_fake = self.critic(fake, t)
        logit_real = self.critic(real_coords, t)
        return bce_logits(logit_real, torch.ones_like(logit_real)) + bce_logits(
            logit_fake, torch.zeros_like(logit_fake))

    def informed_loss(self, z: Tensor, t: Tensor) -> Tensor:
        coords = self.generate(z, t)
        total = potential_loss(coords, self.ff)
        if self.bias is not None:
            total = total + W_BIAS * bias_energy_loss(
                coords, self.bias, t * BIAS_TOTAL_STEPS)
        return total

    def g_step(self, z: Tensor, t: Tensor) -> Tensor:
        """Adversarial generator update."""
        loss = self.g_loss(z, t)
        descend(self.opt_g, loss)
        if self.opt_g.backward:
            for p in self.discriminator.parameters():
                p.grad = None
        return loss.detach()

    def d_step(self, z: Tensor, real_coords: Tensor, t: Tensor) -> Tensor:
        """Discriminator update on real against generated."""
        loss = self.d_loss(z, real_coords, t)
        descend(self.opt_d, loss)
        return loss.detach()

    def informed_step(self, z: Tensor, t: Tensor) -> Tensor:
        """Physics-informed update: batched potential + weighted bias
        through the differentiable energy."""
        loss = self.informed_loss(z, t)
        descend(self.opt_i, loss)
        return loss.detach()


class PretrainStep:
    """Decoder pretraining update (the reference's ``make_pretrain_step``):
    ``alpha * mean potential + distance-matrix MSE + Kabsch RMSD``, Adam at
    ``lr`` clipped at global norm ``CLIP_NORM``. ``alpha`` is an argument, so the
    caller ramps it per epoch. ``generator`` may be a
    ``DistributedDataParallel`` wrapper."""

    def __init__(self, generator: Generator, ff: FFParams, lr: float = 1e-4):
        self.generator = generator
        self.ff = ff
        self.opt = ClippedAdam(generator.parameters(), lr, CLIP_NORM,
                               backward=is_data_parallel(generator))

    def loss(self, z: Tensor, real_coords: Tensor, t: Tensor, alpha: float):
        """(loss, (potential, distance-matrix MSE, RMSD))."""
        coords = generated_coords(self.generator, z, t)
        l_pot = potential_loss(coords, self.ff)
        l_dist = distance_matrix_loss(coords, real_coords)
        l_rmsd = rmsd_loss(coords, real_coords)
        return alpha * l_pot + l_dist + l_rmsd, (l_pot, l_dist, l_rmsd)

    def __call__(self, z: Tensor, real_coords: Tensor, t: Tensor, alpha: float):
        val, parts = self.loss(z, real_coords, t, alpha)
        descend(self.opt, val)
        return val.detach(), tuple(p.detach() for p in parts)
