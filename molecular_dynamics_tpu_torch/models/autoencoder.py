"""Autoencoders: residual MLP AE, latent (Pixel) HNN, adversarial AE.

- ``MLPAutoencoder``: the encoder / decoder pair (orthogonal kernels), also
  the backbone of ``LatentHNN``: encode frames to a latent phase space, run
  an HNN there, decode.
- ``LatentDiscriminator`` and ``aae_losses``: an AE whose latent
  distribution a critic shapes (reconstruction + latent-adversarial
  training).

Attribute names follow flax's scopes (``encoder``, ``decoder``, ``ae``,
``hnn``), so ``convert`` maps the parameter trees onto each other.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from molecular_dynamics_tpu_torch.models.common import MLP, dense_layers
from molecular_dynamics_tpu_torch.models.hnn import HNN

Tensor = torch.Tensor


class MLPAutoencoder(nn.Module):
    """Residual MLP autoencoder. ``cond_dim > 0`` makes the decoder
    conditional: ``decode(z, c)`` concatenates the conditioning vector."""

    def __init__(self, in_dim: int, latent_dim: int, hidden: Sequence[int] = (256, 128),
                 cond_dim: int = 0, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.in_dim, self.latent_dim, self.cond_dim = in_dim, latent_dim, cond_dim
        kw = dict(generator=generator, device=device, dtype=dtype, use_orthogonal_init=True)
        self.encoder = MLP(in_dim, tuple(hidden) + (latent_dim,), **kw)
        self.decoder = MLP(latent_dim + cond_dim, tuple(reversed(hidden)) + (in_dim,), **kw)

    def encode(self, x: Tensor) -> Tensor:
        return self.encoder(x)

    def decode(self, z: Tensor, c: Optional[Tensor] = None) -> Tensor:
        if self.cond_dim:
            z = torch.cat([z, c], dim=-1)
        return self.decoder(z)

    def forward(self, x: Tensor, c: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        z = self.encode(x)
        return self.decode(z, c), z


class LatentHNN(nn.Module):
    """PixelHNN: autoencode to a latent phase space, HNN dynamics there.
    ``latent_dim`` must be even (the q, p split)."""

    def __init__(self, in_dim: int, latent_dim: int = 16, ae_hidden: Sequence[int] = (256, 128),
                 hnn_hidden: Sequence[int] = (200, 200), generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if latent_dim % 2:
            raise ValueError(f"latent_dim must be even for the (q, p) split, got {latent_dim}")
        self.latent_dim = latent_dim
        self.ae = MLPAutoencoder(in_dim, latent_dim, hidden=ae_hidden, generator=generator,
                                 device=device, dtype=dtype)
        self.hnn = HNN(latent_dim, hidden=hnn_hidden, generator=generator, device=device,
                       dtype=dtype)

    def forward(self, x: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        recon, z = self.ae(x)
        return recon, z, self.hnn(z)

    def encode(self, x: Tensor) -> Tensor:
        return self.ae.encode(x)

    def decode(self, z: Tensor) -> Tensor:
        return self.ae.decode(z)


class LatentDiscriminator(nn.Module):
    """Critic on latent codes for adversarial autoencoders: leaky-ReLU (0.2)
    layers and one logit a code."""

    def __init__(self, latent_dim: int, hidden: Sequence[int] = (128, 64), generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.layers = dense_layers(tuple(hidden) + (1,), latent_dim, generator, device, dtype)

    def forward(self, z: Tensor) -> Tensor:
        h = z
        for layer in self.layers[:-1]:
            h = F.leaky_relu(layer(h), 0.2)
        return self.layers[-1](h)[..., 0]


def _bce(logits: Tensor, label: float) -> Tensor:
    """Mean sigmoid binary cross-entropy against a constant label (optax's
    ``sigmoid_binary_cross_entropy``)."""
    return torch.mean(F.binary_cross_entropy_with_logits(
        logits, torch.full_like(logits, label), reduction="none"))


def aae_losses(recon: Tensor, x: Tensor, d_logits_fake: Tensor,
               d_logits_real: Optional[Tensor] = None):
    """(reconstruction MSE, generator-side BCE, discriminator BCE or None).

    The encoder fools the critic into reading its codes as prior samples;
    the critic separates prior samples from codes."""
    rec = torch.mean((recon - x) ** 2)
    g_adv = _bce(d_logits_fake, 1.0)
    if d_logits_real is None:
        return rec, g_adv, None
    return rec, g_adv, _bce(d_logits_real, 1.0) + _bce(d_logits_fake, 0.0)
