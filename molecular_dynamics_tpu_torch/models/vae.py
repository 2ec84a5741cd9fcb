"""Conditional VAE over trajectory frames.

The reference's time-conditioned VAE: one-hot time-bucket conditioning on
both encoder and decoder, reparameterised sampling, the MSE + KLD objective,
and a generation sweep over the buckets. The reparameterisation draw
``eps`` is an argument: the caller draws it from its ``torch.Generator``.
Attribute names follow flax's scopes (``encoder``, ``mu_head``,
``logvar_head``, ``decoder``), so ``convert`` maps the trees onto each other.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from molecular_dynamics_tpu_torch.models.common import MLP, dense

Tensor = torch.Tensor


class ConditionalVAE(nn.Module):
    def __init__(self, out_dim: int, latent_dim: int = 32, n_time_buckets: int = 10,
                 enc_hidden: Sequence[int] = (256, 128), dec_hidden: Sequence[int] = (128, 256),
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.out_dim, self.latent_dim, self.n_time_buckets = out_dim, latent_dim, n_time_buckets
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.encoder = MLP(out_dim + n_time_buckets, tuple(enc_hidden), final_activation=torch.relu,
                           **kw)
        self.mu_head = dense(enc_hidden[-1], latent_dim, **kw)
        self.logvar_head = dense(enc_hidden[-1], latent_dim, **kw)
        self.decoder = MLP(latent_dim + n_time_buckets, tuple(dec_hidden) + (out_dim,), **kw)

    def _onehot(self, bucket: Tensor, like: Tensor) -> Tensor:
        return F.one_hot(bucket.long(), self.n_time_buckets).to(like.dtype)

    def encode(self, x: Tensor, bucket: Tensor) -> Tuple[Tensor, Tensor]:
        h = self.encoder(torch.cat([x, self._onehot(bucket, x)], dim=-1))
        return self.mu_head(h), self.logvar_head(h)

    def decode(self, z: Tensor, bucket: Tensor) -> Tensor:
        return self.decoder(torch.cat([z, self._onehot(bucket, z)], dim=-1))

    def forward(self, x: Tensor, bucket: Tensor, eps: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """(reconstruction, mu, logvar); ``eps`` is the standard normal draw
        of the reparameterisation, ``(B, latent_dim)``."""
        mu, logvar = self.encode(x, bucket)
        z = mu + torch.exp(0.5 * logvar) * eps.to(mu.dtype)
        return self.decode(z, bucket), mu, logvar


def vae_loss(recon: Tensor, x: Tensor, mu: Tensor, logvar: Tensor, beta: float = 1.0) -> Tensor:
    """MSE + beta x KLD, each summed over the features, averaged over the batch."""
    mse = torch.sum((recon - x) ** 2, dim=-1)
    kld = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=-1)
    return torch.mean(mse + beta * kld)
