"""Time-conditioned GAN for reaction-pathway structure generation.

The flagship family: a generator mapping (noise z, normalized
reaction-coordinate time t) to coordinates, and a discriminator scoring
(t, features) pairs, where the features are raw positions, dihedral angles
or distance matrices. The informed training phase evaluates the force-field
energy of the generated batch in one batched call (``train.losses``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from molecular_dynamics_tpu_torch.models.common import dense_layers


def _conform_time(t, ref: torch.Tensor) -> torch.Tensor:
    """Broadcast scalar or per-sample t to ``ref.shape[:-1] + (1,)``."""
    t = torch.as_tensor(t, dtype=ref.dtype, device=ref.device)
    if t.ndim == ref.ndim - 1 and t.ndim > 0:
        t = t[..., None]
    return torch.broadcast_to(t, ref.shape[:-1] + (1,))


class Generator(nn.Module):
    """MLP decoder: (z, t) -> flattened coordinates (n_atoms * 3,).

    ``t`` is the normalized frame index / reaction coordinate in [0, 1].
    The input is ``[z, t]``, in that order.
    """

    def __init__(
        self,
        n_atoms: int,
        latent_dim: int = 31,
        hidden: Sequence[int] = (128, 256, 512),
        generator: Optional[torch.Generator] = None,
        device=None,
        dtype=torch.float32,
    ):
        super().__init__()
        self.n_atoms = n_atoms
        self.latent_dim = latent_dim
        self.layers = dense_layers(
            (*hidden, n_atoms * 3), latent_dim + 1, generator, device, dtype)

    def forward(self, z: torch.Tensor, t) -> torch.Tensor:
        x = torch.cat([z, _conform_time(t, z)], dim=-1)
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)

    def coords(self, z: torch.Tensor, t) -> torch.Tensor:
        """Generated coordinates reshaped to (..., n_atoms, 3)."""
        flat = self(z, t)
        return flat.reshape(flat.shape[:-1] + (self.n_atoms, 3))


class Discriminator(nn.Module):
    """MLP critic on (t, features): one BCE logit a sample.

    ``features`` can be flattened coordinates, dihedral angles or distance
    matrices. The input is ``[t, features]``, in that order.
    """

    def __init__(
        self,
        in_features: int,
        hidden: Sequence[int] = (512, 256, 128),
        generator: Optional[torch.Generator] = None,
        device=None,
        dtype=torch.float32,
    ):
        super().__init__()
        self.layers = dense_layers((*hidden, 1), in_features + 1, generator, device, dtype)

    def forward(self, features: torch.Tensor, t) -> torch.Tensor:
        x = torch.cat([_conform_time(t, features), features], dim=-1)
        for layer in self.layers[:-1]:
            x = F.leaky_relu(layer(x), 0.2)
        return self.layers[-1](x)[..., 0]
