"""Conditional RealNVP normalizing flow.

Masked affine coupling layers with alternating binary masks, conditioned on
the normalized frame index (or Fourier features of it), exact ``log_prob``
for NLL training and inverse-pass conditional sampling. ActNorm (a learned
per-feature affine bijection, zero-initialised) stands in for the
reference's flow BatchNorm, as in the JAX package.

``RealNVP.forward`` is the data -> latent pass, ``(z, log|det J|)``, the
JAX module's ``forward`` method; ``log_prob`` is what the flax module's
``__call__`` returns. ``sample`` takes the base draw ``z`` from the caller.
The coupling nets are flax's ``Dense_0 ...`` chain: the relu hidden layers,
then the scale head, then the shift head, both reading the last hidden
layer.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from molecular_dynamics_tpu_torch.models.common import dense
from molecular_dynamics_tpu_torch.convert import resolve_device

Tensor = torch.Tensor


class AffineCoupling(nn.Module):
    """Masked affine coupling ``y = mask*x + (1-mask)*(x*exp(s) + t)``."""

    def __init__(self, mask: Sequence[int], hidden: Sequence[int] = (256, 256), cond_dim: int = 1,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        dim = len(mask)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.register_buffer("mask", torch.as_tensor(np.asarray(mask), dtype=dtype,
                                                      device=resolve_device(device)),
                             persistent=False)
        widths, layers, fan_in = tuple(hidden), [], dim + cond_dim
        for w in widths:
            layers.append(dense(fan_in, w, **kw))
            fan_in = w
        layers += [dense(fan_in, dim, **kw), dense(fan_in, dim, **kw)]  # scale, shift
        self.layers = nn.ModuleList(layers)

    def forward(self, x: Tensor, cond: Tensor, reverse: bool = False) -> Tuple[Tensor, Tensor]:
        mask = self.mask.to(x.dtype)
        h = torch.cat([x * mask, cond.to(x.dtype)], dim=-1)
        for layer in self.layers[:-2]:
            h = torch.relu(layer(h))
        s = torch.tanh(self.layers[-2](h)) * (1.0 - mask)
        t = self.layers[-1](h) * (1.0 - mask)
        if reverse:
            return mask * x + (1.0 - mask) * ((x - t) * torch.exp(-s)), -torch.sum(s, dim=-1)
        return mask * x + (1.0 - mask) * (x * torch.exp(s) + t), torch.sum(s, dim=-1)


class ActNorm(nn.Module):
    """Learned per-feature affine bijection (the BatchNorm stand-in)."""

    def __init__(self, dim: int, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.log_scale = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(dim, device=device, dtype=dtype))

    def forward(self, x: Tensor, reverse: bool = False) -> Tuple[Tensor, Tensor]:
        log_det = torch.sum(self.log_scale) * torch.ones(x.shape[:-1], dtype=x.dtype,
                                                         device=x.device)
        if reverse:
            return (x - self.bias) * torch.exp(-self.log_scale), -log_det
        return x * torch.exp(self.log_scale) + self.bias, log_det


class RealNVP(nn.Module):
    """Alternating-mask RealNVP with a conditioning input: the masks
    alternate ``arange(dim) % 2`` and its complement, each coupling after
    its ActNorm."""

    def __init__(self, dim: int, n_coupling: int = 6, hidden: Sequence[int] = (256, 256),
                 cond_dim: int = 1, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.dim, self.cond_dim = dim, cond_dim
        base = np.arange(dim) % 2
        self.couplings = nn.ModuleList([
            AffineCoupling(base if i % 2 == 0 else 1 - base, hidden, cond_dim, generator, device,
                           dtype) for i in range(n_coupling)])
        self.norms = nn.ModuleList([ActNorm(dim, device, dtype) for _ in range(n_coupling)])

    def forward(self, x: Tensor, cond: Tensor) -> Tuple[Tensor, Tensor]:
        """Data -> latent: ``(z, total log|det J|)``."""
        log_det = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for coupling, norm in zip(self.couplings, self.norms):
            x, ld = norm(x)
            log_det = log_det + ld
            x, ld = coupling(x, cond)
            log_det = log_det + ld
        return x, log_det

    def inverse(self, z: Tensor, cond: Tensor) -> Tensor:
        """Latent -> data (the conditional sampling path)."""
        for coupling, norm in zip(reversed(self.couplings), reversed(self.norms)):
            z, _ = coupling(z, cond, reverse=True)
            z, _ = norm(z, reverse=True)
        return z

    def log_prob(self, x: Tensor, cond: Tensor) -> Tensor:
        """Exact log density under a standard-normal base."""
        z, log_det = self.forward(x, cond)
        return -0.5 * torch.sum(z ** 2 + math.log(2 * math.pi), dim=-1) + log_det

    def sample(self, z: Tensor, cond: Tensor) -> Tensor:
        """``len(z)`` samples at ``cond`` (broadcast to ``(len(z), cond_dim)``)
        from the base draws ``z (n, dim)``."""
        return self.inverse(z, torch.broadcast_to(cond, (len(z), self.cond_dim)))
