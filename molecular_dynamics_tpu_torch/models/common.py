"""Shared model building blocks.

Every dense layer starts as flax's ``Dense`` does: a LeCun-normal kernel (a
normal truncated at two standard deviations, scaled so that its standard
deviation is ``sqrt(1 / fan_in)``) and a zero bias, or, where the reference
asks for it (its HNN and autoencoder stacks), flax's ``orthogonal()`` kernel.
``nn.Linear``'s own initialisation (uniform, a third of that variance, a
non-zero bias) would change what a few epochs of training reach. The layers
of a module are its ``layers`` list, in the order of flax's ``Dense_0``,
``Dense_1``, ... (``convert.flax_params_to_state_dict`` maps one onto the
other).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from molecular_dynamics_tpu_torch.convert import resolve_device

#: the standard deviation of a standard normal truncated to [-2, 2]
TRUNCATED_NORMAL_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None):
    """flax's ``lecun_normal`` on a torch ``(out, in)`` weight, in place."""
    std = math.sqrt(1.0 / weight.shape[1]) / TRUNCATED_NORMAL_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(
            weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


def orthogonal_(weight: torch.Tensor, generator: Optional[torch.Generator] = None):
    """flax's ``orthogonal()`` on a torch ``(out, in)`` weight, in place.

    flax draws the ``(in, out)`` kernel: a standard normal of shape
    ``(max(in, out), min(in, out))``, its reduced QR, the columns of Q
    multiplied by the signs of R's diagonal, transposed when ``in < out``
    (``jax.random.orthogonal``); the weight is that kernel transposed."""
    n_out, n_in = weight.shape
    with torch.no_grad():
        z = torch.randn((max(n_in, n_out), min(n_in, n_out)), generator=generator,
                        device=weight.device, dtype=torch.float64)
        q, r = torch.linalg.qr(z)
        q = q * torch.sign(torch.diagonal(r))[None, :]
        kernel = q.T if n_in < n_out else q
        return weight.copy_(kernel.T)


def dense(
    in_features: int, out_features: int, generator=None, device=None,
    dtype=torch.float32, bias: bool = True, use_orthogonal_init: bool = False,
) -> nn.Linear:
    """One ``nn.Linear`` initialised as flax's ``Dense`` (LeCun-normal
    kernel, or an orthogonal one; zero bias, or none)."""
    layer = nn.Linear(in_features, out_features, bias=bias, device=resolve_device(device),
                      dtype=dtype)
    (orthogonal_ if use_orthogonal_init else lecun_normal_)(layer.weight, generator)
    if bias:
        with torch.no_grad():
            layer.bias.zero_()
    return layer


def dense_layers(
    widths: Sequence[int], in_features: int, generator=None, device=None,
    dtype=torch.float32, use_orthogonal_init: bool = False,
) -> nn.ModuleList:
    """A chain of ``dense`` layers of the given widths."""
    layers = nn.ModuleList()
    for width in widths:
        layers.append(dense(in_features, width, generator, device, dtype,
                            use_orthogonal_init=use_orthogonal_init))
        in_features = width
    return layers


class MLP(nn.Module):
    """Plain MLP with configurable widths and activations (the generator /
    discriminator stacks are the same shape; ``use_orthogonal_init`` gives
    the HNN and autoencoder stacks the reference's orthogonal kernels).

    flax infers the input width at its first call; a torch layer needs it
    when it is built, so ``in_features`` comes first.
    """

    def __init__(
        self,
        in_features: int,
        features: Sequence[int],
        activation: Callable = torch.relu,
        final_activation: Optional[Callable] = None,
        generator: Optional[torch.Generator] = None,
        device=None,
        dtype=torch.float32,
        use_orthogonal_init: bool = False,
    ):
        super().__init__()
        self.activation = activation
        self.final_activation = final_activation
        self.layers = dense_layers(features, in_features, generator, device, dtype,
                                   use_orthogonal_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.activation(x)
            elif self.final_activation is not None:
                x = self.final_activation(x)
        return x
