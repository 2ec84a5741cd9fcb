"""Shared model building blocks.

Every dense layer starts as flax's ``Dense`` does: a LeCun-normal kernel (a
normal truncated at two standard deviations, scaled so that its standard
deviation is ``sqrt(1 / fan_in)``) and a zero bias. ``nn.Linear``'s own
initialisation (uniform, a third of that variance, a non-zero bias) would
change what a few epochs of training reach. The layers of a module are its
``layers`` list, in the order of flax's ``Dense_0``, ``Dense_1``, ...
(``convert.flax_params_to_state_dict`` maps one onto the other).
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


def dense_layers(
    widths: Sequence[int], in_features: int, generator=None, device=None,
    dtype=torch.float32,
) -> nn.ModuleList:
    """``nn.Linear`` layers of the given widths, initialised as flax's
    ``Dense`` (LeCun-normal kernel, zero bias)."""
    device = resolve_device(device)
    layers = nn.ModuleList()
    for width in widths:
        layer = nn.Linear(in_features, width, device=device, dtype=dtype)
        lecun_normal_(layer.weight, generator)
        with torch.no_grad():
            layer.bias.zero_()
        layers.append(layer)
        in_features = width
    return layers


class MLP(nn.Module):
    """Plain MLP with configurable widths and activations (the generator /
    discriminator stacks are the same shape). The reference's orthogonal
    initialisation, which only its HNN and autoencoder use, comes with
    those families (ROADMAP A11, A13).

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
    ):
        super().__init__()
        self.activation = activation
        self.final_activation = final_activation
        self.layers = dense_layers(features, in_features, generator, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = self.activation(x)
            elif self.final_activation is not None:
                x = self.final_activation(x)
        return x
