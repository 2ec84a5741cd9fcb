"""Dense SchNet: continuous-filter convolutions over atom distances.

A ``CfConv`` block weights neighbour features by a filter network of the
pairwise distances, followed by interaction blocks with shifted-softplus
activations. At these sizes (N up to a few hundred atoms) the convolution is
a dense ``(B, N, N, F)`` filter contracted with ``torch.einsum``.

Each module keeps flax's parameter names in its attributes: the dense
layers in ``layers`` in the order flax numbers them (``Dense_0``,
``Dense_1``, ...: the order they are built in, which for
``Dense(2)(f(Dense(F // 2)(h)))`` puts the outer layer first), the filter blocks in ``cfconv`` (``CfConv_k``)
and the atom-type table in ``embed`` (``Embed_0``); ``convert`` maps the
trees onto each other.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from molecular_dynamics_tpu_torch.convert import resolve_device
from molecular_dynamics_tpu_torch.features import distance_matrix
from molecular_dynamics_tpu_torch.models.common import TRUNCATED_NORMAL_STD, dense_layers

Tensor = torch.Tensor

LOG2 = math.log(2.0)


def shifted_softplus(x: Tensor) -> Tensor:
    return torch.nn.functional.softplus(x) - LOG2


class CfConv(nn.Module):
    """Continuous-filter convolution: h_i' = sum_j W(d_ij) * h_j.

    ``rbf = 0`` feeds the filter network the reference's raw distance kernel
    exp(-d), which saturates to 0 a few Angstrom out; ``rbf > 0`` expands
    d_ij on that many Gaussian radial bases spanning [0, rbf_cut]."""

    def __init__(self, features: int, filter_hidden: int = 64, rbf: int = 0,
                 rbf_cut: float = 24.0, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.rbf, self.rbf_cut = rbf, rbf_cut
        self.layers = dense_layers((filter_hidden, features), rbf or 1, generator, device, dtype)

    def forward(self, h: Tensor, dist: Tensor) -> Tensor:
        """h (..., N, F), dist (..., N, N) -> (..., N, F)."""
        if self.rbf:
            mu = torch.linspace(0.0, self.rbf_cut, self.rbf, device=dist.device, dtype=dist.dtype)
            gamma = (self.rbf - 1) / self.rbf_cut  # about 1 / spacing
            w = torch.exp(-gamma * (dist[..., None] - mu) ** 2)  # (..., N, N, K)
        else:
            w = torch.exp(-dist)[..., None]  # (..., N, N, 1)
        w = shifted_softplus(self.layers[0](w))
        w = shifted_softplus(self.layers[1](w))  # (..., N, N, F)
        return torch.einsum("...ijf,...jf->...if", w, h)


def _embed(num: int, features: int, generator, device, dtype) -> nn.Embedding:
    """flax's ``Embed`` init: a normal truncated at two standard deviations
    with standard deviation ``sqrt(1 / features)``."""
    table = nn.Embedding(num, features, device=device, dtype=dtype)
    std = math.sqrt(1.0 / features) / TRUNCATED_NORMAL_STD
    with torch.no_grad():
        nn.init.trunc_normal_(table.weight, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=generator)
    return table


class SchNet(nn.Module):
    """Embedding -> ``n_interactions`` interaction blocks -> atomwise
    readout. ``layers``: one (in, out) pair per interaction, then the
    readout's ``Dense(out_dim)`` and ``Dense(features // 2)``."""

    def __init__(self, features: int = 64, n_interactions: int = 3, out_dim: int = 1,
                 readout: str = "sum", generator=None, device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.n_interactions, self.readout = n_interactions, readout
        self.embed = _embed(64, features, generator, device, dtype)
        self.layers = nn.ModuleList()
        for _ in range(n_interactions):
            self.layers.extend(dense_layers((features, features), features, generator, device,
                                            dtype))
        self.layers.extend(dense_layers((out_dim,), features // 2, generator, device, dtype))
        self.layers.extend(dense_layers((features // 2,), features, generator, device, dtype))
        self.cfconv = nn.ModuleList(
            CfConv(features, generator=generator, device=device, dtype=dtype)
            for _ in range(n_interactions))

    def forward(self, pos: Tensor, atom_types: Tensor) -> Tensor:
        dist = distance_matrix(pos)
        h = self.embed(atom_types)
        return _readout(self, _interactions(self, h, dist), self.readout)


class SchNetHNN(nn.Module):
    """SchNet-backbone scalar-field pair for the HNN line: a dense embedding
    of the velocity half, interaction blocks whose filters read the
    distances of the position half, and an atomwise two-channel head summed
    over atoms to the (F1, F2) fields. Drop-in for ``models.hnn.HNN``: rows
    ``(B, 2 * 3N) -> (B, 2)`` and a ``field_type``. ``layers``: the velocity
    embedding, one (in, out) pair per interaction, then the head's
    ``Dense(2)`` and ``Dense(features // 2)``."""

    def __init__(self, n_atoms: int, features: int = 64, n_interactions: int = 3,
                 rbf: int = 0, field_type: str = "solenoidal", generator=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        self.n_atoms, self.n_interactions, self.field_type = n_atoms, n_interactions, field_type
        self.layers = dense_layers((features,), 3, generator, device, dtype)
        for _ in range(n_interactions):
            self.layers.extend(dense_layers((features, features), features, generator, device,
                                            dtype))
        self.layers.extend(dense_layers((2,), features // 2, generator, device, dtype))
        self.layers.extend(dense_layers((features // 2,), features, generator, device, dtype))
        self.cfconv = nn.ModuleList(
            CfConv(features, rbf=rbf, generator=generator, device=device, dtype=dtype)
            for _ in range(n_interactions))

    def forward(self, x: Tensor) -> Tensor:
        n = self.n_atoms
        pos = x[..., : 3 * n].reshape(*x.shape[:-1], n, 3)
        vel = x[..., 3 * n:].reshape(*x.shape[:-1], n, 3)
        dist = distance_matrix(pos)
        h = self.layers[0](vel)  # the velocity-channel embedding
        return _readout(self, _interactions(self, h, dist, first=1), "sum")


def _interactions(module, h: Tensor, dist: Tensor, first: int = 0) -> Tensor:
    """The residual interaction blocks: ``layers[first + 2k]``, ``cfconv[k]``,
    ``layers[first + 2k + 1]``."""
    for k in range(module.n_interactions):
        v = module.layers[first + 2 * k](h)
        v = module.cfconv[k](v, dist)
        v = module.layers[first + 2 * k + 1](shifted_softplus(v))
        h = h + v
    return h


def _readout(module, h: Tensor, readout: str) -> Tensor:
    """The last two layers: ``layers[-2](ssp(layers[-1](h)))``, summed over
    atoms for ``"sum"``."""
    out = module.layers[-2](shifted_softplus(module.layers[-1](h)))
    return torch.sum(out, dim=-2) if readout == "sum" else out
