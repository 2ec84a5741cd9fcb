"""Neural SDE-GAN: a Stratonovich SDE generator and a neural CDE critic.

The generator integrates a learned Stratonovich SDE in a latent space with
the reversible Heun scheme and reads it out linearly to data space; the
critic is a neural CDE driven by the time-augmented, linearly interpolated
data path; the activations are LipSwish. Both loops are Python loops over
the path's ``len(ts) - 1`` steps, differentiable end to end by autograd.

The generator's randomness is an argument: the initial noise ``z0 (B,
init_noise_dim)`` and the Brownian increments ``dw (T-1, B, noise_dim)``,
already scaled by ``sqrt(dt)``. Attribute names follow flax's scopes (``initial``,
``drift``, ``diffusion``, ``readout``; ``embed``, ``field``, ``readout``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from molecular_dynamics_tpu_torch.models.common import dense, dense_layers

Tensor = torch.Tensor


def lipswish(x: Tensor) -> Tensor:
    """0.909 x swish: a Lipschitz-1 activation."""
    return 0.909 * F.silu(x)


class _LipMLP(nn.Module):
    def __init__(self, in_features: int, features: Sequence[int], generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.layers = dense_layers(features, in_features, generator, device, dtype)

    def forward(self, x: Tensor) -> Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = lipswish(x)
        return x


def _cat_time(t, x: Tensor, cond: Optional[Tensor], cond_dim: int) -> Tensor:
    """``[t, x, cond]`` along the features, ``t`` and ``cond`` broadcast to
    ``x``'s leading axes."""
    lead = x.shape[:-1]
    parts = [torch.as_tensor(t, dtype=x.dtype, device=x.device).expand(lead + (1,)), x]
    if cond_dim:
        parts.append(torch.broadcast_to(cond.to(x.dtype), lead + (cond_dim,)))
    return torch.cat(parts, dim=-1)


class SDEGenerator(nn.Module):
    """Latent Stratonovich SDE ``dX = mu(t, X) dt + sigma(t, X) o dW`` with a
    linear readout: ``forward(ts, z0, dw, cond) -> (B, len(ts), data_dim)``.
    ``cond_dim > 0`` conditions the initial-state net and every drift and
    diffusion evaluation on a per-path context vector."""

    def __init__(self, data_dim: int, latent_dim: int = 32, noise_dim: int = 8,
                 hidden: Sequence[int] = (64, 64), init_noise_dim: int = 16, cond_dim: int = 0,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.data_dim, self.latent_dim, self.noise_dim = data_dim, latent_dim, noise_dim
        self.init_noise_dim, self.cond_dim = init_noise_dim, cond_dim
        kw = dict(generator=generator, device=device, dtype=dtype)
        field_in = 1 + latent_dim + cond_dim
        self.initial = _LipMLP(init_noise_dim + cond_dim, (64, latent_dim), **kw)
        self.drift = _LipMLP(field_in, tuple(hidden) + (latent_dim,), **kw)
        self.diffusion = _LipMLP(field_in, tuple(hidden) + (latent_dim * noise_dim,), **kw)
        self.readout = dense(latent_dim, data_dim, **kw)

    def _mu(self, t, x: Tensor, cond: Optional[Tensor]) -> Tensor:
        return self.drift(_cat_time(t, x, cond, self.cond_dim))

    def _sigma(self, t, x: Tensor, cond: Optional[Tensor]) -> Tensor:
        out = self.diffusion(_cat_time(t, x, cond, self.cond_dim))
        return out.reshape(x.shape[:-1] + (self.latent_dim, self.noise_dim))

    def forward(self, ts: Tensor, z0: Tensor, dw: Tensor, cond: Optional[Tensor] = None) -> Tensor:
        dtype = self.readout.weight.dtype
        z0, dw, ts = z0.to(dtype), dw.to(dtype), ts.to(dtype)
        if self.cond_dim:
            z0 = torch.cat([z0, torch.broadcast_to(cond.to(dtype), (len(z0), self.cond_dim))],
                           dim=-1)
        y = y_hat = self.initial(z0)
        t, ys = ts[0], [y]
        for dt, dw_n in zip(torch.diff(ts), dw):
            # reversible Heun (Kidger et al. 2021), Stratonovich
            f_hat = self._mu(t, y_hat, cond)
            gw_hat = torch.einsum("bln,bn->bl", self._sigma(t, y_hat, cond), dw_n)
            y_hat_next = 2.0 * y - y_hat + f_hat * dt + gw_hat
            t = t + dt
            f_next = self._mu(t, y_hat_next, cond)
            gw_next = torch.einsum("bln,bn->bl", self._sigma(t, y_hat_next, cond), dw_n)
            y = y + 0.5 * ((f_hat + f_next) * dt + gw_hat + gw_next)
            y_hat = y_hat_next
            ys.append(y)
        return self.readout(torch.stack(ys, dim=1))  # (B, T, data)


class CDEDiscriminator(nn.Module):
    """Neural CDE critic: ``forward(paths (B, T, data_dim), ts, cond) ->
    (B,)`` integrates ``dH = f(H) dY`` along the time-augmented path with a
    Heun update per increment and reads out one score. The context enters
    the initial hidden state only (the CDE sees only ``dY``, so a constant
    channel would be invisible to it)."""

    def __init__(self, data_dim: int, hidden_dim: int = 32, f_hidden: Sequence[int] = (64,),
                 cond_dim: int = 0, generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.data_dim, self.hidden_dim, self.cond_dim = data_dim, hidden_dim, cond_dim
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.embed = dense(data_dim + 1 + cond_dim, hidden_dim, **kw)
        self.field = _LipMLP(hidden_dim, tuple(f_hidden) + (hidden_dim * (data_dim + 1),), **kw)
        self.readout = dense(hidden_dim, 1, **kw)

    def forward(self, paths: Tensor, ts: Tensor, cond: Optional[Tensor] = None) -> Tensor:
        b, t, d = paths.shape
        dtype = self.readout.weight.dtype
        paths = paths.to(dtype)
        y = torch.cat([ts.to(dtype)[None, :, None].expand(b, t, 1), paths], dim=-1)
        h0_in = y[:, 0]
        if self.cond_dim:
            h0_in = torch.cat([h0_in, torch.broadcast_to(cond.to(dtype), (b, self.cond_dim))],
                              dim=-1)
        h = self.embed(h0_in)
        for dy in torch.diff(y, dim=1).unbind(1):
            f = self.field(h).reshape(b, self.hidden_dim, d + 1)
            # midpoint (Heun) update of the controlled ODE
            h_tilde = h + torch.einsum("bhc,bc->bh", f, dy)
            f2 = self.field(h_tilde).reshape(b, self.hidden_dim, d + 1)
            h = h + 0.5 * torch.einsum("bhc,bc->bh", f + f2, dy)
        return self.readout(h)[..., 0]
