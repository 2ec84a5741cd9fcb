"""Hamiltonian neural networks.

The network learns two scalar fields F1 (conservative) and F2
(Hamiltonian, solenoidal); the phase-space time derivative is

    dx/dt = grad(F1)            (conservative part)
          + J^T grad(F2)        (symplectic part)

with J the canonical symplectic map. The gradient with respect to the input
is ``torch.autograd.grad`` with ``create_graph=True``, so a loss on dx/dt
is differentiated once more with respect to the weights (second-order
autograd). Rows of a batch are independent, so the gradient of the fields
summed over the batch is each row's own gradient.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from molecular_dynamics_tpu_torch.models.common import MLP

Tensor = torch.Tensor

FIELD_TYPES = ("solenoidal", "conservative", "both")


class HNN(nn.Module):
    """Scalar-field network: x (..., 2n) -> (F1, F2), a tanh MLP with
    orthogonal kernels and a two-channel head. flax infers the input width;
    here it is ``in_dim``."""

    def __init__(
        self,
        in_dim: int,
        hidden: Sequence[int] = (200, 200, 200, 200, 200),
        field_type: str = "solenoidal",
        generator: Optional[torch.Generator] = None,
        device=None,
        dtype=torch.float32,
    ):
        super().__init__()
        if field_type not in FIELD_TYPES:
            raise ValueError(f"field_type must be one of {FIELD_TYPES}, got {field_type!r}")
        self.field_type = field_type
        self.mlp = MLP(in_dim, tuple(hidden) + (2,), activation=torch.tanh,
                       generator=generator, device=device, dtype=dtype,
                       use_orthogonal_init=True)

    def forward(self, x: Tensor) -> Tensor:
        return self.mlp(x)


def symplectic_apply(g: Tensor) -> Tensor:
    """J^T grad: (dH/dp, -dH/dq) for x = (q, p) split at the midpoint."""
    n = g.shape[-1] // 2
    return torch.cat([g[..., n:], -g[..., :n]], dim=-1)


def time_derivative(model: nn.Module, x: Tensor, create_graph: bool = True) -> Tensor:
    """Phase-space vector field dx/dt at x (batched over leading axes).

    ``model`` maps ``(B, D)`` rows to their ``(B, 2)`` fields and carries a
    ``field_type``. With ``create_graph`` (the default) the result stays
    differentiable with respect to the weights and to ``x``; without it
    (generation) it is a plain tensor. Runs under ``torch.enable_grad()``,
    so it also works inside a ``no_grad`` block.
    """
    flat = x.reshape(-1, x.shape[-1])
    conservative = model.field_type in ("conservative", "both")
    solenoidal = model.field_type in ("solenoidal", "both")
    with torch.enable_grad():
        if not flat.requires_grad:
            flat = flat.detach().requires_grad_(True)
        fields = model(flat)

        def grad_of(k, retain):
            (g,) = torch.autograd.grad(fields[:, k].sum(), flat, create_graph=create_graph,
                                       retain_graph=retain or create_graph)
            return g

        out = torch.zeros_like(flat)
        if conservative:
            out = out + grad_of(0, retain=solenoidal)
        if solenoidal:
            out = out + symplectic_apply(grad_of(1, retain=False))
    if not create_graph:
        out = out.detach()
    return out.reshape(x.shape)


def rollout(
    model: nn.Module,
    x0: Tensor,
    n_steps: int,
    dt: float = 0.005,
    noise_std: float = 0.0,
    generator: Optional[torch.Generator] = None,
    max_step: Optional[float] = None,
    corrector: Optional[Callable[[Tensor], Tensor]] = None,
) -> Tensor:
    """Autoregressive generation ``x += dx_hat * dt (+ noise)``; returns the
    ``(n_steps, ...)`` trajectory of states. ``x0`` may carry leading batch
    axes: each row is its own rollout. ``max_step`` clamps the per-step
    displacement componentwise; ``corrector`` relaxes each generated state
    (``train.seq.make_frame_corrector``); the noise is drawn from
    ``generator``. The state is detached between steps: a long rollout does
    not grow an autograd graph."""
    x = x0.detach()
    frames = []
    for _ in range(n_steps):
        d = time_derivative(model, x, create_graph=False) * dt
        if max_step is not None:
            d = torch.clamp(d, -max_step, max_step)
        x = x + d
        if corrector is not None:
            x = corrector(x)
        if noise_std > 0:
            x = x + noise_std * torch.randn(
                x.shape, generator=generator, device=x.device, dtype=x.dtype)
        frames.append(x)
    return torch.stack(frames)
