"""Shared optimizer: Adam with global-norm clipping, as optax chains them
(the reference's ``make_state`` and the trainers' optimizers).

``torch.optim.Adam`` computes optax's ``adam`` (the same moments, bias
corrections and epsilon outside the square root) in exact arithmetic. The
clip is optax's ``clip_by_global_norm``: a gradient whose global norm
exceeds ``max_norm`` is scaled by ``max_norm / norm``
(``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead).
"""

from __future__ import annotations

from typing import List, Sequence

import torch


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm`` on a list of gradients. The choice is
    a ``torch.where`` on the device: no host synchronisation."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    return [torch.where(norm < max_norm, g, g / norm * max_norm) for g in grads]


class ClippedAdam:
    """Adam over ``params`` with global-norm clipping of each update's
    gradients (every caller clips, as the reference's trainers do).
    ``step(grads)`` takes the gradients explicitly (as ``torch.autograd.grad``
    returns them), so two optimizers over the same parameters keep separate
    moments and never read each other's ``.grad``."""

    def __init__(self, params, lr: float = 1e-4, clip_norm: float = 1.0):
        self.params = list(params)
        self.clip_norm = clip_norm
        self.adam = torch.optim.Adam(self.params, lr=lr)

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        grads = clip_by_global_norm(grads, self.clip_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.adam.step()
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return self.adam.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state)


def descend(opt: ClippedAdam, loss: torch.Tensor) -> None:
    """One update of ``opt``'s parameters down the gradient of ``loss``. A
    parameter the loss does not reach gets a zero gradient, as in JAX (an
    HNN's loss reads the input gradient of its fields, which the last
    layer's bias does not move)."""
    opt.step(torch.autograd.grad(loss, opt.params, materialize_grads=True))


def stepper(opt: ClippedAdam, loss_fn):
    """``step(*batch)``: one ``descend`` of ``opt`` down ``loss_fn(*batch)``,
    returning the loss (a 0-dim tensor on the device, no host sync)."""
    def step(*batch):
        loss = loss_fn(*batch)
        descend(opt, loss)
        return loss.detach()
    return step
