"""Shared optimizers: Adam with global-norm clipping, as optax chains them
(the reference's ``make_state`` and the trainers' optimizers), the same
Adam without the clip, and optax's Adadelta.

``torch.optim.Adam`` computes optax's ``adam`` (the same moments, bias
corrections and epsilon outside the square root) in exact arithmetic. The
clip is optax's ``clip_by_global_norm``: a gradient whose global norm
exceeds ``max_norm`` is scaled by ``max_norm / norm``
(``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead), so
a ``max_norm`` of 0 zeroes every update, as in optax.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import torch


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm`` on a list of gradients. The choice is
    a ``torch.where`` on the device: no host synchronisation."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    return [torch.where(norm < max_norm, g, g / norm * max_norm) for g in grads]


class ClippedAdam:
    """Adam over ``params`` with global-norm clipping of each update's
    gradients, or, with ``clip_norm=None``, bare Adam (optax's ``adam``
    alone, the SDE-GAN trainer's ``adam=True``). ``step(grads)`` takes the
    gradients explicitly (as ``torch.autograd.grad`` returns them), so two
    optimizers over the same parameters keep separate moments and never read
    each other's ``.grad``. ``backward=True`` is for the parameters of a
    ``DistributedDataParallel`` module, whose gradients only
    ``loss.backward()`` all-reduces: ``descend`` then takes them from
    ``.grad``."""

    def __init__(self, params, lr: float = 1e-4, clip_norm: Optional[float] = 1.0,
                 backward: bool = False):
        self.params = list(params)
        self.clip_norm = clip_norm
        self.backward = backward
        self.adam = torch.optim.Adam(self.params, lr=lr)

    def step(self, grads: Sequence[torch.Tensor]) -> None:
        if self.clip_norm is not None:
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


class Adadelta:
    """optax's ``adadelta(lr, rho, eps, weight_decay)``: the decayed weights
    added to the gradient, then ``scale_by_adadelta`` (the running mean of
    squared gradients ``e_g``, the update ``sqrt(e_x + eps) / sqrt(e_g +
    eps) * g``, the running mean of squared updates ``e_x``), scaled by
    ``-lr``. The same ``step(grads)`` interface as ``ClippedAdam``."""

    def __init__(self, params, lr: float, rho: float = 0.9, eps: float = 1e-6,
                 weight_decay: float = 0.0):
        self.params = list(params)
        self.lr, self.rho, self.eps, self.weight_decay = lr, rho, eps, weight_decay
        self.e_g = [torch.zeros_like(p) for p in self.params]
        self.e_x = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        rho, eps = self.rho, self.eps
        for p, g, e_g, e_x in zip(self.params, grads, self.e_g, self.e_x):
            g = g + self.weight_decay * p
            e_g.copy_((1 - rho) * g ** 2 + rho * e_g)
            delta = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
            e_x.copy_((1 - rho) * delta ** 2 + rho * e_x)
            p.sub_(self.lr * delta)


def descend(opt: ClippedAdam, loss: torch.Tensor) -> None:
    """One update of ``opt``'s parameters down the gradient of ``loss``. A
    parameter the loss does not reach gets a zero gradient, as in JAX (an
    HNN's loss reads the input gradient of its fields, which the last
    layer's bias does not move). An optimizer built with ``backward=True``
    takes the gradients ``loss.backward()`` leaves, all-reduced over the
    ranks of a data-parallel run, and clips them after the reduction."""
    if getattr(opt, "backward", False):
        loss.backward()
        opt.step([torch.zeros_like(p) if p.grad is None else p.grad for p in opt.params])
        return
    opt.step(torch.autograd.grad(loss, opt.params, materialize_grads=True))


def is_data_parallel(module) -> bool:
    """Whether ``module`` is a ``DistributedDataParallel`` wrapper (without
    importing that module, which takes seconds, where nothing has)."""
    ddp = sys.modules.get("torch.nn.parallel.distributed")
    return ddp is not None and isinstance(module, ddp.DistributedDataParallel)


def stepper(opt: ClippedAdam, loss_fn):
    """``step(*batch)``: one ``descend`` of ``opt`` down ``loss_fn(*batch)``,
    returning the loss (a 0-dim tensor on the device, no host sync)."""
    def step(*batch):
        loss = loss_fn(*batch)
        descend(opt, loss)
        return loss.detach()
    return step
