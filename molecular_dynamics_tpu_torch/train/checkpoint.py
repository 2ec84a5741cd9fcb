"""Checkpoint/resume for models, optimizers and MD states.

Best-loss checkpoints, staged pretrain -> GAN weight reuse, periodic
saves and job-chain resume. A target is a module (its ``state_dict``), an
optimizer (its ``state_dict``), a dataclass of tensors such as ``MDState``
(its fields), or a dict, list or tuple of these; ``save`` writes it as a
tree of plain containers and tensors with ``torch.save``, and ``load``
reads that tree with ``weights_only=True`` (no pickled code) and restores
it into a template of the same structure.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch


def _has_state_dict(x) -> bool:
    """A module, an optimizer or ``train.common.ClippedAdam``."""
    return hasattr(x, "state_dict") and hasattr(x, "load_state_dict")


def _tree(target: Any):
    if _has_state_dict(target):
        return target.state_dict()
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        return {f.name: _tree(getattr(target, f.name)) for f in dataclasses.fields(target)}
    if isinstance(target, dict):
        return {k: _tree(v) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return [_tree(v) for v in target]
    if isinstance(target, torch.Tensor):
        return target.detach().cpu()
    return target


def _restore(template: Any, tree: Any):
    if _has_state_dict(template):
        template.load_state_dict(tree)
        return template
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _restore(getattr(template, f.name), tree[f.name])
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _restore(v, tree[k]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_restore(a, b) for a, b in zip(template, tree))
    if isinstance(template, torch.Tensor):
        return tree.to(device=template.device, dtype=template.dtype)
    return tree


def save(path: str, target: Any) -> None:
    """Write a module / optimizer / MDState / dict of them to ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(_tree(target), path)


def load(path: str, template: Any) -> Any:
    """Restore ``path`` into the structure of ``template``: a module or an
    optimizer is loaded in place and returned, a dataclass comes back as a
    new instance, tensors on the template's device and dtype."""
    return _restore(template, torch.load(path, map_location="cpu", weights_only=True))


class BestKeeper:
    """Keep the best-loss checkpoint on disk."""

    def __init__(self, path: str):
        self.path = path
        self.best = float("inf")

    def update(self, loss: float, target: Any) -> bool:
        if loss < self.best:
            self.best = loss
            save(self.path, target)
            return True
        return False

    def rebase(self) -> None:
        """Reset the best-loss floor at a training-phase boundary.

        Multi-phase drivers (pretrain -> GAN) optimize incommensurable
        losses; without a rebase the later phase can never beat the earlier
        phase's numerically smaller loss and ``best.ckpt`` keeps the
        pre-phase model.
        """
        self.best = float("inf")


class PeriodicSaver:
    """Save every N steps + keep a rolling 'latest' for crash resume."""

    def __init__(self, path: str, every: int = 1000):
        self.path = path
        self.every = every

    def maybe_save(self, step: int, target: Any) -> bool:
        if step % self.every == 0:
            save(self.path, target)
            return True
        return False


def resume_or_init(path: str, template: Any) -> tuple:
    """(target, resumed): restore if a checkpoint exists, else the template."""
    if os.path.exists(path):
        return load(path, template), True
    return template, False
