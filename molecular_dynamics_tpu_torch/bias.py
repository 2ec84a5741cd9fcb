"""Bias potentials (steered-MD colvars) as first-class force hooks.

A bias is a dataclass of tensors with a differentiable ``energy(pos, step)``;
the composed integrators get the bias force through ``torch.autograd`` of the
total energy, and the campaign kernel evaluates the same force analytically.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from molecular_dynamics_tpu_torch.convert import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HarmonicSMDBias:
    """Moving harmonic restraint on the distance between two atom groups.

    ``E(t) = 0.5 * fk * (center(t) - |com2 - com1|)^2`` with ``center(t)``
    linearly interpolated from ``cent_0`` to ``cent_1`` over ``T`` steps and
    held at ``cent_1`` afterwards. Group membership is a weight vector of
    length N; centres are unweighted means over the group.
    """

    fk: Tensor
    cent_0: Tensor
    cent_1: Tensor
    T: Tensor
    group1_w: Tensor  # (N,) normalized membership weights
    group2_w: Tensor

    @classmethod
    def create(
        cls,
        n_atoms: int,
        group1: Sequence[int],
        group2: Sequence[int],
        fk: float = 1.0,
        cent_0: float = 12.0,
        cent_1: float = 34.0,
        T: float = 10000.0,
        dtype=torch.float32,
        device=None,
    ) -> "HarmonicSMDBias":
        device = resolve_device(device)

        def weights(group):
            w = torch.zeros(n_atoms, dtype=dtype, device=device)
            w[torch.as_tensor(list(group), dtype=torch.int64, device=device)] = 1.0
            return w / torch.sum(w)

        def scalar(v):
            return torch.tensor(float(v), dtype=dtype, device=device)

        return cls(
            fk=scalar(fk),
            cent_0=scalar(cent_0),
            cent_1=scalar(cent_1),
            T=scalar(T),
            group1_w=weights(group1),
            group2_w=weights(group2),
        )

    def center(self, step) -> Tensor:
        """Restraint centre at integration step ``step``: linear schedule,
        held at ``cent_1`` past ``T`` steps."""
        t = torch.as_tensor(step, device=self.cent_0.device).to(self.cent_0.dtype)
        t = torch.minimum(t, self.T)
        return (self.cent_1 - self.cent_0) / self.T * t + self.cent_0

    def colvar(self, pos: Tensor) -> Tensor:
        """Current collective variable value: inter-group distance.
        ``pos`` is ``(..., N, 3)``; the result has shape ``(...)``."""
        delta = torch.einsum("n,...nd->...d", self.group2_w - self.group1_w, pos)
        return torch.sqrt(torch.sum(delta * delta, dim=-1) + 1e-12)

    def energy(self, pos: Tensor, step) -> Tensor:
        dist = self.colvar(pos)
        return 0.5 * self.fk * (self.center(step) - dist) ** 2


def end_to_end_distance(pos: Tensor, i: int = 0, j: int = -1) -> Tensor:
    """Distance between two atoms of each frame in ``(..., N, 3)``."""
    delta = pos[..., j, :] - pos[..., i, :]
    return torch.sqrt(torch.sum(delta * delta, dim=-1))
