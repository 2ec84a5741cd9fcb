"""MD simulation state.

``MDState`` is a frozen dataclass of tensors; integrator steps are
``state -> state`` functions that return a new state. A replica ensemble is
the same dataclass with a leading replica axis on every field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from molecular_dynamics_tpu_torch.convert import resolve_device


@dataclasses.dataclass(frozen=True)
class MDState:
    """State of one system (or, with a leading axis, a replica ensemble).

    - ``pos``/``vel``/``forces``: (N, 3) in Angstrom / Angstrom per AKMA time
      / kcal/mol/Angstrom
    - ``box``: (3,) rectangular box diagonal; zeros mean vacuum
    - ``key``: int64 thermostat seed (one per replica in an ensemble). The
      noise of a step is a function of (seed, step), so the seed itself never
      changes as the state advances.
    - ``step``: int64 step counter (drives time-dependent biases)
    """

    pos: torch.Tensor
    vel: torch.Tensor
    forces: torch.Tensor
    box: torch.Tensor
    key: torch.Tensor
    step: torch.Tensor

    @property
    def n_atoms(self) -> int:
        return self.pos.shape[-2]

    def replace(self, **changes) -> "MDState":
        return dataclasses.replace(self, **changes)


def system_init(
    pos,
    *,
    vel=None,
    box=None,
    key: int = 0,
    dtype=torch.float32,
    device=None,
) -> MDState:
    """Create an :class:`MDState` from positions (velocities default to 0)."""
    device = resolve_device(device)
    pos = torch.as_tensor(pos).to(device=device, dtype=dtype)
    vel = (
        torch.zeros_like(pos) if vel is None
        else torch.as_tensor(vel).to(device=device, dtype=dtype)
    )
    box = (
        torch.zeros(3, device=device, dtype=dtype) if box is None
        else torch.as_tensor(box).to(device=device, dtype=dtype)
    )
    return MDState(
        pos=pos,
        vel=vel,
        forces=torch.zeros_like(pos),
        box=box,
        key=torch.tensor(int(key), dtype=torch.int64, device=device),
        step=torch.zeros((), dtype=torch.int64, device=device),
    )


def wrap_positions(
    pos: torch.Tensor, box: torch.Tensor, center: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Wrap coordinates back into the primary box for visualisation.
    No-op on zero-box (vacuum) axes."""
    box = torch.as_tensor(box, dtype=pos.dtype, device=pos.device)
    if center is None:
        center = torch.mean(pos, dim=-2, keepdim=True)
    safe = torch.where(box > 0, box, torch.ones_like(box))
    shift = safe * torch.round((pos - center) / safe)
    return torch.where(box > 0, pos - shift, pos)


def replicate(state: MDState, n_replicas: int, seed: int = 0) -> MDState:
    """Broadcast a single-system state to a replica ensemble.

    Every replica gets its own thermostat seed, drawn from a generator
    seeded with ``seed``, so thermostat noise decorrelates the ensemble.
    """
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    keys = torch.randint(
        0, 2**62, (n_replicas,), generator=gen, dtype=torch.int64
    ).to(state.pos.device)

    def tile(x):
        return x.expand((n_replicas,) + tuple(x.shape)).clone()

    return MDState(
        pos=tile(state.pos),
        vel=tile(state.vel),
        forces=tile(state.forces),
        box=tile(state.box),
        key=keys,
        step=tile(state.step),
    )
