"""Integrators, thermostats, initial conditions and minimizers.

Every step is a ``MDState -> MDState`` function built around a caller-
supplied force function ``(pos, box) -> forces``. States and masses may
carry a leading replica axis: ``pos`` ``(..., N, 3)``, ``masses`` ``(N,)``.

Thermostat noise is explicit: a step takes either the ``noise`` tensor
itself (standard normals shaped like ``vel``) or a ``torch.Generator`` to
draw it from. With neither, the generator is seeded from the state's own
``(key, step)``, which reads two scalars back from the device.

Units: dt in femtoseconds at the API (converted internally by TIMEFACTOR),
gamma in 1/ps, temperatures in Kelvin; see ``units``.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from molecular_dynamics_tpu_torch import units
from molecular_dynamics_tpu_torch.system import MDState

Tensor = torch.Tensor
ForceFn = Callable[[Tensor, Tensor], Tensor]  # (pos, box) -> forces

_MASK63 = (1 << 63) - 1


def mix_seed(key: int, step: int) -> int:
    """One 63-bit stream seed from a state's thermostat seed and step
    counter (splitmix64 finalizer), so that two segments of one run, or two
    runs with different seeds, never share a stream."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(step) + 0x632BE59BD9B4E019) % (1 << 64)
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) % (1 << 64)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) % (1 << 64)
    return (z ^ (z >> 31)) & _MASK63


def state_generator(state: MDState) -> torch.Generator:
    """A generator on the state's device seeded from its first replica's
    ``(key, step)`` (one device read-back)."""
    gen = torch.Generator(device=state.pos.device)
    gen.manual_seed(
        mix_seed(int(state.key.reshape(-1)[0]), int(state.step.reshape(-1)[0]))
    )
    return gen


def _normal_like(
    state: MDState, template: Tensor,
    noise: Optional[Tensor], generator: Optional[torch.Generator],
) -> Tensor:
    if noise is not None:
        return noise.to(dtype=template.dtype, device=template.device)
    if generator is None:
        generator = state_generator(state)
    return torch.randn(
        template.shape, generator=generator,
        dtype=template.dtype, device=template.device,
    )


# ---------------------------------------------------------------------------
# kinetic quantities and initial conditions
# ---------------------------------------------------------------------------


def kinetic_energy(vel: Tensor, masses: Tensor) -> Tensor:
    """0.5 * sum(m v^2) in kcal/mol (velocities in internal units)."""
    return 0.5 * torch.sum(masses[..., :, None] * vel * vel, dim=(-2, -1))


def temperature(ekin: Tensor, n_atoms: int) -> Tensor:
    """Instantaneous temperature from kinetic energy (3N degrees of freedom)."""
    return 2.0 * ekin / (3.0 * n_atoms * units.BOLTZMANN)


def maxwell_boltzmann(generator: torch.Generator, masses: Tensor, T: float) -> Tensor:
    """Sample velocities from the Maxwell-Boltzmann distribution at T.
    ``generator`` must live on the device of ``masses``."""
    std = torch.sqrt(units.BOLTZMANN * T / masses)[:, None]
    return std * torch.randn(
        masses.shape + (3,), generator=generator,
        dtype=masses.dtype, device=masses.device,
    )


# ---------------------------------------------------------------------------
# integrator steps
# ---------------------------------------------------------------------------


def velocity_verlet_step(
    state: MDState, force_fn: ForceFn, masses: Tensor, dt_fs: float
) -> MDState:
    """One NVE velocity-Verlet step.

    ``state.forces`` must hold the forces at ``state.pos`` (seed with
    :func:`initialize_forces`); they are reused so each step costs exactly
    one force evaluation.
    """
    dt = dt_fs / units.TIMEFACTOR
    m = masses[:, None]
    vel_half = state.vel + 0.5 * dt * state.forces / m
    pos = state.pos + dt * vel_half
    forces = force_fn(pos, state.box)
    vel = vel_half + 0.5 * dt * forces / m
    return state.replace(pos=pos, vel=vel, forces=forces, step=state.step + 1)


def langevin_step(
    state: MDState,
    force_fn: ForceFn,
    masses: Tensor,
    dt_fs: float,
    T: float,
    gamma_ps: float = 1.0,
    noise: Optional[Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> MDState:
    """One BAOAB Langevin (NVT) step; one force evaluation per step."""
    dt = dt_fs / units.TIMEFACTOR
    gamma = gamma_ps * (units.TIMEFACTOR / 1000.0)  # 1/ps -> 1/internal-time
    m = masses[:, None]

    # B: half kick with stored forces
    vel = state.vel + 0.5 * dt * state.forces / m
    # A: half drift
    pos = state.pos + 0.5 * dt * vel
    # O: Ornstein-Uhlenbeck exact solve
    c1 = math.exp(-gamma * dt)
    vel = c1 * vel
    if T > 0.0:
        c2 = torch.sqrt(units.BOLTZMANN * T / m * (1.0 - c1 * c1))
        vel = vel + c2 * _normal_like(state, vel, noise, generator)
    # A: half drift
    pos = pos + 0.5 * dt * vel
    # B: half kick with new forces
    forces = force_fn(pos, state.box)
    vel = vel + 0.5 * dt * forces / m
    return state.replace(pos=pos, vel=vel, forces=forces, step=state.step + 1)


def initialize_forces(state: MDState, force_fn: ForceFn) -> MDState:
    """Seed ``state.forces`` with the forces at the current positions."""
    return state.replace(forces=force_fn(state.pos, state.box).detach())


# ---------------------------------------------------------------------------
# minimization
# ---------------------------------------------------------------------------


def minimize_fire(
    pos: Tensor,
    force_fn: Callable[[Tensor], Tensor],
    n_steps: int = 500,
    dt_start: float = 0.02,
    dt_max: float = 0.2,
    n_min: int = 5,
    f_inc: float = 1.1,
    f_dec: float = 0.5,
    alpha_start: float = 0.1,
    f_alpha: float = 0.99,
    max_disp: float = 0.0,
) -> Tensor:
    """FIRE structure minimization of one system ``(N, 3)``.

    The branch state (``dt``, ``alpha``, the downhill-step count) lives in
    0-dim tensors on the device and every branch is a ``torch.where``, so
    the loop never waits for the device.

    ``max_disp > 0`` clamps each step's per-component displacement (a trust
    region): required when the start is far from physical, where |F| can
    reach 1e6 and one unclamped step throws atoms thousands of Angstrom.
    """
    pos = pos.detach()
    vel = torch.zeros_like(pos)
    dt = torch.tensor(dt_start, dtype=pos.dtype, device=pos.device)
    alpha = torch.tensor(alpha_start, dtype=pos.dtype, device=pos.device)
    n_pos = torch.zeros((), dtype=torch.int64, device=pos.device)
    dt_cap = torch.tensor(dt_max, dtype=pos.dtype, device=pos.device)
    alpha_reset = torch.tensor(alpha_start, dtype=pos.dtype, device=pos.device)

    for _ in range(n_steps):
        f = force_fn(pos).detach()
        power = torch.sum(f * vel)
        f_norm = torch.sqrt(torch.sum(f * f)) + 1e-12
        v_norm = torch.sqrt(torch.sum(vel * vel))
        vel = (1.0 - alpha) * vel + alpha * f / f_norm * v_norm

        uphill = power <= 0.0
        n_pos = torch.where(uphill, torch.zeros_like(n_pos), n_pos + 1)
        grow = (~uphill) & (n_pos > n_min)
        dt = torch.where(grow, torch.minimum(dt * f_inc, dt_cap), dt)
        alpha = torch.where(grow, alpha * f_alpha, alpha)
        dt = torch.where(uphill, dt * f_dec, dt)
        alpha = torch.where(uphill, alpha_reset, alpha)
        vel = torch.where(uphill, torch.zeros_like(vel), vel)

        vel = vel + dt * f
        disp = dt * vel
        if max_disp > 0.0:
            disp = torch.clamp(disp, -max_disp, max_disp)
        pos = pos + disp
    return pos
