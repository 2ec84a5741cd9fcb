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


def minimize_lbfgs(
    pos: Tensor,
    energy_fn: Callable[[Tensor], Tensor],
    n_steps: int = 100,
    history: int = 10,
    c1: float = 1e-4,
    max_ls: int = 20,
    curvature_eps: float = 1e-10,
) -> Tensor:
    """L-BFGS structure minimization of one system.

    The JAX package's algorithm: the limited-memory two-loop recursion over
    a fixed ``history``-slot circular buffer, an Armijo backtracking line
    search (step halved up to ``max_ls`` times; a NaN energy keeps
    halving), steepest descent where the direction is not downhill, a step
    rejected when no trial lowered the energy, and a pair (s, y) kept only
    where ``s.y > curvature_eps``. ``energy_fn`` maps positions (same shape
    as ``pos``) to a scalar; its gradient comes from autograd.

    The branches read the energies back to the host, one read a line-search
    trial: this is a set-up step, not a per-step path of a campaign.
    """
    shape = pos.shape
    m = history

    def val_grad(x):
        x = x.detach().requires_grad_(True)
        e = energy_fn(x.reshape(shape))
        (g,) = torch.autograd.grad(e, x)
        return float(e.detach()), g.detach()

    x = pos.detach().reshape(-1)
    s_buf = torch.zeros((m,) + x.shape, dtype=x.dtype, device=x.device)
    y_buf = torch.zeros_like(s_buf)
    rho = [0.0] * m
    k = 0  # pairs kept so far; the newest sits in slot (k - 1) % m
    e, g = val_grad(x)

    for _ in range(n_steps):
        # two-loop recursion: d = -H_k g over the kept pairs, newest first
        kept = [(k - 1 - i) % m for i in range(min(k, m))]
        q = g
        alphas = []
        for j in kept:
            a = rho[j] * float(torch.dot(s_buf[j], q))
            q = q - a * y_buf[j]
            alphas.append(a)
        gamma = 1.0
        if k > 0:
            jm = (k - 1) % m
            yy = float(torch.dot(y_buf[jm], y_buf[jm]))
            if yy > 1e-12:
                gamma = float(torch.dot(s_buf[jm], y_buf[jm])) / yy
        r = gamma * q
        for j, a in reversed(list(zip(kept, alphas))):
            b = rho[j] * float(torch.dot(y_buf[j], r))
            r = r + (a - b) * s_buf[j]
        d = -r
        gd = float(torch.dot(g, d))
        if gd >= 0.0:  # not downhill: steepest descent
            d = -g
            gd = -float(torch.dot(g, g))

        alpha, n_ls = 1.0, 1
        e_new, g_new = val_grad(x + d)
        while not (e_new <= e + c1 * alpha * gd) and n_ls < max_ls:
            alpha *= 0.5
            e_new, g_new = val_grad(x + alpha * d)
            n_ls += 1
        if not e_new <= e:  # no trial lowered the energy: stay
            continue
        x_new = x + alpha * d
        s = x_new - x
        y = g_new - g
        sy = float(torch.dot(s, y))
        x, e, g = x_new, e_new, g_new
        if sy > curvature_eps:
            slot = k % m
            s_buf[slot] = s
            y_buf[slot] = y
            rho[slot] = 1.0 / max(sy, curvature_eps)
            k += 1
    return x.reshape(shape)


def minimize_gd(
    pos: Tensor,
    force_fn: Callable[[Tensor], Tensor],
    n_steps: int = 200,
    lr: float = 1e-4,
    max_disp: float = 0.1,
) -> Tensor:
    """Clipped steepest-descent relaxation (robust for very bad contacts):
    each atom moves ``lr`` times its force, at most ``max_disp`` A a step."""
    pos = pos.detach()
    for _ in range(n_steps):
        step = lr * force_fn(pos).detach()
        norm = torch.sqrt(torch.sum(step * step, dim=-1, keepdim=True))
        pos = pos + step * torch.clamp(max_disp / (norm + 1e-12), max=1.0)
    return pos
