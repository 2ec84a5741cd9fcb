"""Physics correctors for generated frames (the rollout correctors of the
sequence-model module; the window trainers come with the sequence line,
ROADMAP A12).

A corrector relaxes each generated frame of a rollout through the
differentiable force field before it is fed back: a few FIRE steps
(``make_frame_corrector``) or a short thermostatted Langevin burst
(``make_langevin_corrector``), optionally holding the frame's own
end-to-end distance with a harmonic pin. Each works on the rollout's
representation (whitened flat features ``(..., 3N)``: it unwhitens,
relaxes each frame, re-whitens) and falls back to the uncorrected frame
where the relaxation is not finite. ``corrector_from_env`` reads the
``MDX_ROLLOUT_CORRECT`` recipe (``<mode>:<n>[:pin[<fk>]]``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from molecular_dynamics_tpu_torch import units
from molecular_dynamics_tpu_torch.energy import REFERENCE_CONFIG, _neg_grad, total_energy
from molecular_dynamics_tpu_torch.integrate import minimize_fire, mix_seed

Tensor = torch.Tensor

#: the Langevin corrector's stream: each frame's generator is seeded from
#: this and the bits of the frame's float32 sum
LANGEVIN_SEED = 20260819


def _pinned_energy(ff, cfg, pin_groups, pin_fk):
    """``energy(q, d0)``: the potential, plus ``0.5 fk (d - d0)^2`` on the
    distance between ``pin_groups`` when given."""
    if pin_groups is None:
        return lambda q, _d0: total_energy(q, ff, config=cfg)
    gi, gj = int(pin_groups[0]), int(pin_groups[1])

    def energy(q, d0):
        d = torch.sqrt(torch.sum((q[gj] - q[gi]) ** 2) + 1e-12)
        return total_energy(q, ff, config=cfg) + 0.5 * pin_fk * (d - d0) ** 2

    return energy


def _pin_distance(pos: Tensor, pin_groups) -> Tensor:
    if pin_groups is None:
        return torch.zeros((), dtype=pos.dtype, device=pos.device)
    gi, gj = int(pin_groups[0]), int(pin_groups[1])
    return torch.sqrt(torch.sum((pos[gj] - pos[gi]) ** 2) + 1e-12)


def _clamped_force(energy, d0):
    """-dE/dq, NaN -> 0 and saturated at +-1e4: a clash frame's LJ force can
    overflow float32, and FIRE's f/|f| mixing would turn the frame NaN."""
    def force(p):
        f = _neg_grad(lambda q: energy(q, d0), p)
        return torch.clamp(torch.nan_to_num(f, nan=0.0, posinf=1e4, neginf=-1e4), -1e4, 1e4)
    return force


def _per_frame(correct_one, w_mean, w_std, n_atoms):
    """Lift a one-frame corrector on coordinates ``(N, 3)`` to whitened
    flat features ``(..., 3N)``, frame by frame."""
    mean32 = np.asarray(w_mean, np.float32)
    std32 = np.asarray(w_std, np.float32)

    def correct(flat: Tensor) -> Tensor:
        mean = torch.as_tensor(mean32, device=flat.device).to(flat.dtype)
        std = torch.as_tensor(std32, device=flat.device).to(flat.dtype)
        rows = flat.detach().reshape(-1, flat.shape[-1])
        out = []
        for row in rows:
            pos = (row * std + mean).reshape(n_atoms, 3)
            relaxed = correct_one(pos, row)
            relaxed = torch.where(torch.isfinite(relaxed).all(), relaxed, pos)
            out.append((relaxed.reshape(-1) - mean) / std)
        return torch.stack(out).reshape(flat.shape)

    return correct


def make_frame_corrector(
    ff, w_mean, w_std, n_steps: int = 8,
    dt_start: float = 1e-3, dt_max: float = 5e-3, energy_config=None,
    pin_groups=None, pin_fk: float = 50.0,
):
    """FIRE corrector: ``n_steps`` of FIRE on each frame with a trust region
    of 0.05 A a component a step (generated frames can carry clashes with
    |F| ~ 1e6). ``pin_groups=(i, j)`` holds the i-j distance at the incoming
    frame's own value with a harmonic restraint of ``pin_fk``
    kcal/mol/A^2: restrained minimisation along the SMD reaction
    coordinate. Returns ``(..., 3N) -> (..., 3N)``."""
    energy = _pinned_energy(ff, energy_config or REFERENCE_CONFIG, pin_groups, pin_fk)

    def relax(pos, _row):
        force = _clamped_force(energy, _pin_distance(pos, pin_groups))
        return minimize_fire(pos, force, n_steps=n_steps, dt_start=dt_start, dt_max=dt_max,
                             max_disp=0.05)

    return _per_frame(relax, w_mean, w_std, ff.n_atoms)


def make_langevin_corrector(
    ff, w_mean, w_std, n_steps: int = 10, dt_fs: float = 1.0,
    temperature: float = 300.0, gamma_ps: float = 20.0,
    energy_config=None, pin_groups=None, pin_fk: float = 50.0,
    max_disp: float = 0.05,
):
    """Thermostatted corrector: ``n_steps`` BAOAB Langevin steps at
    ``temperature`` instead of a minimisation, which keeps the frame on the
    thermal manifold the model was trained on. Velocities and noise come
    from a ``torch.Generator`` seeded from the frame's bits (the rollout
    gives the corrector no generator; a content-derived seed keeps the map
    deterministic per frame). Same pin and trust region (``max_disp`` A a
    component a step) as the FIRE corrector."""
    energy = _pinned_energy(ff, energy_config or REFERENCE_CONFIG, pin_groups, pin_fk)
    dt = dt_fs / units.TIMEFACTOR
    gamma = gamma_ps * (units.TIMEFACTOR / 1000.0)
    c1 = float(np.exp(-gamma * dt))

    def burst(pos0, row):
        m = ff.masses.to(device=pos0.device, dtype=pos0.dtype)[:, None]
        c2 = torch.sqrt(units.BOLTZMANN * temperature / m * (1.0 - c1 * c1))
        v_sigma = torch.sqrt(units.BOLTZMANN * temperature / m)
        force = _clamped_force(energy, _pin_distance(pos0, pin_groups))
        bits = int(np.float32(row.sum(dtype=torch.float32).item()).view(np.int32))
        gen = torch.Generator(device=pos0.device)
        gen.manual_seed(mix_seed(LANGEVIN_SEED, bits))

        def normal():
            return torch.randn(pos0.shape, generator=gen, device=pos0.device, dtype=pos0.dtype)

        pos, vel, f = pos0, v_sigma * normal(), force(pos0)
        for _ in range(n_steps):
            v1 = vel + 0.5 * dt * f / m
            p1 = pos + 0.5 * dt * v1
            v1 = c1 * v1 + c2 * normal()
            p2 = p1 + 0.5 * dt * v1
            p2 = pos + torch.clamp(p2 - pos, -max_disp, max_disp)  # the step's trust region
            f = force(p2)
            pos, vel = p2, v1 + 0.5 * dt * f / m
        return pos

    return _per_frame(burst, w_mean, w_std, ff.n_atoms)


def corrector_from_env(ff, w_mean, w_std, env="MDX_ROLLOUT_CORRECT"):
    """A frame corrector from the recipe environment knob, or None (unset:
    the committed backbone recipes run uncorrected).

    Format: ``<mode>:<n_steps>[:pin[<fk>]]`` with mode ``fire``
    (:func:`make_frame_corrector`) or ``langevin``
    (:func:`make_langevin_corrector`), e.g. ``fire:8``, ``fire:16:pin``,
    ``langevin:10:pin100``; ``pin`` holds each frame's end-to-end distance
    (first and last atom) with ``fk`` kcal/mol/A^2 (default 50)."""
    spec = os.environ.get(env, "")
    if not spec:
        return None
    return corrector_from_spec(ff, w_mean, w_std, spec, what=env)


def corrector_from_spec(ff, w_mean, w_std, spec: str, what: str = "spec"):
    """A frame corrector from a ``<mode>:<n>[:pin[<fk>]]`` string; ``"none"``
    or an empty spec gives None (the uncorrected rollout)."""
    if not spec or spec == "none":
        return None
    parts = spec.split(":")
    makers = {"fire": make_frame_corrector, "langevin": make_langevin_corrector}
    if parts[0] not in makers:
        raise ValueError(f"{what} mode must be 'fire' or 'langevin', got {parts[0]!r}")
    kwargs = {}
    if len(parts) > 2:
        if not parts[2].startswith("pin"):
            raise ValueError(f"{what} third field must be 'pin[<fk>]'")
        kwargs["pin_groups"] = (0, ff.n_atoms - 1)
        if parts[2][3:]:
            kwargs["pin_fk"] = float(parts[2][3:])
    return makers[parts[0]](ff, w_mean, w_std, n_steps=int(parts[1] or 8), **kwargs)
