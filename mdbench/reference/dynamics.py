"""The reference integrator: the configuration's constrained BAOAB Langevin
step, with the thermostat's normals drawn as the stated noise stream.

The configuration states the integrator and its noise exactly, so that a
segment can be followed step for step from a state: g-BAOAB (half kick,
half drift, Ornstein-Uhlenbeck, half drift, force, half kick) with Jacobi
SHAKE sweeps after each drift along the bonds at the drift's start and
RATTLE sweeps after each kick and the O-step; the SMD centre of a step's new
force at the step's start index; the normals of step ``t`` of replica ``r``
Philox4x32-10 draws keyed on the segment's stream seed ``mix(key_0, t_0)``,
``(atom, r, t)``, through Box-Muller in float32; the r-RESPA cadences as a
held LCPO force (``sasa_every``) or GB impulses (``gb_every``).

Every tensor is ``(rows, N, 3)``; each row carries its own replica index,
stream seed and start step, so that rows of different segments run as one
batch.
"""

from __future__ import annotations

import math

import torch

from mdbench.reference import energy as E

Tensor = torch.Tensor
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
#: the potential's terms, as ``energy.potential_terms`` names them
_ALL_TERMS = ("bonds", "urey_bradley", "angles", "dihedrals", "impropers", "lj14", "elec14",
              "electrostatics", "lj", "gb", "sasa")


def mix_seed(key: int, step: int) -> int:
    """A segment's stream seed from the ensemble's first thermostat key and
    the segment's start step (the splitmix64 finaliser, 63 bits)."""
    z = (int(key) * 0x9E3779B97F4A7C15 + int(step) + 0x632BE59BD9B4E019) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def replica_keys(seed: int, n_replicas: int) -> Tensor:
    """The ensemble's thermostat keys for a run seed: uniform on [0, 2^62)
    from the CPU generator seeded with it."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    return torch.randint(0, 2**62, (n_replicas,), generator=gen, dtype=torch.int64)


def _philox(c0, c1, c2, c3, k0, k1):
    for _ in range(10):
        p0 = c0 * 0xD2511F53
        p1 = c2 * 0xCD9E8D57
        hi0, lo0 = (p0 >> 32) & _M32, p0 & _M32
        hi1, lo1 = (p1 >> 32) & _M32, p1 & _M32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + 0x9E3779B9) & _M32
        k1 = (k1 + 0xBB67AE85) & _M32
    return c0, c1, c2, c3


def normals(seeds: Tensor, replicas: Tensor, step: Tensor, n_atoms: int) -> Tensor:
    """Float32 standard normals ``(rows, N, 3)`` of one step: row ``k`` keyed
    on ``(seeds[k], replicas[k], step[k], atom)``."""
    dev = seeds.device
    atom = torch.arange(n_atoms, dtype=torch.int64, device=dev).view(1, -1)
    zero = torch.zeros((seeds.shape[0], n_atoms), dtype=torch.int64, device=dev)
    col = lambda v: v.view(-1, 1) + zero  # noqa: E731
    o = _philox(zero + atom, col(replicas), col(step & _M32), col((step >> 32) & _M32),
                col(seeds & _M32), col((seeds >> 32) & _M32))
    u = [((w >> 9).to(torch.float32) + 0.5) * (1.0 / 8388608.0) for w in o]
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32, device=dev)
    r1 = torch.sqrt(-2.0 * torch.log(u[0]))
    r2 = torch.sqrt(-2.0 * torch.log(u[2]))
    return torch.stack([r1 * torch.cos(two_pi * u[1]), r1 * torch.sin(two_pi * u[1]),
                        r2 * torch.cos(two_pi * u[3])], -1)


def _cons_scatter(p: Tensor, corr: Tensor, s) -> Tensor:
    i, j = s.cons_pairs[:, 0], s.cons_pairs[:, 1]
    inv_m = 1.0 / s.masses
    out = p.clone()
    out.index_add_(-2, i, -inv_m[i][:, None] * corr)
    out.index_add_(-2, j, inv_m[j][:, None] * corr)
    return out


def _cons_vec(p: Tensor, s) -> Tensor:
    return p[..., s.cons_pairs[:, 0], :] - p[..., s.cons_pairs[:, 1], :]


def rattle(vel: Tensor, pos: Tensor, s, sweeps: int) -> Tensor:
    """Jacobi RATTLE sweeps: remove each constrained bond's relative
    velocity along the bond."""
    d = _cons_vec(pos, s)
    dhat = d * torch.rsqrt(torch.clamp_min(torch.sum(d * d, -1, keepdim=True), 1e-12))
    inv_m = 1.0 / s.masses
    winv = (1.0 / (inv_m[s.cons_pairs[:, 0]] + inv_m[s.cons_pairs[:, 1]]))[:, None]
    for _ in range(sweeps):
        lam = torch.sum(_cons_vec(vel, s) * dhat, -1, keepdim=True) * winv
        vel = _cons_scatter(vel, lam * dhat, s)
    return vel


def shake(pos: Tensor, ref: Tensor, s, sweeps: int) -> Tensor:
    """Jacobi SHAKE sweeps along the bonds at the drift's start."""
    inv_m = 1.0 / s.masses
    wsum = (inv_m[s.cons_pairs[:, 0]] + inv_m[s.cons_pairs[:, 1]])[:, None]
    d0sq = (s.cons_lengths * s.cons_lengths)[:, None]
    for _ in range(sweeps):
        d = _cons_vec(pos, s)
        diff = torch.sum(d * d, -1, keepdim=True) - d0sq
        denom = 2.0 * wsum * torch.sum(d * ref, -1, keepdim=True)
        g = diff / torch.where(torch.abs(denom) > 1e-12, denom, torch.full_like(denom, 1e-12))
        pos = _cons_scatter(pos, g * ref, s)
    return pos


def segment(pos: Tensor, vel: Tensor, frc: Tensor, t0: Tensor, seeds: Tensor,
            replicas: Tensor, s, cfg: dict, traffic: dict, bias, n_steps: int):
    """Advance every row ``n_steps`` steps from ``(pos, vel, frc)``, where
    ``frc`` is the force the state carries. Returns ``(pos, vel, frc)``."""
    e, integ = cfg["energy"], cfg["integrator"]
    dt_fs = integ["dt_fs"]
    half = 0.5 * dt_fs / E.TIMEFACTOR
    gamma = integ["gamma_ps"] * (E.TIMEFACTOR / 1000.0)
    c1 = math.exp(-gamma * dt_fs / E.TIMEFACTOR)
    dtype = pos.dtype
    minv = (1.0 / s.masses)[:, None]
    c2 = torch.sqrt(E.BOLTZMANN * integ["temperature"] / s.masses * (1.0 - c1 * c1))[:, None]
    cons = integ["constrain_h_bonds"] and s.n_constraints > 0
    shake_n, rattle_n = integ["shake_sweeps"], integ["rattle_sweeps"]
    terms = set(e["terms"])
    gb_every, sasa_every = traffic["gb_every"], traffic["sasa_every"]
    impulse = "gb" in terms and gb_every > 1
    held = "sasa" in terms and sasa_every > 1 and not impulse
    # under the impulse form the LCPO force rides with GB where it has a
    # cadence of its own (the configuration lets it take gb_every's only)
    slow_terms = ({"gb"} | ({"sasa"} if "sasa" in terms and sasa_every > 1 else set())
                  if impulse else ({"sasa"} if held else set()))

    def fast_forces(p, i, extra=None):
        f = E.forces(p, s, e, bias, t0 + i, terms=None if not slow_terms else
                     [t for t in _ALL_TERMS if t not in slow_terms])
        return f if extra is None else f + extra

    def slow_forces(p):
        return E.forces(p, s, e, terms=slow_terms)

    def step(pos, vel, frc, i, extra=None):
        vel = vel + half * frc * minv
        if cons:
            vel = rattle(vel, pos, s, rattle_n)
            ref = _cons_vec(pos, s)
        new = pos + half * vel
        pos = shake(new, ref, s, shake_n) if cons else new
        vel = c1 * vel + c2 * normals(seeds, replicas, t0 + i, s.n_atoms).to(dtype)
        if cons:
            vel = rattle(vel, pos, s, rattle_n)
            ref = _cons_vec(pos, s)
        new = pos + half * vel
        pos = shake(new, ref, s, shake_n) if cons else new
        frc = fast_forces(pos, i, extra)
        vel = vel + half * frc * minv
        if cons:
            vel = rattle(vel, pos, s, rattle_n)
        return pos, vel, frc

    def slow_kick(pos, vel, slow):
        vel = vel + (gb_every * half) * slow * minv
        return rattle(vel, pos, s, rattle_n) if cons else vel

    if impulse:
        slow = slow_forces(pos)
        frc = frc - slow
        for j in range(n_steps // gb_every):
            vel = slow_kick(pos, vel, slow)
            for i in range(gb_every):
                pos, vel, frc = step(pos, vel, frc, j * gb_every + i)
            slow = slow_forces(pos)
            vel = slow_kick(pos, vel, slow)
        frc = frc + slow
    elif held:
        for j in range(n_steps // sasa_every):
            slow = slow_forces(pos)
            for i in range(sasa_every):
                pos, vel, frc = step(pos, vel, frc, j * sasa_every + i, slow)
    else:
        for i in range(n_steps):
            pos, vel, frc = step(pos, vel, frc, i)
    return pos, vel, frc

