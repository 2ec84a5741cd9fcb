"""The system under test: the SMD campaign of ``molecular_dynamics_tpu_torch``
as a user drives it, built from a configuration file and a traffic mix.

Set-up follows the port's own campaign drivers (FIRE, the SMD bias from the
measured end-to-end distance, Maxwell-Boltzmann velocities, the forces at
the start, the replicas); a chunk is one ``simulate_ensemble`` call with
``fused_campaign=True`` whose state carries over to the next, and whose
frames and log the caller copies to the host, as
``molecular_dynamics_tpu_torch.regenerate_smd`` does. This module is the
only one of the benchmark that imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _energy_config(e: dict):
    from molecular_dynamics_tpu_torch.energy import EnergyConfig

    keys = ("cutoff", "switch_dist", "rfa", "solvent_dielectric", "ion_concentration",
            "surface_tension")
    return EnergyConfig(terms=tuple(e["terms"]), **{k: e[k] for k in keys if k in e})


@dataclasses.dataclass
class Chunk:
    """What one chunk handed back, copied to the host: the frames ``(saves,
    R, N, 3)``, the log (``(logged saves, R)`` a key) and which replicas
    came back finite."""

    frames: np.ndarray
    log: dict
    finite: np.ndarray


class Campaign:
    """One configuration under one traffic mix, on one device."""

    def __init__(self, cfg: dict, traffic: dict, arrays: dict, seed: int, device):
        from molecular_dynamics_tpu_torch import (
            HarmonicSMDBias,
            maxwell_boltzmann,
            minimize_fire,
            system_init,
        )
        from molecular_dynamics_tpu_torch.convert import FF_ARRAY_FIELDS, ff_params_from_numpy
        from molecular_dynamics_tpu_torch.energy import force_fn
        from molecular_dynamics_tpu_torch.integrate import initialize_forces
        from molecular_dynamics_tpu_torch.sim import SimulationConfig, simulate_ensemble
        from molecular_dynamics_tpu_torch.solvent import attach_gb_params, infer_elements
        from molecular_dynamics_tpu_torch.system import replicate

        self._simulate = simulate_ensemble
        self.traffic = traffic
        ff = ff_params_from_numpy({k: arrays[f"ff_{k}"] for k in FF_ARRAY_FIELDS},
                                  device=device, dtype=torch.float32)
        self.ff = attach_gb_params(ff, infer_elements(arrays["ff_masses"], arrays["atom_names"]))
        n = self.ff.n_atoms
        mini = cfg["minimize"]
        fire_force = force_fn(_energy_config(mini["energy"]))
        pos = minimize_fire(
            torch.as_tensor(arrays["coords"], dtype=torch.float32, device=device),
            lambda p: fire_force(p, self.ff), n_steps=mini["steps"],
            dt_start=mini["dt_start"], dt_max=mini["dt_max"])
        b = cfg["bias"]
        g1, g2 = list(b["group1"]), list(b["group2"])
        d0 = float(torch.linalg.norm(pos[g2].mean(0) - pos[g1].mean(0)))
        self.bias = HarmonicSMDBias.create(
            n_atoms=n, group1=g1, group2=g2, fk=b["fk"], cent_0=d0, cent_1=d0 + b["pull"],
            T=float(b["pull_steps"]), device=device)
        integ = cfg["integrator"]
        e_cfg = _energy_config(cfg["energy"])
        self.sim_config = SimulationConfig(
            dt_fs=integ["dt_fs"], temperature=integ["temperature"], gamma_ps=integ["gamma_ps"],
            energy=e_cfg, fused_campaign=True, constrain_h_bonds=integ["constrain_h_bonds"],
            sasa_every=traffic["sasa_every"], gb_every=traffic["gb_every"])
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        state = system_init(pos, vel=maxwell_boltzmann(gen, self.ff.masses, integ["temperature"]),
                            key=0, device=device)
        start_force = force_fn(e_cfg, external=lambda q: self.bias.energy(q, 0))
        state = initialize_forces(state, lambda p, box: start_force(p, self.ff))
        self.states = replicate(state, traffic["replicas"], seed=int(seed))

    def chunk(self) -> Chunk:
        """One ``simulate_ensemble`` call of ``chunk_steps`` from the carried
        state; its frames and log copied to the host."""
        t = self.traffic
        states, frames, log = self._simulate(
            self.states, self.ff, t["chunk_steps"], t["save_every"], self.sim_config, self.bias,
            obs_every=t["obs_every"])
        finite = torch.isfinite(frames).flatten(2).all(-1).all(0)
        out = Chunk(frames=frames.cpu().numpy(),
                    log={k: v.cpu().numpy() for k, v in log.items()},
                    finite=finite.cpu().numpy())
        self.states = states
        return out

    @staticmethod
    def launches() -> int:
        """Launches of the campaign kernel this process has made (the CPU
        takes the kernel's plain version, which launches nothing)."""
        from molecular_dynamics_tpu_torch.ops.fused_step import campaign_advance

        return int(campaign_advance.launches)

    def state_rows(self, rows) -> dict:
        """The carried state of some replicas, on the host."""
        idx = torch.as_tensor(rows, device=self.states.pos.device)
        s = self.states
        return {"pos": s.pos[idx].cpu().numpy(), "vel": s.vel[idx].cpu().numpy(),
                "frc": s.forces[idx].cpu().numpy(), "step": int(s.step.reshape(-1)[0])}

    def release(self):
        """Drop the program's device state (before the reference runs)."""
        self.states = self.ff = self.bias = None
