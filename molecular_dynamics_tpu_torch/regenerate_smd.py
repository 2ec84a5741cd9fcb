"""Regenerate the SMD training-data campaign on the card.

The reference made its training data with independent NAMD jobs, each
500,000 Langevin steps (1 ns) of steered MD pulling deca-alanine's
end-to-end distance across 22 A, frames every 50 steps. This module runs
the same protocol (Langevin 300 K, damping 1/ps, 2 fs steps, a moving
harmonic colvar over the whole run) for ``--replicas`` replicas in one
program, through the campaign kernel unless ``--no-fused``, and writes the
npy trajectories the training loaders read, per-atom forces with
``--forces``, a DCD of replica 0, the colvar/energy CSV log (every 20th
save), the full per-replica log and a ``summary.json``.

Usage: ``python -m molecular_dynamics_tpu_torch.regenerate_smd --replicas 64
--steps 500000 [--gbis] [--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python -m molecular_dynamics_tpu_torch.regenerate_smd")
    ap.add_argument("--replicas", type=int, default=64)
    ap.add_argument("--steps", type=int, default=500_000)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--pull", type=float, default=22.0, help="colvar span (A)")
    ap.add_argument("--out", default="smd_campaign")
    ap.add_argument("--no-fused", action="store_true",
                    help="the composed per-step path instead of the campaign kernel")
    ap.add_argument(
        "--gbis", action="store_true",
        help="the NAMD campaign's physics: GB-OBC + SASA implicit solvent, 0.1 M salt, "
        "rigid X-H bonds, all inside the campaign kernel",
    )
    ap.add_argument("--max-dump", type=int, default=4,
                    help="replicas to write npy files for (the statistics use all)")
    ap.add_argument("--forces", action="store_true",
                    help="also dump the per-atom total forces of every saved frame")
    ap.add_argument(
        "--obs-every", type=int, default=1,
        help="log observables every Nth saved frame (frames are still saved every "
        "--save-every steps): the per-term energy log costs a force-field pass per save",
    )
    ap.add_argument(
        "--sasa-every", type=int, default=1,
        help="evaluate the LCPO SASA force every k steps and hold it in between; must "
        "divide --save-every (1 = every step)",
    )
    ap.add_argument(
        "--chunk-steps", type=int, default=100_000,
        help="steps per simulate_ensemble call (the state carries its step counter, so "
        "the SMD schedule continues across calls)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' plain versions)")
    return ap.parse_args(argv)


def summarize(args, frames, log, masses, elapsed, dt_fs) -> dict:
    """The campaign's ``summary.json`` from its frames (saves, R, N, 3) and
    its per-replica log (saves, R): radius of gyration over the second half
    of the frames, end-to-end distances, the colvar against its centre, and
    the temperature over the second half of the log."""
    from molecular_dynamics_tpu_torch.evaluate import radius_of_gyration

    n = frames.shape[2]
    half = frames[frames.shape[0] // 2 :]
    rg = radius_of_gyration(half.reshape(-1, n, 3), masses)
    e2e_all = np.linalg.norm(frames[:, :, -1, :] - frames[:, :, 0, :], axis=-1)

    cv = log["colvar_value"]  # (saves, R)
    center = log["colvar_center"][:, 0]
    temp = log["T"]
    lag = center[:, None] - cv
    return {
        "replicas": args.replicas,
        "physics": "gbis+sasa+rigidH" if args.gbis else "vacuum(rfa)",
        "rg_mean_A": round(float(rg.mean()), 3),
        "rg_std_A": round(float(rg.std()), 3),
        "e2e_mean_A": round(float(e2e_all.mean()), 2),
        "e2e_final_mean_A": round(float(e2e_all[-1].mean()), 2),
        "steps": args.steps,
        "wall_s": round(elapsed, 1),
        "aggregate_steps_per_sec": round(args.steps * args.replicas / elapsed, 1),
        "sim_ns_per_replica": args.steps * dt_fs / 1e6,
        "colvar_start_A": round(float(cv[0].mean()), 2),
        "colvar_end_A": round(float(cv[-1].mean()), 2),
        "colvar_target_end_A": round(float(center[-1]), 2),
        "colvar_mean_lag_A": round(float(lag[len(lag) // 2 :].mean()), 2),
        "temperature_mean_K": round(float(temp[len(temp) // 2 :].mean()), 1),
        "all_finite": bool(np.isfinite(frames).all()),
        "frames_shape": list(frames.shape),
    }


def main(argv=None) -> int:
    from molecular_dynamics_tpu_torch import (
        HarmonicSMDBias,
        maxwell_boltzmann,
        minimize_fire,
        system_init,
    )
    from molecular_dynamics_tpu_torch.cli import _device
    from molecular_dynamics_tpu_torch.energy import GBIS_CONFIG, REFERENCE_CONFIG, force_fn
    from molecular_dynamics_tpu_torch.examples import decaalanine_full
    from molecular_dynamics_tpu_torch.integrate import initialize_forces
    from molecular_dynamics_tpu_torch.io import write_dcd
    from molecular_dynamics_tpu_torch.log import write_simulation_log
    from molecular_dynamics_tpu_torch.sim import SimulationConfig, simulate_ensemble
    from molecular_dynamics_tpu_torch.system import replicate

    args = parse_args(argv)
    device = _device(args.device)
    os.makedirs(args.out, exist_ok=True)

    ff, coords, _ = decaalanine_full(dtype=torch.float32, device=device)
    n = ff.n_atoms
    e_cfg = GBIS_CONFIG if args.gbis else REFERENCE_CONFIG
    force = force_fn(e_cfg)
    pos = minimize_fire(
        torch.as_tensor(coords, dtype=torch.float32, device=device),
        lambda p: force(p, ff), n_steps=1000, dt_start=1e-3, dt_max=1e-2,
    )

    d0 = float(torch.linalg.norm(pos[-1] - pos[0]))
    bias = HarmonicSMDBias.create(
        n_atoms=n, group1=[0], group2=[n - 1], fk=1.0,
        cent_0=d0, cent_1=d0 + args.pull, T=float(args.steps), device=device,
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = system_init(
        pos, vel=maxwell_boltzmann(gen, ff.masses, 300.0), key=0, device=device)
    seed_force = force_fn(e_cfg, external=lambda q: bias.energy(q, 0))
    state = initialize_forces(state, lambda p, box: seed_force(p, ff))
    ens = replicate(state, args.replicas, seed=1)

    cfg = SimulationConfig(
        dt_fs=2.0, temperature=300.0, gamma_ps=1.0,
        energy=e_cfg,
        fused_campaign=not args.no_fused,
        # the NAMD campaign ran rigidBonds all at 2 fs
        constrain_h_bonds=args.gbis,
        sasa_every=args.sasa_every,
    )
    t0 = time.perf_counter()
    # chunks are multiples of save_every x obs_every: simulate_ensemble runs
    # only n_steps // save_every * save_every steps, so a ragged chunk would
    # silently shorten the campaign
    quantum = args.save_every * max(1, args.obs_every)
    chunk = max(quantum, min(args.chunk_steps, args.steps))
    chunk -= chunk % quantum
    total = args.steps - args.steps % quantum
    frames_parts, log_parts, force_parts = [], [], []
    states = ens
    done = 0
    while done < total:
        n_chunk = min(chunk, total - done)
        n_chunk -= n_chunk % quantum
        out = simulate_ensemble(
            states, ff, n_chunk, args.save_every, cfg, bias,
            obs_every=args.obs_every, save_forces=args.forces,
        )
        states, fr, lg = out[:3]
        if args.forces:
            force_parts.append(out[3].cpu().numpy())
        frames_parts.append(fr.cpu().numpy())
        log_parts.append({k: v.cpu().numpy() for k, v in lg.items()})
        done += n_chunk
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    frames = np.concatenate(frames_parts)  # (saves, R, N, 3)
    log = {k: np.concatenate([p[k] for p in log_parts]) for k in log_parts[0]}

    # artifacts: one npy a replica (the first max_dump), one DCD, the CSV log
    for r in range(min(args.replicas, args.max_dump)):
        np.save(os.path.join(args.out, f"raw-traj_rep-{r}.npy"), frames[:, r])
    if args.forces:
        force_frames = np.concatenate(force_parts)
        for r in range(min(args.replicas, args.max_dump)):
            np.save(os.path.join(args.out, f"raw-forces_rep-{r}.npy"), force_frames[:, r])
    write_dcd(os.path.join(args.out, "rep0.dcd"), frames[:, 0])
    write_simulation_log(
        os.path.join(args.out, "sim_log.csv"), {k: v[::20] for k, v in log.items()})
    # every replica's observables at every logged save (saves, R): the strided
    # CSV and the max_dump frame subset lose them
    np.savez_compressed(os.path.join(args.out, "full_log.npz"), **log)

    summary = summarize(args, frames, log, ff.masses.cpu().numpy(), elapsed, cfg.dt_fs)
    with open(os.path.join(args.out, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=2)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
