"""Command-line interface: ``simulate | energy | train | convert | bench``.

``python -m molecular_dynamics_tpu_torch.cli`` (or ``mdx-torch``) takes the
sub-commands and options of the JAX package's ``mdx``: ``simulate`` runs a
replica SMD campaign and leaves per-replica ``.npy`` trajectories, a DCD and
an XYZ of replica 0 and a CSV log; ``energy`` prints per-term energies;
``convert`` turns trajectories into ``.npy`` or PDB; ``bench`` runs
``bench_torch.py``. One option more, ``--device`` (default ``cuda``): the
commands run on the card unless the caller asks for the CPU.

Not ported yet, and raising with the ROADMAP item that brings them:
``train`` (A10-A13), ``--devices`` above 1 (A14), ``.prmtop`` topologies and
``.xtc`` / ``.mdxtc`` trajectories (A8).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_PRMTOP_MSG = (
    "prmtop topologies (with chamber) are not ported yet "
    "(ROADMAP A8: prmtop/chamber)"
)


def _device(name: str):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the commands run on the card; pass --device cpu "
            "to run on the CPU"
        )
    return device


def _meta_topology(ff, meta):
    """Minimal Topology from an npz example's metadata (name/residue tables
    for feature extraction, e.g. phi/psi index tables)."""
    import numpy as np

    from molecular_dynamics_tpu_torch.topology import Topology

    def host(t, dtype):
        return t.detach().cpu().numpy().astype(dtype)

    return Topology(
        atom_types=np.asarray(meta["atom_types"]),
        atom_names=np.asarray(meta["atom_names"]),
        res_names=np.asarray(meta["res_names"]),
        res_ids=np.asarray(meta["res_ids"], np.int64),
        charges=host(ff.charges, np.float64),
        masses=host(ff.masses, np.float64),
        bonds=host(ff.bonds, np.int64),
        angles=host(ff.angles, np.int64),
        dihedrals=host(ff.dihedrals, np.int64),
        impropers=host(ff.impropers, np.int64),
    )


def _load_system(topology: str, parameters: str, coordinates: str = "",
                 dtype=None, device=None):
    """Resolve a (topology, parameters) pair to
    (FFParams, coords, names, Topology). ``coordinates``, a PDB, replaces
    the topology's own coordinates (its first model)."""
    import numpy as np

    from molecular_dynamics_tpu_torch.ff import YamlForceField, build_ff_params

    if topology in ("example:backbone", ""):
        from molecular_dynamics_tpu_torch.examples import (
            BACKBONE_FF_PRM,
            decaalanine_backbone,
        )

        top, coords = decaalanine_backbone()
        ff = build_ff_params(top, YamlForceField(BACKBONE_FF_PRM), dtype=dtype, device=device)
        names = np.asarray(top.atom_names)
    elif topology in ("example:full", "example:diala"):
        from molecular_dynamics_tpu_torch.examples import decaalanine_full, dialanine

        loader = decaalanine_full if topology == "example:full" else dialanine
        ff, coords, meta = loader(dtype=dtype, device=device)
        top = _meta_topology(ff, meta)
        names = meta["atom_names"]
    elif topology.endswith(".prmtop"):
        raise NotImplementedError(_PRMTOP_MSG)
    else:
        from molecular_dynamics_tpu_torch.io import read_psf

        top = read_psf(topology)
        ff = build_ff_params(top, YamlForceField(parameters), dtype=dtype, device=device)
        coords, names = top.coords, np.asarray(top.atom_names)

    if coordinates:
        from molecular_dynamics_tpu_torch.io import read_pdb

        coords = read_pdb(coordinates)[0]
        if coords.ndim == 3:
            coords = coords[0]
        if coords.shape != (ff.n_atoms, 3):
            raise ValueError(
                f"{coordinates} holds {coords.shape[0]} atoms, the topology {ff.n_atoms}"
            )
    return ff, (None if coords is None else np.asarray(coords)), names, top


def prepare_campaign(cfg, device):
    """What ``simulate`` runs, up to the campaign: the system of ``cfg``
    (a ``CampaignConfig``), FIRE-minimised, the SMD bias at the measured
    colvar, Maxwell-Boltzmann velocities, forces, ``cfg.n_replicas``
    replicas. Returns (FFParams, atom names, bias or None, ensemble), or
    None where the topology carries no coordinates."""
    import torch

    from molecular_dynamics_tpu_torch import (
        HarmonicSMDBias,
        maxwell_boltzmann,
        minimize_fire,
        system_init,
    )
    from molecular_dynamics_tpu_torch.energy import force_fn
    from molecular_dynamics_tpu_torch.integrate import initialize_forces
    from molecular_dynamics_tpu_torch.system import replicate

    ff, coords, names, _ = _load_system(
        cfg.topology, cfg.parameters, cfg.coordinates, device=device)
    if coords is None:
        return None
    energy_cfg = cfg.sim.energy
    force = force_fn(energy_cfg)
    pos = torch.as_tensor(coords, dtype=torch.float32, device=device)
    if cfg.minimize_steps:
        pos = minimize_fire(
            pos, lambda p: force(p, ff), n_steps=cfg.minimize_steps,
            dt_start=0.001, dt_max=0.01,
        )

    bias = None
    if cfg.colvar is not None:
        cv = cfg.colvar
        g1, g2 = list(cv.group1), list(cv.group2)
        cent_0 = cv.cent_0
        if cent_0 is None:
            c1 = pos[torch.as_tensor(g1, device=device)].mean(0)
            c2 = pos[torch.as_tensor(g2, device=device)].mean(0)
            cent_0 = float(torch.linalg.norm(c2 - c1))
        bias = HarmonicSMDBias.create(
            n_atoms=ff.n_atoms, group1=g1, group2=g2,
            fk=cv.fk, cent_0=cent_0, cent_1=cv.cent_1, T=cv.T, device=device,
        )

    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    state = system_init(
        pos, vel=maxwell_boltzmann(gen, ff.masses, cfg.sim.temperature),
        key=cfg.seed, device=device,
    )
    seed_force = force_fn(
        energy_cfg, external=None if bias is None else (lambda q: bias.energy(q, 0)))
    state = initialize_forces(state, lambda p, box: seed_force(p, ff))
    return ff, names, bias, replicate(state, cfg.n_replicas, seed=cfg.seed)


def cmd_simulate(args) -> int:
    import numpy as np
    import torch

    from molecular_dynamics_tpu_torch.config import (
        CampaignConfig,
        apply_overrides,
        load_config,
    )
    from molecular_dynamics_tpu_torch.io import write_dcd, write_xyz
    from molecular_dynamics_tpu_torch.log import write_simulation_log
    from molecular_dynamics_tpu_torch.sim import simulate_ensemble

    cfg = load_config(args.config, CampaignConfig) if args.config else CampaignConfig()
    cfg = apply_overrides(cfg, args.override or [])
    devices = getattr(args, "devices", 0) or cfg.devices
    if devices and devices > 1:
        raise NotImplementedError(
            f"--devices {devices}: sharding the replicas over several devices "
            "is not ported yet (ROADMAP A14)"
        )
    device = _device(args.device)
    os.makedirs(cfg.out_dir, exist_ok=True)

    start = prepare_campaign(cfg, device)
    if start is None:
        print("topology carries no coordinates; provide a pdb (coordinates=...)",
              file=sys.stderr)
        return 2
    ff, names, bias, ens = start

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    synchronize()
    t0 = time.perf_counter()
    _, frames, log = simulate_ensemble(
        ens, ff, cfg.n_steps, cfg.save_every, cfg.sim, bias, obs_every=cfg.obs_every,
    )
    synchronize()
    elapsed = time.perf_counter() - t0
    frames = frames.cpu().numpy()  # (saves, R, N, 3)

    for r in range(cfg.n_replicas):
        np.save(os.path.join(cfg.out_dir, f"raw-traj_rep-{r}.npy"), frames[:, r])
    write_dcd(os.path.join(cfg.out_dir, "rep0.dcd"), frames[:, 0])
    write_xyz(
        os.path.join(cfg.out_dir, "rep0.xyz"), frames[:, 0],
        symbols=[str(n) for n in names],
    )
    write_simulation_log(
        os.path.join(cfg.out_dir, "sim_log.csv"),
        {k: v.cpu().numpy() for k, v in log.items()},
    )
    agg = cfg.n_steps * cfg.n_replicas / elapsed
    print(json.dumps({
        "replicas": cfg.n_replicas,
        "steps": cfg.n_steps,
        "frames": list(frames.shape),
        "steps_per_sec": round(agg, 1),
        "out_dir": cfg.out_dir,
    }))
    return 0


def cmd_energy(args) -> int:
    """Per-term energies of frames, one dict a frame (the potcalc printout)."""
    import numpy as np
    import torch

    from molecular_dynamics_tpu_torch.energy import REFERENCE_CONFIG, energy_terms

    device = _device(args.device)
    ff, coords, _, _ = _load_system(
        args.topology, args.parameters, args.coordinates, device=device)
    if args.frames:
        frames = np.load(args.frames)
    elif coords is None:
        print("topology carries no coordinates; pass --frames or --coordinates",
              file=sys.stderr)
        return 2
    else:
        frames = coords[None]
    with torch.no_grad():
        out = energy_terms(
            torch.as_tensor(frames, dtype=torch.float32, device=device), ff,
            config=REFERENCE_CONFIG,
        )
    out = {k: v.cpu().numpy() for k, v in out.items()}
    for i in range(frames.shape[0]):
        print({k: round(float(v[i]), 4) for k, v in out.items()})
    return 0


def cmd_train(args) -> int:
    raise NotImplementedError(
        f"train {args.family}: the model zoo and its training loops are not "
        "ported yet (ROADMAP A10-A13)"
    )


def cmd_convert(args) -> int:
    """Trajectory conversion: dcd/xyz/npy -> npy or PDB, with an optional
    backbone selection and Kabsch alignment to the first frame."""
    import numpy as np

    from molecular_dynamics_tpu_torch.io import read_dcd, read_psf, read_xyz

    if args.input.endswith((".xtc", ".mdxtc")):
        raise NotImplementedError(
            f"{args.input}: xtc trajectories and the native codec are not ported "
            "yet (ROADMAP A8: xtc, the native codec)"
        )
    if args.topology and args.topology.endswith(".prmtop"):
        raise NotImplementedError(_PRMTOP_MSG)
    if args.input.endswith(".dcd"):
        frames, _ = read_dcd(args.input)
    elif args.input.endswith(".xyz"):
        frames = read_xyz(args.input)
    else:
        frames = np.load(args.input)

    if args.selection == "backbone":
        if not args.topology:
            print("--topology required for backbone selection", file=sys.stderr)
            return 2
        top = read_psf(args.topology)
        keep = np.isin(
            np.asarray([str(n) for n in top.atom_names]), ["N", "CA", "C", "O"]
        )
        frames = frames[:, keep]

    if args.align:
        # host numpy f64 Kabsch onto the first frame
        ref = np.asarray(frames[0], np.float64)
        ref_c = ref - ref.mean(axis=0)
        out = np.empty_like(np.asarray(frames, np.float64))
        for k, f in enumerate(np.asarray(frames, np.float64)):
            f_c = f - f.mean(axis=0)
            u, _, vt = np.linalg.svd(f_c.T @ ref_c, full_matrices=False)
            d = np.sign(np.linalg.det(vt.T @ u.T))
            r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
            out[k] = f_c @ r.T + ref.mean(axis=0)
        frames = out

    if args.output.endswith(".pdb"):
        # one multi-model PDB for VMD
        from molecular_dynamics_tpu_torch.io import write_pdb

        frames = np.asarray(frames, np.float64)
        n = frames.shape[-2]
        names = resnames = resids = None
        if args.topology:
            top = read_psf(args.topology)
            atoms = np.asarray([str(x) for x in top.atom_names], object)
            if args.selection == "backbone":
                sel = np.isin(atoms, ["N", "CA", "C", "O"])
                names = atoms[sel]
                resnames, resids = top.res_names[sel], top.res_ids[sel]
            elif len(atoms) == n:
                names = atoms
                resnames, resids = top.res_names, top.res_ids
        if names is None and n % 4 == 0:
            # a backbone: N/CA/C/O x (n/4), resname ALA
            names = np.array(["N", "CA", "C", "O"] * (n // 4), object)
            resnames = np.array(["ALA"] * n, object)
            resids = np.repeat(np.arange(1, n // 4 + 1), 4)
        if names is None:
            names = np.array(["C"] * n, object)
        write_pdb(args.output, frames, names, resnames=resnames, resids=resids)
    else:
        np.save(args.output, np.asarray(frames, np.float32))
    print(f"{args.input} -> {args.output} {frames.shape}")
    return 0


def cmd_bench(args) -> int:
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return subprocess.call(
        [sys.executable, os.path.join(root, "bench_torch.py"), "--device", args.device]
    )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="mdx-torch",
        description="molecular dynamics on the GPU (the PyTorch/CUDA port of mdx)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    def device_option(p):
        p.add_argument(
            "--device", default="cuda",
            help="torch device to run on (default cuda; cpu runs the kernels' "
            "plain PyTorch versions)",
        )

    p_sim = sub.add_parser("simulate", help="run a replica MD/SMD campaign")
    p_sim.add_argument("--config", default=None, help="YAML or JSON campaign config")
    p_sim.add_argument(
        "-o", "--override", action="append",
        help="dotted config override, e.g. n_replicas=8",
    )
    p_sim.add_argument(
        "--devices", type=int, default=0,
        help="shard the replica axis over N devices (not ported yet above 1)",
    )
    device_option(p_sim)
    p_sim.set_defaults(fn=cmd_simulate)

    p_en = sub.add_parser("energy", help="print per-term energies of frames")
    p_en.add_argument("--topology", default="example:backbone")
    p_en.add_argument("--parameters", default="")
    p_en.add_argument("--coordinates", default="", help="pdb of the starting coordinates")
    p_en.add_argument("--frames", default=None, help="npy of (F, N, 3)")
    device_option(p_en)
    p_en.set_defaults(fn=cmd_energy)

    p_tr = sub.add_parser("train", help="train a model family (not ported yet)")
    p_tr.add_argument("family", choices=[
        "pretrain", "cgan", "hnn", "hnn-schnet", "hnn-latent", "lstm", "lstm-nll", "seq2seq",
        "seq2seq-graph", "seq2seq-gan", "lstm-gat", "aae", "flow", "vae", "transformer",
        "gat", "sde", "node",
    ])
    p_tr.add_argument("--data", default="", help="npy glob of trajectories")
    p_tr.add_argument("--stride", type=int, default=1,
                      help="frame stride applied when loading --data trajectories")
    p_tr.add_argument("--topology", default="example:backbone")
    p_tr.add_argument("--parameters", default="")
    p_tr.add_argument("--epochs", type=int, default=3)
    p_tr.add_argument("--batch-size", type=int, default=32)
    p_tr.add_argument("--out-dir", default="runs")
    p_tr.add_argument("--seed", type=int, default=0)
    p_tr.add_argument("--devices", type=int, default=0,
                      help="data-parallel training over N devices")
    device_option(p_tr)
    p_tr.set_defaults(fn=cmd_train)

    p_cv = sub.add_parser("convert", help="trajectory -> npy conversion")
    p_cv.add_argument("input")
    p_cv.add_argument("output")
    p_cv.add_argument("--selection", choices=["all", "backbone"], default="all")
    p_cv.add_argument("--align", action="store_true",
                      help="Kabsch-align all frames to the first")
    p_cv.add_argument("--topology", default=None)
    p_cv.set_defaults(fn=cmd_convert)

    p_be = sub.add_parser("bench", help="run the port's benchmark (bench_torch.py)")
    device_option(p_be)
    p_be.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
