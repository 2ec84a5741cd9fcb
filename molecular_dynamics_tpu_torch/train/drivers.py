"""End-to-end training drivers (``cli train``).

Load or generate trajectories, build the family's model and update steps,
run epochs with CSV logging, best-checkpoint keeping and loss plots, and
emit generated ``.xyz`` / ``.pdb`` trajectories and an ``eval.json`` at the
end. Ported families: ``pretrain`` (the decoder's pretraining) and ``cgan``
(pretrain, then the three-phase physics-informed GAN). Every other family
raises ``NotImplementedError`` naming the ROADMAP item that brings it.

When no ``--data`` glob is given the driver first generates a small SMD
dataset on the device (``_bootstrap_dataset``).
"""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import torch

#: families of the reference not ported yet, and the ROADMAP item of each
_QUEUED = {
    **dict.fromkeys(("hnn", "hnn-schnet", "hnn-latent"), "A11"),
    **dict.fromkeys(("lstm", "lstm-nll", "seq2seq", "seq2seq-gan", "seq2seq-graph",
                     "lstm-gat", "transformer", "gat"), "A12"),
    **dict.fromkeys(("vae", "aae", "flow", "sde", "node"), "A13"),
}


def _bootstrap_dataset(ff, coords, out_dir, n_replicas=8, n_steps=8000, device=None):
    """Generate SMD trajectories on the device (a mini SMD campaign):
    FIRE, a bias from the measured end-to-end distance +8 A over the run,
    300 K velocities, ``n_replicas`` replicas at 0.5 fs on the composed
    path, frames every 50 steps. Replicas that diverge are dropped (more
    than half raises). Writes ``raw-traj_rep-{r}.npy`` into ``out_dir`` and
    returns the frames (R, saves, N, 3)."""
    from molecular_dynamics_tpu_torch import (
        HarmonicSMDBias,
        maxwell_boltzmann,
        minimize_fire,
        system_init,
    )
    from molecular_dynamics_tpu_torch.convert import resolve_device
    from molecular_dynamics_tpu_torch.energy import REFERENCE_CONFIG, force_fn
    from molecular_dynamics_tpu_torch.integrate import initialize_forces
    from molecular_dynamics_tpu_torch.sim import SimulationConfig, simulate_ensemble
    from molecular_dynamics_tpu_torch.system import replicate

    device = resolve_device(device)
    force = force_fn(REFERENCE_CONFIG)
    pos = minimize_fire(
        torch.as_tensor(coords, dtype=torch.float32, device=device),
        lambda p: force(p, ff), n_steps=1000, dt_start=0.001, dt_max=0.01,
    )
    n = ff.n_atoms
    d0 = float(torch.linalg.norm(pos[-1] - pos[0]))
    bias = HarmonicSMDBias.create(
        n_atoms=n, group1=[0], group2=[n - 1], fk=1.0,
        cent_0=d0, cent_1=d0 + 8.0, T=float(n_steps), device=device,
    )
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    state = system_init(
        pos, vel=maxwell_boltzmann(gen, ff.masses, 300.0), key=0, device=device)
    seed_force = force_fn(REFERENCE_CONFIG, external=lambda q: bias.energy(q, 0))
    state = initialize_forces(state, lambda p, box: seed_force(p, ff))
    ens = replicate(state, n_replicas, seed=1)
    # 0.5 fs: the unconstrained backbone force field is marginal at 1 fs:
    # from thermal 300 K starts about 1 replica in 8 blows through a
    # stiff-bond resonance within a few ps and poisons the whole dataset
    _, frames, _ = simulate_ensemble(
        ens, ff, n_steps, save_every=50, config=SimulationConfig(dt_fs=0.5), bias=bias)
    frames = np.moveaxis(frames.cpu().numpy(), 1, 0)  # (R, saves, N, 3)
    # refuse to train on an exploded ensemble
    span = float(pos.abs().max())
    ok = np.isfinite(frames).all(axis=(1, 2, 3)) & (
        np.abs(frames).max(axis=(1, 2, 3)) < 100.0 * max(span, 1.0))
    if not ok.all():
        bad = int((~ok).sum())
        if bad > n_replicas // 2:
            raise RuntimeError(
                f"bootstrap SMD ensemble diverged in {bad}/{n_replicas} "
                "replicas: check the force field / schedule")
        print(f"bootstrap: dropping {bad}/{n_replicas} diverged replicas")
        frames = frames[ok]
    os.makedirs(out_dir, exist_ok=True)
    for r in range(len(frames)):
        np.save(os.path.join(out_dir, f"raw-traj_rep-{r}.npy"), frames[r])
    return frames


def run_training(
    family: str,
    data: str = "",
    data_stride: int = 1,
    topology: str = "example:backbone",
    parameters: str = "",
    epochs: int = 3,
    batch_size: int = 32,
    out_dir: str = "runs",
    seed: int = 0,
    devices: int = 0,
    device=None,
) -> int:
    """Train ``family`` on ``data`` (or on a bootstrap dataset) into
    ``out_dir/family``. ``device`` defaults to the CUDA device; the numpy
    batches are shuffled by ``np.random.default_rng(seed)`` and the model
    initialised and its latents drawn from a ``torch.Generator`` on the
    device seeded with ``seed``."""
    from molecular_dynamics_tpu_torch.cli import _device, _load_system
    from molecular_dynamics_tpu_torch.convert import resolve_device
    from molecular_dynamics_tpu_torch.log import CSVLogger, plot_losses
    from molecular_dynamics_tpu_torch.train.checkpoint import BestKeeper
    from molecular_dynamics_tpu_torch.train.datasets import TrajectoryData

    if family in _QUEUED:
        raise NotImplementedError(
            f"train {family}: this family is not ported yet (ROADMAP {_QUEUED[family]})")
    if family not in _FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    if devices and devices > 1:
        raise NotImplementedError(
            f"--devices {devices}: data-parallel training over several devices is "
            "not ported yet (ROADMAP A14)")
    device = _device(resolve_device(device))

    out_dir = os.path.join(out_dir, family)
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    ff, coords, names, top = _load_system(topology, parameters, device=device)
    if data:
        traj = TrajectoryData.from_npy_glob(data, stride=data_stride)
    else:
        frames = _bootstrap_dataset(ff, coords, os.path.join(out_dir, "data"), device=device)
        traj = TrajectoryData.from_array(frames)

    logger = CSVLogger(os.path.join(out_dir, "train_log.csv"), ["epoch", "step", "loss", "wall_s"])
    keeper = BestKeeper(os.path.join(out_dir, "best.ckpt"))
    curves = {"loss": []}
    t_start = time.time()
    _FAMILIES[family](
        ff=ff, traj=traj, epochs=epochs, batch_size=batch_size, rng=rng, gen=gen,
        logger=logger, keeper=keeper, curves=curves, out_dir=out_dir, names=names,
        top=top, device=device,
    )
    plot_losses(os.path.join(out_dir, "loss.png"), curves, title=family)
    logger.close()
    print(
        f"{family}: {epochs} epochs in {time.time() - t_start:.1f}s, "
        f"best loss {keeper.best:.4f}, artifacts in {out_dir}"
    )
    return 0


def _log(logger, curves, keeper, model, epoch, step, loss, t0):
    """One row of the training log (a host synchronisation: ``float``)."""
    loss = float(loss)
    logger.write_row(epoch=epoch, step=step, loss=loss, wall_s=round(time.time() - t0, 2))
    curves["loss"].append(loss)
    if math.isfinite(loss):
        keeper.update(loss, model)


def _export_xyz(path, coords_batch, names, top=None, max_pdb_frames=200):
    """Write a generated rollout as xyz plus a multi-model PDB sibling for
    VMD. Residue records come from the topology where it has one an atom,
    else from the backbone heuristic (N/CA/C/O x n/4, ALA)."""
    from molecular_dynamics_tpu_torch.io import write_pdb, write_xyz

    coords = np.asarray(coords_batch)
    write_xyz(path, coords, symbols=[str(n) for n in names])

    frames = coords[None] if coords.ndim == 2 else coords
    n = frames.shape[1]
    resnames = resids = None
    if top is not None and len(getattr(top, "res_names", ())) == n:
        resnames, resids = top.res_names, top.res_ids
    elif n % 4 == 0 and [str(x) for x in names[:4]] == ["N", "CA", "C", "O"]:
        resnames = np.array(["ALA"] * n, object)
        resids = np.repeat(np.arange(1, n // 4 + 1), 4)
    write_pdb(
        os.path.splitext(path)[0] + ".pdb",
        frames[:max_pdb_frames],
        np.asarray([str(x) for x in names], object),
        resnames=resnames,
        resids=resids,
    )


def _eval_generated(out_dir, family, generated, traj):
    """Score a generated ensemble against the training data (end-to-end
    distance per normalized-time bucket, radius of gyration) and write
    ``eval.json`` in the run directory."""
    from molecular_dynamics_tpu_torch.evaluate import compare_e2e

    data_frames, _ = traj.stacked()
    generated = np.asarray(generated)
    data_frames = np.asarray(data_frames)
    # time-resolved data reference: each trajectory bucketed along its own
    # normalized time, so the generated sweep is scored against the pulling
    # profile
    metrics = compare_e2e(generated, data_frames, data_trajectories=traj.trajectories)
    # radius-of-gyration statistics (uniform weights: both ensembles share
    # one topology)
    for name, ens in (("gen", generated), ("data", data_frames)):
        cen = ens - ens.mean(axis=1, keepdims=True)
        rg = np.sqrt((cen**2).sum(axis=(1, 2)) / ens.shape[1])
        metrics[f"rg_{name}_mean"] = float(rg.mean())
    metrics["rg_abs_error"] = abs(metrics["rg_gen_mean"] - metrics["rg_data_mean"])
    with open(os.path.join(out_dir, "eval.json"), "w") as f:
        json.dump(metrics, f, indent=1)
    print(
        f"{family} eval: "
        + ", ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(metrics.items())
        )
    )
    return metrics


def _latents(gen, n, latent_dim):
    return torch.randn((n, latent_dim), generator=gen, device=gen.device)


def _sweep(model, gen):
    """The generation sweep: 20 structures at t = 0 ... 1, as numpy."""
    device = next(model.parameters()).device
    with torch.no_grad():
        coords = model.coords(_latents(gen, 20, model.latent_dim),
                              torch.linspace(0, 1, 20, device=device))
    return coords.cpu().numpy()


# --- family runners ---------------------------------------------------------


def _pretrain_generator(model, ff, traj, epochs, batch_size, rng, gen, logger, keeper,
                        curves, t0=None):
    """The shared decoder-pretrain loop, in place on ``model``.

    lr 1e-3: at the reference's 1e-4 + clip 1.0 the decoder needs about
    10k steps to reach the data's coordinate scale. The potential
    curriculum is capped at 1e-2: the raw potential (about 1e3 kcal/mol)
    would otherwise drown the O(1) geometric losses. Returns the step count.
    """
    from molecular_dynamics_tpu_torch.train.cgan import PretrainStep
    from molecular_dynamics_tpu_torch.train.datasets import frame_time_batches

    step = PretrainStep(model, ff, lr=1e-3)
    device = gen.device
    t0 = time.time() if t0 is None else t0
    i = 0
    for epoch in range(epochs):
        alpha = 0.01 * min(1.0, epoch / max(epochs - 1, 1))
        for frames, times in frame_time_batches(traj, batch_size, rng):
            loss, _ = step(
                _latents(gen, len(times), model.latent_dim),
                torch.as_tensor(frames, device=device),
                torch.as_tensor(times, device=device), alpha)
            i += 1
            if i % 10 == 0:
                _log(logger, curves, keeper, model, epoch, i, loss, t0)
    return i


def _run_pretrain(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir,
                  names, top, device):
    from molecular_dynamics_tpu_torch.models.cgan import Generator

    model = Generator(n_atoms=ff.n_atoms, generator=gen, device=device)
    _pretrain_generator(model, ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves)
    coords = _sweep(model, gen)
    _export_xyz(os.path.join(out_dir, "pretrain_generated.xyz"), coords, names, top=top)
    _eval_generated(out_dir, "pretrain", coords, traj)
    return model


def _clone_state(model):
    """A snapshot of ``model``'s weights (``state_dict`` alone aliases them)."""
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _data_bias(traj, n_atoms, device, dtype=torch.float32):
    """The informed phase's SMD bias, anchored to the data: the centre must
    start at the colvar the trajectories actually visit (a schedule away
    from it dumps hundreds of kcal/mol into the informed loss). cent_0 /
    cent_1 = the mean end-to-end distance of the data over the first / last
    10 % of normalized time, over 10,000 steps."""
    from molecular_dynamics_tpu_torch import HarmonicSMDBias

    frames_all, times_all = traj.stacked()
    e2e = np.linalg.norm(frames_all[:, -1] - frames_all[:, 0], axis=-1)
    order = np.argsort(times_all)
    k10 = max(len(order) // 10, 1)
    return HarmonicSMDBias.create(
        n_atoms=n_atoms, group1=[0], group2=[n_atoms - 1], fk=1.0,
        cent_0=float(np.mean(e2e[order[:k10]])), cent_1=float(np.mean(e2e[order[-k10:]])),
        T=10000.0, dtype=dtype, device=device,
    )


def _run_cgan(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir,
              names, top, device):
    from molecular_dynamics_tpu_torch.models.cgan import Discriminator, Generator
    from molecular_dynamics_tpu_torch.train.cgan import CGANConfig, CGANTrainer
    from molecular_dynamics_tpu_torch.train.datasets import frame_time_batches

    n = ff.n_atoms
    g_model = Generator(n_atoms=n, generator=gen, device=device)
    d_model = Discriminator(in_features=n * 3, generator=gen, device=device)
    bias = _data_bias(traj, n, device)
    # GAN-phase rates: at the reference's 1e-4 the discriminator saturates
    # in one epoch and the adversarial push walks the pretrained decoder off
    # the manifold, after which the informed loss explodes. 1e-5 everywhere
    # keeps all three losses bounded; the physics-best generator below is
    # the reference's best-checkpoint rollback.
    cfg = CGANConfig(lr_g=1e-5, lr_d=1e-5, lr_informed=1e-5)
    trainer = CGANTrainer(g_model, d_model, ff, bias=bias, config=cfg)
    t0 = time.time()
    # phase 1: decoder pretrain (a GAN from a random decoder collapses: the
    # informed phase sees astronomic LJ). The keeper is not rebased after
    # it, as in the reference driver.
    i = _pretrain_generator(g_model, ff, traj, max(epochs, 4), batch_size, rng, gen, logger,
                            keeper, curves, t0=t0)
    # phase 2: the three-phase adversarial + informed loop (the trainer's
    # optimizers have taken no step yet), the final generator the
    # physics-best (lowest informed loss) probe, not the last iterate
    best_i, best_state = float("inf"), _clone_state(g_model)
    for epoch in range(epochs):
        for frames, times in frame_time_batches(traj, batch_size, rng):
            fr_b = torch.as_tensor(frames, device=device)
            t_b = torch.as_tensor(times, device=device)
            n_b = len(times)
            trainer.g_step(_latents(gen, n_b, g_model.latent_dim), t_b)
            trainer.d_step(_latents(gen, n_b, g_model.latent_dim), fr_b, t_b)
            i_loss = trainer.informed_step(_latents(gen, n_b, g_model.latent_dim), t_b)
            i += 1
            if i % 10 == 0:
                # a host synchronisation, so the best-generator probe shares
                # the logging cadence instead of blocking every batch
                il = float(i_loss)
                if il < best_i:
                    best_i, best_state = il, _clone_state(g_model)
                elif not np.isfinite(il) or (
                    np.isfinite(best_i) and il > 1e3 * (abs(best_i) + 1.0)
                ):
                    # adversarial divergence (the informed loss explodes once
                    # the GAN push walks the generator off the physical
                    # manifold, then NaNs poison every later update): restore
                    # the physics-best generator and fresh generator
                    # optimizers
                    g_model.load_state_dict(best_state)
                    trainer.reset_generator_optimizers()
                _log(logger, curves, keeper, g_model, epoch, i, i_loss, t0)
    g_model.load_state_dict(best_state)
    coords = _sweep(g_model, gen)
    _export_xyz(os.path.join(out_dir, "cGAN_generated.xyz"), coords, names, top=top)
    _eval_generated(out_dir, "cgan", coords, traj)
    return g_model


_FAMILIES = {
    "pretrain": _run_pretrain,
    "cgan": _run_cgan,
}
