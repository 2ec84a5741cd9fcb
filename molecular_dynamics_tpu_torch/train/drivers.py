"""End-to-end training drivers (``cli train``).

Load or generate trajectories, build the family's model and update steps,
run epochs with CSV logging, best-checkpoint keeping and loss plots, and
emit generated ``.xyz`` / ``.pdb`` trajectories and an ``eval.json`` at the
end. Ported families: ``pretrain`` (the decoder's pretraining), ``cgan``
(pretrain, then the three-phase physics-informed GAN), and the Hamiltonian
dynamics line: ``hnn`` and ``hnn-schnet`` (an HNN field, MLP or SchNet,
trained on phase-space differences, then through a recurrent unroll),
``hnn-latent`` (an HNN in an autoencoder's latent phase space) and ``node``
(the HNN field trained through an RK4 solver). The dynamics families
generate by rollout from each data trajectory's start and can pick the
training snapshot whose probe rollouts best match the data. Every other
family raises ``NotImplementedError`` naming the ROADMAP item that brings
it.

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
    **dict.fromkeys(("lstm", "lstm-nll", "seq2seq", "seq2seq-gan", "seq2seq-graph",
                     "lstm-gat", "transformer", "gat"), "A12"),
    **dict.fromkeys(("vae", "aae", "flow", "sde"), "A13"),
}

#: the stem of the generated trajectory each family writes (``.xyz``, and a
#: ``.pdb`` beside it), the reference's file names
GENERATED = {"pretrain": "pretrain_generated", "cgan": "cGAN_generated", "hnn": "HNN_generated",
             "hnn-schnet": "HNN_generated", "hnn-latent": "LatentHNN_generated",
             "node": "NODE_generated"}


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


def _eval_generated(out_dir, family, generated, traj, extra=None,
                    generated_trajectories=None):
    """Score a generated ensemble against the training data (end-to-end
    distance per normalized-time bucket, radius of gyration) and write
    ``eval.json`` in the run directory. ``generated_trajectories`` buckets an
    ensemble of rollouts per rollout, as the data is; ``extra`` adds keys."""
    from molecular_dynamics_tpu_torch.evaluate import compare_e2e

    data_frames, _ = traj.stacked()
    generated = np.asarray(generated)
    data_frames = np.asarray(data_frames)
    # time-resolved data reference: each trajectory bucketed along its own
    # normalized time, so the generated sweep is scored against the pulling
    # profile
    metrics = compare_e2e(generated, data_frames, data_trajectories=traj.trajectories,
                          generated_trajectories=generated_trajectories)
    # radius-of-gyration statistics (uniform weights: both ensembles share
    # one topology)
    for name, ens in (("gen", generated), ("data", data_frames)):
        cen = ens - ens.mean(axis=1, keepdims=True)
        rg = np.sqrt((cen**2).sum(axis=(1, 2)) / ens.shape[1])
        metrics[f"rg_{name}_mean"] = float(rg.mean())
    metrics["rg_abs_error"] = abs(metrics["rg_gen_mean"] - metrics["rg_data_mean"])
    if extra:
        metrics.update(extra)
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


def _eval_rollout_ensemble(out_dir, family, rollouts, traj, extra=None):
    """Evaluate generated rollouts (one per data-trajectory start), pooled
    per normalized-time bucket as the data is."""
    gen_list = [np.asarray(r) for r in rollouts]
    return _eval_generated(out_dir, family, np.concatenate(gen_list), traj, extra=extra,
                           generated_trajectories=gen_list)


def _ensemble_probe_score(probes, traj, rg_data, std_w=None):
    """Spread-aware score of a probe ensemble for snapshot selection:
    ``e2e mean error + Rg error + w * e2e spread error``, the statistics
    eval.json reports, so that a probe which collapses the ensemble's
    spread does not score well on the mean path alone. ``w`` is
    ``MDX_PROBE_STD_W`` (default 0.5)."""
    from molecular_dynamics_tpu_torch.evaluate import compare_e2e, radius_of_gyration

    if std_w is None:
        std_w = float(os.environ.get("MDX_PROBE_STD_W", 0.5))
    stacked = np.concatenate(probes)
    m = compare_e2e(stacked, np.concatenate(traj.trajectories),
                    data_trajectories=traj.trajectories, generated_trajectories=probes)
    rg_err = abs(float(radius_of_gyration(stacked).mean()) - rg_data)
    return m["mean_abs_error"] + rg_err + std_w * m["std_abs_error"]


def _whitened(traj):
    """(whitened TrajectoryData, mean, std): per-feature whitening over all
    frames of all trajectories."""
    from molecular_dynamics_tpu_torch.evaluate import whiten, whiten_fit
    from molecular_dynamics_tpu_torch.train.datasets import TrajectoryData

    stacked = np.concatenate(traj.trajectories)
    mean, std = whiten_fit(stacked)
    white = TrajectoryData([whiten(t, mean, std).astype(np.float32) for t in traj.trajectories])
    return white, mean, std


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
    _export_xyz(os.path.join(out_dir, GENERATED["pretrain"] + ".xyz"), coords, names, top=top)
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
    _export_xyz(os.path.join(out_dir, GENERATED["cgan"] + ".xyz"), coords, names, top=top)
    _eval_generated(out_dir, "cgan", coords, traj)
    return g_model


# --- the Hamiltonian dynamics line -------------------------------------------


#: snapshots kept for probe selection (the last ones taken)
_MAX_SNAPSHOTS = 12


def _probe_select(family, model, snapshots, score):
    """Load into ``model`` the candidate (each snapshot, then the final
    weights) whose probe ``score()`` is lowest, the first on a tie. Final
    weights equal to the last snapshot take its score without a second
    probe run: the same choice, one probe fewer."""
    final = _clone_state(model)
    scores = []
    for state in snapshots:
        model.load_state_dict(state)
        scores.append(score())
    if snapshots and all(torch.equal(v, final[k]) for k, v in snapshots[-1].items()):
        scores.append(scores[-1])
    else:
        model.load_state_dict(final)
        scores.append(score())
    best = int(np.argmin(scores))
    model.load_state_dict((snapshots + [final])[best])
    print(f"{family} probe selection: checkpoint {best + 1}/{len(scores)}"
          f" score {scores[best]:.3f} (final-params score {scores[-1]:.3f})")


def _snapshot(snapshots, model):
    snapshots.append(_clone_state(model))
    del snapshots[:-_MAX_SNAPSHOTS]


def _segments(traj, seq_len):
    """Each trajectory's first row in the concatenated ``phase_space_pairs``
    arrays, and every start of a ``seq_len`` window that stays inside its
    trajectory (rollout starts and unroll windows never cross them)."""
    seg_lens = [len(t) - 2 for t in traj.trajectories]
    seg_starts = np.cumsum([0] + seg_lens)[:-1]
    windows = [np.arange(st, st + ln - seq_len) for st, ln in zip(seg_starts, seg_lens)
               if ln > seq_len]
    return seg_starts, (np.concatenate(windows) if windows else np.zeros(0, np.int64))


def _phase_rollouts(frames, half):
    """``(steps, R, D)`` phase-space rollouts -> R coordinate trajectories
    ``(steps, N, 3)`` (the position half), as numpy."""
    frames = frames.cpu().numpy()
    return [frames[:, r, :half].reshape(len(frames), -1, 3) for r in range(frames.shape[1])]


def _position_corrector(ff, half_dim):
    """``MDX_ROLLOUT_CORRECT``'s corrector on the position half of
    phase-space states (the velocities ride along), or None."""
    from molecular_dynamics_tpu_torch.train.seq import corrector_from_env

    pos_correct = corrector_from_env(ff, np.zeros(ff.n_atoms * 3), np.ones(ff.n_atoms * 3))
    if pos_correct is None:
        return None
    return lambda st: torch.cat([pos_correct(st[..., :half_dim]), st[..., half_dim:]], dim=-1)


def _rg_data(traj):
    from molecular_dynamics_tpu_torch.evaluate import radius_of_gyration

    return float(radius_of_gyration(np.concatenate(traj.trajectories)).mean())


def _run_hnn(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir, names,
             top, device, backbone="mlp"):
    """The HNN field (an MLP, or SchNet for ``hnn-schnet``) trained on
    phase-space differences: L2 with every 10th step potential-informed,
    then in the last quarter of the epochs a 10-step recurrent unroll (the
    cure for autoregressive drift); generation by rollouts of the field at
    dt = 1 frame, the displacement clamped to the data's dx support."""
    from molecular_dynamics_tpu_torch.models.hnn import HNN, rollout
    from molecular_dynamics_tpu_torch.train.checkpoint import save
    from molecular_dynamics_tpu_torch.train.datasets import phase_space_pairs
    from molecular_dynamics_tpu_torch.train.hnn import HNNTrainConfig, make_hnn_trainer

    x, dx = phase_space_pairs(traj)
    if backbone == "schnet":
        from molecular_dynamics_tpu_torch.models.schnet import SchNetHNN

        # Gaussian distance bases by default: the reference's bare exp(-d)
        # filter input is blind past a few Angstrom (models/schnet.py)
        model = SchNetHNN(n_atoms=ff.n_atoms, rbf=int(os.environ.get("MDX_SCHNET_RBF", 32)),
                          generator=gen, device=device)
    else:
        model = HNN(x.shape[1], hidden=(200, 200), generator=gen, device=device)
    cfg = HNNTrainConfig(seq_len=10)
    _, l2_step, informed_step, unroll_step = make_hnn_trainer(model, ff, config=cfg)
    seg_starts, seq_starts_all = _segments(traj, cfg.seq_len)
    x_d, dx_d = torch.as_tensor(x, device=device), torch.as_tensor(dx, device=device)
    window = torch.arange(cfg.seq_len, device=device)
    t0 = time.time()
    i = 0
    unroll_from = max(epochs - max(epochs // 4, 1), 1)
    if not len(seq_starts_all):  # every trajectory shorter than the unroll: no phase 2
        unroll_from = epochs
    rebased = False
    # spread-aware probe selection over the unroll phase: on by default for
    # the SchNet backbone, whose failure is the ensemble's spread, off for
    # the MLP; MDX_HNN_PROBE overrides
    probe_every = int(os.environ.get("MDX_HNN_PROBE", 50 if backbone == "schnet" else 0))
    snapshots = []
    for epoch in range(epochs):
        if epoch >= unroll_from:
            if not rebased:
                # a new loss regime (the unroll MSE): best.ckpt tracks it
                keeper.rebase()
                rebased = True
            order = rng.permutation(seq_starts_all)
            for s in range(0, len(order) - batch_size + 1, batch_size):
                sel = torch.as_tensor(order[s: s + batch_size], device=device)
                loss = unroll_step(x_d[sel], dx_d[sel[:, None] + window])
                i += 1
                if i % 10 == 0:
                    _log(logger, curves, keeper, model, epoch, i, loss, t0)
                if probe_every and i % probe_every == 0:
                    _snapshot(snapshots, model)
                if i >= 200 * (epoch + 1):
                    break
            if probe_every:
                # epoch-end snapshot: with large batches an epoch is a few
                # updates and i % probe_every may never fire
                _snapshot(snapshots, model)
            continue
        order = rng.permutation(len(x))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            sel = torch.as_tensor(order[s: s + batch_size], device=device)
            if i % cfg.potential_every == cfg.potential_every - 1:
                loss, _ = informed_step(x_d[sel], dx_d[sel])
            else:
                loss = l2_step(x_d[sel], dx_d[sel])
            i += 1
            if i % 10 == 0:
                _log(logger, curves, keeper, model, epoch, i, loss, t0)
            if i >= 200 * (epoch + 1):
                break  # a bounded epoch on a large dataset
    # rollouts over the data's normalized-time span: the field predicts the
    # per-frame difference, so dt = 1 frame; one rollout per trajectory
    # start (each a row of one batched rollout), the displacement clamped
    roll_len = int(np.mean([len(t) for t in traj.trajectories]))
    max_step = float(np.quantile(np.abs(dx), 0.999)) * 2.0
    half = x.shape[1] // 2
    if probe_every and snapshots:
        rg_data = _rg_data(traj)

        def probe_score():
            fr = rollout(model, x_d[seg_starts[:3]], n_steps=roll_len, dt=1.0,
                         max_step=max_step)
            return _ensemble_probe_score(_phase_rollouts(fr, half), traj, rg_data)

        _probe_select("hnn", model, snapshots, probe_score)
    frames = rollout(model, x_d[seg_starts[:8]], n_steps=roll_len, dt=1.0, max_step=max_step,
                     corrector=_position_corrector(ff, half))
    rolls = _phase_rollouts(frames, half)
    tag = "hnn-schnet" if backbone == "schnet" else "hnn"
    _export_xyz(os.path.join(out_dir, GENERATED[tag] + ".xyz"), rolls[0], names, top=top)
    _eval_rollout_ensemble(out_dir, tag, rolls, traj)
    # best.ckpt holds the weights eval.json scores (the probe's choice), not
    # the keeper's lowest-loss snapshot
    save(os.path.join(out_dir, "best.ckpt"), model)
    return model


def _node_frame(field, x, dt, sub, max_step, lo, hi):
    """One generated frame: ``sub`` RK4 substeps of ``dt / sub``, each
    displacement clamped to ``max_step`` and the state to ``[lo, hi]``,
    the map ``rk4_rollout`` applies at generation time."""
    from molecular_dynamics_tpu_torch.models.node import rk4_step

    for _ in range(sub):
        xn = rk4_step(field, x, 0.0, dt / sub)
        xn = x + torch.clamp(xn - x, -max_step, max_step)
        x = torch.clamp(xn, lo, hi)
    return x


def _node_step_loss(model, xb, dxb, dt=1.0):
    """One RK4 step through the HNN field: x(t + dt) against x + dx."""
    from molecular_dynamics_tpu_torch.models.node import hnn_field, rk4_step

    pred = rk4_step(hnn_field(model), xb, 0.0, dt)
    return torch.mean((pred - (xb + dxb)) ** 2)


def _node_unroll_loss(model, x0b, xseq, dt, sub, max_step, lo, hi):
    """The chained-solver fine-tune: ``xseq.shape[1]`` generated frames
    (``_node_frame``) from ``x0b``, each against the data's next state,
    differentiable through every frame."""
    from molecular_dynamics_tpu_torch.models.node import hnn_field

    field = hnn_field(model)
    xc, losses = x0b, []
    for s in range(xseq.shape[1]):
        xc = _node_frame(field, xc, dt, sub, max_step, lo, hi)
        losses.append(torch.mean((xc - xseq[:, s]) ** 2))
    return torch.mean(torch.stack(losses))


def _run_node(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir, names,
              top, device):
    """Neural ODE on phase-space data: an HNN vector field trained through
    an RK4 step, then (last quarter of the epochs) through a chain of
    ``MDX_NODE_SEQ`` clamped generated frames, with probe selection over
    that phase (``MDX_NODE_PROBE``); generation by clamped RK4 rollouts."""
    from molecular_dynamics_tpu_torch.models.hnn import HNN
    from molecular_dynamics_tpu_torch.models.node import hnn_field, rk4_rollout
    from molecular_dynamics_tpu_torch.train.checkpoint import save
    from molecular_dynamics_tpu_torch.train.common import ClippedAdam, descend
    from molecular_dynamics_tpu_torch.train.datasets import TrajectoryData, phase_space_pairs

    # full frame resolution by default: strided frames make the
    # finite-difference field coarser and noisier
    stride = int(os.environ.get("MDX_NODE_STRIDE", 1))
    if stride > 1:
        traj = TrajectoryData([t[::stride] for t in traj.trajectories])
    x, dx = phase_space_pairs(traj)
    model = HNN(x.shape[1], hidden=(200, 200), generator=gen, device=device)
    opt = ClippedAdam(model.parameters(), lr=1e-3, clip_norm=1.0)
    dt = 1.0  # frame units: dx is the per-frame finite difference
    seq_len = int(os.environ.get("MDX_NODE_SEQ", 10))
    seg_starts, seq_starts_all = _segments(traj, seq_len)
    # the generation map's constants, which the fine-tune trains through:
    # the displacement clamped to the data's dx support, the state to its
    # box, MDX_NODE_SUB RK4 substeps a frame (1 at full resolution)
    max_step = float(np.quantile(np.abs(dx), 0.999)) * 2.0
    lo = torch.as_tensor(x.min(axis=0) - 1.0, device=device)
    hi = torch.as_tensor(x.max(axis=0) + 1.0, device=device)
    sub = int(os.environ.get("MDX_NODE_SUB", 1))
    x_d, dx_d = torch.as_tensor(x, device=device), torch.as_tensor(dx, device=device)
    window = torch.arange(1, seq_len + 1, device=device)
    t0 = time.time()
    i = 0
    unroll_from = max(epochs - max(epochs // 4, 1), 1)
    rebased = False
    # probe-rollout snapshot selection over the fine-tune, whose endpoint is
    # sensitive to gradient noise (MDX_NODE_PROBE=0 keeps the final weights)
    probe_every = int(os.environ.get("MDX_NODE_PROBE", 50))
    snapshots = []
    for epoch in range(epochs):
        if epoch >= unroll_from and len(seq_starts_all):
            if not rebased:
                keeper.rebase()  # a new loss regime (chained-solver MSE)
                rebased = True
            order = rng.permutation(seq_starts_all)
            for s in range(0, len(order) - batch_size + 1, batch_size):
                sel = torch.as_tensor(order[s: s + batch_size], device=device)
                loss = _node_unroll_loss(model, x_d[sel], x_d[sel[:, None] + window], dt, sub,
                                         max_step, lo, hi)
                descend(opt, loss)
                i += 1
                if i % 10 == 0:
                    _log(logger, curves, keeper, model, epoch, i, loss.detach(), t0)
                if probe_every and i % probe_every == 0:
                    _snapshot(snapshots, model)
                if i >= 200 * (epoch + 1):
                    break
            if probe_every:
                _snapshot(snapshots, model)  # epoch-end snapshot (see _run_hnn)
            continue
        order = rng.permutation(len(x))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            sel = torch.as_tensor(order[s: s + batch_size], device=device)
            loss = _node_step_loss(model, x_d[sel], dx_d[sel], dt)
            descend(opt, loss)
            i += 1
            if i % 10 == 0:
                _log(logger, curves, keeper, model, epoch, i, loss.detach(), t0)
            if i >= 200 * (epoch + 1):
                break
    roll_len = int(np.mean([len(t) for t in traj.trajectories]))
    half = x.shape[1] // 2

    def generate(starts, n_frames, corrector=None):
        frames = rk4_rollout(hnn_field(model, create_graph=False), x_d[starts],
                             n_steps=n_frames * sub, dt=dt / sub, max_step=max_step,
                             state_bounds=(lo, hi), corrector=corrector)
        return _phase_rollouts(frames[sub - 1:: sub], half)

    if probe_every and snapshots:
        # probes run the full rollout horizon: shorter ones favour
        # checkpoints that drift late
        rg_data = _rg_data(traj)
        _probe_select("node", model, snapshots, lambda: _ensemble_probe_score(
            generate(seg_starts[:3], max(roll_len, 2)), traj, rg_data))
    rolls = generate(seg_starts[:8], roll_len, _position_corrector(ff, half))
    _export_xyz(os.path.join(out_dir, GENERATED["node"] + ".xyz"), rolls[0], names, top=top)
    _eval_rollout_ensemble(out_dir, "node", rolls, traj)
    save(os.path.join(out_dir, "best.ckpt"), model)
    return model


def _latent_hnn_loss(model, xb, xb1, lam, zreg):
    """The latent HNN's loss on whitened frame pairs (x_t, x_t+1): AE
    reconstruction + the decoded next frame through one latent Euler step
    z + f(z) + ``lam`` x a latent-consistency term against encode(x_t+1)
    + ``zreg`` x an L2 on z that pins the latent gauge. The consistency
    term differentiates its target too: a one-sided "dynamics chases the
    encoder" form drifts along the AE's free affine reparameterisation
    until |z| runs away."""
    from molecular_dynamics_tpu_torch.models.hnn import time_derivative

    recon, z = model.ae(xb)
    z1 = model.encode(xb1)
    z1_pred = z + time_derivative(model.hnn, z)
    x1_pred = model.decode(z1_pred)
    return (torch.mean((recon - xb) ** 2) + torch.mean((x1_pred - xb1) ** 2)
            + lam * torch.mean((z1_pred - z1) ** 2) + zreg * torch.mean(z ** 2))


def _latent_unroll_loss(model, xb, tgt, max_step):
    """The latent fine-tune: encode each start once, ``tgt.shape[1]``
    clamped latent Euler steps, decode each against the next frames."""
    from molecular_dynamics_tpu_torch.models.hnn import time_derivative

    zc, zs = model.encode(xb), []
    for _ in range(tgt.shape[1]):
        zc = zc + torch.clamp(time_derivative(model.hnn, zc), -max_step, max_step)
        zs.append(zc)
    return torch.mean((model.decode(torch.stack(zs, dim=1)) - tgt) ** 2)


def _run_hnn_latent(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir,
                    names, top, device):
    """PixelHNN: autoencode whitened frames to a small latent phase space,
    learn Hamiltonian dynamics there, generate by latent rollout + decode.
    Knobs: MDX_LHNN_LATENT (16, even), MDX_LHNN_LAT_W (consistency weight),
    MDX_LHNN_ZREG (latent L2), MDX_LHNN_CLIP (the global-norm clip, which
    keeps the inner HNN's grad-of-grad surface from diverging),
    MDX_LHNN_PROBE (probe-selection cadence in epochs), MDX_LHNN_FT_*
    (a latent-unroll fine-tune, off by default: a measured reject on the
    backbone data)."""
    from molecular_dynamics_tpu_torch.evaluate import unwhiten
    from molecular_dynamics_tpu_torch.models.autoencoder import LatentHNN
    from molecular_dynamics_tpu_torch.models.hnn import rollout
    from molecular_dynamics_tpu_torch.train.checkpoint import save
    from molecular_dynamics_tpu_torch.train.common import ClippedAdam, descend

    n = ff.n_atoms
    feat = n * 3
    raw_traj = traj
    traj, w_mean, w_std = _whitened(traj)
    model = LatentHNN(in_dim=feat, latent_dim=int(os.environ.get("MDX_LHNN_LATENT", 16)),
                      generator=gen, device=device)
    opt = ClippedAdam(model.parameters(), lr=1e-3,
                      clip_norm=float(os.environ.get("MDX_LHNN_CLIP", 1.0)))
    flats = [t.reshape(len(t), feat) for t in traj.trajectories]
    x0 = np.concatenate([f[:-1] for f in flats]).astype(np.float32)
    x1 = np.concatenate([f[1:] for f in flats]).astype(np.float32)
    x0_d, x1_d = torch.as_tensor(x0, device=device), torch.as_tensor(x1, device=device)
    lam = float(os.environ.get("MDX_LHNN_LAT_W", 1.0))
    zreg = float(os.environ.get("MDX_LHNN_ZREG", 1e-3))
    # epoch-end snapshots scored by probe rollouts through the generation
    # map (MDX_LHNN_PROBE=0 disables)
    probe_every_ep = int(os.environ.get("MDX_LHNN_PROBE", 4))
    snapshots = []
    t0 = time.time()
    i = 0
    for epoch in range(epochs):
        order = rng.permutation(len(x0))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            sel = torch.as_tensor(order[s: s + batch_size], device=device)
            loss = _latent_hnn_loss(model, x0_d[sel], x1_d[sel], lam, zreg)
            descend(opt, loss)
            i += 1
            if i % 10 == 0:
                _log(logger, curves, keeper, model, epoch, i, loss.detach(), t0)
            if i >= 200 * (epoch + 1):
                break  # a bounded epoch, as _run_hnn's
        if probe_every_ep and (epoch + 1) % probe_every_ep == 0:
            _snapshot(snapshots, model)

    def latent_step_clamp():
        """The collapse guard of the generation map: twice the 99.9 %
        quantile of |encode(x_t+1) - encode(x_t)| under the current
        encoder."""
        with torch.no_grad():
            dz = (model.encode(x1_d) - model.encode(x0_d)).abs().cpu().numpy()
        return float(np.quantile(dz, 0.999)) * 2.0

    ft_w = int(os.environ.get("MDX_LHNN_FT_W", 8))
    ft_epochs = int(os.environ.get("MDX_LHNN_FT_EPOCHS", 0))
    if ft_epochs > 0 and ft_w > 1:
        w0l, wtl = [], []
        for flat in flats:
            for s in range(0, len(flat) - 1 - ft_w, max(1, ft_w // 2)):
                w0l.append(flat[s])
                wtl.append(flat[s + 1: s + 1 + ft_w])
        w0a = torch.as_tensor(np.stack(w0l).astype(np.float32), device=device)
        wta = torch.as_tensor(np.stack(wtl).astype(np.float32), device=device)
        ft_ms = latent_step_clamp()  # from the encoder before the fine-tune
        keeper.rebase()  # the rollout-MSE regime
        ft_opt = ClippedAdam(model.parameters(), lr=float(os.environ.get("MDX_LHNN_FT_LR", 1e-4)),
                             clip_norm=1.0)
        ft_bs = max(4, batch_size // 2)
        for epoch in range(ft_epochs):
            order = rng.permutation(len(w0a))
            for s in range(0, len(order) - ft_bs + 1, ft_bs):
                sel = torch.as_tensor(order[s: s + ft_bs], device=device)
                loss = _latent_unroll_loss(model, w0a[sel], wta[sel], ft_ms)
                descend(ft_opt, loss)
                i += 1
                if i % 10 == 0:
                    _log(logger, curves, keeper, model, epochs + epoch, i, loss.detach(), t0)
                if i >= 200 * (epochs + epoch + 1):
                    break

    # latent rollouts from each trajectory's first frame, decoded; the
    # latent step clamped under the candidate's own encoder
    roll_len = int(np.mean([len(t) for t in traj.trajectories]))

    def latent_rolls(n_rolls):
        ms = latent_step_clamp()
        starts = torch.as_tensor(np.stack([f[0] for f in flats[:n_rolls]]), device=device)
        with torch.no_grad():
            zs = rollout(model.hnn, model.encode(starts), n_steps=roll_len, dt=1.0, max_step=ms)
            frames = model.decode(zs).cpu().numpy()  # (roll_len, R, feat)
        return [unwhiten(frames[:, r].reshape(-1, n, 3), w_mean, w_std)
                for r in range(frames.shape[1])]

    if probe_every_ep and snapshots:
        rg_data = _rg_data(raw_traj)
        _probe_select("hnn-latent", model, snapshots,
                      lambda: _ensemble_probe_score(latent_rolls(3), raw_traj, rg_data))
    rolls = latent_rolls(8)
    _export_xyz(os.path.join(out_dir, GENERATED["hnn-latent"] + ".xyz"), rolls[0], names, top=top)
    _eval_rollout_ensemble(out_dir, "hnn-latent", rolls, raw_traj)
    save(os.path.join(out_dir, "best.ckpt"), model)
    return model


_FAMILIES = {
    "pretrain": _run_pretrain,
    "cgan": _run_cgan,
    "hnn": _run_hnn,
    "hnn-schnet": lambda **kw: _run_hnn(backbone="schnet", **kw),
    "hnn-latent": _run_hnn_latent,
    "node": _run_node,
}
