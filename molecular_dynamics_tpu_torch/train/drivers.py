"""End-to-end training drivers (``cli train``).

Load or generate trajectories, build the family's model and update steps,
run epochs with CSV logging, best-checkpoint keeping and loss plots, and
emit generated ``.xyz`` / ``.pdb`` trajectories and an ``eval.json`` at the
end. Ported families: ``pretrain`` (the decoder's pretraining), ``cgan``
(pretrain, then the three-phase physics-informed GAN); the Hamiltonian
dynamics line: ``hnn`` and ``hnn-schnet`` (an HNN field, MLP or SchNet,
trained on phase-space differences, then through a recurrent unroll),
``hnn-latent`` (an HNN in an autoencoder's latent phase space) and ``node``
(the HNN field trained through an RK4 solver); and the sequence and graph
line: ``lstm`` and ``transformer`` (next-frame windows, then an unrolled
fine-tune through the rollout map), ``lstm-nll`` (a Gaussian head, sampled
rollouts), ``seq2seq`` and ``seq2seq-gan`` (noise-fed decoders, the second
against an LSTM critic, chained decodes), ``gat`` (a GNS acceleration
model with input noise and an unrolled fine-tune), ``lstm-gat`` (per-atom
LSTM + GAT, a clamped unrolled fine-tune) and ``seq2seq-graph`` (per-atom
Seq2Seq with GAT refinement, torsion channels rebuilt from each decoded
segment, a chained fine-tune), each generating by rollout from the data
trajectories' starts, as rows of one batched rollout; and the generative
line: ``flow`` (a conditional RealNVP on min-max scaled frames, sampled
along the normalized time), ``vae`` (a time-bucket conditional VAE on
whitened frames, one decode a bucket), ``aae`` (an adversarial autoencoder
with a time-conditioned decoder and evaluator-probed snapshots) and ``sde``
(a neural SDE-GAN on 8-frame path windows: a gradient-penalised CDE critic,
moment matching, potential injection, weight averaging and marginal-TV
probed snapshots). These are all the reference's families.
``devices=N`` (``--devices N``) trains ``pretrain``, ``cgan``, ``lstm`` or
``lstm-nll`` data-parallel on N ranks (``parallel.data``): every rank
draws the global batch and keeps its rows, the models are wrapped in
``DistributedDataParallel``, the logged loss is the global batch's mean,
and rank 0 alone writes the run's files.

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

#: the stem of the generated trajectory each family writes (``.xyz``, and a
#: ``.pdb`` beside it), the reference's file names
GENERATED = {"pretrain": "pretrain_generated", "cgan": "cGAN_generated", "hnn": "HNN_generated",
             "hnn-schnet": "HNN_generated", "hnn-latent": "LatentHNN_generated",
             "node": "NODE_generated", "lstm": "LSTM_generated", "lstm-nll": "LSTMNLL_generated",
             "seq2seq": "Seq2Seq_generated", "transformer": "Transformer_generated",
             "gat": "GAT_generated", "seq2seq-gan": "Seq2SeqGAN_generated",
             "lstm-gat": "LSTMGAT_generated", "seq2seq-graph": "Seq2SeqGraph_generated",
             "flow": "cFlow_generated", "vae": "VAE_generated", "aae": "AAE_generated",
             "sde": "SDE_generated"}


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


#: the families ``devices`` above 1 trains data-parallel (the JAX package's)
_DP_FAMILIES = {"pretrain", "cgan", "lstm", "lstm-nll"}


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
    device seeded with ``seed``.

    ``devices`` above 1 runs that many data-parallel ranks (``spawn``): NCCL
    on ``cuda:0 ... cuda:N-1``, or gloo on the CPU with ``device="cpu"``. It
    raises ``ValueError`` for a batch size it does not divide (lstm: nor
    its fine-tune batch, ``_finetune_batch``), a family outside
    ``_DP_FAMILIES`` or fewer visible CUDA devices, before any rank starts;
    a rank's exception raises here."""
    from molecular_dynamics_tpu_torch.convert import resolve_device

    if family not in _FAMILIES:
        raise ValueError(f"unknown family {family!r}")
    kwargs = dict(family=family, data=data, data_stride=data_stride, topology=topology,
                  parameters=parameters, epochs=epochs, batch_size=batch_size,
                  out_dir=out_dir, seed=seed)
    if devices and devices > 1:
        from molecular_dynamics_tpu_torch.parallel.data import rank_devices, spawn

        if batch_size % devices:
            raise ValueError(
                f"batch_size {batch_size} must be divisible by the device count {devices}")
        if family not in _DP_FAMILIES:
            raise ValueError(
                f"family {family!r} trains on one device; --devices shards batches for "
                f"{', '.join(sorted(_DP_FAMILIES))} only")
        if family == "lstm" and _finetune_batch(batch_size) % devices:
            raise ValueError(
                f"the lstm fine-tune's batch of max(4, batch_size // 2) = "
                f"{_finetune_batch(batch_size)} rows must be divisible by the device count "
                f"{devices}")
        ranks = rank_devices(devices, device)
        if not data:
            # one dataset for every rank, made once, here
            from molecular_dynamics_tpu_torch.cli import _load_system

            ff, coords, _, _ = _load_system(topology, parameters, device=ranks[0])
            root = os.path.join(out_dir, family, "data")
            _bootstrap_dataset(ff, coords, root, device=ranks[0])
            kwargs.update(data=os.path.join(root, "raw-traj_rep-*.npy"), data_stride=1)
        spawn(_train_rank, devices, devices=ranks, args=(kwargs,))
        return 0
    return _train(device=resolve_device(device), **kwargs)


def _train_rank(dp, kwargs):
    """One rank of a data-parallel ``run_training``."""
    _train(device=dp.device, dp=dp, **kwargs)


class _Quiet:
    """The logger and the best-checkpoint keeper of a data-parallel rank
    other than 0: it writes nothing."""

    best = float("inf")

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def _writes(dp) -> bool:
    """Whether this process writes the run's files (rank 0 of a
    data-parallel run, or a run of one process)."""
    return dp is None or dp.writer


def _train(family, data, data_stride, topology, parameters, epochs, batch_size, out_dir,
           seed, device, dp=None) -> int:
    from molecular_dynamics_tpu_torch.cli import _device, _load_system
    from molecular_dynamics_tpu_torch.log import CSVLogger, plot_losses
    from molecular_dynamics_tpu_torch.train.checkpoint import BestKeeper
    from molecular_dynamics_tpu_torch.train.datasets import TrajectoryData

    device = _device(device)
    out_dir = os.path.join(out_dir, family)
    writes = _writes(dp)
    if writes:
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

    if writes:
        logger = CSVLogger(os.path.join(out_dir, "train_log.csv"),
                           ["epoch", "step", "loss", "wall_s"])
        keeper = BestKeeper(os.path.join(out_dir, "best.ckpt"))
    else:
        logger = keeper = _Quiet()
    curves = {"loss": []}
    t_start = time.time()
    _FAMILIES[family](
        ff=ff, traj=traj, epochs=epochs, batch_size=batch_size, rng=rng, gen=gen,
        logger=logger, keeper=keeper, curves=curves, out_dir=out_dir, names=names,
        top=top, device=device, **({} if dp is None else {"dp": dp}),
    )
    if not writes:
        return 0
    plot_losses(os.path.join(out_dir, "loss.png"), curves, title=family)
    logger.close()
    ranks = "" if dp is None else f" on {dp.world} data-parallel ranks"
    print(
        f"{family}: {epochs} epochs in {time.time() - t_start:.1f}s{ranks}, "
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


def _rows(dp, *arrays):
    """This rank's rows of each array (all of them without ``dp``)."""
    return arrays if dp is None else tuple(dp.rows(a) for a in arrays)


def _global(dp, loss):
    """The global batch's loss from this rank's (a collective: every rank
    calls it at the same step)."""
    return loss if dp is None else dp.mean(loss)


def _pretrain_generator(model, ff, traj, epochs, batch_size, rng, gen, logger, keeper,
                        curves, t0=None, dp=None, forward=None):
    """The shared decoder-pretrain loop, in place on ``model`` (through
    ``forward``, its data-parallel wrapper, where one is given).

    lr 1e-3: at the reference's 1e-4 + clip 1.0 the decoder needs about
    10k steps to reach the data's coordinate scale. The potential
    curriculum is capped at 1e-2: the raw potential (about 1e3 kcal/mol)
    would otherwise drown the O(1) geometric losses. Returns the step count.
    """
    from molecular_dynamics_tpu_torch.train.cgan import PretrainStep
    from molecular_dynamics_tpu_torch.train.datasets import frame_time_batches

    step = PretrainStep(model if forward is None else forward, ff, lr=1e-3)
    device = gen.device
    t0 = time.time() if t0 is None else t0
    i = 0
    for epoch in range(epochs):
        alpha = 0.01 * min(1.0, epoch / max(epochs - 1, 1))
        for frames, times in frame_time_batches(traj, batch_size, rng):
            z = _latents(gen, len(times), model.latent_dim)
            frames, times, z = _rows(dp, frames, times, z)
            loss, _ = step(z, torch.as_tensor(frames, device=device),
                           torch.as_tensor(times, device=device), alpha)
            i += 1
            if i % 10 == 0:
                _log(logger, curves, keeper, model, epoch, i, _global(dp, loss), t0)
    return i


def _run_pretrain(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir,
                  names, top, device, dp=None):
    from molecular_dynamics_tpu_torch.models.cgan import Generator

    model = Generator(n_atoms=ff.n_atoms, generator=gen, device=device)
    _pretrain_generator(model, ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves,
                        dp=dp, forward=None if dp is None else dp.wrap(model))
    if not _writes(dp):
        return model
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
              names, top, device, dp=None):
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
    # one data-parallel wrapper a module, shared by every phase that steps it
    g_fwd, d_fwd = (g_model, d_model) if dp is None else (dp.wrap(g_model), dp.wrap(d_model))
    trainer = CGANTrainer(g_fwd, d_fwd, ff, bias=bias, config=cfg)
    t0 = time.time()
    # phase 1: decoder pretrain (a GAN from a random decoder collapses: the
    # informed phase sees astronomic LJ). The keeper is not rebased after
    # it, as in the reference driver.
    i = _pretrain_generator(g_model, ff, traj, max(epochs, 4), batch_size, rng, gen, logger,
                            keeper, curves, t0=t0, dp=dp, forward=g_fwd)
    # phase 2: the three-phase adversarial + informed loop (the trainer's
    # optimizers have taken no step yet), the final generator the
    # physics-best (lowest informed loss) probe, not the last iterate
    best_i, best_state = float("inf"), _clone_state(g_model)
    for epoch in range(epochs):
        for frames, times in frame_time_batches(traj, batch_size, rng):
            n_b = len(times)
            fr_b, t_b = (torch.as_tensor(a, device=device) for a in _rows(dp, frames, times))
            trainer.g_step(*_rows(dp, _latents(gen, n_b, g_model.latent_dim)), t_b)
            trainer.d_step(*_rows(dp, _latents(gen, n_b, g_model.latent_dim)), fr_b, t_b)
            i_loss = trainer.informed_step(
                *_rows(dp, _latents(gen, n_b, g_model.latent_dim)), t_b)
            i += 1
            if i % 10 == 0:
                # a host synchronisation, so the best-generator probe shares
                # the logging cadence instead of blocking every batch; the
                # global loss, so that every rank takes the same rollback
                i_loss = _global(dp, i_loss)
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
    if not _writes(dp):
        return g_model
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


# --- the sequence and graph line ---------------------------------------------


def _noise(gen, shape):
    """Standard normal training noise of ``shape`` from the run's generator
    (decoder inputs, the GNS input noise, the generative line's latents,
    reparameterisation draws and SDE paths): every training draw of the
    sequence line, and every draw of the generative line, goes through
    here or ``_uniform``; the sequence line's rollouts draw their own."""
    return torch.randn(shape, generator=gen, device=gen.device)


def _uniform(gen, shape):
    """Uniform [0, 1) draws of ``shape`` from the run's generator (the
    gradient penalty's interpolation weights)."""
    return torch.rand(shape, generator=gen, device=gen.device)


def _epochs(epochs, batches, update, logger, curves, keeper, model, t0, i=0, epoch0=0,
            epoch_end=None, dp=None):
    """The shared update loop: ``update(*batch)`` for each batch of
    ``batches()``, a log row every 10 updates at epoch ``epoch0 + epoch``
    (the global batch's loss under ``dp``), then ``epoch_end(epoch)``.
    Returns the update count."""
    for epoch in range(epochs):
        for batch in batches():
            loss = update(*batch)
            i += 1
            if i % 10 == 0:
                _log(logger, curves, keeper, model, epoch0 + epoch, i, _global(dp, loss), t0)
        if epoch_end is not None:
            epoch_end(epoch)
    return i


def _shuffled(rng, n, batch_size, device):
    """Index tensors of the full batches of one ``rng`` permutation of ``n``."""
    order = rng.permutation(n)
    for s in range(0, len(order) - batch_size + 1, batch_size):
        yield (torch.as_tensor(order[s: s + batch_size], device=device),)


def _finetune(model, keeper, rng, arrays, loss_fn, batch_size, ft_epochs, epochs, i, t0, logger,
              curves, lr=2e-5, dp=None):
    """An unrolled fine-tune: a new loss regime (``keeper.rebase()``), a
    fresh ``ClippedAdam`` (``lr``, clip 1.0), shuffled batches of ``max(4,
    batch_size // 2)`` rows of ``arrays`` (tensors on the device) into
    ``loss_fn``, ``ft_epochs`` epochs logged after the ``epochs`` base ones.
    Under ``dp`` each rank takes its block of every batch (``loss_fn`` then
    runs the model's data-parallel wrapper). Returns the update count."""
    from molecular_dynamics_tpu_torch.train.common import ClippedAdam, stepper

    keeper.rebase()
    opt = ClippedAdam(model.parameters(), lr=lr, clip_norm=1.0, backward=dp is not None)
    update = stepper(opt, lambda sel: loss_fn(*(a[sel] for a in arrays)))
    ft_bs = _finetune_batch(batch_size)
    return _epochs(ft_epochs, lambda: (
        _rows(dp, *sel) for sel in _shuffled(rng, len(arrays[0]), ft_bs, arrays[0].device)),
                   update, logger, curves, keeper, model, t0, i=i, epoch0=epochs, dp=dp)


def _finetune_batch(batch_size):
    """The unrolled fine-tune's batch rows."""
    return max(4, batch_size // 2)


def _window_unroll_loss(model, w0, tgt):
    """The window rollout map, differentiable: ``tgt.shape[1]`` predictions
    each shifted into ``w0 (B, T, F)``, their MSE against ``tgt (B, W, F)``."""
    w, preds = w0, []
    for _ in range(tgt.shape[1]):
        pred = model(w)
        w = torch.cat([w[:, 1:], pred[:, None]], dim=1)
        preds.append(pred)
    return torch.mean((torch.stack(preds, dim=1) - tgt) ** 2)


def _windows_ahead(arrays, history, ahead, transpose=False):
    """Fine-tune rows: for each ``(T, ...)`` array, a ``history`` window and
    the ``ahead`` frames after it, every ``ahead // 2`` frames, as two lists
    (``transpose`` puts each window's atoms first; the targets stay time
    first)."""
    w0, tgt = [], []
    for arr in arrays:
        for s in range(0, len(arr) - history - ahead, max(1, ahead // 2)):
            win = arr[s: s + history]
            w0.append(win.transpose(1, 0, 2) if transpose else win)
            tgt.append(arr[s + history: s + history + ahead])
    return w0, tgt


def _window_rollout_finetune(model, traj, history, feat, rng, i, t0, epochs, batch_size,
                             logger, curves, keeper, env_prefix, ft_w_default=8,
                             ft_epochs_default=4, dp=None, forward=None):
    """Unrolled fine-tune through the exact window-shift rollout map (lstm,
    transformer): ``<PREFIX>_FT_W``-frame rollouts against the true future
    frames, ``<PREFIX>_FT_EPOCHS`` epochs at lr 2e-5, so that compounding
    drift is penalised directly (data-parallel under ``dp``, through
    ``forward``). Returns the update count."""
    ft_w = int(os.environ.get(env_prefix + "_FT_W", ft_w_default))
    ft_epochs = int(os.environ.get(env_prefix + "_FT_EPOCHS", ft_epochs_default))
    if ft_epochs <= 0 or ft_w <= 1:
        return i
    fw0, ftg = _windows_ahead([t.reshape(len(t), feat) for t in traj.trajectories], history, ft_w)
    if not fw0:
        return i
    device = next(model.parameters()).device
    arrays = [torch.as_tensor(np.stack(a).astype(np.float32), device=device) for a in (fw0, ftg)]
    fwd = model if forward is None else forward
    return _finetune(model, keeper, rng, arrays, lambda w, t: _window_unroll_loss(fwd, w, t),
                     batch_size, ft_epochs, epochs, i, t0, logger, curves, dp=dp)


def _start_windows(traj, history, device, n=8, flat=True):
    """The first ``history`` frames of the first ``n`` trajectories as rows
    ``(R, history, F)`` (``flat``) or ``(R, history, N, 3)``."""
    starts = [t[:history].reshape(history, -1) if flat else t[:history]
              for t in traj.trajectories[:n]]
    return torch.as_tensor(np.stack(starts), device=device)


def _unwhitened_rows(frames, n_atoms, w_mean, w_std):
    """Rollout frames ``(T, R, ...)`` -> R coordinate trajectories ``(T, N,
    3)`` in Angstrom."""
    from molecular_dynamics_tpu_torch.evaluate import unwhiten

    frames = frames.cpu().numpy()
    return [unwhiten(frames[:, r].reshape(len(frames), n_atoms, 3), w_mean, w_std)
            for r in range(frames.shape[1])]


def _roll_len(traj):
    """Rollouts span the data's normalized time: the mean trajectory length."""
    return int(np.mean([len(t) for t in traj.trajectories]))


def _torsion_tables(ff, top):
    """phi / psi index tables from the topology's backbone names, else the
    force field's first dihedrals (a quarter of the atoms each)."""
    from molecular_dynamics_tpu_torch.features import phi_psi_indices

    phi_idx, psi_idx = phi_psi_indices(top)
    if not len(phi_idx) or not len(psi_idx):
        m = max(1, ff.n_atoms // 4)
        dihedrals = ff.dihedrals.cpu().numpy()
        phi_idx, psi_idx = dihedrals[:m], dihedrals[m:][:m]
    return phi_idx, psi_idx


def _run_lstm(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir, names,
              top, device, nll=False, dp=None):
    """Windowed LSTM (history 15): the composite next-frame loss at lead 2,
    then the unrolled fine-tune (``MDX_LSTM_FT_*``); or, for ``lstm-nll``,
    the Gaussian NLL at lead 1 (each sample is fed back as the immediate
    successor) and sampled rollouts. ``MDX_LSTM_PROBE=k`` snapshots every k
    epochs and keeps the one whose probe rollouts score best (``lstm``
    only)."""
    import warnings

    from molecular_dynamics_tpu_torch.models.seq import LSTMNLLPredictor, LSTMPredictor
    from molecular_dynamics_tpu_torch.train.checkpoint import save
    from molecular_dynamics_tpu_torch.train.datasets import window_batches
    from molecular_dynamics_tpu_torch.train.seq import (
        SeqTrainConfig, autoregressive_rollout, corrector_from_env, make_nll_trainer,
        make_window_trainer, nll_sampling_rollout)

    n = ff.n_atoms
    feat = n * 3
    history, lead = 15, (1 if nll else 2)
    raw_traj = traj
    traj, w_mean, w_std = _whitened(traj)
    if nll:
        model = LSTMNLLPredictor(feat, feat, generator=gen, device=device)
        fwd = model if dp is None else dp.wrap(model)
        _, step = make_nll_trainer(fwd)
    else:
        model = LSTMPredictor(feat, feat, generator=gen, device=device)
        fwd = model if dp is None else dp.wrap(model)
        phi_idx, psi_idx = _torsion_tables(ff, top)
        _, step = make_window_trainer(fwd, phi_idx, psi_idx, SeqTrainConfig(n_atoms=n))
    probe_every_ep = int(os.environ.get("MDX_LSTM_PROBE", 0))
    if probe_every_ep and nll:
        warnings.warn("MDX_LSTM_PROBE is ignored by lstm-nll: it keeps its final weights "
                      "(probe selection scores deterministic rollouts)", stacklevel=2)
        probe_every_ep = 0
    snapshots = []

    def batches():
        for window, target in window_batches(traj, history, lead, batch_size, rng):
            window, target = _rows(dp, window, target)
            yield torch.as_tensor(window, device=device), torch.as_tensor(target, device=device)

    def epoch_end(epoch):
        if probe_every_ep and (epoch + 1) % probe_every_ep == 0:
            _snapshot(snapshots, model)

    t0 = time.time()
    i = _epochs(epochs, batches, step, logger, curves, keeper, model, t0, epoch_end=epoch_end,
                dp=dp)
    if not nll:
        i = _window_rollout_finetune(model, traj, history, feat, rng, i, t0, epochs, batch_size,
                                     logger, curves, keeper, env_prefix="MDX_LSTM", dp=dp,
                                     forward=fwd)
    if not _writes(dp):
        return model
    roll_len = _roll_len(traj)
    correct = corrector_from_env(ff, w_mean, w_std)
    starts = _start_windows(traj, history, device)

    def rolls(k):
        if nll:
            frames = nll_sampling_rollout(model, starts[:k], roll_len, generator=gen,
                                          corrector=correct)
        else:
            frames = autoregressive_rollout(model, starts[:k], roll_len, corrector=correct)
        return _unwhitened_rows(frames, n, w_mean, w_std)

    if probe_every_ep and snapshots:
        # probes through the exact generation map, corrector included
        rg_data = _rg_data(raw_traj)
        _probe_select("lstm", model, snapshots,
                      lambda: _ensemble_probe_score(rolls(3), raw_traj, rg_data))
    tag = "lstm-nll" if nll else "lstm"
    generated = rolls(8)
    _export_xyz(os.path.join(out_dir, GENERATED[tag] + ".xyz"), generated[0], names, top=top)
    _eval_rollout_ensemble(out_dir, tag, generated, raw_traj)
    if probe_every_ep:
        save(os.path.join(out_dir, "best.ckpt"), model)  # the weights eval.json scored
    return model


def _decode_batches(arrays, history, decode_len, batch_size, device, transpose=False):
    """Seq2Seq batches, in order: for each ``(T, ...)`` array, windows of
    ``history`` frames and the ``decode_len`` after them, ``batch_size``
    consecutive starts a batch (the last one shorter). ``transpose`` puts
    each window's atoms first (per-atom series)."""
    for arr in arrays:
        for s in range(0, len(arr) - history - decode_len, batch_size):
            m = min(batch_size, len(arr) - s - history - decode_len)
            wins = np.stack([arr[s + j: s + j + history] for j in range(m)])
            tgts = np.stack([arr[s + j + history: s + j + history + decode_len]
                             for j in range(m)])
            if transpose:
                wins, tgts = wins.transpose(0, 2, 1, 3), tgts.transpose(0, 2, 1, 3)
            yield torch.as_tensor(wins, device=device), torch.as_tensor(tgts, device=device)


def _run_seq2seq(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir, names,
                 top, device, adversarial=False):
    """Seq2Seq (history 10, decode 5, noise 16): the sequence MSE of
    noise-fed decodes, or (``seq2seq-gan``) that plus the BCE of an LSTM
    critic trained beside it; generation by chained decodes of the trained
    horizon (``MDX_ROLLOUT_CORRECT`` corrects plain ``seq2seq``'s)."""
    from molecular_dynamics_tpu_torch.models.seq import Seq2Seq, SequenceDiscriminator
    from molecular_dynamics_tpu_torch.train.seq import (
        chained_decode_rollout, corrector_from_env, make_seq2seq_gan_trainer,
        make_seq2seq_trainer)

    n = ff.n_atoms
    feat = n * 3
    history, decode_len = 10, 5
    raw_traj = traj
    traj, w_mean, w_std = _whitened(traj)
    model = Seq2Seq(feat, feat, generator=gen, device=device)
    if adversarial:
        disc = SequenceDiscriminator(feat, generator=gen, device=device)
        _, _, g_step, d_step = make_seq2seq_gan_trainer(model, disc)

        def update(wins, tgts):
            shape = model.noise_shape(wins.shape[:1], decode_len)
            g_loss = g_step(_noise(gen, shape), wins, tgts)
            d_step(_noise(gen, shape), wins, tgts)
            return g_loss
    else:
        _, step = make_seq2seq_trainer(model)

        def update(wins, tgts):
            return step(_noise(gen, model.noise_shape(wins.shape[:1], decode_len)), wins, tgts)

    flats = [t.reshape(len(t), -1) for t in traj.trajectories]
    t0 = time.time()
    _epochs(epochs, lambda: _decode_batches(flats, history, decode_len, batch_size, device),
            update, logger, curves, keeper, model, t0)
    # chained decodes: each decode runs at the horizon the decoder (and the
    # critic) was trained on
    correct = None if adversarial else corrector_from_env(ff, w_mean, w_std)
    frames = chained_decode_rollout(model, _start_windows(traj, history, device), decode_len,
                                    _roll_len(traj), generator=gen, corrector=correct)
    tag = "seq2seq-gan" if adversarial else "seq2seq"
    generated = _unwhitened_rows(frames, n, w_mean, w_std)
    _export_xyz(os.path.join(out_dir, GENERATED[tag] + ".xyz"), generated[0], names, top=top)
    _eval_rollout_ensemble(out_dir, tag, generated, raw_traj)
    return model


def _run_transformer(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir,
                     names, top, device):
    """Trajectory transformer (history 11, d_model 64): next-frame MSE at
    lead 1, then the unrolled fine-tune (``MDX_TRANSFORMER_FT_*``);
    autoregressive rollouts, uncorrected."""
    from molecular_dynamics_tpu_torch.models.transformer import TrajectoryTransformer
    from molecular_dynamics_tpu_torch.train.datasets import window_batches
    from molecular_dynamics_tpu_torch.train.seq import autoregressive_rollout, make_mse_trainer

    n = ff.n_atoms
    feat = n * 3
    history = 11
    raw_traj = traj
    traj, w_mean, w_std = _whitened(traj)
    model = TrajectoryTransformer(feat, feat, d_model=64, history=history, generator=gen,
                                  device=device)
    _, step = make_mse_trainer(model)

    def batches():
        for window, target in window_batches(traj, history, 1, batch_size, rng):
            yield torch.as_tensor(window, device=device), torch.as_tensor(target, device=device)

    t0 = time.time()
    i = _epochs(epochs, batches, step, logger, curves, keeper, model, t0)
    _window_rollout_finetune(model, traj, history, feat, rng, i, t0, epochs, batch_size, logger,
                             curves, keeper, env_prefix="MDX_TRANSFORMER")
    frames = autoregressive_rollout(model, _start_windows(traj, history, device), _roll_len(traj))
    generated = _unwhitened_rows(frames, n, w_mean, w_std)
    _export_xyz(os.path.join(out_dir, GENERATED["transformer"] + ".xyz"), generated[0], names,
                top=top)
    _eval_rollout_ensemble(out_dir, "transformer", generated, raw_traj)
    return model


def _gns_dataset(traj):
    """The GNS dataset of ``traj``: within each trajectory (never across),
    frames 2 .. T-2 with their two previous finite-difference velocities,
    the acceleration target and the next frame; pooled, with each
    trajectory's first row."""
    pos_l, vel_l, acc_l, nxt_l = [], [], [], []
    for t_one in traj.trajectories:
        v = np.diff(t_one, axis=0)
        a = np.diff(v, axis=0)
        sel = np.arange(2, len(t_one) - 1)
        pos_l.append(t_one[sel])
        nxt_l.append(t_one[sel + 1])
        vel_l.append(np.stack([v[sel - 1], v[sel - 2]], axis=1))
        acc_l.append(a[sel - 1])
    starts = np.cumsum([0] + [len(x) for x in pos_l])[:-1]
    return (np.concatenate(pos_l), np.concatenate(vel_l), np.concatenate(acc_l),
            np.concatenate(nxt_l), starts, [len(x) for x in pos_l])


def _gat_loss(model, noise, pos, v1, v2, target_acc, pos_next, noise_sd, vel_scale, acc_scale):
    """The GNS step: positions perturbed by ``noise_sd x noise``, the
    acceleration MSE plus the next position's MSE."""
    pos_n = pos + noise_sd * noise
    pred = model(torch.cat([pos_n, v1, v2], dim=-1), pos_n)
    l_acc = torch.mean((pred - target_acc) ** 2)
    p_new = pos_n + v1 * vel_scale + pred * acc_scale
    return l_acc + torch.mean((p_new - pos_next) ** 2)


def _gat_sim_step(model, pos, vc1, vc2, vel_scale, acc_scale):
    """The one semi-implicit generation map, shared by the fine-tune and the
    rollout: the acceleration clamped to +-2 (z-scored targets), the
    velocity to +-3, in normalised units."""
    acc_n = torch.clamp(model(torch.cat([pos, vc1, vc2], dim=-1), pos), -2.0, 2.0)
    v_new = torch.clamp(vc1 + acc_n * (acc_scale / vel_scale), -3.0, 3.0)
    return pos + v_new * vel_scale, v_new


def _gat_unroll(model, p0, v1, v2, n_steps, vel_scale, acc_scale):
    pos, out = p0, []
    for _ in range(n_steps):
        pos, v_new = _gat_sim_step(model, pos, v1, v2, vel_scale, acc_scale)
        v1, v2 = v_new, v1
        out.append(pos)
    return torch.stack(out, dim=1)  # (B, W, N, 3)


def _gat_unroll_loss(model, p0, v1, v2, tgt, vel_scale, acc_scale):
    """The GAT fine-tune's loss: ``tgt.shape[1]`` frames of the generation
    map against the true future positions ``tgt (B, W, N, 3)``."""
    return torch.mean(
        (_gat_unroll(model, p0, v1, v2, tgt.shape[1], vel_scale, acc_scale) - tgt) ** 2)


def _run_gat(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir, names,
             top, device):
    """GNS-style GAT simulator on raw coordinates: trajectories strided to
    about 160 frames, velocities and accelerations by finite differences
    normalised to their mean magnitudes, Gaussian input noise
    (``MDX_GAT_NOISE`` x the velocity scale), then an unrolled fine-tune
    through the clamped generation map (``MDX_GAT_FT_*``); 24 rollouts."""
    from molecular_dynamics_tpu_torch.models.gat import GATSimulator
    from molecular_dynamics_tpu_torch.train.common import ClippedAdam, stepper
    from molecular_dynamics_tpu_torch.train.datasets import TrajectoryData

    n = ff.n_atoms
    stride = max(1, int(round(np.mean([len(t) for t in traj.trajectories]) / 160.0)))
    if stride > 1:
        traj = TrajectoryData([t[::stride] for t in traj.trajectories])
    gat_noise = float(os.environ.get("MDX_GAT_NOISE", 0.5))
    model = GATSimulator(node_in=9, latent=int(os.environ.get("MDX_GAT_LATENT", 64)),
                         n_processors=int(os.environ.get("MDX_GAT_PROC", 3)), k=min(40, n - 1),
                         generator=gen, device=device)
    opt = ClippedAdam(model.parameters(), lr=1e-4, clip_norm=1.0)
    pos_a, vv, aa, nxt_a, traj_starts, lens = _gns_dataset(traj)
    # normalise the finite-difference scales (strided frames make raw
    # accelerations large)
    acc_scale = float(np.abs(aa).mean()) + 1e-8
    vel_scale = float(np.abs(vv).mean()) + 1e-8
    vv, aa = vv / vel_scale, aa / acc_scale
    pos_d, vv_d, aa_d, nxt_d = (torch.as_tensor(a, device=device) for a in (pos_a, vv, aa, nxt_a))
    update = stepper(opt, lambda sel: _gat_loss(
        model, _noise(gen, (len(sel), n, 3)), pos_d[sel], vv_d[sel, 0], vv_d[sel, 1], aa_d[sel],
        nxt_d[sel], gat_noise * vel_scale, vel_scale, acc_scale))
    t0 = time.time()
    i = _epochs(epochs, lambda: _shuffled(rng, len(pos_a), batch_size, device), update, logger,
                curves, keeper, model, t0)
    ft_w = int(os.environ.get("MDX_GAT_FT_W", 8))
    ft_epochs = int(os.environ.get("MDX_GAT_FT_EPOCHS", 6))
    if ft_epochs > 0 and ft_w > 1:
        rows = [traj_starts[ti] + s for ti, ln in enumerate(lens)
                for s in range(0, ln - ft_w, max(1, ft_w // 2))]
        if rows:
            rows = np.asarray(rows)
            tgt = np.stack([pos_a[j + 1: j + 1 + ft_w] for j in rows])
            arrays = [pos_d[rows], vv_d[rows, 0], vv_d[rows, 1],
                      torch.as_tensor(tgt, device=device)]
            _finetune(model, keeper, rng, arrays, lambda p0, v1, v2, t: _gat_unroll_loss(
                model, p0, v1, v2, t, vel_scale, acc_scale),
                batch_size, ft_epochs, epochs, i, t0, logger, curves)
    s0 = torch.as_tensor(traj_starts[:24], device=device)
    with torch.no_grad():
        frames = _gat_unroll(model, pos_d[s0], vv_d[s0, 0], vv_d[s0, 1], _roll_len(traj),
                             vel_scale, acc_scale).cpu().numpy()
    generated = list(frames)
    _export_xyz(os.path.join(out_dir, GENERATED["gat"] + ".xyz"), generated[0], names, top=top)
    _eval_rollout_ensemble(out_dir, "gat", generated, traj)
    return model


def _lstm_gat_windows(traj, history):
    """LSTM-GAT training pairs: every ``history`` window ``(history, N, 3)``
    of each trajectory that leaves a frame after it, and that frame."""
    wins, tgts = [], []
    for t_arr in traj.trajectories:
        for s in range(0, len(t_arr) - history - 1):
            wins.append(t_arr[s: s + history])
            tgts.append(t_arr[s + history])
    return np.stack(wins).astype(np.float32), np.stack(tgts).astype(np.float32)


def _lstm_gat_predict(model, wins):
    """Windows ``(B, T, N, 3)`` -> the next frame ``(B, N, 3)``: each atom's
    series through the model, the graph of the latest frame, a delta on it."""
    pos = wins[:, -1]
    return pos + model(wins.transpose(1, 2), pos)


def _lstm_gat_clamps(traj, device):
    """The generation map's clamps: a step's displacement within twice the
    99.9 % quantile of the data's, the frame within the data's box +-0.5."""
    dx_all = np.concatenate([np.diff(t, axis=0) for t in traj.trajectories])
    all_w = np.concatenate(traj.trajectories)
    return (float(np.quantile(np.abs(dx_all), 0.999)) * 2.0,
            torch.as_tensor(all_w.min(axis=0) - 0.5, device=device),
            torch.as_tensor(all_w.max(axis=0) + 0.5, device=device))


def _lstm_gat_unroll(model, w, n_steps, clamps):
    """The one clamped generation map, ``n_steps`` frames from windows ``w
    (B, T, N, 3)``, each shifted in: ``(B, n_steps, N, 3)``. The fine-tune
    trains through it and the rollout runs it."""
    max_step, box_lo, box_hi = clamps
    out = []
    for _ in range(n_steps):
        last = w[:, -1]
        pred = last + torch.clamp(_lstm_gat_predict(model, w) - last, -max_step, max_step)
        pred = torch.minimum(torch.maximum(pred, box_lo), box_hi)
        w = torch.cat([w[:, 1:], pred[:, None]], dim=1)
        out.append(pred)
    return torch.stack(out, dim=1)


def _run_lstm_gat(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir,
                  names, top, device):
    """LSTM-GAT on whitened per-atom windows (history 5) predicting the next
    frame's delta, then an unrolled fine-tune (``MDX_LSTMGAT_FT_*``, 8 x 8
    by default) through the clamped generation map (``_lstm_gat_unroll``)."""
    from molecular_dynamics_tpu_torch.models.gat import LSTMGAT
    from molecular_dynamics_tpu_torch.train.common import ClippedAdam, stepper

    n = ff.n_atoms
    history = 5
    raw_traj = traj
    traj, w_mean, w_std = _whitened(traj)
    model = LSTMGAT(in_features=3, out_dim=3, k=min(10, n - 1), generator=gen, device=device)
    opt = ClippedAdam(model.parameters(), lr=1e-3, clip_norm=1.0)
    wins_d, tgt_d = (torch.as_tensor(a, device=device) for a in _lstm_gat_windows(traj, history))
    update = stepper(opt, lambda sel: torch.mean(
        (_lstm_gat_predict(model, wins_d[sel]) - tgt_d[sel]) ** 2))
    t0 = time.time()
    i = _epochs(epochs, lambda: _shuffled(rng, len(wins_d), batch_size, device), update, logger,
                curves, keeper, model, t0)
    clamps = _lstm_gat_clamps(traj, device)
    ft_w = int(os.environ.get("MDX_LSTMGAT_FT_W", 8))
    ft_epochs = int(os.environ.get("MDX_LSTMGAT_FT_EPOCHS", 8))
    if ft_epochs > 0 and ft_w > 1:
        fw0, ftg = _windows_ahead(traj.trajectories, history, ft_w)
        if fw0:
            arrays = [torch.as_tensor(np.stack(a).astype(np.float32), device=device)
                      for a in (fw0, ftg)]
            _finetune(model, keeper, rng, arrays,
                      lambda w, t: torch.mean((_lstm_gat_unroll(model, w, ft_w, clamps) - t) ** 2),
                      batch_size, ft_epochs, epochs, i, t0, logger, curves)
    with torch.no_grad():
        frames = _lstm_gat_unroll(model, _start_windows(traj, history, device, flat=False),
                                  _roll_len(traj), clamps)
    generated = _unwhitened_rows(frames.transpose(0, 1), n, w_mean, w_std)
    _export_xyz(os.path.join(out_dir, GENERATED["lstm-gat"] + ".xyz"), generated[0], names, top=top)
    _eval_rollout_ensemble(out_dir, "lstm-gat", generated, raw_traj)
    return model


def _refeaturizer(phi_idx, psi_idx, phi_row, psi_row, w_mean, w_std, device):
    """``seg (..., N, L, 5) -> (..., N, L, 5)``: the phi / psi channels
    rebuilt from the segment's own (unwhitened) geometry, each atom carrying
    its residue's torsions (0 at a terminus without one)."""
    from molecular_dynamics_tpu_torch.features import phi_psi

    mean = torch.as_tensor(np.asarray(w_mean, np.float32), device=device)
    std = torch.as_tensor(np.asarray(w_std, np.float32), device=device)
    phi_row, psi_row = (torch.as_tensor(r, device=device) for r in (phi_row, psi_row))

    def channel(values, rows):  # (..., L, n_torsions) -> (..., N, L, 1)
        picked = values[..., rows.clamp(min=0)]
        return torch.where(rows >= 0, picked, torch.zeros_like(picked)).transpose(-1, -2)[..., None]

    def refeature(seg):
        xyz = seg[..., :3].transpose(-3, -2)  # (..., L, N, 3)
        flat = xyz.reshape(*xyz.shape[:-2], -1)
        pos = (flat * std.to(seg.dtype) + mean.to(seg.dtype)).reshape(xyz.shape)
        ph, ps = phi_psi(pos, phi_idx, psi_idx)
        return torch.cat([seg[..., :3], channel(ph, phi_row), channel(ps, psi_row)], dim=-1)

    return refeature


def _atom_features(raw_traj, white_traj, top, device):
    """Per-atom series ``(T, N, 5)`` of each trajectory: the whitened xyz and
    the atom's residue torsions from the raw geometry (whitening distorts
    dihedrals), 0 at a terminus without one or without backbone names."""
    from molecular_dynamics_tpu_torch.features import per_atom_angle_rows, phi_psi

    phi_idx, psi_idx, phi_row, psi_row = per_atom_angle_rows(top)
    feats = []
    for raw, white in zip(raw_traj.trajectories, white_traj.trajectories):
        if len(phi_idx) and len(psi_idx):
            with torch.no_grad():
                ph, ps = (a.cpu().numpy() for a in phi_psi(
                    torch.as_tensor(np.asarray(raw), device=device), phi_idx, psi_idx))
            a_phi = np.where(phi_row >= 0, ph[:, np.clip(phi_row, 0, None)], 0.0)
            a_psi = np.where(psi_row >= 0, ps[:, np.clip(psi_row, 0, None)], 0.0)
        else:
            a_phi = a_psi = np.zeros(np.shape(raw)[:2], np.float32)
        feats.append(np.concatenate([np.asarray(white, np.float32),
                                     a_phi[..., None].astype(np.float32),
                                     a_psi[..., None].astype(np.float32)], axis=-1))
    return feats


def _graph_unroll(model, w0, noise, refeature):
    """The chained-decode generation map, differentiable: ``noise (B, S, L,
    N, F)`` drives S decodes of ``w0 (B, N, T, F)``; returns the frames
    ``(B, S * L, N, F)``."""
    w, segs = w0, []
    for s in range(noise.shape[1]):
        seg = model(w, noise[:, s])
        if refeature is not None:
            seg = refeature(seg)
        w = torch.cat([w[..., seg.shape[-2]:, :], seg], dim=-2)
        segs.append(seg.transpose(1, 2))
    return torch.cat(segs, dim=1)


def _graph_unroll_loss(model, w0, tgt, noise, refeature):
    """The graph fine-tune's loss: the chained decodes' whitened positions
    against ``tgt (B, S * L, N, F)``'s, plus the mirrored-pair distances'
    MSE."""
    from molecular_dynamics_tpu_torch.train.seq import mirrored_pair_distances

    pos = _graph_unroll(model, w0, noise, refeature)[..., :3]
    pos_t = tgt[..., :3]
    return torch.mean((pos - pos_t) ** 2) + torch.mean(
        (mirrored_pair_distances(pos) - mirrored_pair_distances(pos_t)) ** 2)


def _run_seq2seq_graph(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir,
                       names, top, device):
    """Graph-conditioned Seq2Seq over per-atom [whitened xyz, phi, psi]
    series (history 10, decode 5; ``MDX_GSEQ_HIDDEN``, ``_K``, ``_NOISE``,
    ``_LR``), the torsions from the raw geometry; then a fine-tune through
    ``MDX_GSEQ_FT_SEGS`` chained segments with the torsion channels rebuilt
    from each (``MDX_GSEQ_REFEAT``), against the whitened positions and the
    mirrored-pair distances."""
    from molecular_dynamics_tpu_torch.features import per_atom_angle_rows
    from molecular_dynamics_tpu_torch.models.gat import GraphSeq2Seq
    from molecular_dynamics_tpu_torch.train.seq import (
        graph_chained_decode_rollout, make_graph_seq2seq_trainer)

    n = ff.n_atoms
    history, decode_len = 10, 5
    raw_traj = traj
    traj, w_mean, w_std = _whitened(traj)
    phi_idx, psi_idx, phi_row, psi_row = per_atom_angle_rows(top)
    has_torsions = bool(len(phi_idx) and len(psi_idx))
    feats = _atom_features(raw_traj, traj, top, device)
    model = GraphSeq2Seq(hidden_size=int(os.environ.get("MDX_GSEQ_HIDDEN", 64)),
                         k=int(os.environ.get("MDX_GSEQ_K", 6)),
                         noise_scale=float(os.environ.get("MDX_GSEQ_NOISE", 0.5)),
                         generator=gen, device=device)
    _, step = make_graph_seq2seq_trainer(model, lr=float(os.environ.get("MDX_GSEQ_LR", 1e-3)))

    def update(wins, tgts):  # one noise draw a row
        return step(_noise(gen, (len(wins), decode_len, n, 5)), wins, tgts)

    t0 = time.time()
    i = _epochs(epochs, lambda: _decode_batches(feats, history, decode_len, batch_size, device,
                                                transpose=True),
                update, logger, curves, keeper, model, t0)
    refeature = None
    if os.environ.get("MDX_GSEQ_REFEAT", "1") == "1" and has_torsions:
        refeature = _refeaturizer(phi_idx, psi_idx, phi_row, psi_row, w_mean, w_std, device)
    ft_segs = int(os.environ.get("MDX_GSEQ_FT_SEGS", 4))
    ft_epochs = int(os.environ.get("MDX_GSEQ_FT_EPOCHS", 4))
    if ft_epochs > 0 and ft_segs > 0:
        fw0, ftg = _windows_ahead(feats, history, ft_segs * decode_len, transpose=True)
        if fw0:
            arrays = [torch.as_tensor(np.stack(a).astype(np.float32), device=device)
                      for a in (fw0, ftg)]

            def ft_loss(w0, tgt):  # one draw a row and segment
                noise = _noise(gen, (len(w0), ft_segs, decode_len, n, 5))
                return _graph_unroll_loss(model, w0, tgt, noise, refeature)

            _finetune(model, keeper, rng, arrays, ft_loss, batch_size, ft_epochs, epochs, i, t0,
                      logger, curves, lr=float(os.environ.get("MDX_GSEQ_FT_LR", 2e-5)))
    starts = torch.as_tensor(np.stack([f[:history].transpose(1, 0, 2) for f in feats[:8]]),
                             device=device)
    frames = graph_chained_decode_rollout(model, starts, decode_len, _roll_len(traj),
                                          generator=gen, refeature=refeature)
    generated = _unwhitened_rows(frames[..., :3], n, w_mean, w_std)
    _export_xyz(os.path.join(out_dir, GENERATED["seq2seq-graph"] + ".xyz"), generated[0], names,
                top=top)
    _eval_rollout_ensemble(out_dir, "seq2seq-graph", generated, raw_traj)
    return model


# --- the generative line -----------------------------------------------------


def _run_flow(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir, names,
              top, device):
    """Conditional RealNVP on min-max scaled flat frames, the NLL at the
    frame's normalized time; then a sweep of ``MDX_FLOW_NGEN`` samples along
    the time (base draws scaled by ``MDX_FLOW_TAU``). ``MDX_FLOW_TEMB=K``
    conditions on ``[t, sin(2 pi k t), cos(2 pi k t)]``, k = 1..K, built in
    float32; ``MDX_FLOW_COUPLING`` and ``MDX_FLOW_HIDDEN`` size the flow."""
    from molecular_dynamics_tpu_torch.features import minmax_fit, minmax_scale, minmax_unscale
    from molecular_dynamics_tpu_torch.models.flows import RealNVP
    from molecular_dynamics_tpu_torch.train.datasets import frame_time_batches
    from molecular_dynamics_tpu_torch.train.generative import make_flow_trainer

    n = ff.n_atoms
    frames_all, _ = traj.stacked()
    lo, hi = minmax_fit(torch.as_tensor(frames_all.reshape(len(frames_all), -1), device=device))
    n_coupling = int(os.environ.get("MDX_FLOW_COUPLING", 6))
    width = int(os.environ.get("MDX_FLOW_HIDDEN", 256))
    temb = int(os.environ.get("MDX_FLOW_TEMB", 0))
    tau = float(os.environ.get("MDX_FLOW_TAU", 1.0))
    k = 2.0 * math.pi * torch.arange(1, temb + 1, device=device, dtype=torch.float32)

    def embed(t):  # (B, 1) normalized time -> (B, 1 + 2 temb)
        if not temb:
            return t
        kt = t * k
        return torch.cat([t, torch.sin(kt), torch.cos(kt)], dim=-1)

    model = RealNVP(n * 3, n_coupling, (width, width), 1 + 2 * temb, generator=gen,
                    device=device)
    _, step = make_flow_trainer(model)

    def batches():
        for frames, times in frame_time_batches(traj, batch_size, rng):
            x = torch.as_tensor(frames.reshape(len(frames), -1), device=device)
            yield minmax_scale(x, lo, hi), embed(torch.as_tensor(times, device=device)[:, None])

    _epochs(epochs, batches, step, logger, curves, keeper, model, time.time())
    # conditional sweep along the reaction coordinate
    n_gen = int(os.environ.get("MDX_FLOW_NGEN", 20))
    z = tau * _noise(gen, (n_gen, n * 3))
    with torch.no_grad():
        samples = model.inverse(z, embed(torch.linspace(0.0, 1.0, n_gen, device=device)[:, None]))
    coords = minmax_unscale(samples, lo, hi).cpu().numpy().reshape(n_gen, n, 3)
    _export_xyz(os.path.join(out_dir, GENERATED["flow"] + ".xyz"), coords, names, top=top)
    _eval_generated(out_dir, "flow", coords, traj)
    return model


def _run_vae(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir, names,
             top, device):
    """Conditional VAE on whitened flat frames, conditioned on the frame's
    time bucket; then one decode of a prior draw a bucket, each relaxed by
    ``MDX_ROLLOUT_CORRECT``'s corrector where it is set."""
    from molecular_dynamics_tpu_torch.evaluate import unwhiten
    from molecular_dynamics_tpu_torch.models.vae import ConditionalVAE
    from molecular_dynamics_tpu_torch.train.datasets import frame_time_batches
    from molecular_dynamics_tpu_torch.train.generative import make_vae_trainer
    from molecular_dynamics_tpu_torch.train.seq import corrector_from_env

    n = ff.n_atoms
    raw_traj = traj
    traj, w_mean, w_std = _whitened(traj)
    model = ConditionalVAE(out_dim=n * 3, generator=gen, device=device)
    _, step = make_vae_trainer(model)

    def batches():  # ten time buckets, min(int(t * 10), 9)
        for frames, times in frame_time_batches(traj, batch_size, rng):
            yield (torch.as_tensor(frames.reshape(len(frames), -1), device=device),
                   torch.as_tensor(np.minimum((times * 10).astype(np.int32), 9), device=device))

    _epochs(epochs, batches, lambda x, b: step(_noise(gen, (len(x), model.latent_dim)), x, b),
            logger, curves, keeper, model, time.time())
    z = _noise(gen, (10, model.latent_dim))
    with torch.no_grad():
        decoded = model.decode(z, torch.arange(10, device=device))
    correct = corrector_from_env(ff, w_mean, w_std)
    if correct is not None:
        # no feedback loop to stabilise here: relax each decoded frame onto
        # the physical manifold before scoring
        decoded = correct(decoded)
    coords = unwhiten(decoded.cpu().numpy().reshape(10, n, 3), w_mean, w_std)
    _export_xyz(os.path.join(out_dir, GENERATED["vae"] + ".xyz"), coords, names, top=top)
    _eval_generated(out_dir, "vae", coords, raw_traj)
    return model


def _fixed_latents(n, latent_dim, device, seed=7):
    """The AAE probe's fixed prior sample: standard normals from a
    ``torch.Generator`` of its own, seeded ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn((n, latent_dim), generator=gen, device=device)


def _aae_losses(ae, disc, x, c, prior=None):
    """The AAE's two losses: the autoencoder's ``reconstruction + 0.1 x``
    the critic's BCE on its codes read as prior samples (``prior`` None),
    or the critic's BCE separating ``prior`` draws from the detached codes."""
    from molecular_dynamics_tpu_torch.models.autoencoder import aae_losses

    if prior is None:
        recon, z = ae(x, c)
        rec, g_adv, _ = aae_losses(recon, x, disc(z))
        return rec + 0.1 * g_adv
    with torch.no_grad():
        _, z = ae(x, c)
    return aae_losses(x, x, disc(z), disc(prior))[2]


def _run_aae(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir, names,
             top, device):
    """Adversarial autoencoder on whitened flat frames: reconstruction +
    a latent critic shaping the codes to the Gaussian prior, the decoder
    conditioned on the normalized time, so that prior samples sweep the
    pathway. Every ``MDX_AAE_PROBE`` epochs the decoder is scored by the
    end-to-end evaluator on 200 fixed prior draws and the best kept; then
    ``MDX_AAE_NGEN`` decodes along the time. ``MDX_AAE_LATENT`` sizes the
    code."""
    from molecular_dynamics_tpu_torch.evaluate import compare_e2e, unwhiten
    from molecular_dynamics_tpu_torch.models.autoencoder import (LatentDiscriminator,
                                                                 MLPAutoencoder)
    from molecular_dynamics_tpu_torch.train.common import ClippedAdam, stepper
    from molecular_dynamics_tpu_torch.train.datasets import frame_time_batches

    n = ff.n_atoms
    feat = n * 3
    latent = int(os.environ.get("MDX_AAE_LATENT", 16))
    raw_traj = traj
    traj, w_mean, w_std = _whitened(traj)
    ae = MLPAutoencoder(in_dim=feat, latent_dim=latent, cond_dim=1, generator=gen, device=device)
    disc = LatentDiscriminator(latent, generator=gen, device=device)
    ae_step = stepper(ClippedAdam(ae.parameters(), lr=1e-3, clip_norm=1.0),
                      lambda x, c: _aae_losses(ae, disc, x, c))
    d_step = stepper(ClippedAdam(disc.parameters(), lr=1e-4, clip_norm=1.0),
                     lambda prior, x, c: _aae_losses(ae, disc, x, c, prior))

    def batches():
        for frames, times in frame_time_batches(traj, batch_size, rng):
            yield (torch.as_tensor(frames.reshape(len(frames), -1), device=device),
                   torch.as_tensor(times, device=device)[:, None])

    def update(x, c):
        loss = ae_step(x, c)
        d_step(_noise(gen, (len(x), latent)), x, c)
        return loss

    probe_every = int(os.environ.get("MDX_AAE_PROBE", 8))
    probe_n = 200
    probe_z = _fixed_latents(probe_n, latent, device)
    probe_c = torch.linspace(0.0, 1.0, probe_n, device=device)[:, None]
    probe_data, _ = raw_traj.stacked()
    best = {"err": float("inf"), "state": None}

    def probe(epoch):
        if not probe_every or (epoch + 1) % probe_every:
            return
        with torch.no_grad():
            dec = ae.decode(probe_z, probe_c).cpu().numpy()
        pc = unwhiten(dec.reshape(probe_n, n, 3), w_mean, w_std)
        err = compare_e2e(pc, probe_data, data_trajectories=raw_traj.trajectories)["mean_abs_error"]
        if err < best["err"]:
            best.update(err=err, state=_clone_state(ae))
        print(f"aae probe epoch {epoch + 1}: e2e={err:.3f} (best {best['err']:.3f})")

    _epochs(epochs, batches, update, logger, curves, keeper, ae, time.time(), epoch_end=probe)
    if best["state"] is not None:
        ae.load_state_dict(best["state"])
    n_gen = int(os.environ.get("MDX_AAE_NGEN", 200))
    z = _noise(gen, (n_gen, latent))
    with torch.no_grad():
        decoded = ae.decode(z, torch.linspace(0.0, 1.0, n_gen, device=device)[:, None])
    coords = unwhiten(decoded.cpu().numpy().reshape(n_gen, n, 3), w_mean, w_std)
    _export_xyz(os.path.join(out_dir, GENERATED["aae"] + ".xyz"), coords, names, top=top)
    _eval_generated(out_dir, "aae", coords, raw_traj)
    return ae


def _sde_windows(traj, path_len):
    """The SDE-GAN's path windows ``(B, path_len, 3N)`` (float32), every
    ``path_len // 2`` frames of each trajectory, and each window's start as
    normalized time along its trajectory."""
    wins, win_t = [], []
    for t_arr in traj.trajectories:
        flat = t_arr.reshape(len(t_arr), -1)
        span = max(1, len(flat) - path_len)
        for s in range(0, len(flat) - path_len + 1, path_len // 2):
            wins.append(flat[s: s + path_len])
            win_t.append(s / span)
    return np.stack(wins).astype(np.float32), np.asarray(win_t, np.float32)


def _run_sde(ff, traj, epochs, batch_size, rng, gen, logger, keeper, curves, out_dir, names,
             top, device):
    """Neural SDE-GAN on whitened 8-frame path windows (stride 4): a batch
    is one generator update, three critic updates (a gradient penalty of
    ``MDX_SDE_GP``) and, every 10th, a potential-injection update on the
    unwhitened paths; the generator averaged uniformly over the second half
    of the updates. Every ``MDX_SDE_PROBE`` epochs the average's marginal TV
    on 512 paths (mean of ``MDX_SDE_PROBE_SEEDS`` draws) picks the best
    snapshot; then 1,024 paths are scored (the non-finite dropped) beside
    the data's own TV floor of a random half split, and ``best.ckpt`` holds
    the averaged generator. Knobs: ``MDX_SDE_TEMB`` (time conditioning),
    ``_HIDDEN``, ``_LATENT``, ``_NOISE``, ``_GP``, ``_LR_G``, ``_LR_D``,
    ``_MOMENT``, ``_QUANTILE``, ``_SWA``."""
    import copy

    from molecular_dynamics_tpu_torch.evaluate import marginal_histograms, unwhiten
    from molecular_dynamics_tpu_torch.models.sde import CDEDiscriminator, SDEGenerator
    from molecular_dynamics_tpu_torch.train.checkpoint import save
    from molecular_dynamics_tpu_torch.train.sde import SDEGANConfig, make_sde_gan_trainer

    n = ff.n_atoms
    feat = n * 3
    path_len = 8
    raw_traj = traj
    traj, w_mean, w_std = _whitened(traj)
    paths, win_t = _sde_windows(traj, path_len)
    temb_k = int(os.environ.get("MDX_SDE_TEMB", 0))
    cond_dim = 2 * temb_k + 1 if temb_k else 0

    def conds_at(tvals):  # (B,) times -> float32 [t, sin(2 pi k t), cos(2 pi k t)], k = 1..K
        if not temb_k:
            return None
        t = np.asarray(tvals, np.float32)[:, None]
        feats = [t]
        for k in range(1, temb_k + 1):
            feats += [np.sin(2.0 * np.pi * k * t), np.cos(2.0 * np.pi * k * t)]
        return torch.as_tensor(np.concatenate(feats, axis=-1), device=device)

    conds = conds_at(win_t)
    ts = torch.linspace(0.0, 1.0, path_len, device=device)
    h = int(os.environ.get("MDX_SDE_HIDDEN", 128))
    g_model = SDEGenerator(feat, latent_dim=int(os.environ.get("MDX_SDE_LATENT", 64)),
                           noise_dim=int(os.environ.get("MDX_SDE_NOISE", 16)), hidden=(h, h),
                           cond_dim=cond_dim, generator=gen, device=device)
    d_model = CDEDiscriminator(feat, cond_dim=cond_dim, generator=gen, device=device)
    cfg = SDEGANConfig(
        gp_weight=float(os.environ.get("MDX_SDE_GP", 10.0)), adam=True,
        lr_g=float(os.environ.get("MDX_SDE_LR_G", 2e-4)),
        lr_d=float(os.environ.get("MDX_SDE_LR_D", 1e-3)),
        moment_weight=float(os.environ.get("MDX_SDE_MOMENT", 1.0)),
        quantile_weight=float(os.environ.get("MDX_SDE_QUANTILE", 0.0)),
        swa_decay=float(os.environ.get("MDX_SDE_SWA", 0.99)))
    # the potential injection reads the physical scale: the generator emits
    # whitened paths, unwhitened (differentiably) before the energy
    unwhitening = tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                        for a in (w_mean, w_std))
    init_fn, _, g_step, d_step, informed_step, swa_update = make_sde_gan_trainer(
        g_model, d_model, ts, ff=ff, config=cfg, unwhiten=unwhitening)
    init_fn()

    def draws(batch):  # z0 and dw of ``batch`` paths, the increments scaled by sqrt(dt)
        z0 = _noise(gen, (batch, g_model.init_noise_dim))
        dts = torch.diff(ts)
        dw = _noise(gen, (len(dts), batch, g_model.noise_dim)) * torch.sqrt(dts)[:, None, None]
        return z0, dw

    g_avg = copy.deepcopy(g_model)
    paths_d = torch.as_tensor(paths, device=device)
    t0 = time.time()
    i = 0
    # uniform averaging over the second half of training
    steps_per_epoch = max(1, (len(paths) - batch_size + 1) // batch_size + 1)
    swa_start = (epochs * steps_per_epoch) // 2
    n_avg = 0
    probe_every = int(os.environ.get("MDX_SDE_PROBE", 1))
    probe_seeds = int(os.environ.get("MDX_SDE_PROBE_SEEDS", 1))
    best_tv, best_g = float("inf"), None
    for epoch in range(epochs):
        order = rng.permutation(len(paths))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            sel = torch.as_tensor(order[s: s + batch_size], device=device)
            # the fakes share the real batch's conditions
            real, bc = paths_d[sel], None if conds is None else conds[sel]
            g_step(*draws(batch_size), real, bc)
            for _ in range(3):
                z0, dw = draws(batch_size)
                eps = _uniform(gen, (batch_size, 1, 1)) if cfg.gp_weight > 0.0 else None
                d_loss = d_step(z0, dw, eps, real, bc)
            if i % cfg.potential_every == cfg.potential_every - 1:
                informed_step(*draws(batch_size), bc)
            if i >= swa_start:
                swa_update(g_avg, g_model, n_avg)
                n_avg += 1
            else:
                g_avg.load_state_dict(g_model.state_dict())
            i += 1
            if i % 10 == 0:
                _log(logger, curves, keeper, g_model, epoch, i, d_loss, t0)
        # marginal-TV probed snapshot selection of the averaged generator
        # (the critic collapses in long runs: keep the best pre-collapse one)
        if probe_every and (epoch + 1) % probe_every == 0:
            tvs = []
            for _ in range(max(1, probe_seeds)):
                with torch.no_grad():
                    probe = g_avg(ts, *draws(512), conds_at(np.linspace(0.0, 1.0, 512)))
                probe = probe.cpu().numpy()
                if not np.isfinite(probe).all():
                    tvs = None
                    break
                tvs.append(marginal_histograms(probe, paths)["marginal_tv_mean"])
            if tvs is None:
                print(f"sde probe epoch {epoch + 1}: non-finite paths")
            else:
                tv = float(np.mean(tvs))
                if tv < best_tv:
                    best_tv, best_g = tv, _clone_state(g_avg)
                print(f"sde probe epoch {epoch + 1}: tv={tv:.4f} (best {best_tv:.4f})")
    if best_g is not None:
        g_avg.load_state_dict(best_g)
    # 1,024 paths (finite-sample TV biases upward), swept along the time
    # with conditioning; a diverged run is scored on its finite paths
    with torch.no_grad():
        fake = g_avg(ts, *draws(1024), conds_at(np.linspace(0.0, 1.0, 1024))).cpu().numpy()
    finite = np.isfinite(fake).all(axis=(1, 2))
    if not finite.all():
        print(f"sde: {int((~finite).sum())}/{len(finite)} generated paths non-finite "
              "(diverged run); evaluating the finite subset")
        fake = fake[finite] if finite.any() else np.zeros((1,) + fake.shape[1:], np.float32)
    coords = unwhiten(fake.reshape(-1, n, 3), w_mean, w_std)
    _export_xyz(os.path.join(out_dir, GENERATED["sde"] + ".xyz"), coords[:256], names, top=top)
    half = rng.permutation(len(paths))
    floor = marginal_histograms(paths[half[: len(half) // 2]], paths[half[len(half) // 2:]])
    extra = marginal_histograms(fake, paths)
    extra["marginal_tv_floor"] = floor["marginal_tv_mean"]
    _eval_generated(out_dir, "sde", coords, raw_traj, extra=extra)
    # best.ckpt holds the generator the evaluation scored (the probe's
    # averaged snapshot), not the keeper's lowest critic loss
    save(os.path.join(out_dir, "best.ckpt"), g_avg)
    return g_avg


_FAMILIES = {
    "pretrain": _run_pretrain,
    "cgan": _run_cgan,
    "hnn": _run_hnn,
    "hnn-schnet": lambda **kw: _run_hnn(backbone="schnet", **kw),
    "hnn-latent": _run_hnn_latent,
    "node": _run_node,
    "lstm": _run_lstm,
    "lstm-nll": lambda **kw: _run_lstm(nll=True, **kw),
    "seq2seq": _run_seq2seq,
    "seq2seq-gan": lambda **kw: _run_seq2seq(adversarial=True, **kw),
    "transformer": _run_transformer,
    "gat": _run_gat,
    "lstm-gat": _run_lstm_gat,
    "seq2seq-graph": _run_seq2seq_graph,
    "flow": _run_flow,
    "vae": _run_vae,
    "aae": _run_aae,
    "sde": _run_sde,
}
