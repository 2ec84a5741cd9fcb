"""Sequence-model training: the trainers, the rollouts that generate with
them, and the physics correctors of generated frames.

**Trainers.** Each ``make_*_trainer`` returns its ``ClippedAdam`` (Adam after
optax's global-norm clip) and a step that updates the model in place and
returns the loss (a 0-dim tensor on the device); the loss itself is a plain
function of the module and the batch (``window_loss``, ``nll_loss``,
``seq2seq_loss``, ``gan_generator_loss``, ``gan_critic_loss``,
``graph_seq2seq_loss``). The window trainer scores the next frame with the
composite position + phi + psi + kNN-distance loss; the NLL trainer the
Gaussian head; Seq2Seq the sequence MSE of a noise-fed decode (no teacher
forcing), its adversarial variant adds an LSTM critic; the graph trainer
per-atom windows with a mirrored-pair end-to-end term. Decoder noise is an
argument of every step: the caller draws it from its ``torch.Generator``.

**Rollouts.** ``autoregressive_rollout`` (predict, shift the window),
``nll_sampling_rollout`` (sample the predicted Gaussian),
``chained_decode_rollout`` and ``graph_chained_decode_rollout`` (decode a
trained horizon, shift the window by the segment). Every leading axis of
the start windows is a row of one batched rollout; each row is the
reference's rollout from that start, given the same draws. They run
without a graph and return frames time first, ``(T, ...)``.

**Correctors.** A corrector relaxes each generated frame of a rollout
through the differentiable force field before it is fed back: a few FIRE
steps (``make_frame_corrector``) or a short thermostatted Langevin burst
(``make_langevin_corrector``), optionally holding the frame's own
end-to-end distance with a harmonic pin. Each works on the rollout's
representation (whitened flat features ``(..., 3N)``: it unwhitens,
relaxes each frame, re-whitens) and falls back to the uncorrected frame
where the relaxation is not finite. ``corrector_from_env`` reads the
``MDX_ROLLOUT_CORRECT`` recipe (``<mode>:<n>[:pin[<fk>]]``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
from torch.nn import functional as F

from molecular_dynamics_tpu_torch import units
from molecular_dynamics_tpu_torch.energy import REFERENCE_CONFIG, _neg_grad, total_energy
from molecular_dynamics_tpu_torch.features import knn_mask
from molecular_dynamics_tpu_torch.integrate import minimize_fire, mix_seed
from molecular_dynamics_tpu_torch.models.seq import gaussian_nll
from molecular_dynamics_tpu_torch.train.common import ClippedAdam, is_data_parallel, stepper
from molecular_dynamics_tpu_torch.train.losses import window_composite_loss

Tensor = torch.Tensor


# --- trainers -----------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SeqTrainConfig:
    lr: float = 1e-4
    clip_norm: float = 1.0
    n_atoms: int = 40
    w_pos: float = 1.0
    w_phi: float = 1.0
    w_psi: float = 1.0
    w_dist: float = 1.0
    knn_k: int = 5


def window_loss(model, window: Tensor, target: Tensor, phi_idx: Tensor, psi_idx: Tensor,
                knn: Tensor, config: SeqTrainConfig = SeqTrainConfig()) -> Tensor:
    """The composite next-frame loss of ``model(window)`` against ``target``
    (flat frames ``(B, 3N)``, scored as ``(B, N, 3)``)."""
    pred = model(window)
    n = config.n_atoms
    return window_composite_loss(
        pred.reshape(-1, n, 3), target.to(pred.dtype).reshape(-1, n, 3), phi_idx, psi_idx, knn,
        config.w_pos, config.w_phi, config.w_psi, config.w_dist)


def make_window_trainer(model, phi_idx, psi_idx, config: SeqTrainConfig = SeqTrainConfig()):
    """Composite-loss next-frame trainer: ``(opt, step(window, target))``.
    ``model`` may be a ``DistributedDataParallel`` wrapper (as may the NLL
    trainer's)."""
    opt = ClippedAdam(model.parameters(), lr=config.lr, clip_norm=config.clip_norm,
                      backward=is_data_parallel(model))
    device = next(model.parameters()).device
    knn = knn_mask(config.n_atoms, config.knn_k, device=device)
    phi = torch.as_tensor(np.asarray(phi_idx), device=device)
    psi = torch.as_tensor(np.asarray(psi_idx), device=device)
    return opt, stepper(opt, lambda w, t: window_loss(model, w, t, phi, psi, knn, config))


def nll_loss(model, window: Tensor, target: Tensor) -> Tensor:
    mu, sigma = model(window)
    return gaussian_nll(mu, sigma, target.to(mu.dtype))


def make_nll_trainer(model, lr: float = 1e-4, clip_norm: float = 1.0):
    """Gaussian-NLL next-frame trainer: ``(opt, step(window, target))``."""
    opt = ClippedAdam(model.parameters(), lr=lr, clip_norm=clip_norm,
                      backward=is_data_parallel(model))
    return opt, stepper(opt, lambda w, t: nll_loss(model, w, t))


def mse_loss(model, window: Tensor, target: Tensor) -> Tensor:
    """The next frame's mean squared error (the transformer's loss)."""
    pred = model(window)
    return torch.mean((pred - target.to(pred.dtype)) ** 2)


def make_mse_trainer(model, lr: float = 1e-4, clip_norm: float = 1.0):
    """Next-frame MSE trainer: ``(opt, step(window, target))``."""
    opt = ClippedAdam(model.parameters(), lr=lr, clip_norm=clip_norm)
    return opt, stepper(opt, lambda w, t: mse_loss(model, w, t))


def seq2seq_loss(model, noise: Tensor, window: Tensor, target_seq: Tensor) -> Tensor:
    pred = model(window, noise)
    return torch.mean((pred - target_seq.to(pred.dtype)) ** 2)


def make_seq2seq_trainer(model, lr: float = 1e-4, clip_norm: float = 1.0):
    """Sequence-MSE trainer of a noise-fed decoder: ``(opt, step(noise,
    window, target_seq))``, the decode as long as ``noise``."""
    opt = ClippedAdam(model.parameters(), lr=lr, clip_norm=clip_norm)
    return opt, stepper(opt, lambda z, w, t: seq2seq_loss(model, z, w, t))


def _bce_logits(logits: Tensor, label: float) -> Tensor:
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, label))


def gan_generator_loss(gen, disc, noise: Tensor, window: Tensor, target_seq: Tensor,
                       adv_weight: float = 0.1) -> Tensor:
    """Sequence MSE + ``adv_weight`` x the non-saturating BCE of the critic
    on the decode."""
    pred = gen(window, noise)
    l2 = torch.mean((pred - target_seq.to(pred.dtype)) ** 2)
    return l2 + adv_weight * _bce_logits(disc(pred), 1.0)


def gan_critic_loss(disc, gen, noise: Tensor, window: Tensor, target_seq: Tensor) -> Tensor:
    """The critic's BCE: real future windows against decoded ones (no
    gradient into the generator)."""
    with torch.no_grad():
        fake = gen(window, noise)
    return _bce_logits(disc(target_seq), 1.0) + _bce_logits(disc(fake), 0.0)


def make_seq2seq_gan_trainer(gen, disc, lr_g: float = 1e-4, lr_d: float = 1e-4,
                             adv_weight: float = 0.1, clip_norm: float = 1.0):
    """Adversarial Seq2Seq: ``(opt_g, opt_d, g_step, d_step)``, each step
    ``(noise, window, target_seq)``. The critic is the one ``d_step``
    updates; ``g_step`` reads it as it stands."""
    opt_g = ClippedAdam(gen.parameters(), lr=lr_g, clip_norm=clip_norm)
    opt_d = ClippedAdam(disc.parameters(), lr=lr_d, clip_norm=clip_norm)
    g_step = stepper(opt_g, lambda z, w, t: gan_generator_loss(gen, disc, z, w, t, adv_weight))
    d_step = stepper(opt_d, lambda z, w, t: gan_critic_loss(disc, gen, z, w, t))
    return opt_g, opt_d, g_step, d_step


def mirrored_pair_distances(pos: Tensor) -> Tensor:
    """``(..., N, 3)`` -> ``(..., N // 2)``: the distance of atom i to atom
    N-1-i (the end-to-end pairing the reference meant)."""
    half = pos.shape[-2] // 2
    return torch.linalg.norm(pos[..., :half, :] - torch.flip(pos, (-2,))[..., :half, :], dim=-1)


def graph_seq2seq_loss(model, noise: Tensor, windows: Tensor, targets: Tensor,
                       w_angles: float = 0.1, w_e2e: float = 1.0) -> Tensor:
    """Per-atom windows ``(B, N, T, F)`` decoded to ``(B, N, L, F)`` against
    ``targets`` of that shape: position MSE + ``w_angles`` x the angle
    channels' MSE + ``w_e2e`` x the mirrored-pair distance MSE."""
    pred = model(windows, noise)
    targets = targets.to(pred.dtype)
    pos_p = pred[..., :3].transpose(1, 2)  # (B, L, N, 3)
    pos_t = targets[..., :3].transpose(1, 2)
    val = torch.mean((pos_p - pos_t) ** 2)
    val = val + w_angles * torch.mean((pred[..., 3:] - targets[..., 3:]) ** 2)
    return val + w_e2e * torch.mean(
        (mirrored_pair_distances(pos_p) - mirrored_pair_distances(pos_t)) ** 2)


def make_graph_seq2seq_trainer(model, lr: float = 1e-3, clip_norm: float = 1.0,
                               w_angles: float = 0.1, w_e2e: float = 1.0):
    """Graph-conditioned Seq2Seq trainer: ``(opt, step(noise, windows,
    targets))``, ``noise (B, L, N, F)`` one draw a row."""
    opt = ClippedAdam(model.parameters(), lr=lr, clip_norm=clip_norm)
    return opt, stepper(
        opt, lambda z, w, t: graph_seq2seq_loss(model, z, w, t, w_angles, w_e2e))


# --- rollouts -----------------------------------------------------------------


def _draws(noise: Optional[Tensor], generator: Optional[torch.Generator], shape, like: Tensor):
    """``noise`` as given, or standard normals of ``shape`` from
    ``generator``."""
    if noise is not None:
        return noise.to(device=like.device, dtype=like.dtype)
    if generator is None:
        raise ValueError("a rollout that samples needs its noise or a torch.Generator")
    return torch.randn(shape, generator=generator, device=like.device, dtype=like.dtype)


def _shift(window: Tensor, frames: Tensor) -> Tensor:
    """Drop as many oldest frames as ``frames (..., k, F)`` brings, append them."""
    return torch.cat([window[..., frames.shape[-2]:, :], frames], dim=-2)


@torch.no_grad()
def autoregressive_rollout(model, windows: Tensor, n_steps: int, corrector=None) -> Tensor:
    """Predict the next frame of ``windows (..., T, F)``, correct it, shift
    it in; ``n_steps`` times. Returns ``(n_steps, ..., F)``."""
    w, frames = windows, []
    for _ in range(n_steps):
        pred = model(w)
        if corrector is not None:
            pred = corrector(pred)
        w = _shift(w, pred[..., None, :])
        frames.append(pred)
    return torch.stack(frames)


@torch.no_grad()
def nll_sampling_rollout(model, windows: Tensor, n_steps: int, noise: Optional[Tensor] = None,
                         generator: Optional[torch.Generator] = None, corrector=None) -> Tensor:
    """Sample each next frame from the predicted Gaussian, ``mu + sigma *
    noise[i]``, correct it and feed it back. ``noise (n_steps, ..., F)``, or
    drawn from ``generator``. Returns ``(n_steps, ..., F)``."""
    w, frames = windows, []
    for i in range(n_steps):
        mu, sigma = model(w)
        if i == 0:
            noise = _draws(noise, generator, (n_steps,) + tuple(mu.shape), mu)
        pred = mu + sigma * noise[i].to(mu.dtype)
        if corrector is not None:
            pred = corrector(pred)
        w = _shift(w, pred[..., None, :])
        frames.append(pred)
    return torch.stack(frames)


@torch.no_grad()
def chained_decode_rollout(model, windows: Tensor, decode_len: int, n_steps: int,
                           noise: Optional[Tensor] = None,
                           generator: Optional[torch.Generator] = None,
                           corrector=None) -> Tensor:
    """Seq2Seq generation by chained decodes of the trained horizon: decode
    ``decode_len`` frames from each window, correct them, shift the window by
    the whole segment; ``segments = max(1, n_steps // decode_len)`` times
    (the decoder, and a critic, only ever see the horizon they were trained
    at). ``noise (segments, ..., decode_len, noise_dim)``, or drawn from
    ``generator``. Returns ``(segments * decode_len, ..., F)``."""
    segs = max(1, n_steps // decode_len)
    ref = model.layers[0].weight
    shape = (segs,) + model.noise_shape(windows.shape[:-2], decode_len)
    noise = _draws(noise, generator, shape, ref)
    w, out = windows, []
    for s in range(segs):
        seg = model(w, noise[s])
        if corrector is not None:
            seg = corrector(seg)
        w = _shift(w, seg)
        out.append(seg.movedim(-2, 0))
    return torch.cat(out)


@torch.no_grad()
def graph_chained_decode_rollout(model, windows: Tensor, decode_len: int, n_steps: int,
                                 noise: Optional[Tensor] = None,
                                 generator: Optional[torch.Generator] = None,
                                 refeature=None) -> Tensor:
    """Chained trained-horizon decodes of per-atom windows ``(..., N, T, F)``
    (the graph family's generation). ``refeature`` ``(..., N, L, F) -> (...,
    N, L, F)`` rebuilds derived channels (phi / psi) of each decoded segment
    from its own geometry before it is fed back. ``noise (segments, ..., L,
    N, F)``, or drawn from ``generator``. Returns ``(segments * L, ..., N,
    F)``."""
    segs = max(1, n_steps // decode_len)
    n, feat = windows.shape[-3], windows.shape[-1]
    ref = model.layers[0].weight
    noise = _draws(noise, generator, (segs,) + windows.shape[:-3] + (decode_len, n, feat), ref)
    w, out = windows, []
    for s in range(segs):
        seg = model(w, noise[s])
        if refeature is not None:
            seg = refeature(seg)
        w = _shift(w, seg)
        out.append(seg.movedim(-2, 0))
    return torch.cat(out)


# --- correctors ---------------------------------------------------------------


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
