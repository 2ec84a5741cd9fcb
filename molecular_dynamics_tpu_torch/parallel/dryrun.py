"""Multi-device dry run: a data-parallel cGAN step and sharded MD steps.

``dryrun_multichip(n)`` runs, at small widths on the 40-atom backbone and
the 104-atom deca-alanine:

- on ``n`` data-parallel ranks (``parallel.data``): 300 decoder-pretrain
  steps onto the real structure, then one G, one D and one informed
  update of the cGAN, each loss finite and the informed loss within the
  physical bound ``max(1e6, 100 (|E_real| + 1))`` kcal/mol (a collapsed
  random generator sits near 1e15);
- in this process, over an ``n``-entry mesh: one sharded composed Langevin
  step of the biased backbone ensemble, and one sharded launch of the
  campaign op in vacuum and under GB + LCPO (``sasa_every=2``), each
  finite.

The ranks and the mesh take ``n`` CUDA devices where that many are
visible, else ``n`` gloo ranks and ``n`` mesh entries on the CPU.
"""

from __future__ import annotations

import torch

from molecular_dynamics_tpu_torch.parallel.data import spawn
from molecular_dynamics_tpu_torch.parallel.mesh import (
    get_mesh,
    shard_campaign_advance,
    shard_ensemble,
    to_device,
    visible_cuda_devices,
)

#: generator and critic widths of the dry run
HIDDEN = (32, 32)
LATENT = 31
PRETRAIN_STEPS = 300


def _backbone(device):
    from molecular_dynamics_tpu_torch.examples import BACKBONE_FF_PRM, decaalanine_backbone
    from molecular_dynamics_tpu_torch.ff import YamlForceField, build_ff_params

    top, coords = decaalanine_backbone()
    ff = build_ff_params(top, YamlForceField(BACKBONE_FF_PRM), device=device)
    return ff, torch.as_tensor(coords, dtype=torch.float32, device=device)


def _bias(n, device):
    from molecular_dynamics_tpu_torch.bias import HarmonicSMDBias

    return HarmonicSMDBias.create(n_atoms=n, group1=[0], group2=[n - 1], fk=1.0,
                                  cent_0=12.0, cent_1=34.0, T=10000.0, device=device)


def cgan_rank(dp):
    """One rank's data-parallel cGAN step: the global g, d and informed
    losses and the bound (rank 0 prints them)."""
    from molecular_dynamics_tpu_torch.energy import total_energy
    from molecular_dynamics_tpu_torch.models.cgan import Discriminator, Generator
    from molecular_dynamics_tpu_torch.train.cgan import CGANTrainer, generated_coords
    from molecular_dynamics_tpu_torch.train.common import ClippedAdam, descend

    device = dp.device
    ff, coords = _backbone(device)
    n = ff.n_atoms
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    g_model = Generator(n_atoms=n, latent_dim=LATENT, hidden=HIDDEN, generator=gen, device=device)
    d_model = Discriminator(in_features=n * 3, hidden=HIDDEN, generator=gen, device=device)
    g_fwd, d_fwd = dp.wrap(g_model), dp.wrap(d_model)
    trainer = CGANTrainer(g_fwd, d_fwd, ff, bias=_bias(n, device))

    batch = 2 * dp.world
    t = dp.rows(torch.linspace(0.0, 1.0, batch, device=device))
    real = coords.expand(len(t), n, 3)

    def latents():
        return dp.rows(torch.randn((batch, LATENT), generator=gen, device=device))

    # pretrain onto the real structure, so that the informed loss sits at its
    # physical scale (a random generator's structures collapse)
    opt = ClippedAdam(g_model.parameters(), lr=1e-3, clip_norm=None, backward=True)
    for _ in range(PRETRAIN_STEPS):
        descend(opt, torch.mean((generated_coords(g_fwd, latents(), t) - real) ** 2))

    losses = {"g": trainer.g_step(latents(), t),
              "d": trainer.d_step(latents(), real, t),
              "informed": trainer.informed_step(latents(), t)}
    losses = {k: float(dp.mean(v)) for k, v in losses.items()}
    for name, value in losses.items():
        if not torch.isfinite(torch.tensor(value)):
            raise AssertionError(f"{name} loss not finite: {value}")
    e_real = float(total_energy(coords, ff))
    bound = max(1e6, 100.0 * (abs(e_real) + 1.0))
    if not abs(losses["informed"]) < bound:
        raise AssertionError(
            f"informed loss {losses['informed']:.3e} exceeds the physical bound {bound:.3e} "
            f"(E_real={e_real:.1f} kcal/mol)")
    res = {**losses, "bound": bound, "e_real": e_real}
    if dp.writer:
        print("dryrun_multichip cgan: " + ", ".join(f"{k}={v:.4g}" for k, v in res.items()),
              flush=True)
    return res


def sharded_md(mesh) -> dict:
    """One sharded composed step and two sharded campaign launches over
    ``mesh``, one replica a mesh entry; raises on a non-finite result."""
    import molecular_dynamics_tpu_torch as mdx
    from molecular_dynamics_tpu_torch.energy import GBIS_POLAR_CONFIG, force_fn
    from molecular_dynamics_tpu_torch.examples import decaalanine_full
    from molecular_dynamics_tpu_torch.integrate import initialize_forces
    from molecular_dynamics_tpu_torch.ops.fused_step import make_fused_campaign_op
    from molecular_dynamics_tpu_torch.sim import SimulationConfig, simulate_ensemble
    from molecular_dynamics_tpu_torch.system import replicate

    n_dev, device = mesh.size, mesh.devices[0]
    ff, coords = _backbone(device)
    bias = _bias(ff.n_atoms, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    state = mdx.system_init(coords, vel=mdx.maxwell_boltzmann(gen, ff.masses, 300.0),
                            device=device)
    seed_force = force_fn(mdx.REFERENCE_CONFIG, external=lambda q: bias.energy(q, 0))
    state = initialize_forces(state, lambda p, box: seed_force(p, ff))
    _, frames, _ = simulate_ensemble(
        shard_ensemble(replicate(state, n_dev, seed=3), mesh), ff, n_steps=1, save_every=1,
        config=SimulationConfig(dt_fs=0.5), bias=bias, mesh=mesh)
    if not bool(torch.isfinite(frames).all()):
        raise AssertionError("sharded MD step diverged")

    ff_full, coords_full, _ = decaalanine_full(device=device)
    n = ff_full.n_atoms
    pos = torch.as_tensor(coords_full, dtype=torch.float32, device=device).expand(n_dev, n, 3)
    frc = force_fn(mdx.REFERENCE_CONFIG)(pos, ff_full)
    g = GBIS_POLAR_CONFIG
    out = {}
    for name, kw in (("vacuum", {}), ("gbis_sasa", dict(
            cutoff=g.cutoff, switch_dist=g.switch_dist, rfa=g.rfa, gb=True,
            ion_concentration=g.ion_concentration, sasa=True, sasa_every=2))):
        # one op a device, built from that device's force field
        adv = shard_campaign_advance({dev: make_fused_campaign_op(
            to_device(ff_full, dev), n_inner=2, dt_fs=1.0, temperature=0.0, gamma_ps=1.0, **kw)
            for dev in set(mesh.devices)}, mesh)
        p_out, _, _ = adv(*(shard_ensemble(x.contiguous(), mesh)
                            for x in (pos, torch.zeros_like(pos), frc)), 0, 1)
        if not all(bool(torch.isfinite(p).all()) for p in p_out):
            raise AssertionError(f"sharded {name} campaign step diverged")
        out[name] = [str(p.device) for p in p_out]
    return out


def dryrun_multichip(n_devices: int) -> dict:
    """The data-parallel cGAN step on ``n_devices`` ranks and the sharded MD
    steps over an ``n_devices`` mesh: on CUDA devices where that many are
    visible, else on the CPU (gloo ranks, a CPU mesh). Raises on any
    failed check; returns where it ran."""
    device = "cuda" if visible_cuda_devices() >= n_devices else "cpu"
    spawn(cgan_rank, n_devices, device)
    shards = sharded_md(get_mesh(n_devices, device=device))
    print(f"dryrun_multichip ok: {n_devices} {device} ranks and mesh entries; "
          f"campaign shards on {shards['vacuum']}")
    return {"device": device, "campaign_shards": shards}
