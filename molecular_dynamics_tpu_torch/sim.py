"""Simulation campaigns: rollouts, replica ensembles, SMD regeneration.

A rollout advances ``save_every`` integrator steps per emitted frame; a
replica ensemble is a leading axis on every state field, so 1024 replicas
advance in one device program. With ``SimulationConfig.fused_campaign`` a
whole ``save_every``-step segment is one launch of the campaign kernel
(``ops.fused_step``), in vacuum or with the GBIS implicit solvent (GB-OBC II
+ LCPO SASA) evaluated inside it.

Output: strided coordinate frames ``(frames, [replicas,] atoms, 3)``,
per-frame energy/temperature logs and colvar centre/value traces.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from molecular_dynamics_tpu_torch.constraints import (
    constrained_langevin_step,
    constrained_temperature,
    constrained_velocity_verlet_step,
    hydrogen_bond_constraints,
)
from molecular_dynamics_tpu_torch.energy import (
    DEFAULT_TERMS,
    EnergyConfig,
    GBIS_CONFIG,
    GBIS_POLAR_CONFIG,
    REFERENCE_CONFIG,
    _neg_grad,
    resolve_urey_bradley,
    total_energy,
)
from molecular_dynamics_tpu_torch.ff.params import FFParams
from molecular_dynamics_tpu_torch.integrate import (
    kinetic_energy,
    langevin_step,
    mix_seed,
    state_generator,
    temperature,
    velocity_verlet_step,
)
from molecular_dynamics_tpu_torch.system import MDState

#: the pair ops ``SimulationConfig.kernel_variant`` chooses between
KERNEL_VARIANTS = ("ring", "dense")


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """Static rollout options."""

    dt_fs: float = 2.0
    integrator: str = "langevin"  # "langevin" | "nve"
    temperature: float = 300.0
    gamma_ps: float = 1.0
    energy: EnergyConfig = REFERENCE_CONFIG
    #: enable minimum-image wrapping against state.box. Off by default: the
    #: campaign workloads are vacuum / implicit-solvent systems.
    pbc: bool = False
    #: the composed force path: every 2-body term (LJ, Coulomb, bonds,
    #: Urey-Bradley, 1-4) from a pair op (``kernel_variant``), angles and
    #: torsions from ``ops.bonded.make_angle_torsion_op``, the bias from
    #: autograd. Differentiable: the pair ops carry their own backward.
    #: Requires the default term set and no PBC.
    fused_nonbonded: bool = False
    #: the pair op of ``fused_nonbonded``: ``"ring"`` (each unordered pair
    #: once, ``ops.ring.make_pair_ring_op``) or ``"dense"`` (every pair from
    #: both ends, ``ops.nonbonded.make_nonbonded_op``)
    kernel_variant: str = "ring"
    #: run whole save_every-step segments inside ONE launch of the campaign
    #: kernel (state resident on chip, in-kernel noise + analytic bonded
    #: forces). Fastest simulation path; not differentiable. Langevin + no
    #: PBC only.
    fused_campaign: bool = False
    #: constrain all bonds to hydrogen (NAMD rigidBonds all) via SHAKE/RATTLE:
    #: in the kernel on the campaign path, batched projection steps on the
    #: composed path.
    constrain_h_bonds: bool = False
    #: campaign path only: evaluate the LCPO SASA force once per this many
    #: steps and hold it (r-RESPA held-force cadence; 1 = every step). Must
    #: divide ``save_every``.
    sasa_every: int = 1
    #: campaign path only: apply the whole GB polar force (and the LCPO force
    #: when ``sasa_every`` equals it) as Verlet-I impulses once per this many
    #: steps (1 = every step). Must divide ``save_every``.
    gb_every: int = 1

    def __post_init__(self):
        if self.kernel_variant not in KERNEL_VARIANTS:
            raise ValueError(
                f"kernel_variant must be one of {KERNEL_VARIANTS}, "
                f"got {self.kernel_variant!r}"
            )


def _potential(ff: FFParams, config: SimulationConfig, bias):
    def potential(pos, box, step, energy_config=config.energy):
        e = total_energy(
            pos, ff, box=box if config.pbc else None, config=energy_config
        )
        if bias is not None:
            e = e + bias.energy(pos, step)
        return e

    return potential


def make_step_fn(
    ff: FFParams,
    config: SimulationConfig = SimulationConfig(),
    bias=None,
) -> Callable[..., MDState]:
    """Build the ``state -> state`` integrator step of one system (a batched
    state works too: every function underneath carries leading axes).

    The bias contributes energy at the state's step counter; its force
    arrives through autograd of the combined potential. The returned
    ``step_fn(state, noise=None, generator=None)`` passes its noise
    arguments to the Langevin step.
    """
    return make_ensemble_step_fn(ff, config, bias)


#: term sets the campaign kernel covers beyond the default one; both need
#: the GB tables on the force field
_CAMPAIGN_SOLVENT_TERM_SETS = (
    frozenset(DEFAULT_TERMS + ("gb",)),
    frozenset(DEFAULT_TERMS + ("gb", "sasa")),
)


def _require_kernel_coverage(
    flag: str, config: SimulationConfig, langevin_only: bool, ff: FFParams
):
    """Raise where ``config`` asks for a kernel path (``flag``) together with
    an option that kernel does not cover. A kernel flag never gives way to
    the autograd path: that path is taken only when the flag is off.

    ``fused_nonbonded`` covers the default term set. ``fused_campaign``
    (``langevin_only``) covers exactly three: the default set, the default
    set + ``gb``, and the default set + ``gb`` + ``sasa``, the last two only
    where ``ff`` carries the GB tables."""
    if config.pbc:
        raise ValueError(f"{flag}=True does not cover pbc=True: the kernel has no box")
    if langevin_only and config.integrator != "langevin":
        raise ValueError(
            f"{flag}=True covers integrator='langevin' only, "
            f"got {config.integrator!r}"
        )
    term_set = frozenset(config.energy.terms)
    if term_set == frozenset(DEFAULT_TERMS):
        return
    if langevin_only and term_set in _CAMPAIGN_SOLVENT_TERM_SETS:
        if not ff.has_gb:
            raise ValueError(
                f"{flag}=True with the term set {sorted(term_set)} needs GB "
                "tables on the FFParams (solvent.attach_gb_params)"
            )
        return
    covered = "the default term set" + (
        ", alone or with gb or gb + sasa" if langevin_only else ""
    )
    raise ValueError(
        f"{flag}=True covers {covered} ({sorted(DEFAULT_TERMS)}), "
        f"got the term set {sorted(term_set)}"
    )


def make_ensemble_step_fn(
    ff: FFParams,
    config: SimulationConfig = SimulationConfig(),
    bias=None,
) -> Callable[..., MDState]:
    """Ensemble step: operates directly on batched ``(R, ...)`` states.

    With ``config.fused_nonbonded`` the forces are composed as the JAX
    package composes them: the 2-body forces from the pair op of
    ``config.kernel_variant`` (one kernel launch over all replicas), angles
    and torsions from the angle-torsion op, minus the bias gradient. Both ops
    are differentiable, so a rollout differentiated through this path keeps
    every force's gradient. Otherwise the forces are autograd of the total
    energy, except those of the ``gb`` and ``sasa`` terms, which are analytic
    (``ops.gb.gb_forces``, ``ops.sasa.sasa_forces``) wherever the step need
    not be differentiated through and the wrapper answers the state: on a
    CUDA state their kernels take float32 within their shared-memory limits
    only (``gb_forces_holds``, ``sasa_forces_holds``, decided by dtype and
    size before any launch); a term they do not hold stays on autograd, as
    the JAX package computes every force. Positions that carry a graph keep
    every force on autograd. ``fused_nonbonded`` with PBC or a term set its
    kernels do not cover raises. ``step_fn(states, noise=None,
    generator=None)``.
    """
    potential = _potential(ff, config, bias)
    use_fused = config.fused_nonbonded
    ecfg = config.energy
    # without the GB tables the energy itself raises, at the first step
    solvent_terms = (
        tuple(t for t in ecfg.terms if t in ("gb", "sasa")) if ff.has_gb else ()
    )
    if use_fused:
        _require_kernel_coverage("fused_nonbonded", config, langevin_only=False, ff=ff)
        from molecular_dynamics_tpu_torch.ops.bonded import make_angle_torsion_op
        from molecular_dynamics_tpu_torch.ops.nonbonded import make_nonbonded_op
        from molecular_dynamics_tpu_torch.ops.ring import make_pair_ring_op

        make_pair = (
            make_pair_ring_op if config.kernel_variant == "ring" else make_nonbonded_op
        )
        pair_op = make_pair(
            ff,
            cutoff=ecfg.cutoff,
            switch_dist=ecfg.switch_dist,
            rfa=ecfg.rfa,
            solvent_dielectric=ecfg.solvent_dielectric,
            include_bonds=True,
            include_14=True,
            include_ub=resolve_urey_bradley(ecfg, ff),
        )
        at_op = make_angle_torsion_op(ff, dtype=ff.masses.dtype)
    elif solvent_terms:
        # neither term sees the box, so this holds with PBC too
        from molecular_dynamics_tpu_torch.ops import gb, sasa

        gb_tables = gb.build_gb_tables(ff) if "gb" in solvent_terms else None
        gb_consts = gb.gb_constants(ecfg.solvent_dielectric, ecfg.ion_concentration)
        sasa_tables = sasa.build_sasa_tables(ff) if "sasa" in solvent_terms else None
        # the analytic terms -> the energy config of the rest
        rest_cfgs = {}

        def analytic_terms(pos) -> Tuple[str, ...]:
            """The solvent terms whose wrapper answers ``pos`` (its device
            type, dtype and size); the others stay on autograd."""
            dev, dtype = pos.device.type, pos.dtype
            held = []
            if gb_tables is not None and gb.gb_forces_holds(dev, dtype, ff.n_atoms):
                held.append("gb")
            if sasa_tables is not None and sasa.sasa_forces_holds(
                dev, dtype, ff.n_atoms, sasa_tables.n_compact
            ):
                held.append("sasa")
            return tuple(held)

    cons = hydrogen_bond_constraints(ff) if config.constrain_h_bonds else None

    def step_fn(states: MDState, noise=None, generator=None) -> MDState:
        step = states.step

        def force_fn(pos, box):
            if use_fused:
                # the ops take (R, N, 3): one system is an ensemble of one
                flat = pos.reshape(-1, *pos.shape[-2:]).contiguous()
                f = (pair_op(flat)[1] + at_op(flat)[1]).reshape(pos.shape)
                if bias is not None:
                    f = f + _neg_grad(lambda p: bias.energy(p, step), pos)
                return f
            # the analytic forces carry no graph: positions that are
            # differentiated through stay on autograd below
            analytic = (
                analytic_terms(pos)
                if solvent_terms and not (torch.is_grad_enabled() and pos.requires_grad)
                else ()
            )
            if analytic:
                if analytic not in rest_cfgs:
                    rest_cfgs[analytic] = dataclasses.replace(
                        ecfg, terms=tuple(t for t in ecfg.terms if t not in analytic)
                    )
                rest_cfg = rest_cfgs[analytic]
                flat = pos.reshape(-1, *pos.shape[-2:]).contiguous()
                rest = _neg_grad(lambda p: potential(p, box, step, rest_cfg), pos)
                if "gb" in analytic:
                    rest = rest + gb.gb_forces(flat, gb_tables, gb_consts)[0].reshape(pos.shape)
                if "sasa" in analytic:
                    rest = rest + sasa.sasa_forces(
                        flat, sasa_tables, ecfg.surface_tension
                    )[0].reshape(pos.shape)
                return rest
            return _neg_grad(lambda p: potential(p, box, step), pos)

        if config.integrator == "nve":
            if cons is not None:
                return constrained_velocity_verlet_step(
                    states, force_fn, ff.masses, cons, config.dt_fs
                )
            return velocity_verlet_step(states, force_fn, ff.masses, config.dt_fs)
        if cons is not None:
            return constrained_langevin_step(
                states, force_fn, ff.masses, cons, config.dt_fs,
                config.temperature, config.gamma_ps,
                noise=noise, generator=generator,
            )
        return langevin_step(
            states, force_fn, ff.masses, config.dt_fs, config.temperature,
            config.gamma_ps, noise=noise, generator=generator,
        )

    return step_fn


def _observables(
    state: MDState, ff: FFParams, config: SimulationConfig, bias,
    n_constraints: Optional[int] = None,
):
    """Energies, temperature and colvar values of a state (or ensemble).
    ``n_constraints`` saves rebuilding the constraint list on every call
    (building it reads a mask back from the device)."""
    # same box handling as the force path, so logged energies match the
    # dynamics actually simulated
    with torch.no_grad():
        epot = total_energy(
            state.pos, ff,
            box=state.box if config.pbc else None,
            config=config.energy,
        )
        ekin = kinetic_energy(state.vel, ff.masses)
        if config.constrain_h_bonds:
            if n_constraints is None:
                n_constraints = hydrogen_bond_constraints(ff).n_constraints
            temp = constrained_temperature(ekin, ff.n_atoms, n_constraints)
        else:
            temp = temperature(ekin, ff.n_atoms)
        obs = {
            "step": state.step,
            "epot": epot,
            "ekin": ekin,
            "etot": epot + ekin,
            "T": temp,
        }
        if bias is not None:
            obs["colvar_center"] = bias.center(state.step)
            obs["colvar_value"] = bias.colvar(state.pos)
            obs["colvar_energy"] = bias.energy(state.pos, state.step)
    return obs


def _n_constraints(ff: FFParams, config: SimulationConfig) -> Optional[int]:
    if not config.constrain_h_bonds:
        return None
    return hydrogen_bond_constraints(ff).n_constraints


def _stack_logs(logs) -> dict:
    return {k: torch.stack([entry[k] for entry in logs]) for k in logs[0]} if logs else {}


def simulate(
    state: MDState,
    ff: FFParams,
    n_steps: int,
    save_every: int = 50,
    config: SimulationConfig = SimulationConfig(),
    bias=None,
) -> Tuple[MDState, torch.Tensor, dict]:
    """Run one system for ``n_steps``, emitting a frame every ``save_every``.

    Returns (final_state, frames (n_saves, N, 3), log dict of (n_saves,)
    tensors).
    """
    step_fn = make_step_fn(ff, config, bias)
    generator = state_generator(state)
    n_cons = _n_constraints(ff, config)
    frames, logs = [], []
    with torch.no_grad():
        for _ in range(n_steps // save_every):
            for _ in range(save_every):
                state = step_fn(state, generator=generator)
            frames.append(state.pos)
            logs.append(_observables(state, ff, config, bias, n_cons))
    return state, torch.stack(frames), _stack_logs(logs)


def _campaign_advance_fn(ff: FFParams, save_every: int, config: SimulationConfig, bias):
    """The campaign op for this config, or raise where the kernel does not
    cover it (there is no second path to fall to)."""
    from molecular_dynamics_tpu_torch.ops.fused_step import make_fused_campaign_op

    _require_kernel_coverage("fused_campaign", config, langevin_only=True, ff=ff)
    cons = None
    if config.constrain_h_bonds:
        hb = hydrogen_bond_constraints(ff)
        cons = hb if hb.n_constraints else None
    term_set = set(config.energy.terms)
    return make_fused_campaign_op(
        ff,
        n_inner=save_every,
        dt_fs=config.dt_fs,
        temperature=config.temperature,
        gamma_ps=config.gamma_ps,
        cutoff=config.energy.cutoff,
        switch_dist=config.energy.switch_dist,
        rfa=config.energy.rfa,
        solvent_dielectric=config.energy.solvent_dielectric,
        include_ub=resolve_urey_bradley(config.energy, ff),
        bias=bias,
        constraints=cons,
        gb="gb" in term_set,
        ion_concentration=config.energy.ion_concentration,
        sasa="sasa" in term_set,
        surface_tension=config.energy.surface_tension,
        sasa_every=config.sasa_every,
        gb_every=config.gb_every,
    )


def simulate_ensemble(
    states: MDState,
    ff: FFParams,
    n_steps: int,
    save_every: int = 50,
    config: SimulationConfig = SimulationConfig(),
    bias=None,
    mesh=None,
    axis_name: str = "replica",
    obs_every: int = 1,
    save_forces: bool = False,
):
    """Replica-ensemble rollout: ``states`` has a leading replica axis.

    With ``config.fused_campaign`` every ``save_every``-step segment is one
    launch of the campaign kernel. It covers Langevin dynamics without PBC on
    the default term set, alone or with ``gb`` or ``gb`` + ``sasa``
    (``GBIS_POLAR_CONFIG``, ``GBIS_CONFIG``; ``config.sasa_every`` and
    ``config.gb_every`` set their cadences and must divide ``save_every``);
    any other integrator, PBC, another term set, a force field without GB
    tables or a system the kernel cannot hold raises. The composed per-step
    path runs only when the flag is off. Each segment's thermostat seed
    is derived from the first replica's ``(key, step)``, so two segments
    never reuse a noise stream.

    ``obs_every`` logs the observables dict only every Nth saved frame
    (frames are still saved every ``save_every`` steps): the per-term energy
    evaluation costs a full dense force-field pass per save.
    ``n_steps // save_every`` must be divisible by it.

    ``save_forces=True`` additionally records the per-atom total forces of
    every saved frame.

    ``mesh`` (``parallel.get_mesh``) shards the replicas over its devices:
    ``states`` is the whole ensemble or the list of its shards that
    ``parallel.shard_ensemble`` made. Each shard advances on its own
    device. The campaign op runs through ``parallel.shard_campaign_advance``,
    whose per-shard seed offset gives every shard its own noise streams (at
    zero temperature the run equals the unsharded one). The composed path
    keeps the unsharded run's one noise stream: each step draws the whole
    ensemble's normals on the first device and hands each shard its rows,
    so it equals the unsharded run at any temperature. The outputs come
    back on the first device in replica order, shaped as without a mesh.
    Without a mesh the ensemble runs as the one shard of a mesh of its own
    device.

    Returns (final_states, frames (n_saves, R, N, 3), log of
    (n_saves // obs_every, R)); with ``save_forces``, (final_states, frames,
    log, forces (n_saves, R, N, 3)).
    """
    n_saves = n_steps // save_every
    obs_every = max(1, int(obs_every))
    if n_saves % obs_every:
        raise ValueError(
            f"n_steps // save_every = {n_saves} must be divisible by "
            f"obs_every = {obs_every}"
        )
    from molecular_dynamics_tpu_torch.parallel.mesh import (
        Mesh,
        gather,
        shard_campaign_advance,
        shard_ensemble,
        to_device,
    )

    # without a mesh the ensemble is one shard on its own device
    if mesh is None:
        mesh = Mesh((states.pos.device,), axis_name)
    shards = (list(states) if isinstance(states, (list, tuple))
              else shard_ensemble(states, mesh, axis_name))
    if len(shards) != mesh.size:
        raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size} devices")
    devices = mesh.devices
    first = devices[0]

    # one read-back for the whole run: the seed and step of replica 0
    key0 = int(shards[0].key.reshape(-1)[0])
    step0 = int(shards[0].step.reshape(-1)[0])
    n_rows = [s.pos.shape[0] for s in shards]
    shape = (n_saves, sum(n_rows)) + tuple(shards[0].pos.shape[1:])
    frames = torch.empty(shape, dtype=shards[0].pos.dtype, device=first)
    frc_frames = torch.empty_like(frames) if save_forces else None
    # each device's force field and bias
    on = {}
    for dev in devices:
        if dev not in on:
            on[dev] = (to_device(ff, dev), to_device(bias, dev))
    n_cons = _n_constraints(ff, config)
    logs = []

    if config.fused_campaign:
        advance = shard_campaign_advance(
            {dev: _campaign_advance_fn(ff_d, save_every, config, bias_d)
             for dev, (ff_d, bias_d) in on.items()}, mesh, axis_name)

        def segment(shards, step_now: int):
            pos, vel, frc = advance(
                [s.pos.contiguous() for s in shards], [s.vel.contiguous() for s in shards],
                [s.forces.contiguous() for s in shards], step_now, mix_seed(key0, step_now))
            return [s.replace(pos=p, vel=v, forces=f, step=s.step + save_every)
                    for s, p, v, f in zip(shards, pos, vel, frc)]

    else:
        step_fns = {dev: make_ensemble_step_fn(ff_d, config, bias_d)
                    for dev, (ff_d, bias_d) in on.items()}
        # one noise stream for the whole ensemble, drawn on the first device
        generator = torch.Generator(device=first)
        generator.manual_seed(mix_seed(key0, step0))
        draws = config.integrator != "nve"
        noise_shape = shape[1:]
        dtype = shards[0].vel.dtype

        def segment(shards, step_now: int):
            for _ in range(save_every):
                noise = (torch.randn(noise_shape, generator=generator, dtype=dtype, device=first)
                         if draws else None)
                lo = 0
                stepped = []
                for dev, s, r in zip(devices, shards, n_rows):
                    part = None if noise is None else noise[lo:lo + r].to(dev)
                    stepped.append(step_fns[dev](s, noise=part))
                    lo += r
                shards = stepped
            return shards

    with torch.no_grad():
        for s in range(n_saves):
            shards = segment(shards, step0 + s * save_every)
            lo = 0
            for x, r in zip(shards, n_rows):
                frames[s, lo:lo + r] = x.pos
                if save_forces:
                    frc_frames[s, lo:lo + r] = x.forces
                lo += r
            if (s + 1) % obs_every == 0:
                logs.append(gather([
                    _observables(x, on[dev][0], config, on[dev][1], n_cons)
                    for dev, x in zip(devices, shards)], first))

    states, log = gather(shards, first), _stack_logs(logs)
    if save_forces:
        return states, frames, log, frc_frames
    return states, frames, log


def smd_campaign_config(
    implicit_solvent: bool = False, sasa: bool = True
) -> Tuple[SimulationConfig, dict]:
    """The reference SMD data-generation protocol as config values:
    Langevin 300 K damping 1/ps, 2 fs steps, 500k steps, frames every 50,
    colvar 12 -> 34 A over the run.

    ``implicit_solvent=True`` switches the energy to the NAMD-campaign
    physics (GBIS with 0.1 M salt, rigid H bonds) instead of the vacuum
    config; ``sasa=True`` (default) adds the LCPO nonpolar term. Both run
    through the campaign kernel (``fused_campaign``).
    """
    if implicit_solvent:
        e_cfg = GBIS_CONFIG if sasa else GBIS_POLAR_CONFIG
    else:
        e_cfg = REFERENCE_CONFIG
    sim = SimulationConfig(
        dt_fs=2.0,
        temperature=300.0,
        gamma_ps=1.0,
        energy=e_cfg,
        constrain_h_bonds=implicit_solvent,
        fused_campaign=implicit_solvent,
    )
    colvar = {
        "fk": 1.0,
        "cent_0": 12.0,
        "cent_1": 34.0,
        "n_steps": 500_000,
        "save_every": 50,
    }
    return sim, colvar
