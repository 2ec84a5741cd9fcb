#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device, ``nvcc`` and ``g++``; without a device it exits
non-zero and prints no result. It imports ``molecular_dynamics_tpu_torch``
only, and loads the numpy file writer ``tests/torch_files.py`` and the
trained generation maps of ``tests/torch_trained.py`` by their paths.

Phases, one JSON line each on standard output:

1. ``env``: versions and the card's name and power limit.
2. ``build``: compiles every ``csrc/*.cu`` of the port (one ``nvcc`` each,
   all at once).
3. ``checks``: each kernel against its plain PyTorch version on the card, at
   the shapes of the main path (1024 replicas x 104 atoms x 50 steps), with
   the tolerances below; the thermostat generator's statistics; the campaign
   kernel on the tables build_ff_params makes for the 40-atom backbone (50 steps at
   1024 replicas, T = 0 and 300 K, and 50 = 25 + 25); the campaign
   kernel with GB and SASA on, at every step and at the ``sasa_every`` /
   ``gb_every`` cadences; the two pair-op kernels (dense-row
   ``nonbonded_rows`` and each-pair-once ``pair_tiles``, both on the per-atom
   pair layout with the chunk box test) and the pair-forces kernel (in each
   of its three CTA shapes) at 104 x 1024, 416 x 192, 1,040 x 96 and (the
   pair-op kernels only) 2,496 x 4, at 9 A with the reaction field and at
   16 A without it, the pair-op kernels also at 4,056 x 2, where the
   dense-row kernel opts in to more than 48 KB of shared memory, and the pair
   ops' backward at 8 x 416; the SASA kernel also above 48 KB of shared
   memory (two tiled copies, where it opts in to more), and raising when a
   neighbour list overflows (the pair pressed to a tenth); the GB kernel at
   208 atoms and the GBIS campaign kernel at 208 atoms, where its LCPO lists
   can overflow and the wrapper reads the flag. ``levers``: what each choice
   of the GB and LCPO layout and of the pair loop and the CTA shape buys,
   each taken out of a copy of
   ``csrc/`` (``LEVERS``), built beside the port's libraries while the
   checks run and timed against the kernel as built, in turns, each variant
   held to its run's tolerance; and the split of a vacuum launch (variants
   with the plain pairs, the special pairs or the angles and torsions
   compiled out).
4. ``campaign``: the main path through the public entry points: load the
   104-atom deca-alanine, FIRE-minimise, draw velocities, build the SMD bias
   at the measured end-to-end distance, replicate to 1024, and run
   ``simulate_ensemble`` for 2000 steps (40 launches of the campaign kernel)
   with rigid X-H bonds. Then the composed pair-op path at the same shape
   (the same entry point with ``fused_nonbonded``, 4 steps, one
   ``pair_tiles`` launch a step) against the all-autograd path, each
   kernel's launch count set to 0 just before its path and read just after,
   and a second, timed campaign call for aggregate steps/s. The standalone
   ``pair_forces`` kernel has no path of its own: it is the standalone launch
   of the campaign kernel's pair loop (``csrc/pair_loop.cuh``), and its line
   names the campaign kernel's launches as where that loop runs.
   ``gbis_campaign``: the implicit-solvent main path the same way: FIRE under
   ``GBIS_CONFIG``, 1024 replicas, ``simulate_ensemble`` for 2000 steps with
   GB-OBC II and LCPO SASA inside the campaign kernel, at ``sasa_every=1``
   and ``sasa_every=5``; then the GB and SASA kernels' own path (the same
   entry point on its composed per-step path, ``fused_campaign=False``,
   whose GB and LCPO forces are one ``gb_forces`` and one ``sasa_forces``
   launch a step); then the same entry point with no kernel flag on a state
   the GB and SASA kernels do not hold (104 atoms in float64), where those
   forces come from autograd, against 104, 416 and 506 atoms in float32,
   where both kernels launch (``solvent_dispatch``; the GB kernel at 416
   atoms runs without its dI cache, and is held there against its plain
   version at 192 replicas and timed; the SASA kernel at 506 atoms keeps its
   lists in a global workspace, and is held there at 128 replicas and
   timed). ``option_dispatch``: a kernel flag beside an option its kernels
   do not cover, at 1024 x 104 (fault C11): ``fused_campaign`` with
   ``GBIS_CONFIG`` and ``integrator="nve"`` (run A, 20 steps) and
   ``fused_nonbonded`` with ``pbc=True`` (run B) warn and equal the
   unflagged runs bit for bit; run A launches the GB and SASA kernels a step
   each and the campaign kernel never, run B neither pair-op kernel.
   ``gbis_tiers``: the GBIS campaign through the campaign kernel at 208
   atoms x 384 replicas and 416 x 192 (``tiled_decaalanine(m)``, m = 2, 4,
   copies of the GBIS-minimised structure; SMD bias on copy 0's ends, atom
   0 against atom 103; rigid X-H bonds, 2 fs, 300 K): the kernel (its
   512-thread instantiation without GB's dI cache) against its plain
   version, 5 steps in float32 and 50 against float64, on the same normals;
   its time a launch beside its bound; ``simulate_ensemble(fused_campaign)``
   for 2000 steps with the campaign gates and 40 launches, at 416 atoms
   under ``GBIS_CONFIG`` at ``sasa_every`` 1 and 5 and under
   ``GBIS_POLAR_CONFIG`` at ``gb_every=5`` (at 208 atoms the checks and
   the time a launch only);
   ``cli simulate`` under ``GBIS_CONFIG`` on the 416-atom system written as
   a chamber prmtop; the 416-atom launch with the LCPO lists in shared
   memory and in the global workspace, timed in turns (the measurement
   ``fused_step.campaign_sasa_lists_global`` rests on); the same checks,
   timing and 2000-step run at ``sasa_every=1`` on di-alanine tiled 23
   times (506 atoms x 128 replicas, 230 heavy atoms: the LCPO lists in a
   global workspace; copies on a grid 50 A apart, bias on copy 0's first
   and last heavy atom), with no composed-path warning; and both solvent
   instantiations and both GB kernels (with and without the cache) at 104
   and 208 atoms, timed in turns: the measurement the switch point
   ``gb.GB_CACHE_MAX_ATOMS`` rests on.
   ``cadence``: the cadences' long-run soundness: NVE traces (gamma = 0, 1
   fs, no constraints, 10,000 steps, E_tot once a launch) through the
   campaign kernel at 104 atoms x 1024 replicas under ``GBIS_POLAR_CONFIG``
   at ``gb_every`` 1, 2, 5 and ``GBIS_CONFIG`` at ``sasa_every`` 1, 5, and at
   416 x 128 at ``gb_every`` 1 and 5: the fitted drift of E_tot over the
   run at k > 1 within 1.0 kcal/mol (a 104-atom copy) of k = 1's.
   ``tiers``: the composed, differentiable pair-op path at the system sizes
   of the tier table: ``tiled_decaalanine(m)`` for m = 1, 4, 8, 10 at 768, 192,
   96 and 96 replicas, FIRE, then 500 steps of 1 fs at 300 K, unconstrained,
   through ``simulate_ensemble`` with ``fused_nonbonded`` at both
   ``kernel_variant``s and with ``fused_campaign`` (above 104 atoms after a
   check of the campaign kernel against its plain version there): aggregate
   steps/s and each kernel's launches per (size, path), then each kernel's
   time a launch at each size, for the campaign and pair-forces kernels
   with their bound, SFU bound and build facts (threads, registers, CTAs an
   SM, SMs used, waves; the two kernels must run the same CTA shape);
   the campaign kernel alone at 12 copies (1,248 atoms, the most it holds:
   checked against its plain version, one launch through
   ``simulate_ensemble``, timed); and the CTA-shape levers of the campaign
   kernel and the group, box-test and CTA levers of the pair-op kernels at
   416 x 192 and 1,040 x 96. The pair kernels (pair-forces, dense-row,
   pair-tile) are timed on the card (``device_ms``: torch.profiler's kernel
   time, the median of three 20-call windows), their back-to-back launches
   beside.
   ``grad``: gradients through 10 steps of the composed path (ring, dense)
   against the all-autograd path, 416 atoms x 8 replicas.
   ``cli``: the command line (``molecular_dynamics_tpu_torch.cli.main``),
   three ``simulate`` campaigns of 1024 replicas x 2000 steps through the
   campaign kernel into a temporary directory: (a) ``example:full`` in
   vacuum (rigid X-H bonds, 2 fs), (b) the same under ``GBIS_CONFIG`` from a
   JSON config, (c) the generated 40-atom backbone at 1 fs. Each: 40 kernel
   launches, the printed rate, the seconds outside ``simulate_ensemble``
   (the start, ``cli.prepare_campaign``, timed inside the run, and the files),
   frames finite, T in 150-350 K, mean abs(colvar - centre) < 2 A, replicas
   apart, every file there with its shape and ``rep0.dcd`` read back equal
   to replica 0's frames. Then ``energy`` on ``example:full`` and on the
   in-repo PSF / PDB / YAML system against ``energy_terms`` in float64, and
   ``simulate`` with ``fused_nonbonded`` at both ``kernel_variant``s, 8
   replicas x 50 steps, one pair-tile or dense-row launch a step.
   ``host_io``: the packaged 104-atom tables written as a CHARMM chamber
   prmtop by the numpy writer of the CPU tests (``tests/torch_files.py``,
   loaded by path), with a PDB of the start: ``energy`` on it against
   ``energy_terms`` of ``example:full`` in float64, and its tables against
   the packaged ones in float64 on the card under ``REFERENCE_CONFIG`` and
   ``GBIS_CONFIG``; ``simulate topology=<prmtop> coordinates=<pdb>`` at
   1024 x 2000 in vacuum (rigid X-H bonds, 2 fs) and under ``GBIS_CONFIG``
   with the cli campaigns' gates and 40 campaign-kernel launches each,
   their rates beside ``example:full``'s; a CHARMM ``.prm`` with one
   periodic 24 x 24 CMAP map on the alanine key, read by ``CharmmPrm`` and
   attached on the rows ``ff.builder`` derives: energy and forces with the
   ``cmap`` term in float32 on 1024 jittered states against float64 on the
   CPU, ``simulate_ensemble`` with no kernel flag for 50 steps (no kernel
   launches), ``tile_ff_params(m=4)`` against four copies, ``repulsion`` /
   ``repulsioncg`` in float32 against float64; ``convert`` on the golden
   xtc (the C++ decoder equal to the pure-Python one, the re-encoding equal
   to the file's bytes), replica 0's frames through the native xtc and
   mdxtc writers and ``convert`` within their quantisation, and through
   the asynchronous sink in both formats.
   ``parallel``: several devices on the one card (its two gloo ranks start
   with the script and wait for it). ``simulate_ensemble``
   with a mesh of two shards on ``cuda:0`` on the 1024 x 2000 campaign in
   vacuum and under ``GBIS_CONFIG``: at 0 K equal to the unsharded call
   within 1e-6 A; at 300 K from the identical replicas of the main path,
   the campaign's gates, replica j and 512 + j apart (the shards' noise
   streams differ), 80 kernel launches a run (2 x 40), the rate beside
   the unsharded call's. The data-parallel path (``parallel.data``) at
   world size 1 (NCCL, in this process) and 2 (gloo, both ranks on
   ``cuda:0``): one pretrain and one informed update of the 40-atom
   generator at published widths, batch 32, against one process (loss,
   the all-reduced gradient and the generator after it within 1e-5
   relative), and ``run_training``'s rank body on a short pretrain run
   whose files rank 0 writes once. ``cli simulate | train --devices N``
   with N above the visible count raise, naming it.
   ``bench``: ``bench_torch.py``'s three protocols (vacuum, ``gbis``,
   ``gbis_sasa``; a warm-up and three timed calls each): its record with
   the median and the spread, and the campaign kernel's launches.
   ``regenerate``: the SMD data-generation twin
   (``python -m molecular_dynamics_tpu_torch.regenerate_smd --gbis``), 64
   replicas x 20,000 steps through the campaign kernel (400 launches),
   every replica's frames written: frames finite, T over the second half in
   150-350 K, mean colvar lag under 2 A, every file there; then ``cli train
   cgan`` on those frames (104 atoms, stride 10, 1 epoch): finite losses,
   ``eval.json``, the log and the generated ``.xyz`` / ``.pdb``.
   ``train``: ``cli train pretrain --epochs 4`` and ``cli train cgan
   --epochs 3`` on the in-repo 40-atom data (batch 32, seed 0) under the
   JAX package's live-quality ceilings (mean_abs_error 2.20 / 2.60 A); one
   informed and one pretrain step on the card against the same step in
   float64 on the CPU (loss, gradient norm and direction); a launch census
   of one informed step at 40 and 104 atoms (generator, energy, backward,
   optimizer) with the device's busy share; the update rates of the four
   phases; the flagship forward (generated structures and their energies,
   batch 8), timed. The training path launches no kernel; the run fails if
   it does.
   ``dynamics``: the Hamiltonian dynamics line on the same data: ``cli
   train node --epochs 8`` under the JAX package's live-quality ceiling
   (mean_abs_error 1.10 A), ``hnn`` and ``hnn-latent`` at 1 epoch and
   ``hnn-schnet`` at 1 under the 100 A sanity bound (eval.json finite, the generated
   rollouts finite); from the four runs' trained weights, every step kind
   (HNN and SchNet HNN L2, informed and 10-step unroll; node's RK4 step and
   10-frame chained-solver update; the latent HNN's update) on the card
   against float64 on the CPU (loss, gradient norm and direction, the
   parameters after one clipped-Adam update); the update rates of each at
   40 atoms x batch 32; a launch census of an HNN informed step and a node
   unroll update (field, energy, backward, optimizer) with the device's
   busy share. No kernel launches there either; the run fails if one does.
   ``sequence``: the sequence and graph line on the same data: ``cli train
   lstm --epochs 8`` and ``lstm-gat --epochs 6`` under the JAX package's
   live-quality ceilings (mean_abs_error 3.20 / 3.00 A), ``lstm-nll``,
   ``seq2seq``, ``seq2seq-gan``, ``transformer``, ``gat`` and
   ``seq2seq-graph`` at 1 epoch under the 100 A sanity bound; from the
   runs' trained weights, every step kind (the lstm window step and its
   8-window fine-tune, the lstm-nll step, the seq2seq step, seq2seq-gan's
   generator and critic steps, the transformer's step and fine-tune, the
   gat and lstm-gat steps and 8-frame fine-tunes, the seq2seq-graph step
   and its fine-tune of 4 chained segments) on the card against float64 on
   the CPU, with the same draws and kNN graphs (loss, gradient norm and
   direction within 1e-5, the update within 1e-3, or within 10x the same
   step's error in float32 on the CPU where that is larger); the update
   rates of each at 40 atoms x batch 32 (fine-tunes 16 rows); a launch
   census of an lstm and a
   seq2seq-graph fine-tune update (LSTM layers, graphs, refeaturizer,
   backward, optimizer) with the device's busy share. No kernel launches
   there; the run fails if one does.
   ``generative``: the generative line on the same data: ``cli train
   flow``, ``vae``, ``aae`` and ``sde`` at 2 epochs under the 100 A sanity
   bound (``sde``'s marginal TV in [0, 1]); from the runs' trained weights,
   every step kind (the flow's NLL step, the VAE step, the AAE's
   autoencoder and critic steps, the SDE-GAN's generator step, its critic
   step with the gradient penalty and its potential-injection step) on the
   card against float64 on the CPU with the same draws, as the sequence
   phase holds them, and the weight average; the update rates of each at
   40 atoms x batch 32; a launch census of an SDE critic step with the
   penalty and of an injection step (generator, critic, penalty, energy,
   backward, optimizer) with the device's busy share. No kernel launches
   there either; the run fails if one does.
   ``trained_generation``: the generation maps of ``gat``, ``hnn-schnet``
   and ``seq2seq-graph`` from the JAX package's trained weights (the drivers
   at ``epochs=0``, two starts of the in-repo data at the full rollout
   length, seq2seq-graph's decoder draws replayed), each eval.json key
   within 2e-3 A of the JAX package's on the CPU; the weights, draws and
   numbers are kept in ``tests/goldens/trained_generation`` and the map in
   ``tests/torch_trained.py`` (loaded by path). No kernel launches there;
   the run fails if one does.
5. ``profile``: the campaign call again under ``torch.profiler``: device
   time summed over kernel rows, the device's busy and idle share; the same
   for 50 steps of the composed pair-op path at 416 x 192, with the kernels
   it launches a step; and a launch census of one composed step there (ring
   and dense, with the SMD bias): launches and host ms by source (pair op,
   angle-torsion forward and its autograd pass, bias gradient, BAOAB
   update) and the device's busy share.
6. the card's name and power limit as ``nvidia-smi`` prints them, the
   ``kernels`` line (per kernel: launches counted on the main path and, in
   ``launches_by_path``, on each path that runs it, error
   against the plain version, time per launch, the plain version's time, the
   least time the card could take, and beside it the least time its SFU
   could take for the transcendentals; for the campaign, GB and SASA kernels
   also registers a thread, shared memory, CTAs an SM from the occupancy API
   and the waves 1024 replicas make; for the campaign kernel the split of a
   vacuum launch into plain pairs, special pairs, angles and torsions,
   constraints and the rest, and of a GBIS launch into its fast part, GB and
   LCPO; for the pair-forces, pair-op and campaign kernels the bound counts
   the pair tests of the chunk pairs whose boxes lie within the cutoff and
   the bytes of the per-atom pair layout, and ``bound_ms_dense`` beside it
   the dense-table design's count; for the pair-op kernels also registers,
   CTAs an SM and SMs used), and the final ``ok`` line.
   The ``build`` phase carries what ``nvcc -Xptxas -v`` printed of each
   kernel's registers, shared memory and spills.

Any failed check ends the run with a non-zero exit code.
"""

import ast
import contextlib
import csv
import ctypes
import dataclasses
import functools
import hashlib
import importlib.util
import io
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device; this script measures on the card only",
          file=sys.stderr)
    sys.exit(2)

import molecular_dynamics_tpu_torch as mdx
from molecular_dynamics_tpu_torch.bias import HarmonicSMDBias
from molecular_dynamics_tpu_torch.constraints import hydrogen_bond_constraints
from molecular_dynamics_tpu_torch.energy import (
    DEFAULT_TERMS,
    GBIS_CONFIG,
    GBIS_POLAR_CONFIG,
    REFERENCE_CONFIG,
    EnergyConfig,
    _neg_grad,
    energy_and_forces,
    energy_terms,
    total_energy,
)
from molecular_dynamics_tpu_torch import cli
from molecular_dynamics_tpu_torch.examples import (
    BACKBONE_FF_PRM,
    decaalanine_backbone,
    decaalanine_full,
    dialanine,
    tiled_decaalanine,
)
from molecular_dynamics_tpu_torch.ff import YamlForceField, build_ff_params
from molecular_dynamics_tpu_torch.config import CampaignConfig, apply_overrides
from molecular_dynamics_tpu_torch.integrate import (
    initialize_forces,
    maxwell_boltzmann,
    minimize_fire,
    mix_seed,
)
from molecular_dynamics_tpu_torch.ops import _build
from molecular_dynamics_tpu_torch.ops import fused_step, gb, nonbonded, ring, sasa
from molecular_dynamics_tpu_torch import solvent
from molecular_dynamics_tpu_torch.sim import (
    SimulationConfig,
    _campaign_advance_fn,
    make_ensemble_step_fn,
    simulate_ensemble,
)
from molecular_dynamics_tpu_torch.ff import builder as ff_builder
from molecular_dynamics_tpu_torch.ff.params import attach_cmap_params, tile_ff_params
from molecular_dynamics_tpu_torch.io import (
    CharmmPrm,
    native,
    prmtop_to_ff_params,
    read_dcd,
    read_pdb,
    read_psf,
    read_xyz,
    write_pdb,
)
from molecular_dynamics_tpu_torch.io.xtc import read_xtc_py
from molecular_dynamics_tpu_torch.system import MDState, replicate, system_init
from molecular_dynamics_tpu_torch import regenerate_smd
from molecular_dynamics_tpu_torch.models import Discriminator, Generator
from molecular_dynamics_tpu_torch.train import cgan as tcgan
from molecular_dynamics_tpu_torch.train.common import ClippedAdam
from molecular_dynamics_tpu_torch.train.drivers import GENERATED

N_REPLICAS = 1024
N_INNER = 50
N_STEPS = 2000
PAIR_PATH_STEPS = 4  # steps of the fused_nonbonded path, one pair_tiles launch each
SOLVENT_PATH_STEPS = 4  # steps of the composed GBIS path, one gb_forces + one sasa_forces launch each
#: the GBIS campaign at the tier sizes: tiled_decaalanine(m) at the tier
#: table's replica count (416 x 192; 208 x 384 between it and 104 x 768)
GBIS_TIERS = ((2, 384), (4, 192))
#: the GBIS tier past the LCPO lists' room in shared memory: di-alanine
#: tiled DIALA_TIER[0] times (506 atoms, 230 heavy atoms: K1 and K4 keep the
#: lists in a global workspace) at DIALA_TIER[1] replicas, one wave of one
#: CTA an SM on 132 SMs
DIALA_TIER = (23, 128)
#: FIRE steps of the di-alanine copy under GBIS_CONFIG: the largest force
#: falls from 57 to about 1.3 kcal/mol/A in 100 (FIRE's steps are
#: launch-bound, about 24 ms each on the card: 500 took 12 s)
DIALA_FIRE_STEPS = 100
#: the runs of simulate_ensemble(fused_campaign) at a GBIS tier: (label,
#: energy, sasa_every, gb_every); the 208-atom tier runs the first only
GBIS_TIER_RUNS = (("sasa_every=1", GBIS_CONFIG, 1, 1), ("sasa_every=5", GBIS_CONFIG, 5, 1),
                  ("polar,gb_every=5", GBIS_POLAR_CONFIG, 1, 5))
#: the cadence phase: NVE traces (gamma = 0, 1 fs, no constraints) through
#: the campaign kernel, the total energy once a launch; (label, energy,
#: sasa_every, gb_every, the every-step arm it is held against). A replica's
#: E_tot swings by about 5 kcal/mol (104 atoms) from save to save, so its
#: fitted drift over the run scatters by about 4 kcal/mol from replica to
#: replica (with 8 replicas the k = 5 and k = 1 means parted by 1.2 kcal/mol
#: of that noise alone; with 256, by 0.42 +- 0.35; H100 80GB HBM3 at 700 W):
#: the arms run the main path's 1024 replicas, so that the gap between two
#: arms' means is known to about a sixth of the bound
CADENCE_STEPS = 10_000
CADENCE_REPLICAS = 1024
CADENCE_ARMS = (
    ("polar,gb_every=1", GBIS_POLAR_CONFIG, 1, 1, None),
    ("polar,gb_every=2", GBIS_POLAR_CONFIG, 1, 2, "polar,gb_every=1"),
    ("polar,gb_every=5", GBIS_POLAR_CONFIG, 1, 5, "polar,gb_every=1"),
    ("gbis,sasa_every=1", GBIS_CONFIG, 1, 1, None),
    ("gbis,sasa_every=5", GBIS_CONFIG, 5, 1, "gbis,sasa_every=1"),
)
#: the arms run at 416 atoms too, at fewer replicas
CADENCE_ARMS_416 = ("polar,gb_every=1", "polar,gb_every=5")
CADENCE_REPLICAS_416 = 128  # one wave of CTAs at one an SM
#: the fitted drift of E_tot over a run at k > 1 against k = 1's: the JAX
#: package's bound on the k = 5 NVE trace of the 104-atom system
#: (tests/test_fused_gb.py, TestGBMultipleTimestepping.
#: test_nve_energy_trace_matches_every_step); the drift is extensive, so the
#: tiled system is held to it per 104-atom copy
CADENCE_DRIFT_BOUND = 1.0  # kcal/mol a copy
SEED = 20240914
# the composed pair-op path at the system sizes of the JAX package's tier
# table (scripts/bench_tiers.py): m tiled copies of the 104-atom system and
# the replicas of each, 768/m as there, and 1,040 atoms x 96 replicas
TIERS = ((1, 768), (4, 192), (8, 96), (10, 96))
# the shapes K5 and K6 are checked at: the main path's, the tier table's
# 416 x 192 and 1,040 x 96, and 2,496 x 4 (above the 2,048 atoms the
# pair-forces kernel holds)
PAIR_OP_SHAPES = ((1, 1024), (4, 192), (10, 96), (24, 4))
# the dense-row kernel above 48 KB of shared memory: 39 copies, 4,056 atoms
K5_OPT_IN_SHAPE = (39, 2)
TIER_STEPS = 500
TIER_SAVE = 50
#: the profile phase's composed ring run at 416 x 192: 413 launches a step,
#: the same every step; at TIER_SAVE steps reading the trace back took 14 s
PROFILE_COMPOSED_STEPS = 10
GRAD_STEPS = 10  # the grad phase: 416 atoms x 8 replicas, T = 0
CLI_CHECK_REPLICAS = 8   # the cli phase's fused_nonbonded runs: 8 replicas x 50 steps
CLI_CHECK_STEPS = 50
#: the in-repo PSF / PDB / YAML system (TorchMD's recorded backbone)
GOLDENS = pathlib.Path(__file__).resolve().parent / "tests" / "goldens"
#: the regenerate phase: the SMD data-generation campaign under GBIS at 64
#: replicas, cut to 20,000 steps; the pull keeps the campaign's pace
#: (0.88 A = 22 A x 20,000 / 500,000 steps)
REGEN_REPLICAS = 64
REGEN_STEPS = 20_000
REGEN_PULL = 0.88
#: the train phase: the in-repo 40-atom SMD data (16 trajectories x 320
#: frames) and the live-training budgets and ceilings of the JAX package's
#: quality guard (tests/test_train_quality.py, LIVE_BUDGET): an untrained
#: generator scores above 4 A there
TRAIN_DATA = pathlib.Path(__file__).resolve().parent / "datasets" / "backbone_smd"
TRAIN_BUDGET = {"pretrain": (4, 2.20), "cgan": (3, 2.60), "node": (8, 1.10), "lstm": (8, 3.20),
                "lstm-gat": (6, 3.00)}
TRAIN_BATCH = 32
#: the dynamics phase: ``node`` at its live budget above; the three HNN
#: families below, and the generative families at this depth, held to the
#: sanity bound of the JAX package's driver test (tests/test_train.py:
#: generated e2e within 100 A of the data)
DYNAMICS_EPOCHS = 2
DYNAMICS_SANITY_A = 100.0
#: ``hnn-schnet``'s sanity run at one epoch: its (32, 40, 40, 64) filters,
#: differentiated twice, took 48.8 s of a two-epoch run against 5.6 s at
#: one (H100 80GB HBM3 at 700 W); the same gate
SCHNET_EPOCHS = 1
#: ``hnn`` and ``hnn-latent`` at one epoch too, under the same gate (at two
#: they took 7.4 and 4.9 s, H100 80GB HBM3 at 700 W): room for the GBIS
#: tiers and the cadence phase, after the sequence families' cut
HNN_SANITY_EPOCHS = 1
#: the sequence phase: ``lstm`` and ``lstm-gat`` at their live budgets
#: above, the other six at SEQUENCE_SANITY_EPOCHS under the sanity bound (at
#: two epochs they took 127 s of the phase's 268, H100 80GB HBM3 at 700 W:
#: one epoch makes room for the GBIS tiers and the cadence phase)
SEQUENCE_SANITY_EPOCHS = 1
#: the sanity runs' unrolled fine-tunes at one epoch each (the drivers'
#: defaults are 4, 6 and 4: at those ``transformer`` took 69.3 s, ``gat``
#: 17.5 s and ``seq2seq-graph`` 18.7 s of the phase's 238.5, H100 80GB HBM3
#: at 700 W); the live-budget families keep their drivers' defaults
SEQUENCE_SANITY_FT = {"transformer": {"MDX_TRANSFORMER_FT_EPOCHS": "1"},
                      "gat": {"MDX_GAT_FT_EPOCHS": "1"},
                      "seq2seq-graph": {"MDX_GSEQ_FT_EPOCHS": "1"}}
SEQUENCE_FAMILIES = ("lstm", "lstm-gat", "lstm-nll", "seq2seq", "seq2seq-gan", "transformer",
                     "gat", "seq2seq-graph")
#: each sequence step kind on the card against float64: the loss, the
#: gradient's norm and direction, relative (the update within TOL_TRAIN_STEP)
TOL_SEQUENCE_STEP = 1e-5
#: the generative phase: the four families at DYNAMICS_EPOCHS under the
#: sanity bound (they have no live budget in the JAX package's guard)
GENERATIVE_FAMILIES = ("flow", "vae", "aae", "sde")
DYNAMICS_FAMILIES = ("node", "hnn", "hnn-latent", "hnn-schnet")
#: the dynamics, sequence and generative censuses' steps: every step of a
#: kind launches the same kernels, and at 5 reading their traces back took
#: 52 s (H100 80GB HBM3 at 700 W)
CENSUS_STEPS = 2
#: the ``cli train`` runs of the train, dynamics, sequence and generative
#: phases go TRAIN_WORKERS at a time, each in a process of its own, in
#: TRAIN_LONGEST_FIRST's order (the rest after): each run is host-bound (the
#: device 5-16 % busy), and one after another they took about 400 s of the
#: script (H100 80GB HBM3 at 700 W). Their wall seconds are read under that
#: sharing; the phases' steps against float64, update rates and censuses
#: run after the last of them, in this process alone
TRAIN_WORKERS = 4
TRAIN_LONGEST_FIRST = ("node", "lstm-gat", "lstm", "cgan", "transformer", "sde", "pretrain",
                       "seq2seq-graph", "gat", "flow", "hnn-schnet")
#: the host_io phase: the packaged 104-atom tables written as a chamber
#: prmtop by the numpy writer of the CPU tests (loaded by path, the one file
#: of tests/ this script reads)
TEST_FILES = pathlib.Path(__file__).resolve().parent / "tests" / "torch_files.py"
#: the trained_generation phase: the port's generation maps from the JAX
#: package's trained weights, and the goldens they are held to
TEST_TRAINED = pathlib.Path(__file__).resolve().parent / "tests" / "torch_trained.py"
FULL_DA_NPZ = (pathlib.Path(__file__).resolve().parent / "molecular_dynamics_tpu_torch"
               / "examples" / "data" / "full_da.npz")
#: the prmtop system against the packaged one in float64 on the card, term
#: by term: the tables pass through %16.8E text (9 significant digits), and
#: the packaged qq_pair is a float32 product
TOL_PRMTOP_REL = 2e-6
#: the CHARMM22 alanine CMAP key, which the packaged system's types carry
ALA_CMAP_KEY = ("C", "NH1", "CT1", "C", "NH1", "CT1", "C", "NH1")
CMAP_STEPS = 50  # simulate_ensemble with no kernel flag on the CMAP system
#: float32 on the card against float64 on the CPU on 1024 jittered states:
#: the total energy (relative), forces (relative to the largest), and the
#: cmap term alone (kcal/mol)
TOL_F32_ENERGY_REL = 1e-5
TOL_F32_FORCE_REL = 1e-4
TOL_F32_CMAP_ABS = 1e-4
#: trajectory codecs: xtc at 1000 / nm (0.01 A steps), mdxtc at 10000 / nm
XTC_QUANT_A = 0.011
MDXTC_QUANT_A = 1e-3
GOLDEN_XTC_SHA256 = "77ba35f14e78995e568fbdfd66a68714c4bd2257168498527967fec8ee1d4d51"
#: where float32 itself misses those tolerances on a step (the same step in
#: float32 on the CPU against float64), the card is held within this factor
#: of float32's own error instead
FLOAT32_FLOOR = 10.0
#: the float64 step checks of the SchNet HNN run at this batch (its filters
#: are (B, 40, 40, 64) tensors, and the CPU side differentiates ten chained
#: frames of them twice); the others at TRAIN_BATCH
SCHNET_CHECK_BATCH = 8
#: one informed and one pretrain step on the card (float32) against the same
#: steps on the CPU in float64: loss, gradient norm and direction, the
#: generator's parameters after both, and the clipped Adam's change on the
#: same gradients, relative
TOL_TRAIN_STEP = 1e-3

# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth. The kernels do float32 arithmetic only.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Operation counts read off csrc/pair_terms.cuh and csrc/campaign_advance.cu.
# The bound counts what the function needs, not what the kernels do: every
# unordered pair once (Newton's third law), its force added on both ends.
# K1, K2 and K6 evaluate each pair once too; K5 from both ends.
FLOPS_PAIR_TEST = 9          # dx, dy, dz, d2 and the cutoff compare, every unordered pair
FLOPS_PAIR_TERM = 52         # pair_term<false>, live unordered pairs
FLOPS_PAIR_ACCUM = 6         # f -= coeff * (dx, dy, dz) on one end; two ends a pair
FLOPS_PAIR_ENERGY = 12       # what pair_term<true> adds
FLOPS_ANGLE = 80
FLOPS_TORSION_BASE = 150
FLOPS_TORSION_TERM = 12
FLOPS_CONSTRAINT_SWEEP = 40  # one constraint in one SHAKE or RATTLE sweep, scatter included
FLOPS_ATOM_STEP = 60         # kicks, drifts, O-step, Box-Muller, bias, per atom and step
# csrc/gb_terms.cuh, per unordered pair (GB has no cutoff: every pair is live).
# A division, a square root, an expf or a logf counts as one operation.
FLOPS_GB_GEOMETRY = 10       # dx, dy, dz, d2, 1/sqrt, d: once a pair
FLOPS_GB_HCT = 30            # hct_pair<false>, one direction (two a pair)
FLOPS_GB_HCT_DERIV = 22      # what hct_pair<true> adds, one direction (two a pair)
FLOPS_GB_STILL = 40          # the Still term with salt: expf twice, 1/sqrt, u, du, coeff
FLOPS_GB_ACCUM = 10          # force on one end + its dE/dR share; two ends a pair
FLOPS_GB_ENERGY = 3
FLOPS_GB_ATOM = 40           # OBC tanh rescaling, self term, chain cotangent
# csrc/sasa_terms.cuh
FLOPS_SASA_GEOMETRY = 12     # per unordered pair of the compact set: distance and window test
FLOPS_SASA_AREA = 8          # a_pq, per overlapping ordered pair
FLOPS_SASA_PAIR = 30         # per overlapping ordered pair: area sum, W, da/dd, force
FLOPS_SASA_B = 1             # per (p, q overlapping, k in N(p)): B_pq += a_qk
FLOPS_SASA_G = 3             # per (p, q overlapping, i in N(p) and N(q)): the W sum
FLOPS_SASA_ATOM = 10
# The second bound, the SFU's: transcendental operations each function needs
# (a division, square root, reciprocal square root, exponential, logarithm,
# sine or cosine counts one, the one SFU instruction at the heart of its
# sequence). csrc/gb_terms.cuh per unordered pair: 1/d (2), each of the two
# HCT directions two divisions and a logarithm (6), the Still term two
# exponentials with salt, a square root and a division (4).
SFU_GB_PAIR = 12
SFU_GB_ATOM = 4              # tanh (2), 1/R, the self term's exponential
SFU_SASA_PAIR = 2            # per unordered pair of the compact set: 1/d
SFU_PAIR_LIVE = 2            # pair_term: 1/d, per live unordered pair
SFU_ANGLE = 5                # atan2, a square root, two 1/sqrt, a division
SFU_TORSION_BASE = 7         # atan2, a square root, five divisions
SFU_TORSION_TERM = 1         # a sine per term
SFU_CONSTRAINT_SWEEP = 1     # a division (SHAKE) or 1/sqrt (RATTLE) per sweep
SFU_ATOM_STEP = 7            # Box-Muller: two logarithms, two roots, three sines/cosines
# An H100 SM issues 128 float32 FMAs (256 flops) and 16 SFU operations a
# clock (4 SFUs in each of its 4 sub-partitions; NVIDIA H100 white paper)
PEAK_SFU_OPS = PEAK_F32_FLOPS / 16

# Tolerances. The kernel and its plain version do the same float32 arithmetic
# in another order (and rsqrtf/atan2f are 2-ulp functions), so they agree to
# float32 rounding of the largest terms: stiff bonds of k ~ 300-500
# kcal/mol/A^2 turn 1e-6 A into 1e-3 kcal/mol/A.
TOL_PAIR_FORCE = 2e-3    # kcal/mol/A
TOL_PAIR_ENERGY = 5e-3   # kcal/mol
TOL_POS = 1e-4           # A, n_inner <= 5
TOL_VEL = 5e-3           # A per AKMA time
TOL_FRC = 0.15           # kcal/mol/A
TOL_POS_50 = 1e-3        # A, n_inner = 50: float32 trajectories drift apart
TOL_NOISE = 1e-4         # kernel normals vs the PyTorch Philox
TOL_TABLES = 1e-4        # plain f64 vs autograd f64: the pair tables are float32
# GB and SASA: forces of O(10) and O(0.1) kcal/mol/A, energies of O(50) and
# O(5) kcal/mol; the far-pair cancellation of the HCT integral is what float32
# costs (the JAX kernel is pinned 5.4e-4 from float64, bound 5e-3)
TOL_GB_FORCE = 5e-4      # kernel vs plain float32
TOL_GB_ENERGY = 2e-3
TOL_SASA_FORCE = 1e-5
TOL_SASA_ENERGY = 1e-4
TOL_F32_VS_F64 = 5e-3    # plain float32 vs plain float64, forces and energies
TOL_AUTOGRAD_F64 = 1e-7  # plain float64 vs autograd of the float64 energy
# the pair ops' backward against autograd of their float32 reference: the
# same arithmetic, so only the order of a few sums differs
TOL_BACKWARD = 1e-3      # relative to the largest gradient entry
# the grad phase: gradients through GRAD_STEPS float32 steps of the composed
# path (ring, dense) against the all-autograd path; the forward forces of
# the three differ by float32 rounding (TOL_PAIR_FORCE), which the
# Hessian-vector products of the backward carry into the gradient
TOL_GRAD = 1e-3          # relative to the largest gradient entry


def emit(name, **fields):
    print(json.dumps({"phase": name, **fields}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def kernel_counters():
    """Every kernel wrapper of the port by its row in the kernels line (the
    campaign kernel's two instantiations share one count)."""
    return {"pair_forces": ring.pair_forces, "campaign_advance": fused_step.campaign_advance,
            "gb_forces": gb.gb_forces, "sasa_forces": sasa.sasa_forces,
            "nonbonded_rows": nonbonded.nonbonded_rows, "pair_tiles": ring.pair_tiles}


def reset_launches():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in kernel_counters().items()}


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def time_ms(fn, repeats, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def device_ms(fn, repeats=20, windows=3):
    """Device time of one call of ``fn``: every kernel it launches, summed
    over ``repeats`` calls under torch.profiler, over the count; the median
    of ``windows`` such windows. The pair kernels take less time on the card
    than their wrappers take on the host, so back-to-back launches
    (``time_ms``) time the host there. A window now and then reports part of
    its kernels or none (seen at 1,040 x 96): the median of the windows that
    report any stands, and the run fails only if none does."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    reads = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            reads.append(total / 1e3 / repeats)
    check(bool(reads), "torch.profiler reported no device time: nothing was measured")
    return float(np.median(reads))


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def profile_call(fn):
    """Run ``fn`` once under torch.profiler: wall seconds, device seconds
    summed over kernel rows (an operator row repeats its kernels' time), the
    device's busy and idle share of the wall time, the five longest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = sorted(
        (
            (e.key, e.self_device_time_total / 1e6, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
        ),
        key=lambda r: -r[1],
    )
    device_s = sum(r[1] for r in rows)
    return {
        "wall_seconds_under_profiler": wall, "device_seconds": device_s,
        "device_busy_share": device_s / wall, "device_idle_share": 1.0 - device_s / wall,
        "kernel_launches": sum(r[2] for r in rows),
        "top_kernels": [
            {"name": k[:60], "device_seconds": sec, "calls": c} for k, sec, c in rows[:5]
        ],
    }


def labelled(label, fn):
    """``fn`` inside a ``torch.profiler.record_function`` range
    ``census:<label>``."""
    from torch.profiler import record_function

    def run(*args, **kwargs):
        with record_function(f"census:{label}"):
            return fn(*args, **kwargs)
    return run


@contextlib.contextmanager
def patched(patches):
    """Set each ``(module, name, value)`` for the block, restore after."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    try:
        for mod, name, new in patches:
            setattr(mod, name, new)
        yield
    finally:
        for mod, name, old in saved:
            setattr(mod, name, old)


@contextlib.contextmanager
def environ(values):
    """Set each environment variable of ``values`` for the block, restore
    after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def census_by_source(step, sources, steps):
    """Run ``step`` (one warm-up, then ``steps`` times inside a
    ``census:step`` range) under torch.profiler and attribute each kernel
    launch to the innermost ``census:<source>`` range its runtime call lies
    in (``sources`` innermost first; outside every source: ``step``).
    Returns launches and host ms per step by source (a source's host ms
    include the sources inside it), the launches, device kernels, host,
    wall and device ms per step, and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile, record_function

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            with record_function("census:step"):
                step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    spans = {label: [(e.time_range.start, e.time_range.end) for e in events
                     if e.name == f"census:{label}"] for label in (*sources, "step")}
    launches = [e.time_range.start for e in events if "LaunchKernel" in e.name]
    # the device's own events: kernels, copies and sets (the ranges above
    # appear on the device's timeline too, as annotations)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("census:")]
    count = dict.fromkeys((*sources, "step"), 0)
    for t in launches:
        for label in (*sources, "step"):
            if any(a <= t < b for a, b in spans[label]):
                count[label] += 1
                break
    device_s = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e6
    return {
        "launches": {k: c / steps for k, c in count.items()},
        "host_ms": {label: sum(b - a for a, b in spans[label]) / 1e3 / steps for label in spans},
        "launches_per_step": len(launches) / steps,
        "device_kernels_per_step": len(kernels) / steps,
        "wall_ms_per_step": 1e3 * wall / steps,
        "device_ms_per_step": 1e3 * device_s / steps,
        "device_busy_share": device_s / wall,
    }


def launch_census(ff_m, ens, variant, bias, steps=5):
    """Kernel launches and host ms of one composed step (``fused_nonbonded``,
    ``kernel_variant=variant``, with the SMD bias), by source. Each source is
    wrapped in a ``torch.profiler.record_function`` range for this run only
    (the factories ``sim`` calls and the functions the angle-torsion op and
    the bias gradient go through, restored after); a launch is attributed to
    the innermost range its runtime call lies in (``census_by_source``), and
    whatever lies outside every range is the BAOAB update (its kicks,
    drifts, noise and the step counter). Averaged over ``steps`` steps after
    one warm-up step."""
    from molecular_dynamics_tpu_torch import sim as sim_module
    from molecular_dynamics_tpu_torch.ops import bonded

    def labelled_op(label, make):
        return lambda *args, **kwargs: labelled(label, make(*args, **kwargs))

    patches = (
        (ring, "make_pair_ring_op", labelled_op("pair_op", ring.make_pair_ring_op)),
        (nonbonded, "make_nonbonded_op", labelled_op("pair_op", nonbonded.make_nonbonded_op)),
        (bonded, "make_angle_torsion_op",
         labelled_op("angle_torsion", bonded.make_angle_torsion_op)),
        (bonded, "_angle_energy", labelled("angle_torsion_forward", bonded._angle_energy)),
        (bonded, "_torsion_energy", labelled("angle_torsion_forward", bonded._torsion_energy)),
        (sim_module, "_neg_grad", labelled("bias_gradient", sim_module._neg_grad)),
    )
    state = [ens]

    def step():
        state[0] = step_fn(state[0])

    with patched(patches):
        step_fn = make_ensemble_step_fn(ff_m, SimulationConfig(
            dt_fs=1.0, temperature=300.0, fused_nonbonded=True, kernel_variant=variant), bias)
        # innermost first: the forward lies inside the angle-torsion op
        res = census_by_source(
            step, ("angle_torsion_forward", "pair_op", "bias_gradient", "angle_torsion"), steps)
    count, host = res["launches"], res["host_ms"]
    per_step = {
        "pair_op": (count["pair_op"], host["pair_op"]),
        "angle_torsion_forward": (count["angle_torsion_forward"], host["angle_torsion_forward"]),
        "angle_torsion_autograd": (count["angle_torsion"],
                                   host["angle_torsion"] - host["angle_torsion_forward"]),
        "bias_gradient": (count["bias_gradient"], host["bias_gradient"]),
        "baoab_update": (count["step"], host["step"] - host["pair_op"] - host["angle_torsion"]
                         - host["bias_gradient"]),
    }
    return {
        "variant": variant, "atoms": ff_m.n_atoms, "replicas": int(ens.pos.shape[0]),
        "steps": steps,
        "by_source": {k: {"launches_per_step": c, "host_ms_per_step": ms}
                      for k, (c, ms) in per_step.items()},
        "launches_per_step": res["launches_per_step"],
        "device_kernels_per_step": res["device_kernels_per_step"],
        "host_ms_per_step": host["step"], "wall_ms_per_step": res["wall_ms_per_step"],
        "device_ms_per_step": res["device_ms_per_step"],
        "device_busy_share": res["device_busy_share"],
    }


def live_pair_count(pos, tables, consts):
    """Unordered pairs (r, i < j) that carry a term at these positions:
    unmasked and inside the cutoff, or with a bond/1-4 entry."""
    cutoff2 = consts[0]
    qq, aa, bb, msym, kb, d0, a14, b14, qq14 = tables.dense
    special = (kb > 0) | (a14 != 0) | (b14 != 0) | (qq14 != 0)
    total = 0
    for chunk in pos.split(128):
        d2 = torch.cdist(chunk, chunk) ** 2
        live = ((msym > 0) & (d2 <= cutoff2)) | special
        total += int(live.sum())
    return total // 2  # the tables are symmetric: both (i, j) and (j, i) counted


def loop_pair_tests(pos, tables, cutoff2):
    """Plain pairs (unmasked, not special, i < j) that the pair loop of the
    campaign and pair-forces kernels (csrc/pair_loop.cuh) must test at these
    positions: those of chunk pairs whose bounding boxes lie within the
    cutoff (``boxes_apart``, its margin included). Every other pair is
    beyond the cutoff and needs no test."""
    n_rep, n = pos.shape[:2]
    cs, nc = nonbonded.chunk_size(n), nonbonded.chunk_count(n)
    qq, aa, bb, msym, kb, d0, a14, b14, qq14 = tables.dense
    special = (kb > 0) | (a14 != 0) | (b14 != 0) | (qq14 != 0)
    plain = ((msym > 0) & ~special).float().fill_diagonal_(0.0)
    member = torch.nn.functional.one_hot(
        torch.arange(n, device=pos.device) // cs, nc).float()
    between = member.T @ plain @ member  # (nc, nc): ordered plain pairs
    unordered = torch.triu(between, 1) + torch.diag(torch.diagonal(between) / 2)
    # the kernel's boxes: a chunk's atoms, the last atom standing in for lanes past the end
    atom = torch.clamp(torch.arange(nc * cs, device=pos.device), max=n - 1)
    chunks = pos[:, atom].reshape(n_rep, nc, cs, 3)
    lo, hi = chunks.amin(2), chunks.amax(2)
    gap = torch.clamp(torch.maximum(lo[:, None] - hi[:, :, None], lo[:, :, None] - hi[:, None]),
                      min=0.0)
    near = (gap * gap).sum(-1) <= cutoff2 * 1.0001
    return int(round(float((near.float() * unordered).sum())))


def pair_flops(tests, live, with_energy):
    return tests * FLOPS_PAIR_TEST + live * (
        FLOPS_PAIR_TERM + 2 * FLOPS_PAIR_ACCUM
        + (FLOPS_PAIR_ENERGY if with_energy else 0)
    )


def dense_table_bytes(tables):
    """Bytes of the dense tables one launch of the dense-table design read
    (the pair kernels before the per-atom layout): 16 bytes for every
    ordered pair i != j (qq, lj_a, lj_b, mask) and 20 more for every ordered
    entry of a bond, Urey-Bradley or 1-4 pair. Replicas share the tables, so
    they count once a launch. Kept to compare with those designs' rows."""
    n = tables.dense.shape[-1]
    qq, aa, bb, msym, kb, d0, a14, b14, qq14 = tables.dense
    special = int(((kb > 0) | (a14 != 0) | (b14 != 0) | (qq14 != 0)).sum())
    return n * (n - 1) * 16 + special * 20


def pair_layout_bytes(tables):
    """Bytes of the per-atom pair layout one launch of K1 or K2 reads
    (csrc/pair_loop.cuh): every array of ``tables.layout`` once; replicas
    share it."""
    return sum(t.numel() * t.element_size() for t in tables.layout.values())


def bound_of(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def dense_design_bound_ms(n_rep, n, live, tables):
    """The dense-table design's bound (``bound_ms_dense``): every unordered
    pair tested, the dense tables read (``dense_table_bytes``)."""
    flops = pair_flops(n_rep * (n * (n - 1) // 2), live, True)
    return bound_of(flops, 2 * n_rep * n * 12 + n_rep * 4 + dense_table_bytes(tables))[0]


def loop_pair_bound(pos, tables, live, cutoff2):
    """The bound of the pair kernels K2, K5 and K6 (one count for the three,
    each pair once): the pair tests ``loop_pair_tests`` counts at ``pos``,
    the per-atom layout read; and beside it, as ``bound_ms_dense``, the
    count of the dense-table design (every unordered pair tested, the dense
    tables read), which keeps its rows comparable with that design's."""
    n_rep, n = pos.shape[:2]
    tests = loop_pair_tests(pos, tables, cutoff2)
    flops = pair_flops(tests, live, True)
    nbytes = 2 * n_rep * n * 12 + n_rep * 4 + pair_layout_bytes(tables)
    bound, by = bound_of(flops, nbytes)
    return {"bound_ms": bound, "bound_by": by, "flops": flops, "bytes": nbytes,
            "pair_tests": tests, "layout_bytes": pair_layout_bytes(tables),
            "bound_ms_dense": dense_design_bound_ms(n_rep, n, live, tables)}


def campaign_bound(pos, tab, live, n_inner, shake_iters, rattle_iters, cutoff2):
    """The campaign kernel's bound per launch: each step's pair tests
    (``loop_pair_tests`` at ``pos``, the launch's first positions), live
    pairs, bonded terms, constraint sweeps and per-atom work; the state in
    and out once and every table once (the per-atom pair layout). Beside it,
    as ``bound_ms_dense``, the dense-table design's count (every unordered
    pair tested each step, table A read for every ordered pair)."""
    n_rep, n = pos.shape[:2]
    rest = n_rep * (
        tab.n_angles * FLOPS_ANGLE
        + tab.n_tors * (FLOPS_TORSION_BASE + FLOPS_TORSION_TERM * tab.max_t)
        + tab.n_cons * FLOPS_CONSTRAINT_SWEEP * (2 * shake_iters + 3 * rattle_iters)
        + n * FLOPS_ATOM_STEP
    )
    tests = loop_pair_tests(pos, tab.pair, cutoff2)
    flops = n_inner * (pair_flops(tests, live, False) + rest)
    state_bytes = 2 * 9 * n_rep * n * 4 + sum(t.numel() * 4 for t in tab.tensors.values())
    nbytes = state_bytes + pair_layout_bytes(tab.pair)
    bound, by = bound_of(flops, nbytes)
    dense_flops = n_inner * (pair_flops(n_rep * (n * (n - 1) // 2), live, False) + rest)
    dense_bytes = state_bytes + dense_table_bytes(tab.pair)
    return {"bound_ms": bound, "bound_by": by, "flops": flops, "bytes": nbytes,
            "pair_tests_per_step": tests, "layout_bytes": pair_layout_bytes(tab.pair),
            "bound_ms_dense": bound_of(dense_flops, dense_bytes)[0]}


def sfu_ms(ops):
    """The least time the card's SFUs take for ``ops`` transcendentals."""
    return 1e3 * ops / PEAK_SFU_OPS


def pair_sfu_ops(live):
    return live * SFU_PAIR_LIVE


def campaign_sfu_ops(n_rep, tab, live, n_inner, shake_iters, rattle_iters):
    return n_inner * (pair_sfu_ops(live) + n_rep * (
        tab.n_angles * SFU_ANGLE
        + tab.n_tors * (SFU_TORSION_BASE + SFU_TORSION_TERM * tab.max_t)
        + tab.n_cons * SFU_CONSTRAINT_SWEEP * (2 * shake_iters + 3 * rattle_iters)
        + tab.n_atoms * SFU_ATOM_STEP))


def gb_sfu_ops(n_rep, n):
    return n_rep * (n * (n - 1) // 2 * SFU_GB_PAIR + n * SFU_GB_ATOM)


def sasa_sfu_ops(n_rep, nc):
    return n_rep * nc * (nc - 1) // 2 * SFU_SASA_PAIR


def build_facts(info, n_ctas=N_REPLICAS):
    """A kernel's build facts (``_build.kernel_info``) and the waves
    ``n_ctas`` CTAs make on the card's SMs at that occupancy."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = sms * info["ctas_per_sm"]
    return {**info, "sm_count": sms,
            f"waves_for_{n_ctas}_ctas": n_ctas / slots if slots else None}


def ptxas_summary(logs):
    """The lines of ``nvcc -Xptxas -v`` that name a kernel and its resources."""
    keep = ("Compiling entry function", "Function properties", "Used", "spill")
    return {name: [ln.strip() for ln in log.splitlines() if any(k in ln for k in keep)]
            for name, log in logs.items()}


def max_heavy_atoms(atoms_per_heavy, lists_global=True):
    """The largest LCPO set the SASA kernel holds in the shared memory a CTA
    may opt in to, with ``atoms_per_heavy`` atoms a heavy atom (their
    coordinates and forces sit in shared memory too), with its lists in
    global memory (the kernel's bound) or beside them in shared memory."""
    nc = 1
    while (sasa.sasa_shared_bytes(nc + 1, lists_global)
           + 24 * math.ceil(atoms_per_heavy * (nc + 1)) <= _build.SHARED_OPT_IN_BYTES):
        nc += 1
    return nc


def gb_bound_ms(n_rep, n, with_energy=True):
    pairs = n * (n - 1) // 2
    flops = n_rep * (
        pairs * (
            FLOPS_GB_GEOMETRY + 2 * FLOPS_GB_HCT + 2 * FLOPS_GB_HCT_DERIV
            + FLOPS_GB_STILL + 2 * FLOPS_GB_ACCUM
            + (FLOPS_GB_ENERGY if with_energy else 0)
        )
        + n * FLOPS_GB_ATOM
    )
    nbytes = n_rep * n * (12 + 12 + 4) + n_rep * 4 + n * 5 * 4
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


def sasa_work(pos, tables):
    """What the LCPO sums need at these positions, over all replicas:
    overlapping ordered pairs, sum over p of |N(p)|^2 (the B sums), and the
    triples (p, q, i) with i a neighbour of both (the W sums)."""
    pairs = tri_b = tri_g = 0
    for chunk in pos.split(256):
        o = sasa.sasa_overlaps(chunk, tables).float()
        nbr = o.sum(-1)
        pairs += int(nbr.sum())
        tri_b += int((nbr * nbr).sum())
        tri_g += int(((o @ o) * o).sum())
    return pairs, tri_b, tri_g


def sasa_flops(n_rep, nc, work):
    pairs, tri_b, tri_g = work
    return (
        n_rep * (nc * (nc - 1) // 2) * FLOPS_SASA_GEOMETRY
        + pairs * (FLOPS_SASA_AREA + FLOPS_SASA_PAIR)
        + tri_b * FLOPS_SASA_B + tri_g * FLOPS_SASA_G + n_rep * nc * FLOPS_SASA_ATOM
    )


def sasa_bound_ms(n_rep, n, nc, work):
    flops = sasa_flops(n_rep, nc, work)
    nbytes = n_rep * n * 24 + n_rep * 4 + nc * 24
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops, nbytes


# -- lever ablation -------------------------------------------------------------
# What each design choice of the GB and LCPO redesign buys, measured in this
# call: a copy of csrc/ with one choice changed (a textual substitution of
# the committed source: old text -> new, or (first line, line after) of a
# span -> new), built with the same flags beside the libraries the port
# loads, and timed on the same inputs as the kernel itself. A substitution
# that no longer applies to the sources is reported, not run.
_STILL_RING = """template <int kThreads, bool kEnergy>
__device__ __forceinline__ float gb_still_pass(
    int n, const float* sx, const float* sy, const float* sz,
    const float* __restrict__ atom, const GbConsts& c, const GbShared& w,
    float* tx, float* ty, float* tz) {
  constexpr int kGbStillBatch = 4, kGbStillLanes = 2;
  float* der_sum = w.cache + static_cast<size_t>(n) * gb_cache_stride(n);
  float* coeff_buf = der_sum + n;
  float* dshare = coeff_buf + kGbStillBatch * n;
  for (int i = threadIdx.x; i < n; i += kThreads) der_sum[i] = 0.f;
  __syncthreads();
  const int half = n / 2;
  float e_thread = 0.f;
  for (int s0 = 1; s0 <= half; s0 += kGbStillBatch) {
    const int s1 = min(s0 + kGbStillBatch, half + 1);
    // i's half of the pairs (i, i + s); lane g of i's group takes every
    // kGbStillLanes-th shift of the batch from s0 + g
    for (int base = 0; base < n * kGbStillLanes; base += kThreads) {
      const int k = base + static_cast<int>(threadIdx.x);
      const int i = k / kGbStillLanes, g = k % kGbStillLanes;
      float fx = 0.f, fy = 0.f, fz = 0.f, der = 0.f;
      if (i < n) {
        const float xi = sx[i], yi = sy[i], zi = sz[i];
        const float bi = w.born[i], bi_inv = w.binv[i];
        const float qi = __ldg(&atom[kGbColumns * i + kGbQ]);
        for (int s = s0 + g; s < s1; s += kGbStillLanes) {
          if (2 * s == n && i >= half) continue;  // taken from its lower end
          int j = i + s;
          if (j >= n) j -= n;
          const float dx = xi - sx[j], dy = yi - sy[j], dz = zi - sz[j];
          const float d2 = dx * dx + dy * dy + dz * dz;
          const float bj = w.born[j], bj_inv = w.binv[j];
          const float qs = 0.25f * d2;
          const float ex = expf(-qs * (bi_inv * bj_inv));
          const float f2 = d2 + bi * bj * ex;
          const float finv = 1.0f / sqrtf(f2);
          float u, du;
          still_u(f2 * finv, finv, c, u, du);
          const float gqq = qi * __ldg(&atom[kGbColumns * j + kGbQ]);
          const float nqu = -gqq * du;
          const float coeff = nqu * (1.0f - 0.25f * ex) * finv;
          const float hx = 0.5f * ex * finv;
          fx -= coeff * dx;
          fy -= coeff * dy;
          fz -= coeff * dz;
          der += nqu * (bj + qs * bi_inv) * hx;
          coeff_buf[(s - s0) * n + i] = coeff;
          dshare[(s - s0) * n + i] = nqu * (bi + qs * bj_inv) * hx;
          if (kEnergy) e_thread -= gqq * u;
        }
      }
      fx = group_sum<kGbStillLanes>(fx);
      fy = group_sum<kGbStillLanes>(fy);
      fz = group_sum<kGbStillLanes>(fz);
      der = group_sum<kGbStillLanes>(der);
      if (i < n && g == 0) {
        tx[i] += fx;
        ty[i] += fy;
        tz[i] += fz;
        der_sum[i] += der;
      }
    }
    __syncthreads();
    // j's half of the same pairs, from the buffer (the same lanes own j)
    for (int base = 0; base < n * kGbStillLanes; base += kThreads) {
      const int k = base + static_cast<int>(threadIdx.x);
      const int j = k / kGbStillLanes, g = k % kGbStillLanes;
      float fx = 0.f, fy = 0.f, fz = 0.f, der = 0.f;
      if (j < n) {
        const float xj = sx[j], yj = sy[j], zj = sz[j];
        for (int s = s0 + g; s < s1; s += kGbStillLanes) {
          int i = j - s;
          if (i < 0) i += n;
          if (2 * s == n && i >= half) continue;
          const float coeff = coeff_buf[(s - s0) * n + i];
          fx -= coeff * (xj - sx[i]);
          fy -= coeff * (yj - sy[i]);
          fz -= coeff * (zj - sz[i]);
          der += dshare[(s - s0) * n + i];
        }
      }
      fx = group_sum<kGbStillLanes>(fx);
      fy = group_sum<kGbStillLanes>(fy);
      fz = group_sum<kGbStillLanes>(fz);
      der = group_sum<kGbStillLanes>(der);
      if (j < n && g == 0) {
        tx[j] += fx;
        ty[j] += fy;
        tz[j] += fz;
        der_sum[j] += der;
      }
    }
    __syncthreads();
  }
  // the Born self terms and the chain cotangents
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float qi = __ldg(&atom[kGbColumns * i + kGbQ]);
    float u, du;
    still_u(w.born[i], w.binv[i], c, u, du);
    const float der = der_sum[i] - 0.5f * qi * qi * du;
    w.ce[i] = der * w.ce[i] * (0.5f * __ldg(&atom[kGbColumns * i + kGbRho]));
    if (kEnergy) e_thread -= 0.5f * qi * qi * u;
  }
  __syncthreads();
  return e_thread;
}
"""
_D_AND_WALK = """    float gsum = 0.f;
    for (int wd = 0; wd < words; ++wd) {
      const unsigned mp = w.bits[p * words + wd];
      unsigned m = mp & w.bits[q * words + wd];  // o is symmetric: i in N(p)
      const float* atp = w.at + p * cap + w.wbase[p * words + wd];
      while (m) {
        const int bit = __ffs(m) - 1;
        m &= m - 1;
        const int i = 32 * wd + bit;
        gsum += w.g3[i] + w.g4[i] * atp[__popc(mp & below(bit))];  // a_ip
      }
    }"""
_D_BIT_PER_I = """    float gsum = 0.f;
    const float* atp = w.at + p * cap;
    const unsigned short* ip = w.nbr + p * cap;
    const unsigned* bq = w.bits + q * words;
    for (int s = 0; s < w.cnt[p]; ++s) {
      const int i = ip[s];
      if ((bq[i >> 5] >> (i & 31)) & 1u) gsum += w.g3[i] + w.g4[i] * atp[s];
    }"""
#: (what is taken out, its substitutions, the runs it is measured in)
LEVERS = (
    ("Still term once per unordered pair, on a ring (partner halves through shared memory)", [
        (("template <int kThreads, bool kEnergy>\n__device__ __forceinline__ float gb_still_pass(",
          "// Chain pass:"), _STILL_RING + "\n"),
        ("         (cached ? static_cast<size_t>(n) * gb_cache_stride(n) : 0);",
         "         (cached ? static_cast<size_t>(n) * gb_cache_stride(n) : 0) + 9 * static_cast<size_t>(n);")],
     ("gb_forces", "campaign_advance[gbis]")),
    ("a thread per atom in every GB pass (no lane groups)", [
        ("constexpr int kGbLanes = 16;", "constexpr int kGbLanes = 1;")],
     ("gb_forces", "campaign_advance[gbis]")),
    ("IEEE reciprocals in hct_pair", [
        ("  const float ui = __fdividef(1.0f, up);\n  const float li = __fdividef(1.0f, lo);",
         "  const float ui = 1.0f / up;\n  const float li = 1.0f / lo;")],
     ("gb_forces", "campaign_advance[gbis]")),
    ("LCPO pass D tests one bit per i of N(p) instead of walking the AND", [
        (_D_AND_WALK, _D_BIT_PER_I)],
     ("sasa_forces", "campaign_advance[gbis]")),
    ("128 threads a CTA", [
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
     ("gb_forces", "sasa_forces")),
    ("solvent kernel at 128 threads (128 registers)", [
        ("constexpr int kSolventThreads = 256;", "constexpr int kSolventThreads = 128;")],
     ("campaign_advance[gbis]",)),
    ("solvent kernel without its register cap", [
        ("__launch_bounds__(kSolventThreads, kSolventCtasPerSm)",
         "__launch_bounds__(kSolventThreads)")],
     ("campaign_advance[gbis]",)),
    # the pair loop (csrc/pair_loop.cuh) and the CTA shape of K1
    ("each pair from both ends (rows only, every chunk pair in both orders)", [
        ("  const int s_lo = diag ? 1 : 0, s_hi = diag ? half : cs - 1;",
         "  const int s_lo = diag ? 1 : 0, s_hi = cs - 1;"),
        ("!(diag && 2 * s == cs && lane >= half)", "true"),
        ("  if (diag) {\n    rx += cx;", "  if (false) {\n    rx += cx;"),
        ("  } else if (lane < cs && J * cs + lane < n) {", "  } else if (false) {"),
        ("  for (int k = 1; k <= nc / 2; ++k) {", "  for (int k = 1; k < nc; ++k) {"),
        ("      if (I >= nc || (2 * k == nc && I >= k)) continue;", "      if (I >= nc) continue;")],
     ("campaign_advance[vacuum]", "campaign_advance[1040x96]")),
    ("plain pairs through the whole pair_term (the bond and 1-4 lines add zeros)", [
        ("pair_term<kEnergy, false>(d2, qi", "pair_term<kEnergy, true>(d2, qi")],
     ("campaign_advance[vacuum]", "campaign_advance[1040x96]", "pair_forces")),
    ("no box test (every chunk pair met)", [
        ("      if (boxes_apart(box, I, J, c.cutoff2)) continue;\n", "")],
     ("campaign_advance[vacuum]", "campaign_advance[1040x96]", "pair_forces")),
    ("256 threads above 512 atoms (five chunks a warp)", [
        ("constexpr int kLargeThreads = 1024;", "constexpr int kLargeThreads = 256;"),
        ("  return threads == kLargeThreads ? 2 : 1;", "  return threads == kLargeThreads ? 5 : 1;")],
     ("campaign_advance[1040x96]",)),
    ("1024 threads also at 129-512 atoms", [
        ("constexpr int kMediumAtoms = 512;", "constexpr int kMediumAtoms = 128;")],
     ("campaign_advance[416x192]",)),
    ("512 threads above 512 atoms (four chunks a warp)", [
        ("constexpr int kLargeThreads = 1024;", "constexpr int kLargeThreads = 512;"),
        ("  return threads == kLargeThreads ? 2 : 1;", "  return threads == kLargeThreads ? 4 : 1;")],
     ("campaign_advance[1040x96]",)),
    ("vacuum kernel without its register cap (8 CTAs an SM)", [
        ("__launch_bounds__(kSmallThreads, kVacuumCtasPerSm)", "__launch_bounds__(kSmallThreads)")],
     ("campaign_advance[vacuum]",)),
    # the pair-op kernels (csrc/pair_tiles.cu, csrc/nonbonded_rows.cu)
    ("pair-tile kernel without the box test (every chunk pair met)", [
        ("  return !boxes_apart(p, q, cutoff2);", "  return true;")],
     ("pair_tiles[1040x96]",)),
    ("pair-tile kernel, one CTA a replica (it walks every group in turn)", [
        ("pair_tiles_kernel<<<dim3(n_replicas, n_groups), kThreads, 0, s>>>(",
         "pair_tiles_kernel<<<dim3(n_replicas, 1), kThreads, 0, s>>>(")],
     ("pair_tiles[416x192]", "pair_tiles[1040x96]")),
    ("pair-tile kernel with tiles of 2 chunks", [
        ("constexpr int kTileChunks = 4;", "constexpr int kTileChunks = 2;")],
     ("pair_tiles[416x192]", "pair_tiles[1040x96]")),
    ("pair-tile kernel with tiles of 8 chunks", [
        ("constexpr int kTileChunks = 4;", "constexpr int kTileChunks = 8;")],
     ("pair_tiles[416x192]", "pair_tiles[1040x96]")),
    ("pair-tile kernel without its register cap (80 registers, 6 CTAs an SM)", [
        ("__launch_bounds__(kThreads, kCtasPerSm)", "__launch_bounds__(kThreads)")],
     ("pair_tiles[1040x96]",)),
    ("dense-row kernel without the box test (every column chunk met)", [
        ("      if (boxes_apart(box, I, J, pc.cutoff2)) continue;\n", "")],
     ("nonbonded_rows[1040x96]",)),
    ("dense-row kernel, one CTA a replica (it walks every row chunk in turn)", [
        ("  const dim3 grid(n_replicas, (chunk_count(n_atoms) + kWarps - 1) / kWarps);",
         "  const dim3 grid(n_replicas, 1);")],
     ("nonbonded_rows[416x192]", "nonbonded_rows[1040x96]")),
    # the vacuum split: each variant compiles one part of a step out
    ("split: no plain pairs", [
        ("  pair_rounds<kThreads, kRows, false>(n, s.x, s.y, s.z, s.fx, s.fy, s.fz,\n"
         "                                      s.box, t.pair, k.pair, rx, ry, rz);",
         "  for (int q = 0; q < kRows; ++q) rx[q] = ry[q] = rz[q] = 0.f;\n  __syncthreads();")],
     ("campaign_advance[vacuum]",)),
    ("split: no special pairs", [
        ("    special_sum<false>(a, s.x, s.y, s.z, t.pair, k.pair, fx, fy, fz, unused);\n", "")],
     ("campaign_advance[vacuum]",)),
    ("split: no angles and torsions", [
        ("  angle_forces<kThreads>(s, t, d);\n  torsion_forces<kThreads>(s, t, d);\n  for (int a",
         "  for (int a"),
        ("    gather3(s.abuf, t.ang_start, t.ang_src, t.ang_w, a, ax, ay, az);\n"
         "    gather3(s.tbuf, t.tor_start, t.tor_src, t.tor_w, a, bx, by, bz);",
         "    ax = ay = az = bx = by = bz = 0.f;")],
     ("campaign_advance[vacuum]",)),
)
LEVER_DIR = pathlib.Path(__file__).resolve().parent / "build" / "mdx_torch_levers"


def lever_library(run):
    """The library a lever's run key times: "campaign_advance[gbis]" ->
    "campaign_advance"."""
    return run.split("[")[0]


def lever_defines(lib, runs):
    """The compiler's defines of a lever build of ``lib`` timed in ``runs``:
    a campaign_advance build compiles only the bodies those runs can reach
    (MDX_CAMPAIGN_BODIES: the two solvent ones for "[gbis]", else the three
    vacuum ones, whichever a lever's sizes pick), about half the build."""
    if lib != "campaign_advance":
        return []
    bits = 0
    for run in runs:
        if lever_library(run) == lib:
            bits |= 0x18 if run.endswith("[gbis]") else 0x07
    return [f"-DMDX_CAMPAIGN_BODIES={bits}"]


def lowest_priority():
    """Run this process at the lowest CPU priority (in a child, before its
    program starts)."""
    os.nice(19)


def start_lever_builds():
    """Copy csrc/ once per variant and library, change it, start one nvcc
    each at the lowest CPU priority: they start with the kernels' own build
    and take the cores it and the first checks leave idle."""
    started, skipped = {}, {}
    jobs = [(lib, label, subs, runs) for label, subs, runs in LEVERS
            for lib in dict.fromkeys(lever_library(r) for r in runs)]
    for i, (lib, label, subs, runs) in enumerate(jobs):
        d = LEVER_DIR / f"{lib}_{i}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(_build.CSRC, d)
        missing = []
        for old, new in subs:
            first, after = old if isinstance(old, tuple) else (old, None)
            # the library's own source first, then the headers
            hits = [f for f in [d / f"{lib}.cu", *sorted(d.glob("*.cuh"))] if first in f.read_text()]
            text = hits[0].read_text() if hits else ""
            if text.count(first) != 1 or (after and after not in text[text.find(first):]):
                missing.append(first.strip().splitlines()[0][:60])
                continue
            start = text.index(first)
            end = text.index(after, start) if after else start + len(first)
            hits[0].write_text(text[:start] + new + text[end:])
        if missing:
            skipped[f"{lib}: {label}"] = f"substitution no longer applies: {missing}"
            continue
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *lever_defines(lib, runs), "-I", str(d),
               "-o", str(d / "lib.so"), str(d / f"{lib}.cu")]
        started[(lib, label)] = (d, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            preexec_fn=lowest_priority))
    return started, skipped


def finish_lever_builds(started, skipped):
    libs = {}
    for (lib, label), (d, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            skipped[f"{lib}: {label}"] = f"nvcc failed: {log[-400:]}"
            continue
        libs[(lib, label)] = ctypes.CDLL(str(d / "lib.so"))
    return libs


#: libraries whose launches take less time on the card than on the host:
#: their levers are timed on the card (``device_ms``)
DEVICE_TIMED = ("pair_forces", "nonbonded_rows", "pair_tiles")


def levers_phase(libs, runs):
    """Each variant against the kernel as built, in turns (built, variant,
    variant, built), in every run of ``runs`` its lever names: ``runs`` maps a
    run key of ``LEVERS`` to (call, error of a result against its plain
    version, or None, build facts or None). Rows are keyed "run: label"."""
    rows = {}
    targets = {label: run_keys for label, _, run_keys in LEVERS}
    for (lib, label), variant in libs.items():
        for run in targets[label]:
            if run not in runs or lever_library(run) != lib:
                continue
            built = _build._libraries[lib]
            call, error, facts = runs[run]
            times = {"built": [], "variant": []}
            for which in ("built", "variant", "variant", "built"):
                _build._libraries[lib] = built if which == "built" else variant
                times[which].append(
                    device_ms(call) if lib in DEVICE_TIMED
                    else time_ms(call, repeats=3 if lib == "campaign_advance" else 20))
            _build._libraries[lib] = variant
            err = error(call()) if error else None
            facts_v = facts() if facts else None
            _build._libraries[lib] = built
            rows[f"{run}: {label}"] = {
                "ms_built": sum(times["built"]) / 2, "ms_variant": sum(times["variant"]) / 2,
                "ms_each": times, "error_vs_plain_variant": err,
                **({"build_facts_variant": facts_v} if facts_v else {})}
    return rows


def hold_levers(rows, tolerances):
    """Every design variant (not the split's, which take a part out) within
    its run's tolerance of the plain version."""
    for key, row in rows.items():
        run, label = key.split(": ", 1)
        if label.startswith("split: ") or row.get("error_vs_plain_variant") is None:
            continue
        check(row["error_vs_plain_variant"] <= tolerances[run],
              f"lever {key}: {row['error_vs_plain_variant']} against {tolerances[run]}")


PAIR_CASES = {
    "9A_rf": (9.0, 7.5, True, mdx.units.SOLVENT_DIELECTRIC),
    "16A_norf": (16.0, 15.0, False, GBIS_CONFIG.solvent_dielectric),
}
PAIR_OP_KERNELS = {"nonbonded_rows": nonbonded.nonbonded_rows, "pair_tiles": ring.pair_tiles}


def jittered(coords, n_rep, rng, sigma=0.02):
    """``n_rep`` copies of ``coords`` jittered by ``sigma`` A, on the card."""
    return torch.as_tensor(
        np.asarray(coords)[None] + rng.normal(0.0, sigma, (n_rep,) + np.shape(coords)),
        dtype=torch.float32, device="cuda",
    ).contiguous()


def cutoff_clear(pos, tables, cutoff, margin=5e-6):
    """Replicas with no unmasked pair within ``margin`` A of the cutoff. The
    energy (plain Coulomb) or the force (reaction field) of a pair jumps
    there, so a pair that float32 and float64, or two orders of the same
    float32 sums, put on either side of it measures the jump (up to
    qq / cutoff, 0.6 kcal/mol at 16 A), not the arithmetic; float32 places
    a distance near 16 A to about 2e-6 A."""
    unmasked = tables.dense[3] > 0
    keep = [
        ~(((torch.cdist(chunk, chunk, compute_mode="donot_use_mm_for_euclid_dist") - cutoff).abs()
            < margin) & unmasked).flatten(1).any(1)
        for chunk in pos.split(128)
    ]
    return torch.cat(keep)


def pair_op_checks(rng, checks):
    """K5, K6 and K2 (``ring.pair_forces``, in each of its CTA shapes, up to
    the 2,048 atoms it holds) against their plain version (float32) at
    PAIR_OP_SHAPES, at 9 A with the reaction field and at 16 A without it
    (the halfway pairs of a diagonal tile live there); the plain version in
    float32 against float64; two launches give the same bits; K5 and K6 at
    K5_OPT_IN_SHAPE, where K5 takes more than 48 KB of shared memory; the
    ops' backward against autograd of their float32 reference at 8
    replicas x 416 atoms, for the energy's and the forces' cotangent.
    Returns the largest force error of each kernel."""
    worst = {name: 0.0 for name in (*PAIR_OP_KERNELS, "pair_forces")}
    for m, n_rep in PAIR_OP_SHAPES:
        ff_m, coords_m, _ = tiled_decaalanine(m)
        pos = jittered(coords_m, n_rep, rng)
        tabs = nonbonded.build_pair_tables(ff_m)
        for cname, c in PAIR_CASES.items():
            consts = nonbonded.pair_constants(*c)
            keep = cutoff_clear(pos, tabs, c[0])
            e_p, f_p = nonbonded.dense_pair_math(pos, tabs.dense, consts)
            e_d, f_d = nonbonded.dense_pair_math(pos.double(), tabs.dense, consts)
            res = {"replicas_compared": int(keep.sum()),
                   "force_err_plain_f32_vs_f64": max_err(f_p[keep], f_d[keep]),
                   "energy_err_plain_f32_vs_f64": max_err(e_p[keep], e_d[keep])}
            tag = f"pair_ops[{ff_m.n_atoms}x{n_rep},{cname}]"
            check(res["replicas_compared"] >= 0.75 * n_rep, f"{tag}: {res}")
            check(res["force_err_plain_f32_vs_f64"] <= TOL_PAIR_FORCE
                  and res["energy_err_plain_f32_vs_f64"] <= m * TOL_PAIR_ENERGY,
                  f"{tag} plain f32 vs f64: {res}")
            kernels_here = dict(PAIR_OP_KERNELS)
            if ff_m.n_atoms <= nonbonded.PAIR_LOOP_MAX_ATOMS:
                kernels_here["pair_forces"] = lambda p, t_, _, c=c: ring.pair_forces(p, t_, *c)
            for name, fn in kernels_here.items():
                e_k, f_k = fn(pos, tabs, consts)
                e_k2, f_k2 = fn(pos, tabs, consts)
                torch.cuda.synchronize()
                r = {"force_err_kernel_vs_plain": max_err(f_k[keep], f_p[keep]),
                     "energy_err_kernel_vs_plain": max_err(e_k[keep], e_p[keep]),
                     "force_err_kernel_vs_f64": max_err(f_k[keep], f_d[keep]),
                     "energy_err_kernel_vs_f64": max_err(e_k[keep], e_d[keep]),
                     "reproducible": bool(torch.equal(f_k, f_k2) and torch.equal(e_k, e_k2))}
                res[name] = r
                check(bool(torch.isfinite(f_k).all() and torch.isfinite(e_k).all()),
                      f"{tag} {name}: non-finite output")
                check(r["force_err_kernel_vs_plain"] <= TOL_PAIR_FORCE
                      and r["energy_err_kernel_vs_plain"] <= m * TOL_PAIR_ENERGY,
                      f"{tag} {name} vs plain: {r}")
                check(r["reproducible"], f"{tag} {name}: two launches differ")
                worst[name] = max(worst[name], r["force_err_kernel_vs_plain"])
            checks[tag] = res
            del e_p, f_p, e_d, f_d

    # K5 above 48 KB of shared memory (it opts in), K6 beside it; at 9 A with
    # the reaction field, a replica with a pair on the cutoff left out
    m, n_rep = K5_OPT_IN_SHAPE
    ff_m, coords_m, _ = tiled_decaalanine(m)
    pos = jittered(coords_m, n_rep, rng)
    tabs = nonbonded.build_pair_tables(ff_m)
    consts = nonbonded.pair_constants(*PAIR_CASES["9A_rf"])
    keep = cutoff_clear(pos, tabs, PAIR_CASES["9A_rf"][0])
    e_p, f_p = nonbonded.dense_pair_math(pos, tabs.dense, consts)
    tag = f"pair_ops[{ff_m.n_atoms}x{n_rep},9A_rf]"
    res = {"replicas_compared": int(keep.sum()),
           "k5_shared_bytes": nonbonded.nonbonded_rows_shared_bytes(ff_m.n_atoms)}
    check(res["replicas_compared"] >= 1 and res["k5_shared_bytes"] > 48 * 1024, f"{tag}: {res}")
    for name, fn in PAIR_OP_KERNELS.items():
        e_k, f_k = fn(pos, tabs, consts)
        e_k2, f_k2 = fn(pos, tabs, consts)
        torch.cuda.synchronize()
        r = {"force_err_kernel_vs_plain": max_err(f_k[keep], f_p[keep]),
             "energy_err_kernel_vs_plain": max_err(e_k[keep], e_p[keep]),
             "reproducible": bool(torch.equal(f_k, f_k2) and torch.equal(e_k, e_k2))}
        res[name] = r
        check(bool(torch.isfinite(f_k).all() and torch.isfinite(e_k).all()),
              f"{tag} {name}: non-finite output")
        check(r["force_err_kernel_vs_plain"] <= TOL_PAIR_FORCE
              and r["energy_err_kernel_vs_plain"] <= m * TOL_PAIR_ENERGY and r["reproducible"],
              f"{tag} {name} vs plain: {r}")
        worst[name] = max(worst[name], r["force_err_kernel_vs_plain"])
    checks[tag] = res
    del e_p, f_p, pos, tabs

    ff4, coords4, _ = tiled_decaalanine(4)
    pos = jittered(coords4, 8, rng)
    w_e = torch.as_tensor(rng.normal(size=8), dtype=torch.float32, device="cuda")
    w_f = torch.as_tensor(rng.normal(size=tuple(pos.shape)), dtype=torch.float32, device="cuda")
    for name, make in (("nonbonded_rows", nonbonded.make_nonbonded_op),
                       ("pair_tiles", ring.make_pair_ring_op)):
        op = make(ff4)
        for cot in ("energy", "forces"):
            loss = (lambda e, f: (e * w_e).sum()) if cot == "energy" else (lambda e, f: (f * w_f).sum())
            p = pos.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(loss(*op(p)), p)
            q = pos.clone().requires_grad_(True)
            (g_ref,) = torch.autograd.grad(loss(op.reference_energy(q), op.reference_forces(q)), q)
            scale = float(g_ref.abs().max())
            rel = max_err(g, g_ref) / scale
            checks[f"pair_op_backward[{name},{cot},8x416]"] = {
                "max_abs_err": max_err(g, g_ref), "max_abs_grad": scale, "relative": rel}
            check(bool(torch.isfinite(g).all()) and scale > 0.0 and rel <= TOL_BACKWARD,
                  f"{name} backward, {cot} cotangent: {rel} of {scale}")
    return worst


def solvent_dispatch_check(n_steps=3, n_rep=4):
    """Fault C8 on the card: with no kernel flag, the step under GBIS_CONFIG
    takes the GB and LCPO forces from K3 and K4 only where they hold the
    state (``gb_forces_holds``, ``sasa_forces_holds``: float32 within their
    shared memory), else from autograd of the energy, as the JAX package
    does. 104 atoms in float64 (both from autograd), 416 atoms in float32 (K3
    without its dI cache, K4 with the 204 heavy atoms), 506 atoms in float32
    (the tiled di-alanine: K4 with 230 heavy atoms, its lists in a global
    workspace) and 104 atoms in float32 (both kernels), a few steps at T = 0
    from the packaged coordinates: the force each step carries equals
    autograd of the whole energy at its positions, and the launch counters
    show the route. K3 at 416 atoms x 192 replicas and K4 at 506 x 128
    against their plain versions, timed. A direct call of a wrapper on a
    state its kernel does not hold still raises."""
    res = {}
    cases = (("104_atoms_f64", 1, torch.float64, TOL_AUTOGRAD_F64),
             ("416_atoms_f32", 4, torch.float32, TOL_F32_VS_F64),
             ("506_atoms_f32", "diala", torch.float32, TOL_F32_VS_F64),
             ("104_atoms_f32", 1, torch.float32, TOL_F32_VS_F64))
    for label, m, dtype, tol in cases:
        if m == "diala":
            ff_m, coords_m, _ = diala_tier_system(dtype, minimise=False)
        else:
            ff_m, coords_m, _ = (decaalanine_full(dtype=dtype) if m == 1
                                 else tiled_decaalanine(m, dtype=dtype))
        n_m = ff_m.n_atoms
        state = replicate(system_init(torch.as_tensor(coords_m, dtype=dtype, device="cuda"),
                                      dtype=dtype), n_rep, seed=1)
        energy = lambda q, ff_m=ff_m: total_energy(q, ff_m, config=GBIS_CONFIG)
        state = state.replace(forces=_neg_grad(energy, state.pos).detach())
        step_fn = make_ensemble_step_fn(
            ff_m, SimulationConfig(energy=GBIS_CONFIG, dt_fs=1.0, temperature=0.0))
        reset_launches()
        for _ in range(n_steps):
            state = step_fn(state)
        torch.cuda.synchronize()
        launches = {"gb_forces": gb.gb_forces.launches, "sasa_forces": sasa.sasa_forces.launches}
        nc = sasa.build_sasa_tables(ff_m).n_compact
        holds = {"gb_forces": gb.gb_forces_holds("cuda", dtype, n_m),
                 "sasa_forces": sasa.sasa_forces_holds("cuda", dtype, n_m, nc)}
        res[label] = {"atoms": n_m, "heavy_atoms": nc, "dtype": str(dtype), "steps": n_steps,
                      "kernel_holds": holds, "launches": launches, "tolerance": tol,
                      "force_err_vs_autograd": max_err(state.forces, _neg_grad(energy, state.pos))}
        check(bool(torch.isfinite(state.pos).all()) and state.pos.dtype == dtype,
              f"solvent dispatch {label}: {res[label]}")
        check(all(launches[k] == (n_steps if holds[k] else 0) for k in launches),
              f"solvent dispatch {label}: launches against the predicates: {res[label]}")
        check(res[label]["force_err_vs_autograd"] <= tol, f"solvent dispatch {label}: {res[label]}")
    skipped = {"gb_forces": 0, "sasa_forces": 0}
    launched = {k: n_steps for k in skipped}
    check(res["104_atoms_f64"]["launches"] == skipped
          and all(res[f"{n}_atoms_f32"]["launches"] == launched for n in (416, 506, 104)),
          f"solvent dispatch: K3 and K4 skipped at float64, both launched at 416, 506 and "
          f"104 atoms in float32: {res}")
    res["sasa_forces_506_atoms"] = sasa_forces_506()
    # K3 at 416 atoms without its dI cache, 192 replicas, against its plain version
    ff4, coords4, _ = tiled_decaalanine(4)
    consts = gb.gb_constants(GBIS_CONFIG.solvent_dielectric, GBIS_CONFIG.ion_concentration)
    n4 = ff4.n_atoms
    pos4 = jittered(coords4, GBIS_TIERS[-1][1], np.random.default_rng(SEED + 4))
    tab4 = gb.build_gb_tables(ff4)
    f_k, e_k, _ = gb.gb_forces(pos4, tab4, consts)
    f_p, e_p, _ = gb.gb_forces_reference(pos4, tab4, consts)
    torch.cuda.synchronize()
    tol_e = 4 * TOL_GB_ENERGY  # four copies' energy, summed in another order
    k3 = {"shape": list(pos4.shape), "gb_cached": gb.gb_cached(n4),
          "force_err_kernel_vs_plain": max_err(f_k, f_p),
          "energy_err_kernel_vs_plain": max_err(e_k, e_p),
          "tolerances": (TOL_GB_FORCE, tol_e)}
    check(not k3["gb_cached"] and k3["force_err_kernel_vs_plain"] <= TOL_GB_FORCE
          and k3["energy_err_kernel_vs_plain"] <= tol_e, f"gb_forces at 416 atoms: {k3}")
    call = lambda: gb.gb_forces(pos4, tab4, consts)
    bound, by, _, _ = gb_bound_ms(pos4.shape[0], n4)
    k3.update(ms=time_ms(call, repeats=10),
              plain_ms=time_ms(lambda: gb.gb_forces_reference(pos4, tab4, consts), repeats=2),
              bound_ms=bound, bound_by=by, sfu_bound_ms=sfu_ms(gb_sfu_ops(pos4.shape[0], n4)),
              **build_facts(gb_forces_facts(n4), n_ctas=pos4.shape[0]))
    res["gb_forces_416_atoms"] = k3
    # the wrappers themselves launch or raise: past what K3 holds without
    # its cache (6,456 atoms), and on float64
    n_past = 6457
    tab_past = gb.GBTables(atom=torch.zeros((n_past, 5), device="cuda"),
                           atom64=torch.zeros((n_past, 5), dtype=torch.float64, device="cuda"))
    pos_past = torch.zeros((1, n_past, 3), device="cuda")
    ff1, coords1, _ = decaalanine_full()
    pos64 = torch.as_tensor(coords1, dtype=torch.float64, device="cuda")[None].contiguous()
    raised = {}
    for label, call in (
        (f"gb_forces_{n_past}_atoms_f32", lambda: gb.gb_forces(pos_past, tab_past, consts)),
        ("gb_forces_104_atoms_f64", lambda: gb.gb_forces(pos64, gb.build_gb_tables(ff1), consts)),
        ("sasa_forces_104_atoms_f64", lambda: sasa.sasa_forces(pos64, sasa.build_sasa_tables(ff1))),
    ):
        try:
            call()
            raised[label] = False
        except (ValueError, TypeError):
            raised[label] = True
    res["wrappers_raise"] = raised
    check(all(raised.values()), f"solvent dispatch: a wrapper ran on a state it does not hold: {raised}")
    return res


def option_dispatch_check(n_rep=N_REPLICAS, n_steps=20, save_every=10):
    """Fault C11 on the card: a kernel flag beside an option its kernels do
    not cover warns and runs the unflagged path, as the JAX package does.
    The packaged 104-atom deca-alanine at ``n_rep`` replicas in float32, 1
    fs, from its packaged coordinates. Run A: ``GBIS_CONFIG`` with
    ``fused_campaign=True`` and ``integrator="nve"``: the composed per-step
    path, its GB and LCPO forces from K3 and K4 a step each and K1 never
    launched, its frames and final forces equal to the unflagged run's bit
    for bit, the carried force within ``TOL_F32_VS_F64`` of autograd at the
    last positions; its seconds a step (the flagged call first, then the
    unflagged one, each with its observables once). Run B: ``REFERENCE_CONFIG`` with
    ``fused_nonbonded=True`` and ``pbc=True`` in a 100 A box at T = 0: the
    unflagged step bit for bit, K5 and K6 never launched. The launch counts
    are those of the flagged runs alone."""
    ff1, coords1, _ = decaalanine_full()
    state = replicate(system_init(coords1, device="cuda"), n_rep, seed=1)
    res = {"replicas": n_rep, "atoms": ff1.n_atoms, "steps": n_steps, "save_every": save_every}
    runs = {
        "A": (dict(energy=GBIS_CONFIG, integrator="nve", dt_fs=1.0), "fused_campaign",
              "integrator='nve'", state),
        "B": (dict(energy=REFERENCE_CONFIG, pbc=True, temperature=0.0, dt_fs=1.0),
              "fused_nonbonded", "pbc=True",
              state.replace(box=torch.full((n_rep, 3), 100.0, device="cuda"))),
    }
    for run, (kw, flag, option, st) in runs.items():
        ecfg = kw["energy"]
        box = st.box if kw.get("pbc") else None
        energy = lambda q, ecfg=ecfg, box=box: total_energy(q, ff1, box=box, config=ecfg)
        st = st.replace(forces=_neg_grad(energy, st.pos).detach())
        go = lambda **flags: simulate_ensemble(
            st, ff1, n_steps=n_steps, save_every=save_every, obs_every=n_steps // save_every,
            config=SimulationConfig(**kw, **flags))
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            final, frames, _ = go(**{flag: True})
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = read_launches()
        said = [str(w.message) for w in caught if issubclass(w.category, UserWarning)]
        t0 = time.perf_counter()
        plain_final, plain_frames, _ = go()
        torch.cuda.synchronize()
        plain_seconds = time.perf_counter() - t0
        res[run] = {
            "config": {**{k: v for k, v in kw.items() if k != "energy"},
                       "terms": list(ecfg.terms), flag: True},
            "warned": any(f"{flag} requested" in m and option in m for m in said),
            "warning": said[:1],
            "frames_equal_unflagged": torch.equal(frames, plain_frames),
            "forces_equal_unflagged": torch.equal(final.forces, plain_final.forces),
            "finite": bool(torch.isfinite(frames).all()),
            "launches": launches,
            "force_err_vs_autograd": max_err(final.forces, _neg_grad(energy, final.pos)),
            "tolerance": TOL_F32_VS_F64,
            "seconds": seconds, "seconds_per_step": seconds / n_steps,
            "unflagged_seconds_per_step": plain_seconds / n_steps,
        }
        check(all(res[run][k] for k in ("warned", "frames_equal_unflagged",
                                         "forces_equal_unflagged", "finite")),
              f"option dispatch, run {run}: {res[run]}")
        check(res[run]["force_err_vs_autograd"] <= TOL_F32_VS_F64,
              f"option dispatch, run {run}: carried force vs autograd: {res[run]}")
    a, b = res["A"]["launches"], res["B"]["launches"]
    check(a["gb_forces"] == n_steps and a["sasa_forces"] == n_steps and a["campaign_advance"] == 0,
          f"option dispatch, run A: K3 and K4 {n_steps} launches each, K1 none: {a}")
    check(b["nonbonded_rows"] == 0 and b["pair_tiles"] == 0,
          f"option dispatch, run B: K5 and K6 never launched: {b}")
    return res


def sasa_forces_506(n_rep=DIALA_TIER[1]):
    """K4 on the tiled di-alanine (506 atoms, 230 heavy atoms, whose lists
    do not fit beside the rest: they lie in a global workspace) at 128
    replicas, each the packaged copies on the grid jittered by 0.02 A,
    against its plain version, timed beside its bound."""
    ff_m, pos0, _ = diala_tier_system(minimise=False)
    tab = sasa.build_sasa_tables(ff_m)
    n, nc = ff_m.n_atoms, tab.n_compact
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 5)
    pos = (pos0[None] + 0.02 * torch.randn((n_rep, n, 3), generator=gen, device="cuda")
           ).contiguous()
    gamma = GBIS_CONFIG.surface_tension
    f_k, e_k = sasa.sasa_forces(pos, tab, gamma)
    torch.cuda.synchronize()
    f_p, e_p = sasa.sasa_forces_reference(pos, tab, gamma)
    tol_e = 2 * TOL_SASA_ENERGY  # 23 copies' energy, summed in another order
    lists_global = sasa.sasa_lists_global(n, nc)
    k4 = {"shape": list(pos.shape), "heavy_atoms": nc, "lists_global": lists_global,
          "list_bytes_per_replica": sasa.sasa_list_bytes(nc),
          "shared_bytes": sasa.sasa_shared_bytes(nc, lists_global) + 24 * n,
          "max_degree": int(sasa.sasa_overlaps(pos, tab).sum(-1).max()),
          "force_err_kernel_vs_plain": max_err(f_k, f_p),
          "energy_err_kernel_vs_plain": max_err(e_k, e_p),
          "tolerances": (TOL_SASA_FORCE, tol_e)}
    check(lists_global and bool(torch.isfinite(f_k).all())
          and k4["force_err_kernel_vs_plain"] <= TOL_SASA_FORCE
          and k4["energy_err_kernel_vs_plain"] <= tol_e, f"sasa_forces at 506 atoms: {k4}")
    bound, by, _, _ = sasa_bound_ms(n_rep, n, nc, sasa_work(pos, tab))
    k4.update(ms=time_ms(lambda: sasa.sasa_forces(pos, tab, gamma), repeats=20),
              plain_ms=time_ms(lambda: sasa.sasa_forces_reference(pos, tab, gamma), repeats=3),
              bound_ms=bound, bound_by=by, sfu_bound_ms=sfu_ms(sasa_sfu_ops(n_rep, nc)),
              **build_facts(_build.kernel_info("sasa_forces", "mdx_sasa_forces_info",
                                               [ctypes.c_int] * 3, n, nc, int(lists_global)),
                            n_ctas=n_rep))
    return k4


def tiled_start(pos, m, spacing=50.0):
    """``m`` copies of the 104-atom positions ``pos`` placed as
    ``tiled_decaalanine`` places its copies (``spacing`` A apart along x)."""
    shift = torch.zeros((m, 1, 3), dtype=pos.dtype, device=pos.device)
    shift[:, 0, 0] = spacing * torch.arange(m, dtype=pos.dtype, device=pos.device)
    return (pos[None] + shift).reshape(-1, 3)


def grid_start(pos, m, spacing=50.0):
    """``m`` copies of the positions ``pos`` (about their centroid) on a
    cubic grid ``spacing`` A apart about the origin, at most 27. In a line
    along x, 23 di-alanines would reach 1,100 A, where float32 resolves 1.2e-4
    A, more than TOL_POS: the checks would measure float32's grain there,
    not the kernel."""
    ax = spacing * (torch.arange(3, dtype=pos.dtype, device=pos.device) - 1.0)
    grid = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1).reshape(-1, 3)[:m]
    return (grid[:, None] + (pos - pos.mean(0))).reshape(-1, 3).contiguous()


def diala_tier_system(dtype=torch.float32, minimise=True):
    """The tiled di-alanine of DIALA_TIER: its tables, one copy (FIRE under
    GBIS_CONFIG, DIALA_FIRE_STEPS steps, where ``minimise``, else as
    packaged) on ``grid_start``'s grid, and copy 0's first and last heavy
    atom."""
    ff1, coords1, _ = dialanine(dtype=dtype)
    one = torch.as_tensor(coords1, dtype=dtype, device="cuda")
    if minimise:
        force = mdx.force_fn(GBIS_CONFIG)
        one = minimize_fire(one, lambda p: force(p, ff1), n_steps=DIALA_FIRE_STEPS,
                            dt_start=1e-3, dt_max=1e-2)
    heavy = torch.nonzero(ff1.sasa_radii > 0).flatten().tolist()
    return (tile_ff_params(ff1, DIALA_TIER[0]), grid_start(one, DIALA_TIER[0]),
            (heavy[0], heavy[-1]))


def with_forces(ens, ff_m, ecfg, bias_m=None):
    """The ensemble with its carried forces those of ``ecfg`` (and the bias
    at each replica's step) at its positions."""
    step = int(ens.step.reshape(-1)[0])

    def energy(q):
        e = total_energy(q, ff_m, config=ecfg)
        return e if bias_m is None else e + bias_m.energy(q, step)

    return ens.replace(forces=_neg_grad(energy, ens.pos).detach().contiguous())


def gbis_op(ff_m, n_inner, temperature, ecfg=GBIS_CONFIG, bias=None, constraints=None,
            dt_fs=2.0, gamma_ps=1.0, **kw):
    """The campaign op under ``ecfg`` (GB, and LCPO where its terms have
    ``sasa``)."""
    return fused_step.make_fused_campaign_op(
        ff_m, n_inner=n_inner, dt_fs=dt_fs, temperature=temperature, gamma_ps=gamma_ps,
        cutoff=ecfg.cutoff, switch_dist=ecfg.switch_dist, rfa=ecfg.rfa,
        solvent_dielectric=ecfg.solvent_dielectric, ion_concentration=ecfg.ion_concentration,
        surface_tension=ecfg.surface_tension, bias=bias, constraints=constraints,
        gb=True, sasa="sasa" in ecfg.terms, **kw)


def gbis_launch_bound(op, pos, sasa_tab):
    """A GBIS launch's bound and SFU bound at ``pos``: the fast part's
    (``campaign_bound``) and the GB and LCPO work at their cadences,
    counted as the cached design does it (each ordered pair's HCT integral
    and derivative once: ``gb_bound_ms``), so that recomputing them is part
    of the gap, not of the bound."""
    s, tab = op.settings, op.tables
    n_rep, n = pos.shape[:2]
    live = live_pair_count(pos, tab.pair, s["pair_consts"])
    fast = campaign_bound(pos, tab, live, s["n_inner"], s["shake_iters"], s["rattle_iters"],
                          s["pair_consts"][0])
    gb_evals = s["n_inner"] // s["gb_every"]
    flops = fast["flops"] + gb_evals * gb_bound_ms(n_rep, n, with_energy=False)[2]
    sfu = campaign_sfu_ops(n_rep, tab, live, s["n_inner"], s["shake_iters"],
                           s["rattle_iters"]) + gb_evals * gb_sfu_ops(n_rep, n)
    nbytes = fast["bytes"] + n * 5 * 4
    if s["surface_tension"] is not None:
        nc = sasa_tab.n_compact
        sasa_evals = s["n_inner"] // s["sasa_every"]
        flops += sasa_evals * sasa_flops(n_rep, nc, sasa_work(pos, sasa_tab))
        sfu += sasa_evals * sasa_sfu_ops(n_rep, nc)
        nbytes += nc * 24
    bound, by = bound_of(flops, nbytes)
    return {"bound_ms": bound, "bound_by": by, "sfu_bound_ms": sfu_ms(sfu), "flops": flops,
            "bytes": nbytes, "live_unordered_pairs_at_entry": live}


def both_variants(make, patch, error, repeats=3):
    """A kernel as built and with ``patch`` (module, name, value) set, which
    makes the other instantiation run: ``make()`` returns the call and its
    build facts, under the patch where it applies. Timed in turns (built,
    other, other, built), each with its error against the plain version."""
    calls = {}
    for label, patches in (("as_built", ()), ("other", (patch,))):
        with patched(patches):
            calls[label] = make()
    rows = {label: {"ms_each": []} for label in calls}
    for label in ("as_built", "other", "other", "as_built"):
        with patched(() if label == "as_built" else (patch,)):
            rows[label]["ms_each"].append(time_ms(calls[label][0], repeats=repeats))
    for label, (call, facts) in calls.items():
        with patched(() if label == "as_built" else (patch,)):
            rows[label].update(ms=sum(rows[label]["ms_each"]) / 2,
                               error_vs_plain=error(call()), **facts())
    return rows


def gbis_tier_checks(ff_m, pos0, bias_m, cons_m, n_rep, m, runs):
    """The campaign kernel under GBIS at a tier against its plain version on
    the same normals, with the tolerances of the 104-atom checks, every
    replica from the minimum jittered by 0.01 A at rest, as the tier checks
    start: 5 steps at T = 0 (the first run) and at 300 K against the plain
    version in float32; 50 steps at 300 K against it in float64 (and, not
    held, in float32). Two float32 trajectories part faster than one does
    from float64: at 416 x 192 after 50 steps the plain float32 version
    itself sits 0.137-0.158 kcal/mol/A from float64 in force, against
    TOL_FRC = 0.15 (from 300 K velocities its positions sit 2.3e-4 A from
    float64 after 5 steps, past TOL_POS). Each run of ``runs`` is (label,
    energy, sasa_every, gb_every). Then each run's ms a launch of 50 steps
    at 300 K beside its bound and SFU bound, and the instantiation's build
    facts."""
    n = ff_m.n_atoms
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + m)
    pos_b = (pos0[None] + 0.01 * torch.randn((n_rep, n, 3), generator=gen, device="cuda")
             ).contiguous()
    vel_b = torch.zeros_like(pos_b)
    sasa_tab = sasa.build_sasa_tables(ff_m)
    checks, times, ops = {}, {}, {}
    for label, ecfg, sasa_every, gb_every in runs:
        kw = dict(ecfg=ecfg, bias=bias_m, constraints=cons_m, sasa_every=sasa_every,
                  gb_every=gb_every)
        op50 = gbis_op(ff_m, N_INNER, 300.0, **kw)
        s = op50.settings
        # the start's forces in float64, rounded once: the same float32
        # input every run (float32 sums on the card differ run to run)
        frc = fused_step.campaign_forces_reference(
            pos_b.double(), op50.tables, s["pair_consts"], s["bias_consts"], 0,
            s["gb_consts"], s["surface_tension"]).float().contiguous()
        cases = [(5, 0.0)] if label == runs[0][0] else []
        for n_inner, temperature in cases + [(5, 300.0), (N_INNER, 300.0)]:
            op = op50 if (n_inner, temperature) == (N_INNER, 300.0) else gbis_op(
                ff_m, n_inner, temperature, **kw)
            noise = (fused_step.campaign_noise(13, 40, n_inner, n_rep, n) if temperature
                     else None)
            t0, seed = (40, 13) if noise is not None else (0, 1)
            out_k = op(pos_b, vel_b, frc, t0, seed)
            torch.cuda.synchronize()
            out_p = fused_step.campaign_advance_reference(
                pos_b, vel_b, frc, t0, seed, op.tables, noise=noise, **op.settings)
            errs = [max_err(x, y) for x, y in zip(out_k, out_p)]
            name = f"{label},T={temperature:g},n_inner={n_inner}" + (",same noise" if noise is not None else "")
            tols = (TOL_POS if n_inner <= 5 else TOL_POS_50, TOL_VEL, TOL_FRC)
            checks[name] = {**dict(zip(("pos", "vel", "frc"), errs)), "tolerances": tols,
                            "held_against": "plain float32"}
            if n_inner == N_INNER:
                # both float32 trajectories against float64 from the same start
                out_d = fused_step.campaign_advance_reference(
                    pos_b.double(), vel_b.double(), frc.double(), t0, seed, op.tables,
                    noise=noise.double(), **op.settings)
                errs = [max_err(x, y) for x, y in zip(out_k, out_d)]
                checks[name].update(
                    held_against="plain float64", kernel_vs_float64=errs,
                    plain_float32_vs_float64=[max_err(x, y) for x, y in zip(out_p, out_d)])
                del out_d
            check(all(bool(torch.isfinite(x).all()) for x in out_k),
                  f"GBIS campaign_advance at {n} atoms {name}: non-finite")
            check(all(e <= tol for e, tol in zip(errs, tols)),
                  f"GBIS campaign_advance at {n} atoms {name} vs the "
                  f"{checks[name]['held_against']}: {errs} (bounds {tols})")
            del out_p
        times[label] = {
            "ms": time_ms(lambda: op50(pos_b, vel_b, frc, 0, 3), repeats=3),
            "n_inner": N_INNER, "shared_bytes": op50.shared_bytes,
            **gbis_launch_bound(op50, pos_b, sasa_tab),
            **build_facts(op50.kernel_info(), n_ctas=n_rep),
        }
        ops[label] = (functools.partial(gbis_op, ff_m, N_INNER, 300.0, **kw), frc)
    return checks, times, (pos_b, vel_b, ops)


def gbis_tier_run(ff_m, ens, bias_m, cons_m, ecfg, sasa_every, gb_every, tag):
    """``simulate_ensemble(fused_campaign=True)`` at a GBIS tier for
    N_STEPS: the campaign gates of the 104-atom path (frames finite, X-H
    within 1e-5 A, T in 150-350 K, colvar lag under 2 A, replicas apart)
    and one kernel launch a save, counted from 0 just before the call."""
    n_rep, n = ens.pos.shape[:2]
    n_saves = N_STEPS // N_INNER
    cfg = SimulationConfig(dt_fs=2.0, temperature=300.0, energy=ecfg, fused_campaign=True,
                           constrain_h_bonds=True, sasa_every=sasa_every, gb_every=gb_every)
    ens = with_forces(ens, ff_m, ecfg, bias_m)
    reset_launches()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        final, frames, log = simulate_ensemble(ens, ff_m, n_steps=N_STEPS, save_every=N_INNER,
                                               config=cfg, bias=bias_m)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = read_launches()
    composed = [str(w.message) for w in caught if "does not hold this system" in str(w.message)]
    check(not composed, f"{tag}: simulate_ensemble ran the composed path: {composed}")
    check(tuple(frames.shape) == (n_saves, n_rep, n, 3), f"{tag}: frames {tuple(frames.shape)}")
    check(bool(torch.isfinite(frames).all()), f"{tag}: non-finite frames")
    check(launches["campaign_advance"] == n_saves,
          f"{tag}: campaign kernel launched {launches['campaign_advance']} times, expected {n_saves}")
    last = frames[-1]
    pairs = cons_m.pairs
    bond = torch.linalg.norm(last[:, pairs[:, 0]] - last[:, pairs[:, 1]], dim=-1)
    violation = float((bond - cons_m.lengths[None]).abs().max())
    check(violation < 1e-5, f"{tag}: max X-H constraint violation {violation} A")
    t_last = float(log["T"][-1].mean())
    check(150.0 < t_last < 350.0, f"{tag}: ensemble-mean T of the last save {t_last} K")
    lag = float((log["colvar_value"][-1] - log["colvar_center"][-1]).abs().mean())
    check(lag < 2.0, f"{tag}: mean |colvar - centre| {lag} A")
    flat = last.reshape(n_rep, -1)
    spread = float((flat[1:] - flat[:-1]).abs().amax(dim=1).min())
    check(spread > 1e-3, f"{tag}: neighbouring replicas coincide ({spread})")
    return {
        "replicas": n_rep, "atoms": n, "steps": N_STEPS, "launches": launches,
        "max_constraint_violation_A": violation, "T_last_mean_K": t_last, "colvar_lag_A": lag,
        "min_neighbour_spread_A": spread, "epot_last_mean": float(log["epot"][-1].mean()),
        "seconds": seconds, "aggregate_steps_per_s": N_STEPS * n_rep / seconds,
    }


def write_tiled_prmtop(files, tmp, ff_m, meta_m, pos0):
    """``ff_m`` (tiled copies of the packaged tables) as a chamber prmtop
    and ``pos0`` as a PDB, by the numpy writer of the CPU tests."""
    with np.load(FULL_DA_NPZ) as raw:
        names = [k[3:] for k in raw.files if k.startswith("ff_")]
    tables = {k: getattr(ff_m, k).detach().cpu().numpy() for k in names}
    m = meta_m["tiled_copies"]
    prmtop, pdb = tmp / f"full_da_x{m}.prmtop", tmp / f"full_da_x{m}.pdb"
    files.write_prmtop(prmtop, tables, meta_m["atom_names"], meta_m["atom_types"],
                       meta_m["res_ids"], meta_m["res_names"])
    write_pdb(str(pdb), pos0.cpu().numpy(), meta_m["atom_names"], resnames=meta_m["res_names"],
              resids=meta_m["res_ids"])
    return str(prmtop), str(pdb)


def gbis_tiers_phase(pos_g, switch_inputs):
    """The GBIS campaign through the campaign kernel at the tier sizes
    (GBIS_TIERS): m copies of the GBIS-minimised 104-atom structure, the SMD
    bias on copy 0's ends (atom 0 against atom 103, from the measured
    distance), Maxwell-Boltzmann velocities at 300 K; and at DIALA_TIER the
    tiled di-alanine (``diala_tier_system``), whose LCPO lists the kernel
    keeps in a global workspace, the bias on copy 0's first and last heavy
    atom. At each tier the kernel against its plain version and its time a
    launch, then ``simulate_ensemble(fused_campaign=True)`` for N_STEPS at
    each run of GBIS_TIER_RUNS (the 506-atom tier at the first, the
    208-atom tier at none);
    at 416 atoms also ``cli simulate`` on the system written as a chamber
    prmtop, and the launch with the lists in shared memory (as built) and in
    the global workspace, the measurement ``campaign_sasa_lists_global``
    rests on. Then both solvent instantiations (and both GB kernels) at 104
    and 208 atoms, the measurement the switch points rest on
    (``switch_inputs``: the 104-atom checks' states and plain outputs)."""
    res, by_tier, launches = {}, {}, {}
    starts = {}
    tiers = [(m, n_rep, "deca") for m, n_rep in GBIS_TIERS] + [(*DIALA_TIER, "diala")]
    for m, n_rep, kind in tiers:
        if kind == "diala":
            ff_m, pos0, (g1, g2) = diala_tier_system()
            meta_m, n_cons = None, 12 * m
        else:
            ff_m, _, meta_m = tiled_decaalanine(m)
            pos0, (g1, g2), n_cons = tiled_start(pos_g, m), (0, 103), 53 * m
        n_m = ff_m.n_atoms
        d0 = float(torch.linalg.norm(pos0[g2] - pos0[g1]))
        bias_m = HarmonicSMDBias.create(n_atoms=n_m, group1=[g1], group2=[g2], fk=1.0,
                                        cent_0=d0, cent_1=d0 + 22.0, T=500_000.0)
        cons_m = hydrogen_bond_constraints(ff_m)
        check(cons_m.n_constraints == n_cons, f"{n_m} atoms: {cons_m.n_constraints} X-H constraints")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(m)
        ens = replicate(system_init(pos0, vel=maxwell_boltzmann(gen, ff_m.masses, 300.0), key=m),
                        n_rep, seed=1)
        runs = GBIS_TIER_RUNS if m == 4 else GBIS_TIER_RUNS[:1]
        shape = f"{n_m}x{n_rep}"
        checks, times, tier_inputs = gbis_tier_checks(ff_m, pos0, bias_m, cons_m, n_rep, m, runs)
        starts[m] = (ff_m, pos0, tier_inputs)
        first = times[runs[0][0]]
        row = {"campaign_advance_vs_plain": checks, "shared_bytes": first["shared_bytes"],
               "sasa_lists": first["sasa_lists"],
               "sasa_workspace_bytes_per_replica": first["sasa_workspace_bytes_per_replica"]}
        # the 208-atom tier is checked and timed only: its 2000-step run
        # was dropped to keep the script within 1,200 s
        runs = () if m == 2 else runs
        check(row["sasa_lists"] == ("global" if kind == "diala" else "shared"),
              f"GBIS tier {shape}: the LCPO lists in {row['sasa_lists']} memory")
        for label, ecfg, sasa_every, gb_every in runs:
            tag = f"GBIS tier {shape} {label}"
            row[label] = gbis_tier_run(ff_m, ens, bias_m, cons_m, ecfg, sasa_every, gb_every, tag)
            times[label]["launches"] = row[label]["launches"]["campaign_advance"]
            launches[f"gbis_tiers: simulate_ensemble(fused_campaign, {label}) {shape} x {N_STEPS}"] = (
                row[label]["launches"])
        if m == 4:
            row["cli_prmtop"], cli_launches = gbis_tier_cli(ff_m, meta_m, pos0, n_rep)
            launches[f"gbis_tiers: cli simulate prmtop GBIS_CONFIG {shape} x {N_STEPS}"] = cli_launches
            pos4, vel4, ops4 = tier_inputs
            make_416, frc4 = ops4[GBIS_TIER_RUNS[0][0]]
            row["sasa_lists_switch"] = sasa_lists_switch(make_416, (pos4, vel4, frc4))
        by_tier[shape] = times
        res[shape] = row
    make_104, pos_b, vel_b, frc_g, pos_pert, gb_tab, gb_consts = switch_inputs
    ff2, _, (pos2, vel2, ops2) = starts[2]
    make_208, frc2 = ops2[GBIS_TIER_RUNS[0][0]]
    shape_208 = f"{ff2.n_atoms}x{pos2.shape[0]}"
    res["switch"] = gbis_switch(
        {f"104x{N_REPLICAS}": (make_104, (pos_b, vel_b, frc_g)),
         shape_208: (make_208, (pos2, vel2, frc2))},
        {f"104x{N_REPLICAS}": (pos_pert, gb_tab, gb_consts),
         shape_208: (pos2, gb.build_gb_tables(ff2), gb_consts)})
    return res, by_tier, launches, starts


def sasa_lists_switch(make_op, args):
    """The campaign kernel at 416 x 192, the one tier where the LCPO lists
    fit a CTA with the rest, with the lists in shared memory (as built) and
    in the global workspace (``campaign_sasa_lists_global`` patched to say
    so), timed in turns: the measurement the rule rests on. The same math in
    the same order: each variant's positions after 50 steps against the
    as-built launch's, within TOL_POS."""
    op = make_op()
    ref = op(*args, 0, 3)[0]

    def make():
        op = make_op()
        return (lambda: op(*args, 0, 3)), op.kernel_info

    rows = both_variants(make, (fused_step, "campaign_sasa_lists_global", lambda *sizes: True),
                         lambda out: max_err(out[0], ref))
    check(rows["as_built"]["sasa_lists"] == "shared" and rows["other"]["sasa_lists"] == "global"
          and all(r["error_vs_plain"] <= TOL_POS for r in rows.values()),
          f"the LCPO lists' switch at 416 atoms: {rows}")
    return {("shared" if k == "as_built" else "global"): {
        **{key: v for key, v in r.items() if key != "error_vs_plain"},
        "pos_err_vs_as_built": r["error_vs_plain"]} for k, r in rows.items()}


def gbis_tier_cli(ff_m, meta_m, pos0, n_rep):
    """``cli simulate`` with implicit solvent on the tier system written as
    a chamber prmtop and PDB (the minimised copies; FIRE 50 steps from
    there), n_rep x N_STEPS, with the cli campaigns' gates."""
    files = load_test_files()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        prmtop, pdb = write_tiled_prmtop(files, tmp, ff_m, meta_m, pos0)
        gbis_cfg = {**dataclasses.asdict(GBIS_CONFIG), "terms": list(GBIS_CONFIG.terms)}
        cfg_path = tmp / "gbis.json"
        cfg_path.write_text(json.dumps({"sim": {"energy": gbis_cfg, "sasa_every": 1}}))
        run = [f"topology={prmtop}", f"coordinates={pdb}", "colvar.group2=[103]",
               "colvar.T=500000", "sim.dt_fs=2.0", "sim.constrain_h_bonds=true",
               "minimize_steps=50"]
        out, _ = cli_campaign_run(ff_m.n_atoms, run, config=str(cfg_path), n_rep=n_rep)
    return out, {"campaign_advance": out["campaign_kernel_launches"]}


def gbis_switch(k1_cases, k3_cases):
    """Both solvent instantiations of the campaign kernel (256 threads with
    GB's dI cache, 512 without) and both GB kernels (with and without the
    cache) at 104 and 208 atoms, each against its plain version: the times
    the switch point ``gb.GB_CACHE_MAX_ATOMS`` rests on (the campaign kernel
    runs its 256-thread instantiation, with the cache, where the GB kernel
    keeps the cache). ``k1_cases``: shape -> (a function
    that builds the 50-step GBIS op at 300 K, its pos, vel and forces);
    ``k3_cases``: shape -> (pos, tables, consts)."""
    res = {}
    for shape, (make_op, args) in k1_cases.items():
        n_rep, n = args[0].shape[:2]
        op = make_op()
        noise = fused_step.campaign_noise(3, 0, N_INNER, n_rep, n)
        plain = fused_step.campaign_advance_reference(
            *args, 0, 3, op.tables, noise=noise, **op.settings)[0]

        def make(make_op=make_op, args=args):
            op = make_op()
            return (lambda: op(*args, 0, 3)), op.kernel_info

        # the other instantiation: 512 threads where 256 run, and back
        other = 0 if op.gb_cached else n
        res[f"campaign_advance[gbis,{shape}]"] = both_variants(
            make, (gb, "GB_CACHE_MAX_ATOMS", other),
            lambda out, plain=plain: max_err(out[0], plain))
    for shape, (pos, tab, consts) in k3_cases.items():
        n = pos.shape[1]
        plain = gb.gb_forces_reference(pos, tab, consts)[0]

        def make(pos=pos, tab=tab, consts=consts, n=n):
            return (lambda: gb.gb_forces(pos, tab, consts)), lambda: gb_forces_facts(n)

        other = 0 if gb.gb_cached(n) else n
        res[f"gb_forces[{shape}]"] = both_variants(
            make, (gb, "GB_CACHE_MAX_ATOMS", other),
            lambda out, plain=plain: max_err(out[0], plain), repeats=20)
    return res


def gb_forces_facts(n):
    """The GB kernel's build facts for ``n`` atoms, with the variant
    ``gb.gb_cached`` picks."""
    cached = gb.gb_cached(n)
    return {"gb_cached": cached, **_build.kernel_info(
        "gb_forces", "mdx_gb_forces_info", [ctypes.c_int] * 2, n, int(cached))}


def cadence_arm(ff_m, pos0, ecfg, sasa_every, gb_every, n_rep, seed):
    """One NVE trace through the campaign kernel: ``n_rep`` replicas from
    ``pos0`` with their own Maxwell-Boltzmann velocities at 300 K (the same
    draw for every arm), gamma = 0, 1 fs, no constraints, CADENCE_STEPS
    steps, E_tot logged once a launch. The drift: each replica's
    least-squares slope of E_tot against the step, times the run's length,
    averaged over the replicas."""
    n = ff_m.n_atoms
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    std = torch.sqrt(mdx.units.BOLTZMANN * 300.0 / ff_m.masses)[None, :, None]
    vel = std * torch.randn((n_rep, n, 3), generator=gen, device="cuda")
    ens = with_forces(replicate(system_init(pos0, key=seed), n_rep, seed=1).replace(vel=vel),
                      ff_m, ecfg)
    cfg = SimulationConfig(dt_fs=1.0, temperature=0.0, gamma_ps=0.0, energy=ecfg,
                           fused_campaign=True, sasa_every=sasa_every, gb_every=gb_every)
    reset_launches()
    t0 = time.perf_counter()
    _, frames, log = simulate_ensemble(ens, ff_m, n_steps=CADENCE_STEPS, save_every=N_INNER,
                                       config=cfg)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = fused_step.campaign_advance.launches
    tag = f"cadence {n} atoms sasa_every={sasa_every} gb_every={gb_every}"
    check(launches == CADENCE_STEPS // N_INNER,
          f"{tag}: campaign kernel launched {launches} times, expected {CADENCE_STEPS // N_INNER}")
    check(bool(torch.isfinite(frames).all()), f"{tag}: non-finite frames")
    e = log["etot"].double().cpu()  # (saves, R)
    step = N_INNER * torch.arange(1, e.shape[0] + 1, dtype=torch.float64)[:, None]
    dt = step - step.mean()
    slope = (dt * (e - e.mean(0))).sum(0) / (dt * dt).sum()
    drift = slope * CADENCE_STEPS
    return {
        "atoms": n, "replicas": n_rep, "steps": CADENCE_STEPS, "launches": launches,
        "drift_kcal_mol": float(drift.mean()), "drift_by_replica": drift.tolist(),
        "etot_first_mean": float(e[0].mean()), "etot_std_mean": float(e.std(0).mean()),
        "T_mean_K": float(log["T"].mean()), "seconds": seconds,
    }


def cadence_phase(ff, pos_g, ff4, pos4):
    """The cadences' long-run soundness: NVE traces of the 104-atom system
    at every arm of CADENCE_ARMS, and of the 416-atom one at
    CADENCE_ARMS_416; at k > 1 the fitted drift of E_tot over the run
    within CADENCE_DRIFT_BOUND a 104-atom copy of the every-step arm's."""
    arms = {label: (ecfg, sasa_every, gb_every, ref)
            for label, ecfg, sasa_every, gb_every, ref in CADENCE_ARMS}
    res = {}
    for prefix, ff_m, pos0, labels, n_rep in (
        ("", ff, pos_g, list(arms), CADENCE_REPLICAS),
        (f"{ff4.n_atoms}_atoms,", ff4, pos4, CADENCE_ARMS_416, CADENCE_REPLICAS_416),
    ):
        copies = ff_m.n_atoms // ff.n_atoms
        for label in labels:
            ecfg, sasa_every, gb_every, _ = arms[label]
            res[prefix + label] = cadence_arm(ff_m, pos0, ecfg, sasa_every, gb_every, n_rep, SEED)
        for label in labels:
            ref = arms[label][3]
            if ref is None:
                continue
            gap = abs(res[prefix + label]["drift_kcal_mol"] - res[prefix + ref]["drift_kcal_mol"])
            res[prefix + label]["drift_minus_every_step_kcal_mol"] = gap
            res[prefix + label]["drift_minus_every_step_a_copy_kcal_mol"] = gap / copies
            check(gap / copies < CADENCE_DRIFT_BOUND,
                  f"cadence {prefix}{label}: its drift is {gap} kcal/mol from {ref}'s over "
                  f"{copies} copies (bound {CADENCE_DRIFT_BOUND} a copy): {res}")
    return res


def minimised_ensemble(ff_m, one, n_rep, seed):
    """The tiers' start: ``one`` (the 104-atom system FIRE-minimised under
    REFERENCE_CONFIG) in as many copies as ``ff_m`` holds, laid out as
    ``tiled_decaalanine`` lays them (50 A apart, past the 9 A cutoff: each
    copy's minimum is the tiled system's; a FIRE run of the whole took 36 s
    of the five tiers' starts), Maxwell-Boltzmann velocities at 300 K,
    forces, ``n_rep`` replicas."""
    force = mdx.force_fn(REFERENCE_CONFIG)
    pos0 = tiled_start(one, ff_m.n_atoms // one.shape[0]).contiguous()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    state = system_init(pos0, vel=maxwell_boltzmann(gen, ff_m.masses, 300.0), key=seed)
    state = initialize_forces(state, lambda p, box: force(p, ff_m))
    return pos0, replicate(state, n_rep, seed=1)


def campaign_check_at(ff_m, pos0, m):
    """The campaign kernel at this system: 5 steps at T = 0 against its plain
    version, 8 replicas near the minimum. Returns the check's row and a
    function that repeats it (the tier levers' error)."""
    n_m = ff_m.n_atoms
    op5 = fused_step.make_fused_campaign_op(ff_m, n_inner=5, dt_fs=1.0, temperature=0.0)
    s5 = op5.settings
    pos_c = (pos0[None] + 0.01 * torch.randn(
        (8, n_m, 3), generator=torch.Generator(device="cuda").manual_seed(m),
        device="cuda")).contiguous()
    vel_c = torch.zeros_like(pos_c)
    frc_c = fused_step.campaign_forces_reference(
        pos_c, op5.tables, s5["pair_consts"], s5["bias_consts"], 0).contiguous()
    out_p = fused_step.campaign_advance_reference(pos_c, vel_c, frc_c, 0, 1, op5.tables, **s5)

    def error(_=None):
        out_k = op5(pos_c, vel_c, frc_c, 0, 1)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x).all()) for x in out_k),
              f"campaign_advance at {n_m} atoms: non-finite output")
        return [max_err(a, b) for a, b in zip(out_k, out_p)]

    errs = error()
    check(errs[0] <= TOL_POS and errs[1] <= TOL_VEL and errs[2] <= TOL_FRC,
          f"campaign_advance at {n_m} atoms, T=0, 5 steps vs plain: {errs}")
    return {**dict(zip(("pos", "vel", "frc"), errs)), "shared_bytes": op5.shared_bytes,
            "threads": op5.kernel_info()["threads_per_cta"]}, lambda out: error()[0]


def campaign_tier_row(k1_op, pos, vel, frc, n_rep, live, launches):
    """The campaign kernel at a tier: ms per TIER_SAVE steps beside its
    bound (``campaign_bound``: the pair tests of the chunk pairs near each
    other at ``pos``, the per-atom layout's bytes; the dense-table design's
    count beside it), its SFU bound and its build facts."""
    tab = k1_op.tables
    s = k1_op.settings
    bound = campaign_bound(pos, tab, live, TIER_SAVE, s["shake_iters"], s["rattle_iters"],
                           s["pair_consts"][0])
    facts = build_facts(k1_op.kernel_info(), n_ctas=n_rep)
    return {
        "ms": time_ms(lambda: k1_op(pos, vel, frc, 0, 3), repeats=3),
        "n_inner": TIER_SAVE, "shared_bytes": k1_op.shared_bytes, "launches": launches,
        **bound,
        "sfu_bound_ms": sfu_ms(campaign_sfu_ops(
            n_rep, tab, live, TIER_SAVE, s["shake_iters"], s["rattle_iters"])),
        "live_unordered_pairs": live, **facts,
        "sms_used": min(facts["sm_count"], n_rep),
    }


def pair_forces_tier_row(pos, tabs, live, consts, plain_ms=None):
    """The pair-forces kernel (the campaign kernel's pair loop alone) at a
    tier: device ms a launch at 9 A with the reaction field (and the time of
    back-to-back launches) beside its bound (``loop_pair_bound``) and its
    build facts. Its launches: 0, no path launches it."""
    n_rep, n = pos.shape[:2]
    call = lambda: ring.pair_forces(pos, tabs, *PAIR_CASES["9A_rf"])
    return {
        "ms": device_ms(call), "ms_back_to_back": time_ms(call, repeats=20),
        **loop_pair_bound(pos, tabs, live, consts[0]), "live_unordered_pairs": live,
        "launches": 0, "plain_ms": plain_ms,
        **build_facts(_build.kernel_info("pair_forces", "mdx_pair_forces_info", [ctypes.c_int], n),
                      n_ctas=n_rep),
    }


#: the C entries that report the build facts of K5 and K6
PAIR_OP_INFO = {"nonbonded_rows": "mdx_nonbonded_rows_info", "pair_tiles": "mdx_pair_tiles_info"}
#: row chunks a CTA of the dense-row kernel takes (csrc/nonbonded_rows.cu kWarps)
K5_ROW_CHUNKS_A_CTA = 4


def pair_op_ctas(name, n_rep, n):
    """CTAs one launch of K5 (a replica's row chunks, four a CTA) or K6 (a
    replica's tile pairs) runs."""
    if name == "pair_tiles":
        return n_rep * ring.tile_pair_count(n)
    return n_rep * -(-nonbonded.chunk_count(n) // K5_ROW_CHUNKS_A_CTA)


def pair_op_tier_row(name, pos, tabs, live, consts, plain_ms, launches):
    """K5 or K6 at a tier: device ms a launch at 9 A with the reaction field
    (and the time of back-to-back launches) beside the bound the pair-forces
    kernel has (``loop_pair_bound``: the same work, each pair once) and the
    dense-table design's, its build facts and the SMs its CTAs cover."""
    n_rep, n = pos.shape[:2]
    call = lambda: PAIR_OP_KERNELS[name](pos, tabs, consts)
    ctas = pair_op_ctas(name, n_rep, n)
    facts = build_facts(_build.kernel_info(name, PAIR_OP_INFO[name], [ctypes.c_int], n),
                        n_ctas=ctas)
    return {"ms": device_ms(call), "ms_back_to_back": time_ms(call, repeats=20),
            "plain_ms": plain_ms, **loop_pair_bound(pos, tabs, live, consts[0]),
            "live_unordered_pairs": live, "launches": launches, "ctas": ctas, **facts,
            "sms_used": min(facts["sm_count"], ctas)}


def same_shape(times, shape):
    """The pair-forces kernel runs the campaign kernel's CTA shape."""
    k1, k2 = times["campaign_advance"][shape], times["pair_forces"][shape]
    check(k1["threads_per_cta"] == k2["threads_per_cta"],
          f"{shape}: the campaign kernel runs {k1['threads_per_cta']} threads a CTA, "
          f"the pair-forces kernel {k2['threads_per_cta']}")


def tiers_phase(lever_libs, pos_min):
    """The composed pair-op path (``fused_nonbonded`` at both
    ``kernel_variant``s) and the campaign kernel where it holds the system,
    at every TIERS size: aggregate steps/s and each kernel's launches, its
    counter set to 0 just before the path and read just after; then each
    kernel's time a launch at the tier's shape and positions. Above 104
    atoms, first the campaign kernel against its plain version. Then the
    campaign kernel alone at 12 copies (1,248 atoms, the most it holds), and
    the tier levers at 1,040 x 96. Every start is ``pos_min`` (the
    minimised 104-atom system) tiled."""
    counters = {"nonbonded_rows": nonbonded.nonbonded_rows, "pair_tiles": ring.pair_tiles,
                "campaign_advance": fused_step.campaign_advance}
    path_kernel = {"ring": "pair_tiles", "dense": "nonbonded_rows", "campaign": "campaign_advance"}
    rows, times, starts, k1_checks, lever_rows = {}, {}, {}, {}, {}
    for m, n_rep in TIERS:
        ff_m, _, _ = tiled_decaalanine(m)
        n_m = ff_m.n_atoms
        pos0, ens = minimised_ensemble(ff_m, pos_min, n_rep, seed=m)
        starts[m] = (ff_m, pos0, ens)
        if m > 1:
            k1_checks[f"{n_m}x8"], k1_error = campaign_check_at(ff_m, pos0, m)
        base = dict(dt_fs=1.0, temperature=300.0, gamma_ps=1.0, energy=REFERENCE_CONFIG)
        paths = {
            "ring": SimulationConfig(fused_nonbonded=True, kernel_variant="ring", **base),
            "dense": SimulationConfig(fused_nonbonded=True, kernel_variant="dense", **base),
        }
        k1_op = fused_step.make_fused_campaign_op(
            ff_m, n_inner=TIER_SAVE, dt_fs=1.0, temperature=300.0, gamma_ps=1.0)
        paths["campaign"] = SimulationConfig(fused_campaign=True, **base)
        for path, cfg in paths.items():
            # one save first, so that the timed call sees built tables
            simulate_ensemble(ens, ff_m, n_steps=TIER_SAVE, save_every=TIER_SAVE, config=cfg)
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            final, frames, log = simulate_ensemble(
                ens, ff_m, n_steps=TIER_STEPS, save_every=TIER_SAVE, config=cfg,
                obs_every=TIER_STEPS // TIER_SAVE)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = {k: c.launches for k, c in counters.items()}
            tag = f"tiers {n_m}x{n_rep} {path}"
            t_last = float(log["T"][-1].mean())
            check(bool(torch.isfinite(frames).all()), f"{tag}: non-finite frames")
            check(150.0 < t_last < 400.0, f"{tag}: ensemble-mean T of the last save {t_last} K")
            want = TIER_STEPS if path != "campaign" else TIER_STEPS // TIER_SAVE
            check(launches[path_kernel[path]] == want,
                  f"{tag}: {path_kernel[path]} launched {launches[path_kernel[path]]} times, expected {want}")
            rows[f"{n_m}x{n_rep}/{path}"] = {
                "atoms": n_m, "replicas": n_rep, "steps": TIER_STEPS, "seconds": seconds,
                "aggregate_steps_per_s": TIER_STEPS * n_rep / seconds,
                "atom_steps_per_s": TIER_STEPS * n_rep * n_m / seconds,
                "launches": launches, "T_last_mean_K": t_last,
            }

        # each kernel at this shape, at the positions the run ended at
        pos = final.pos.contiguous()
        tabs = nonbonded.build_pair_tables(ff_m)
        consts = nonbonded.pair_constants(*PAIR_CASES["9A_rf"])
        live = live_pair_count(pos, tabs, consts)
        plain_ms = time_ms(lambda: nonbonded.dense_pair_math(pos, tabs.dense, consts), repeats=2)
        shape = f"{n_m}x{n_rep}"
        for name, fn in PAIR_OP_KERNELS.items():
            times.setdefault(name, {})[shape] = pair_op_tier_row(
                name, pos, tabs, live, consts, plain_ms,
                rows[f"{shape}/{'ring' if name == 'pair_tiles' else 'dense'}"]["launches"][name])
        times.setdefault("pair_forces", {})[shape] = pair_forces_tier_row(
            pos, tabs, live, consts, plain_ms)
        vel = final.vel.contiguous()
        frc = final.forces.contiguous()
        times.setdefault("campaign_advance", {})[shape] = campaign_tier_row(
            k1_op, pos, vel, frc, n_rep, live,
            rows[f"{shape}/campaign"]["launches"]["campaign_advance"])
        same_shape(times, shape)
        if shape in ("416x192", "1040x96"):
            runs = {f"campaign_advance[{shape}]": (
                lambda: k1_op(pos, vel, frc, 0, 3), k1_error, k1_op.kernel_info)}
            plain_f = nonbonded.dense_pair_math(pos, tabs.dense, consts)[1]
            for name, fn in PAIR_OP_KERNELS.items():
                runs[f"{name}[{shape}]"] = (
                    lambda fn=fn: fn(pos, tabs, consts), lambda out: max_err(out[1], plain_f),
                    lambda name=name: _build.kernel_info(
                        name, PAIR_OP_INFO[name], [ctypes.c_int], n_m))
            rows_m = levers_phase(lever_libs, runs)
            hold_levers(rows_m, {f"campaign_advance[{shape}]": TOL_POS,
                                 **{f"{name}[{shape}]": TOL_PAIR_FORCE for name in PAIR_OP_KERNELS}})
            lever_rows.update(rows_m)
            del plain_f
        del tabs, final, frames

    # the largest system the campaign kernel holds: 12 copies, 96 replicas
    m, n_rep = 12, 96
    ff_m, _, _ = tiled_decaalanine(m)
    pos0, ens = minimised_ensemble(ff_m, pos_min, n_rep, seed=m)
    k1_checks[f"{ff_m.n_atoms}x8"], _ = campaign_check_at(ff_m, pos0, m)
    k1_op = fused_step.make_fused_campaign_op(
        ff_m, n_inner=TIER_SAVE, dt_fs=1.0, temperature=300.0, gamma_ps=1.0)
    reset_launches()
    final, _, _ = simulate_ensemble(ens, ff_m, n_steps=TIER_SAVE, save_every=TIER_SAVE,
                                    config=SimulationConfig(fused_campaign=True, dt_fs=1.0,
                                                            temperature=300.0, energy=REFERENCE_CONFIG))
    torch.cuda.synchronize()
    launches = fused_step.campaign_advance.launches
    check(launches == 1 and bool(torch.isfinite(final.pos).all()),
          f"campaign at {ff_m.n_atoms} atoms: {launches} launches, finite {bool(torch.isfinite(final.pos).all())}")
    pos = final.pos.contiguous()
    tabs = nonbonded.build_pair_tables(ff_m)
    consts = nonbonded.pair_constants(*PAIR_CASES["9A_rf"])
    live = live_pair_count(pos, tabs, consts)
    shape = f"{ff_m.n_atoms}x{n_rep}"
    times["pair_forces"][shape] = pair_forces_tier_row(pos, tabs, live, consts)
    times["campaign_advance"][shape] = campaign_tier_row(
        k1_op, pos, final.vel.contiguous(), final.forces.contiguous(), n_rep, live, launches)
    same_shape(times, shape)
    return rows, times, starts, k1_checks, lever_rows


def grad_phase(ff4, pos_min4, rng):
    """Gradients through GRAD_STEPS steps of the composed path (ring, dense)
    and of the all-autograd path, at 416 atoms x 8 replicas, T = 0: the loss
    is a fixed weighted sum of the final positions and velocities."""
    n_rep, n4 = 8, ff4.n_atoms
    pos0 = (pos_min4[None] + torch.as_tensor(
        rng.normal(0.0, 0.02, (n_rep, n4, 3)), dtype=torch.float32, device="cuda")).contiguous()
    std = torch.sqrt(mdx.units.BOLTZMANN * 300.0 / ff4.masses)[None, :, None]
    vel0 = std * torch.as_tensor(rng.normal(size=(n_rep, n4, 3)), dtype=torch.float32, device="cuda")
    frc0 = mdx.force_fn(REFERENCE_CONFIG)(pos0, ff4).detach()
    w_pos, w_vel = (torch.as_tensor(rng.normal(size=(n_rep, n4, 3)), dtype=torch.float32,
                                    device="cuda") for _ in range(2))
    grads = {}
    for label, kw in (("ring", dict(fused_nonbonded=True, kernel_variant="ring")),
                      ("dense", dict(fused_nonbonded=True, kernel_variant="dense")),
                      ("autograd", {})):
        step_fn = make_ensemble_step_fn(ff4, SimulationConfig(dt_fs=1.0, temperature=0.0, **kw))
        p = pos0.clone().requires_grad_(True)
        st = MDState(pos=p, vel=vel0, forces=frc0,
                     box=torch.zeros((n_rep, 3), device="cuda"),
                     key=torch.zeros(n_rep, dtype=torch.int64, device="cuda"),
                     step=torch.zeros(n_rep, dtype=torch.int64, device="cuda"))
        for _ in range(GRAD_STEPS):
            st = step_fn(st)
        loss = (w_pos * st.pos).sum() + (w_vel * st.vel).sum()
        (grads[label],) = torch.autograd.grad(loss, p)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(grads[label]).all()), f"grad {label}: non-finite gradient")
    scale = float(grads["autograd"].abs().max())
    res = {"max_abs_grad_autograd": scale}
    for a, b in (("ring", "autograd"), ("dense", "autograd"), ("ring", "dense")):
        res[f"{a}_vs_{b}_relative"] = max_err(grads[a], grads[b]) / scale
        check(res[f"{a}_vs_{b}_relative"] <= TOL_GRAD, f"grad {a} vs {b}: {res}")
    return res


def backbone_campaign_check(rng):
    """The campaign kernel on the tables build_ff_params makes: the 40-atom
    backbone (a chunk of 32 and a tail of 8, 4 LJ types from the swapped
    YAML fields, harmonic impropers, no hydrogens and no constraints), FIRE,
    then one launch of 50 steps at 1024 replicas against the plain version,
    at T = 0 and at 300 K with the same noise, and 50 = 25 + 25."""
    top, coords = decaalanine_backbone()
    ff_bb = build_ff_params(top, YamlForceField(BACKBONE_FF_PRM))
    n_bb = ff_bb.n_atoms
    check(n_bb == 40 and hydrogen_bond_constraints(ff_bb).n_constraints == 0,
          f"backbone: {n_bb} atoms")
    force = mdx.force_fn(REFERENCE_CONFIG)
    pos0 = minimize_fire(torch.as_tensor(coords, dtype=torch.float32, device="cuda"),
                         lambda p: force(p, ff_bb), n_steps=500, dt_start=1e-3, dt_max=1e-2)
    d0 = float(torch.linalg.norm(pos0[-1] - pos0[0]))
    bias_bb = HarmonicSMDBias.create(n_atoms=n_bb, group1=[0], group2=[n_bb - 1], fk=1.0,
                                     cent_0=d0, cent_1=d0 + 22.0, T=500_000.0)
    jitter = rng.normal(0.0, 0.01, (N_REPLICAS, n_bb, 3))
    pos = (pos0[None] + torch.as_tensor(jitter, dtype=torch.float32, device="cuda")).contiguous()
    std = torch.sqrt(mdx.units.BOLTZMANN * 300.0 / ff_bb.masses)[None, :, None]
    vel = (std * torch.randn((N_REPLICAS, n_bb, 3), device="cuda",
                             generator=torch.Generator(device="cuda").manual_seed(SEED))
           ).contiguous()

    def make(n_inner, temperature):
        return fused_step.make_fused_campaign_op(
            ff_bb, n_inner=n_inner, dt_fs=1.0, temperature=temperature, gamma_ps=1.0,
            bias=bias_bb)

    op0, op300 = make(N_INNER, 0.0), make(N_INNER, 300.0)
    st = op0.settings
    frc = fused_step.campaign_forces_reference(
        pos, op0.tables, st["pair_consts"], st["bias_consts"], 0).contiguous()
    res = {"atoms": n_bb, "lj_types": op0.tables.pair.n_lj_types,
           "special_pairs": op0.tables.pair.n_special, "d0_A": d0}
    tols = (TOL_POS_50, TOL_VEL, TOL_FRC)
    for label, op, t0, seed, noise in (
        ("T=0", op0, 0, 1, None),
        ("T=300,same noise", op300, 40, 13,
         fused_step.campaign_noise(13, 40, N_INNER, N_REPLICAS, n_bb)),
    ):
        out_k = op(pos, vel, frc, t0, seed)
        out_p = fused_step.campaign_advance_reference(
            pos, vel, frc, t0, seed, op.tables, noise=noise, **op.settings)
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(x).all()) for x in out_k),
              f"campaign_advance on the backbone, {label}: non-finite output")
        errs = [max_err(a, b) for a, b in zip(out_k, out_p)]
        res[label] = dict(zip(("pos", "vel", "frc"), errs))
        check(all(e <= tol for e, tol in zip(errs, tols)),
              f"campaign_advance on the backbone, {label}, 50 steps vs plain: {errs} "
              f"(bounds {tols})")
    op25 = make(25, 300.0)
    a = op300(pos, vel, frc, 100, 7)
    c = op25(*op25(pos, vel, frc, 100, 7), 125, 7)
    torch.cuda.synchronize()
    res["split_25_25_equal"] = all(torch.equal(x, y) for x, y in zip(a, c))
    check(res["split_25_25_equal"], "campaign_advance on the backbone: 50 steps differ from 25 + 25")
    res["threads"] = op0.kernel_info()["threads_per_cta"]
    return res


def run_cli(argv):
    """``cli.main(argv)`` with its standard output captured: the wall seconds
    (ending in a device synchronisation) and the lines it printed."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"cli {' '.join(argv)}: exit code {rc}")
    return wall, buf.getvalue().strip().splitlines()


#: a replica whose temperature passes this at a save has collapsed
COLLAPSE_T_K = 1000.0
#: the share of replicas of the 40-atom backbone run that may collapse: its
#: YAML force field has next to no LJ repulsion (the swapped fields give
#: A ~ 1e-10), so an unexcluded pair of opposite charges can fall together.
#: The share depends on the one velocity draw every replica starts from: 3
#: of 1024 on the card, 85 of 1024 in the JAX CLI's run on the CPU. A
#: broken kernel would lose most replicas; ``collapse_check`` holds the
#: first collapse against the plain version.
COLLAPSE_SHARE_BACKBONE = 0.25


def cli_campaign_run(n_atoms, overrides, config=None, collapse_share=0.0, n_rep=N_REPLICAS,
                     starts=None):
    """One ``cli simulate`` campaign of ``n_rep`` x N_STEPS through the
    campaign kernel into a temporary directory: the kernel's launches, the
    printed rate, the seconds outside ``simulate_ensemble`` (loading, FIRE,
    the files; the start, ``cli.prepare_campaign``, timed inside the run, so
    that the rest is the files), and the gates on what it wrote. A replica whose logged T
    passes COLLAPSE_T_K at some save has collapsed: at most
    ``collapse_share`` of them may, and the ensemble gates hold over the
    others. Returns the result and replica 0's frames; the run's start
    (what ``cli.prepare_campaign`` returned) is appended to ``starts`` where
    that is a list."""
    n_saves = N_STEPS // N_INNER
    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "out"
        reset_launches()
        argv = ["simulate", *(["--config", config] if config else [])]
        for ov in (*campaign_overrides(overrides, n_rep), f"out_dir={out}"):
            argv += ["-o", ov]
        prepare = cli.prepare_campaign
        prepare_s = []

        def timed_prepare(*args, **kwargs):
            t0 = time.perf_counter()
            start = prepare(*args, **kwargs)
            torch.cuda.synchronize()
            prepare_s.append(time.perf_counter() - t0)
            if starts is not None:
                starts.append(start)
            return start

        with patched([(cli, "prepare_campaign", timed_prepare)]):
            wall, lines = run_cli(argv)
        check(len(prepare_s) == 1, f"cli simulate ran prepare_campaign {len(prepare_s)} times")
        prepare_s = prepare_s[0]
        launches = fused_step.campaign_advance.launches
        line = json.loads(lines[-1])
        tag = f"cli simulate {' '.join(overrides)}"
        check(line["frames"] == [n_saves, n_rep, n_atoms, 3], f"{tag}: {line}")
        check(launches == n_saves,
              f"{tag}: campaign kernel launched {launches} times, expected {n_saves}")
        frames = np.stack([np.load(out / f"raw-traj_rep-{r}.npy") for r in range(n_rep)],
                          axis=1)
        check(frames.shape == (n_saves, n_rep, n_atoms, 3),
              f"{tag}: replica files {frames.shape}")
        dcd, cells = read_dcd(str(out / "rep0.dcd"))
        check(cells is None and np.array_equal(dcd, frames[:, 0]),
              f"{tag}: rep0.dcd read back differs from frames[:, 0]")
        xyz = read_xyz(str(out / "rep0.xyz"))
        check(xyz.shape == frames[:, 0].shape, f"{tag}: rep0.xyz {xyz.shape}")
        with open(out / "sim_log.csv") as fh:
            rows = list(csv.DictReader(fh))
    check(len(rows) == n_saves * n_rep, f"{tag}: {len(rows)} log rows")

    def column(key):
        return np.array([float(r[key]) for r in rows]).reshape(n_saves, n_rep)

    temps = column("T")
    collapsed = ~(temps < COLLAPSE_T_K).all(axis=0) | ~np.isfinite(frames).all(axis=(0, 2, 3))
    kept = ~collapsed
    check(collapsed.sum() <= collapse_share * n_rep,
          f"{tag}: {int(collapsed.sum())} replicas collapsed (T above {COLLAPSE_T_K} K), "
          f"at most {collapse_share:.0%} may: {np.flatnonzero(collapsed)[:20].tolist()}")
    check(np.abs(xyz - frames[:, 0]).max() < 1e-5 or collapsed[0], f"{tag}: rep0.xyz differs")
    t_mean = float(temps[-1, kept].mean())
    lag = float(np.abs(column("colvar_value") - column("colvar_center"))[-1, kept].mean())
    flat = frames[-1, kept].reshape(int(kept.sum()), -1)
    spread = float(np.abs(flat[1:] - flat[:-1]).max(axis=1).min())
    check(np.isfinite(frames[:, kept]).all(), f"{tag}: non-finite frames")
    check(150.0 < t_mean < 350.0, f"{tag}: ensemble-mean T of the last save {t_mean} K")
    check(lag < 2.0, f"{tag}: mean |colvar - centre| {lag} A")
    check(spread > 1e-3, f"{tag}: neighbouring replicas coincide ({spread})")
    simulate_s = line["replicas"] * line["steps"] / line["steps_per_sec"]
    # what the seconds outside simulate_ensemble hold: the start (load, FIRE,
    # bias, velocities, forces, replicas), the rest is the files
    return {
        "atoms": n_atoms, "frames": line["frames"], "campaign_kernel_launches": launches,
        "steps_per_sec": line["steps_per_sec"], "wall_seconds": wall,
        "simulate_ensemble_seconds": simulate_s, "seconds_outside_simulate": wall - simulate_s,
        "prepare_campaign_seconds": prepare_s,
        "files_seconds": wall - simulate_s - prepare_s,
        "T_last_mean_K": t_mean, "colvar_lag_A": lag,
        "colvar_center_last_A": float(column("colvar_center")[-1, 0]),
        "min_neighbour_spread_A": spread, "dcd_equals_frames": True,
        "collapsed_replicas": np.flatnonzero(collapsed).tolist(),
    }, frames[:, 0]


def campaign_overrides(overrides, n_rep=N_REPLICAS):
    """The overrides of an ``n_rep`` x 2000 campaign through the campaign kernel."""
    return [*overrides, f"n_replicas={n_rep}", f"n_steps={N_STEPS}",
            f"save_every={N_INNER}", "sim.fused_campaign=true"]


def collapse_check(overrides, cli_collapsed, start):
    """A cli run's collapse, taken apart: the run again in this process from
    the CLI's own start (``start``, what its ``cli.prepare_campaign`` returned
    for the same config), segment
    by segment through the op ``simulate_ensemble`` launches, then the
    segment in which the first replica collapses once more through the
    plain version with the kernel's noise. The kernel must carry that
    replica where the plain version does, so the collapse is the force
    field's, not the kernel's."""
    cfg = apply_overrides(CampaignConfig(), campaign_overrides(overrides))
    ff_c, _, bias_c, ens = start
    advance = _campaign_advance_fn(ff_c, cfg.save_every, cfg.sim, bias_c)
    key0 = int(ens.key[0])

    def temps(vel):
        return mdx.temperature(mdx.kinetic_energy(vel, ff_c.masses), ff_c.n_atoms)

    state = (ens.pos.contiguous(), ens.vel.contiguous(), ens.forces.contiguous())
    hot = torch.zeros(N_REPLICAS, dtype=torch.bool, device="cuda")
    first = None
    for s in range(cfg.n_steps // cfg.save_every):
        t0 = s * cfg.save_every
        nxt = advance(*state, t0, mix_seed(key0, t0))
        now_hot = ~(temps(nxt[1]) < COLLAPSE_T_K)
        if first is None and bool(now_hot.any()):
            first = (t0, state, int(torch.nonzero(now_hot)[0]))
        hot |= now_hot
        state = nxt
    res = {"collapsed_replicas": torch.nonzero(hot).flatten().tolist()}
    res["same_as_cli_run"] = res["collapsed_replicas"] == cli_collapsed
    if first is None:
        check(not cli_collapsed, f"collapse check: the cli run collapsed {cli_collapsed}, "
                                 "its repetition nowhere")
        return res
    t0, start, r = first
    seed = mix_seed(key0, t0)
    out_k = advance(*start, t0, seed)
    out_p = fused_step.campaign_advance_reference(
        *start, t0, seed, advance.tables, noise=fused_step.campaign_noise(
            seed, t0, cfg.save_every, N_REPLICAS, ff_c.n_atoms), **advance.settings)
    torch.cuda.synchronize()
    mask = (ff_c.nb_mask | ff_c.nb_mask.T)

    def closest_pair(pos):
        d = torch.cdist(pos[None].double(), pos[None].double())[0]
        d = torch.where(mask, d, torch.full_like(d, float("inf")))
        k = int(torch.argmin(d))
        i, j = divmod(k, ff_c.n_atoms)
        return {"atoms": [i, j], "distance_A": float(d[i, j]),
                "charges": [float(ff_c.charges[i]), float(ff_c.charges[j])]}

    res.update({
        "first_replica": r, "segment_start_step": t0,
        "pos_err_kernel_vs_plain_A": max_err(out_k[0][r], out_p[0][r]),
        "T_end_kernel_K": float(temps(out_k[1][r])), "T_end_plain_K": float(temps(out_p[1][r])),
        "closest_unexcluded_pair_at_start": closest_pair(start[0][r]),
        "closest_unexcluded_pair_at_end_plain": closest_pair(out_p[0][r]),
    })
    check(res["pos_err_kernel_vs_plain_A"] <= TOL_POS_50
          and res["T_end_kernel_K"] > COLLAPSE_T_K and res["T_end_plain_K"] > COLLAPSE_T_K,
          f"collapse check: kernel and plain version part in the collapsing segment: {res}")
    return res


def energy_printed_vs(argv, ff_e, pos):
    """``cli energy`` against ``energy_terms`` of the same system: the
    printed (float32, 4 decimals) values on the card against float64 on the
    host, within 1e-3 kcal/mol or 1e-3 relative, whichever is larger."""
    _, lines = run_cli(["energy", *argv])
    printed = ast.literal_eval(lines[-1])
    ff64 = ff_e.to(device="cpu", dtype=torch.float64)
    ref = energy_terms(torch.as_tensor(pos, dtype=torch.float64), ff64, config=REFERENCE_CONFIG)
    ref = {k: float(v) for k, v in ref.items()}
    check(set(printed) == set(ref), f"cli energy {argv}: terms {sorted(printed)}")
    err = {k: abs(printed[k] - v) for k, v in ref.items()}
    check(all(e <= max(1e-3, 1e-3 * abs(ref[k])) for k, e in err.items()),
          f"cli energy {argv}: printed {printed} vs float64 {ref}")
    return {"printed": printed, "max_abs_err_vs_f64": max(err.values())}


def cli_phase(ff, coords):
    """The command line on the card: three 1024 x 2000 campaigns, the energy
    printout, and two short runs of the composed pair-op path."""
    res = {}
    gbis_cfg = {**dataclasses.asdict(GBIS_CONFIG), "terms": list(GBIS_CONFIG.terms)}
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = pathlib.Path(tmp) / "gbis.json"
        cfg_path.write_text(json.dumps({"sim": {"energy": gbis_cfg, "sasa_every": 1}}))
        # the 104-atom runs pull atom 0 against atom 103 (the default groups
        # are the 40-atom backbone's ends) at the campaign's pace, the
        # centre from the measured distance to 34 A over 500,000 steps
        full = ["topology=example:full", "colvar.group2=[103]", "colvar.T=500000",
                "sim.dt_fs=2.0", "sim.constrain_h_bonds=true"]
        res["vacuum"], _ = cli_campaign_run(104, full)
        res["gbis"], _ = cli_campaign_run(104, full, config=str(cfg_path))
    # the generated backbone as the JAX CLI test runs it, at 1 fs
    starts = []
    res["backbone"], _ = cli_campaign_run(40, ["sim.dt_fs=1.0"],
                                       collapse_share=COLLAPSE_SHARE_BACKBONE, starts=starts)
    res["backbone_collapse"] = collapse_check(["sim.dt_fs=1.0"],
                                              res["backbone"]["collapsed_replicas"], starts[0])

    res["energy_example_full"] = energy_printed_vs(["--topology", "example:full"], ff, coords)
    psf, yaml_path, pdb = (str(GOLDENS / f) for f in (
        "backbone-no-improp.psf", "param_bb-3.0.yaml", "backbone.pdb"))
    ff_g = build_ff_params(read_psf(psf), YamlForceField(yaml_path))
    res["energy_psf_yaml_pdb"] = energy_printed_vs(
        ["--topology", psf, "--parameters", yaml_path, "--coordinates", pdb], ff_g,
        read_pdb(pdb)[0])

    pair_launches = {}
    for variant, counted in (("ring", ring.pair_tiles), ("dense", nonbonded.nonbonded_rows)):
        with tempfile.TemporaryDirectory() as tmp:
            reset_launches()
            _, lines = run_cli([
                "simulate", "-o", "topology=example:full", "-o", "colvar.group2=[103]",
                "-o", f"n_replicas={CLI_CHECK_REPLICAS}", "-o", f"n_steps={CLI_CHECK_STEPS}",
                "-o", f"save_every={CLI_CHECK_STEPS}", "-o", "sim.constrain_h_bonds=true",
                "-o", "sim.fused_nonbonded=true", "-o", f"sim.kernel_variant={variant}",
                "-o", f"out_dir={tmp}/out"])
            pair_launches[counted.__name__] = counted.launches
            frames = np.load(pathlib.Path(tmp) / "out" / "raw-traj_rep-0.npy")
            check(np.isfinite(frames).all(), f"cli fused_nonbonded {variant}: non-finite")
            check(counted.launches == CLI_CHECK_STEPS,
                  f"cli fused_nonbonded {variant}: {counted.__name__} launched "
                  f"{counted.launches} times, expected {CLI_CHECK_STEPS}")
            res[f"fused_nonbonded_{variant}"] = {
                "line": json.loads(lines[-1]), f"{counted.__name__}_launches": counted.launches}
    return res, pair_launches


# -- host I/O: prmtop, CHARMM .prm with CMAP, trajectories ------------------------


def load_test_files(path=TEST_FILES):
    """``tests/torch_files.py``, the numpy-only writer of the prmtop, .prm
    and PSF fixtures (or another helper of ``tests/``), loaded by its path."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_prmtop_system(files, tmp):
    """The packaged 104-atom tables as a chamber prmtop and their start
    coordinates as a PDB; returns both paths and the PDB's coordinates."""
    with np.load(FULL_DA_NPZ) as raw:
        tables = {k[3:]: raw[k] for k in raw.files if k.startswith("ff_")}
        meta = {k: raw[k] for k in ("atom_names", "atom_types", "res_ids", "res_names")}
        coords = raw["coords"]
    prmtop, pdb = tmp / "full_da.prmtop", tmp / "full_da.pdb"
    files.write_prmtop(prmtop, tables, meta["atom_names"], meta["atom_types"],
                       meta["res_ids"], meta["res_names"])
    write_pdb(str(pdb), coords, meta["atom_names"], resnames=meta["res_names"],
              resids=meta["res_ids"])
    return str(prmtop), str(pdb), read_pdb(str(pdb))[0]


def prmtop_energies(prmtop, pdb, pdb_coords, ff, dev):
    """``cli energy`` on the prmtop + PDB against ``energy_terms`` of
    ``example:full`` in float64, and the prmtop's tables against the
    packaged ones in float64 on the card under REFERENCE_CONFIG and
    GBIS_CONFIG (the GB tables follow the elements inferred from the
    prmtop's names and masses), term by term."""
    res = {"cli_energy": energy_printed_vs(
        ["--topology", prmtop, "--coordinates", pdb, "--device", dev.type], ff, pdb_coords)}
    ff_p = prmtop_to_ff_params(prmtop, dtype=torch.float64, device=dev)
    ff_e, _, _ = decaalanine_full(dtype=torch.float64, device=dev)
    pos = torch.as_tensor(pdb_coords, dtype=torch.float64, device=dev)
    for name, cfg in (("reference", REFERENCE_CONFIG), ("gbis", GBIS_CONFIG)):
        got, want = energy_terms(pos, ff_p, config=cfg), energy_terms(pos, ff_e, config=cfg)
        check(set(got) == set(want), f"prmtop energy terms {sorted(got)} vs {sorted(want)}")
        rel = {k: abs(float(got[k]) - float(v)) / max(abs(float(v)), 1.0)
               for k, v in want.items()}
        check(max(rel.values()) <= TOL_PRMTOP_REL,
              f"prmtop vs example:full ({name}), relative errors {rel}")
        res[f"f64_{name}"] = {"max_rel_err": max(rel.values()),
                              "terms": {k: float(v) for k, v in got.items()}}
    res["nb_mask_equal"] = bool(torch.equal(ff_p.nb_mask, ff_e.nb_mask))
    res["qq_pair_max_abs_diff"] = max_err(ff_p.qq_pair, ff_e.qq_pair)
    check(res["nb_mask_equal"], "prmtop: the exclusion mask differs from the packaged one")
    return res


def cmap_checks(files, tmp, ff, coords, meta, dev, n_rep=N_REPLICAS):
    """A CHARMM .prm with one smooth periodic 24 x 24 map on the alanine
    key, read by ``CharmmPrm`` and attached to the 104-atom system on the
    rows ``ff.builder`` derives from its backbone names; ``total_energy`` and
    forces with the cmap term in float32 on ``dev`` against float64 on the
    CPU on ``n_rep`` jittered states; ``simulate_ensemble`` with no kernel
    flag (no launch); ``tile_ff_params(m=4)`` against 4 copies;
    ``repulsion`` / ``repulsioncg`` in float32 against float64."""
    prm_path = tmp / "ala_cmap.prm"
    files.write_charmm_prm(prm_path, {ALA_CMAP_KEY: files.smooth_cmap(24, seed=SEED % 1000)})
    prm = CharmmPrm(str(prm_path))
    top = cli._meta_topology(ff, meta)
    rows, grids, gids = ff_builder._cmap_tables(top, prm, np.asarray(top.atom_types))
    check(len(rows) == 8 and len(grids) == 1,
          f"cmap: {len(rows)} cross-terms on {len(grids)} maps, expected 8 on 1")
    ff_c = attach_cmap_params(ff.to(device=dev, dtype=torch.float32), rows, grids, gids)
    ff64 = ff_c.to(device="cpu", dtype=torch.float64)
    rng = np.random.default_rng(SEED)
    pos = coords[None] + rng.normal(0.0, 0.1, (n_rep,) + coords.shape)
    pos32 = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    pos64 = torch.as_tensor(pos, dtype=torch.float64)
    res = {"cross_terms": len(rows), "grid": list(grids[0].shape), "replicas": n_rep}

    def vs_float64(cfg, ff32, ff_64, label):
        t32, f32 = energy_and_forces(pos32, ff32, config=cfg)
        t64, f64 = energy_and_forces(pos64, ff_64, config=cfg)
        e32 = torch.stack(list(t32.values())).sum(0).double().cpu()
        e64 = torch.stack(list(t64.values())).sum(0)
        out = {
            "energy_max_rel_err": float(((e32 - e64).abs() / e64.abs().clamp_min(1.0)).max()),
            "force_max_rel_err": max_err(f32.cpu(), f64) / float(f64.abs().max()),
            "terms_max_abs_err": {k: max_err(t32[k].cpu(), v) for k, v in t64.items()},
            "terms_mean_f64": {k: float(v.mean()) for k, v in t64.items()},
        }
        check(out["energy_max_rel_err"] <= TOL_F32_ENERGY_REL
              and out["force_max_rel_err"] <= TOL_F32_FORCE_REL,
              f"{label}: float32 on {dev} against float64: {out}")
        return out

    cfg_c = dataclasses.replace(REFERENCE_CONFIG, terms=DEFAULT_TERMS + ("cmap",))
    res["cmap_f32_vs_f64"] = vs_float64(cfg_c, ff_c, ff64, "cmap")
    res["cmap_f32_abs_err"] = res["cmap_f32_vs_f64"]["terms_max_abs_err"]["cmap"]
    check(res["cmap_f32_abs_err"] <= TOL_F32_CMAP_ABS,
          f"cmap term: float32 off float64 by {res['cmap_f32_abs_err']} kcal/mol")
    check(abs(res["cmap_f32_vs_f64"]["terms_mean_f64"]["cmap"]) > 0.1, "cmap term reads 0")

    # the composed per-step path with the cmap term: autograd, no kernel
    scfg = SimulationConfig(dt_fs=1.0, temperature=300.0, energy=cfg_c)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    state = system_init(torch.as_tensor(coords, dtype=torch.float32, device=dev),
                        vel=maxwell_boltzmann(gen, ff_c.masses, 300.0), key=SEED, device=dev)
    force = mdx.force_fn(cfg_c)
    state = initialize_forces(state, lambda p, box: force(p, ff_c))
    ens = replicate(state, n_rep, seed=SEED)
    reset_launches()
    t0 = time.perf_counter()
    _, frames, log = simulate_ensemble(ens, ff_c, CMAP_STEPS, CMAP_STEPS, scfg)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    res["simulate_no_flag"] = {
        "steps": CMAP_STEPS, "seconds": time.perf_counter() - t0, "launches": read_launches(),
        "T_K": float(log["T"].mean()), "frames_finite": bool(torch.isfinite(frames).all())}
    check(not any(res["simulate_no_flag"]["launches"].values()),
          f"cmap simulate_ensemble (no kernel flag) launched {res['simulate_no_flag']['launches']}")
    check(res["simulate_no_flag"]["frames_finite"], "cmap simulate_ensemble: non-finite frames")

    # four far-apart copies: four times the single copy's energy, term by term
    ff_dev64 = ff_c.to(device=dev, dtype=torch.float64)
    ff4 = tile_ff_params(ff_dev64, 4)
    one = energy_terms(torch.as_tensor(coords, dtype=torch.float64, device=dev), ff_dev64,
                       config=cfg_c)
    shifted = np.concatenate([coords + [60.0 * k, 0.0, 0.0] for k in range(4)])
    four = energy_terms(torch.as_tensor(shifted, dtype=torch.float64, device=dev), ff4,
                        config=cfg_c)
    rel4 = {k: abs(float(four[k]) - 4 * float(v)) / max(abs(4 * float(v)), 1.0)
            for k, v in one.items()}
    res["tile_m4_max_rel_err"] = max(rel4.values())
    check(res["tile_m4_max_rel_err"] <= 1e-9 and ff4.cmap_idx.shape[0] == 4 * len(rows),
          f"tile_ff_params(m=4) with CMAP: {rel4}")

    cfg_r = EnergyConfig(terms=("bonds", "angles", "repulsion", "repulsioncg"),
                         cutoff=9.0, switch_dist=7.5)
    res["repulsion_f32_vs_f64"] = vs_float64(cfg_r, ff_c, ff64, "repulsion")
    return res


def trajectory_checks(tmp, rep0):
    """``cli convert`` on the in-repo golden .xtc (the native decoder equal
    to the pure-Python one, the re-encoding equal to the file's bytes), the
    campaign's replica-0 frames through the native xtc and mdxtc writers
    and back through ``cli convert`` within their quantisation, and through
    the asynchronous sink in both formats, read back equal."""
    res = {}
    golden = GOLDENS / "golden.xtc"
    blob = golden.read_bytes()
    check(hashlib.sha256(blob).hexdigest() == GOLDEN_XTC_SHA256, "golden.xtc changed")
    _, lines = run_cli(["convert", str(golden), str(tmp / "golden.npy")])
    decoded, plain = np.load(tmp / "golden.npy"), read_xtc_py(str(golden))
    check(np.array_equal(decoded, plain) and np.array_equal(native.xtc_read(str(golden)), plain),
          "golden.xtc: the native decoder and the pure-Python one differ")
    native.xtc_write(str(tmp / "again.xtc"), np.load(GOLDENS / "golden_xtc_coords.npy"))
    check((tmp / "again.xtc").read_bytes() == blob, "golden.xtc: re-encoding differs")
    res["golden_xtc"] = {"frames": list(decoded.shape), "decoders_equal": True,
                         "reencoded_sha256_equal": True}
    for codec, precision, quant in (("xtc", 1000.0, XTC_QUANT_A),
                                    ("mdxtc", 10000.0, MDXTC_QUANT_A)):
        path = tmp / f"rep0.{codec}"
        getattr(native, f"{codec}_write")(str(path), rep0, precision=precision)
        run_cli(["convert", str(path), str(tmp / f"rep0_{codec}.npy")])
        err = float(np.abs(np.load(tmp / f"rep0_{codec}.npy") - rep0).max())
        check(err <= quant, f"rep0 through {codec} and cli convert: {err} A, bound {quant}")
        res[codec] = {"frames": list(rep0.shape), "max_abs_err_A": err, "bound_A": quant,
                      "bytes": path.stat().st_size, "raw_bytes": int(rep0.nbytes)}
    for fmt in ("raw", "dcd"):
        path = tmp / f"sink.{fmt}"
        with native.AsyncTrajectorySink(str(path), rep0.shape[1], fmt=fmt) as sink:
            for frame in rep0:
                sink.push(frame)
            written = sink.close()
        back = (np.fromfile(path, np.float32).reshape(rep0.shape) if fmt == "raw"
                else read_dcd(str(path))[0])
        check(written == len(rep0) and np.array_equal(back, rep0),
              f"AsyncTrajectorySink {fmt}: {written} frames, read back differs")
        res[f"sink_{fmt}"] = {"frames": written, "equal": True}
    return res


def host_io_phase(ff, coords, meta, cli_res):
    """The host I/O on the card: the prmtop system's energies and two
    1024 x 2000 ``cli simulate`` campaigns from it (vacuum with rigid X-H
    bonds at 2 fs, and GBIS_CONFIG), CMAP at full width, and the trajectory
    codecs on the vacuum campaign's replica 0."""
    files = load_test_files()
    dev = torch.device("cuda")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        native.build()
        res["native_build_seconds"] = time.perf_counter() - t0
        prmtop, pdb, pdb_coords = write_prmtop_system(files, tmp)
        res["energies"] = prmtop_energies(prmtop, pdb, pdb_coords, ff, dev)
        gbis_cfg = {**dataclasses.asdict(GBIS_CONFIG), "terms": list(GBIS_CONFIG.terms)}
        cfg_path = tmp / "gbis.json"
        cfg_path.write_text(json.dumps({"sim": {"energy": gbis_cfg, "sasa_every": 1}}))
        run = [f"topology={prmtop}", f"coordinates={pdb}", "colvar.group2=[103]",
               "colvar.T=500000", "sim.dt_fs=2.0", "sim.constrain_h_bonds=true"]
        res["vacuum"], rep0 = cli_campaign_run(104, run)
        res["gbis"], _ = cli_campaign_run(104, run, config=str(cfg_path))
        for name in ("vacuum", "gbis"):
            res[name]["example_full_steps_per_sec"] = cli_res[name]["steps_per_sec"]
        res["cmap"] = cmap_checks(files, tmp, ff, coords, meta, dev)
        res["trajectories"] = trajectory_checks(tmp, rep0)
    launches = {
        f"host_io: cli simulate prmtop vacuum {N_REPLICAS} x {N_STEPS}":
            res["vacuum"]["campaign_kernel_launches"],
        f"host_io: cli simulate prmtop GBIS_CONFIG {N_REPLICAS} x {N_STEPS}":
            res["gbis"]["campaign_kernel_launches"],
        f"host_io: simulate_ensemble with cmap, no kernel flag {N_REPLICAS} x {CMAP_STEPS}":
            res["cmap"]["simulate_no_flag"]["launches"],
    }
    return res, launches


# -- several devices: sharded campaigns and data-parallel training --------------


#: the parallel phase's data-parallel run: pretrain, 1 epoch of the in-repo
#: data at this stride (16 updates of batch 32, one logged row)
DP_STRIDE = 10
TOL_DP = 1e-5            # relative, float32: data-parallel against one process
DP_RATE_UPDATES = 10     # timed pretrain updates of batch 32, after the checked one
TOL_SHARDED_A = 1e-6     # A: the sharded campaign against the unsharded one at 0 K


def sharded_campaign(ff, ens, cfg, bias, cons, mesh, tag):
    """``simulate_ensemble(mesh=)`` on a 1024 x 2000 campaign over ``mesh``
    (two shards on one card): at 0 K against the unsharded call; at 300 K
    from the identical replicas of ``ens``, the campaign gates, the two
    shards' streams apart, and the rate beside the unsharded call's at 300 K
    in this phase. Returns the result and every kernel's launches by run."""
    n_saves = N_STEPS // N_INNER
    launches, runs = {}, {}
    cold = dataclasses.replace(cfg, temperature=0.0)
    for label, kw, conf in (("unsharded_0K", {}, cold), ("sharded_0K", {"mesh": mesh}, cold),
                            ("sharded_300K", {"mesh": mesh}, cfg), ("unsharded_300K", {}, cfg)):
        reset_launches()
        t0 = time.perf_counter()
        runs[label] = simulate_ensemble(ens, ff, n_steps=N_STEPS, save_every=N_INNER,
                                        config=conf, bias=bias, **kw)
        torch.cuda.synchronize()
        runs[label] += (time.perf_counter() - t0,)
        launches[label] = read_launches()
        want = n_saves * (mesh.size if kw else 1)
        check(launches[label]["campaign_advance"] == want,
              f"{tag} {label}: kernels launched {launches[label]}, expected {want} campaign "
              "launches")
    final, frames, log, seconds = runs["sharded_300K"]
    err_0k = max_err(runs["sharded_0K"][1], runs["unsharded_0K"][1])
    check(err_0k <= TOL_SHARDED_A, f"{tag}: sharded vs unsharded at 0 K, {err_0k} A")
    check(tuple(frames.shape) == (n_saves, N_REPLICAS, ff.n_atoms, 3),
          f"{tag}: frames {tuple(frames.shape)}")
    check(bool(torch.isfinite(frames).all()), f"{tag}: non-finite frames")
    last = frames[-1]
    bond = torch.linalg.norm(last[:, cons.pairs[:, 0]] - last[:, cons.pairs[:, 1]], dim=-1)
    violation = float((bond - cons.lengths[None]).abs().max())
    check(violation < 1e-5, f"{tag}: max X-H constraint violation {violation} A")
    t_mean = float(log["T"][-1].mean())
    check(150.0 < t_mean < 350.0, f"{tag}: ensemble-mean T of the last save {t_mean} K")
    lag = float((log["colvar_value"][-1] - log["colvar_center"][-1]).abs().mean())
    check(lag < 2.0, f"{tag}: mean |colvar - centre| {lag} A")
    half = N_REPLICAS // mesh.size
    apart = float((last[:half] - last[half:2 * half]).abs().amax(dim=(1, 2)).min())
    check(apart > 1e-3, f"{tag}: replica j and {half} + j coincide ({apart} A): "
                        "the shards replayed one noise stream")
    check(int(final.step[0]) == N_STEPS and str(frames.device) == str(mesh.devices[0]),
          f"{tag}: final step {int(final.step[0])}, frames on {frames.device}")
    rate = N_STEPS * N_REPLICAS / seconds
    rate_1 = N_STEPS * N_REPLICAS / runs["unsharded_300K"][3]
    return {"shards": mesh.size, "sharded_vs_unsharded_0K_A": err_0k,
            "max_constraint_violation_A": violation, "T_last_mean_K": t_mean,
            "colvar_lag_A": lag, "min_shard_pair_apart_A": apart,
            "sharded_call_seconds": seconds, "aggregate_steps_per_s": rate,
            "unsharded_call_seconds": runs["unsharded_300K"][3],
            "unsharded_aggregate_steps_per_s": rate_1,
            "campaign_kernel_launches": launches}, launches


def dp_inputs():
    """What every process of the data-parallel checks starts from, made the
    same in each: the in-repo 40-atom data, one batch of 32 (frames, times,
    latents) and a seeded generator at published widths whose output layer
    is anchored at a data frame (so that the informed loss sits at its
    physical scale; a random generator's structures collapse)."""
    from molecular_dynamics_tpu_torch.train.datasets import TrajectoryData, frame_time_batches

    traj = TrajectoryData.from_npy_glob(str(TRAIN_DATA / "raw-traj_rep-*.npy"))
    frames, times = next(frame_time_batches(traj, TRAIN_BATCH, np.random.default_rng(0)))
    z = np.random.default_rng(1).standard_normal((TRAIN_BATCH, 31))
    gen = Generator(40, generator=torch.Generator().manual_seed(0), device="cpu")
    weights = gen.state_dict()
    last = len(gen.layers) - 1
    weights[f"layers.{last}.weight"] = 0.01 * weights[f"layers.{last}.weight"]
    weights[f"layers.{last}.bias"] = torch.as_tensor(
        traj.trajectories[0][0].reshape(-1), dtype=torch.float32)
    return traj, (z, frames, times), weights


def dp_updates(dp, dev):
    """One pretrain update (alpha 0.01) and one informed update from
    ``dp_inputs``, float32 on ``dev``: each update's loss (the global
    batch's), the gradient it stepped along (all-reduced under ``dp``, one
    process's without) and the generator after it; then the pretrain
    update's rate, DP_RATE_UPDATES more of them timed (global batches a
    second)."""
    traj, batch, weights = dp_inputs()
    rows = (lambda a: a) if dp is None else dp.rows
    z, frames, times = (torch.as_tensor(rows(a), device=dev, dtype=torch.float32) for a in batch)
    out = {}
    for name in ("pretrain", "informed"):
        ff, gen, disc, bias = train_systems(traj, 40, weights, dev, torch.float32)
        g_fwd, d_fwd = (gen, disc) if dp is None else (dp.wrap(gen), dp.wrap(disc))
        trainer = tcgan.CGANTrainer(g_fwd, d_fwd, ff, bias=bias)
        pretrain = tcgan.PretrainStep(g_fwd, ff, lr=1e-3)
        loss_fn = ((lambda: pretrain.loss(z, frames, times, 0.01)[0]) if name == "pretrain"
                   else (lambda: trainer.informed_loss(z, times)))
        loss = loss_fn()
        if dp is None:
            grads = torch.autograd.grad(loss, list(gen.parameters()))
        else:
            loss.backward()
            grads = [p.grad.clone() for p in gen.parameters()]
            for p in gen.parameters():
                p.grad = None
        step_loss = (pretrain(z, frames, times, 0.01)[0] if name == "pretrain"
                     else trainer.informed_step(z, times))
        if dp is not None:
            loss, step_loss = dp.mean(loss), dp.mean(step_loss)
        out[name] = {"loss": float(loss.detach()), "step_loss": float(step_loss),
                     "grad": torch.cat([g.reshape(-1).double().cpu() for g in grads]).numpy(),
                     "after": flat_params(gen).numpy()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(DP_RATE_UPDATES):
        pretrain(z, frames, times, 0.01)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out["pretrain"]["updates_per_s"] = DP_RATE_UPDATES / (time.perf_counter() - t0)
    return out


def dp_rank(dp, root, t_spawn, parent=None):
    """One rank of the parallel phase: ``dp_updates``, then
    ``run_training``'s rank body on a short pretrain run into ``root``;
    rank 0 writes its updates to ``root/updates.npz``, with the seconds
    from the spawn (``t_spawn``, ``time.time()``) to its start and those of
    its work. Ranks started ahead (``parent``: the script's pid) warm up,
    then wait for ``root/go``, and leave if the script has ended."""
    from molecular_dynamics_tpu_torch.train import drivers

    entered = time.time()
    if parent is not None:
        # what a fresh process pays at its first update: the context and
        # cuBLAS, the optimizer's and DDP's imports
        warm = torch.ones((64, 64), device=dp.device)
        float((warm @ warm).sum())
        ClippedAdam([torch.nn.Parameter(warm)], lr=1e-3)
        importlib.import_module("torch.nn.parallel.distributed")
        while not (root / "go").exists():
            if os.getppid() != parent:
                sys.exit(1)
            time.sleep(0.05)
    started = time.time()
    out = dp_updates(dp, dp.device)
    drivers._train_rank(dp, dict(
        family="pretrain", data=str(TRAIN_DATA / "raw-traj_rep-*.npy"), data_stride=DP_STRIDE,
        topology="example:backbone", parameters="", epochs=1, batch_size=TRAIN_BATCH,
        out_dir=str(root / "runs"), seed=0))
    if dp.writer:
        np.savez(root / "updates.npz", start_seconds=entered - t_spawn,
                 ready_seconds=started - t_spawn, work_seconds=time.time() - started,
                 **{f"{k}:{f}": v for k, row in out.items() for f, v in row.items()})


def start_dp_ranks(dev):
    """The parallel phase's two gloo ranks on ``dev``, started now (their
    process start and first-use costs run beside the earlier phases); they
    wait for ``dp_phase``. Returns (context, temporary directory, their
    root, the time they were started)."""
    import torch.multiprocessing as mp

    from molecular_dynamics_tpu_torch.parallel import data as pdata
    from molecular_dynamics_tpu_torch.parallel.mesh import indexed

    tmp = tempfile.TemporaryDirectory()
    root = pathlib.Path(tmp.name) / "world2"
    root.mkdir()
    t_spawn = time.time()
    # the ranks' bodies as ``pdata.spawn`` runs them, left running: daemons
    # that end with this process
    ctx = mp.start_processes(
        pdata.rank_main, nprocs=2, join=False, daemon=True, start_method="spawn",
        args=(dp_rank, [indexed(dev)] * 2, "gloo", pdata.free_port(),
              (root, t_spawn, os.getpid())))
    return ctx, tmp, root, t_spawn


def dp_phase(dev, ranks):
    """The data-parallel path at world size 1 (NCCL, in this process) and 2
    (``ranks``, from ``start_dp_ranks``: both on ``dev``, gloo) against
    one process: each update's loss, gradient and the generator after it,
    and the short pretrain run's files and logged losses."""
    from molecular_dynamics_tpu_torch.parallel import data as pdata
    from molecular_dynamics_tpu_torch.parallel.mesh import indexed
    from molecular_dynamics_tpu_torch.train import drivers

    dev = indexed(dev)
    one = dp_updates(None, dev)
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        argv = dict(family="pretrain", data=str(TRAIN_DATA / "raw-traj_rep-*.npy"),
                    data_stride=DP_STRIDE, epochs=1, batch_size=TRAIN_BATCH,
                    out_dir=str(tmp / "one"), seed=0)
        t0 = time.perf_counter()
        check(drivers.run_training(**argv) == 0, "one-process pretrain run")
        one_s = time.perf_counter() - t0
        with open(tmp / "one" / "pretrain" / "train_log.csv") as fh:
            one_log = [float(r["loss"]) for r in csv.DictReader(fh)]
        one_files = sorted(p.name for p in (tmp / "one" / "pretrain").iterdir())
        ctx, _, root2, _ = ranks
        for world, devices, backend in ((1, [dev], "nccl"), (2, [dev, dev], "gloo")):
            t0 = time.perf_counter()
            if world == 1:
                root = tmp / "world1"
                root.mkdir()
                pdata.spawn(dp_rank, 1, devices=devices, backend=backend,
                            args=(root, time.time()))
            else:
                root = root2
                (root / "go").touch()
                while not ctx.join():
                    pass
            spawn_s = time.perf_counter() - t0
            got = dict(np.load(root / "updates.npz"))
            row = {"backend": backend, "devices": [str(d) for d in devices],
                   "processes": "this one" if world == 1 else
                   f"{world} spawned at the script's start, waiting for this phase",
                   "seconds_in_phase": spawn_s,
                   "rank0_start_seconds": float(got["start_seconds"]),
                   "rank0_ready_seconds": float(got["ready_seconds"]),
                   "rank0_work_seconds": float(got["work_seconds"])}
            for name, want in one.items():
                g, p = got[f"{name}:grad"], got[f"{name}:after"]
                r = {"loss_rel_err": abs(float(got[f"{name}:loss"]) - want["loss"])
                     / abs(want["loss"]),
                     "grad_rel_err": float(np.linalg.norm(g - want["grad"])
                                           / np.linalg.norm(want["grad"])),
                     "param_rel_err": float(np.linalg.norm(p - want["after"])
                                            / np.linalg.norm(want["after"]))}
                for key, value in r.items():
                    check(value <= TOL_DP, f"data-parallel {name} update, world {world} "
                                           f"({backend}) against one process: {r}")
                row[name] = r
            row["pretrain"]["updates_per_s"] = float(got["pretrain:updates_per_s"])
            row["pretrain"]["one_process_updates_per_s"] = one["pretrain"]["updates_per_s"]
            run = root / "runs" / "pretrain"
            files = sorted(p.name for p in run.iterdir())
            with open(run / "train_log.csv") as fh:
                log = [float(r["loss"]) for r in csv.DictReader(fh)]
            with open(run / "eval.json") as fh:
                metrics = json.load(fh)
            check(files == one_files and len(log) == len(one_log) and one_log,
                  f"data-parallel pretrain, world {world}: files {files}, {len(log)} logged rows "
                  f"against one process's {one_files}, {len(one_log)}")
            check(all(np.isfinite(v) for v in metrics.values()),
                  f"data-parallel pretrain, world {world}: eval.json {metrics}")
            row["run"] = {"files": files, "logged_rows": len(log),
                          "logged_loss_rel_err": max(abs(a - b) / abs(b)
                                                     for a, b in zip(log, one_log)),
                          "mean_abs_error": metrics["mean_abs_error"]}
            res[f"world_{world}"] = row
    res["one_process_run_seconds"] = one_s
    res["tolerance"] = TOL_DP
    return res


def parallel_phase(ff, vacuum, gbis, dev, ranks):
    """Several devices on one card: ``simulate_ensemble(mesh=)`` through two
    shards on ``dev`` in vacuum and under GBIS (``sharded_campaign``), the
    data-parallel path (``dp_phase``, with the two ranks ``ranks`` started
    ahead), and ``cli simulate | train --devices 2`` raising on a one-card
    machine. Returns the result and the launches by path."""
    from molecular_dynamics_tpu_torch.parallel import Mesh

    mesh = Mesh((dev, dev))
    res, by_path = {}, {}
    for tag, (ens, cfg, bias) in (("vacuum", vacuum), ("gbis", gbis)):
        res[tag], launches = sharded_campaign(ff, ens, cfg, bias, hydrogen_bond_constraints(ff),
                                              mesh, f"parallel {tag}")
        for label, count in launches.items():
            by_path[f"parallel: simulate_ensemble({tag}, {label}, "
                    f"{'2 shards on ' + str(dev) if label.startswith('sharded') else 'no mesh'}) "
                    f"{N_REPLICAS} x {N_STEPS}"] = count
    res["data_parallel"] = dp_phase(dev, ranks)
    visible = torch.cuda.device_count()
    raised = {}
    for argv in (["simulate", "--devices", str(visible + 1)],
                 ["train", "pretrain", "--devices", str(visible + 1), "--data",
                  str(TRAIN_DATA / "raw-traj_rep-*.npy")]):
        try:
            cli.main(argv)
            raised[argv[0]] = None
        except ValueError as err:
            raised[argv[0]] = str(err)
        check(raised[argv[0]] is not None
              and f"only {visible} CUDA devices are visible" in raised[argv[0]],
              f"cli {' '.join(argv)} on {visible} card(s): {raised[argv[0]]}")
    res["cli_raises"] = raised
    return res, by_path


def bench_phase():
    """``bench_torch.py``'s three protocols in this process: its record,
    and the campaign kernel's launches over them (a warm-up and three timed
    calls of 40 launches each, three protocols)."""
    import bench_torch

    reset_launches()
    t0 = time.perf_counter()
    record = bench_torch.run("cuda")
    seconds = time.perf_counter() - t0
    launches = fused_step.campaign_advance.launches
    expected = 3 * (1 + bench_torch.TIMED_CALLS) * (N_STEPS // bench_torch.SAVE_EVERY)
    check(launches == expected, f"bench: campaign kernel launched {launches} times, "
                                f"expected {expected}")
    check({"metric", "value", "unit", "secondary"} <= set(record)
          and {"gbis_steps_per_sec", "gbis_sasa_steps_per_sec"} <= set(record["secondary"]),
          f"bench record {record}")
    return record, launches, seconds


# -- the training path and its data ---------------------------------------------


def train_run(argv):
    """One ``cli train <family> ...`` run: its wall seconds, ``eval.json``,
    the logged losses (all finite) and the files it wrote, and the run's
    directory."""
    family = argv[0]
    tag = f"cli train {' '.join(argv)}"
    wall, _ = run_cli(["train", *argv])
    out = pathlib.Path(argv[argv.index("--out-dir") + 1]) / family
    generated = GENERATED[family]
    for name in ("eval.json", "train_log.csv", "best.ckpt", f"{generated}.xyz", f"{generated}.pdb"):
        check((out / name).exists(), f"{tag}: {name} not written")
    with open(out / "eval.json") as fh:
        metrics = json.load(fh)
    check(all(np.isfinite(v) for v in metrics.values()), f"{tag}: eval.json {metrics}")
    with open(out / "train_log.csv") as fh:
        losses = np.array([float(r["loss"]) for r in csv.DictReader(fh)])
    check(len(losses) > 0 and np.isfinite(losses).all(), f"{tag}: non-finite logged losses")
    coords = read_xyz(str(out / f"{generated}.xyz"))
    check(np.isfinite(coords).all(), f"{tag}: non-finite generated structures")
    return {"wall_seconds": wall, "eval": metrics, "logged_losses": len(losses),
            "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
            "generated": list(coords.shape)}, out


def train_jobs(tmp):
    """Every ``cli train`` run of the train, dynamics, sequence and
    generative phases, and the regenerate phase's 104-atom cgan on its
    frames (in ``tmp``): (phase, family) -> (argv, environment, epochs, the
    ceiling its ``mean_abs_error`` is held to)."""
    pattern = str(TRAIN_DATA / "raw-traj_rep-*.npy")
    budgets = {
        **{("train", f): TRAIN_BUDGET[f] for f in ("pretrain", "cgan")},
        ("dynamics", "node"): TRAIN_BUDGET["node"],
        **{("dynamics", f): (HNN_SANITY_EPOCHS, DYNAMICS_SANITY_A) for f in ("hnn", "hnn-latent")},
        ("dynamics", "hnn-schnet"): (SCHNET_EPOCHS, DYNAMICS_SANITY_A),
        **{("sequence", f): TRAIN_BUDGET.get(f, (SEQUENCE_SANITY_EPOCHS, DYNAMICS_SANITY_A))
           for f in SEQUENCE_FAMILIES},
        **{("generative", f): (DYNAMICS_EPOCHS, DYNAMICS_SANITY_A) for f in GENERATIVE_FAMILIES},
    }
    out = {"train": tmp / "runs40", "dynamics": tmp / "dynamics", "sequence": tmp / "sequence",
           "generative": tmp / "generative"}
    jobs = {(phase, family): (
        [family, "--data", pattern, "--epochs", str(epochs), "--batch-size", str(TRAIN_BATCH),
         "--seed", "0", "--out-dir", str(out[phase])],
        SEQUENCE_SANITY_FT.get(family, {}) if phase == "sequence" else {}, epochs, ceiling)
        for (phase, family), (epochs, ceiling) in budgets.items()}
    # the 104-atom pipeline of docs/TRAINING.md on the regenerate phase's
    # frames, cut in depth (no ceiling: a run's own gates)
    jobs["regenerate", "cgan"] = (
        ["cgan", "--topology", "example:full", "--data", str(tmp / "smd" / "raw-traj_rep-*.npy"),
         "--stride", "10", "--epochs", "1", "--batch-size", str(TRAIN_BATCH), "--seed", "0",
         "--out-dir", str(tmp / "runs104")], {}, 1, None)
    return jobs


def train_job(argv, env):
    """``train_run(argv)`` under the environment variables ``env``, in a
    worker process: its result and the kernels' launches it made."""
    reset_launches()
    with environ(env):
        run, _ = train_run(argv)
    return run, read_launches()


def train_runs_phase(tmp):
    """Every run of ``train_jobs``, TRAIN_WORKERS at a time (spawned
    processes on this card, ended before it returns): (phase, family) ->
    (result, epochs, ceiling, launches), and the wall seconds of all. A
    failed check in a worker fails the script here."""
    import concurrent.futures
    import multiprocessing

    jobs = train_jobs(tmp)
    rank = {f: i for i, f in enumerate(TRAIN_LONGEST_FIRST)}
    order = sorted(jobs, key=lambda key: rank.get(key[1], len(rank)))
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            TRAIN_WORKERS, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {key: pool.submit(train_job, *jobs[key][:2]) for key in order}
        done = {key: f.result() for key, f in futures.items()}
    wall = time.perf_counter() - t0
    return {key: (run, jobs[key][2], jobs[key][3], launches)
            for key, (run, launches) in done.items()}, wall


def regenerate_phase(tmp):
    """The SMD data-generation twin under GBIS (64 replicas x 20,000 steps,
    every replica's frames written into ``tmp / "smd"``), through the
    campaign kernel; the 104-atom cGAN on its frames is one of
    ``train_jobs``."""
    out = tmp / "smd"
    n_saves = REGEN_STEPS // N_INNER
    argv = ["--gbis", "--replicas", str(REGEN_REPLICAS), "--steps", str(REGEN_STEPS),
            "--max-dump", str(REGEN_REPLICAS), "--pull", str(REGEN_PULL), "--out", str(out)]
    reset_launches()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = regenerate_smd.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    tag = f"regenerate_smd {' '.join(argv[:-2])}"
    check(rc == 0, f"{tag}: exit code {rc}")
    check(launches["campaign_advance"] == n_saves,
          f"{tag}: campaign kernel launched {launches['campaign_advance']} times, expected {n_saves}")
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    with open(out / "summary.json") as fh:
        check(json.load(fh) == summary, f"{tag}: summary.json differs from the printed line")
    check(summary["frames_shape"] == [n_saves, REGEN_REPLICAS, 104, 3], f"{tag}: {summary}")
    check(summary["all_finite"], f"{tag}: non-finite frames")
    check(150.0 < summary["temperature_mean_K"] < 350.0,
          f"{tag}: mean T over the second half {summary['temperature_mean_K']} K")
    check(abs(summary["colvar_mean_lag_A"]) < 2.0,
          f"{tag}: mean colvar lag over the second half {summary['colvar_mean_lag_A']} A")
    files = sorted(out.glob("raw-traj_rep-*.npy"))
    check(len(files) == REGEN_REPLICAS, f"{tag}: {len(files)} replica files")
    dcd, _ = read_dcd(str(out / "rep0.dcd"))
    check(np.array_equal(dcd, np.load(out / "raw-traj_rep-0.npy")),
          f"{tag}: rep0.dcd differs from replica 0's frames")
    with np.load(out / "full_log.npz") as full:
        check(full["T"].shape == (n_saves, REGEN_REPLICAS), f"{tag}: full_log T {full['T'].shape}")
    check((out / "sim_log.csv").exists(), f"{tag}: sim_log.csv not written")

    return {"argv": argv, "wall_seconds": wall, "summary": summary, "launches": launches}, launches


def train_systems(traj, n_atoms, weights, device, dtype):
    """(force field, generator with ``weights``, discriminator, the
    training driver's data-anchored bias) of the 40-atom backbone or the 104-atom
    system, on ``device`` in ``dtype``."""
    from molecular_dynamics_tpu_torch.train.drivers import _data_bias

    topology = "example:backbone" if n_atoms == 40 else "example:full"
    ff = cli._load_system(topology, "", dtype=dtype, device=device)[0]
    gen = Generator(n_atoms, dtype=dtype, device=device)
    gen.load_state_dict({k: v.to(device=device, dtype=dtype) for k, v in weights.items()})
    disc = Discriminator(n_atoms * 3, dtype=dtype, device=device,
                         generator=torch.Generator(device=device).manual_seed(1))
    return ff, gen, disc, _data_bias(traj, n_atoms, device, dtype)


def flat_params(module):
    return torch.cat([p.detach().reshape(-1).double().cpu() for p in module.parameters()])


def step_vs_float64(traj, weights, batch, dev):
    """One informed and one pretrain step (alpha 0.01) of the 40-atom
    backbone: the card's float32 steps against the port's float64 steps on
    the CPU, from the same weights, latents and batch. Loss, gradient norm
    and direction before the updates, and the generator's parameters after
    both, relative; then the clipped Adam alone (``adam_vs_float64``) on the
    card's own two gradients."""
    z, frames, times = batch
    res = {}
    sides = {}
    for side, device, dtype in (("card", dev, torch.float32),
                                ("cpu_f64", torch.device("cpu"), torch.float64)):
        ff, gen, disc, bias = train_systems(traj, 40, weights, device, dtype)
        trainer = tcgan.CGANTrainer(gen, disc, ff, bias=bias)
        pretrain = tcgan.PretrainStep(gen, ff, lr=1e-3)
        zt, ft, tt = (torch.as_tensor(a, device=device, dtype=dtype) for a in (z, frames, times))
        out = {"start": flat_params(gen)}
        for name, loss_fn in (("informed", lambda: trainer.informed_loss(zt, tt)),
                              ("pretrain", lambda: pretrain.loss(zt, ft, tt, 0.01)[0])):
            loss = loss_fn()
            out[name] = (float(loss.detach()), torch.autograd.grad(loss, list(gen.parameters())))
        # the updates themselves: the informed step's loss is the one above
        out["informed_step_loss"] = float(trainer.informed_step(zt, tt))
        pretrain(zt, ft, tt, 0.01)
        out["after"] = flat_params(gen)
        sides[side] = out
    for name in ("informed", "pretrain"):
        (l32, g32), (l64, g64) = sides["card"][name], sides["cpu_f64"][name]
        g32, g64 = (torch.cat([g.reshape(-1).double().cpu() for g in grads]) for grads in (g32, g64))
        n32, n64 = float(g32.norm()), float(g64.norm())
        row = {"loss_card": l32, "loss_cpu_f64": l64, "loss_rel_err": abs(l32 - l64) / abs(l64),
               "grad_norm_card": n32, "grad_norm_cpu_f64": n64,
               "grad_norm_rel_err": abs(n32 - n64) / n64,
               "grad_direction_err": float((g32 / n32 - g64 / n64).norm())}
        for key in ("loss_rel_err", "grad_norm_rel_err", "grad_direction_err"):
            check(row[key] <= TOL_TRAIN_STEP, f"{name} step, card vs float64: {row}")
        res[name] = row
    res["informed"]["step_loss_card"] = sides["card"]["informed_step_loss"]
    check(abs(sides["card"]["informed_step_loss"] - sides["card"]["informed"][0])
          <= TOL_TRAIN_STEP * abs(sides["card"]["informed"][0]), f"informed step loss {res}")
    # the generator after the informed and the pretrain update: the
    # parameters against float64's, and the change the two updates made
    # against float64's change
    start = sides["cpu_f64"]["start"]
    p32, p64 = sides["card"]["after"], sides["cpu_f64"]["after"]
    moved = p64 - start
    res["params_after"] = {
        "param_rel_err": float((p32 - p64).norm() / p64.norm()),
        "update_rel_err": float((p32 - start - moved).norm() / moved.norm()),
        "update_norm_cpu_f64": float(moved.norm()), "param_norm_cpu_f64": float(p64.norm())}
    for key in ("param_rel_err", "update_rel_err"):
        check(res["params_after"][key] <= TOL_TRAIN_STEP,
              f"generator after an informed and a pretrain step, card vs float64: {res['params_after']}")
    res["adam_vs_float64"] = adam_vs_float64(
        weights, [sides["card"][name][1] for name in ("informed", "pretrain")], dev)
    res["tolerance"] = TOL_TRAIN_STEP
    return res


def adam_vs_float64(weights, grad_steps, dev):
    """The clipped Adam the card applies (torch's multi-tensor Adam on CUDA)
    against float64's on the CPU (its per-parameter loop), both fed the same
    gradients, one update per list in ``grad_steps`` (the clip fires on
    each whose norm in ``grad_norms`` exceeds 1): the change in the
    generator's parameters, relative."""
    moved = {}
    for side, device, dtype in (("card", dev, torch.float32),
                                ("cpu_f64", torch.device("cpu"), torch.float64)):
        gen = Generator(40, dtype=dtype, device=device)
        gen.load_state_dict({k: v.to(device=device, dtype=dtype) for k, v in weights.items()})
        start = flat_params(gen)
        opt = ClippedAdam(gen.parameters(), lr=1e-3, clip_norm=1.0)
        for grads in grad_steps:
            opt.step([g.to(device=device, dtype=dtype) for g in grads])
        moved[side] = flat_params(gen) - start
    err = float((moved["card"] - moved["cpu_f64"]).norm() / moved["cpu_f64"].norm())
    norms = [float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))) for grads in grad_steps]
    res = {"update_rel_err": err, "grad_norms": norms, "lr": 1e-3, "clip_norm": 1.0,
           "update_norm_cpu_f64": float(moved["cpu_f64"].norm())}
    check(err <= TOL_TRAIN_STEP, f"clipped Adam, card vs float64: {res}")
    return res


def census_descend(opt, loss):
    """``train.common.descend`` in two census ranges: the backward pass and
    the optimizer."""
    from torch.profiler import record_function

    with record_function("census:backward"):
        grads = torch.autograd.grad(loss, opt.params, materialize_grads=True)
    with record_function("census:optimizer"):
        opt.step(grads)


def census_summary(res, sources, **fields):
    """A ``census_by_source`` result as a record: ``fields``, launches and
    host ms a step by source, the rest of the step outside every source,
    and the step's launches, device kernels, wall and device ms and busy
    share."""
    count, host = res["launches"], res["host_ms"]
    return {
        **fields,
        "by_source": {k: {"launches_per_step": count[k], "host_ms_per_step": host[k]}
                      for k in sources},
        "rest_of_step": {"launches_per_step": count["step"],
                         "host_ms_per_step": host["step"] - sum(host[k] for k in sources)},
        **{k: res[k] for k in ("launches_per_step", "device_kernels_per_step",
                                "wall_ms_per_step", "device_ms_per_step", "device_busy_share")},
    }


def informed_census(trainer, z, t, steps=5):
    """Kernel launches and host ms of one informed step, by source: the
    generator's forward, the batched energy and bias (forward), the
    backward pass, the optimizer (clip + Adam); outside them the rest of the
    step (the loss arithmetic)."""
    trainer.generate = labelled("generator", trainer.generate)
    try:
        with patched(((tcgan, "potential_loss", labelled("energy", tcgan.potential_loss)),
                      (tcgan, "bias_energy_loss", labelled("energy", tcgan.bias_energy_loss)),
                      (tcgan, "descend", census_descend))):
            res = census_by_source(lambda: trainer.informed_step(z, t),
                                   ("generator", "energy", "backward", "optimizer"), steps)
    finally:
        del trainer.generate
    return census_summary(res, ("generator", "energy", "backward", "optimizer"),
                          atoms=trainer.generator.n_atoms, batch=int(z.shape[0]), steps=steps)


def update_rates(trainer, pretrain, z, frames, t, repeats=30):
    """Updates and samples a second of each phase (after a warm-up), the
    host clock around ``repeats`` updates ending in a synchronisation."""
    rates = {}
    for name, fn in (("pretrain", lambda: pretrain(z, frames, t, 0.01)),
                     ("g", lambda: trainer.g_step(z, t)),
                     ("d", lambda: trainer.d_step(z, frames, t)),
                     ("informed", lambda: trainer.informed_step(z, t))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
        per_s = repeats / (time.perf_counter() - t0)
        rates[name] = {"updates_per_s": per_s, "samples_per_s": per_s * int(z.shape[0]),
                       "ms_per_update": 1e3 / per_s}
    return rates


def flagship_forward(dev):
    """The flagship forward (the generator's structures and their
    per-sample potential energy, batch 8, the 40-atom backbone), timed."""
    top, _ = decaalanine_backbone()
    ff = build_ff_params(top, YamlForceField(BACKBONE_FF_PRM), device=dev)
    gen = Generator(top.n_atoms, latent_dim=31, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    z = torch.zeros((8, 31), device=dev)
    t = torch.linspace(0.0, 1.0, 8, device=dev)

    def forward():
        with torch.no_grad():
            coords = gen.coords(z, t)
            return coords, total_energy(coords, ff)

    coords, energies = forward()
    check(tuple(coords.shape) == (8, top.n_atoms, 3) and tuple(energies.shape) == (8,),
          f"flagship forward shapes {tuple(coords.shape)}, {tuple(energies.shape)}")
    # at z = 0 and t = 0 every layer's input is zero and so is its output
    # (zero biases): all atoms at the origin, whose energy is NaN, as in the
    # JAX package's forward on the same arguments
    check(bool(torch.isfinite(coords).all() & torch.isfinite(energies[1:]).all()),
          f"flagship forward: non-finite output {energies.tolist()}")
    return {"batch": 8, "atoms": top.n_atoms, "ms": time_ms(forward, repeats=50),
            "device_ms": device_ms(forward), "energies_t_above_0": energies[1:].tolist(),
            "energy_t0_finite": bool(torch.isfinite(energies[0]))}


def train_phase(tmp, dev, runs):
    """The training path on the card: the quality gates on the in-repo
    40-atom data (the ``cli train`` runs of ``runs``), the card's steps
    against float64, the informed step's census at 40 atoms and at 104 (the
    regenerate phase's frames and generator, in ``tmp``), the update rates
    and the flagship forward."""
    from molecular_dynamics_tpu_torch.train.datasets import TrajectoryData, frame_time_batches

    res, launches = {}, {}
    pattern = str(TRAIN_DATA / "raw-traj_rep-*.npy")
    for family in ("pretrain", "cgan"):
        run, epochs, ceiling, launches[family] = runs["train", family]
        e2e = run["eval"]["mean_abs_error"]
        check(e2e <= ceiling,
              f"train {family} --epochs {epochs}: mean_abs_error {e2e} A above the ceiling {ceiling}")
        res[family] = {**run, "epochs": epochs, "ceiling_A": ceiling, "launches": launches[family]}

    traj = TrajectoryData.from_npy_glob(pattern)
    frames, times = next(frame_time_batches(traj, TRAIN_BATCH, np.random.default_rng(0)))
    z = np.random.default_rng(1).standard_normal((TRAIN_BATCH, 31))
    # the pretrained generator of the run above: the weights an informed step meets
    pretrained = torch.load(tmp / "runs40" / "pretrain" / "best.ckpt", weights_only=True)
    res["step_vs_float64"] = step_vs_float64(traj, pretrained, (z, frames, times), dev)

    zt, ft, tt = (torch.as_tensor(a, device=dev, dtype=torch.float32) for a in (z, frames, times))
    ff, gen, disc, bias = train_systems(traj, 40, pretrained, dev, torch.float32)
    trainer = tcgan.CGANTrainer(gen, disc, ff, bias=bias)
    res["census_informed_40"] = informed_census(trainer, zt, tt)
    res["update_rates_40"] = update_rates(trainer, tcgan.PretrainStep(gen, ff, lr=1e-3),
                                          zt, ft, tt)
    traj104 = TrajectoryData.from_npy_glob(str(tmp / "smd" / "raw-traj_rep-*.npy"), stride=10)
    weights104 = torch.load(tmp / "runs104" / "cgan" / "best.ckpt", weights_only=True)
    ff104, gen104, disc104, bias104 = train_systems(traj104, 104, weights104, dev, torch.float32)
    trainer104 = tcgan.CGANTrainer(gen104, disc104, ff104, bias=bias104)
    res["census_informed_104"] = informed_census(trainer104, zt, tt)
    res["flagship_forward"] = flagship_forward(dev)
    return res, launches


# -- the training steps on the card against float64 -----------------------------


@contextlib.contextmanager
def graphs_of(record):
    """The kNN adjacencies of the graph models: with ``record`` empty,
    computed as usual and appended to it; else taken from it in order (on
    the caller's device). A flipped kNN edge, where two distances tie within
    float32's rounding, is a discrete branch, not arithmetic error: the
    float64 side records its graphs and the float32 sides replay them."""
    from molecular_dynamics_tpu_torch.models import gat as mgat

    replay, calls = list(record), iter(range(len(record)))

    def graph(pos, k):
        if replay:
            return replay[next(calls)].to(pos.device)
        adj = compute(pos, k)
        record.append(adj.cpu())
        return adj

    compute = mgat.graph
    with patched(((mgat, "graph", graph),)):
        yield


def step_errors(ref, other):
    """``other``'s step against ``ref``'s (each ``(loss, grads, start,
    params after one update)``): loss, gradient norm and direction, the
    update and the parameters after it, relative."""
    (l64, g64, start, p64), (l, g, _, p) = ref, other
    n, n64 = float(g.norm()), float(g64.norm())
    moved = p64 - start
    return {"loss_rel_err": abs(l - l64) / abs(l64), "grad_norm_rel_err": abs(n - n64) / n64,
            "grad_direction_err": float((g / n - g64 / n64).norm()),
            "update_rel_err": float((p - start - moved).norm() / moved.norm()),
            "param_rel_err": float((p - p64).norm() / p64.norm())}


def steps_vs_float64(sides_steps, tol_grad, tol_update, floor=FLOAT32_FLOOR):
    """Each step kind on the card (float32) against the same step in float64
    on the CPU, from the same weights, batch, draws and kNN graphs: the
    loss, the gradient's norm and direction (within ``tol_grad``), and the
    parameters after one update of a fresh clipped Adam (their change
    against float64's change, within ``tol_update``), relative. The same
    step in float32 on the CPU gives float32's own error on it: where that
    exceeds the tolerance (a loss whose gradient float32 cannot resolve, an
    Adam update of a parameter whose gradient is zero in exact arithmetic),
    the card is held within ``floor`` times it instead. ``sides_steps`` maps
    ``cpu_f64``, ``card`` and, where the floor applies, ``cpu_f32`` to their
    step lists."""
    sides, graphs = {}, {}
    for side in (s for s in ("cpu_f64", "cpu_f32", "card") if s in sides_steps):
        out = {}
        for name, module, loss_fn, rows in sides_steps[side]:
            trained = {k: v.clone() for k, v in module.state_dict().items()}
            start = flat_params(module)
            with graphs_of(graphs.setdefault(name, [])):
                loss = loss_fn()
            grads = torch.autograd.grad(loss, list(module.parameters()), materialize_grads=True)
            ClippedAdam(module.parameters(), lr=1e-3, clip_norm=1.0).step(grads)
            out[name] = (float(loss.detach()),
                         torch.cat([g.reshape(-1).double().cpu() for g in grads]),
                         start, flat_params(module), rows)
            module.load_state_dict(trained)  # the next step kind starts from the same weights
        sides[side] = out
    res = {}
    for name, ref in sides["cpu_f64"].items():
        card = step_errors(ref[:4], sides["card"][name][:4])
        cpu32 = step_errors(ref[:4], sides["cpu_f32"][name][:4]) if "cpu_f32" in sides else {}
        row = {"rows": ref[4], "loss_card": sides["card"][name][0], "loss_cpu_f64": ref[0],
               "grad_norm_cpu_f64": float(ref[1].norm()), **card,
               **{f"{k}_cpu_f32": v for k, v in cpu32.items()}, "graphs_replayed": len(graphs[name])}
        for key, tol in (("loss_rel_err", tol_grad), ("grad_norm_rel_err", tol_grad),
                         ("grad_direction_err", tol_grad), ("update_rel_err", tol_update),
                         ("param_rel_err", tol_update)):
            bound = max(tol, floor * cpu32[key]) if cpu32 else tol
            check(card[key] <= bound, f"{name}, card vs float64: {row}")
        res[name] = row
    return res


def update_rates_of(steps, repeats=10):
    """Updates a second of each step kind on the card (loss, gradient,
    clipped Adam), after a warm-up, the host clock around ``repeats``
    updates ending in a synchronisation."""
    from molecular_dynamics_tpu_torch.train.common import descend

    rates = {}
    for name, module, loss_fn, rows in steps:
        opt = ClippedAdam(module.parameters(), lr=1e-3, clip_norm=1.0)
        descend(opt, loss_fn())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(repeats):
            descend(opt, loss_fn())
        torch.cuda.synchronize()
        per_s = repeats / (time.perf_counter() - t0)
        rates[name] = {"updates_per_s": per_s, "samples_per_s": per_s * rows,
                       "ms_per_update": 1e3 / per_s, "rows": rows}
    return rates


# -- the Hamiltonian dynamics line ------------------------------------------------


def dynamics_data(pattern, dev):
    """The in-repo 40-atom data as the dynamics drivers see it: phase-space
    rows (x, dx) and whitened frame pairs, a batch of row indices (the first
    of a seeded permutation, TRAIN_BATCH rows whose 10-frame windows stay
    inside their trajectory) and the node driver's clamps."""
    from molecular_dynamics_tpu_torch.train.datasets import TrajectoryData, phase_space_pairs
    from molecular_dynamics_tpu_torch.train.drivers import _segments, _whitened

    traj = TrajectoryData.from_npy_glob(pattern)
    x, dx = phase_space_pairs(traj)
    _, windows = _segments(traj, 10)
    sel = np.random.default_rng(0).permutation(windows)[:TRAIN_BATCH]
    white, _, _ = _whitened(traj)
    flats = [w.reshape(len(w), -1) for w in white.trajectories]
    x0 = np.concatenate([f[:-1] for f in flats])
    x1 = np.concatenate([f[1:] for f in flats])
    return {
        "x": x[sel], "dx": dx[sel], "dx_seq": np.stack([dx[j: j + 10] for j in sel]),
        "x_seq": np.stack([x[j + 1: j + 11] for j in sel]),
        "lo": x.min(axis=0) - 1.0, "hi": x.max(axis=0) + 1.0,
        "max_step": float(np.quantile(np.abs(dx), 0.999)) * 2.0,
        "z0": x0[sel], "z1": x1[sel],
    }


def dynamics_models(runs, device, dtype):
    """The four trained models of the phase's runs (their best.ckpt: the
    weights each eval.json scored), on ``device`` in ``dtype``."""
    from molecular_dynamics_tpu_torch.models import HNN, LatentHNN
    from molecular_dynamics_tpu_torch.models.schnet import SchNetHNN

    built = {"hnn": HNN(240, (200, 200), device=device, dtype=dtype),
             "hnn-schnet": SchNetHNN(40, rbf=32, device=device, dtype=dtype),
             "node": HNN(240, (200, 200), device=device, dtype=dtype),
             "hnn-latent": LatentHNN(120, 16, device=device, dtype=dtype)}
    for family, module in built.items():
        state = torch.load(runs / family / "best.ckpt", weights_only=True)
        module.load_state_dict({k: v.to(device=device, dtype=dtype) for k, v in state.items()})
    return built


def dynamics_steps(ff, models, data, device, dtype, schnet_rows=TRAIN_BATCH):
    """Each step kind of the line as (name, module, loss thunk, rows): the
    HNN and SchNet HNN L2, informed and 10-step unroll losses (the SchNet
    HNN on its first ``schnet_rows`` rows), node's RK4 step and its
    10-frame chained-solver loss, the latent HNN's loss. Every update is
    ``ClippedAdam(lr 1e-3, clip 1.0)`` down that loss."""
    from molecular_dynamics_tpu_torch.train import drivers
    from molecular_dynamics_tpu_torch.train import hnn as thnn_train

    a = {k: torch.as_tensor(v, device=device, dtype=dtype) if isinstance(v, np.ndarray) else v
         for k, v in data.items()}
    steps = []
    for family, rows in (("hnn", TRAIN_BATCH), ("hnn-schnet", schnet_rows)):
        m = models[family]
        x, dx, seq = a["x"][:rows], a["dx"][:rows], a["dx_seq"][:rows]
        steps += [
            (f"{family}.l2", m, lambda m=m, x=x, dx=dx: thnn_train.l2_loss(m, x, dx), rows),
            (f"{family}.informed", m,
             lambda m=m, x=x, dx=dx: thnn_train.informed_loss(m, ff, x, dx)[0], rows),
            (f"{family}.unroll", m, lambda m=m, x=x, seq=seq: thnn_train.unroll_loss(m, x, seq),
             rows),
        ]
    m = models["node"]
    steps += [
        ("node.step", m, lambda: drivers._node_step_loss(m, a["x"], a["dx"]), TRAIN_BATCH),
        ("node.unroll", m, lambda: drivers._node_unroll_loss(
            m, a["x"], a["x_seq"], 1.0, 1, a["max_step"], a["lo"], a["hi"]), TRAIN_BATCH),
        ("hnn-latent.step", models["hnn-latent"], lambda: drivers._latent_hnn_loss(
            models["hnn-latent"], a["z0"], a["z1"], 1.0, 1e-3), TRAIN_BATCH),
    ]
    return steps


def dynamics_vs_float64(runs, data, dev):
    """Each step kind on the card (float32) against the same step in float64
    on the CPU, from the same trained weights and rows (the SchNet HNN's at
    SCHNET_CHECK_BATCH rows), all within TOL_TRAIN_STEP
    (``steps_vs_float64``)."""
    sides = {}
    for side, device, dtype in (("card", dev, torch.float32),
                                ("cpu_f64", torch.device("cpu"), torch.float64)):
        ff = cli._load_system("example:backbone", "", dtype=dtype, device=device)[0]
        sides[side] = dynamics_steps(ff, dynamics_models(runs, device, dtype), data, device,
                                     dtype, schnet_rows=SCHNET_CHECK_BATCH)
    return steps_vs_float64(sides, TOL_TRAIN_STEP, TOL_TRAIN_STEP)


def dynamics_rates(runs, data, dev):
    """Updates a second of each step kind on the card at 40 atoms x batch
    32 (``update_rates_of``)."""
    ff = cli._load_system("example:backbone", "", device=dev)[0]
    return update_rates_of(dynamics_steps(ff, dynamics_models(runs, dev, torch.float32), data,
                                          dev, torch.float32))


def dynamics_census(runs, data, dev, steps=CENSUS_STEPS):
    """Kernel launches and host ms by source of one HNN informed step (the
    driver's ``informed_step``) and one node unroll update (10 chained
    frames), at 40 atoms x batch 32: the HNN field (its forward and its
    input gradient, ``time_derivative``), the batched energy, the backward
    pass, the optimizer; the rest of the step outside them."""
    from molecular_dynamics_tpu_torch.models import hnn as mhnn
    from molecular_dynamics_tpu_torch.train import common as tcommon
    from molecular_dynamics_tpu_torch.train import drivers
    from molecular_dynamics_tpu_torch.train import hnn as thnn_train
    from molecular_dynamics_tpu_torch.train.common import ClippedAdam

    ff = cli._load_system("example:backbone", "", device=dev)[0]
    models = dynamics_models(runs, dev, torch.float32)
    a = {k: torch.as_tensor(v, device=dev) if isinstance(v, np.ndarray) else v
         for k, v in data.items()}
    _, _, informed_step, _ = thnn_train.make_hnn_trainer(models["hnn"], ff)
    opt = ClippedAdam(models["node"].parameters(), lr=1e-3, clip_norm=1.0)
    runs_by_name = {
        "census_hnn_informed_40": lambda: informed_step(a["x"], a["dx"]),
        "census_node_unroll_40": lambda: tcommon.descend(opt, drivers._node_unroll_loss(
            models["node"], a["x"], a["x_seq"], 1.0, 1, a["max_step"], a["lo"], a["hi"])),
    }
    field = labelled("field", mhnn.time_derivative)
    sources = ("field", "energy", "backward", "optimizer")
    out = {}
    with patched(((mhnn, "time_derivative", field), (thnn_train, "time_derivative", field),
                  (thnn_train, "potential_loss", labelled("energy", thnn_train.potential_loss)),
                  (thnn_train, "descend", census_descend), (tcommon, "descend", census_descend))):
        for name, step in runs_by_name.items():
            out[name] = census_summary(census_by_source(step, sources, steps), sources,
                                       atoms=40, batch=TRAIN_BATCH, steps=steps)
    return out


def dynamics_phase(tmp, dev, train_runs):
    """The Hamiltonian dynamics line on the card: ``cli train node`` at its
    live-quality budget, ``hnn`` and ``hnn-latent`` at HNN_SANITY_EPOCHS and
    ``hnn-schnet`` at SCHNET_EPOCHS under the sanity bound, on the in-repo
    40-atom data;
    every step kind against float64 from the trained weights; update rates;
    the census of an HNN informed step and a node unroll update."""
    res, launches = {}, {}
    pattern = str(TRAIN_DATA / "raw-traj_rep-*.npy")
    for family in DYNAMICS_FAMILIES:
        run, epochs, ceiling, launches[family] = train_runs["dynamics", family]
        e2e = run["eval"]["mean_abs_error"]
        if family == "node":
            check(e2e <= ceiling, f"train node --epochs {epochs}: mean_abs_error {e2e} A above "
                                  f"the ceiling {ceiling}")
        else:
            check(e2e < ceiling, f"train {family} --epochs {epochs}: mean_abs_error {e2e} A")
        res[family] = {**run, "epochs": epochs, "ceiling_A": ceiling, "launches": launches[family]}
    runs = tmp / "dynamics"
    data = dynamics_data(pattern, dev)
    res["step_vs_float64"] = {**dynamics_vs_float64(runs, data, dev),
                              "tolerance": TOL_TRAIN_STEP}
    res["update_rates_40"] = dynamics_rates(runs, data, dev)
    res.update(dynamics_census(runs, data, dev))
    return res, launches


# -- the sequence and graph line ---------------------------------------------------


def sequence_data(pattern):
    """The in-repo 40-atom data as the sequence drivers see it, one batch of
    each step kind (numpy, float32, the first of a seeded permutation where
    the driver shuffles): windows and targets of ``lstm`` (history 15, lead
    2), ``lstm-nll`` (lead 1) and the transformer (history 11, lead 1); the
    window fine-tunes' 8-frame rollout targets (16 rows, the drivers' fine-tune batch);
    a Seq2Seq batch (history 10, decode 5) with its decoder noise; the GNS
    rows and scales of ``gat`` (strided to 160 frames) with input noise and
    its fine-tune's 8-frame rows; ``lstm-gat``'s windows and fine-tune rows;
    ``seq2seq-graph``'s per-atom batch and its fine-tune rows (4 segments of
    5) with their noise; and what each side needs to rebuild the rest
    (whitening, the torsion rows)."""
    from molecular_dynamics_tpu_torch.train import drivers as d
    from molecular_dynamics_tpu_torch.train.datasets import TrajectoryData, window_batches

    traj = TrajectoryData.from_npy_glob(pattern)
    white, w_mean, w_std = d._whitened(traj)
    rng = np.random.default_rng(0)
    b, ft_b = TRAIN_BATCH, TRAIN_BATCH // 2
    out = {"w_mean": w_mean, "w_std": w_std}
    for name, history, lead in (("lstm", 15, 2), ("nll", 15, 1), ("transformer", 11, 1)):
        out[f"{name}_w"], out[f"{name}_t"] = next(window_batches(white, history, lead, b, rng))
    flats = [t.reshape(len(t), -1) for t in white.trajectories]

    def some(arrays, n):
        sel = rng.permutation(len(arrays[0]))[:n]
        return [np.stack(a)[sel].astype(np.float32) for a in arrays]

    for name, history in (("lstm", 15), ("transformer", 11)):
        out[f"{name}_ft_w"], out[f"{name}_ft_t"] = some(d._windows_ahead(flats, history, 8), ft_b)
    wins, tgts = next(d._decode_batches(flats, 10, 5, b, "cpu"))
    out["s2s_w"], out["s2s_t"] = wins.numpy(), tgts.numpy()
    out["s2s_noise_g"], out["s2s_noise_d"] = (rng.standard_normal((b, 5, 16)).astype(np.float32)
                                              for _ in range(2))
    strided = TrajectoryData([t[::2] for t in traj.trajectories])  # the driver's 160 frames
    pos, vv, aa, nxt, starts, lens = d._gns_dataset(strided)
    acc_scale, vel_scale = float(np.abs(aa).mean()) + 1e-8, float(np.abs(vv).mean()) + 1e-8
    vv, aa = vv / vel_scale, aa / acc_scale
    sel = rng.permutation(len(pos))[:b]
    out.update(gat_pos=pos[sel], gat_v1=vv[sel, 0], gat_v2=vv[sel, 1], gat_acc=aa[sel],
               gat_next=nxt[sel], gat_noise=rng.standard_normal((b, 40, 3)).astype(np.float32),
               gat_scales=(vel_scale, acc_scale))
    rows = rng.permutation([starts[i] + s for i, n in enumerate(lens)
                            for s in range(0, n - 8, 4)])[:ft_b]
    out.update(gat_ft_p0=pos[rows], gat_ft_v1=vv[rows, 0], gat_ft_v2=vv[rows, 1],
               gat_ft_t=np.stack([pos[j + 1: j + 9] for j in rows]))
    lg_w, lg_t = d._lstm_gat_windows(white, 5)
    sel = rng.permutation(len(lg_w))[:b]
    out["lg_w"], out["lg_t"] = lg_w[sel], lg_t[sel]
    out["lg_ft_w"], out["lg_ft_t"] = some(d._windows_ahead(white.trajectories, 5, 8), ft_b)
    top, _ = decaalanine_backbone()
    feats = d._atom_features(traj, white, top, "cpu")
    wins, tgts = next(d._decode_batches(feats, 10, 5, b, "cpu", transpose=True))
    out["g_w"], out["g_t"] = wins.numpy(), tgts.numpy()
    out["g_noise"] = rng.standard_normal((b, 5, 40, 5)).astype(np.float32)
    out["g_ft_w"], out["g_ft_t"] = some(d._windows_ahead(feats, 10, 20, transpose=True), ft_b)
    out["g_ft_noise"] = rng.standard_normal((ft_b, 4, 5, 40, 5)).astype(np.float32)
    out["white_trajectories"] = white
    return out


def sequence_models(runs, device, dtype):
    """The eight trained models of the phase's runs (their best.ckpt), on
    ``device`` in ``dtype``, at the drivers' widths; beside the adversarial
    Seq2Seq's generator a critic from its seeded initialisation (the run
    keeps the generator only)."""
    from molecular_dynamics_tpu_torch.models import gat as mgat
    from molecular_dynamics_tpu_torch.models import seq as mseq
    from molecular_dynamics_tpu_torch.models.transformer import TrajectoryTransformer

    kw = dict(device=device, dtype=dtype)
    built = {"lstm": mseq.LSTMPredictor(120, 120, **kw),
             "lstm-nll": mseq.LSTMNLLPredictor(120, 120, **kw),
             "seq2seq": mseq.Seq2Seq(120, 120, **kw), "seq2seq-gan": mseq.Seq2Seq(120, 120, **kw),
             "transformer": TrajectoryTransformer(120, 120, d_model=64, history=11, **kw),
             "gat": mgat.GATSimulator(9, latent=64, n_processors=3, k=39, **kw),
             "lstm-gat": mgat.LSTMGAT(3, 3, k=10, **kw), "seq2seq-graph": mgat.GraphSeq2Seq(**kw)}
    for family, module in built.items():
        state = torch.load(runs / family / "best.ckpt", weights_only=True)
        module.load_state_dict({k: v.to(device=device, dtype=dtype) for k, v in state.items()})
    cpu_gen = torch.Generator().manual_seed(SEED)
    critic = mseq.SequenceDiscriminator(120, generator=cpu_gen, device="cpu")
    built["critic"] = critic.to(device=device, dtype=dtype)
    return built


def sequence_steps(models, data, device, dtype):
    """Each step kind of the line as (name, module, loss thunk, rows): the
    lstm window step and its fine-tune (8 chained windows), the lstm-nll
    step, the seq2seq step, seq2seq-gan's generator and critic steps, the
    transformer's step and fine-tune, the gat step (input noise) and
    fine-tune (8 clamped frames), the lstm-gat step and fine-tune (8
    clamped frames), the seq2seq-graph step and fine-tune (4 chained
    segments of 5 decodes, torsions rebuilt). Every update is
    ``ClippedAdam(lr 1e-3, clip 1.0)`` down that loss."""
    from molecular_dynamics_tpu_torch.features import knn_mask, per_atom_angle_rows
    from molecular_dynamics_tpu_torch.train import drivers as d
    from molecular_dynamics_tpu_torch.train import seq as tseq

    a = {k: torch.as_tensor(v, device=device, dtype=dtype) if isinstance(v, np.ndarray) else v
         for k, v in data.items()}
    m = models
    top, _ = decaalanine_backbone()
    phi_idx, psi_idx, _, _ = per_atom_angle_rows(top)
    phi = torch.as_tensor(phi_idx, device=device)
    psi = torch.as_tensor(psi_idx, device=device)
    knn = knn_mask(40, 5, device=device)
    vel_scale, acc_scale = data["gat_scales"]
    clamps = d._lstm_gat_clamps(data["white_trajectories"], device)
    clamps = (clamps[0], clamps[1].to(dtype), clamps[2].to(dtype))
    refeature = d._refeaturizer(*per_atom_angle_rows(top), data["w_mean"], data["w_std"], device)
    b, ft_b = TRAIN_BATCH, TRAIN_BATCH // 2
    return [
        ("lstm.step", m["lstm"], lambda: tseq.window_loss(
            m["lstm"], a["lstm_w"], a["lstm_t"], phi, psi, knn), b),
        ("lstm.finetune", m["lstm"], lambda: d._window_unroll_loss(
            m["lstm"], a["lstm_ft_w"], a["lstm_ft_t"]), ft_b),
        ("lstm-nll.step", m["lstm-nll"], lambda: tseq.nll_loss(
            m["lstm-nll"], a["nll_w"], a["nll_t"]), b),
        ("seq2seq.step", m["seq2seq"], lambda: tseq.seq2seq_loss(
            m["seq2seq"], a["s2s_noise_g"], a["s2s_w"], a["s2s_t"]), b),
        ("seq2seq-gan.g", m["seq2seq-gan"], lambda: tseq.gan_generator_loss(
            m["seq2seq-gan"], m["critic"], a["s2s_noise_g"], a["s2s_w"], a["s2s_t"]), b),
        ("seq2seq-gan.d", m["critic"], lambda: tseq.gan_critic_loss(
            m["critic"], m["seq2seq-gan"], a["s2s_noise_d"], a["s2s_w"], a["s2s_t"]), b),
        ("transformer.step", m["transformer"], lambda: tseq.mse_loss(
            m["transformer"], a["transformer_w"], a["transformer_t"]), b),
        ("transformer.finetune", m["transformer"], lambda: d._window_unroll_loss(
            m["transformer"], a["transformer_ft_w"], a["transformer_ft_t"]), ft_b),
        ("gat.step", m["gat"], lambda: d._gat_loss(
            m["gat"], a["gat_noise"], a["gat_pos"], a["gat_v1"], a["gat_v2"], a["gat_acc"],
            a["gat_next"], 0.5 * vel_scale, vel_scale, acc_scale), b),
        ("gat.finetune", m["gat"], lambda: d._gat_unroll_loss(
            m["gat"], a["gat_ft_p0"], a["gat_ft_v1"], a["gat_ft_v2"], a["gat_ft_t"],
            vel_scale, acc_scale), ft_b),
        ("lstm-gat.step", m["lstm-gat"], lambda: torch.mean(
            (d._lstm_gat_predict(m["lstm-gat"], a["lg_w"]) - a["lg_t"]) ** 2), b),
        ("lstm-gat.finetune", m["lstm-gat"], lambda: torch.mean(
            (d._lstm_gat_unroll(m["lstm-gat"], a["lg_ft_w"], 8, clamps) - a["lg_ft_t"]) ** 2),
         ft_b),
        ("seq2seq-graph.step", m["seq2seq-graph"], lambda: tseq.graph_seq2seq_loss(
            m["seq2seq-graph"], a["g_noise"], a["g_w"], a["g_t"]), b),
        ("seq2seq-graph.finetune", m["seq2seq-graph"], lambda: d._graph_unroll_loss(
            m["seq2seq-graph"], a["g_ft_w"], a["g_ft_t"], a["g_ft_noise"], refeature), ft_b),
    ]


def sequence_census(runs, data, dev, steps=CENSUS_STEPS):
    """Kernel launches and host ms by source of an lstm fine-tune update (8
    chained windows of 15 frames, 16 rows) and a seq2seq-graph fine-tune
    update (4 chained segments of 5 decodes, 16 rows x 40 atoms): the LSTM
    layers (cuDNN), the kNN graphs and GAT layers, the torsion
    refeaturizer, the backward pass, the optimizer; the rest of the step
    (heads, shifts, the loss) outside them."""
    from molecular_dynamics_tpu_torch.features import per_atom_angle_rows
    from molecular_dynamics_tpu_torch.models import gat as mgat
    from molecular_dynamics_tpu_torch.models import seq as mseq
    from molecular_dynamics_tpu_torch.train import drivers as d

    models = sequence_models(runs, dev, torch.float32)
    a = {k: torch.as_tensor(v, device=dev) for k, v in data.items() if isinstance(v, np.ndarray)}
    top, _ = decaalanine_backbone()
    refeature = labelled("refeature", d._refeaturizer(*per_atom_angle_rows(top), data["w_mean"],
                                                      data["w_std"], dev))
    opts = {f: ClippedAdam(models[f].parameters(), lr=2e-5, clip_norm=1.0)
            for f in ("lstm", "seq2seq-graph")}
    runs_by_name = {
        "census_lstm_finetune_40": (lambda: census_descend(opts["lstm"], d._window_unroll_loss(
            models["lstm"], a["lstm_ft_w"], a["lstm_ft_t"])), ("lstm", "backward", "optimizer")),
        "census_seq2seq_graph_finetune_40": (lambda: census_descend(
            opts["seq2seq-graph"], d._graph_unroll_loss(
                models["seq2seq-graph"], a["g_ft_w"], a["g_ft_t"], a["g_ft_noise"], refeature)),
            ("lstm", "graph", "refeature", "backward", "optimizer")),
    }
    out = {}
    with patched(((mseq.LSTMLayer, "forward", labelled("lstm", mseq.LSTMLayer.forward)),
                  (mgat.DenseGATLayer, "forward", labelled("graph", mgat.DenseGATLayer.forward)),
                  (mgat, "graph", labelled("graph", mgat.graph)))):
        for name, (step, sources) in runs_by_name.items():
            out[name] = census_summary(census_by_source(step, sources, steps), sources,
                                       atoms=40, rows=TRAIN_BATCH // 2, steps=steps)
    return out


def sequence_phase(tmp, dev, train_runs):
    """The sequence and graph line on the card: ``cli train lstm`` and
    ``lstm-gat`` at their live-quality budgets, the other six at
    SEQUENCE_SANITY_EPOCHS under the sanity bound, on the in-repo 40-atom data;
    every step kind against float64 from the trained weights; update rates;
    the census of an lstm and a seq2seq-graph fine-tune update."""
    res, launches = {}, {}
    pattern = str(TRAIN_DATA / "raw-traj_rep-*.npy")
    runs = tmp / "sequence"
    for family in SEQUENCE_FAMILIES:
        run, epochs, ceiling, launches[family] = train_runs["sequence", family]
        e2e = run["eval"]["mean_abs_error"]
        if family in TRAIN_BUDGET:
            check(e2e <= ceiling, f"train {family} --epochs {epochs}: mean_abs_error {e2e} A "
                                  f"above the ceiling {ceiling}")
        else:
            check(e2e < ceiling, f"train {family} --epochs {epochs}: mean_abs_error {e2e} A")
        res[family] = {**run, "epochs": epochs, "ceiling_A": ceiling,
                       "mean_abs_error": e2e, "rg_abs_error": run["eval"]["rg_abs_error"],
                       "launches": launches[family]}
    data = sequence_data(pattern)
    cpu = torch.device("cpu")
    sides = {side: sequence_steps(sequence_models(runs, device, dtype), data, device, dtype)
             for side, device, dtype in (("card", dev, torch.float32),
                                         ("cpu_f32", cpu, torch.float32),
                                         ("cpu_f64", cpu, torch.float64))}
    res["step_vs_float64"] = {
        **steps_vs_float64(sides, TOL_SEQUENCE_STEP, TOL_TRAIN_STEP),
        "tolerance_loss_grad": TOL_SEQUENCE_STEP, "tolerance_update": TOL_TRAIN_STEP,
        "float32_floor_factor": FLOAT32_FLOOR, "float64_side": "cpu",
        "float32_side": torch.cuda.get_device_name(0)}
    res["update_rates_40"] = update_rates_of(
        sequence_steps(sequence_models(runs, dev, torch.float32), data, dev, torch.float32))
    res.update(sequence_census(runs, data, dev))
    return res, launches


# -- the generative line ----------------------------------------------------------


def generative_data(pattern):
    """The in-repo 40-atom data as the generative drivers see it, one batch
    of each step kind (numpy, the first TRAIN_BATCH of a seeded permutation)
    with its draws: min-max scaled frames and times for the flow (the
    driver's scaling over all frames), whitened frames with their time
    buckets and reparameterisation draws for the VAE, whitened frames,
    times and prior draws for the AAE, and whitened 8-frame path windows
    with the generator's ``z0`` and ``dw`` and the penalty's ``eps`` for
    the SDE-GAN, and the whitening."""
    from molecular_dynamics_tpu_torch.train import drivers as d
    from molecular_dynamics_tpu_torch.train.datasets import TrajectoryData

    traj = TrajectoryData.from_npy_glob(pattern)
    white, w_mean, w_std = d._whitened(traj)
    rng = np.random.default_rng(0)
    b = TRAIN_BATCH
    frames, times = traj.stacked()
    flat = frames.reshape(len(frames), -1)
    lo, hi = flat.min(axis=0), flat.max(axis=0)
    sel = rng.permutation(len(flat))[:b]
    wflat = np.concatenate(white.trajectories).reshape(len(flat), -1)
    paths, _ = d._sde_windows(white, 8)
    dts = np.diff(np.linspace(0.0, 1.0, 8))
    return {
        "flow_x": ((flat[sel] - lo) / (hi - lo + 1e-12)).astype(np.float32),
        "flow_c": times[sel, None],
        "vae_x": wflat[sel], "vae_b": np.minimum((times[sel] * 10).astype(np.int64), 9),
        "vae_eps": rng.standard_normal((b, 32)).astype(np.float32),
        "aae_x": wflat[sel], "aae_c": times[sel, None],
        "aae_prior": rng.standard_normal((b, 16)).astype(np.float32),
        "sde_real": paths[rng.permutation(len(paths))[:b]],
        "sde_z0": rng.standard_normal((b, 16)).astype(np.float32),
        "sde_dw": (rng.standard_normal((7, b, 16)) * np.sqrt(dts)[:, None, None]).astype(
            np.float32),
        "sde_eps": rng.uniform(size=(b, 1, 1)).astype(np.float32),
        "w_mean": np.asarray(w_mean, np.float32), "w_std": np.asarray(w_std, np.float32),
    }


def generative_models(runs, device, dtype):
    """The four trained models of the phase's runs (their best.ckpt), on
    ``device`` in ``dtype``, at the drivers' widths; beside the AAE's
    autoencoder and the SDE's averaged generator, the critics from their
    seeded initialisation (the runs keep the generators only)."""
    from molecular_dynamics_tpu_torch.models import CDEDiscriminator, ConditionalVAE, RealNVP
    from molecular_dynamics_tpu_torch.models import LatentDiscriminator, MLPAutoencoder, SDEGenerator

    kw = dict(device=device, dtype=dtype)
    built = {"flow": RealNVP(120, 6, (256, 256), 1, **kw), "vae": ConditionalVAE(120, **kw),
             "aae": MLPAutoencoder(120, 16, cond_dim=1, **kw),
             "sde": SDEGenerator(120, latent_dim=64, noise_dim=16, hidden=(128, 128), **kw)}
    for family, module in built.items():
        state = torch.load(runs / family / "best.ckpt", weights_only=True)
        module.load_state_dict({k: v.to(device=device, dtype=dtype) for k, v in state.items()})
    cpu_gen = torch.Generator().manual_seed(SEED)
    built["aae_critic"] = LatentDiscriminator(16, generator=cpu_gen, device="cpu").to(**kw)
    built["sde_critic"] = CDEDiscriminator(120, generator=cpu_gen, device="cpu").to(**kw)
    return built


#: the SDE driver's configuration at its defaults
SDE_DRIVER_CONFIG = dict(gp_weight=10.0, adam=True, lr_g=2e-4, lr_d=1e-3, moment_weight=1.0)


def generative_steps(ff, models, data, device, dtype):
    """Each step kind of the line as (name, module, loss thunk, rows): the
    flow's NLL, the VAE's MSE + KLD, the AAE's autoencoder loss and its
    critic's, the SDE-GAN's generator loss (critic, moments), its critic
    loss with the gradient penalty (a double backward) and its potential
    injection on the unwhitened paths. Every update is ``ClippedAdam(lr
    1e-3, clip 1.0)`` down that loss."""
    from molecular_dynamics_tpu_torch.train import drivers as d
    from molecular_dynamics_tpu_torch.train import generative as tgen
    from molecular_dynamics_tpu_torch.train import sde as tsde_train

    a = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
    a = {k: v if k == "vae_b" else v.to(dtype) for k, v in a.items()}
    m = models
    ts = torch.linspace(0.0, 1.0, 8, device=device, dtype=dtype)
    cfg = tsde_train.SDEGANConfig(**SDE_DRIVER_CONFIG)
    b = TRAIN_BATCH
    return [
        ("flow.step", m["flow"], lambda: tgen.flow_loss(m["flow"], a["flow_x"], a["flow_c"]), b),
        ("vae.step", m["vae"], lambda: tgen.vae_step_loss(
            m["vae"], a["vae_eps"], a["vae_x"], a["vae_b"]), b),
        ("aae.ae", m["aae"], lambda: d._aae_losses(m["aae"], m["aae_critic"], a["aae_x"],
                                                   a["aae_c"]), b),
        ("aae.d", m["aae_critic"], lambda: d._aae_losses(
            m["aae"], m["aae_critic"], a["aae_x"], a["aae_c"], a["aae_prior"]), b),
        ("sde.g", m["sde"], lambda: tsde_train.generator_loss(
            m["sde"], m["sde_critic"], ts, a["sde_z0"], a["sde_dw"], a["sde_real"], None, cfg), b),
        ("sde.d_gp", m["sde_critic"], lambda: tsde_train.critic_loss(
            m["sde_critic"], m["sde"], ts, a["sde_z0"], a["sde_dw"], a["sde_eps"], a["sde_real"],
            None, cfg), b),
        ("sde.informed", m["sde"], lambda: tsde_train.informed_loss(
            m["sde"], ff, ts, a["sde_z0"], a["sde_dw"], None, cfg,
            unwhiten=(a["w_mean"], a["w_std"])), b),
    ]


def swa_vs_float64(runs, dev):
    """``swa_update`` on the card against float64 on the CPU: the trained
    SDE generator averaged (as the sixth of a run) with a seeded perturbation
    of itself, relative."""
    from molecular_dynamics_tpu_torch.train.sde import swa_update

    out = {}
    for side, device, dtype in (("card", dev, torch.float32),
                                ("cpu_f64", torch.device("cpu"), torch.float64)):
        avg = generative_models(runs, device, dtype)["sde"]
        other = generative_models(runs, device, dtype)["sde"]
        rng = np.random.default_rng(SEED)
        with torch.no_grad():
            for p in other.parameters():
                p.add_(torch.as_tensor(0.01 * rng.standard_normal(tuple(p.shape)), device=device,
                                       dtype=dtype))
        swa_update(avg, other, 5)
        out[side] = flat_params(avg)
    err = float((out["card"] - out["cpu_f64"]).norm() / out["cpu_f64"].norm())
    check(err <= TOL_SEQUENCE_STEP, f"swa_update, card vs float64: {err}")
    return {"param_rel_err": err, "n_averaged": 5, "tolerance": TOL_SEQUENCE_STEP}


def generative_census(runs, data, dev, steps=CENSUS_STEPS):
    """Kernel launches and host ms by source of one SDE critic update with
    the gradient penalty and one potential-injection update, at 40 atoms x
    batch 32 with the driver's configuration: the generator's paths, the
    critic's scores, the penalty's input gradient, the batched energy, the
    backward pass, the optimizer; the rest of the step outside them."""
    from molecular_dynamics_tpu_torch.models import sde as msde
    from molecular_dynamics_tpu_torch.train import sde as tsde_train

    ff = cli._load_system("example:backbone", "", device=dev)[0]
    models = generative_models(runs, dev, torch.float32)
    a = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
    ts = torch.linspace(0.0, 1.0, 8, device=dev)
    _, _, _, d_step, informed_step, _ = tsde_train.make_sde_gan_trainer(
        models["sde"], models["sde_critic"], ts, ff=ff,
        config=tsde_train.SDEGANConfig(**SDE_DRIVER_CONFIG), unwhiten=(a["w_mean"], a["w_std"]))
    runs_by_name = {
        "census_sde_d_gp_40": lambda: d_step(a["sde_z0"], a["sde_dw"], a["sde_eps"],
                                             a["sde_real"]),
        "census_sde_informed_40": lambda: informed_step(a["sde_z0"], a["sde_dw"]),
    }
    sources = ("critic", "generator", "penalty", "energy", "backward", "optimizer")
    out = {}
    with patched(((msde.SDEGenerator, "forward", labelled("generator", msde.SDEGenerator.forward)),
                  (msde.CDEDiscriminator, "forward",
                   labelled("critic", msde.CDEDiscriminator.forward)),
                  (tsde_train, "_input_gradient",
                   labelled("penalty", tsde_train._input_gradient)),
                  (tsde_train, "potential_loss", labelled("energy", tsde_train.potential_loss)),
                  (tsde_train, "descend", census_descend))):
        for name, step in runs_by_name.items():
            out[name] = census_summary(census_by_source(step, sources, steps), sources,
                                       atoms=40, batch=TRAIN_BATCH, steps=steps)
    return out


def generative_phase(tmp, dev, train_runs):
    """The generative line on the card: ``cli train flow``, ``vae``, ``aae``
    and ``sde`` at DYNAMICS_EPOCHS under the sanity bound, on the in-repo
    40-atom data; every step kind against float64 from the trained weights
    and the weight average; update rates; the census of an SDE critic step
    with the penalty and an injection step."""
    res, launches = {}, {}
    pattern = str(TRAIN_DATA / "raw-traj_rep-*.npy")
    runs = tmp / "generative"
    for family in GENERATIVE_FAMILIES:
        run, _, _, launches[family] = train_runs["generative", family]
        e2e = run["eval"]["mean_abs_error"]
        check(e2e < DYNAMICS_SANITY_A,
              f"train {family} --epochs {DYNAMICS_EPOCHS}: mean_abs_error {e2e} A")
        if family == "sde":
            tv = run["eval"]["marginal_tv_mean"]
            check(0.0 <= tv <= 1.0, f"train sde: marginal_tv_mean {tv}")
            res["sde_marginal_tv"] = {k: run["eval"][k] for k in (
                "marginal_tv_mean", "marginal_tv_max", "marginal_tv_floor")}
        res[family] = {**run, "epochs": DYNAMICS_EPOCHS, "ceiling_A": DYNAMICS_SANITY_A,
                       "mean_abs_error": e2e, "rg_abs_error": run["eval"]["rg_abs_error"],
                       "launches": launches[family]}
    data = generative_data(pattern)
    cpu = torch.device("cpu")
    sides = {}
    for side, device, dtype in (("card", dev, torch.float32), ("cpu_f32", cpu, torch.float32),
                                ("cpu_f64", cpu, torch.float64)):
        ff = cli._load_system("example:backbone", "", dtype=dtype, device=device)[0]
        sides[side] = generative_steps(ff, generative_models(runs, device, dtype), data, device,
                                       dtype)
    res["step_vs_float64"] = {
        **steps_vs_float64(sides, TOL_SEQUENCE_STEP, TOL_TRAIN_STEP),
        "tolerance_loss_grad": TOL_SEQUENCE_STEP, "tolerance_update": TOL_TRAIN_STEP,
        "float32_floor_factor": FLOAT32_FLOOR, "float64_side": "cpu",
        "float32_side": torch.cuda.get_device_name(0)}
    res["swa_update_vs_float64"] = swa_vs_float64(runs, dev)
    ff = cli._load_system("example:backbone", "", device=dev)[0]
    res["update_rates_40"] = update_rates_of(
        generative_steps(ff, generative_models(runs, dev, torch.float32), data, dev,
                         torch.float32))
    res.update(generative_census(runs, data, dev))
    return res, launches


def trained_generation_phase(tmp):
    """``gat``, ``hnn-schnet`` and ``seq2seq-graph``'s generation maps on the
    card from the JAX package's trained weights, each eval.json key against
    the JAX package's on the CPU (``tests/goldens/trained_generation``); the
    kernel launches of each map."""
    trained = load_test_files(TEST_TRAINED)
    goldens = trained.golden_eval()
    res, launches = {"tolerance_A": trained.TOL, "data": trained.DATA}, {}
    for family in sorted(trained.FAMILIES):
        kept = trained.golden(family)
        reset_launches()
        t0 = time.perf_counter()
        got = trained.port_generation(family, tmp / "trained_generation", "cuda",
                                      kept["state_dict"], kept["noise"])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches[family] = read_launches()
        want = goldens[family]
        check(sorted(got) == sorted(want), f"trained {family}: eval keys {sorted(got)}")
        errs = {k: abs(got[k] - want[k]) for k in want}
        res[family] = {"eval": got, "jax_cpu": want, "max_abs_err_A": max(errs.values()),
                       "worst_key": max(errs, key=errs.get), "seconds": seconds,
                       "launches": launches[family]}
        check(max(errs.values()) <= trained.TOL,
              f"trained {family}: the card's eval.json {errs} A from the JAX package's on the "
              f"CPU (tolerance {trained.TOL})")
    return res, launches


def main():
    t_script = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)

    # the parallel phase's two data-parallel ranks start now: a fresh
    # process's start (its imports, its CUDA context) runs beside the build
    dp_ranks = start_dp_ranks(dev)

    # -- build -------------------------------------------------------------
    lever_builds = start_lever_builds()
    libs = _build.build_all(verbose=True)
    emit("build", seconds=round(_build.last_build_seconds, 2),
         libraries=sorted(libs), flags=" ".join(_build.NVCC_FLAGS),
         ptxas=ptxas_summary(_build.last_build_logs))

    # -- the system: minimised 104-atom deca-alanine -------------------------
    ff, coords, meta_full = decaalanine_full()
    n = ff.n_atoms
    check(n == 104, f"expected the 104-atom system, got {n}")
    force = mdx.force_fn(REFERENCE_CONFIG)
    t0 = time.perf_counter()
    pos_min = minimize_fire(
        torch.as_tensor(coords, dtype=torch.float32, device=dev),
        lambda p: force(p, ff), n_steps=500, dt_start=1e-3, dt_max=1e-2,
    )
    torch.cuda.synchronize()
    fire_s = time.perf_counter() - t0
    e_min = float(total_energy(pos_min, ff))
    check(np.isfinite(e_min), "FIRE minimisation diverged")

    d0 = float(torch.linalg.norm(pos_min[-1] - pos_min[0]))
    bias = HarmonicSMDBias.create(
        n_atoms=n, group1=[0], group2=[n - 1], fk=1.0,
        cent_0=d0, cent_1=d0 + 22.0, T=500_000.0,
    )
    cons = hydrogen_bond_constraints(ff)
    check(cons.n_constraints == 53, f"expected 53 X-H constraints, got {cons.n_constraints}")

    rng = np.random.default_rng(SEED)
    jitter = torch.as_tensor(
        rng.normal(0.0, 0.02, (N_REPLICAS, n, 3)), dtype=torch.float32, device=dev
    )
    pos_pert = (pos_min[None] + jitter).contiguous()

    checks = {}
    kernels = {}

    # -- K2: pair_forces ---------------------------------------------------
    tables = nonbonded.build_pair_tables(ff)
    ff64 = ff.to(dtype=torch.float64)
    pair_cases = {
        "reference_9A_rf_sw7.5": dict(cutoff=9.0, switch_dist=7.5, rfa=True),
        "gbis_16A_norf_sw15": dict(cutoff=16.0, switch_dist=15.0, rfa=False),
    }
    for name, kw in pair_cases.items():
        e_k, f_k = ring.pair_forces(pos_pert, tables, **kw)
        torch.cuda.synchronize()
        e_p, f_p = ring.pair_forces_reference(pos_pert, tables, **kw)
        e_d, f_d = ring.pair_forces_reference(pos_pert.double(), tables, **kw)
        # the f64 autograd energy of the same 2-body terms, on a few replicas
        ecfg = mdx.EnergyConfig(
            terms=("electrostatics", "lj", "bonds", "dihedrals", "1-4"), **kw
        )
        sub = pos_pert[:8].double()

        def two_body_energy(p):
            terms = energy_terms(p, ff64, config=ecfg)
            return sum(v for k, v in terms.items() if k != "dihedrals")

        f_auto = _neg_grad(two_body_energy, sub)
        res = {
            "force_err_kernel_vs_plain": max_err(f_k, f_p),
            "energy_err_kernel_vs_plain": max_err(e_k, e_p),
            "force_err_plain_f32_vs_f64": max_err(f_p, f_d),
            "energy_err_plain_f32_vs_f64": max_err(e_p, e_d),
            "force_err_kernel_vs_f64": max_err(f_k, f_d),
            "energy_err_kernel_vs_f64": max_err(e_k, e_d),
            "force_err_plain_f64_vs_autograd": max_err(f_d[:8], f_auto),
        }
        checks[f"pair_forces[{name}]"] = res
        check(bool(torch.isfinite(f_k).all()), f"pair_forces {name}: non-finite forces")
        check(res["force_err_kernel_vs_plain"] <= TOL_PAIR_FORCE, f"pair_forces {name}: {res}")
        check(res["energy_err_kernel_vs_plain"] <= TOL_PAIR_ENERGY, f"pair_forces {name}: {res}")
        check(res["force_err_plain_f32_vs_f64"] <= TOL_PAIR_FORCE, f"pair plain f32/f64 {name}: {res}")
        check(res["energy_err_plain_f32_vs_f64"] <= TOL_PAIR_ENERGY, f"pair plain f32/f64 {name}: {res}")
        check(res["force_err_plain_f64_vs_autograd"] <= TOL_TABLES, f"pair plain vs autograd {name}: {res}")

    # every timing below runs with the host to itself: the lever builds end here
    lever_libs = finish_lever_builds(*lever_builds)
    ref_kw = pair_cases["reference_9A_rf_sw7.5"]
    pair_consts = nonbonded.pair_constants(9.0, 7.5, True, mdx.units.SOLVENT_DIELECTRIC)
    live = live_pair_count(pos_pert, tables, pair_consts)
    k2_ms = device_ms(lambda: ring.pair_forces(pos_pert, tables, **ref_kw))
    k2_b2b_ms = time_ms(lambda: ring.pair_forces(pos_pert, tables, **ref_kw), repeats=20)
    k2_plain_ms = time_ms(lambda: ring.pair_forces_reference(pos_pert, tables, **ref_kw), repeats=3)
    k2_plain = ring.pair_forces_reference(pos_pert, tables, **ref_kw)
    k2_bound = loop_pair_bound(pos_pert, tables, live, pair_consts[0])
    ref_res = checks["pair_forces[reference_9A_rf_sw7.5]"]
    kernels["pair_forces"] = {
        "name": "pair_forces", "route": "cuda",
        "source": "molecular_dynamics_tpu_torch/csrc/pair_forces.cu",
        "replaces": "molecular_dynamics_tpu/ops/ring.py:38",
        "launches": 0,
        "max_abs_err": max(ref_res["force_err_kernel_vs_plain"],
                           checks["pair_forces[gbis_16A_norf_sw15]"]["force_err_kernel_vs_plain"]),
        "tolerance": TOL_PAIR_FORCE,
        "ms": k2_ms, "ms_back_to_back": k2_b2b_ms, "plain_ms": k2_plain_ms, **k2_bound,
        "library_ms": None, "sfu_bound_ms": sfu_ms(pair_sfu_ops(live)),
        **build_facts(_build.kernel_info("pair_forces", "mdx_pair_forces_info", [ctypes.c_int], n)),
        "shape": [N_REPLICAS, n, 3], "live_unordered_pairs": live,
    }

    # -- K1: campaign_advance ----------------------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    std = torch.sqrt(mdx.units.BOLTZMANN * 300.0 / ff.masses)[None, :, None]
    vel_b = (std * torch.randn((N_REPLICAS, n, 3), generator=gen, device=dev)).contiguous()
    pos_b = (pos_min[None] + 0.5 * jitter).contiguous()  # sigma 0.01 A

    def make_op(n_inner, temperature):
        return fused_step.make_fused_campaign_op(
            ff, n_inner=n_inner, dt_fs=2.0, temperature=temperature,
            gamma_ps=1.0, bias=bias, constraints=cons,
        )

    op1 = make_op(1, 0.0)
    tab = op1.tables
    frc_b = fused_step.campaign_forces_reference(
        pos_b, tab, op1.settings["pair_consts"], op1.settings["bias_consts"], 0
    ).contiguous()

    k1_err = {}
    for n_inner in (1, 2, 5, N_INNER):
        op = make_op(n_inner, 0.0)
        out_k = op(pos_b, vel_b, frc_b, 0, 1)
        torch.cuda.synchronize()
        out_p = fused_step.campaign_advance_reference(
            pos_b, vel_b, frc_b, 0, 1, tab, **op.settings
        )
        errs = [max_err(a, b) for a, b in zip(out_k, out_p)]
        k1_err[n_inner] = errs
        check(all(bool(torch.isfinite(t).all()) for t in out_k),
              f"campaign_advance T=0 n_inner={n_inner}: non-finite output")
        tol_pos = TOL_POS if n_inner <= 5 else TOL_POS_50
        check(errs[0] <= tol_pos and errs[1] <= TOL_VEL and errs[2] <= TOL_FRC,
              f"campaign_advance T=0 n_inner={n_inner}: pos/vel/frc errors {errs}")
    checks["campaign_advance[T=0]"] = {
        f"n_inner={k}": dict(zip(("pos", "vel", "frc"), v)) for k, v in k1_err.items()
    }

    # one launch is reproducible, and 50 steps = 25 + 25
    op50, op25 = make_op(N_INNER, 300.0), make_op(25, 300.0)
    a = op50(pos_b, vel_b, frc_b, 100, 7)
    b = op50(pos_b, vel_b, frc_b, 100, 7)
    h = op25(pos_b, vel_b, frc_b, 100, 7)
    c = op25(*h, 125, 7)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(a, b)), "campaign_advance: two equal launches differ")
    check(all(torch.equal(x, y) for x, y in zip(a, c)),
          "campaign_advance: one launch of 50 steps differs from 25 + 25")

    # the generator
    g = fused_step.campaign_noise(7, 100, N_INNER, N_REPLICAS, n)
    g_two = torch.cat([
        fused_step.campaign_noise(7, 100, 25, N_REPLICAS, n),
        fused_step.campaign_noise(7, 125, 25, N_REPLICAS, n),
    ])
    g_other = fused_step.campaign_noise(8, 100, N_INNER, N_REPLICAS, n)
    g_plain = fused_step.philox_normals(7, 100, N_INNER, N_REPLICAS, n, device=dev)
    torch.cuda.synchronize()

    def corr(x, y):
        return float(torch.corrcoef(torch.stack([x.flatten(), y.flatten()]))[0, 1])

    noise_res = {
        "mean": float(g.mean()), "var": float(g.var()),
        "corr_replicas_0_1": corr(g[:, 0], g[:, 1]),
        "corr_steps_0_1": corr(g[0], g[1]),
        "corr_components_x_y": corr(g[..., 0], g[..., 1]),
        "max_abs": float(g.abs().max()),
        "differs_for_other_seed": float((g - g_other).abs().max()),
        "split_25_25_equal": bool(torch.equal(g, g_two)),
        "err_vs_plain_philox": max_err(g, g_plain),
    }
    checks["noise"] = noise_res
    check(abs(noise_res["mean"]) < 0.01, f"noise mean {noise_res}")
    check(abs(noise_res["var"] - 1.0) < 0.02, f"noise variance {noise_res}")
    for key in ("corr_replicas_0_1", "corr_steps_0_1", "corr_components_x_y"):
        check(abs(noise_res[key]) < 0.05, f"noise {key} {noise_res}")
    check(noise_res["differs_for_other_seed"] > 0.1, "noise: another seed gives the same numbers")
    check(noise_res["split_25_25_equal"], "noise: 50 steps differ from 25 + 25")
    check(noise_res["err_vs_plain_philox"] <= TOL_NOISE, f"noise vs plain Philox {noise_res}")

    # T = 300 K from identical starts: replicas end apart, all finite
    same_pos = pos_min[None].expand(N_REPLICAS, n, 3).contiguous()
    same_vel = torch.zeros_like(same_pos)
    same_frc = fused_step.campaign_forces_reference(
        same_pos[:1], tab, op1.settings["pair_consts"], op1.settings["bias_consts"], 0
    ).expand(N_REPLICAS, n, 3).contiguous()
    hot = op50(same_pos, same_vel, same_frc, 0, 11)
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(t).all()) for t in hot), "campaign_advance T=300: non-finite")
    flat = hot[0].reshape(N_REPLICAS, -1)
    spread = float((flat[1:] - flat[:-1]).abs().amax(dim=1).min())
    check(spread > 1e-4, f"campaign_advance T=300: neighbouring replicas coincide ({spread})")

    # T = 300 K: kernel with (seed, t0) vs plain fed the same normals, over
    # 5 steps and over the main path's 50
    for n_inner, op_hot, tols in (
        (5, make_op(5, 300.0), (TOL_POS, TOL_VEL, TOL_FRC)),
        (N_INNER, op50, (TOL_POS_50, TOL_VEL, TOL_FRC)),
    ):
        out_k = op_hot(pos_b, vel_b, frc_b, 40, 13)
        noise_k = fused_step.campaign_noise(13, 40, n_inner, N_REPLICAS, n)
        out_p = fused_step.campaign_advance_reference(
            pos_b, vel_b, frc_b, 40, 13, op_hot.tables, noise=noise_k, **op_hot.settings
        )
        torch.cuda.synchronize()
        errs = [max_err(x, y) for x, y in zip(out_k, out_p)]
        checks[f"campaign_advance[T=300,n_inner={n_inner},same noise]"] = dict(
            zip(("pos", "vel", "frc"), errs))
        check(all(e <= tol for e, tol in zip(errs, tols)),
              f"campaign_advance T=300 n_inner={n_inner} vs plain with the same noise: "
              f"{errs} (bounds {tols})")
    checks["campaign_advance[T=300]"] = {"min_neighbour_spread_A": spread}

    # three timings: their spread is the noise a vacuum time is read against
    k1_ms_runs = [time_ms(lambda: op50(pos_b, vel_b, frc_b, 0, 3), repeats=5) for _ in range(3)]
    k1_ms = sorted(k1_ms_runs)[1]
    # where a launch's time goes: the same 50 steps without SHAKE/RATTLE
    op50_free = fused_step.make_fused_campaign_op(
        ff, n_inner=N_INNER, dt_fs=2.0, temperature=300.0, gamma_ps=1.0, bias=bias
    )
    k1_free_ms = time_ms(lambda: op50_free(pos_b, vel_b, frc_b, 0, 3), repeats=5)
    plain_settings = op50.settings
    tab50 = op50.tables
    k1_plain_ms = time_ms(
        lambda: fused_step.campaign_advance_reference(
            pos_b, vel_b, frc_b, 0, 3, tab50, **plain_settings),
        repeats=1, warmup=0,
    )
    k1_plain_out = fused_step.campaign_advance_reference(pos_b, vel_b, frc_b, 0, 3, tab50, **plain_settings)
    live_b = live_pair_count(pos_b, tables, pair_consts)
    k1_bound = campaign_bound(
        pos_b, tab, live_b, N_INNER, plain_settings["shake_iters"],
        plain_settings["rattle_iters"], plain_settings["pair_consts"][0])
    kernels["campaign_advance"] = {
        "name": "campaign_advance", "route": "cuda",
        "source": "molecular_dynamics_tpu_torch/csrc/campaign_advance.cu",
        "replaces": "molecular_dynamics_tpu/ops/fused_step.py:775",
        "launches": 0,
        "max_abs_err": k1_err[N_INNER][0], "tolerance": TOL_POS_50,
        "max_abs_err_what": "positions (A) after 50 steps at T=0 vs the plain version",
        "ms": k1_ms, "ms_runs": k1_ms_runs, "plain_ms": k1_plain_ms, **k1_bound,
        "library_ms": None,
        "sfu_bound_ms": sfu_ms(campaign_sfu_ops(
            N_REPLICAS, tab, live_b, N_INNER, plain_settings["shake_iters"],
            plain_settings["rattle_iters"])),
        **build_facts(op50.kernel_info()),
        "shape": [N_REPLICAS, n, 3], "n_inner": N_INNER,
        "ms_without_constraints": k1_free_ms,
        "live_unordered_pairs_at_entry": live_b,
    }
    # another shape through the same kernels: the 22-atom di-alanine
    # (fewer atoms than a warp, its own term counts), 64 replicas, T = 0
    ff2, coords2, _ = dialanine()
    n2 = ff2.n_atoms
    pos2 = (
        torch.as_tensor(coords2, dtype=torch.float32, device=dev)[None]
        + torch.as_tensor(rng.normal(0.0, 0.02, (64, n2, 3)), dtype=torch.float32, device=dev)
    ).contiguous()
    tables2 = nonbonded.build_pair_tables(ff2)
    e_k, f_k = ring.pair_forces(pos2, tables2)
    e_p, f_p = ring.pair_forces_reference(pos2, tables2)
    op2 = fused_step.make_fused_campaign_op(
        ff2, n_inner=5, dt_fs=2.0, temperature=0.0,
        constraints=hydrogen_bond_constraints(ff2),
    )
    vel2 = torch.zeros_like(pos2)
    out_k = op2(pos2, vel2, f_p.contiguous(), 0, 1)
    out_p = fused_step.campaign_advance_reference(
        pos2, vel2, f_p, 0, 1, op2.tables, **op2.settings
    )
    torch.cuda.synchronize()
    errs = [max_err(x, y) for x, y in zip(out_k, out_p)]
    checks["dialanine_22_atoms"] = {
        "pair_force_err": max_err(f_k, f_p), "pair_energy_err": max_err(e_k, e_p),
        **dict(zip(("pos", "vel", "frc"), errs)),
    }
    check(max_err(f_k, f_p) <= TOL_PAIR_FORCE and max_err(e_k, e_p) <= TOL_PAIR_ENERGY,
          f"pair_forces on di-alanine: {checks['dialanine_22_atoms']}")
    check(errs[0] <= TOL_POS and errs[1] <= TOL_VEL and errs[2] <= TOL_FRC,
          f"campaign_advance on di-alanine: {errs}")
    # tables made by build_ff_params: the generated 40-atom backbone, 1024 replicas
    checks["campaign_advance[backbone,40 atoms]"] = backbone_checks = backbone_campaign_check(rng)
    kernels["campaign_advance"]["max_abs_err_backbone_40_atoms"] = backbone_checks["T=0"]["pos"]

    # -- K3: gb_forces and K4: sasa_forces, standalone ----------------------
    eps_s, salt, gamma = (GBIS_CONFIG.solvent_dielectric, GBIS_CONFIG.ion_concentration,
                          GBIS_CONFIG.surface_tension)
    gb_tab = gb.build_gb_tables(ff)
    gb_consts = gb.gb_constants(eps_s, salt)
    sasa_tab = sasa.build_sasa_tables(ff)
    nc = sasa_tab.n_compact
    check(nc == 51, f"expected 51 heavy atoms in the LCPO set, got {nc}")
    sub = pos_pert[:8].double()

    f_k, e_k, b_k = gb.gb_forces(pos_pert, gb_tab, gb_consts)
    torch.cuda.synchronize()
    f_p, e_p, b_p = gb.gb_forces_reference(pos_pert, gb_tab, gb_consts)
    f_gb_plain = f_p
    f_d, e_d, b_d = gb.gb_forces_reference(pos_pert.double(), gb_tab, gb_consts)
    gb_energy = lambda p: solvent.gb_energy(p, ff64, eps_s, salt)
    res = {
        "force_err_kernel_vs_plain": max_err(f_k, f_p),
        "energy_err_kernel_vs_plain": max_err(e_k, e_p),
        "born_err_kernel_vs_plain": max_err(b_k, b_p),
        "force_err_plain_f32_vs_f64": max_err(f_p, f_d),
        "energy_err_plain_f32_vs_f64": max_err(e_p, e_d),
        "force_err_kernel_vs_f64": max_err(f_k, f_d),
        "energy_err_kernel_vs_f64": max_err(e_k, e_d),
        "force_err_plain_f64_vs_autograd": max_err(f_d[:8], _neg_grad(gb_energy, sub)),
        "energy_err_plain_f64_vs_autograd": max_err(e_d[:8], gb_energy(sub)),
        "max_abs_force": float(f_d.abs().max()), "mean_energy": float(e_d.mean()),
    }
    checks["gb_forces"] = res
    check(bool(torch.isfinite(f_k).all() and torch.isfinite(e_k).all()), "gb_forces: non-finite")
    check(res["force_err_kernel_vs_plain"] <= TOL_GB_FORCE, f"gb_forces: {res}")
    check(res["energy_err_kernel_vs_plain"] <= TOL_GB_ENERGY, f"gb_forces: {res}")
    check(res["born_err_kernel_vs_plain"] <= 1e-4, f"gb_forces Born radii: {res}")
    check(res["force_err_plain_f32_vs_f64"] <= TOL_F32_VS_F64, f"gb plain f32/f64: {res}")
    check(res["energy_err_plain_f32_vs_f64"] <= TOL_F32_VS_F64, f"gb plain f32/f64: {res}")
    check(res["force_err_kernel_vs_f64"] <= TOL_F32_VS_F64, f"gb kernel vs f64: {res}")
    check(res["force_err_plain_f64_vs_autograd"] <= TOL_AUTOGRAD_F64, f"gb plain vs autograd: {res}")
    check(res["energy_err_plain_f64_vs_autograd"] <= TOL_AUTOGRAD_F64, f"gb plain vs autograd: {res}")

    k3_ms = time_ms(lambda: gb.gb_forces(pos_pert, gb_tab, gb_consts), repeats=20)
    k3_plain_ms = time_ms(lambda: gb.gb_forces_reference(pos_pert, gb_tab, gb_consts), repeats=3)
    k3_bound, k3_by, k3_flops, k3_bytes = gb_bound_ms(N_REPLICAS, n)
    kernels["gb_forces"] = {
        "name": "gb_forces", "route": "cuda",
        "source": "molecular_dynamics_tpu_torch/csrc/gb_forces.cu",
        "replaces": "molecular_dynamics_tpu/ops/fused_step.py:933",
        "launches": 0,
        "max_abs_err": res["force_err_kernel_vs_plain"], "tolerance": TOL_GB_FORCE,
        "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by,
        "library_ms": None, "sfu_bound_ms": sfu_ms(gb_sfu_ops(N_REPLICAS, n)),
        **build_facts(gb_forces_facts(n)),
        "library_note": "no single PyTorch call computes GB-OBC II forces",
        "shape": [N_REPLICAS, n, 3], "flops": k3_flops, "bytes": k3_bytes,
    }

    f_k, e_k = sasa.sasa_forces(pos_pert, sasa_tab, gamma)
    torch.cuda.synchronize()
    f_p, e_p = sasa.sasa_forces_reference(pos_pert, sasa_tab, gamma)
    f_sasa_plain = f_p
    f_d, e_d = sasa.sasa_forces_reference(pos_pert.double(), sasa_tab, gamma)
    sasa_energy = lambda p: solvent.sasa_energy(p, ff64, gamma)
    gated = int((solvent.sasa(pos_pert, ff)[:, sasa_tab.idx.long()] <= 0).sum())
    res = {
        "force_err_kernel_vs_plain": max_err(f_k, f_p),
        "energy_err_kernel_vs_plain": max_err(e_k, e_p),
        "force_err_plain_f32_vs_f64": max_err(f_p, f_d),
        "energy_err_plain_f32_vs_f64": max_err(e_p, e_d),
        "force_err_kernel_vs_f64": max_err(f_k, f_d),
        "force_err_plain_f64_vs_autograd": max_err(f_d[:8], _neg_grad(sasa_energy, sub)),
        "energy_err_plain_f64_vs_autograd": max_err(e_d[:8], sasa_energy(sub)),
        "max_abs_force": float(f_d.abs().max()), "mean_energy": float(e_d.mean()),
        "atoms_gated_to_zero_area": gated,
    }
    # the packaged geometry gates no atom: cut P1 of every third heavy atom to
    # a tenth, so that areas go negative and the kernel's gate is exercised
    atom_gated = sasa_tab.atom.clone()
    atom_gated[::3, 1] *= 0.1
    atom64_gated = sasa_tab.atom64.clone()
    atom64_gated[::3, 1] = atom_gated[::3, 1].double()
    tab_gated = sasa.SasaTables(idx=sasa_tab.idx, atom=atom_gated.contiguous(),
                                atom64=atom64_gated, n_atoms=n)
    fg_k, eg_k = sasa.sasa_forces(pos_pert, tab_gated, gamma)
    fg_p, eg_p = sasa.sasa_forces_reference(pos_pert, tab_gated, gamma)
    res["gated_case_force_err_kernel_vs_plain"] = max_err(fg_k, fg_p)
    res["gated_case_energy_err_kernel_vs_plain"] = max_err(eg_k, eg_p)
    res["gated_case_force_differs_by"] = max_err(fg_p, f_p)
    # above 48 KB of shared memory, where the kernel opts in to more: two
    # tiled copies, 102 heavy atoms, 64 replicas
    ff_t2, coords_t2, _ = tiled_decaalanine(2)
    tab_t2 = sasa.build_sasa_tables(ff_t2)
    pos_t2 = jittered(coords_t2, 64, np.random.default_rng(SEED + 2))
    ft_k, et_k = sasa.sasa_forces(pos_t2, tab_t2, gamma)
    ft_p, et_p = sasa.sasa_forces_reference(pos_t2, tab_t2, gamma)
    torch.cuda.synchronize()
    res["tiled_2_shared_bytes"] = sasa.sasa_shared_bytes(tab_t2.n_compact) + 24 * ff_t2.n_atoms
    res["tiled_2_force_err_kernel_vs_plain"] = max_err(ft_k, ft_p)
    res["tiled_2_energy_err_kernel_vs_plain"] = max_err(et_k, et_p)
    check(res["tiled_2_shared_bytes"] > 48 * 1024, f"sasa_forces tiled: {res}")
    check(res["tiled_2_force_err_kernel_vs_plain"] <= TOL_SASA_FORCE
          and res["tiled_2_energy_err_kernel_vs_plain"] <= 2 * TOL_SASA_ENERGY,
          f"sasa_forces above 48 KB of shared memory: {res}")
    # at 102 heavy atoms a list holds 64 of the 101 possible neighbours: the
    # pair pressed to a tenth about its centre overlaps up to 101, and the
    # wrapper must raise instead of returning a truncated force
    centre = pos_t2[:1].mean(1, keepdim=True)
    squeezed = (centre + 0.1 * (pos_t2[:1] - centre)).contiguous()
    res["tiled_2_squeezed_max_degree"] = int(sasa.sasa_overlaps(squeezed, tab_t2).sum(-1).max())
    try:
        sasa.sasa_forces(squeezed, tab_t2, gamma)
        res["tiled_2_squeezed_raised"] = False
    except RuntimeError as exc:
        res["tiled_2_squeezed_raised"] = "neighbour list" in str(exc)
    check(res["tiled_2_squeezed_max_degree"] > sasa.sasa_capacity(tab_t2.n_compact)
          and res["tiled_2_squeezed_raised"],
          f"sasa_forces: an overflowing neighbour list did not raise: {res}")
    # the GB kernel on the same pair: 208 atoms, without its dI cache (which
    # alone would take 172 KB)
    gb_t2 = gb.build_gb_tables(ff_t2)
    fb_k, eb_k, _ = gb.gb_forces(pos_t2, gb_t2, gb_consts)
    fb_p, eb_p, _ = gb.gb_forces_reference(pos_t2, gb_t2, gb_consts)
    torch.cuda.synchronize()
    checks["gb_forces[208 atoms]"] = {
        "shared_bytes": gb.gb_shared_bytes(ff_t2.n_atoms, gb.gb_cached(ff_t2.n_atoms))
        + 24 * ff_t2.n_atoms, "gb_cached": gb.gb_cached(ff_t2.n_atoms),
        "force_err_kernel_vs_plain": max_err(fb_k, fb_p),
        "energy_err_kernel_vs_plain": max_err(eb_k, eb_p)}
    check(checks["gb_forces[208 atoms]"]["force_err_kernel_vs_plain"] <= TOL_GB_FORCE
          and checks["gb_forces[208 atoms]"]["energy_err_kernel_vs_plain"] <= 2 * TOL_GB_ENERGY,
          f"gb_forces at 208 atoms: {checks['gb_forces[208 atoms]']}")
    checks["sasa_forces"] = res
    check(bool(torch.isfinite(f_k).all() and torch.isfinite(e_k).all()), "sasa_forces: non-finite")
    check(res["force_err_kernel_vs_plain"] <= TOL_SASA_FORCE, f"sasa_forces: {res}")
    check(res["energy_err_kernel_vs_plain"] <= TOL_SASA_ENERGY, f"sasa_forces: {res}")
    check(res["gated_case_force_err_kernel_vs_plain"] <= TOL_SASA_FORCE, f"sasa_forces gated: {res}")
    check(res["gated_case_energy_err_kernel_vs_plain"] <= TOL_SASA_ENERGY, f"sasa_forces gated: {res}")
    check(res["gated_case_force_differs_by"] > 1e-3, f"sasa_forces: the gated case gates nothing: {res}")
    check(res["force_err_plain_f32_vs_f64"] <= TOL_F32_VS_F64, f"sasa plain f32/f64: {res}")
    check(res["energy_err_plain_f32_vs_f64"] <= TOL_F32_VS_F64, f"sasa plain f32/f64: {res}")
    check(res["force_err_plain_f64_vs_autograd"] <= TOL_AUTOGRAD_F64, f"sasa plain vs autograd: {res}")
    check(res["energy_err_plain_f64_vs_autograd"] <= TOL_AUTOGRAD_F64, f"sasa plain vs autograd: {res}")

    k4_ms = time_ms(lambda: sasa.sasa_forces(pos_pert, sasa_tab, gamma), repeats=20)
    k4_plain_ms = time_ms(lambda: sasa.sasa_forces_reference(pos_pert, sasa_tab, gamma), repeats=3)
    work = sasa_work(pos_pert, sasa_tab)
    k4_bound, k4_by, k4_flops, k4_bytes = sasa_bound_ms(N_REPLICAS, n, nc, work)
    kernels["sasa_forces"] = {
        "name": "sasa_forces", "route": "cuda",
        "source": "molecular_dynamics_tpu_torch/csrc/sasa_forces.cu",
        "replaces": "molecular_dynamics_tpu/ops/fused_step.py:1290",
        "launches": 0,
        "max_abs_err": res["force_err_kernel_vs_plain"], "tolerance": TOL_SASA_FORCE,
        "ms": k4_ms, "plain_ms": k4_plain_ms, "bound_ms": k4_bound, "bound_by": k4_by,
        "library_ms": None, "sfu_bound_ms": sfu_ms(sasa_sfu_ops(N_REPLICAS, nc)),
        **build_facts(_build.kernel_info(
            "sasa_forces", "mdx_sasa_forces_info", [ctypes.c_int] * 3, n, nc,
            int(sasa.sasa_lists_global(n, nc)))),
        "list_capacity": sasa.sasa_capacity(nc),
        "largest_heavy_atom_count": max_heavy_atoms(n / nc),
        "largest_heavy_atom_count_lists_in_shared": max_heavy_atoms(n / nc, lists_global=False),
        "library_note": "the two (nc, nc) products alone could be torch.bmm; the function "
                        "as a whole (overlap test, gate, cotangent, forces) has no single call",
        "shape": [N_REPLICAS, n, 3], "compact_atoms": nc, "flops": k4_flops, "bytes": k4_bytes,
        "overlapping_ordered_pairs": work[0], "b_sum_terms": work[1], "w_sum_terms": work[2],
        "mean_neighbours_per_heavy_atom": work[0] / (N_REPLICAS * nc),
    }

    # -- K1 with GB and SASA on (GBIS_CONFIG) -------------------------------
    def make_gbis_op(n_inner, temperature, constraints=cons, **kw):
        return fused_step.make_fused_campaign_op(
            ff, n_inner=n_inner, dt_fs=2.0, temperature=temperature, gamma_ps=1.0,
            cutoff=GBIS_CONFIG.cutoff, switch_dist=GBIS_CONFIG.switch_dist,
            rfa=GBIS_CONFIG.rfa, solvent_dielectric=eps_s, ion_concentration=salt,
            surface_tension=gamma, bias=bias, constraints=constraints,
            **{"gb": True, "sasa": True, **kw},
        )

    def against_plain(op, t0, seed, noise=None):
        out_k = op(pos_b, vel_b, frc_g, t0, seed)
        torch.cuda.synchronize()
        out_p = fused_step.campaign_advance_reference(
            pos_b, vel_b, frc_g, t0, seed, op.tables, noise=noise, **op.settings)
        check(all(bool(torch.isfinite(x).all()) for x in out_k), "GBIS campaign_advance: non-finite")
        return out_k, [max_err(x, y) for x, y in zip(out_k, out_p)]

    def hold(name, errs, n_inner):
        tols = (TOL_POS if n_inner <= 5 else TOL_POS_50, TOL_VEL, TOL_FRC)
        checks[name] = dict(zip(("pos", "vel", "frc"), errs))
        check(all(e <= tol for e, tol in zip(errs, tols)), f"{name}: {errs} (bounds {tols})")

    g1 = make_gbis_op(1, 0.0)
    gs = g1.settings
    frc_g = fused_step.campaign_forces_reference(
        pos_b, g1.tables, gs["pair_consts"], gs["bias_consts"], 0, gs["gb_consts"],
        gs["surface_tension"]).contiguous()
    kg_err = {}
    for n_inner in (1, 2, 5, N_INNER):
        _, errs = against_plain(make_gbis_op(n_inner, 0.0), 0, 1)
        kg_err[n_inner] = errs
        hold(f"campaign_advance[gbis,T=0,n_inner={n_inner}]", errs, n_inner)
    g50 = make_gbis_op(N_INNER, 300.0)
    noise_k = fused_step.campaign_noise(13, 40, N_INNER, N_REPLICAS, n)
    _, errs = against_plain(g50, 40, 13, noise=noise_k)
    hold(f"campaign_advance[gbis,T=300,n_inner={N_INNER},same noise]", errs, N_INNER)
    g50_s5 = make_gbis_op(N_INNER, 300.0, sasa_every=5)
    _, errs = against_plain(g50_s5, 40, 13, noise=noise_k)
    hold(f"campaign_advance[gbis,sasa_every=5,T=300,n_inner={N_INNER},same noise]", errs, N_INNER)
    _, errs = against_plain(make_gbis_op(N_INNER, 0.0, sasa_every=5), 0, 1)
    hold(f"campaign_advance[gbis,sasa_every=5,T=0,n_inner={N_INNER}]", errs, N_INNER)
    g50_g2 = make_gbis_op(N_INNER, 300.0, gb_every=2, sasa_every=2)
    _, errs = against_plain(make_gbis_op(N_INNER, 0.0, gb_every=2, sasa_every=2), 0, 1)
    hold(f"campaign_advance[gbis,gb_every=2,sasa_every=2,T=0,n_inner={N_INNER}]", errs, N_INNER)
    _, errs = against_plain(make_gbis_op(10, 0.0, gb_every=2), 0, 1)
    hold("campaign_advance[gbis,gb_every=2,sasa_every=1,T=0,n_inner=10]", errs, 10)

    # one launch is reproducible and 50 steps = 25 + 25 bit for bit, with GB
    # and SASA on every step and with the held SASA force. The impulse form
    # takes the slow force off the carried force and puts it back in float32
    # at every launch boundary, so there 25 + 25 agrees to rounding only.
    for label, kw, exact in (("", {}, True), ("sasa_every=5", dict(sasa_every=5), True),
                             ("gb_every=5", dict(gb_every=5, sasa_every=5), False)):
        op_a, op_h = make_gbis_op(N_INNER, 300.0, **kw), make_gbis_op(25, 300.0, **kw)
        a = op_a(pos_b, vel_b, frc_g, 100, 7)
        b = op_a(pos_b, vel_b, frc_g, 100, 7)
        c = op_h(*op_h(pos_b, vel_b, frc_g, 100, 7), 125, 7)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"GBIS campaign_advance {label}: two equal launches differ")
        split = [max_err(x, y) for x, y in zip(a, c)]
        checks[f"campaign_advance[gbis,{label}] 50 vs 25+25"] = dict(zip(("pos", "vel", "frc"), split))
        if exact:
            check(all(torch.equal(x, y) for x, y in zip(a, c)),
                  f"GBIS campaign_advance {label}: 50 steps differ from 25 + 25: {split}")
        else:
            check(split[0] <= TOL_POS_50 and split[1] <= TOL_VEL and split[2] <= TOL_FRC,
                  f"GBIS campaign_advance {label}: 50 steps vs 25 + 25: {split}")

    variants = {
        "vacuum_16A": make_gbis_op(N_INNER, 300.0, gb=False, sasa=False),
        "gb": make_gbis_op(N_INNER, 300.0, sasa=False),
        "sasa": make_gbis_op(N_INNER, 300.0, gb=False),
        "gb+sasa": g50,
        "gb+sasa,sasa_every=5": g50_s5,
        "gb+sasa,gb_every=2,sasa_every=2": g50_g2,
        "gb+sasa,no_constraints": make_gbis_op(N_INNER, 300.0, constraints=None),
        "vacuum_16A,no_constraints": make_gbis_op(N_INNER, 300.0, constraints=None, gb=False, sasa=False),
    }
    gbis_ms = {name: time_ms(lambda op=op: op(pos_b, vel_b, frc_g, 0, 3), repeats=3)
               for name, op in variants.items()}
    kg_plain_ms = time_ms(
        lambda: fused_step.campaign_advance_reference(
            pos_b, vel_b, frc_g, 0, 3, g50.tables, **g50.settings),
        repeats=1, warmup=0,
    )
    g50_plain = fused_step.campaign_advance_reference(
        pos_b, vel_b, frc_g, 0, 3, g50.tables, **g50.settings)
    pair_consts_g = gs["pair_consts"]
    live_g = live_pair_count(pos_b, tables, pair_consts_g)
    work_b = sasa_work(pos_b, sasa_tab)
    fast = campaign_bound(pos_b, g1.tables, live_g, N_INNER, gs["shake_iters"],
                          gs["rattle_iters"], pair_consts_g[0])
    kg_bytes = fast["bytes"]
    kg_flops = fast["flops"] + N_INNER * (
        gb_bound_ms(N_REPLICAS, n, with_energy=False)[2] + sasa_flops(N_REPLICAS, nc, work_b))
    kg_bytes += n * 5 * 4 + nc * 24
    kg_bound = 1e3 * max(kg_flops / PEAK_F32_FLOPS, kg_bytes / PEAK_BYTES_PER_S)
    kg_sfu = campaign_sfu_ops(N_REPLICAS, g1.tables, live_g, N_INNER, gs["shake_iters"],
                              gs["rattle_iters"]) + N_INNER * (
        gb_sfu_ops(N_REPLICAS, n) + sasa_sfu_ops(N_REPLICAS, nc))
    # a GBIS launch taken apart by differences of whole-kernel times
    split = {
        "fast_part": gbis_ms["vacuum_16A"],
        "constraints": gbis_ms["vacuum_16A"] - gbis_ms["vacuum_16A,no_constraints"],
        "gb": gbis_ms["gb"] - gbis_ms["vacuum_16A"],
        "lcpo": gbis_ms["gb+sasa"] - gbis_ms["gb"],
        "lcpo_without_gb": gbis_ms["sasa"] - gbis_ms["vacuum_16A"],
        "lcpo_sasa_every_5": gbis_ms["gb+sasa,sasa_every=5"] - gbis_ms["gb"],
    }
    kernels["campaign_advance[gbis]"] = {
        "name": "campaign_advance[gbis]", "route": "cuda",
        "source": "molecular_dynamics_tpu_torch/csrc/campaign_advance.cu",
        "replaces": "molecular_dynamics_tpu/ops/fused_step.py:775",
        "launches": 0,
        "max_abs_err": kg_err[N_INNER][0], "tolerance": TOL_POS_50,
        "max_abs_err_what": "positions (A) after 50 steps at T=0 with GB and SASA vs the plain version",
        "ms": gbis_ms["gb+sasa"], "plain_ms": kg_plain_ms, "bound_ms": kg_bound,
        "bound_by": "operations" if kg_flops / PEAK_F32_FLOPS >= kg_bytes / PEAK_BYTES_PER_S else "bytes",
        "library_ms": None, "sfu_bound_ms": sfu_ms(kg_sfu),
        **build_facts(g50.kernel_info()),
        "build_facts_sasa_every_5": build_facts(g50_s5.kernel_info()),
        "shape": [N_REPLICAS, n, 3], "n_inner": N_INNER, "flops": kg_flops, "bytes": kg_bytes,
        "ms_by_variant": gbis_ms, "split_ms": split, "shared_bytes": g50.shared_bytes,
        "shared_bytes_with_cadence": g50_s5.shared_bytes,
        "live_unordered_pairs_at_entry": live_g,
    }

    # -- what each lever of the redesign buys (ablation, see LEVERS) --------
    t_lev = time.perf_counter()
    levers = levers_phase(lever_libs, {
        "gb_forces": (lambda: gb.gb_forces(pos_pert, gb_tab, gb_consts),
                      lambda out: max_err(out[0], f_gb_plain), None),
        "sasa_forces": (lambda: sasa.sasa_forces(pos_pert, sasa_tab, gamma),
                        lambda out: max_err(out[0], f_sasa_plain), None),
        "campaign_advance[gbis]": (lambda: g50(pos_b, vel_b, frc_g, 0, 3),
                                   lambda out: max_err(out[0], g50_plain[0]), g50.kernel_info),
        "campaign_advance[vacuum]": (lambda: op50(pos_b, vel_b, frc_b, 0, 3),
                                     lambda out: max_err(out[0], k1_plain_out[0]), op50.kernel_info),
        "pair_forces": (lambda: ring.pair_forces(pos_pert, tables, **ref_kw),
                        lambda out: max_err(out[1], k2_plain[1]), None),
    })
    # where a vacuum launch's time goes: differences of whole-kernel times
    split_rows = {label[len("split: no "):]: levers[f"campaign_advance[vacuum]: {label}"]
                  for label, _, _ in LEVERS if label.startswith("split: ")
                  and f"campaign_advance[vacuum]: {label}" in levers}
    split = {part: row["ms_built"] - row["ms_variant"] for part, row in split_rows.items()}
    split["constraints"] = k1_ms - k1_free_ms
    split["rest"] = k1_ms - sum(split.values())
    kernels["campaign_advance"]["split_ms"] = split
    hold_levers(levers, {"gb_forces": TOL_GB_FORCE, "sasa_forces": TOL_SASA_FORCE,
                         "campaign_advance[gbis]": TOL_POS_50,
                         "campaign_advance[vacuum]": TOL_POS_50, "pair_forces": TOL_PAIR_FORCE})
    emit("levers", seconds=round(time.perf_counter() - t_lev, 1), **levers,
         **{f"skipped: {k}": v for k, v in lever_builds[1].items()},
         device=torch.cuda.get_device_name(0), nvidia_smi=smi)

    # the 22-atom di-alanine (10 heavy atoms: one mask word, fewer atoms than
    # a warp) through K3, K4 and the GBIS campaign kernel, 64 replicas, T = 0
    gb_tab2, sasa_tab2 = gb.build_gb_tables(ff2), sasa.build_sasa_tables(ff2)
    f_k, e_k, _ = gb.gb_forces(pos2, gb_tab2, gb_consts)
    f_p, e_p, _ = gb.gb_forces_reference(pos2, gb_tab2, gb_consts)
    s_k, se_k = sasa.sasa_forces(pos2, sasa_tab2, gamma)
    s_p, se_p = sasa.sasa_forces_reference(pos2, sasa_tab2, gamma)
    res = {"gb_force_err": max_err(f_k, f_p), "gb_energy_err": max_err(e_k, e_p),
           "sasa_force_err": max_err(s_k, s_p), "sasa_energy_err": max_err(se_k, se_p)}
    check(res["gb_force_err"] <= TOL_GB_FORCE and res["gb_energy_err"] <= TOL_GB_ENERGY
          and res["sasa_force_err"] <= TOL_SASA_FORCE and res["sasa_energy_err"] <= TOL_SASA_ENERGY,
          f"gb_forces / sasa_forces on di-alanine: {res}")
    for label, kw in (("", {}), (",sasa_every=5", dict(sasa_every=5)),
                      (",gb_every=5", dict(gb_every=5, sasa_every=5))):
        op2g = fused_step.make_fused_campaign_op(
            ff2, n_inner=5, dt_fs=2.0, temperature=0.0, cutoff=GBIS_CONFIG.cutoff,
            switch_dist=GBIS_CONFIG.switch_dist, rfa=GBIS_CONFIG.rfa, solvent_dielectric=eps_s,
            ion_concentration=salt, surface_tension=gamma,
            constraints=hydrogen_bond_constraints(ff2), gb=True, sasa=True, **kw)
        s2 = op2g.settings
        frc2 = fused_step.campaign_forces_reference(
            pos2, op2g.tables, s2["pair_consts"], s2["bias_consts"], 0, s2["gb_consts"],
            s2["surface_tension"]).contiguous()
        out_k = op2g(pos2, vel2, frc2, 0, 1)
        out_p = fused_step.campaign_advance_reference(pos2, vel2, frc2, 0, 1, op2g.tables, **s2)
        torch.cuda.synchronize()
        errs = [max_err(x, y) for x, y in zip(out_k, out_p)]
        res[f"campaign{label}"] = dict(zip(("pos", "vel", "frc"), errs))
        check(errs[0] <= TOL_POS and errs[1] <= TOL_VEL and errs[2] <= TOL_FRC,
              f"GBIS campaign_advance{label} on di-alanine: {errs}")
    checks["dialanine_22_atoms[gbis]"] = res

    # the tiled pair (208 atoms, 102 heavy) through the GBIS campaign kernel:
    # its lists can overflow there, so the wrapper reads the flag every launch
    cons_t2 = hydrogen_bond_constraints(ff_t2)
    op_t2 = fused_step.make_fused_campaign_op(
        ff_t2, n_inner=5, dt_fs=2.0, temperature=0.0, cutoff=GBIS_CONFIG.cutoff,
        switch_dist=GBIS_CONFIG.switch_dist, rfa=GBIS_CONFIG.rfa, solvent_dielectric=eps_s,
        ion_concentration=salt, surface_tension=gamma, constraints=cons_t2, gb=True, sasa=True)
    st2 = op_t2.settings
    pos8 = pos_t2[:8].contiguous()
    frc8 = fused_step.campaign_forces_reference(
        pos8, op_t2.tables, st2["pair_consts"], st2["bias_consts"], 0, st2["gb_consts"],
        st2["surface_tension"]).contiguous()
    vel8 = torch.zeros_like(pos8)
    out_k = op_t2(pos8, vel8, frc8, 0, 1)
    out_p = fused_step.campaign_advance_reference(pos8, vel8, frc8, 0, 1, op_t2.tables, **st2)
    torch.cuda.synchronize()
    errs = [max_err(x, y) for x, y in zip(out_k, out_p)]
    checks["campaign_advance[gbis,208 atoms,T=0,n_inner=5]"] = {
        **dict(zip(("pos", "vel", "frc"), errs)), "shared_bytes": op_t2.shared_bytes,
        "lists_can_overflow": sasa.overflow_possible(op_t2.tables.sasa.n_compact)}
    check(errs[0] <= TOL_POS and errs[1] <= TOL_VEL and errs[2] <= TOL_FRC,
          f"GBIS campaign_advance at 208 atoms: {errs}")

    # -- K5: nonbonded_rows and K6: pair_tiles, and K2 at their shapes -------
    pair_op_err = pair_op_checks(rng, checks)
    kernels["pair_forces"]["max_abs_err_at_pair_op_shapes"] = pair_op_err["pair_forces"]
    kernels["pair_forces"]["max_abs_err"] = max(
        kernels["pair_forces"]["max_abs_err"], pair_op_err["pair_forces"])

    emit("checks", fire_seconds=round(fire_s, 2), e_min=e_min, **checks)

    # -- the main path -------------------------------------------------------
    gen.manual_seed(0)
    vel = maxwell_boltzmann(gen, ff.masses, 300.0)
    state = system_init(pos_min, vel=vel, key=0)
    state = initialize_forces(
        state,
        lambda p, box: _neg_grad(
            lambda q: total_energy(q, ff, config=REFERENCE_CONFIG) + bias.energy(q, 0), p
        ),
    )
    ens = replicate(state, N_REPLICAS, seed=1)
    cfg = SimulationConfig(
        dt_fs=2.0, temperature=300.0, fused_campaign=True, constrain_h_bonds=True
    )

    reset_launches()
    t0 = time.perf_counter()
    final, frames, log = simulate_ensemble(
        ens, ff, n_steps=N_STEPS, save_every=N_INNER, config=cfg, bias=bias
    )
    torch.cuda.synchronize()
    launches_k1 = fused_step.campaign_advance.launches
    first_s = time.perf_counter() - t0
    kernels["campaign_advance"]["launches"] = launches_k1
    kernels["campaign_advance"]["launches_of"] = (
        f"simulate_ensemble(fused_campaign), {N_REPLICAS} replicas x {N_STEPS} steps")

    # B2 runs as the pair loop of csrc/pair_loop.cuh inside every step of
    # every launch above; the standalone pair_forces kernel launches that loop
    # alone and has no path of its own (fused_nonbonded takes K5, K6)
    kernels["pair_forces"]["device_function_in"] = (
        f"campaign_advance: its {launches_k1} launches on the main path run "
        f"pair_rounds and special_sum every step")

    # the composed pair-op path at the main shape: the same entry point with
    # fused_nonbonded (2-body terms from one pair_tiles launch a step, angles
    # and torsions from the angle-torsion op, the bias from autograd)
    cfg_pair = SimulationConfig(
        dt_fs=2.0, temperature=300.0, fused_nonbonded=True, constrain_h_bonds=True
    )
    ring.pair_tiles.launches = 0
    _, fr_pair, _ = simulate_ensemble(
        ens, ff, n_steps=PAIR_PATH_STEPS, save_every=2, config=cfg_pair, bias=bias)
    torch.cuda.synchronize()
    launches_k6_main = ring.pair_tiles.launches

    n_saves = N_STEPS // N_INNER
    check(tuple(frames.shape) == (n_saves, N_REPLICAS, n, 3), f"frames shape {tuple(frames.shape)}")
    check(bool(torch.isfinite(frames).all()), "campaign: non-finite frames")
    check(launches_k1 == n_saves, f"campaign kernel launched {launches_k1} times, expected {n_saves}")
    pairs = cons.pairs
    last = frames[-1]
    bond = torch.linalg.norm(last[:, pairs[:, 0]] - last[:, pairs[:, 1]], dim=-1)
    violation = float((bond - cons.lengths[None]).abs().max())
    check(violation < 1e-5, f"max X-H constraint violation {violation} A")
    t_mean = float(log["T"][-1].mean())
    check(150.0 < t_mean < 350.0, f"ensemble-mean T of the last save {t_mean} K")
    lag = float((log["colvar_value"][-1] - log["colvar_center"][-1]).abs().mean())
    check(lag < 2.0, f"mean |colvar - centre| {lag} A")
    flat = last.reshape(N_REPLICAS, -1)
    spread = float((flat[1:] - flat[:-1]).abs().amax(dim=1).min())
    check(spread > 1e-3, f"campaign: neighbouring replicas coincide ({spread})")
    check(int(final.step[0]) == N_STEPS, f"final step {int(final.step[0])}")

    cfg_auto = SimulationConfig(dt_fs=2.0, temperature=300.0, constrain_h_bonds=True)
    _, fr_auto, _ = simulate_ensemble(
        ens, ff, n_steps=PAIR_PATH_STEPS, save_every=2, config=cfg_auto, bias=bias)
    torch.cuda.synchronize()
    # the standalone kernel's own count over the campaign phase's three paths
    kernels["pair_forces"]["launches"] = ring.pair_forces.launches
    kernels["pair_forces"]["launches_of"] = (
        "simulate_ensemble: fused_campaign, fused_nonbonded and autograd at the main "
        "shape; none of them launches the standalone kernel")
    composed_err = max_err(fr_pair, fr_auto)
    check(launches_k6_main == PAIR_PATH_STEPS,
          f"pair_tiles launched {launches_k6_main} times, expected {PAIR_PATH_STEPS}")
    check(composed_err < 1e-4, f"fused_nonbonded vs autograd composed path: {composed_err} A")

    t0 = time.perf_counter()
    final2, frames2, _ = simulate_ensemble(
        final, ff, n_steps=N_STEPS, save_every=N_INNER, config=cfg, bias=bias
    )
    torch.cuda.synchronize()
    timed_s = time.perf_counter() - t0
    check(bool(torch.isfinite(frames2).all()), "campaign (timed call): non-finite frames")
    t0 = time.perf_counter()
    simulate_ensemble(final2, ff, n_steps=N_STEPS, save_every=N_INNER, config=cfg,
                      bias=bias, obs_every=n_saves)
    torch.cuda.synchronize()
    timed_sparse_obs_s = time.perf_counter() - t0

    emit("campaign", replicas=N_REPLICAS, atoms=n, steps=N_STEPS, save_every=N_INNER,
         frames=list(frames.shape), campaign_kernel_launches=launches_k1,
         pair_tiles_launches=launches_k6_main,
         max_constraint_violation_A=violation, T_last_mean_K=t_mean,
         colvar_lag_A=lag, colvar_last_mean_A=float(log["colvar_value"][-1].mean()),
         colvar_center_last_A=float(log["colvar_center"][-1].mean()),
         min_neighbour_spread_A=spread,
         fused_nonbonded_vs_autograd_A=composed_err,
         first_call_seconds=first_s, timed_call_seconds=timed_s,
         aggregate_steps_per_s=N_STEPS * N_REPLICAS / timed_s,
         timed_call_obs_once_seconds=timed_sparse_obs_s,
         aggregate_steps_per_s_obs_once=N_STEPS * N_REPLICAS / timed_sparse_obs_s,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         script_seconds=round(time.perf_counter() - t_script, 1))

    # -- the implicit-solvent main path: the GBIS campaign ---------------------
    force_g = mdx.force_fn(GBIS_CONFIG)
    t0 = time.perf_counter()
    pos_g = minimize_fire(
        torch.as_tensor(coords, dtype=torch.float32, device=dev),
        lambda p: force_g(p, ff), n_steps=500, dt_start=1e-3, dt_max=1e-2,
    )
    torch.cuda.synchronize()
    fire_g_s = time.perf_counter() - t0
    terms_g = {k: float(v) for k, v in energy_terms(pos_g, ff, config=GBIS_CONFIG).items()}
    check(all(np.isfinite(v) for v in terms_g.values()), "FIRE under GBIS_CONFIG diverged")
    check(terms_g["gb"] < 0.0 < terms_g["sasa"], f"GBIS energy terms {terms_g}")
    d0_g = float(torch.linalg.norm(pos_g[-1] - pos_g[0]))
    bias_g = HarmonicSMDBias.create(
        n_atoms=n, group1=[0], group2=[n - 1], fk=1.0,
        cent_0=d0_g, cent_1=d0_g + 22.0, T=500_000.0,
    )
    gen.manual_seed(0)
    state_g = system_init(pos_g, vel=maxwell_boltzmann(gen, ff.masses, 300.0), key=0)
    state_g = initialize_forces(
        state_g,
        lambda p, box: _neg_grad(
            lambda q: total_energy(q, ff, config=GBIS_CONFIG) + bias_g.energy(q, 0), p
        ),
    )
    ens_g = replicate(state_g, N_REPLICAS, seed=1)
    gbis_runs = {}
    finals_g = {}
    for every in (1, 5):
        cfg_g = SimulationConfig(
            dt_fs=2.0, temperature=300.0, energy=GBIS_CONFIG, fused_campaign=True,
            constrain_h_bonds=True, sasa_every=every,
        )
        reset_launches()
        t0 = time.perf_counter()
        final_g, frames_g, log_g = simulate_ensemble(
            ens_g, ff, n_steps=N_STEPS, save_every=N_INNER, config=cfg_g, bias=bias_g)
        torch.cuda.synchronize()
        launches_g = fused_step.campaign_advance.launches
        first_g_s = time.perf_counter() - t0
        tag = f"GBIS campaign sasa_every={every}"
        check(tuple(frames_g.shape) == (n_saves, N_REPLICAS, n, 3), f"{tag}: frames {tuple(frames_g.shape)}")
        check(bool(torch.isfinite(frames_g).all()), f"{tag}: non-finite frames")
        check(launches_g == n_saves, f"{tag}: kernel launched {launches_g} times, expected {n_saves}")
        last = frames_g[-1]
        bond = torch.linalg.norm(last[:, pairs[:, 0]] - last[:, pairs[:, 1]], dim=-1)
        violation_g = float((bond - cons.lengths[None]).abs().max())
        check(violation_g < 1e-5, f"{tag}: max X-H constraint violation {violation_g} A")
        t_g = float(log_g["T"][-1].mean())
        check(150.0 < t_g < 350.0, f"{tag}: ensemble-mean T of the last save {t_g} K")
        lag_g = float((log_g["colvar_value"][-1] - log_g["colvar_center"][-1]).abs().mean())
        check(lag_g < 2.0, f"{tag}: mean |colvar - centre| {lag_g} A")
        flat = last.reshape(N_REPLICAS, -1)
        spread_g = float((flat[1:] - flat[:-1]).abs().amax(dim=1).min())
        check(spread_g > 1e-3, f"{tag}: neighbouring replicas coincide ({spread_g})")
        check(int(final_g.step[0]) == N_STEPS, f"{tag}: final step {int(final_g.step[0])}")
        t0 = time.perf_counter()
        final_g2, frames_g2, _ = simulate_ensemble(
            final_g, ff, n_steps=N_STEPS, save_every=N_INNER, config=cfg_g, bias=bias_g)
        torch.cuda.synchronize()
        timed_g_s = time.perf_counter() - t0
        check(bool(torch.isfinite(frames_g2).all()), f"{tag} (timed call): non-finite frames")
        t0 = time.perf_counter()
        simulate_ensemble(final_g2, ff, n_steps=N_STEPS, save_every=N_INNER, config=cfg_g,
                          bias=bias_g, obs_every=n_saves)
        torch.cuda.synchronize()
        timed_g_sparse_s = time.perf_counter() - t0
        finals_g[every] = (cfg_g, final_g2)
        gbis_runs[f"sasa_every={every}"] = dict(
            campaign_kernel_launches=launches_g, max_constraint_violation_A=violation_g,
            T_last_mean_K=t_g, colvar_lag_A=lag_g, min_neighbour_spread_A=spread_g,
            epot_last_mean=float(log_g["epot"][-1].mean()),
            first_call_seconds=first_g_s, timed_call_seconds=timed_g_s,
            aggregate_steps_per_s=N_STEPS * N_REPLICAS / timed_g_s,
            timed_call_obs_once_seconds=timed_g_sparse_s,
            aggregate_steps_per_s_obs_once=N_STEPS * N_REPLICAS / timed_g_sparse_s,
        )
        if every == 1:
            kernels["campaign_advance[gbis]"]["launches"] = launches_g
            kernels["campaign_advance[gbis]"]["launches_of"] = (
                f"simulate_ensemble(fused_campaign, GBIS_CONFIG), {N_REPLICAS} replicas x "
                f"{N_STEPS} steps; as many again at sasa_every=5")

    # the GB and SASA kernels' own path: the same entry point on its composed
    # per-step path (GB and LCPO forces from one gb_forces and one
    # sasa_forces launch a step, the rest from autograd), at the main shape
    cfg_solv = SimulationConfig(
        dt_fs=2.0, temperature=300.0, energy=GBIS_CONFIG, constrain_h_bonds=True)
    reset_launches()
    final_solv, fr_solv, _ = simulate_ensemble(
        ens_g, ff, n_steps=SOLVENT_PATH_STEPS, save_every=2, config=cfg_solv, bias=bias_g)
    torch.cuda.synchronize()
    launches_k3, launches_k4 = gb.gb_forces.launches, sasa.sasa_forces.launches
    for name, count in (("gb_forces", launches_k3), ("sasa_forces", launches_k4)):
        kernels[name]["launches"] = count
        kernels[name]["launches_of"] = (
            f"simulate_ensemble(GBIS_CONFIG) on the composed path, {N_REPLICAS} replicas x "
            f"{SOLVENT_PATH_STEPS} steps; inside the campaign kernel it runs as a device "
            f"function every step")
        check(count == SOLVENT_PATH_STEPS,
              f"{name} launched {count} times, expected {SOLVENT_PATH_STEPS}")
    check(bool(torch.isfinite(fr_solv).all()), "composed GBIS path: non-finite frames")
    # the force the path carries is the all-autograd force at its positions
    step_solv = int(final_solv.step[0])
    auto_solv = _neg_grad(
        lambda q: total_energy(q, ff, config=GBIS_CONFIG) + bias_g.energy(q, step_solv - 1),
        final_solv.pos)
    solvent_path_err = max_err(final_solv.forces, auto_solv)
    check(solvent_path_err < TOL_F32_VS_F64,
          f"composed GBIS path, carried force vs autograd: {solvent_path_err} kcal/mol/A")

    # fault C8: the same entry point with no kernel flag on states its
    # kernels do not hold (float64, 416 atoms)
    dispatch_res = solvent_dispatch_check()
    # fault C11: a kernel flag beside an option its kernels do not cover
    t_phase = time.perf_counter()
    option_res = option_dispatch_check()
    emit("option_dispatch", **option_res, seconds=round(time.perf_counter() - t_phase, 2),
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         script_seconds=round(time.perf_counter() - t_script, 1))

    emit("gbis_campaign", replicas=N_REPLICAS, atoms=n, steps=N_STEPS, save_every=N_INNER,
         fire_seconds=round(fire_g_s, 2), energy_terms_at_minimum=terms_g,
         end_to_end_distance_A=d0_g, **gbis_runs,
         gb_kernel_launches=launches_k3, sasa_kernel_launches=launches_k4,
         composed_path_force_vs_autograd=solvent_path_err, solvent_dispatch=dispatch_res,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         script_seconds=round(time.perf_counter() - t_script, 1))
    kernels["gb_forces"]["at_416_atoms"] = dispatch_res["gb_forces_416_atoms"]
    kernels["sasa_forces"]["at_506_atoms"] = dispatch_res["sasa_forces_506_atoms"]

    # -- the GBIS campaign at 208 and 416 atoms, and the cadences over a long run
    t_phase = time.perf_counter()
    tier_g_res, tier_g_times, tier_g_launches, tier_g_starts = gbis_tiers_phase(
        pos_g, (lambda: make_gbis_op(N_INNER, 300.0), pos_b, vel_b, frc_g, pos_pert, gb_tab,
                gb_consts))
    emit("gbis_tiers", **tier_g_res, seconds=round(time.perf_counter() - t_phase, 1),
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         script_seconds=round(time.perf_counter() - t_script, 1))
    kernels["campaign_advance[gbis]"]["by_tier"] = tier_g_times
    kernels["campaign_advance[gbis]"]["switch"] = tier_g_res["switch"]
    t_phase = time.perf_counter()
    ff4g, pos4g, _ = tier_g_starts[4]
    cad_res = cadence_phase(ff, pos_g, ff4g, pos4g)
    emit("cadence", **cad_res, drift_bound_kcal_mol=CADENCE_DRIFT_BOUND,
         seconds=round(time.perf_counter() - t_phase, 1),
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         script_seconds=round(time.perf_counter() - t_script, 1))

    # -- the composed pair-op path at the tier sizes ---------------------------
    tier_rows, tier_times, starts, k1_checks, tier_levers = tiers_phase(lever_libs, pos_min)
    emit("tiers", **tier_rows, campaign_advance_vs_plain=k1_checks,
         campaign_advance_by_tier=tier_times["campaign_advance"],
         pair_forces_by_tier=tier_times["pair_forces"], levers=tier_levers,
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         script_seconds=round(time.perf_counter() - t_script, 1))
    for name, variant, replaces in (
        ("nonbonded_rows", "dense", "molecular_dynamics_tpu/ops/nonbonded.py:274"),
        ("pair_tiles", "ring", "molecular_dynamics_tpu/ops/ring.py:419"),
    ):
        by_shape = tier_times[name]
        at = by_shape[f"{104 * TIERS[-1][0]}x{TIERS[-1][1]}"]
        kernels[name] = {
            "name": name, "route": "cuda",
            "source": f"molecular_dynamics_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": sum(v["launches"] for v in by_shape.values()),
            "launches_of": (f"simulate_ensemble(fused_nonbonded, kernel_variant={variant!r}), "
                            f"{TIER_STEPS} steps at each of " + ", ".join(by_shape)),
            "max_abs_err": pair_op_err[name], "tolerance": TOL_PAIR_FORCE,
            "max_abs_err_what": "forces (kcal/mol/A) vs the plain float32 version, "
                                "at every checked shape and both cutoffs",
            "ms": at["ms"], "ms_back_to_back": at["ms_back_to_back"],
            "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
            "bound_ms_dense": at["bound_ms_dense"], "bound_by": at["bound_by"],
            "library_ms": None, "sfu_bound_ms": sfu_ms(pair_sfu_ops(at["live_unordered_pairs"])),
            "registers_per_thread": at["registers_per_thread"], "ctas_per_sm": at["ctas_per_sm"],
            "sms_used": at["sms_used"],
            "shape": [TIERS[-1][1], 104 * TIERS[-1][0], 3], "by_shape": by_shape,
        }
    kernels["campaign_advance"]["by_tier"] = tier_times["campaign_advance"]
    kernels["pair_forces"]["by_tier"] = tier_times["pair_forces"]

    ff4, pos_min4, ens4 = starts[4]
    grad_res = grad_phase(ff4, pos_min4, rng)
    emit("grad", replicas=8, atoms=ff4.n_atoms, steps=GRAD_STEPS, tolerance=TOL_GRAD,
         **grad_res, device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         script_seconds=round(time.perf_counter() - t_script, 1))

    # -- the command line, and bench_torch.py ---------------------------------
    t_cli = time.perf_counter()
    cli_res, cli_pair_launches = cli_phase(ff, coords)
    emit("cli", **cli_res, seconds=round(time.perf_counter() - t_cli, 1),
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         script_seconds=round(time.perf_counter() - t_script, 1))
    t_phase = time.perf_counter()
    host_res, host_launches = host_io_phase(ff, coords, meta_full, cli_res)
    emit("host_io", **host_res, launches_by_path=host_launches,
         seconds=round(time.perf_counter() - t_phase, 1),
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         script_seconds=round(time.perf_counter() - t_script, 1))
    t_phase = time.perf_counter()
    par_res, par_launches = parallel_phase(
        ff, (ens, cfg, bias), (ens_g, finals_g[1][0], bias_g), dev, dp_ranks)
    emit("parallel", **par_res, launches_by_path=par_launches,
         seconds=round(time.perf_counter() - t_phase, 1),
         device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         script_seconds=round(time.perf_counter() - t_script, 1))
    bench_record, bench_launches, bench_s = bench_phase()
    emit("bench", record=bench_record, campaign_kernel_launches=bench_launches,
         seconds=round(bench_s, 1), device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         script_seconds=round(time.perf_counter() - t_script, 1))

    # -- where the device's time goes in one campaign call ------------------
    profile_res = {}
    for label, every in (("obs_every_save", 1), ("obs_once", n_saves)):
        res = profile_call(lambda: simulate_ensemble(
            final2, ff, n_steps=N_STEPS, save_every=N_INNER, config=cfg, bias=bias,
            obs_every=every))
        check(res["device_seconds"] > 0.0,
              "torch.profiler reported no device time: nothing was measured")
        profile_res[label] = res
    # the composed pair-op path at 416 x 192: how much of a step the device
    # works, and how many kernels a step launches
    cfg_ring = SimulationConfig(dt_fs=1.0, temperature=300.0, fused_nonbonded=True)
    res = profile_call(lambda: simulate_ensemble(
        ens4, ff4, n_steps=PROFILE_COMPOSED_STEPS, save_every=PROFILE_COMPOSED_STEPS,
        config=cfg_ring))
    check(res["device_seconds"] > 0.0, "torch.profiler reported no device time: nothing was measured")
    res["kernel_launches_per_step"] = res["kernel_launches"] / PROFILE_COMPOSED_STEPS
    profile_res[f"composed_ring_{ff4.n_atoms}x{ens4.pos.shape[0]}_{PROFILE_COMPOSED_STEPS}_steps"] = res
    # one composed step at 416 x 192 taken apart by source, ring and dense,
    # with the SMD bias on the chain's ends
    pos4 = ens4.pos[0]
    d4 = float(torch.linalg.norm(pos4[ff4.n_atoms - 1] - pos4[0]))
    bias4 = HarmonicSMDBias.create(n_atoms=ff4.n_atoms, group1=[0], group2=[ff4.n_atoms - 1],
                                   fk=1.0, cent_0=d4, cent_1=d4 + 22.0, T=500_000.0)
    for variant in ("ring", "dense"):
        profile_res[f"census_{variant}_{ff4.n_atoms}x{ens4.pos.shape[0]}"] = launch_census(
            ff4, ens4, variant, bias4)
    for every, (cfg_g, start_g) in finals_g.items():
        res = profile_call(lambda: simulate_ensemble(
            start_g, ff, n_steps=N_STEPS, save_every=N_INNER, config=cfg_g, bias=bias_g))
        check(res["device_seconds"] > 0.0,
              "torch.profiler reported no device time: nothing was measured")
        profile_res[f"gbis_sasa_every={every}_obs_every_save"] = res
    emit("profile", **profile_res, device=torch.cuda.get_device_name(0), nvidia_smi=smi,
         script_seconds=round(time.perf_counter() - t_script, 1))

    # -- the SMD data-generation twin, and the training path --------------------
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t_phase = time.perf_counter()
        regen_res, regen_launches = regenerate_phase(tmp)
        emit("regenerate", **regen_res, seconds=round(time.perf_counter() - t_phase, 1),
             device=torch.cuda.get_device_name(0), nvidia_smi=smi,
             script_seconds=round(time.perf_counter() - t_script, 1))
        train_runs, train_wall = train_runs_phase(tmp)
        emit("train_runs", runs=len(train_runs), workers=TRAIN_WORKERS,
             seconds=round(train_wall, 1),
             run_seconds={f"{p}/{f}": round(r[0]["wall_seconds"], 1)
                          for (p, f), r in train_runs.items()},
             script_seconds=round(time.perf_counter() - t_script, 1))
        regen_cgan, _, _, regen_train_launches = train_runs["regenerate", "cgan"]
        t_phase = time.perf_counter()
        train_res, train_launches = train_phase(tmp, dev, train_runs)
        emit("train", **train_res, cgan_104={**regen_cgan, "launches": regen_train_launches},
             seconds=round(time.perf_counter() - t_phase, 1),
             device=torch.cuda.get_device_name(0), nvidia_smi=smi,
             script_seconds=round(time.perf_counter() - t_script, 1))
        t_phase = time.perf_counter()
        dyn_res, dyn_launches = dynamics_phase(tmp, dev, train_runs)
        emit("dynamics", **dyn_res, seconds=round(time.perf_counter() - t_phase, 1),
             device=torch.cuda.get_device_name(0), nvidia_smi=smi,
             script_seconds=round(time.perf_counter() - t_script, 1))
        t_phase = time.perf_counter()
        seq_res, seq_launches = sequence_phase(tmp, dev, train_runs)
        emit("sequence", **seq_res, seconds=round(time.perf_counter() - t_phase, 1),
             device=torch.cuda.get_device_name(0), nvidia_smi=smi,
             script_seconds=round(time.perf_counter() - t_script, 1))
        t_phase = time.perf_counter()
        gen_res, gen_launches = generative_phase(tmp, dev, train_runs)
        emit("generative", **gen_res, seconds=round(time.perf_counter() - t_phase, 1),
             device=torch.cuda.get_device_name(0), nvidia_smi=smi,
             script_seconds=round(time.perf_counter() - t_script, 1))
        t_phase = time.perf_counter()
        trained_res, trained_launches = trained_generation_phase(tmp)
        emit("trained_generation", **trained_res,
             seconds=round(time.perf_counter() - t_phase, 2),
             device=torch.cuda.get_device_name(0), nvidia_smi=smi,
             script_seconds=round(time.perf_counter() - t_script, 1))
    # the training path reaches no kernel: the energy of a generated batch is
    # the plain PyTorch energy, differentiated by autograd
    train_total = {name: regen_train_launches[name] + sum(run[name] for run in train_launches.values())
                   for name in regen_train_launches}
    check(not any(train_total.values()), f"cli train launched kernels: {train_total}")
    # nor does the dynamics line: its energy is the informed step's plain one
    dyn_total = {name: sum(run[name] for run in dyn_launches.values()) for name in train_total}
    check(not any(dyn_total.values()), f"cli train (dynamics) launched kernels: {dyn_total}")
    # nor does the sequence and graph line: LSTMs, attention and dense GAT layers
    seq_total = {name: sum(run[name] for run in seq_launches.values()) for name in train_total}
    check(not any(seq_total.values()), f"cli train (sequence) launched kernels: {seq_total}")
    # nor does the generative line: MLPs, couplings, SDE and CDE loops, and
    # the injection's plain energy
    gen_total = {name: sum(run[name] for run in gen_launches.values()) for name in train_total}
    check(not any(gen_total.values()), f"cli train (generative) launched kernels: {gen_total}")
    # nor do the trained generation maps: GAT, SchNet and LSTM rollouts
    trained_total = {name: sum(run[name] for run in trained_launches.values())
                     for name in train_total}
    check(not any(trained_total.values()),
          f"trained generation maps launched kernels: {trained_total}")

    kernels["campaign_advance"]["launches_by_path"] = {
        f"simulate_ensemble(fused_campaign) {N_REPLICAS} x {N_STEPS}": launches_k1,
        f"cli simulate example:full vacuum {N_REPLICAS} x {N_STEPS}":
            cli_res["vacuum"]["campaign_kernel_launches"],
        f"cli simulate example:backbone (40 atoms) {N_REPLICAS} x {N_STEPS}":
            cli_res["backbone"]["campaign_kernel_launches"],
        "bench_torch.py, its three protocols (both instantiations)": bench_launches,
    }
    kernels["campaign_advance[gbis]"]["launches_by_path"] = {
        f"simulate_ensemble(fused_campaign, GBIS_CONFIG, sasa_every=1) {N_REPLICAS} x {N_STEPS}":
            kernels["campaign_advance[gbis]"]["launches"],
        f"cli simulate example:full GBIS_CONFIG {N_REPLICAS} x {N_STEPS}":
            cli_res["gbis"]["campaign_kernel_launches"],
    }
    host_vacuum, host_gbis, host_cmap = host_launches
    kernels["campaign_advance"]["launches_by_path"][host_vacuum] = host_launches[host_vacuum]
    kernels["campaign_advance[gbis]"]["launches_by_path"][host_gbis] = host_launches[host_gbis]
    kernels["campaign_advance"]["sharded_rate"] = {
        tag: {"aggregate_steps_per_s": par_res[tag]["aggregate_steps_per_s"],
              "unsharded_aggregate_steps_per_s": par_res[tag]["unsharded_aggregate_steps_per_s"],
              "shards": par_res[tag]["shards"]} for tag in ("vacuum", "gbis")}
    for name in ("nonbonded_rows", "pair_tiles"):
        kernels[name]["launches_by_path"] = {
            f"tiers, {TIER_STEPS} steps at each size": kernels[name]["launches"],
            f"cli simulate fused_nonbonded {CLI_CHECK_REPLICAS} x {CLI_CHECK_STEPS}":
                cli_pair_launches[name],
        }
    kernels["pair_tiles"]["launches_by_path"][
        f"simulate_ensemble(fused_nonbonded) {N_REPLICAS} x {PAIR_PATH_STEPS}"] = launches_k6_main
    regen_path = f"regenerate: regenerate_smd --gbis {REGEN_REPLICAS} x {REGEN_STEPS}"
    train_path = "train: cli train pretrain and cgan (40 atoms), cgan (104 atoms)"
    dyn_path = "dynamics: cli train node, hnn, hnn-schnet, hnn-latent (40 atoms)"
    seq_path = ("sequence: cli train " + ", ".join(SEQUENCE_FAMILIES) + " (40 atoms)")
    gen_path = ("generative: cli train " + ", ".join(GENERATIVE_FAMILIES) + " (40 atoms)")
    trained_path = ("trained_generation: the generation maps of "
                    + ", ".join(sorted(trained_launches)) + " from trained weights (40 atoms)")
    for row, counter in (("pair_forces", "pair_forces"), ("campaign_advance", None),
                         ("gb_forces", "gb_forces"), ("sasa_forces", "sasa_forces"),
                         ("campaign_advance[gbis]", "campaign_advance"),
                         ("nonbonded_rows", "nonbonded_rows"), ("pair_tiles", "pair_tiles")):
        by_path = kernels[row].setdefault("launches_by_path", {})
        # the twin runs under GBIS: every campaign launch is the solvent instantiation
        by_path[regen_path] = 0 if counter is None else regen_launches[counter]
        by_path[train_path] = train_total["campaign_advance" if counter is None else counter]
        by_path[dyn_path] = dyn_total["campaign_advance" if counter is None else counter]
        by_path[seq_path] = seq_total["campaign_advance" if counter is None else counter]
        by_path[gen_path] = gen_total["campaign_advance" if counter is None else counter]
        by_path[trained_path] = trained_total["campaign_advance" if counter is None else counter]
        by_path[host_cmap] = host_launches[host_cmap]["campaign_advance" if counter is None
                                                       else counter]
        for path, counts in par_launches.items():
            # the phase's vacuum runs are the vacuum row's, its GBIS runs the solvent row's
            solvent_path = "(gbis," in path
            if counter is None or row == "campaign_advance[gbis]":
                mine = solvent_path == (row == "campaign_advance[gbis]")
                by_path[path] = counts["campaign_advance"] if mine else 0
            else:
                by_path[path] = counts[counter]

    gbis_paths = kernels["campaign_advance[gbis]"]["launches_by_path"]
    for path, counts in tier_g_launches.items():
        gbis_paths[path] = counts["campaign_advance"]
    for label, arm in cad_res.items():
        gbis_paths[f"cadence: simulate_ensemble(fused_campaign, NVE, {label}) "
                   f"{arm['replicas']} x {arm['steps']}"] = arm["launches"]
    option_path = (f"option_dispatch: simulate_ensemble(fused_campaign, GBIS_CONFIG, "
                   f"integrator='nve') on the composed path, {option_res['replicas']} x "
                   f"{option_res['steps']}")
    for name, counter in (("campaign_advance", "campaign_advance"),
                          ("campaign_advance[gbis]", "campaign_advance"),
                          ("gb_forces", "gb_forces"), ("sasa_forces", "sasa_forces")):
        kernels[name]["launches_by_path"][option_path] = option_res["A"]["launches"][counter]
    for name in ("nonbonded_rows", "pair_tiles"):
        kernels[name]["launches_by_path"][
            f"option_dispatch: simulate_ensemble(fused_nonbonded, pbc=True) {option_res['replicas']}"
            f" x {option_res['steps']}"] = option_res["B"]["launches"][name]
    for name in ("gb_forces", "sasa_forces"):
        for n_d in (416, 506):
            kernels[name]["launches_by_path"][
                f"gbis_campaign: solvent_dispatch, the unflagged GBIS step, {n_d} atoms x 4, "
                "3 steps"] = dispatch_res[f"{n_d}_atoms_f32"]["launches"][name]


    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [
        kernels[k] for k in ("pair_forces", "campaign_advance", "gb_forces", "sasa_forces",
                             "campaign_advance[gbis]", "nonbonded_rows", "pair_tiles")]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
