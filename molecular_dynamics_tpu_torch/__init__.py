"""molecular_dynamics_tpu_torch — the PyTorch/CUDA port of ``mdx``.

Same module and function names as ``molecular_dynamics_tpu`` (the JAX
reference, which this package never imports), PyTorch idiom inside:
dataclasses of tensors, plain functions on ``(..., N, 3)`` tensors, an
explicit ``device``/``dtype``, and hand-written CUDA kernels (``csrc/``,
bound in ``ops/``) where the reference used Pallas.

Ported: every module of the JAX package:

- ``units``, ``topology`` (``Topology``), ``build`` (angles and dihedrals
  from bonds), ``io`` (PSF, PDB, XYZ, DCD, AMBER prmtop plain and chamber,
  CHARMM ``.prm`` with CMAP, GROMACS xtc, mol2, sdf, NAMD xsc, and
  ``io.native``: the C++ DCD / xtc / ``.mdxtc`` codecs and the
  asynchronous trajectory sink), ``ff`` (``FFParams``, ``YamlForceField``,
  ``build_ff_params``, ``finalize_ff_params``, ``tile_ff_params``,
  ``attach_cmap_params``), ``solvent``, ``examples`` (the generated 40-atom
  deca-alanine backbone, the packaged 104-atom deca-alanine and 22-atom
  di-alanine, ``tiled_decaalanine``)
- ``energy`` (bonded terms, 1-4, switched LJ, reaction-field Coulomb,
  Urey-Bradley, CHARMM CMAP, the repulsion variants, GB, SASA; forces
  through ``torch.autograd``)
- ``system``, ``bias``, ``integrate`` (with the FIRE, L-BFGS and
  steepest-descent minimisers), ``constraints``, ``sim``
- ``ops``: ``make_nonbonded_op`` and ``make_pair_ring_op`` (differentiable
  pair ops), ``bonded.make_angle_torsion_op``, ``pair_forces``,
  ``gb.gb_forces``, ``sasa.sasa_forces`` and ``make_fused_campaign_op``
  (CUDA kernels with plain PyTorch versions beside them)
- ``config``, ``log`` and ``cli`` (``python -m
  molecular_dynamics_tpu_torch.cli simulate | energy | train | convert |
  bench``)
- ``features``, ``evaluate``, ``models`` (the flagship cGAN, the
  Hamiltonian dynamics line, the sequence and graph line, the generative
  line) and ``train`` (losses, datasets, checkpoints, updates, rollout
  correctors and the drivers of all 18 ``cli train`` families);
  ``regenerate_smd``, the SMD training-data campaign;
  ``utils.write_vmd_loader``
- ``convert`` — numpy arrays into the port's objects
- ``parallel`` — several devices: ``get_mesh``, ``shard_ensemble``,
  ``shard_campaign_advance`` (``sim.simulate_ensemble(mesh=)``, ``cli
  simulate --devices N``), data-parallel training over
  ``torch.distributed`` ranks (``run_training(devices=N)``, ``cli train
  --devices N``) and ``dryrun_multichip``

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu`` on the command line).
"""

import torch

# Reduced-precision products silently cost kcal/mol in an energy; keep every
# float32 product in full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from molecular_dynamics_tpu_torch import units
from molecular_dynamics_tpu_torch.topology import Topology
from molecular_dynamics_tpu_torch.ff import FFParams, build_ff_params
from molecular_dynamics_tpu_torch.energy import (
    EnergyConfig,
    GBIS_CONFIG,
    REFERENCE_CONFIG,
    energy_terms,
    total_energy,
    force_fn,
    energy_and_forces,
)
from molecular_dynamics_tpu_torch import solvent
from molecular_dynamics_tpu_torch.system import MDState, system_init
from molecular_dynamics_tpu_torch.integrate import (
    velocity_verlet_step,
    langevin_step,
    maxwell_boltzmann,
    kinetic_energy,
    temperature,
    minimize_fire,
    minimize_lbfgs,
)
from molecular_dynamics_tpu_torch.bias import HarmonicSMDBias

__version__ = "0.1.0"

__all__ = [
    "units",
    "Topology",
    "FFParams",
    "build_ff_params",
    "EnergyConfig",
    "GBIS_CONFIG",
    "REFERENCE_CONFIG",
    "solvent",
    "energy_terms",
    "total_energy",
    "force_fn",
    "energy_and_forces",
    "MDState",
    "system_init",
    "velocity_verlet_step",
    "langevin_step",
    "maxwell_boltzmann",
    "kinetic_energy",
    "temperature",
    "minimize_fire",
    "minimize_lbfgs",
    "HarmonicSMDBias",
]
