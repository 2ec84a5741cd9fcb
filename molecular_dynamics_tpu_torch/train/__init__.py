"""Training harness: losses, datasets, checkpoints and the training loops.

The physics-informed cGAN and its decoder pretraining (``train.cgan``), the
HNN trainer (``train.hnn``), the sequence trainers, rollouts and rollout
correctors (``train.seq``), the flow and VAE trainers
(``train.generative``) and the SDE-GAN trainer (``train.sde``), driven end
to end by ``train.drivers.run_training`` (``cli train``, every family of
the JAX package). Every energy evaluation is one batched call of
``energy.energy_terms`` on a ``(B, N, 3)`` tensor inside the update,
differentiated by ``torch.autograd``.
"""

from molecular_dynamics_tpu_torch.train.losses import (
    potential_loss,
    bias_energy_loss,
    distance_matrix_loss,
    torsion_loss,
    window_composite_loss,
)
from molecular_dynamics_tpu_torch.train.datasets import (
    TrajectoryData,
    frame_time_batches,
    window_batches,
    phase_space_pairs,
)

__all__ = [
    "potential_loss",
    "bias_energy_loss",
    "distance_matrix_loss",
    "torsion_loss",
    "window_composite_loss",
    "TrajectoryData",
    "frame_time_batches",
    "window_batches",
    "phase_space_pairs",
]
