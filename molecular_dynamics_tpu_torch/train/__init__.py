"""Training harness: losses, datasets, checkpoints and the training loops.

Ported so far: the physics-informed cGAN and its decoder pretraining
(``train.cgan``), the HNN trainer (``train.hnn``) and the sequence trainers,
rollouts and rollout correctors (``train.seq``), driven end to end by
``train.drivers.run_training`` (``cli train pretrain | cgan | hnn |
hnn-schnet | hnn-latent | node | lstm | lstm-nll | seq2seq | seq2seq-gan |
transformer | gat | lstm-gat | seq2seq-graph``). Every energy evaluation is
one batched call of ``energy.energy_terms`` on a ``(B, N, 3)`` tensor
inside the update, differentiated by ``torch.autograd``. The other
generative families are queued in ROADMAP.md §A (A13).
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
