"""Model zoo, as ``torch.nn.Module``s with the reference's flax layouts.

Ported so far: the shared ``MLP``, the flagship time-conditioned cGAN
(``Generator``, ``Discriminator``) and the Hamiltonian dynamics line
(``HNN``, ``SchNet`` / ``SchNetHNN`` with ``CfConv``, ``MLPAutoencoder``,
``LatentHNN``, ``LatentDiscriminator``, and the ODE solvers ``odeint_field``,
``rk4_rollout``, ``hnn_field``). The sequence, graph and generative families
are queued in ROADMAP.md §A (A12, A13).
"""

from molecular_dynamics_tpu_torch.models.common import MLP
from molecular_dynamics_tpu_torch.models.cgan import Discriminator, Generator
from molecular_dynamics_tpu_torch.models.hnn import HNN
from molecular_dynamics_tpu_torch.models.schnet import CfConv, SchNet
from molecular_dynamics_tpu_torch.models.autoencoder import (
    LatentDiscriminator,
    LatentHNN,
    MLPAutoencoder,
)
from molecular_dynamics_tpu_torch.models.node import hnn_field, odeint_field, rk4_rollout

__all__ = [
    "MLP",
    "Generator",
    "Discriminator",
    "HNN",
    "odeint_field",
    "rk4_rollout",
    "hnn_field",
    "SchNet",
    "CfConv",
    "MLPAutoencoder",
    "LatentHNN",
    "LatentDiscriminator",
]
