"""Model zoo, as ``torch.nn.Module``s with the reference's flax layouts.

The shared ``MLP``, the flagship time-conditioned cGAN
(``Generator``, ``Discriminator``), the Hamiltonian dynamics line (``HNN``,
``SchNet`` / ``SchNetHNN`` with ``CfConv``, ``MLPAutoencoder``,
``LatentHNN``, ``LatentDiscriminator``, and the ODE solvers
``odeint_field``, ``rk4_rollout``, ``hnn_field``) and the sequence and graph
line (``LSTMPredictor``, ``LSTMNLLPredictor``, ``Seq2Seq``, ``Seq2SeqNLL``,
``SequenceDiscriminator``, ``TrajectoryTransformer``, ``GATSimulator``,
``DenseGATLayer``, ``LSTMGAT``; ``GraphSeq2Seq`` in ``models.gat``) and the
generative line (``ConditionalVAE``, ``RealNVP``, ``SDEGenerator``,
``CDEDiscriminator``): every model of the JAX package.
"""

from molecular_dynamics_tpu_torch.models.common import MLP
from molecular_dynamics_tpu_torch.models.cgan import Discriminator, Generator
from molecular_dynamics_tpu_torch.models.hnn import HNN
from molecular_dynamics_tpu_torch.models.seq import (
    LSTMNLLPredictor,
    LSTMPredictor,
    Seq2Seq,
    Seq2SeqNLL,
    SequenceDiscriminator,
)
from molecular_dynamics_tpu_torch.models.schnet import CfConv, SchNet
from molecular_dynamics_tpu_torch.models.autoencoder import (
    LatentDiscriminator,
    LatentHNN,
    MLPAutoencoder,
)
from molecular_dynamics_tpu_torch.models.gat import LSTMGAT, DenseGATLayer, GATSimulator
from molecular_dynamics_tpu_torch.models.transformer import TrajectoryTransformer
from molecular_dynamics_tpu_torch.models.node import hnn_field, odeint_field, rk4_rollout
from molecular_dynamics_tpu_torch.models.vae import ConditionalVAE
from molecular_dynamics_tpu_torch.models.flows import RealNVP
from molecular_dynamics_tpu_torch.models.sde import CDEDiscriminator, SDEGenerator

__all__ = [
    "MLP",
    "Generator",
    "Discriminator",
    "HNN",
    "LSTMPredictor",
    "LSTMNLLPredictor",
    "Seq2Seq",
    "GATSimulator",
    "DenseGATLayer",
    "TrajectoryTransformer",
    "odeint_field",
    "rk4_rollout",
    "hnn_field",
    "Seq2SeqNLL",
    "SequenceDiscriminator",
    "SchNet",
    "CfConv",
    "MLPAutoencoder",
    "LatentHNN",
    "LatentDiscriminator",
    "LSTMGAT",
    "ConditionalVAE",
    "RealNVP",
    "SDEGenerator",
    "CDEDiscriminator",
]
