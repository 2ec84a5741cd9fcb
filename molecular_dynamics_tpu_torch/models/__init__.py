"""Model zoo, as ``torch.nn.Module``s with the reference's flax layouts.

Ported so far: the shared ``MLP`` and the flagship time-conditioned cGAN
(``Generator``, ``Discriminator``). The other families (HNN, sequence and
graph models, the generative line) are queued in ROADMAP.md §A (A11-A13).
"""

from molecular_dynamics_tpu_torch.models.common import MLP
from molecular_dynamics_tpu_torch.models.cgan import Discriminator, Generator

__all__ = ["MLP", "Generator", "Discriminator"]
