"""Hand-written CUDA kernels with their plain PyTorch versions."""

from molecular_dynamics_tpu_torch.ops.nonbonded import make_nonbonded_op
from molecular_dynamics_tpu_torch.ops.ring import make_pair_ring_op, pair_forces
from molecular_dynamics_tpu_torch.ops.fused_step import make_fused_campaign_op

__all__ = ["make_nonbonded_op", "make_pair_ring_op", "pair_forces", "make_fused_campaign_op"]
