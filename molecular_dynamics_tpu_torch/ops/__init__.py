"""Hand-written CUDA kernels with their plain PyTorch versions."""

from molecular_dynamics_tpu_torch.ops.ring import pair_forces
from molecular_dynamics_tpu_torch.ops.fused_step import make_fused_campaign_op

__all__ = ["pair_forces", "make_fused_campaign_op"]
