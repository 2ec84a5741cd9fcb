"""Force-field parameter containers."""

from molecular_dynamics_tpu_torch.ff.params import FFParams

__all__ = ["FFParams"]
