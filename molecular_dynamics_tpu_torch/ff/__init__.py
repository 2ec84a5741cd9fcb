"""Force-field parameter containers."""

from molecular_dynamics_tpu_torch.ff.params import FFParams, tile_ff_params

__all__ = ["FFParams", "tile_ff_params"]
