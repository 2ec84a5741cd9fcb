"""Force-field parameter containers and their builders."""

from molecular_dynamics_tpu_torch.ff.params import (
    FFParams,
    finalize_ff_params,
    tile_ff_params,
)
from molecular_dynamics_tpu_torch.ff.yaml_ff import YamlForceField
from molecular_dynamics_tpu_torch.ff.builder import build_ff_params

__all__ = [
    "FFParams",
    "finalize_ff_params",
    "tile_ff_params",
    "YamlForceField",
    "build_ff_params",
]
