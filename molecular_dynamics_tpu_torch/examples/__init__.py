"""Built-in example systems (self-contained, no external files needed)."""

from molecular_dynamics_tpu_torch.examples.decaalanine import (
    BACKBONE_COLVAR,
    BACKBONE_FF_PRM,
    decaalanine_backbone,
)
from molecular_dynamics_tpu_torch.examples.full_system import (
    decaalanine_full,
    dialanine,
    tiled_decaalanine,
)

__all__ = [
    "decaalanine_backbone",
    "BACKBONE_FF_PRM",
    "BACKBONE_COLVAR",
    "decaalanine_full",
    "dialanine",
    "tiled_decaalanine",
]
