"""Built-in example systems (self-contained, no external files needed)."""

from molecular_dynamics_tpu_torch.examples.full_system import (
    decaalanine_full,
    dialanine,
    tiled_decaalanine,
)

__all__ = ["decaalanine_full", "dialanine", "tiled_decaalanine"]
