"""Miscellaneous utilities (visualisation glue)."""

from molecular_dynamics_tpu_torch.utils.vmd import write_vmd_loader

__all__ = ["write_vmd_loader"]
