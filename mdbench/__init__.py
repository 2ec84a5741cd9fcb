"""The benchmark of molecular_dynamics_tpu_torch (see README.md)."""
