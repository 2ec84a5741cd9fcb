"""The JAX side of the repository must not run in a benchmark process: the
JAX package is the reference the port's CPU tests hold it against, and the
port's package name begins with its name, so modules are compared by their
whole top-level name."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "molecular_dynamics_tpu")


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (or ``names``) whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
