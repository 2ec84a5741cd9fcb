"""NAMD XSC (extended system configuration) reader.

Parses the periodic cell vectors and origin from a NAMD ``.xsc`` /
``.restart.xsc`` file. Returns the rectangular box diagonal used by
``MDState.box`` (the general triclinic vectors are returned too for callers
that need them).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def read_xsc(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (box_diag (3,), cell_vectors (3, 3), origin (3,))."""
    with open(path) as fh:
        rows = [
            ln.split()
            for ln in fh
            if ln.strip() and not ln.startswith("#")
        ]
    if not rows:
        raise ValueError(f"{path}: no data row in XSC file")
    vals = [float(v) for v in rows[-1]]
    if len(vals) < 10:
        raise ValueError(f"{path}: XSC row has {len(vals)} fields, need >= 10")
    # step ax ay az bx by bz cx cy cz [ox oy oz ...]
    cell = np.array(vals[1:10], np.float64).reshape(3, 3)
    origin = (
        np.array(vals[10:13], np.float64)
        if len(vals) >= 13
        else np.zeros(3)
    )
    return np.diag(cell).copy(), cell, origin
