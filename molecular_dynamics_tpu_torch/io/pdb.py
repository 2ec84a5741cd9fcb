"""Minimal PDB coordinate reader/writer.

Coordinates and names of systems like ``backbone.pdb``; fixed-column parsing
per the PDB 3.3 spec; multi-model files read as a trajectory and are written
as one (MODEL/ENDMDL), the form VMD opens.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def read_pdb(path: str):
    """Parse ATOM/HETATM records.

    Returns (coords, names, resnames, resids): coords is (n_models, N, 3)
    float64 (squeezed to (N, 3) for single-model files).
    """
    models: List[List[Tuple[float, float, float]]] = [[]]
    names, resnames, resids = [], [], []
    first_model = True
    with open(path) as fh:
        for line in fh:
            rec = line[:6]
            if rec == "ENDMDL":
                models.append([])
                first_model = False
            elif rec in ("ATOM  ", "HETATM"):
                models[-1].append(
                    (float(line[30:38]), float(line[38:46]), float(line[46:54]))
                )
                if len(models) == 1:
                    names.append(line[12:16].strip())
                    resnames.append(line[17:21].strip())
                    resids.append(int(line[22:26]))
    models = [m for m in models if m]
    coords = np.array(models, np.float64)
    if coords.shape[0] == 1:
        coords = coords[0]
    return (
        coords,
        np.array(names, object),
        np.array(resnames, object),
        np.array(resids, np.int64),
    )


def write_pdb(
    path: str,
    coords: np.ndarray,
    names: np.ndarray,
    resnames: Optional[np.ndarray] = None,
    resids: Optional[np.ndarray] = None,
):
    """Write one or more models of coordinates as a PDB file."""
    coords = np.asarray(coords)
    if coords.ndim == 2:
        coords = coords[None]
    n = coords.shape[1]
    if resnames is None:
        resnames = np.array(["UNK"] * n)
    if resids is None:
        resids = np.ones(n, np.int64)
    with open(path, "w") as fh:
        for m, frame in enumerate(coords):
            if coords.shape[0] > 1:
                fh.write(f"MODEL     {m + 1:4d}\n")
            for i in range(n):
                x, y, z = frame[i]
                name = str(names[i])
                pad_name = f" {name:<3s}" if len(name) < 4 else name
                fh.write(
                    f"ATOM  {i + 1:5d} {pad_name:<4s} {str(resnames[i]):<4s}"
                    f"{int(resids[i]):5d}    "
                    f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}\n"
                )
            if coords.shape[0] > 1:
                fh.write("ENDMDL\n")
        fh.write("END\n")
