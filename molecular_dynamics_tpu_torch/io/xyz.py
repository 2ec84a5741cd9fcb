"""XYZ trajectory writer/reader for VMD visualisation."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def write_xyz(
    path: str,
    frames: np.ndarray,
    symbols: Optional[Sequence[str]] = None,
    comment: str = "frame",
):
    """Write (n_frames, N, 3) (or a single (N, 3) frame) to .xyz."""
    frames = np.asarray(frames)
    if frames.ndim == 2:
        frames = frames[None]
    n = frames.shape[1]
    if symbols is None:
        symbols = ["C"] * n
    with open(path, "w") as fh:
        for f, frame in enumerate(frames):
            fh.write(f"{n}\n{comment} {f}\n")
            for s, (x, y, z) in zip(symbols, frame):
                fh.write(f"{s} {x:.6f} {y:.6f} {z:.6f}\n")


def read_xyz(path: str) -> np.ndarray:
    """Read an .xyz trajectory into (n_frames, N, 3)."""
    frames = []
    with open(path) as fh:
        lines = fh.read().split("\n")
    i = 0
    while i < len(lines) and lines[i].strip():
        n = int(lines[i].strip())
        block = lines[i + 2 : i + 2 + n]
        frames.append([[float(v) for v in ln.split()[1:4]] for ln in block])
        i += 2 + n
    return np.array(frames, np.float64)
