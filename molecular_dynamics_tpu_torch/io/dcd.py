"""DCD binary trajectory codec (CHARMM/NAMD flavour), pure numpy.

Reading supports the CHARMM format with or without the unit-cell block and
either endianness; writing emits standard CHARMM DCDs that VMD and
MDAnalysis open directly. The files are byte for byte those of the JAX
package's writer (same header, same title record).
"""

from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


def _read_record(fh, endian: str) -> bytes:
    raw = fh.read(4)
    if len(raw) < 4:
        return b""
    (n,) = struct.unpack(endian + "i", raw)
    data = fh.read(n)
    fh.read(4)  # trailing length
    return data


def read_dcd(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a DCD file.

    Returns (coords (n_frames, N, 3) float32, cells (n_frames, 6) float64 or
    None). Cell rows are the CHARMM (a, gamma, b, beta, alpha, c) layout as
    stored.
    """
    with open(path, "rb") as fh:
        head = fh.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: truncated DCD")
        (n,) = struct.unpack("<i", head[:4])
        endian = "<" if n == 84 else ">"
        fh.seek(0)

        hdr = _read_record(fh, endian)
        if hdr[:4] != b"CORD":
            raise ValueError(f"{path}: not a DCD file")
        icntrl = np.frombuffer(hdr[4:], dtype=np.dtype(endian + "i4"), count=20)
        has_cell = bool(icntrl[10])
        _read_record(fh, endian)  # titles
        natom_rec = _read_record(fh, endian)
        (natoms,) = struct.unpack(endian + "i", natom_rec)

        frames, cells = [], []
        while True:
            if has_cell:
                cell_rec = _read_record(fh, endian)
                if not cell_rec:
                    break
                cells.append(
                    np.frombuffer(cell_rec, dtype=np.dtype(endian + "f8"), count=6)
                )
            x = _read_record(fh, endian)
            if not x:
                break
            y = _read_record(fh, endian)
            z = _read_record(fh, endian)
            fx = np.frombuffer(x, dtype=np.dtype(endian + "f4"), count=natoms)
            fy = np.frombuffer(y, dtype=np.dtype(endian + "f4"), count=natoms)
            fz = np.frombuffer(z, dtype=np.dtype(endian + "f4"), count=natoms)
            frames.append(np.stack([fx, fy, fz], axis=1))

    coords = np.array(frames, np.float32)
    return coords, (np.array(cells) if cells else None)


def write_dcd(
    path: str,
    coords: np.ndarray,
    cell: Optional[np.ndarray] = None,
    start: int = 0,
    step: int = 1,
    dt_akma: float = 0.04091,
):
    """Write (n_frames, N, 3) coordinates as a CHARMM-format DCD."""
    coords = np.asarray(coords, np.float32)
    if coords.ndim == 2:
        coords = coords[None]
    nframes, natoms, _ = coords.shape
    has_cell = cell is not None

    def _rec(fh, payload: bytes):
        fh.write(struct.pack("<i", len(payload)))
        fh.write(payload)
        fh.write(struct.pack("<i", len(payload)))

    icntrl = np.zeros(20, np.int32)
    icntrl[0] = nframes
    icntrl[1] = start
    icntrl[2] = step
    icntrl[3] = nframes * step
    icntrl[9] = np.float32(dt_akma).view(np.int32)
    icntrl[10] = 1 if has_cell else 0
    icntrl[19] = 24  # CHARMM version

    with open(path, "wb") as fh:
        _rec(fh, b"CORD" + icntrl.tobytes())
        title = b"REMARKS written by molecular_dynamics_tpu".ljust(80)
        _rec(fh, struct.pack("<i", 1) + title)
        _rec(fh, struct.pack("<i", natoms))
        for f in range(nframes):
            if has_cell:
                c = np.asarray(cell, np.float64)
                row = c[f] if c.ndim == 2 else c
                _rec(fh, row.astype("<f8").tobytes())
            frame = coords[f]
            for d in range(3):
                _rec(fh, frame[:, d].astype("<f4").tobytes())
