"""ctypes binding to the C++ trajectory codecs (``native/mdx_native.cpp``).

The DCD bulk reader/writer, the GROMACS XTC codec, mdx's own compressed
``.mdxtc`` format and an asynchronous trajectory sink whose C++ worker
thread writes frames while the caller goes on.

The library is compiled from ``native/mdx_native.cpp`` with ``g++`` (the
flags of ``native/Makefile``, ``CXX_FLAGS``) at first use, into ``build/mdx_torch_native/``
beside the package, in a file named after a hash of the source and the
flags: a changed source builds anew, an unchanged one is reused. The file
is written under a temporary name and moved into place, so processes that
build at once never load a half-written library. A failed build, or a
library that lacks a symbol or reports another ABI version, raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "mdx_native.cpp"
BUILD_DIR = ROOT / "build" / "mdx_torch_native"
#: the flags of native/Makefile, and ``-include string``: the source uses
#: ``std::string`` without including <string>, which g++ 12's headers bring
#: in by the way and g++ 13's do not
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared", "-pthread", "-include", "string")
ABI_VERSION = 2
_SYMBOLS = (
    "mdx_dcd_write", "mdx_dcd_probe", "mdx_dcd_read",
    "mdx_xtc_write", "mdx_xtc_probe", "mdx_xtc_read",
    "mdx_mdxtc_write", "mdx_mdxtc_probe", "mdx_mdxtc_read",
    "mdx_sink_open", "mdx_sink_push", "mdx_sink_close",
    "mdx_abi_version",
)

_lib = None


def library_path() -> pathlib.Path:
    """Where the library built from the current source lives. Its name
    differs from the JAX package's ``libmdx_native.so``, so one process can
    load both as distinct images."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmdx_native_torch_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library if no up-to-date one exists; return its path."""
    target = library_path()
    if target.exists():
        return target
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"no C++ compiler (g++) to build {SOURCE}")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def _bind(lib):
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64, c_int, path = ctypes.c_int64, ctypes.c_int, ctypes.c_char_p
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    sigs = {
        "mdx_dcd_write": ([path, f32p, i64, i64, ctypes.c_int32, ctypes.c_int32], c_int),
        "mdx_dcd_probe": ([path, p_i64, ctypes.POINTER(ctypes.c_int32)], i64),
        "mdx_dcd_read": ([path, f32p, i64, i64], c_int),
        "mdx_xtc_write": ([path, f32p, i64, i64, ctypes.c_float], c_int),
        "mdx_xtc_probe": ([path, p_i64], i64),
        "mdx_xtc_read": ([path, f32p, i64, i64, i32p, f32p], c_int),
        "mdx_mdxtc_write": ([path, f32p, i64, i64, ctypes.c_float], c_int),
        "mdx_mdxtc_probe": ([path, p_i64], i64),
        "mdx_mdxtc_read": ([path, f32p, i64, i64], c_int),
        "mdx_sink_open": ([path, i64, c_int], ctypes.c_void_p),
        "mdx_sink_push": ([ctypes.c_void_p, f32p, i64], c_int),
        "mdx_sink_close": ([ctypes.c_void_p], i64),
    }
    for name, (argtypes, restype) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype


def _load():
    """The bound library (built on first use)."""
    global _lib
    if _lib is None:
        path = build()
        lib = ctypes.CDLL(str(path))
        missing = [s for s in _SYMBOLS if not hasattr(lib, s)]
        if missing:
            raise RuntimeError(f"{path} lacks {missing}")
        if lib.mdx_abi_version() != ABI_VERSION:
            raise RuntimeError(
                f"{path}: ABI version {lib.mdx_abi_version()}, expected {ABI_VERSION}")
        _bind(lib)
        _lib = lib
    return _lib


def available() -> bool:
    """True once the library is built and bound (a failed build raises)."""
    return _load() is not None


def _frames(coords) -> np.ndarray:
    """(F, N, 3) contiguous float32 frames of ``coords`` ((N, 3) or (F, N, 3))."""
    coords = np.ascontiguousarray(coords, np.float32)
    coords = coords[None] if coords.ndim == 2 else coords
    if coords.ndim != 3 or coords.shape[2] != 3:
        raise ValueError(f"frames must be (F, N, 3) or (N, 3), got {coords.shape}")
    return coords


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------


def dcd_write(path: str, coords: np.ndarray, start: int = 0, step: int = 1):
    coords = _frames(coords)
    rc = _load().mdx_dcd_write(
        path.encode(), coords, coords.shape[0], coords.shape[1], start, step)
    if rc != 0:
        raise IOError(f"mdx_dcd_write failed ({rc}) for {path}")


def dcd_read(path: str) -> np.ndarray:
    lib = _load()
    n_frames = ctypes.c_int64()
    has_cell = ctypes.c_int32()
    natoms = lib.mdx_dcd_probe(path.encode(), n_frames, has_cell)
    if natoms < 0:
        raise IOError(f"not a DCD file: {path}")
    out = np.empty((n_frames.value, natoms, 3), np.float32)
    rc = lib.mdx_dcd_read(path.encode(), out, n_frames.value, natoms)
    if rc != 0:
        raise IOError(f"mdx_dcd_read failed ({rc}) for {path}")
    return out


def xtc_write(path: str, coords: np.ndarray, precision: float = 1000.0):
    """Write a GROMACS .xtc (magic 1995, xdr3dfcoord compression). Coords
    in Angstrom (stored as nm); precision in 1/nm as in GROMACS: 1000 keeps
    0.001 nm = 0.01 A."""
    coords = _frames(coords)
    rc = _load().mdx_xtc_write(
        path.encode(), coords, coords.shape[0], coords.shape[1], ctypes.c_float(precision))
    if rc != 0:
        raise IOError(f"mdx_xtc_write failed ({rc}) for {path}")


def xtc_read(path: str, with_meta: bool = False):
    """Read a GROMACS .xtc; returns (n_frames, N, 3) float32 Angstrom, or
    (coords, steps, times_ps) with ``with_meta=True``."""
    lib = _load()
    n_frames = ctypes.c_int64()
    natoms = lib.mdx_xtc_probe(path.encode(), n_frames)
    if natoms < 0:
        raise IOError(f"not a GROMACS XTC file (magic 1995 not found): {path}")
    out = np.empty((n_frames.value, natoms, 3), np.float32)
    steps = np.empty(n_frames.value, np.int32)
    times = np.empty(n_frames.value, np.float32)
    rc = lib.mdx_xtc_read(path.encode(), out, n_frames.value, natoms, steps, times)
    if rc != 0:
        raise IOError(f"mdx_xtc_read failed ({rc}) for {path}")
    return (out, steps, times) if with_meta else out


def mdxtc_write(path: str, coords: np.ndarray, precision: float = 1000.0):
    """Write mdx's own compressed trajectory format (magic 19950; a smaller
    header than XTC, not readable by GROMACS: use ``xtc_write`` for that)."""
    coords = _frames(coords)
    rc = _load().mdx_mdxtc_write(
        path.encode(), coords, coords.shape[0], coords.shape[1], ctypes.c_float(precision))
    if rc != 0:
        raise IOError(f"mdx_mdxtc_write failed ({rc}) for {path}")


def mdxtc_read(path: str) -> np.ndarray:
    lib = _load()
    n_frames = ctypes.c_int64()
    natoms = lib.mdx_mdxtc_probe(path.encode(), n_frames)
    if natoms < 0:
        raise IOError(f"not an mdxtc file: {path}")
    out = np.empty((n_frames.value, natoms, 3), np.float32)
    rc = lib.mdx_mdxtc_read(path.encode(), out, n_frames.value, natoms)
    if rc != 0:
        raise IOError(f"mdx_mdxtc_read failed ({rc}) for {path}")
    return out


# ---------------------------------------------------------------------------
# async trajectory sink
# ---------------------------------------------------------------------------


class AsyncTrajectorySink:
    """Background-thread trajectory writer.

    Frames pushed from the simulation loop are queued and written by a C++
    worker thread, so disk I/O never blocks the device feed. ``fmt`` is
    "raw" (packed f32 stream, loadable with np.fromfile) or "dcd"
    (buffered, written as one DCD at close).
    """

    def __init__(self, path: str, n_atoms: int, fmt: str = "raw"):
        self._lib = _load()
        self.n_atoms = n_atoms
        self._handle = self._lib.mdx_sink_open(path.encode(), n_atoms, 0 if fmt == "raw" else 1)

    def push(self, frame: np.ndarray) -> None:
        """Queue one (N, 3) frame; the worker copies it before this returns."""
        frame = np.ascontiguousarray(frame, np.float32)
        if self._handle is None or frame.size != 3 * self.n_atoms:
            raise ValueError(
                f"push of {frame.size} floats to a sink of {self.n_atoms} atoms"
                + (" that is closed" if self._handle is None else ""))
        self._lib.mdx_sink_push(self._handle, frame, frame.size)

    def close(self) -> int:
        """Flush and join; returns the number of frames written."""
        written = self._lib.mdx_sink_close(self._handle)
        self._handle = None
        return int(written)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self._handle:
            self.close()
