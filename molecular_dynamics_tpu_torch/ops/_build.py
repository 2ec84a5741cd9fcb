"""Build and load the CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and becomes one shared
library, compiled by ``nvcc`` for ``sm_90a`` at first use and loaded with
``ctypes``. The build goes into ``build/mdx_torch_kernels/`` beside the
package, in a file named after a hash of every source under ``csrc/``, so a
changed source builds anew and an unchanged one is reused. All libraries are
compiled at once, one ``nvcc`` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "mdx_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the most shared memory one CTA may opt in to on sm_90 (227 KB), less a
#: kernel's static shared memory; the kernels that may need more than 48 KB
#: opt in (csrc/shared_memory.cuh), and their wrappers check this limit
SHARED_OPT_IN_BYTES = 232448

_libraries: Dict[str, ctypes.CDLL] = {}
#: wall seconds the last call of :func:`build_all` spent compiling
last_build_seconds = 0.0
#: source name -> what nvcc printed (``-Xptxas -v``: registers, shared
#: memory and spills of each kernel) in the last call of :func:`build_all`
last_build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled on the machine that "
        "holds the card (CUDA toolkit on PATH or under CUDA_HOME)"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}_{_source_hash()}.so"


def build_all(verbose: bool = False) -> Dict[str, pathlib.Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, all in
    parallel. Returns name -> library path. Raises if any compile fails."""
    global last_build_seconds
    t_start = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for src in sorted(CSRC.glob("*.cu")):
        target = library_path(src.stem)
        out[src.stem] = target
        if target.exists():
            continue
        tmp = target.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((
            src, tmp, target,
            subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True),
        ))
    failures = []
    last_build_logs.clear()
    for src, tmp, target, proc in procs:
        log, _ = proc.communicate()
        last_build_logs[src.stem] = log
        if verbose and log:
            print(f"[nvcc {src.name}]\n{log}", flush=True)
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {src.name}:\n{log}")
        else:
            os.replace(tmp, target)
    if failures:
        raise RuntimeError("\n".join(failures))
    last_build_seconds = time.perf_counter() - t_start
    return out


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built on demand)."""
    if name not in _libraries:
        _libraries[name] = ctypes.CDLL(str(build_all()[name]))
    return _libraries[name]


#: what ``kernel_info`` reports (``kernel_occupancy`` in csrc/shared_memory.cuh)
KERNEL_INFO_FIELDS = (
    "registers_per_thread", "static_shared_bytes", "threads_per_cta",
    "ctas_per_sm", "dynamic_shared_bytes",
)


def kernel_info(name: str, symbol: str, argtypes, *args) -> Dict[str, int]:
    """Build facts of one kernel of ``csrc/<name>.cu`` on the current device,
    as its C entry ``symbol`` reports them for the launch that ``args`` (of
    ``argtypes``, the entry's leading arguments) describes."""
    out = (ctypes.c_int * len(KERNEL_INFO_FIELDS))()
    err = kernel_function(name, symbol, [*argtypes, ctypes.c_void_p])(*args, out)
    if err != 0:
        raise RuntimeError(f"{symbol}: CUDA error {err}")
    return dict(zip(KERNEL_INFO_FIELDS, out))


def kernel_function(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of the library built from ``csrc/<name>.cu``,
    with its argument types set and an int (the CUDA error) as its result."""
    fn = getattr(load(name), symbol)
    if not fn.argtypes:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn
