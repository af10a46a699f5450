"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Every ``csrc/*.cu`` file is compiled into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in ``_cuda_build/`` next to this file, named by a hash of
the sources and flags, and is built at the first ``load()`` of a
process that finds no library for the current sources.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_cuda_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()
_lib = None


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then /usr/local/cuda/bin, then PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            cand = Path(home) / "bin" / "nvcc"
            if cand.exists():
                return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libswarm_torch_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> str:
    """Compile the library if it is missing; returns nvcc's messages
    (with ``verbose``, ptxas' register and spill report per kernel)."""
    so = library_path()
    if so.exists() and not verbose:
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *(str(s) for s in CSRC.glob("*.cu"))]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n{r.stderr}")
    os.replace(tmp, so)
    return r.stdout + r.stderr


def load() -> ctypes.CDLL:
    """The kernel library, built on first use and bound once."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(library_path()))
            vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            lib.swarm_d2_diffs.argtypes = [
                vp, i64, vp, vp, vp, i64, i32, i32, i32, i32, i32, vp, vp,
            ]
            lib.swarm_d2_diffs.restype = i32
            lib.swarm_d2_max_w.argtypes = []
            lib.swarm_d2_max_w.restype = i32
            _lib = lib
        return _lib
