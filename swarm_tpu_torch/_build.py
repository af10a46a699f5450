"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Every ``csrc/*.cu`` file is compiled to an object file, all sources at
once (one nvcc process each), and the objects are linked into one
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The library lands in ``_cuda_build/`` next to this
file, named by a hash of the sources and flags, and is built at the
first ``load()`` of a process that finds no library for the current
sources.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    tag = f"{so.stem}.{os.getpid()}"
    sources = sorted(CSRC.glob("*.cu"))
    objects = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.tmp"
    extra = ["-Xptxas", "-v"] if verbose else []
    procs = [
        (src, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, *extra, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, obj in zip(sources, objects)]
    try:
        log = []
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on "
                              f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        r = subprocess.run(
            [nvcc(), "-shared", "-o", str(tmp), *(str(o) for o in objects)],
            capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to link ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, so)
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (*objects, tmp):
            path.unlink(missing_ok=True)
    return "".join(log) + r.stdout + r.stderr


def loaded() -> bool:
    """Whether this process has loaded the kernel library."""
    return _lib is not None


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
            lib.swarm_d2_packed.argtypes = [i64, i32, i32, i32, i32, i32]
            lib.swarm_d2_packed.restype = i32
            lib.swarm_d2_screen.argtypes = [
                vp, vp, vp, vp, i64, i32, i64, i32, vp, vp, vp]
            lib.swarm_d2_screen.restype = i32
            lib.swarm_d2_extract.argtypes = [
                vp, vp, vp, vp, vp, i64, i32, i64, vp, vp, vp]
            lib.swarm_d2_extract.restype = i32
            lib.swarm_d2_csr_tile.argtypes = []
            lib.swarm_d2_csr_count.argtypes = [
                vp, vp, i64, i32, i32, i32, vp, vp]
            lib.swarm_d2_csr_scatter.argtypes = [
                vp, vp, vp, i64, i64, i32, i32, i32, vp, vp, vp, vp, vp, vp]
            lib.swarm_d2_csr_finish.argtypes = [vp, vp, i64, i64, vp, vp, vp]
            for fn in ("tile", "count", "scatter", "finish"):
                getattr(lib, f"swarm_d2_csr_{fn}").restype = i32
            lib.swarm_d2_tasks_tile.argtypes = []
            lib.swarm_d2_tasks_count.argtypes = [
                vp, vp, vp, i64, i64, i32, vp, vp]
            lib.swarm_d2_tasks_emit.argtypes = [
                vp, vp, vp, i64, i64, i32, vp, vp, vp, vp]
            for fn in ("tile", "count", "emit"):
                getattr(lib, f"swarm_d2_tasks_{fn}").restype = i32
            lib.swarm_d1_keygen_count.argtypes = [
                vp, i64, vp, vp, vp, i64, vp, i64, vp, vp]
            lib.swarm_d1_keygen_emit.argtypes = [
                vp, i64, vp, vp, i64, vp, vp, vp, vp]
            lib.swarm_d1_partition_count.argtypes = [
                vp, i64, i32, i32, i32, vp, vp]
            lib.swarm_d1_partition_scatter.argtypes = [
                vp, vp, i64, i32, i32, i32, vp, vp, vp, vp]
            lib.swarm_d1_partition_bounds.argtypes = [vp, i64, i32, vp, vp]
            lib.swarm_d1_join_count.argtypes = [
                vp, vp, vp, i64, vp, vp, vp, vp]
            lib.swarm_d1_join_emit.argtypes = [
                vp, vp, vp, i64, vp, vp, vp, vp, vp]
            lib.swarm_d1_verify.argtypes = [
                vp, i64, vp, vp, i64, vp, i64, vp, vp]
            lib.swarm_d1_partition_tile.argtypes = []
            lib.swarm_d1_join_cap.argtypes = []
            for fn in ("keygen_count", "keygen_emit", "partition_count",
                       "partition_scatter", "partition_bounds", "join_count",
                       "join_emit", "verify", "partition_tile", "join_cap"):
                getattr(lib, f"swarm_d1_{fn}").restype = i32
            lib.swarm_graft_keygen_count.argtypes = [
                vp, i64, vp, vp, i64, vp, i64, vp, vp]
            lib.swarm_graft_keygen_emit.argtypes = [
                vp, i64, vp, vp, i64, vp, i64, vp, i64, vp, vp, vp, vp]
            lib.swarm_graft_join_count.argtypes = [
                vp, vp, vp, i64, vp, vp, vp, vp, vp, vp, vp, vp]
            lib.swarm_graft_join_emit.argtypes = [
                vp, vp, i64, vp, vp, vp, vp, vp, vp]
            lib.swarm_graft_verify.argtypes = [
                vp, i64, vp, vp, i64, vp, vp, i64, vp, vp, i64, vp, i64, i32,
                vp, vp, vp]
            lib.swarm_graft_join_chunk.argtypes = []
            lib.swarm_graft_join_tile.argtypes = []
            for fn in ("keygen_count", "keygen_emit", "join_count",
                       "join_emit", "verify", "join_chunk", "join_tile"):
                getattr(lib, f"swarm_graft_{fn}").restype = i32
            scores = [vp, i64, i64, vp, i64, vp, i32, i64, i32, i32, i32]
            lib.swarm_nw_banded_scores.argtypes = [*scores, i32, vp, vp]
            lib.swarm_nw_banded_scores.restype = i32
            lib.swarm_nw_band_fits.argtypes = [i64, i32, i32, i32]
            lib.swarm_nw_band_fits.restype = i32
            lib.swarm_nw_full_scores.argtypes = [*scores, vp, vp, i64, vp]
            lib.swarm_nw_full_scores.restype = i32
            lib.swarm_nw_full_scratch_ints.argtypes = [i64, i64]
            lib.swarm_nw_full_scratch_ints.restype = i64
            lib.swarm_nw_full_strips.argtypes = [
                ctypes.POINTER(ctypes.c_int), i32]
            lib.swarm_nw_full_strips.restype = i32
            lib.swarm_probe_int32_ops.argtypes = [i32, i32]
            lib.swarm_probe_int32_ops.restype = i64
            lib.swarm_probe_int32_rate.argtypes = [i32, i32, i32, vp, vp]
            lib.swarm_probe_int32_rate.restype = i32
            _lib = lib
        return _lib
