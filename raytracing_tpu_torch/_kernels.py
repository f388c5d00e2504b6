"""Build and load the port's CUDA kernels.

``library()`` compiles every ``csrc/*.cu`` with ``nvcc`` for sm_90a into
one shared library under ``_build/`` (keyed by a hash of the sources and
flags, so a changed source rebuilds) and loads it with ``ctypes``. The
sources expose plain ``extern "C"`` entry points, so the build includes no
PyTorch headers and takes seconds. It runs at the first CUDA launch;
importing the package needs no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Kernels:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    build_log: str        # nvcc's output (ptxas registers and spills)


_loaded: Kernels | None = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels "
                       "are built from raytracing_tpu_torch/csrc with nvcc")


def _declare(lib: ctypes.CDLL) -> None:
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.rt_trace_block.argtypes = [P, I, P, I, P, I, P, P, I, P, P, P, U, U, I, I,
                                   F, F, F, I, P]
    lib.rt_trace_block.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p


def library() -> Kernels:
    """Build (if needed) and load the kernel library; cached per process."""
    global _loaded
    if _loaded is not None:
        return _loaded
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    so = BUILD_DIR / f"rt_kernels_{digest.hexdigest()[:16]}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{log}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _loaded = Kernels(lib, so, seconds, log)
    return _loaded
