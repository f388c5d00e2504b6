"""Build and load the port's CUDA kernels.

``library()`` compiles every ``csrc/*.cu`` with ``nvcc`` for sm_90a, one
``nvcc`` per source, all started together, and links the objects into one
shared library under ``_build/`` (keyed by a hash of the sources, headers
and flags, so a changed source rebuilds), which it loads with ``ctypes``.
The sources expose plain ``extern "C"`` entry points, so the build
includes no PyTorch headers and takes seconds. It runs at the first CUDA
launch; importing the package needs no ``nvcc``.
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

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


@dataclass
class Kernels:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    build_log: str        # nvcc's output (ptxas registers, stack and spills)


_loaded: Kernels | None = None


class DeviceCount:
    """A count kept on the device that adds to it: a 0-d int64 counter a
    device, made at its first use, which kernels add to on their stream
    (:meth:`tensor` gives a kernel its address). A kernel captured into a
    CUDA graph adds on every replay of the graph. ``int()`` reads the total
    (a host sync); :meth:`reset` zeroes every counter in place, so graphs
    captured before go on adding to it."""

    def __init__(self):
        self._counts: dict[torch.device, torch.Tensor] = {}

    def tensor(self, dev: torch.device) -> torch.Tensor:
        """The counter on ``dev``, made outside any capture."""
        count = self._counts.get(dev)
        if count is None:
            if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("a kernel's first launch on a device is under CUDA graph "
                                   "capture: launch it once eagerly (a warm-up) first")
            count = self._counts[dev] = torch.zeros((), dtype=torch.int64, device=dev)
        return count

    def reset(self) -> None:
        for count in self._counts.values():
            count.zero_()

    def __int__(self) -> int:
        return sum(int(count) for count in self._counts.values())

    def __repr__(self) -> str:
        return f"{type(self).__name__}({int(self)})"


class LaunchCount(DeviceCount):
    """A kernel wrapper's launches, counted on the device that runs them.

    :meth:`add` adds one to the launch device's counter, on the stream the
    kernel was launched on, right beside the launch: an eager launch adds
    one when it runs, and a launch captured into a CUDA graph adds one on
    every replay of the graph (the capture itself runs nothing, so it adds
    nothing)."""

    def add(self, dev: torch.device) -> None:
        self.tensor(dev).add_(1)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels "
                       "are built from raytracing_tpu_torch/csrc with nvcc")


def _declare(lib: ctypes.CDLL) -> None:
    P, I, U, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.rt_trace_block.argtypes = [P, I, P, I, P, I, P, P, I, P, P, P, P, P, U, U, I, I,
                                   F, F, F, I, I, I, P, P, P, P, I, P, I, P, I, P, F, F, F, F, F, I,
                                   P, P, U, I, P, I, P, P]
    lib.rt_trace_block.restype = ctypes.c_int
    lib.rt_trace_group.argtypes = [P, I, I, P, I, P, P, I, P, P, P, P, I, P, P, P, U, U, I,
                                   F, F, F, I, I, I, P, P, P, P]
    lib.rt_trace_group.restype = ctypes.c_int
    lib.rt_trace_group_probe.argtypes = [P, I, I, P, I, P, P, I, P, P, P, P, I, P, P, P, U, U,
                                         I, F, F, F, I, P, P]
    lib.rt_trace_group_probe.restype = ctypes.c_int
    lib.rt_replay_fwd.argtypes = [P, P, P, P, P, I, I, I, I, U, F, F, F, P, P, P, P]
    lib.rt_replay_fwd.restype = ctypes.c_int
    lib.rt_replay_fwd_probe.argtypes = [P, P, P, P, P, I, I, I, I, U, F, F, F, P, P, P, I, P,
                                        P]
    lib.rt_replay_fwd_probe.restype = ctypes.c_int
    lib.rt_replay_bwd.argtypes = [P, P, P, P, P, P, I, I, I, I, U, F, F, F, P, P]
    lib.rt_replay_bwd.restype = ctypes.c_int
    lib.rt_table_gather.argtypes = [P, P, I, I, I, P, P]
    lib.rt_table_gather.restype = ctypes.c_int
    lib.rt_table_fold.argtypes = [P, P, P, I, I, I, I, P, P]
    lib.rt_table_fold.restype = ctypes.c_int
    lib.rt_bvh_walk.argtypes = [P, P, P, I, P, P, P, P, I, P, P, P, I, P, P, P, P, P, P, P, F,
                                F, I, P, P, P]
    lib.rt_bvh_walk.restype = ctypes.c_int
    lib.rt_camera_rays.argtypes = [P, P, I, P, U, I, U, P, P]
    lib.rt_camera_rays.restype = ctypes.c_int
    lib.rt_while_build.argtypes = [P, P, ctypes.POINTER(P)]
    lib.rt_while_build.restype = ctypes.c_int
    lib.rt_while_launch.argtypes = [P, P]
    lib.rt_while_launch.restype = ctypes.c_int
    lib.rt_while_destroy.argtypes = [P]
    lib.rt_while_destroy.restype = ctypes.c_int
    lib.rt_stage_mark_launch.argtypes = [P, I, I, I, P]
    lib.rt_stage_mark_launch.restype = ctypes.c_int
    lib.rt_globaltimer_probe_launch.argtypes = [P, I, P]
    lib.rt_globaltimer_probe_launch.restype = ctypes.c_int
    lib.rt_graph_kernel_nodes.argtypes = [P, ctypes.POINTER(I), ctypes.POINTER(I)]
    lib.rt_graph_kernel_nodes.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p


def library() -> Kernels:
    """Build (if needed) and load the kernel library; cached per process."""
    global _loaded
    if _loaded is not None:
        return _loaded
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    key = digest.hexdigest()[:16]
    so = BUILD_DIR / f"rt_kernels_{key}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tag = f"{key}.{os.getpid()}"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in sources:
            obj = BUILD_DIR / f"{src.stem}.{tag}.o"
            cmd = [nvcc, *COMPILE_FLAGS, "-o", str(obj), str(src)]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        failed = []
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                failed.append(" ".join(cmd))
        if failed:
            raise RuntimeError(f"nvcc failed ({'; '.join(failed)}):\n{log}")
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        log += r.stdout + r.stderr
        for obj in objs:
            obj.unlink(missing_ok=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({' '.join(cmd)}):\n{log}")
        seconds = time.perf_counter() - t0
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    _loaded = Kernels(lib, so, seconds, log)
    return _loaded
