"""ctypes binding for the native runtime (rt_native.cpp), the counterpart
of ``raytracing_tpu.native.rt_native``: built with g++ on first use into
the package's ``_build/`` directory (keyed by a hash of the source and the
flags, so a changed source rebuilds), with a silent NumPy fallback when no
toolchain exists. ``RT_NATIVE=0`` disables the library per call."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "rt_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
# no -march=native: the library must load on any x86-64 host the build
# directory is copied to, and its results do not depend on it
FLAGS = ("-O3", "-std=c++17", "-ffp-contract=off", "-shared", "-fPIC")
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode() + SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"librt_native_{digest}.so"


def _build(so: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, str(SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except Exception as e:  # toolchain absent / compile error → fallback
        print(f"rt_native build failed ({e}); using NumPy fallback", file=sys.stderr)
        return False
    os.replace(tmp, so)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    # honored per *call*, not only on first load: tests flip it to force
    # the NumPy fallback after the library has been used
    if os.environ.get("RT_NATIVE", "1") == "0":
        return None
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = library_path()
    if not so.exists() and not _build(so):
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError:
        return None
    lib.rt_bvh_build.restype = ctypes.c_int32
    lib.rt_bvh_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.rt_write_ppm.restype = ctypes.c_int32
    lib.rt_write_ppm.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32, ctypes.c_int32,
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def build_bvh_flat(bmin: np.ndarray, bmax: np.ndarray, ids: np.ndarray):
    """(n,3) prim bounds + (n,) global ids → (out_min, out_max, prim, miss)
    flat skip-link arrays, or None if the native lib is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(ids)
    bmin = np.ascontiguousarray(bmin, np.float32)
    bmax = np.ascontiguousarray(bmax, np.float32)
    ids = np.ascontiguousarray(ids, np.int32)
    k = 2 * n - 1
    out_min = np.empty((k, 3), np.float32)
    out_max = np.empty((k, 3), np.float32)
    out_prim = np.empty(k, np.int32)
    out_miss = np.empty(k, np.int32)
    got = lib.rt_bvh_build(_fptr(bmin), _fptr(bmax), _iptr(ids), n,
                           _fptr(out_min), _fptr(out_max), _iptr(out_prim), _iptr(out_miss))
    if got != k:
        return None
    return out_min, out_max, out_prim, out_miss


def write_ppm(path: str, img_u8: np.ndarray) -> bool:
    """Write an (h, w, 3) u8 image as ASCII P3 PPM; False if the native lib
    is unavailable or the write failed."""
    lib = _load()
    if lib is None:
        return False
    img = np.ascontiguousarray(img_u8, np.uint8)
    h, w, _ = img.shape
    rc = lib.rt_write_ppm(str(path).encode(),
                          img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w)
    return rc == 0
