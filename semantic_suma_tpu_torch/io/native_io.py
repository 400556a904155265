"""ctypes bridge to the native C++ prefetching scan loader (counterpart of
``semantic_suma_tpu/io/native_io.py``).

``native/scan_loader.cpp`` (the JAX package's code; a comment names the
reference's file without a machine path) reads
KITTI ``.bin`` files on a worker thread ahead of the consumer. It is built
with ``g++`` at first use into the kernels' build directory
(``ops/cuda_build.BUILD``; the CLI's ``--cache-dir`` names another) under a
temporary name and moved into place, so processes that build it at once
never load a half-written library. A failed build raises with the compiler's output:
there is no silent fallback to numpy (``KITTIReader(prefetch=False)`` asks
for numpy).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops import cuda_build

SRC = Path(__file__).resolve().parent.parent / "native" / "scan_loader.cpp"
CXX_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_build_lock = threading.Lock()
_lib = None


def lib_path() -> Path:
    return cuda_build.BUILD / "libscan_loader.so"


def build() -> Path:
    """Compile the loader with ``g++`` if its library is missing or older
    than the source; returns the library's path. Raises ``RuntimeError``
    with the compiler's output if the build fails (or g++ cannot be run)."""
    out = lib_path()
    if out.exists() and out.stat().st_mtime >= SRC.stat().st_mtime:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"libscan_loader.{os.getpid()}.tmp.so")
    cmd = ["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        p = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot build the native scan loader: "
                           f"{' '.join(cmd)}: {e}") from e
    if p.returncode != 0:
        raise RuntimeError(f"building the native scan loader failed "
                           f"({p.returncode}): {' '.join(cmd)}\n"
                           f"{p.stdout}{p.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _build_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.scan_loader_create.restype = ctypes.c_void_p
            lib.scan_loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, ctypes.c_int]
            lib.scan_loader_read.restype = ctypes.POINTER(ctypes.c_float)
            lib.scan_loader_read.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64)]
            lib.scan_loader_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


class NativeScanLoader:
    """Background-prefetching KITTI ``.bin`` loader: ``read(i)`` returns the
    points ``[N, 3]`` and the max-normalized remissions ``[N]``, as
    ``io.kitti.read_bin`` does."""

    def __init__(self, paths: list[str], prefetch_depth: int = 4):
        lib = _load()
        arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        self._lib = lib
        self._handle = lib.scan_loader_create(arr, len(paths), prefetch_depth)
        if not self._handle:
            raise OSError("scan_loader_create failed")
        self._n = len(paths)

    def read(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        count = ctypes.c_int64()
        ptr = self._lib.scan_loader_read(self._handle, idx,
                                         ctypes.byref(count))
        if not ptr or count.value == 0:
            raise IOError(f"native read failed for scan {idx}")
        flat = np.ctypeslib.as_array(ptr, shape=(count.value,))
        pts = flat.reshape(-1, 4).copy()  # copy out of the ring slot
        rem = pts[:, 3].copy()
        m = rem.max()
        if m > 0:
            rem /= m
        return np.ascontiguousarray(pts[:, :3]), rem

    def __len__(self) -> int:
        return self._n

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.scan_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
