"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``build/lib<name>.so`` inside the package (a directory
git ignores; :func:`set_build_dir`, the CLI's ``--cache-dir``, names
another), then loaded with ``ctypes``. Nothing is compiled when a module
is imported: the first wrapper call on a CUDA tensor builds its library, and
:func:`build_all` builds every source at once, one ``nvcc`` process per
source, all started together.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def set_build_dir(path) -> None:
    """Build the kernels into (and load them from) ``path`` from now on;
    libraries already loaded stay loaded."""
    global BUILD
    BUILD = Path(path).resolve()


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return (not lib.exists()
            or lib.stat().st_mtime < (CSRC / f"{name}.cu").stat().st_mtime)


def build_all(names=None, force: bool = False) -> dict:
    """Compile every stale source (every source with ``force``) in parallel.
    Returns ``{name: {"seconds": s, "log": ptxas output}}`` for what was
    built; raises with the compiler output if any build fails."""
    names = sources() if names is None else list(names)
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = BUILD / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    out, errors = {}, []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"nvcc {n}.cu failed ({p.returncode}):\n{log}")
            continue
        os.replace(tmp, _lib_path(n))
        out[n] = {"seconds": time.perf_counter() - t0, "log": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a launch."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
