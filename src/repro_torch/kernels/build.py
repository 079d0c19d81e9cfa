"""Build the CUDA kernels in ``csrc/`` on first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library, ``build/kernels/<name>-<hash>.so`` under the repository root,
where the hash covers the source and the compiler flags, so an edited
source is rebuilt and an unchanged one is reused.  All missing libraries
are compiled together, one ``nvcc`` process per source.  The build is
never attempted on import: the CPU tests import every module and have no
``nvcc``.  A missing ``nvcc`` or a failed build raises; nothing falls back
to the plain PyTorch versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# no --use_fast_math: it swaps expf/logf for approximations and flushes
# denormals, and the EM stop reads the log-likelihood those produce
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("kmeans_assign", "gmm_estep")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signature of each library's entry points (restype, argtypes)
SIGNATURES = {
    "kmeans_assign": {
        "kmeans_assign_launch": (_I, [_P, _L, _P, _L, _P, _P, _P,
                                      _I, _I, _I, _I, _P]),
    },
    "gmm_estep": {
        "gmm_estep_launch": (_I, [_P, _L, _P, _L, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _P]),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the CUDA kernels "
                       "cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{key[:16]}.so"


def build_all(names=SOURCES) -> float:
    """Compile every missing library, one nvcc per source, in parallel.
    Returns the wall seconds spent (0 when everything was built already)."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)          # atomic: readers see whole files
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all()
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (restype, argtypes) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.restype = restype
        f.argtypes = argtypes
    _LIBS[name] = lib
    return lib


def tile_rows(name: str) -> int:
    """Rows per block of ``csrc/<name>.cu``: its exported constant
    ``<name>_tile_rows``, which sizes the per-block partials."""
    return ctypes.c_int.in_dll(load(name), f"{name}_tile_rows").value


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if status == 1:
        raise RuntimeError(f"{what}: CUDA error 1 (cudaErrorInvalidValue): "
                           "a shape the kernel does not take, e.g. K*D "
                           "beyond its shared memory")
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} "
                           "(cudaGetLastError after the launch)")
