"""Lazy ``nvcc`` build of the port's CUDA sources into shared libraries.

Each ``csrc/<name>.cu`` compiles on first use into
``build/lib<name>-<hash>.so`` at the repository root (``build/`` is
git-ignored) with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v

and is loaded with :mod:`ctypes`.  The file name carries a hash of the
source and the flags, so an edited source never loads a stale library.
No fast math: the kernels' exactness depends on IEEE-rounded float32
arithmetic.  :func:`build` returns the compiler's output (``-Xptxas
-v``: registers and shared memory per kernel).

Nothing here runs at import time: the CPU tests import every module of
the package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Mapping, Sequence, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: the repository root's ``build/`` (``src/repro_torch/kernels`` -> root)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(name: str) -> Tuple[Path, str]:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns
    ``(library, compiler output)`` (the output is empty for a library that
    was already built).  Raises with the compiler's output if ``nvcc``
    fails."""
    out = _target(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)                # atomic: readers see whole files
    return out, proc.stdout


def load(name: str, signatures: Mapping[str, Sequence]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use
    (double-checked under a lock: serving threads may first-call
    together), with ``argtypes`` from ``signatures`` (``{function:
    [ctypes types]}``) and an ``int`` (``cudaError_t``) result declared
    for each function."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(build(name)[0]))
                for fn, argtypes in signatures.items():
                    getattr(lib, fn).argtypes = list(argtypes)
                    getattr(lib, fn).restype = ctypes.c_int
                _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA error {err} launching {what}")

