"""Builds and loads the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` file exports a plain C interface. On first use it
is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/`` beside the package, and loaded with :mod:`ctypes`. The
library file is named by a hash of the source and the compiler flags, so
an edited source is rebuilt and never mixed up with a stale build.
Nothing is built when the package is imported: CPU-only hosts (which
have no ``nvcc``) import every module and run the kernels' plain PyTorch
versions instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from typing import Dict

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PACKAGE_DIR), "build")

NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    # keep each multiply and add separately rounded, as in the kernels'
    # plain PyTorch versions
    "-fmad=false",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    # report registers, shared memory and spills per kernel
    "-Xptxas",
    "-v",
)

_LIBRARIES: Dict[str, ctypes.CDLL] = {}
# what nvcc printed (including -Xptxas -v) and how long the build of
# this process took, by source name; empty for libraries found built
build_logs: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "port's CUDA kernels are compiled on first use"
        )
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def load_library(name: str) -> ctypes.CDLL:
    """Returns the loaded library built from ``csrc/<name>.cu``,
    compiling it first if no build of this source exists. Raises when
    ``nvcc`` is missing or the build fails."""
    library = _LIBRARIES.get(name)
    if library is not None:
        return library

    source = os.path.join(_SOURCE_DIR, f"{name}.cu")
    with open(source, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"{name}-{digest}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        partial = f"{path}.{os.getpid()}.partial"
        start = time.perf_counter()
        result = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", partial, source],
            capture_output=True,
            text=True,
            timeout=900,
        )
        if result.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source} "
                f"(exit code {result.returncode}):\n{result.stderr}"
            )
        # atomic publish: a concurrent process never loads half a file
        os.replace(partial, path)
        build_seconds[name] = time.perf_counter() - start
        build_logs[name] = result.stdout + result.stderr
    library = ctypes.CDLL(path)
    _LIBRARIES[name] = library
    return library
