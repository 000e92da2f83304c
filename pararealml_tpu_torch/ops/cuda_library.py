"""Builds and loads the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` file exports a plain C interface. On first use it
is compiled (several sources at once with :func:`build_libraries`, one
``nvcc`` each) with ``nvcc`` for Hopper (``sm_90a``) into a shared library
under ``build/`` beside the package, and loaded with :mod:`ctypes`. The
library file is named by a hash of the source, the headers of ``csrc/``
(``*.cuh``) and the compiler flags, so an edited source or header is
rebuilt and never mixed up with a stale build.
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
from typing import Dict, Sequence

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
# what nvcc printed (including -Xptxas -v) and the seconds from the
# start of the builds to the end of each build made by this process, by
# source name; empty for libraries found built
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


def _library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(
        entry for entry in os.listdir(_SOURCE_DIR) if entry.endswith(".cuh")
    )
    for file_name in [f"{name}.cu"] + headers:
        with open(os.path.join(_SOURCE_DIR, file_name), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build_libraries(names: Sequence[str]) -> None:
    """Compiles every ``csrc/<name>.cu`` of ``names`` that has no build
    yet, one ``nvcc`` process per source, all started together. Raises
    when ``nvcc`` is missing or a build fails."""
    pending = {}
    start = time.perf_counter()
    for name in names:
        path = _library_path(name)
        if not os.path.exists(path) and name not in pending:
            os.makedirs(BUILD_DIR, exist_ok=True)
            partial = f"{path}.{os.getpid()}.partial"
            source = os.path.join(_SOURCE_DIR, f"{name}.cu")
            process = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", partial, source],
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
                text=True,
            )
            pending[name] = (process, source, partial, path)
    failures = []
    for name, (process, source, partial, path) in pending.items():
        try:
            stdout, stderr = process.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            process.kill()
            stdout, stderr = process.communicate()
        if process.returncode != 0:
            failures.append(
                f"nvcc failed to build {source} "
                f"(exit code {process.returncode}):\n{stderr}"
            )
            continue
        # atomic publish: a concurrent process never loads half a file
        os.replace(partial, path)
        build_seconds[name] = time.perf_counter() - start
        build_logs[name] = stdout + stderr
    if failures:
        raise RuntimeError("\n".join(failures))


def load_library(name: str) -> ctypes.CDLL:
    """Returns the loaded library built from ``csrc/<name>.cu``,
    compiling it first if no build of this source exists. Raises when
    ``nvcc`` is missing or the build fails."""
    library = _LIBRARIES.get(name)
    if library is not None:
        return library
    build_libraries([name])
    library = ctypes.CDLL(_library_path(name))
    _LIBRARIES[name] = library
    return library


# -- stream waits on a device word (the CUDA driver API) ----------------------

# CU_DEVICE_ATTRIBUTE_CAN_USE_64_BIT_STREAM_MEM_OPS: the attribute of the
# driver's stream memory operations (the v2 family, CUDA 12) that the card
# reports; the 32-bit wait needs no attribute of its own there
_STREAM_MEM_OPS_ATTRIBUTE = 122
# CU_STREAM_WAIT_VALUE_GEQ: wait until (int32_t)(*address - value) >= 0
_WAIT_VALUE_GEQ = 0
_DRIVER: Dict[str, ctypes.CDLL] = {}
_STREAM_WAITS: Dict[int, bool] = {}


def _driver() -> ctypes.CDLL:
    driver = _DRIVER.get("cuda")
    if driver is None:
        driver = ctypes.CDLL("libcuda.so.1")
        driver.cuStreamWaitValue32_v2.argtypes = [
            ctypes.c_void_p,
            ctypes.c_uint64,
            ctypes.c_uint32,
            ctypes.c_uint,
        ]
        driver.cuStreamWaitValue32_v2.restype = ctypes.c_int
        _DRIVER["cuda"] = driver
    return driver


def stream_waits_usable(device_index: int) -> bool:
    """Whether a stream on card ``device_index`` can wait on a device word
    (:func:`wait_at_least`): the driver is CUDA 12 or later, exports the
    wait and reports its stream memory operations usable on the card.
    False wherever the driver cannot be asked."""
    usable = _STREAM_WAITS.get(device_index)
    if usable is None:
        usable = False
        try:
            driver = _driver()
            version, device, value = (ctypes.c_int() for _ in range(3))
            usable = (
                driver.cuDriverGetVersion(ctypes.byref(version)) == 0
                and version.value >= 12000
                and driver.cuDeviceGet(ctypes.byref(device), device_index)
                == 0
                and driver.cuDeviceGetAttribute(
                    ctypes.byref(value), _STREAM_MEM_OPS_ATTRIBUTE, device
                )
                == 0
                and value.value == 1
            )
        except (OSError, AttributeError):
            usable = False
        _STREAM_WAITS[device_index] = usable
    return usable


def wait_at_least(stream, word, value: int) -> None:
    """Makes the work enqueued on ``stream`` (a ``torch.cuda.Stream``)
    after this call wait until the int32 device word ``word`` (a CUDA
    tensor) is at least ``value``. The wait takes no multiprocessor; the
    caller must make sure that work already enqueued elsewhere sets the
    word, or the stream waits for ever."""
    error = _driver().cuStreamWaitValue32_v2(
        stream.cuda_stream, word.data_ptr(), value, _WAIT_VALUE_GEQ
    )
    if error != 0:
        raise RuntimeError(f"cuStreamWaitValue32 failed ({error})")
