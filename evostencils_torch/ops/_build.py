"""Build the package's CUDA sources at first use and load them with ctypes.

`nvcc` compiles every `evostencils_torch/csrc/*.cu` into one shared library
with a plain C interface under `build/evostencils_torch/` at the root of
the checkout.  The file name carries a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  The
build uses only the repository's sources and the CUDA toolkit (`nvcc` from
`$CUDA_HOME/bin`, `/usr/local/cuda/bin` or `PATH`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from evostencils_torch import CudaKernelError

SOURCE_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = SOURCE_DIR.parent.parent / "build" / "evostencils_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_library = None
# Serialises the build and the load: two threads that launch the kernel
# first must not both run nvcc into the same target.
_library_lock = threading.Lock()
# Seconds the nvcc run took in this process (None: loaded a built library)
# and what nvcc printed, including ptxas' register and shared-memory use.
build_seconds = None
build_log = ""


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise CudaKernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SOURCE_DIR.glob("*.cu")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return BUILD_DIR / f"libevostencils_torch_{digest.hexdigest()[:16]}.so"


def _compile(target: Path) -> None:
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    command = [_nvcc(), *NVCC_FLAGS, "-o", str(partial),
               *(str(p) for p in sorted(SOURCE_DIR.glob("*.cu")))]
    t0 = time.perf_counter()
    proc = subprocess.run(command, capture_output=True, text=True)
    if proc.returncode != 0:
        raise CudaKernelError(
            f"nvcc exited with {proc.returncode}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(partial, target)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _library
    with _library_lock:
        if _library is None:
            target = library_path()
            if not target.exists():
                _compile(target)
            lib = ctypes.CDLL(str(target))
            # Every pointer and the stream as c_void_p: ctypes would pass a
            # bare Python int as a 32-bit int and cut the pointer.
            # The stencil's coefficients and presence bits are host arrays.
            stencil = [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint32),
                       ctypes.c_int, ctypes.c_float]
            lib.rb_sweep_f32.argtypes = [ctypes.c_void_p] * 4 + stencil + [
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.rb_sweep_f32.restype = ctypes.c_int
            # The batched launch takes the member count before the shape.
            lib.rb_sweep_f32_batched.argtypes = [ctypes.c_void_p] * 4 + stencil + [
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.rb_sweep_f32_batched.restype = ctypes.c_int
            # The constant-stencil kernel: mode, in, out, the host arrays of
            # offsets and weights, the count, members, both shapes and the
            # coarsening factors.
            for name, scalar in (("stencil2d_f32", ctypes.c_float),
                                 ("stencil2d_f64", ctypes.c_double)):
                getattr(lib, name).argtypes = [
                    ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(scalar),
                ] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
                getattr(lib, name).restype = ctypes.c_int
            _library = lib
        return _library
