"""Build the package's CUDA sources at first use, load them with ctypes, and
count their launches.

`nvcc` compiles every `evostencils_torch/csrc/*.cu` into one shared library
with a plain C interface under `build/evostencils_torch/` at the root of
the checkout.  The file name carries a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  The
build uses only the repository's sources and the CUDA toolkit (`nvcc` from
`$CUDA_HOME/bin`, `/usr/local/cuda/bin` or `PATH`).

This module names no kernel.  Each kernel's wrapper declares its own entry
points (`entry`) and counts into its own counters (`counter`, `count`);
backend/graphs.capture records what a capture counted (`recording`) and
each replay of the graph adds it again (`count_replay`).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

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
# The C entry points the wrappers declared (entry()): name -> argtypes.
_entries = {}


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


def entry(name: str, argtypes) -> None:
    """Declare the library's C entry point `name`: its argument types; it
    returns a CUDA error code.  Pass every pointer and the stream as
    c_void_p: ctypes would pass a bare Python int as a 32-bit int and cut
    the pointer."""
    with _library_lock:
        _entries[name] = list(argtypes)
        if _library is not None:
            _declare(_library, name)


def _declare(lib: ctypes.CDLL, name: str) -> None:
    function = getattr(lib, name)
    function.argtypes = _entries[name]
    function.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed, with every entry
    point declared so far."""
    global _library
    with _library_lock:
        if _library is None:
            target = library_path()
            if not target.exists():
                _compile(target)
            lib = ctypes.CDLL(str(target))
            for name in _entries:
                _declare(lib, name)
            _library = lib
        return _library


# Launch accounting, one scheme for every kernel.  A counter holds what
# reached the device since it was cleared: each eager launch where it
# happens, and each launch a CUDA-graph replay runs.  A capture launches
# nothing: backend/graphs.capture records what count() was given while it
# captured, and each replay adds that recording.  The recording is
# thread-local, since threads capture their own graphs at once.
# Counter's += reads and then writes: threads that launch at once would
# lose counts without the lock.
_counts_lock = threading.Lock()
_capturing = threading.local()
# id(counter) -> the part of that counter that replays ran.
_replayed = {}


def counter() -> collections.Counter:
    """A new counter for count(), by any key; `replayed(counter)` is its
    part that graph replays ran."""
    new = collections.Counter()
    _replayed[id(new)] = collections.Counter()
    return new


def replayed(counter: collections.Counter) -> collections.Counter:
    return _replayed[id(counter)]


def count(counter: collections.Counter, key, x: torch.Tensor = None,
          refusal: bool = False) -> None:
    """One more `key` in `counter` for a launch on (or, with `refusal`, a
    gate's refusal of) the tensor `x`.  While x's stream is being captured
    by backend/graphs.capture it goes to that capture's recording, so that
    every replay counts it; under any other capture a launch raises
    CudaKernelError, since nothing would count its replays, and a refusal,
    which ran the plain ops, is counted now.  Without x, on the CPU or
    outside a capture it is counted now."""
    if x is not None and x.device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        recorded = getattr(_capturing, "recording", None)
        if recorded is not None:
            recorded.setdefault(id(counter), (counter, collections.Counter()))[1][key] += 1
            return
        if not refusal:
            raise CudaKernelError(
                "a kernel launched under a CUDA-graph capture that backend/graphs.capture "
                "did not start: its replays would not be counted")
    with _counts_lock:
        counter[key] += 1


@contextlib.contextmanager
def recording():
    """What count() is given on this thread meanwhile, by counter: the
    recording of a CUDA-graph capture (backend/graphs.capture)."""
    recorded = {}
    outer = getattr(_capturing, "recording", None)
    _capturing.recording = recorded
    try:
        yield recorded
    finally:
        _capturing.recording = outer


def count_replay(recorded: dict) -> None:
    """One replay of a graph whose capture recorded `recorded`."""
    with _counts_lock:
        for counter, counts in recorded.values():
            replays = _replayed[id(counter)]
            for key, n in counts.items():
                counter[key] += n
                replays[key] += n


def clear(*counters: collections.Counter) -> None:
    with _counts_lock:
        for counter in counters:
            counter.clear()
            _replayed[id(counter)].clear()
