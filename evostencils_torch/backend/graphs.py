"""CUDA graphs for the measurement loops: the counterpart of the JAX
package's compiled measurement functions.

The reference never runs a cycle op by op.  Its cycle VM is one executable
per problem with the program passed in as data (evostencils_tpu/backend/
vm.py), and its stage solve, power iteration and outer BiCGStab solve are
`lax.while_loop`s on the device (evostencils_tpu/backend/evaluation.py
`stage_raw`, `power_raw`, `solve_raw`), each one dispatch that
`block_until_ready` times.  Eager torch launches every op from the host, so
a loop of eager cycles times the host's walk.  Here the work is captured in
CUDA graphs and replayed:

  * the cycle VM's interpreter (`Interpreter`): one graph per ISA branch
    and one prologue per problem hierarchy, captured at first use; a cycle
    replays the prologue and then the program's branches in order, each
    reading its ω at the device program counter, so every translated
    structure runs on the same graphs;
  * a lowered cycle (`StepCycle`, a `Loop` of one body), one graph per
    structure, as the reference compiles a lowered structure per
    structure (and per solver in backend/device_solve.py);
  * the glue of the measurement loops around a cycle: the stage's start,
    residual norm and best-iterate update; the power block's
    renormalisation and rate; the outer BiCGStab iteration's three pieces
    around its two preconditioner cycles.

The host keeps each loop's control and reads one value per cycle or block
(a residual norm or a block rate), which the reference's `while_loop`
condition reads on the device: the same test on the same values, so
iteration counts, exit reasons and best iterates are the eager loop's.

A `Loop` holds static buffers and its bodies, methods that read and write
only those buffers (and those of the cycle it runs).  `run(name)` calls a
body eagerly, or replays its graph once the loop is captured.  Inputs are
filled with `copy_` before a replay, and anything kept from a replay is
copied out before the next one.  `GraphCache` keeps captured loops by key
(the interpreter's glue once per problem hierarchy, a lowered structure's
loops per structure) under a bound on the bytes their graphs and buffers
hold, evicting the least recently used.

A capture that fails raises `CudaGraphError`.  It never runs eagerly in its
place: an eager time beside graph times would corrupt the time objective of
a population.  Captures run one at a time under one lock, in the
`thread_local` error mode, so that a thread pool's other thread may go on
launching eagerly meanwhile.
"""

from __future__ import annotations

import collections
import gc
import threading
import time
import weakref

import torch

import numpy as np

from evostencils_torch import CudaGraphError
from evostencils_torch.backend.vm import Program
from evostencils_torch.ops import rb_sweep
from evostencils_torch.ops import stencil_ops as sops
from evostencils_torch.utils import profiling

# One capture at a time in the process: the warm-ups, the capture stream
# and the allocator's pools are shared.
_capture_lock = threading.RLock()

# Largest bytes one GraphCache holds before it evicts.  A per-structure
# entry (a cycle with its loop's bodies) held 65 MB at 1023² and 37-59 MB at
# 511² on average when every structure had one (chip_smoke.py's main path
# and evolve phases on an H100): 8 GiB keeps about 130 such entries at 1023²
# and 150-230 at 511², a tenth of an 80 GB card.  The interpreter's glue
# takes one entry per loop and problem hierarchy.
DEFAULT_MAX_BYTES = 8 << 30


class Counters:
    """What the process's graphs did since the last reset(): captures,
    failed captures, replays, seconds spent warming up and capturing,
    entries evicted from a GraphCache, and the measurement loops' reads of
    device values to the host (`read`)."""

    FIELDS = ("captures", "capture_failures", "replays", "capture_s", "evictions", "host_reads")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            for name in self.FIELDS:
                setattr(self, name, 0.0 if name.endswith("_s") else 0)

    def add(self, name: str, value=1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + value)

    def as_dict(self) -> dict:
        with self._lock:
            return {name: getattr(self, name) for name in self.FIELDS}


counters = Counters()
_caches = weakref.WeakSet()
_interpreters = weakref.WeakSet()


def bytes_held() -> int:
    """Bytes every live GraphCache and Interpreter of the process holds."""
    return (sum(cache.bytes_held for cache in list(_caches))
            + sum(interpreter.nbytes for interpreter in list(_interpreters)))


def new_pool(device):
    """A private memory pool for graphs on `device`; None off the card."""
    return torch.cuda.graph_pool_handle() if torch.device(device).type == "cuda" else None


def pool_bytes(pool) -> int:
    """Bytes of the allocator's segments in `pool` (0 for None)."""
    if pool is None:
        return 0
    return sum(segment["total_size"] for segment in torch.cuda.memory_snapshot()
               if tuple(segment["segment_pool_id"]) == tuple(pool))


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages under `tensors`."""
    return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                for t in tensors}.values())


class Graph:
    """A captured CUDA graph.  `replay()` launches it and counts the replay
    and the sweep kernel's launches the capture recorded, by grid shape
    (ops/rb_sweep.py: the counter holds launches that reached the device)."""

    def __init__(self, cuda_graph, launches: collections.Counter):
        self._graph = cuda_graph
        self.launches = launches

    def replay(self) -> None:
        """While a profiler runs, the host's ns of the replay go to the
        timed counter `replay` (utils/profiling.py)."""
        t0 = time.time_ns() if profiling.recording() else None
        self._graph.replay()
        if t0 is not None:
            profiling.add_time("replay", time.time_ns() - t0)
        counters.add("replays")
        if self.launches:
            rb_sweep.count_replay(self.launches)


def read(t: torch.Tensor):
    """A loop's read of device values to the host: a 0-d tensor as a Python
    scalar, anything else as a numpy array.  The host waits for every
    launch before it, so the device idles until the host launches again.
    Counted in `counters.host_reads`; while a profiler runs, the host's
    wait goes to the timed counter `read` (utils/profiling.py)."""
    counters.add("host_reads")
    t0 = time.time_ns() if profiling.recording() else None
    value = t.item() if t.dim() == 0 else t.cpu().numpy()
    if t0 is not None:
        profiling.add_time("read", time.time_ns() - t0)
    return value


# One capture stream per device, as torch.cuda.graph keeps one.
_capture_streams = {}


def capture(fn, warmup: int = 1, pool=None):
    """fn() captured once in a CUDA graph: `warmup` eager calls on a side
    stream first, which build every cache fn keeps on the device (masks,
    inverses, coefficient planes, ω tensors, library handles), then the
    capture on a stream of its own, into `pool` when one is given.  Returns
    (Graph, what the captured call returned).

    The capture is torch.cuda.graph's (capture_begin and capture_end on a
    side stream after a synchronise) without its empty_cache(), which would
    hand every cached block of the allocator back to CUDA at each
    capture, and the evaluations after it would allocate them anew.

    An error in the warm-up is fn's own and propagates as it is.  An error
    in the capture (a host read or a host-to-device copy inside fn) raises
    CudaGraphError."""
    device = torch.cuda.current_device()
    with _capture_lock:
        t0 = time.perf_counter()
        side = torch.cuda.Stream(device=device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(warmup):
                fn()
        torch.cuda.synchronize(device)
        if device not in _capture_streams:
            _capture_streams[device] = torch.cuda.Stream(device=device)
        stream = _capture_streams[device]
        graph = torch.cuda.CUDAGraph()
        # A cyclic collection inside the capture may free another graph (a
        # generator's cache that was dropped) on this thread, which the
        # capture forbids: it would fail this capture.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with rb_sweep.recording_launches() as recorded, torch.cuda.stream(stream):
                graph.capture_begin(pool=pool, capture_error_mode="thread_local")
                try:
                    out = fn()
                finally:
                    graph.capture_end()
        except torch.cuda.OutOfMemoryError:
            raise
        except Exception as err:
            counters.add("capture_failures")
            raise CudaGraphError(
                "the loop body cannot be captured in a CUDA graph (a host read or a "
                f"host-to-device copy inside it?): {err}") from err
        finally:
            if collecting:
                gc.enable()
        counters.add("captures")
        counters.add("capture_s", time.perf_counter() - t0)
    return Graph(graph, recorded), out


def _tensors(value):
    if torch.is_tensor(value):
        yield value
    elif isinstance(value, (tuple, list)):
        for item in value:
            yield from _tensors(item)


class Loop:
    """Static buffers and the bodies that work on them.

    A subclass names its bodies in `bodies` (methods without arguments
    that read and write only the loop's tensors and those of its `parts()`)
    and keeps its host logic in methods that call `run(name)`.  Eager until
    `capture_bodies()`; from then on `run` replays.  `lock` serialises the
    host logic of threads that share a cached loop."""

    bodies: tuple = ()

    def __init__(self):
        self._graphs = None
        self.lock = threading.Lock()
        self.nbytes = 0
        self.captures = 0

    def parts(self) -> tuple:
        """Loops captured with this one, into its pool (a lowered cycle
        inside a measurement loop)."""
        return ()

    def run(self, name: str) -> None:
        if self._graphs is None:
            getattr(self, name)()
        else:
            self._graphs[name].replay()

    def capture_bodies(self, pool=None, warmup: int = 1) -> None:
        """Every body, and every part's, captured into one private pool
        (`pool` when given) after `warmup` eager calls each.  The loop
        replays its graphs one after another on one stream and never two at
        once, and its bodies write only into static buffers, so they share
        the pool.  `nbytes`: the pool's segments and the static buffers;
        `captures`: the graphs captured."""
        loops = (self,) + self.parts()
        tensors = [t for loop in loops for value in vars(loop).values() for t in _tensors(value)]
        own_pool = pool is None
        if own_pool:
            pool = new_pool(tensors[0].device if tensors else "cpu")
        self._graphs = {name: capture(getattr(self, name), warmup=warmup, pool=pool)[0]
                        for name in self.bodies}
        self.captures = len(self._graphs)
        for part in self.parts():
            part.capture_bodies(pool, warmup)
            self.captures += part.captures
        self.nbytes = (pool_bytes(pool) if own_pool else 0) + storage_bytes(tensors)


def _omega_values(omega_arg) -> np.ndarray:
    """The float32 ω of a VM Program or of a lowered step's ω vector (one
    row per member for a batch)."""
    if isinstance(omega_arg, Program):
        return np.asarray(omega_arg.omegas[..., :omega_arg.length], dtype=np.float32)
    return np.asarray(omega_arg, dtype=np.float32)


class StepCycle(Loop):
    """One cycle u ← step(u, f, ω) in place on static buffers `u`, `f`
    shaped like `like`: the eager form of every cycle (a VM program through
    `CycleVM.make_step`, or a step lowered from the IR), and on CUDA graphs
    a lowered structure's cycle, captured per structure with the loop that
    runs it (backend/evaluation.py) or per solver (backend/device_solve.py).
    The same protocol as Interpreter: `u`, `f`, `lock`, `load(omega_arg)`,
    `run_cycle()`.  The step gets `omega_arg`'s structure with a static
    float32 ω tensor, which `load` fills.  A batch of members takes state
    shaped (B, *grid) and ω with one row per member (backend/vm.py
    `batched_program`, or a (B, slots) array for a lowered step): on graphs
    one per (structure, bucket), as the reference compiles its vmapped
    power iteration per key and bucket."""

    bodies = ("cycle",)

    def __init__(self, step, omega_arg, like):
        super().__init__()
        self.step = step
        self.omegas = torch.zeros(_omega_values(omega_arg).shape, dtype=torch.float32,
                                  device=like[0].device)
        self.arg = (omega_arg._replace(omegas=self.omegas)
                    if isinstance(omega_arg, Program) else self.omegas)
        self.u, self.f = sops.zeros_like_state(like), sops.zeros_like_state(like)

    def __call__(self, u, f):
        """The step on (u, f) with the loaded ω."""
        return self.step(u, f, self.arg)

    def load(self, omega_arg) -> None:
        self.omegas.copy_(torch.from_numpy(_omega_values(omega_arg)))

    def cycle(self) -> None:
        for d, x in zip(self.u, self(self.u, self.f)):
            d.copy_(x)

    def run_cycle(self) -> None:
        self.run("cycle")


class Interpreter:
    """The cycle VM's interpreter on CUDA graphs (the counterpart of the
    reference's one executable per problem, evostencils_tpu/backend/vm.py).

    `state` is a backend/vm.LevelState: static levels, the program counter
    and the ω buffer.  Its prologue and each branch's body are captured at
    first use (warm-up first: the warm-up is that instruction's real run,
    since a capture runs nothing) into one pool that every graph of the
    interpreter shares: they run one at a time on one stream, and every
    body writes only into the static state, so nothing one leaves alive
    outlives it.  A lazily registered branch adds its own graph; none is
    captured again.

    `load(program)` copies the program's ω into the state; `run_cycle()`
    runs the loaded program once on the finest level (`u`, `f`): the
    prologue's graph, then the branches' graphs in program order, each
    replay counted by Graph.replay (the replays, the sweep kernel's
    recorded launches).  A body that cannot be captured raises
    CudaGraphError; nothing runs eagerly in its place.  `lock` serialises
    the loops and threads that share the state; `captures` counts this
    interpreter's graphs, `nbytes` its pool and state.  Over a LevelState
    with members it runs a batch of same-structure programs (one per
    member, `load` takes backend/vm.batched_program): the group path keeps
    one such interpreter per (VM, bucket), with its own pool and lock, its
    branches captured at their first use in that bucket."""

    def __init__(self, state):
        self.state = state
        self.u, self.f = state.u, state.f
        self.lock = threading.RLock()
        self._pool = new_pool(state.pc.device)
        self._graphs = {}
        self._sequence = ()
        self.captures = 0
        self._nbytes = None
        _interpreters.add(self)

    @property
    def nbytes(self) -> int:
        """The pool's segments and the state, measured when first asked
        after a capture (the allocator's snapshot is not cheap)."""
        if self._nbytes is None:
            self._nbytes = pool_bytes(self._pool) + storage_bytes(self.state.tensors())
        return self._nbytes

    def load(self, program) -> None:
        self._sequence = ("prologue",) + tuple(self.state.load(program))

    def run_cycle(self) -> None:
        for key in self._sequence:
            graph = self._graphs.get(key)
            if graph is not None:
                graph.replay()
                continue
            # The warm-up inside capture() runs this instruction.
            body = self.state.prologue if key == "prologue" else self.state.body(key)
            self._graphs[key] = capture(body, pool=self._pool)[0]
            self.captures += 1
            self._nbytes = None


class GraphCache:
    """Captured loops by key, least recently used first out once the
    entries hold more than `max_bytes` (the newest entry always stays).
    An evicted loop's graphs and buffers are dropped and the allocator's
    cached blocks released; a thread still inside it keeps it alive until
    it returns."""

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES):
        self.max_bytes = max_bytes
        self._entries = collections.OrderedDict()
        self._lock = threading.Lock()
        self.bytes_held = 0
        # Graphs captured for the entries, by the first item of their key.
        self.captures = collections.Counter()
        _caches.add(self)

    def __len__(self) -> int:
        return len(self._entries)

    def _lookup(self, key):
        with self._lock:
            loop = self._entries.get(key)
            if loop is not None:
                self._entries.move_to_end(key)
            return loop

    def get(self, key, make) -> Loop:
        """The loop cached under `key`, or make() captured and cached."""
        loop = self._lookup(key)
        if loop is not None:
            return loop
        with _capture_lock:
            loop = self._lookup(key)
            if loop is not None:
                return loop
            loop = make()
            self._capture(loop)
            with self._lock:
                self._entries[key] = loop
                self.bytes_held += loop.nbytes
                self.captures[key[0] if isinstance(key, tuple) else key] += loop.captures
                evicted = self._evict()
            if evicted:
                del evicted
                self._release()
        return loop

    def _capture(self, loop: Loop) -> None:
        loop.capture_bodies()

    def _release(self) -> None:
        torch.cuda.empty_cache()

    def _evict(self) -> list:
        evicted = []
        while self.bytes_held > self.max_bytes and len(self._entries) > 1:
            _, loop = self._entries.popitem(last=False)
            self.bytes_held -= loop.nbytes
            evicted.append(loop)
            counters.add("evictions")
        return evicted

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.bytes_held = 0
