"""Tracing and profiling utilities (the port of
evostencils_tpu/utils/profiling.py).

  * `span(name)` — the port's span recorder.  While a torch profiler runs
    (torch.profiler, `trace` below, or a benchmark's device-only profiler),
    each span records (name, start ns, end ns, parent, request id) into a
    bounded buffer, stamped with `time.time_ns()`: the Unix clock, on which
    the profiler stamps its host events and puts the device's.  A root span
    (`span(name, root=True)`: `compile`, `evaluate`, `solve`) starts a new
    request id; every other span takes its parent's.  With no profiler
    running, `span` returns one shared no-op object and reads no clock.
    `add_time(name, ns)` adds to a timed counter (ns and count) while
    recording; `take()` returns what was recorded and clears it.
  * `trace(logdir)` — context manager around `torch.profiler`: everything
    executed inside (host ops and, on the card, device kernels and copies)
    lands in a Chrome trace under `logdir` (chrome://tracing, Perfetto), and
    the spans and timed counters recorded meanwhile beside it
    (`spans_<pid>_<ns>.json`).  A profiler that cannot start raises: a
    measurement path never runs untraced in silence.
  * `evaluation_report(generator)` — structured counters of a
    TorchProgramGenerator: measured seconds, cycle-VM hit rates, cache
    size, device faults, same-structure groups.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple

from torch.autograd import profiler as _autograd_profiler

# Spans the buffer holds before it counts the rest as overflow: a traced
# search evaluation records about ten, a Helmholtz evaluation a few dozen.
SPAN_CAPACITY = 200_000


def recording() -> bool:
    """True while a torch profiler runs in the process (torch's own flag,
    set for any set of activities)."""
    return _autograd_profiler._is_profiler_enabled


class Span(NamedTuple):
    """A recorded span; `parent` is the index of the enclosing span in the
    same `take()` (-1: none recorded), `request` its root's request id (0:
    no root)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    request: int


class Recording(NamedTuple):
    """What `take()` returns: the closed spans in start order, the spans
    the full buffer turned away, and the timed counters (name -> [ns,
    count])."""

    spans: List[Span]
    overflow: int
    timed: Dict[str, List[int]]


class _Recorder:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count(1)
        self.requests = itertools.count(1)
        self.clear()

    def clear(self) -> None:
        # Each record: [id, name, start_ns, end_ns, parent id, request id].
        self.records: list = []
        self.overflow = 0
        self.timed: Dict[str, List[int]] = {}

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack


_recorder = _Recorder(SPAN_CAPACITY)
_NO_PARENT = (0, None, 0, 0, 0, 0)


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "root", "record")

    def __init__(self, name: str, root: bool):
        self.name, self.root = name, root

    def __enter__(self):
        recorder = _recorder
        stack = recorder.stack()
        parent = stack[-1] if stack else _NO_PARENT
        request = next(recorder.requests) if self.root else parent[5]
        record = self.record = [next(recorder.ids), self.name, time.time_ns(), 0, parent[0],
                                request]
        stack.append(record)
        with recorder.lock:
            if len(recorder.records) < recorder.capacity:
                recorder.records.append(record)
            else:
                recorder.overflow += 1
        return self

    def __exit__(self, *exc):
        self.record[3] = time.time_ns()
        stack = _recorder.stack()
        if stack and stack[-1] is self.record:
            stack.pop()
        return False


def span(name: str, root: bool = False):
    """A context manager that records `name` while a profiler runs."""
    if not recording():
        return _NO_SPAN
    return _Span(name, root)


def add_time(name: str, ns: int) -> None:
    """Adds `ns` and one count to the timed counter `name`."""
    with _recorder.lock:
        entry = _recorder.timed.get(name)
        if entry is None:
            entry = _recorder.timed[name] = [0, 0]
        entry[0] += ns
        entry[1] += 1


def take() -> Recording:
    """The spans closed since the last take(), with the overflow count and
    the timed counters; the buffer is cleared.  A span still open is
    dropped."""
    with _recorder.lock:
        records, overflow, timed = _recorder.records, _recorder.overflow, _recorder.timed
        _recorder.clear()
    closed = [r for r in records if r[3]]
    index = {r[0]: i for i, r in enumerate(closed)}
    spans = [Span(r[1], r[2], r[3], index.get(r[4], -1), r[5]) for r in closed]
    return Recording(spans, overflow, timed)


def self_ns(spans: List[Span]) -> List[int]:
    """Each span's own time: its length less its direct children's."""
    own = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


class Trace(NamedTuple):
    """What `trace` yields: the running profiler, the file its Chrome trace
    is written to and the file of the port's spans, both written when the
    block ends."""

    profiler: object
    path: str
    spans_path: str


def _write_spans(path: str, recorded: Recording) -> None:
    """The spans as Chrome trace events (microseconds from
    `baseTimeNanoseconds`, Unix ns), with the overflow and timed counters."""
    spans = recorded.spans
    base = (min(s.start_ns for s in spans) // 10**9) * 10**9 if spans else 0
    pid = os.getpid()
    events = [{"ph": "X", "cat": "evostencils_torch", "name": s.name, "pid": pid, "tid": 0,
               "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
               "args": {"request": s.request, "parent": s.parent, "self_ns": own}}
              for s, own in zip(spans, self_ns(spans))]
    with open(path, "w") as fh:
        json.dump({"baseTimeNanoseconds": base, "displayTimeUnit": "ms", "traceEvents": events,
                   "overflow": recorded.overflow, "timed_ns": recorded.timed}, fh)


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """Profile the block; host and, for a CUDA `device`, device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace: no CUDA device to trace (pass device='cpu')")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    stamp = f"{os.getpid()}_{time.time_ns()}"
    path = os.path.join(logdir, f"trace_{stamp}.json")
    spans_path = os.path.join(logdir, f"spans_{stamp}.json")
    take()
    with profile(activities=activities) as profiler:
        yield Trace(profiler, path, spans_path)
    profiler.export_chrome_trace(path)
    _write_spans(spans_path, take())


def evaluation_report(generator) -> dict:
    report = {
        "run_time_s": round(generator.run_time_total, 3),
        "solver_cache_entries": len(generator._solver_cache),
        "device_failures": generator._consecutive_device_failures,
        "groups": generator.groups,
        "group_members": generator.group_members,
    }
    report.update(generator.vm_stats())
    return report
