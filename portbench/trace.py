"""The traced sub-window: device activity from torch.profiler over the first
requests of the window, reduced to what the per-layer metrics read.

Only device activity is recorded (kernels, copies, fills): a search
evaluation launches tens of thousands of operations, and host events would
multiply the trace and its reduction.  What the host was doing is marked on
the device instead: at each span the benchmark opens (`Spans.enter`), a
traced run launches one empty spin kernel, so the device's own timeline
says which span every idle gap falls in.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from portbench import stats

MARKER = "spin_kernel"


class Spans:
    """Host spans the benchmark opens around its calls into the program;
    with markers on, each span's start is also marked on the device."""

    def __init__(self):
        self.markers = False
        self.labels: List[str] = []
        self.seconds = collections.defaultdict(float)
        self.counts = collections.Counter()

    def enter(self, name: str):
        return _Span(self, name)


class _Span:
    def __init__(self, spans: Spans, name: str):
        self.spans, self.name = spans, name

    def __enter__(self):
        if self.spans.markers:
            self.spans.labels.append(self.name)
            torch.cuda._sleep(0)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.seconds[self.name] += time.perf_counter() - self.t0
        self.spans.counts[self.name] += 1
        return False


def device_events(profiler) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device event the profiler kept."""
    out = []
    for event in profiler.profiler.kineto_results.events():
        if event.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        out.append((event.name(), int(event.start_ns()), int(event.end_ns())))
    return out


class TraceSummary:
    """The sub-window's device timeline, reduced."""

    def __init__(self, events, labels: List[str], window_s: float, requests: int,
                 launches_by_shape: Dict[tuple, int]):
        self.window_s = window_s
        self.requests = requests
        self.launches_by_shape = launches_by_shape
        events = sorted(events, key=lambda e: e[1])
        markers = [e for e in events if MARKER in e[0]]
        work = [e for e in events if MARKER not in e[0]]
        self.device_ops = len(work)
        intervals = [(s * 1e-9, e * 1e-9) for _, s, e in work]
        self.busy_s = stats.union_length(intervals)
        by_name = collections.defaultdict(float)
        for name, s, e in work:
            by_name[name] += (e - s) * 1e-9
        self.seconds_by_name = dict(by_name)
        self.rb_sweep_s = sum(v for k, v in by_name.items() if "rb_sweep" in k)
        # Idle gaps between the first and the last device event, cut at the
        # markers, each piece labelled by the span whose marker came last
        # before it.
        self.gaps: List[Tuple[str, float]] = []
        if work:
            first, last = min(s for s, _ in intervals), max(e for _, e in intervals)
            starts = [s * 1e-9 for _, s, _ in markers]
            names = [labels[i] if i < len(labels) else "unlabelled" for i in range(len(starts))]
            for g0, g1 in stats.idle_gaps(intervals, first, last):
                k = int(np.searchsorted(starts, g0, side="right")) - 1
                cuts = [t for t in starts[k + 1:] if t < g1]
                for a, b in zip([g0] + cuts, cuts + [g1]):
                    self.gaps.append((names[k] if k >= 0 else "before the first span", b - a))
                    k += 1

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps, each named by the span the host was in."""
        ops = sorted(self.seconds_by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps, key=lambda g: -g[1])[:10]
        return {"device_ops": [[name, seconds] for name, seconds in ops],
                "idle_gaps": [[label, seconds] for label, seconds in gaps]}

    def save(self, path: str, events) -> None:
        """A bounded copy of the sub-window's device events (names, starts,
        durations) for a later look; a few MB at most."""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        names = sorted({e[0] for e in events})
        index = {n: i for i, n in enumerate(names)}
        np.savez_compressed(
            path, names=np.array(names), name=np.array([index[e[0]] for e in events], np.int32),
            start_ns=np.array([e[1] for e in events], np.int64),
            duration_ns=np.array([e[2] - e[1] for e in events], np.int64))


class Profile:
    """torch.profiler over device activity, started and stopped around the
    sub-window."""

    def __init__(self):
        self.profiler: Optional[torch.profiler.profile] = None

    def start(self) -> None:
        self.profiler = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.profiler.__enter__()

    def stop(self):
        torch.cuda.synchronize()
        self.profiler.__exit__(None, None, None)
        return device_events(self.profiler)
