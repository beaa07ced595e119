"""The program's own spans and read counter, for the readers of the
traced sub-window.

The port records spans (evostencils_torch/utils/profiling.py) while a torch
profiler runs, so a traced run's sub-window holds them, stamped on the
clock the profiler stamps its device events with.  `recording(context)`
takes them once per run (`profiling.take()`) and keeps them in the
context.  The device's busy intervals come from the sub-window's events
that the harness keeps in portbench_out/ (`TraceSummary.save`, written
before any reader runs): the newest such file, written after the first
recorded span.  The sub-window ends when its last device operation ends
(the harness synchronises then) and lasts the TraceSummary's `window_s`;
its idle time is what the busy intervals leave of it.

Against a program without the recorder (no `profiling.take`, no
`host_reads` counter) every reader here returns None.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from portbench.trace import MARKER

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "portbench_out")
LOOP = "loop."


def recording(context):
    """The program's recorded spans of this run (taken once, kept in the
    context), or None without a traced run or without the recorder."""
    if "program_spans" not in context:
        context["program_spans"] = None
        if context.get("trace") is not None:
            from evostencils_torch.utils import profiling

            take = getattr(profiling, "take", None)
            if take is not None:
                context["program_spans"] = take().spans
    return context["program_spans"]


def _busy(path: str) -> Optional[np.ndarray]:
    """Merged busy intervals (ns, shape (n, 2)) of the device events saved
    at `path`, spin-kernel markers left out."""
    with np.load(path) as saved:
        names = [str(n) for n in saved["names"]]
        work = ~np.array([MARKER in n for n in names], bool)[saved["name"]]
        starts = saved["start_ns"][work]
        ends = starts + saved["duration_ns"][work]
    if not starts.size:
        return None
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], np.maximum.accumulate(ends[order])
    new = np.concatenate(([True], starts[1:] > ends[:-1]))
    last = np.concatenate((np.flatnonzero(new)[1:] - 1, [starts.size - 1]))
    return np.stack((starts[new], ends[last]), axis=1)


class Idle:
    """The sub-window's device-idle time on the span clock: `idle_in(spans)`
    the idle ns inside the union of [start, end) intervals, `total` all of
    it.  Times count from the sub-window's end (`origin`, integer ns), so
    that float64 keeps them to the nanosecond."""

    def __init__(self, busy: np.ndarray, window_ns: float):
        self.origin = int(busy[-1, 1])
        self.start, self.end = -float(window_ns), 0.0
        busy = np.clip((busy - self.origin).astype(np.float64), self.start, self.end)
        self.idle_start = np.concatenate(([self.start], busy[:, 1]))
        self.idle_end = np.concatenate((busy[:, 0], [self.end]))
        lengths = np.maximum(self.idle_end - self.idle_start, 0.0)
        self.before = np.concatenate(([0.0], np.cumsum(lengths)))
        self.total = float(self.before[-1])

    def _idle_to(self, t: np.ndarray) -> np.ndarray:
        t = np.clip(np.asarray(t, np.float64), self.start, self.end)
        k = np.searchsorted(self.idle_start, t, side="right") - 1
        inside = np.clip(t - self.idle_start[k], 0.0, self.idle_end[k] - self.idle_start[k])
        return self.before[k] + np.maximum(inside, 0.0)

    def idle_in(self, intervals: List[Tuple[int, int]]) -> float:
        """Idle ns inside the union of `intervals`."""
        merged = union(intervals)
        if not merged:
            return 0.0
        a, b = (np.array(merged, np.int64) - self.origin).astype(np.float64).T
        return float(np.sum(self._idle_to(b) - self._idle_to(a)))


def union(intervals) -> List[Tuple[int, int]]:
    """The union of [start, end) intervals as disjoint sorted ones."""
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def idle(context) -> Optional[Idle]:
    """The sub-window's idle time (kept in the context), or None."""
    if "program_idle" not in context:
        context["program_idle"] = None
        spans = recording(context)
        trace = context.get("trace")
        if spans and trace is not None and trace.window_s > 0.0:
            saved = sorted(glob.glob(os.path.join(OUT, "*.trace.npz")), key=os.path.getmtime)
            first = min(s.start_ns for s in spans)
            if saved and os.path.getmtime(saved[-1]) * 1e9 >= first:
                busy = _busy(saved[-1])
                if busy is not None:
                    context["program_idle"] = Idle(busy, trace.window_s * 1e9)
    return context["program_idle"]


def idle_share_in(context, loops_only: bool):
    """Share (%) of the sub-window's idle time inside the program's `loop.*`
    spans, or with `loops_only` False inside any of its spans."""
    window = idle(context)
    if window is None or window.total <= 0.0:
        return None
    spans = [(s.start_ns, s.end_ns) for s in recording(context)
             if not loops_only or s.name.startswith(LOOP)]
    return 100.0 * window.idle_in(spans) / window.total


def loop_idle_share(context):
    return idle_share_in(context, loops_only=True)


def idle_in_spans_share(context):
    return idle_share_in(context, loops_only=False)


def host_work_ms_per(context, root: str):
    """Host ms per `root` span outside every `loop.*` span inside it."""
    spans = recording(context)
    roots = [s for s in spans or () if s.name == root]
    if not roots:
        return None
    loops = union((s.start_ns, s.end_ns) for s in spans if s.name.startswith(LOOP))
    total = 0
    for r in roots:
        inside = sum(max(0, min(e, r.end_ns) - max(s, r.start_ns)) for s, e in loops)
        total += r.end_ns - r.start_ns - inside
    return 1e-6 * total / len(roots)


def span_ms_per(context, name: str, root: str):
    """Ms of the `name` spans per `root` span."""
    spans = recording(context)
    roots = sum(1 for s in spans or () if s.name == root)
    if not roots:
        return None
    return 1e-6 * sum(s.end_ns - s.start_ns for s in spans if s.name == name) / roots


def host_reads_per_request(context):
    """The window's host reads (graphs.counters) per completed request."""
    before, after = context["counters_before"], context["counters_after"]
    if "host_reads" not in after or "host_reads" not in before or not context["completed"]:
        return None
    return (after["host_reads"] - before["host_reads"]) / context["completed"]
