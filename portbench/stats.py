"""The benchmark's arithmetic: the yardstick that later changes to the
program cannot move.

  * rates over a completion-aligned window, percentiles, interval unions;
  * the red-black sweep's least traffic: read u and f, write the result,
    4 bytes each (evostencils_torch/measure.py keeps the same count), over
    the H100 SXM's 3.35 TB/s of device memory (NVIDIA's data sheet).
"""

from __future__ import annotations

import math
from typing import Iterable, List, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
RB_SWEEP_BYTES_PER_POINT = 12


def rate_per_hour(completed: int, window_s: float) -> float:
    """Completed requests per hour over a window that ends at the last
    completion, so no request is cut off or dropped."""
    if window_s <= 0.0:
        raise ValueError("an empty window has no rate")
    return completed / window_s * 3600.0


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) of all values, linear between ranks."""
    if not values:
        raise ValueError("no values")
    ordered = sorted(values)
    position = (len(ordered) - 1) * q / 100.0
    lo = math.floor(position)
    hi = min(lo + 1, len(ordered) - 1)
    return ordered[lo] + (ordered[hi] - ordered[lo]) * (position - lo)


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the union of [start, end) intervals."""
    total = 0.0
    current_start = current_end = None
    for start, end in sorted(intervals):
        if current_end is None or start > current_end:
            if current_end is not None:
                total += current_end - current_start
            current_start, current_end = start, end
        elif end > current_end:
            current_end = end
    if current_end is not None:
        total += current_end - current_start
    return total


def idle_gaps(intervals: Iterable[Tuple[float, float]], start: float, end: float
              ) -> List[Tuple[float, float]]:
    """The gaps in [start, end) that no interval covers, in time order."""
    gaps = []
    cursor = start
    for s, e in sorted(intervals):
        if s > cursor:
            gaps.append((cursor, min(s, end)))
        cursor = max(cursor, e)
        if cursor >= end:
            break
    if cursor < end:
        gaps.append((cursor, end))
    return [g for g in gaps if g[1] > g[0]]


def rb_sweep_points(shape: Sequence[int]) -> int:
    """Points one launch updates: rows × cols, times the members of a
    batched launch (rows, cols) or (members, rows, cols)."""
    points = 1
    for extent in shape:
        points *= int(extent)
    return points


def rb_sweep_bound_s(launches_by_shape) -> float:
    """Least device time the sweeps of `launches_by_shape` (shape ->
    launches) could take: their bytes over the device-memory rate."""
    total_bytes = sum(RB_SWEEP_BYTES_PER_POINT * rb_sweep_points(shape) * count
                      for shape, count in launches_by_shape.items())
    return total_bytes / HBM_BYTES_PER_S
