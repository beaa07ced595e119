"""Tracing and profiling utilities (the port of
evostencils_tpu/utils/profiling.py).

  * `trace(logdir)` — context manager around `torch.profiler`: everything
    executed inside (host ops and, on the card, device kernels and copies)
    lands in a Chrome trace under `logdir` (chrome://tracing, Perfetto).  A
    profiler that cannot start raises: a measurement path never runs
    untraced in silence.
  * `evaluation_report(generator)` — structured counters of a
    TorchProgramGenerator: measured seconds, cycle-VM hit rates, cache
    size, device faults, same-structure groups.
  * `bandwidth_utilization(expression, measured_seconds)` — modeled HBM
    bytes per cycle application (models/roofline.estimate_traffic) against
    the H100's 3.35 TB/s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import NamedTuple


class Trace(NamedTuple):
    """What `trace` yields: the running profiler and the file its Chrome
    trace is written to when the block ends."""

    profiler: object
    path: str


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
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=activities) as profiler:
        yield Trace(profiler, path)
    profiler.export_chrome_trace(path)


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


def bandwidth_utilization(expression, measured_seconds: float) -> dict:
    from evostencils_torch.models.roofline import H100_HBM_BANDWIDTH, PerformanceEvaluator

    perf = PerformanceEvaluator()
    traffic = perf.estimate_traffic(expression)
    bw = traffic / max(measured_seconds, 1e-12)
    return {
        "modeled_bytes": int(traffic),
        "achieved_GBps": round(bw / 1e9, 1),
        "utilization_pct_upper_bound": round(100.0 * bw / H100_HBM_BANDWIDTH, 1),
    }
