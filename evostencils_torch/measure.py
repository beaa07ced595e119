"""Device timing and the red-black sweep's bound, as chip_smoke.py and
scripts/torch_rb_sweep_levels.py report them.

Importing this module touches no card; the timing needs one.
"""

from __future__ import annotations

import numpy as np
import torch

# Every grid the main path's smoother runs on: levels 6-9 of the 511²
# configuration and level 10 of the 1023² one.
LEVELS = [(63, 63), (127, 127), (255, 255), (511, 511), (1023, 1023)]
# The H100 SXM's device-memory rate (NVIDIA's data sheet), in bytes/ms, and
# the sweep's least traffic: read u and f, write the result, 4 bytes each.
# Its arithmetic (2 flops an entry, a colour each point) stays far below
# 67 TFLOP/s in float32, so bytes bound it.
HBM_BYTES_PER_MS = 3.35e12 / 1e3
BYTES_PER_POINT = 12


def bound_ms(shape) -> float:
    """Least time the card could take for one sweep of this shape."""
    return BYTES_PER_POINT * shape[0] * shape[1] / HBM_BYTES_PER_MS


def median_device_ms(fn, calls: int = 50, repeats: int = 5) -> float:
    """Median device time of one fn() call: `calls` calls back to back
    between two CUDA events, queued behind a spin kernel so that the host
    enqueues them all before the first runs and its launch overhead stays
    out of the span.  The first call warms the L2 as the main path finds it."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))
