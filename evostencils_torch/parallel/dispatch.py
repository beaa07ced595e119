"""Population-evaluation dispatch (counterpart of
evostencils_tpu/parallel/dispatch.py).

The reference evolution distributes offspring across MPI ranks, each rank
evaluating its share and exchanging fitnesses.  Every evolved individual is
a different program, so the unit of parallel work is one evaluation:

* `ThreadPoolDispatcher` evaluates individuals in threads of one process.
  The interpreter lock serialises the host work of building and driving a
  cycle, which bounds an evaluation on the card, so threads overlap only
  where torch releases the lock (device waits) and do not raise the rate
  of evaluations there (PERF.md §6).  Concurrent evaluations share the card
  and the host, so each one's measured time includes the others' work.
* `SerialDispatcher` evaluates them one after another.
* `MultiHostDispatcher` splits a population round-robin across the
  processes of a torch.distributed process group and all-gathers the
  fitnesses, so every process ends with the whole, ordered list.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist


class ThreadPoolDispatcher:
    """Evaluate individuals concurrently in a pool of `max_workers`
    threads (default min(8, CPU count))."""

    def __init__(self, max_workers: int | None = None):
        if max_workers is None:
            max_workers = min(8, (os.cpu_count() or 4))
        self.max_workers = max_workers

    def map(self, fn: Callable, items: Sequence) -> List:
        if len(items) <= 1 or self.max_workers == 1:
            return [fn(item) for item in items]
        # Generous worker stacks: building and walking deep cycle
        # expressions recurses further than the default thread stack holds.
        previous = threading.stack_size()
        try:
            threading.stack_size(64 * 1024 * 1024)
        except (ValueError, RuntimeError):
            previous = None
        try:
            with concurrent.futures.ThreadPoolExecutor(self.max_workers) as pool:
                return list(pool.map(fn, items))
        finally:
            if previous is not None:
                try:
                    threading.stack_size(previous)
                except (ValueError, RuntimeError):
                    pass


class SerialDispatcher:
    def map(self, fn: Callable, items: Sequence) -> List:
        return [fn(item) for item in items]


class MultiHostDispatcher:
    """Round-robin split of a population across the processes of the
    initialised torch.distributed process group.

    Process i evaluates items i, i + n, i + 2n, ... through `inner`; the
    fitnesses travel as float64 rows (index, arity, fitness values, NaN
    padding) of a fixed width in one `all_gather` on the gloo backend: the
    rows are host data, so gloo serves processes on the card as well.  The
    caller initialises the group (scripts/torch_optimize.py --multihost
    does it from torchrun's environment); there is no serial fallback.
    """

    # Fixed wire width: every process sends the same shape, whatever its
    # slice (an empty one, or one that saw only 1-objective fitnesses).
    # Large enough for every fitness arity in the framework.
    MAX_FITNESS_WIDTH = 4

    def __init__(self, inner=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "MultiHostDispatcher needs an initialised torch.distributed process "
                "group (torch.distributed.init_process_group(backend='gloo', ...))")
        if "gloo" not in str(dist.get_backend()):
            raise RuntimeError(
                f"MultiHostDispatcher gathers host rows over gloo; the process group's "
                f"backend is {dist.get_backend()!r}")
        self.process_index = dist.get_rank()
        self.process_count = dist.get_world_size()
        self.inner = inner or ThreadPoolDispatcher()

    def map(self, fn: Callable, items: Sequence) -> List:
        mine = [
            (i, item)
            for i, item in enumerate(items)
            if i % self.process_count == self.process_index
        ]
        local_results = self.inner.map(fn, [item for _, item in mine])
        if self.process_count == 1:
            return local_results
        width = self.MAX_FITNESS_WIDTH
        rows = np.full((len(items), width + 2), np.nan)
        for (i, _), fit in zip(mine, local_results):
            fit = tuple(fit)
            rows[i, 0] = i
            rows[i, 1] = len(fit)
            rows[i, 2 : 2 + len(fit)] = fit
        local = torch.from_numpy(rows)
        gathered = [torch.empty_like(local) for _ in range(self.process_count)]
        dist.all_gather(gathered, local)
        results: List = [None] * len(items)
        for process_rows in gathered:
            for row in process_rows.numpy():
                if not np.isnan(row[0]):
                    arity = int(row[1])
                    results[int(row[0])] = tuple(float(v) for v in row[2 : 2 + arity])
        return results
