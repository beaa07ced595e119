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
  fitnesses, so every process ends with the whole, ordered list.  Given a
  (dp, sp) device mesh (parallel/mesh.py) it splits across the mesh's `dp`
  rows instead, the reference's production topology: the `sp` ranks of a
  row evaluate the row's share together, one individual at a time, each
  individual split by rows over them.

`MultiHostDispatcher.map` records the spans `dispatch.map` (the whole
call), `dispatch.local` (this process's share through `inner`) and
`dispatch.gather` (the rows, the `all_gather` and their unpacking) while a
profiler runs (utils/profiling.span), and always adds to `counters`: maps,
the items this process evaluated and the nanoseconds of its share and of
its gather, which includes the wait for the slowest process.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
import time
from typing import Callable, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from evostencils_torch.backend import graphs
from evostencils_torch.utils import profiling


class Counters(graphs.Counters):
    """What this process's MultiHostDispatcher maps did since the last
    reset(): maps, the items it evaluated (`items_local`), and the ns spent
    on them (`local_ns`) and on gathering every process's results
    (`gather_ns`)."""

    FIELDS = ("maps", "items_local", "local_ns", "gather_ns")


counters = Counters()


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
        # The current card belongs to each thread (CUDA's current device):
        # the workers take the caller's, or a process given its own card
        # (--multihost on a host with several) evaluates on card 0.  Setting
        # a card initialises CUDA; before that every thread is on card 0.
        device = torch.cuda.current_device() if torch.cuda.is_initialized() else None
        try:
            with concurrent.futures.ThreadPoolExecutor(
                    self.max_workers,
                    initializer=None if device is None else torch.cuda.set_device,
                    initargs=() if device is None else (device,)) as pool:
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
    initialised torch.distributed process group, or across the `dp` rows of
    a device mesh.

    Process (row) i of n evaluates items i, i + n, i + 2n, ... through
    `inner`; the fitnesses travel as float64 rows (index, arity, fitness
    values, NaN padding) of a fixed width in one `all_gather` on gloo: the
    rows are host data, so gloo serves processes on the card as well.  Given
    the `layout` (parallel/mesh.MeshLayout) of the generator that evaluates
    on a mesh, it splits over the mesh's `dp` rows and makes that layout's
    measured times the largest within a row (`layout.score_group`), since
    the rows now time different individuals.  The gather then runs over
    the `dp` group, each rank with the rank of the same `sp` index in every
    other row; under NCCL the dispatcher makes gloo twins of the `dp`
    groups (`dist.new_group` is collective: every rank makes every group,
    in the same order).  The mesh's evaluations are collective over `sp`,
    so `inner` defaults to one after another there.  The caller initialises
    the group (scripts/torch_optimize.py --multihost does it from
    torchrun's environment); there is no serial fallback.
    """

    # Fixed wire width: every process sends the same shape, whatever its
    # slice (an empty one, or one that saw only 1-objective fitnesses).
    # Large enough for every fitness arity in the framework.
    MAX_FITNESS_WIDTH = 4

    def __init__(self, inner=None, layout=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "MultiHostDispatcher needs an initialised torch.distributed process "
                "group (torch.distributed.init_process_group(backend='gloo', ...))")
        gloo = "gloo" in str(dist.get_backend())
        if layout is None:
            if not gloo:
                raise RuntimeError(
                    f"MultiHostDispatcher gathers host rows over gloo; the process group's "
                    f"backend is {dist.get_backend()!r}")
            self.process_index = dist.get_rank()
            self.process_count = dist.get_world_size()
            self.group = None
            self.inner = inner or ThreadPoolDispatcher()
            return
        layout.score_group = layout.sp_group
        self.process_index = layout.dp_index
        self.process_count = layout.dp_size
        self.group = layout.dp_group if gloo else self._gloo_dp_group(layout.mesh)
        self.inner = inner or SerialDispatcher()

    @staticmethod
    def _gloo_dp_group(mesh):
        """A gloo group of this rank's `dp` column: every rank makes the
        group of every column, in column order."""
        columns = mesh.mesh.reshape(mesh.size(0), -1).t().tolist()
        rank = dist.get_rank()
        mine = None
        for ranks in columns:
            group = dist.new_group(ranks, backend="gloo")
            if rank in ranks:
                mine = group
        return mine

    def map(self, fn: Callable, items: Sequence) -> List:
        with profiling.span("dispatch.map"):
            mine = [
                (i, item)
                for i, item in enumerate(items)
                if i % self.process_count == self.process_index
            ]
            t0 = time.perf_counter_ns()
            with profiling.span("dispatch.local"):
                local_results = self.inner.map(fn, [item for _, item in mine])
            t1 = time.perf_counter_ns()
            counters.add("maps")
            counters.add("items_local", len(mine))
            counters.add("local_ns", t1 - t0)
            if self.process_count == 1:
                return local_results
            with profiling.span("dispatch.gather"):
                results = self._gather(len(items), mine, local_results)
            counters.add("gather_ns", time.perf_counter_ns() - t1)
            return results

    def _gather(self, count: int, mine: list, local_results: list) -> List:
        """Every process's results, in the order of the items."""
        width = self.MAX_FITNESS_WIDTH
        rows = np.full((count, width + 2), np.nan)
        for (i, _), fit in zip(mine, local_results):
            fit = tuple(fit)
            rows[i, 0] = i
            rows[i, 1] = len(fit)
            rows[i, 2 : 2 + len(fit)] = fit
        local = torch.from_numpy(rows)
        gathered = [torch.empty_like(local) for _ in range(self.process_count)]
        dist.all_gather(gathered, local, group=self.group)
        results: List = [None] * count
        for process_rows in gathered:
            for row in process_rows.numpy():
                if not np.isnan(row[0]):
                    arity = int(row[1])
                    results[int(row[0])] = tuple(float(v) for v in row[2 : 2 + arity])
        return results
