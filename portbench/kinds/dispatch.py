"""Fitness evaluations of the search pool split over processes by the
port's `MultiHostDispatcher`, as `torchrun --nproc_per_node N
scripts/torch_optimize.py --multihost` evaluates a generation: one process a
card (rank r on card r), a gloo group, and in each process the dispatcher's
default inner `ThreadPoolDispatcher`.

Rank 0 is the harness's process.  It builds the kernel library, starts
ranks 1..N-1 (portbench/dispatch_worker.py, each given its part of the run
on stdin, whose end also tells it that rank 0 is gone) and forms the gloo
group with them through a TCPStore on a free port of 127.0.0.1, under the
traffic's collective timeout.  Before each batch, and before each gathering
of counters, rank 0 broadcasts one command (map, counters, stop) inside a
benchmark span of its own (`dispatch.command`).

A batch is one pass of the mix's order from the seeded offset, one
`MultiHostDispatcher.map` on every rank, each tree evaluated with the
configuration's timing samples.  `request(i)` runs a batch when i is a
multiple of the batch's length and returns its records one by one, so the
window counts evaluations and ends on the first record of the batch that
crosses it.  Set-up: every rank evaluates its share of the order once, one
after another, then one untimed map warms the pool and the gather.

`counters()` holds, besides the search cell's counts, every rank's
`dispatch.counters` (gathered by a command; absent where the program has
none).  A dead rank or a failed collective ends the run at once, with no
result: rank 0 kills the workers and raises SystemExit, since the group can
serve no further request.

The check: the search cell's ρ and iteration gaps against the float64
reference over a seeded sample of the window's trees (kinds/search.check),
`lost_results` (gathered entries missing or NaN), `rank_disagreements`
((rank, batch) pairs whose gathered list differs from rank 0's) and, on
cards, `shared_cards` (the ranks less the distinct cards they evaluated
on, where a rank whose evaluations ran on more than one card gives none).
A rank that loaded a forbidden module ends the run without a result, as
the harness does for rank 0.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import json
import math
import os
import subprocess
import sys
import threading
import time

import torch
import torch.distributed as dist

from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar import gp
from evostencils_torch.parallel import dispatch
from evostencils_torch.problems.poisson import poisson_2d
from portbench import harness
from portbench.kinds import common, search

WORKER = os.path.join(common.HERE, "dispatch_worker.py")
MAP, COUNTERS, STOP = 1, 2, 3


def dispatch_counters():
    """This process's dispatch counters, or None where the program has none."""
    counters = getattr(dispatch, "counters", None)
    return None if counters is None else counters.as_dict()


def digest(results: list) -> str:
    return hashlib.sha256(repr(results).encode()).hexdigest()[:16]


class Rank:
    """One process of the deployment: the search cell's generator and trees
    on this process's card, and a MultiHostDispatcher over the group."""

    def __init__(self, config, traffic, seed, device):
        self.device = device
        self.samples = config["evaluation_samples"]
        dtype = common.DTYPES[config["dtype"]]
        problem = poisson_2d(config["min_level"], config["max_level"], dtype=dtype)
        self.pset, _ = common.primitive_set(problem, config)
        self.generator = TorchProgramGenerator(
            problem, dtype=dtype, iteration_limit=config["iteration_limit"], device=device)
        pool = common.read_pool(common.data_path(traffic["pool"], config))
        self.items = common.seeded_order(traffic["order"], seed, 1)
        self.trees = {i: gp.parse_tree(pool[i], self.pset) for i in traffic["order"]}
        self.dispatcher = dispatch.MultiHostDispatcher()
        self.cards = set()
        self.lock = threading.Lock()
        self.digests = []
        rank, world = dist.get_rank(), dist.get_world_size()
        for index in self.items[rank::world]:
            self.evaluate(index, samples=1)
        self.dispatcher.map(self.evaluate, self.items)

    def evaluate(self, index: int, samples=None) -> tuple:
        """(t, ρ, iterations, 1.0 after a device failure) of one tree; the
        card the evaluating thread is on is noted."""
        expr = gp.compile_tree(self.trees[index], self.pset)[0]
        t, rho, iterations = self.generator.generate_and_evaluate(
            expr, evaluation_samples=samples or self.samples)
        failed = float(self.generator._consecutive_device_failures > 0)
        card = torch.cuda.current_device() if self.device.type == "cuda" else -1
        with self.lock:
            self.cards.add(card)
        return float(t), float(rho), float(iterations), failed

    def batch(self) -> list:
        results = self.dispatcher.map(self.evaluate, self.items)
        self.digests.append(digest(results))
        return results

    def report(self) -> dict:
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        return {"rank": dist.get_rank(), "cards": sorted(self.cards),
                "memory_peak_bytes": int(peak), "digests": self.digests,
                "counters": dispatch_counters(), "forbidden": harness.forbidden_modules()}


def command(code: int) -> int:
    """Rank 0 sends `code`; every other rank receives it."""
    tensor = torch.tensor([code], dtype=torch.int64)
    dist.broadcast(tensor, src=0)
    return int(tensor[0])


def gather_objects(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def serve(spec: dict) -> None:
    """A worker rank: join the group, set up, and obey rank 0's commands
    until it says stop."""
    rank, world = spec["rank"], spec["world"]
    timeout = datetime.timedelta(seconds=spec["timeout_s"])
    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    store = dist.TCPStore("127.0.0.1", spec["port"], world, False, timeout=timeout)
    store.set(f"ready/{rank}", "1")
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world, timeout=timeout)
    state = Rank(spec["config"], spec["traffic"], spec["seed"], device)
    while True:
        code = command(0)
        if code == MAP:
            state.batch()
        elif code == COUNTERS:
            gather_objects(dispatch_counters())
        elif code == STOP:
            gather_objects(state.report())
            break
    dist.destroy_process_group()


class Work:
    def __init__(self, config, traffic, seed, device, spans):
        self.spans = spans
        self.world = config["ranks"]
        if len(traffic["order"]) != config["population"]:
            raise ValueError("a batch is one pass of the order: its length is the population")
        self.timeout_s = traffic["collective_timeout_s"]
        timeout = datetime.timedelta(seconds=self.timeout_s)
        if device.type == "cuda":
            from evostencils_torch.ops import _build

            torch.cuda.set_device(0)
            _build.library()
        store = dist.TCPStore("127.0.0.1", 0, self.world, True, timeout=timeout,
                               wait_for_workers=False)
        spec = {"world": self.world, "port": store.port, "timeout_s": self.timeout_s,
                "device": device.type, "config": config, "traffic": traffic, "seed": seed}
        env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
               "OPENBLAS_NUM_THREADS": "1"}
        self.workers = []
        try:
            for rank in range(1, self.world):
                worker = subprocess.Popen([sys.executable, WORKER], stdin=subprocess.PIPE,
                                          stdout=2, env=env, text=True)
                self.workers.append(worker)
                worker.stdin.write(json.dumps({**spec, "rank": rank}) + "\n")
                worker.stdin.flush()
            self._await_workers(store)
            dist.init_process_group("gloo", store=store, rank=0, world_size=self.world,
                                    timeout=timeout)
            self.rank = Rank(config, traffic, seed, device)
        except BaseException:
            self._close(kill=True)
            raise
        self.records = []
        self.lost = 0

    def _await_workers(self, store) -> None:
        """Wait until every worker has reached the store; a worker that
        ends first, or the timeout, ends the run."""
        keys = [f"ready/{rank}" for rank in range(1, self.world)]
        deadline = time.monotonic() + self.timeout_s
        while not store.check(keys):
            ended = sum(1 for w in self.workers if w.poll() is not None)
            if ended or time.monotonic() > deadline:
                raise harness.Failure(f"dispatch workers did not start ({ended} ended)")
            time.sleep(0.1)

    def _close(self, kill: bool) -> None:
        """Leave the group and end the workers: at once with `kill`, else
        after they leave by themselves (killed after a bounded wait)."""
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except RuntimeError as error:
                print(f"dispatch: leaving the group: {error!r}", file=sys.stderr)
        for worker in self.workers:
            if not kill:
                try:
                    worker.wait(timeout=min(self.timeout_s, 60))
                except subprocess.TimeoutExpired:
                    pass
            if worker.poll() is None:
                worker.kill()
            worker.wait()
            worker.stdin.close()

    @contextlib.contextmanager
    def _collective(self, code: int):
        """Send `code` to the workers, then the block's collective work.  A
        failure there leaves the ranks out of step, so it ends the run."""
        try:
            with self.spans.enter("dispatch.command"):
                command(code)
            yield
        except Exception as error:  # noqa: BLE001 - the group can serve no further request
            print(f"dispatch: the group lost a rank or a collective: {error!r}",
                  file=sys.stderr)
            self._close(kill=True)
            raise SystemExit(f"portbench: {type(error).__name__}: the deployment cannot "
                             "serve; the run ends without a result") from error

    def request(self, i: int) -> dict:
        k = i % len(self.rank.items)
        if k == 0:
            with self._collective(MAP):
                results = self.rank.batch()
            self.records = []
            for index, fit in zip(self.rank.items, results):
                if fit is None or any(math.isnan(v) for v in fit):
                    self.lost += 1
                    self.records.append({"tree": index, "failed": True})
                else:
                    t, rho, it, failed = fit
                    self.records.append({"tree": index, "t": t, "rho": rho, "it": it,
                                         "failed": failed > 0})
        return self.records[k]

    def counters(self) -> dict:
        out = common.counters()
        own = dispatch_counters()
        if own is not None:
            with self._collective(COUNTERS):
                out["dispatch"] = gather_objects(own)
        return out

    def release(self) -> dict:
        with self._collective(STOP):
            reports = gather_objects(self.rank.report())
        self._close(kill=False)
        for report in reports:
            print(f"rank {report['rank']}: cards {report['cards']}, memory peak "
                  f"{report['memory_peak_bytes']} B, {len(report['digests'])} batches, "
                  f"counters {report['counters']}", file=sys.stderr)
        del self.rank
        return {"reports": reports, "lost": self.lost}


def check(config, traffic, seed, records, device, limits, kept) -> dict:
    forbidden = sorted({m for r in kept["reports"] for m in r["forbidden"]})
    if forbidden:
        raise harness.Failure(f"modules that must not load, on a worker: {', '.join(forbidden)}")
    checks = search.check(config, traffic, seed, records, device, limits, kept)
    reports = kept["reports"]
    ours = reports[0]["digests"]
    disagreements = sum(
        sum(1 for b in range(max(len(ours), len(r["digests"])))
            if ours[b:b + 1] != r["digests"][b:b + 1])
        for r in reports[1:])
    checks["lost_results"] = {"value": kept["lost"], "limit": limits["lost_results"]}
    checks["rank_disagreements"] = {"value": disagreements,
                                    "limit": limits["rank_disagreements"]}
    if device.type == "cuda":
        alone = {r["cards"][0] for r in reports if len(r["cards"]) == 1}
        checks["shared_cards"] = {"value": len(reports) - len(alone),
                                  "limit": limits["shared_cards"]}
    return checks
