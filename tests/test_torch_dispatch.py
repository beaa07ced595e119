"""The port's population dispatchers (parallel/dispatch.py), the optimizer's
dispatcher hook, `scripts/torch_optimize.py --multihost` and the two locks
that concurrent evaluation needs, on the CPU.

* `SerialDispatcher` and `ThreadPoolDispatcher` return what the JAX
  package's dispatchers return on a pure function, and on
  TorchProgramGenerator for 4 ω variants of V(2,1) the threads return the
  serial ρ and iterations to the digit (float64, levels 3-5), which match
  the JAX package's within the float64 parity band of
  tests/test_torch_slice.py (residual target 1e-6, 1e-8 in ρ, equal
  iterations: at 1e-12 fast cycles end at the rounding floor).
* `Optimizer(dispatcher=ThreadPoolDispatcher(2))` evolves exactly the
  populations it evolves without one (the stub fitness of
  tests/test_torch_optimizer.py).
* `MultiHostDispatcher` refuses to start without a process group.
* Two processes on one gloo group over 127.0.0.1 run the reference's
  mixed-arity round trip and 6 ω variants, each process checking the
  gathered list against its own serial evaluation; and two processes of
  `torch_optimize.py --multihost --cpu` breed the same populations.
* Over two gloo processes `MultiHostDispatcher` counts its maps, each
  process's items and the ns of its share and its gather exactly, returns
  `SerialDispatcher`'s results bit for bit, records `dispatch.map` around
  `dispatch.local` and `dispatch.gather` under torch.profiler and records
  no span without one.
* The kernel library builds once from four threads, and launch counts
  from many threads are not lost (no kernel needed for either).

Subprocesses get PYTHONPATH set to this checkout and their own timeouts.
"""

import json
import os
import random
import socket
import subprocess
import sys
import threading
import types
from pathlib import Path

import jax.numpy as jnp
import pytest
import torch

from evostencils_tpu.backend.evaluation import JaxProgramGenerator
from evostencils_tpu.parallel import dispatch as jax_dispatch
from evostencils_tpu.problems.poisson import poisson_2d as jax_poisson_2d
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.ir.transformations import canonical_string
from evostencils_torch.ops import _build, rb_sweep
from evostencils_torch.optimization.optimizer import Optimizer
from evostencils_torch.parallel.dispatch import (
    MultiHostDispatcher, SerialDispatcher, ThreadPoolDispatcher,
)
from evostencils_torch.problems.poisson import poisson_2d
from test_torch_optimizer import GROUPING, StubGenerator
from torch_parity import JAX, PORT, Side

ROOT = Path(__file__).resolve().parents[1]
OMEGAS = (0.7, 0.8, 0.9, 1.0, 1.1, 1.2)


def _mixed_arity(x):
    return (float(x * x),) if x % 3 == 0 else (float(x * x), float(x))


def _subprocess_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(ROOT), env.get("PYTHONPATH")]))
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _v21_variants(side):
    return [side.cycle(2, 1, omega) for omega in OMEGAS[:4]]


@pytest.mark.parametrize("name", ["serial", "threads"])
def test_dispatchers_match_the_reference_on_a_pure_function(name):
    ours = SerialDispatcher() if name == "serial" else ThreadPoolDispatcher(3)
    theirs = (jax_dispatch.SerialDispatcher() if name == "serial"
              else jax_dispatch.ThreadPoolDispatcher(3))
    items = list(range(11))
    assert ours.map(_mixed_arity, items) == theirs.map(_mixed_arity, items)
    assert ours.map(_mixed_arity, items) == [_mixed_arity(x) for x in items]
    assert ours.map(_mixed_arity, []) == [] and ours.map(_mixed_arity, [4]) == [(16.0, 4.0)]


def test_thread_pool_evaluates_like_serial_and_like_the_reference():
    port_side = Side(PORT, poisson_2d(3, 5, dtype=torch.float64))
    jax_side = Side(JAX, jax_poisson_2d(3, 5, dtype=jnp.float64))
    generator = TorchProgramGenerator(
        port_side.problem, dtype=torch.float64, epsilon=1e-6, device="cpu")
    expressions = _v21_variants(port_side)

    def evaluate(expression):
        return generator.generate_and_evaluate(expression, evaluation_samples=1)

    serial = SerialDispatcher().map(evaluate, expressions)
    # A fresh generator, so that the threads also build the solvers at once.
    generator = TorchProgramGenerator(
        port_side.problem, dtype=torch.float64, epsilon=1e-6, device="cpu")
    threaded = ThreadPoolDispatcher(4).map(evaluate, expressions)
    assert [(rho, it) for _, rho, it in threaded] == [(rho, it) for _, rho, it in serial]
    assert generator.vm_hits + generator.vm_misses == len(expressions)

    reference = JaxProgramGenerator(jax_side.problem, dtype=jnp.float64, epsilon=1e-6)
    for expression, (_, rho, it) in zip(_v21_variants(jax_side), threaded):
        _, rho_ref, it_ref = reference.generate_and_evaluate(expression, evaluation_samples=1)
        assert abs(rho - rho_ref) <= 1e-8 * rho_ref and it == it_ref, (rho, rho_ref, it, it_ref)


def _stub_evolution(dispatcher, tmp_path, method, seed):
    problem = poisson_2d(3, 5, dtype=torch.float64)
    generator = StubGenerator(problem, canonical_string)
    optimizer = Optimizer.for_problem(
        problem, program_generator=generator, checkpoint_directory_path=str(tmp_path),
        rng=random.Random(seed), dispatcher=dispatcher)
    settings = dict(GROUPING, population_initialization_factor=2, generalization_interval=100,
                    evaluation_samples=1, maximum_local_system_size=4, verbose=False)
    _, _, pops, _, hofs = optimizer.evolutionary_optimization(
        optimization_method=getattr(optimizer, method), **settings)
    return ([[(str(i), i.fitness_values) for i in pop] for pop in pops],
            [[(str(i), i.fitness_values) for i in hof] for hof in hofs],
            generator.group_calls)


@pytest.mark.parametrize("method,seed", [("NSGAII", 4), ("SOGP", 7)])
def test_optimizer_with_a_thread_pool_evolves_the_same_populations(method, seed, tmp_path):
    without = _stub_evolution(None, tmp_path / "serial", method, seed)
    threaded = _stub_evolution(ThreadPoolDispatcher(2), tmp_path / "threads", method, seed)
    assert threaded == without
    assert without[0] and without[2] > 0  # the group path ran too


def test_multihost_dispatcher_needs_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        MultiHostDispatcher()


_WORKER = """
import os, sys
import torch
import torch.distributed as dist

rank, world, address = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://{address}", rank=rank, world_size=world)
from evostencils_torch.backend.evaluation import TorchProgramGenerator
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ir.reference_cycles import generate_v_cycle
from evostencils_torch.parallel.dispatch import MultiHostDispatcher, SerialDispatcher
from evostencils_torch.problems.poisson import poisson_2d

d = MultiHostDispatcher(inner=SerialDispatcher())
assert (d.process_index, d.process_count) == (rank, world)

# The reference's round trip: mixed arities, round-robin slices, and every
# process receives the full, ordered list.
items = list(range(7))
def fitness(x):
    return (float(x * x),) if x % 3 == 0 else (float(x * x), float(x))
assert d.map(fitness, items) == [fitness(x) for x in items]

problem = poisson_2d(3, 5, dtype=torch.float64)
_, terminals = generate_primitive_set(
    problem.approximation(), problem.rhs(), 2, problem.coarsening_factors, 5,
    problem.equations, problem.operators, problem.fields, depth=2)
expressions = [generate_v_cycle(terminals, problem.rhs(), 2, 1, omega=w) for w in OMEGAS]
generator = TorchProgramGenerator(problem, dtype=torch.float64, device="cpu")
gathered = d.map(lambda e: generator.generate_and_evaluate(e, evaluation_samples=1), expressions)
local = TorchProgramGenerator(problem, dtype=torch.float64, device="cpu")
for e, fit in zip(expressions, gathered):
    _, rho, iterations = local.generate_and_evaluate(e, evaluation_samples=1)
    assert (fit[1], fit[2]) == (rho, iterations), (rank, fit, rho, iterations)
print(f"MULTIHOST_OK {rank}", flush=True)
dist.destroy_process_group()
"""


def _run_processes(commands, timeout=240):
    procs = [subprocess.Popen(command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=str(ROOT))
             for command, env in commands]
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outputs


def test_multihost_dispatcher_two_gloo_processes(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(f"OMEGAS = {OMEGAS!r}\n" + _WORKER)
    address = f"127.0.0.1:{_free_port()}"
    env = _subprocess_env()
    procs, outputs = _run_processes(
        [([sys.executable, str(worker), str(rank), "2", address], env) for rank in range(2)])
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out[-3000:]}"
        assert f"MULTIHOST_OK {rank}" in out


_COUNTING_WORKER = """
import json, sys
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

rank, world, address = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://{address}", rank=rank, world_size=world)
from evostencils_torch.parallel import dispatch
from evostencils_torch.utils import profiling

def fitness(x):
    return (x / 3.0, x ** 0.5, 1.0 / (x + 0.7)) if x % 2 else (x * 1.1,)

d = dispatch.MultiHostDispatcher(inner=dispatch.SerialDispatcher())
dispatch.counters.reset()
profiling.take()
untraced = [d.map(fitness, list(range(11))) for _ in range(2)]
quiet = profiling.take().spans
with profile(activities=[ProfilerActivity.CPU]):
    traced = d.map(fitness, list(range(5)))
spans = profiling.take().spans
print("DISPATCH " + json.dumps({
    "counters": dispatch.counters.as_dict(), "untraced": untraced, "traced": traced,
    "serial": [dispatch.SerialDispatcher().map(fitness, list(range(n))) for n in (11, 5)],
    "quiet": [s.name for s in quiet], "spans": [[s.name, s.parent] for s in spans]}),
    flush=True)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def counted_maps(tmp_path_factory):
    """What each of two gloo processes reported after two untraced maps of
    11 items and one traced map of 5."""
    worker = tmp_path_factory.mktemp("counting") / "worker.py"
    worker.write_text(_COUNTING_WORKER)
    address = f"127.0.0.1:{_free_port()}"
    procs, outputs = _run_processes(
        [([sys.executable, str(worker), str(rank), "2", address], _subprocess_env())
         for rank in range(2)], timeout=120)
    reports = []
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out[-3000:]}"
        line = next(l for l in out.splitlines() if l.startswith("DISPATCH "))
        reports.append(json.loads(line[len("DISPATCH "):]))
    return reports


def test_multihost_dispatcher_counts_its_maps_items_and_phases(counted_maps):
    # Rank 0 takes items 0, 2, 4, ...: 6 of 11 and 3 of 5; rank 1 the rest.
    for rank, items in enumerate((6 + 6 + 3, 5 + 5 + 2)):
        counters = counted_maps[rank]["counters"]
        assert (counters["maps"], counters["items_local"]) == (3, items), counters
        assert counters["local_ns"] > 0 and counters["gather_ns"] > 0, counters


def test_multihost_dispatcher_returns_the_serial_results_bit_for_bit(counted_maps):
    for report in counted_maps:
        serial_11, serial_5 = report["serial"]
        assert report["untraced"] == [serial_11, serial_11]
        assert report["traced"] == serial_5


def test_multihost_dispatcher_spans_nest_under_a_profiler(counted_maps):
    for report in counted_maps:
        assert report["spans"] == [["dispatch.map", -1], ["dispatch.local", 0],
                                   ["dispatch.gather", 0]]


def test_multihost_dispatcher_records_no_span_without_a_profiler(counted_maps):
    for report in counted_maps:
        assert report["quiet"] == []


def test_optimize_multihost_processes_breed_the_same_populations(tmp_path):
    port = _free_port()
    commands = []
    for rank in range(2):
        env = _subprocess_env()
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
                   WORLD_SIZE="2", LOCAL_RANK=str(rank))
        commands.append(([
            sys.executable, str(ROOT / "scripts" / "torch_optimize.py"), "--cpu", "--multihost",
            "--min-level", "3", "--max-level", "5", "--mu", "4", "--lambda", "4",
            "--generations", "1", "--evaluation-samples", "1", "--method", "sogp",
            "--seed", "5", "--output", str(tmp_path / f"rank{rank}"),
        ], env))
    procs, outputs = _run_processes(commands)
    for rank, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"process {rank} failed:\n{out[-3000:]}"
    best = [out.split("Best individual:")[1].split()[0] for out in outputs]
    assert best[0] == best[1]
    # Every process evaluated its share; rank 0 wrote the artifacts.
    evaluations = [int(out.split("Evaluations: ")[1].split()[0]) for out in outputs]
    assert all(n > 0 for n in evaluations)
    assert (tmp_path / "rank0" / "individual_0.txt").is_file()
    assert not (tmp_path / "rank1" / "individual_0.txt").exists()


def test_optimize_multihost_needs_a_seed():
    from scripts import torch_optimize

    with pytest.raises(SystemExit) as exit_info:
        torch_optimize.parse_arguments(["--cpu", "--multihost"])
    assert exit_info.value.code == 2


def test_kernel_library_builds_once_from_four_threads(monkeypatch, tmp_path):
    target = tmp_path / "libstub.so"
    compiles = []
    barrier = threading.Barrier(4)

    def compile_stub(path):
        compiles.append(path)
        threading.Event().wait(0.05)  # a build takes a while: others arrive meanwhile
        path.write_bytes(b"")

    def cdll_stub(path):
        return types.SimpleNamespace(rb_sweep_f32=types.SimpleNamespace(),
                                     rb_sweep_f32_batched=types.SimpleNamespace(),
                                     stencil2d_f32=types.SimpleNamespace(),
                                     stencil2d_f64=types.SimpleNamespace())

    monkeypatch.setattr(_build, "_library", None)
    monkeypatch.setattr(_build, "library_path", lambda: target)
    monkeypatch.setattr(_build, "_compile", compile_stub)
    monkeypatch.setattr(_build.ctypes, "CDLL", cdll_stub)
    results = []

    def load():
        barrier.wait(timeout=10)
        results.append(_build.library())

    threads = [threading.Thread(target=load) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert compiles == [target]
    assert len(results) == 4 and all(r is results[0] for r in results)


def test_launch_counts_from_many_threads_are_not_lost(monkeypatch):
    import collections
    import time

    class SlowCounter(collections.Counter):
        """Reads slowly, so that another thread runs between the read and
        the write of every unguarded `+=`."""

        def __getitem__(self, key):
            value = super().__getitem__(key)
            time.sleep(1e-4)
            return value

    monkeypatch.setattr(rb_sweep, "launches", SlowCounter())

    def count():
        for _ in range(100):
            rb_sweep.count_launch((63, 63))
            rb_sweep.count_launch([127, 127])

    threads = [threading.Thread(target=count) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert dict(rb_sweep.launches) == {(63, 63): 800, (127, 127): 800}


def test_optimizer_counters_are_exact_under_a_thread_pool():
    """The optimizer's statistics under ThreadPoolDispatcher(8): a few
    hundred distinct stub evaluations three times over, a quarter of them
    already cached,
    with the interpreter's switch interval cut to 1 µs so that threads
    switch inside every unguarded `+=`.  Hits, misses, evaluations and
    failures equal the serial run's exactly."""
    problem = poisson_2d(3, 5, dtype=torch.float64)
    side = Side(PORT, problem)
    rng = random.Random(8)
    trees = {}
    while len(trees) < 320:
        tree = PORT.gp.gen_grow(side.pset, 2, 8, rng=rng)
        trees.setdefault(str(tree), tree)
    trees = list(trees.values())
    def statistics(dispatcher):
        optimizer = Optimizer.for_problem(
            problem, program_generator=StubGenerator(problem, canonical_string),
            rng=random.Random(0), dispatcher=dispatcher)
        optimizer._pset = side.pset
        for tree in trees[::4]:
            optimizer.evaluate_single_objective(tree, evaluation_samples=1)
        # Three passes, one after another (within a pass every tree is
        # another individual, so no two threads race to cache one): the
        # later passes are cache hits, counted as fast as threads can.
        for _ in range(3):
            (dispatcher or SerialDispatcher()).map(
                lambda tree: (optimizer.evaluate_single_objective(tree, evaluation_samples=1),
                              optimizer.evaluate_multiple_objectives(tree, evaluation_samples=1)),
                trees)
        return (optimizer._individual_cache_hits, optimizer._individual_cache_misses,
                optimizer._total_number_of_evaluations, optimizer._failed_evaluations)

    serial = statistics(None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threaded = statistics(ThreadPoolDispatcher(8))
    finally:
        sys.setswitchinterval(interval)
    assert threaded == serial
    assert serial[0] >= len(trees) // 4 and serial[2] >= len(trees)
