"""The probe state's cache (`TorchProgramGenerator._probe_state`) on the CPU.

The fitness of a cycle starts from four fields at the expression's level:
the problem's initial state (u0, f), the power iteration's seeded random
error e0 and its zero right-hand side zf.  The generator builds them once
for each key of what they are made from (level, dtype, device, the PDE
parameters, the right-hand-side functions, the sample-spread seeds) and
hands the same tensors to every later evaluation.  These tests hold:

* the hit path: two evaluations of a VM tree, a lowered tree and a float64
  tree (the restarted measurement) give the same fitness to the last bit,
  the second a hit, and the fields are the ones the generator built before
  the cache, bit for bit;
* the guard: no evaluation writes the cached tensors (their version
  counters and contents stay), eagerly, on the loops' graph path (graphs
  replayed eagerly), on the group path and through FAS;
* the key: a new level, `rhs_seed`, `init_seed` or parameter value builds a
  new entry, and the cache never holds more than its bound;
* threads: eight threads evaluating one tree on one generator build the
  key once, and each gets the serial fitness.

Times are host clock readings, so `_timed` is replaced by a stand-in that
runs the solve and reports a fixed time: the fitness triple is then
deterministic, and still depends on the executed cycle counts.
"""

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from evostencils_torch.backend import graphs
from evostencils_torch.backend.evaluation import PROBE_STATE_ENTRIES, TorchProgramGenerator
from evostencils_torch.problems import fas
from evostencils_torch.problems.poisson import poisson_2d
from torch_parity import PORT, Side, eager_graphs  # noqa: F401 (eager_graphs: a fixture)

INFINITY = 1e100


def _fixed_time(generator, seconds=1e-3):
    """Each timed solve runs and reads `seconds`."""

    def timed(solve, *args):
        solve(*args)
        return seconds

    generator._timed = timed


def _parent_probe_state(generator, expression):
    """The probe state as the generator built it in every evaluation before
    the cache (the oracle of the bits)."""
    u0_host, f_host = generator.problem.initial_state(
        generator.dtype, level=generator._expression_level(expression),
        rhs_seed=generator.rhs_seed, init_seed=generator.init_seed)
    rng = np.random.default_rng(generator._probe_error_seed())
    e0 = generator._to_device(
        rng.standard_normal(x.shape).astype(generator._np_dtype) for x in u0_host)
    zf = generator._to_device(np.zeros(x.shape, generator._np_dtype) for x in u0_host)
    return generator._to_device(u0_host), generator._to_device(f_host), e0, zf


def _same_bits(got, expected):
    return all(g.dtype == e.dtype and torch.equal(g, e)
               for gs, es in zip(got, expected) for g, e in zip(gs, es))


def _snapshot(state):
    return [(x, x._version, x.clone()) for fields in state for x in fields]


def _unchanged(snapshot):
    return all(x._version == version and torch.equal(x, copy) for x, version, copy in snapshot)


def _generator(dtype=torch.float32, problem=None, **kwargs):
    problem = problem or poisson_2d(3, 5, dtype=dtype)
    generator = TorchProgramGenerator(problem, dtype=dtype, device="cpu", **kwargs)
    _fixed_time(generator)
    return generator


def _cycle(problem, omega=1.0):
    return Side(PORT, problem).cycle(2, 1, omega)


@pytest.mark.parametrize("route", ["vm", "lowered", "float64"])
def test_a_second_evaluation_is_a_hit_with_the_first_ones_fitness(route):
    dtype = torch.float64 if route == "float64" else torch.float32
    # float64: stage windows of 1e-3 towards 1e-8, so that the host
    # residual restarts the measurement.
    kwargs = {"epsilon": 1e-8, "measure_reduction": 1e-3} if route == "float64" else {}
    generator = _generator(dtype, **kwargs)
    if route == "lowered":
        # A VM miss: the structure is lowered from the IR.
        generator._vm_program = lambda expression: (None, None)
    expression = _cycle(generator.problem, 0.9)
    results = []
    for _ in range(2):
        results.append(generator.generate_and_evaluate(
            expression, infinity=INFINITY, evaluation_samples=1))
    assert results[1] == results[0]
    assert results[0][0] < INFINITY and 0.0 < results[0][1] < 1.0
    assert (generator.probe_state_builds, generator.probe_state_hits) == (1, 1)
    stats = generator.vm_stats()
    assert (stats["probe_state_builds"], stats["probe_state_hits"]) == (1, 1)
    assert stats["vm_hits" if route != "lowered" else "vm_misses"] == 2
    if route == "float64":
        # The restarted measurement: stages beyond the first ran.
        assert len(generator.last_cycle_solve["stage_executed"]) >= 2
    cached = generator._probe_state(expression)
    assert _same_bits(cached, _parent_probe_state(generator, expression))
    assert generator.probe_state_hits == 2


@pytest.mark.parametrize("path", ["eager", "graphs", "group", "fas"])
def test_no_evaluation_writes_the_cached_fields(path, request):
    if path == "fas":
        problem = fas.fas_2d(2, 6, dtype=torch.float32)
        generator = _generator(problem=problem)
        expressions = [Side(PORT, problem).cycle(2, 2, 0.8, kind="newton", levels=1)]
    else:
        generator = _generator()
        expressions = [_cycle(generator.problem, w) for w in (0.8, 1.0, 1.1)]
    if path == "graphs":
        request.getfixturevalue("eager_graphs")
        generator.graph_cache = graphs.GraphCache()
    state = generator._probe_state(expressions[0])
    snapshot = _snapshot(state)
    for _ in range(2):
        if path == "group":
            results = generator.generate_and_evaluate_group(
                expressions, infinity=INFINITY, evaluation_samples=1)
            assert generator.groups_batched >= 1
        else:
            results = [generator.generate_and_evaluate(e, infinity=INFINITY,
                                                       evaluation_samples=1)
                       for e in expressions]
        assert all(t < INFINITY for t, _, _ in results), results
        assert _unchanged(snapshot)
    assert generator.probe_state_builds == 1
    assert all(a is b for a, b in zip(generator._probe_state(expressions[0]), state))


def test_each_key_builds_its_own_entry_and_the_cache_is_bounded():
    generator = _generator()
    current = {"expression": _cycle(generator.problem)}
    first = generator._probe_state(current["expression"])
    assert generator._probe_state(current["expression"]) is first

    def build(change):
        builds = generator.probe_state_builds
        change()
        state = generator._probe_state(current["expression"])
        assert generator.probe_state_builds == builds + 1
        assert _same_bits(state, _parent_probe_state(generator, current["expression"]))
        return state

    rhs = build(lambda: setattr(generator, "rhs_seed", 11))
    init = build(lambda: setattr(generator, "init_seed", 5))
    assert not _same_bits(rhs[:2], first[:2]) and not _same_bits(init[:2], rhs[:2])
    generator.rhs_seed = generator.init_seed = None
    assert generator._probe_state(current["expression"]) is first
    for kappa in (2.0, 3.0):
        build(lambda: generator._apply_parameter_values({"kappa": kappa}))

    def coarser():
        generator.reinitialize(3, 4)
        current["expression"] = _cycle(generator.problem)

    coarse = build(coarser)
    assert coarse[0][0].shape == (15, 15) and first[0][0].shape == (31, 31)
    for seed in range(PROBE_STATE_ENTRIES + 3):
        build(lambda: setattr(generator, "rhs_seed", 100 + seed))
        assert len(generator._probe_states) <= PROBE_STATE_ENTRIES
    assert len(generator._probe_states) == PROBE_STATE_ENTRIES
    assert generator.probe_state_hits == 2


def test_eight_threads_build_the_key_once_and_score_as_serial():
    generator = _generator()
    expression = _cycle(generator.problem, 0.9)
    serial = _generator().generate_and_evaluate(expression, infinity=INFINITY,
                                                 evaluation_samples=1)
    built = []
    build = generator._build_probe_state

    def slow_build(level):
        # A wide window for a second thread to build the same key.
        built.append(threading.get_ident())
        time.sleep(0.05)
        return build(level)

    generator._build_probe_state = slow_build
    start = threading.Barrier(8)

    def evaluate(_):
        start.wait()
        return generator.generate_and_evaluate(expression, infinity=INFINITY,
                                               evaluation_samples=1)

    with ThreadPoolExecutor(8) as pool:
        results = list(pool.map(evaluate, range(8)))
    assert len(built) == 1 and generator.probe_state_builds == 1
    assert generator.probe_state_hits == 7
    assert results == [serial] * 8

