"""The port's span recorder (evostencils_torch/utils/profiling.py) and the
loops' counted host reads (backend/graphs.py `read`).

The recorder records only while a torch profiler runs; off, `span` hands
out one shared no-op object.  Spans nest per thread, root spans start
request ids, the buffer is bounded and counts what it turns away, and the
span clock is the profiler's: on the CPU a `record_function` event lies
inside the span that opened it; on the card (the test marked `cuda`, which
skips without one) a kernel launched inside a span runs between the span's
start and the synchronise after it, under a device-only profiler as the
benchmark runs one:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from evostencils_torch.backend import graphs
from evostencils_torch.backend.evaluation import PowerLoop, TorchProgramGenerator
from evostencils_torch.grammar.multigrid import generate_primitive_set
from evostencils_torch.ir import reference_cycles
from evostencils_torch.problems.poisson import poisson_2d
from evostencils_torch.utils import profiling
from evostencils_torch.utils.profiling import Span


def _host_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.take()
    yield
    profiling.take()


def test_off_records_nothing_and_hands_out_one_no_op():
    assert not profiling.recording()
    first, second = profiling.span("evaluate", root=True), profiling.span("loop.stage")
    assert first is second
    with first, second:
        profiling.add_time("read", 5)
    recorded = profiling.take()
    assert recorded.spans == [] and recorded.overflow == 0


def test_nesting_parents_and_request_ids():
    with _host_profile():
        assert profiling.recording()
        with profiling.span("evaluate", root=True):
            with profiling.span("evaluate.build"):
                pass
            with profiling.span("evaluate.timing"):
                with profiling.span("loop.stage"):
                    pass
        with profiling.span("evaluate", root=True):
            with profiling.span("loop.power"):
                pass
        with profiling.span("loop.bicgstab"):
            pass
    spans = profiling.take().spans
    assert [s.name for s in spans] == ["evaluate", "evaluate.build", "evaluate.timing",
                                       "loop.stage", "evaluate", "loop.power", "loop.bicgstab"]
    assert [s.parent for s in spans] == [-1, 0, 0, 2, -1, 4, -1]
    first, second = spans[0].request, spans[4].request
    assert 0 < first < second
    assert [s.request for s in spans] == [first] * 4 + [second] * 2 + [0]
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            parent = spans[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns


def test_the_buffer_is_bounded_and_counts_its_overflow(monkeypatch):
    monkeypatch.setattr(profiling._recorder, "capacity", 3)
    with _host_profile():
        with profiling.span("evaluate", root=True):
            for _ in range(4):
                with profiling.span("loop.stage"):
                    pass
    recorded = profiling.take()
    assert len(recorded.spans) == 3 and recorded.overflow == 2
    assert [s.parent for s in recorded.spans] == [-1, 0, 0]


def test_take_returns_the_spans_and_timed_counters_and_clears_them():
    with _host_profile():
        with profiling.span("solve", root=True):
            profiling.add_time("read", 40)
            profiling.add_time("read", 2)
        with profiling.span("solve.verdict"):
            pass
    recorded = profiling.take()
    assert [s.name for s in recorded.spans] == ["solve", "solve.verdict"]
    assert recorded.timed == {"read": [42, 2]}
    again = profiling.take()
    assert again.spans == [] and again.timed == {} and again.overflow == 0


def test_self_time_of_nested_spans():
    spans = [Span("evaluate", 0, 100, -1, 1), Span("evaluate.timing", 10, 70, 0, 1),
             Span("loop.stage", 20, 30, 1, 1), Span("loop.stage", 40, 65, 1, 1),
             Span("evaluate.build", 75, 95, 0, 1)]
    assert profiling.self_ns(spans) == [20, 25, 10, 25, 20]


def test_the_span_clock_is_the_profilers_host_clock():
    with _host_profile() as prof:
        with profiling.span("evaluate", root=True):
            with record_function("inside"):
                torch.ones(64).sum()
    (span,) = profiling.take().spans
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "inside"]
    tolerance = 1_000_000
    assert span.start_ns - tolerance <= event.start_ns() <= span.end_ns + tolerance
    assert span.start_ns - tolerance <= event.end_ns() <= span.end_ns + tolerance


def test_an_evaluation_records_its_layers_and_counts_its_reads(tmp_path):
    problem = poisson_2d(3, 5, dtype=torch.float32)
    generator = TorchProgramGenerator(problem, dtype=torch.float32, device="cpu")
    terminals = generate_primitive_set(
        problem.approximation(), problem.rhs(), problem.dimension, problem.coarsening_factors,
        problem.max_level, problem.equations, problem.operators, problem.fields)[1]
    expression = reference_cycles.generate_v_cycle(terminals, problem.rhs(), 2, 1)
    before = graphs.counters.host_reads
    with profiling.trace(str(tmp_path), device="cpu") as traced:
        generator.generate_and_evaluate(expression, evaluation_samples=1)
    reads = graphs.counters.host_reads - before
    record = generator.last_cycle_solve
    # One read a power block; a stage run reads its first residual, one a
    # cycle and its best residual and iteration; the time per iteration
    # runs the stage twice at one sample (its count, then the timed run).
    (executed,) = set(record["stage_executed"])
    blocks = record["power_cycles"] // PowerLoop.BLOCK_LEN
    assert blocks >= 3 and executed >= 2
    assert reads == blocks + 2 * (1 + executed + 2)

    with open(traced.spans_path) as fh:
        written = json.load(fh)
    assert written["timed_ns"]["read"][1] == reads
    events = written["traceEvents"]
    names = [e["name"] for e in events]
    assert names.count("evaluate") == 1
    assert {"evaluate.build", "evaluate.probe_state", "evaluate.timing", "loop.power"} <= set(
        names)
    assert names.count("loop.stage") == 2
    root = names.index("evaluate")
    for event in events:
        if event["name"] != "evaluate":
            assert event["args"]["request"] == events[root]["args"]["request"]
    by_name = {e["name"]: e for e in events}
    assert events[by_name["loop.power"]["args"]["parent"]]["name"] == "evaluate"
    (timed_stage,) = [e for e in events if e["name"] == "loop.stage"
                      and events[e["args"]["parent"]]["name"] == "evaluate.timing"]
    assert timed_stage["ts"] >= by_name["evaluate.timing"]["ts"]
    assert os.path.getsize(traced.path) > 0
    assert profiling.take().spans == []


@pytest.mark.cuda
def test_a_kernel_launched_in_a_span_runs_inside_it_on_the_shared_clock():
    """Under a device-only profiler, as the benchmark's traced sub-window
    runs one: the recorder is on, and a sleep kernel launched inside a span
    starts after the span's start and ends before the synchronise after it
    returns, within 50 µs on the span clock.  (The first launch under the
    profiler can take longer than the kernel runs, so the kernel may end
    inside the span.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    synchronised = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert profiling.recording()
        for _ in range(5):
            with profiling.span("loop.stage"):
                torch.cuda._sleep(2_000_000)
            torch.cuda.synchronize()
            synchronised.append(time.time_ns())
            time.sleep(0.002)
    spans = profiling.take().spans
    kernels = sorted((e for e in prof.profiler.kineto_results.events()
                      if e.device_type() == torch.autograd.DeviceType.CUDA
                      and "spin_kernel" in e.name()), key=lambda e: e.start_ns())
    assert len(spans) == 5 and len(kernels) == 5, [e.name() for e in kernels]
    tolerance = 50_000
    outside = [(span.start_ns, kernel.start_ns(), kernel.end_ns(), end)
               for span, kernel, end in zip(spans, kernels, synchronised)
               if kernel.start_ns() < span.start_ns - tolerance
               or kernel.end_ns() > end + tolerance]
    assert not outside
