"""The readers of the program's own spans and read counter
(portbench/program_spans.py) on synthetic traced runs: a device timeline
saved as the harness saves it, spans as the port's recorder returns them,
counters as common.counters() gives them.  Against a program without the
recorder (no `profiling.take`, no `host_reads`) every reader returns None."""

import os

import pytest

from evostencils_torch.utils import profiling
from evostencils_torch.utils.profiling import Recording, Span
from portbench import harness, program_spans
from portbench.trace import MARKER, TraceSummary

NEW = ["host_reads_per_eval.search", "loop_idle_share.search", "host_work_ms_per_eval.search",
       "loop_idle_share.solve", "verdict_ms.solve", "loop_idle_share.outer",
       "host_reads_per_eval.outer", "idle_in_spans_share.search",
       "idle_in_spans_share.solve", "idle_in_spans_share.outer"]
T0 = 1_700_000_000_000_000_000

# Device work in ns from T0: busy [100, 200) (two overlapping kernels),
# [300, 400) and [600, 700); a marker at 50 is not work.  The sub-window is
# the 900 ns that end with the last kernel, [-200, 700): idle [-200, 100),
# [200, 300), [400, 600), 600 ns in all.
EVENTS = [("kernel_a", 100, 180), ("kernel_b", 150, 200), (MARKER, 50, 51),
          ("kernel_a", 300, 400), ("kernel_b", 600, 700)]
SPANS = [Span("evaluate", -150, 650, -1, 1), Span("evaluate.build", -100, 50, 0, 1),
         Span("loop.power", 120, 320, 0, 1), Span("evaluate.timing", 350, 640, 0, 1),
         Span("loop.stage", 450, 550, 3, 1), Span("solve.verdict", 560, 600, 3, 1)]


def _context(window_s=900e-9, take=True):
    summary = TraceSummary([(n, T0 + s, T0 + e) for n, s, e in EVENTS], ["request"], window_s,
                           1, {})
    counters = ({"host_reads": 10, "replays": 0}, {"host_reads": 70, "replays": 5})
    return {"trace": summary, "completed": 4, "counters_before": counters[0],
            "counters_after": counters[1], "spans": None, "records": [], "window_s": 1.0,
            "setup_s": 1.0}


@pytest.fixture
def traced(tmp_path, monkeypatch):
    monkeypatch.setattr(program_spans, "OUT", str(tmp_path))
    context = _context()
    context["trace"].save(str(tmp_path / "cell.7.trace.npz"),
                          [(n, T0 + s, T0 + e) for n, s, e in EVENTS])
    spans = [s._replace(start_ns=T0 + s.start_ns, end_ns=T0 + s.end_ns) for s in SPANS]
    taken = []

    def take():
        taken.append(1)
        return Recording(spans, 0, {})

    monkeypatch.setattr(profiling, "take", take)
    return context, taken


def read(name, context):
    return harness.load_reader(name)(context)


def test_every_new_metric_has_a_reader_and_an_entry():
    spec = harness.load_json(os.path.join(harness.HERE, os.pardir, "BENCHMARK.json"))
    names = {m["name"] for m in spec["per_layer"]}
    assert set(NEW) <= names
    for name in NEW:
        assert callable(harness.load_reader(name))


def test_the_readers_of_a_synthetic_traced_run(traced):
    context, taken = traced
    # Idle inside any span: [-150, 100) 250, [200, 300) 100, [400, 600) 200.
    assert read("idle_in_spans_share.search", context) == pytest.approx(100 * 550 / 600)
    # Inside loop.*: [200, 300) of loop.power, [450, 550) of loop.stage.
    assert read("loop_idle_share.outer", context) == pytest.approx(100 * 200 / 600)
    # evaluate is 800 ns, 300 of them in loops.
    assert read("host_work_ms_per_eval.search", context) == pytest.approx(500e-6)
    # No `solve` root: nothing to divide by.
    assert read("verdict_ms.solve", context) is None
    assert read("host_reads_per_eval.search", context) == pytest.approx(60 / 4)
    assert len(taken) == 1, "the spans are taken once per run"


def test_the_verdict_per_solve(traced, monkeypatch):
    context, _ = traced
    spans = [Span("solve", T0, T0 + 100, -1, 1), Span("solve.verdict", T0 + 60, T0 + 90, 0, 1),
             Span("solve", T0 + 100, T0 + 200, -1, 2),
             Span("solve.verdict", T0 + 150, T0 + 160, 2, 2),
             Span("solve.verdict", T0 + 170, T0 + 190, 2, 2)]
    monkeypatch.setattr(profiling, "take", lambda: Recording(spans, 0, {}))
    assert read("verdict_ms.solve", context) == pytest.approx(60e-6 / 2)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_recorder_reads_none(name, traced, monkeypatch):
    context, _ = traced
    monkeypatch.delattr(profiling, "take")
    for counters in (context["counters_before"], context["counters_after"]):
        del counters["host_reads"]
    assert read(name, context) is None


@pytest.mark.parametrize("name", [n for n in NEW if not n.startswith("host_reads")])
def test_an_untraced_run_reads_none(name, traced):
    context, _ = traced
    assert read(name, {**context, "trace": None}) is None


@pytest.mark.parametrize("name", [n for n in NEW if "idle" in n])
def test_a_timeline_older_than_the_spans_reads_none(name, traced, tmp_path):
    context, _ = traced
    os.utime(tmp_path / "cell.7.trace.npz", (1, 1))
    assert read(name, context) is None
