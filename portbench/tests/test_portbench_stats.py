"""The benchmark's arithmetic on synthetic inputs: the interval union and
the idle gaps, the completion-aligned rate, the percentile, the roofline
bytes, and a trace reduced to the per-layer metrics."""

import math
import statistics

import pytest

from portbench import readers, stats
from portbench.trace import MARKER, Spans, TraceSummary


def test_union_merges_overlaps_and_keeps_gaps():
    assert stats.union_length([]) == 0.0
    assert stats.union_length([(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]) == pytest.approx(3.0)
    assert stats.union_length([(3.0, 4.0), (0.0, 1.0), (1.0, 1.5)]) == pytest.approx(2.5)
    assert stats.union_length([(0.0, 10.0), (2.0, 3.0)]) == pytest.approx(10.0)


def test_idle_gaps_are_the_uncovered_parts_of_the_window():
    gaps = stats.idle_gaps([(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)], 0.0, 7.0)
    assert gaps == [(0.0, 1.0), (3.0, 5.0), (6.0, 7.0)]
    assert sum(b - a for a, b in gaps) + stats.union_length(
        [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0)]) == pytest.approx(7.0)


def test_the_rate_counts_every_completion_over_the_whole_window():
    assert stats.rate_per_hour(150, 30.0) == pytest.approx(18000.0)
    with pytest.raises(ValueError):
        stats.rate_per_hour(1, 0.0)


@pytest.mark.parametrize("q", [0, 25, 50, 75, 95, 100])
def test_percentile_matches_linear_interpolation(q):
    values = [float(v) for v in (7, 1, 3, 9, 4, 4, 12, 2, 8, 5)]
    ordered = sorted(values)
    if q in (25, 50, 75):
        assert stats.percentile(values, q) == pytest.approx(
            statistics.quantiles(values, n=4, method="inclusive")[q // 25 - 1])
    expected = ordered[0] if q == 0 else ordered[-1] if q == 100 else None
    if expected is not None:
        assert stats.percentile(values, q) == expected
    assert stats.percentile([3.0], q) == 3.0


def test_roofline_bytes_count_twelve_bytes_a_point_of_every_launch():
    launches = {(511, 511): 10, (8, 63, 63): 2}
    points = 10 * 511 * 511 + 2 * 8 * 63 * 63
    assert stats.rb_sweep_bound_s(launches) == pytest.approx(12 * points / 3.35e12)
    assert stats.rb_sweep_points((4, 127, 127)) == 4 * 127 * 127


def _summary():
    ns = 1_000_000  # 1 ms
    events = [
        (MARKER + "()", 0, 1_000),
        ("rb_sweep_kernel<1>", 1 * ns, 2 * ns),
        ("elementwise", 2 * ns, 4 * ns),
        (MARKER + "()", 6 * ns, 6 * ns + 1_000),
        ("elementwise", 7 * ns, 9 * ns),
    ]
    return TraceSummary(events, ["request", "search.evaluate"], window_s=0.010, requests=2,
                        launches_by_shape={(511, 511): 100})


def test_a_trace_reduces_to_busy_time_ops_gaps_and_the_kernel():
    summary = _summary()
    assert summary.device_ops == 3
    assert summary.busy_s == pytest.approx(0.005)
    assert summary.rb_sweep_s == pytest.approx(0.001)
    labels = [label for label, _ in summary.gaps]
    assert labels == ["request", "search.evaluate"]
    assert [s for _, s in summary.gaps] == pytest.approx([0.002, 0.001], rel=1e-3)
    breakdown = summary.breakdown()
    assert breakdown["device_ops"][0] == ["elementwise", pytest.approx(0.004)]
    assert len(breakdown["idle_gaps"]) == 2


def test_readers_take_their_numbers_from_the_context():
    summary = _summary()
    spans = Spans()
    spans.seconds["solve.verdict"], spans.counts["solve.verdict"] = 0.012, 4
    context = {"trace": summary, "window_s": 2.0, "completed": 4, "spans": spans,
               "records": [{"ms": float(v)} for v in range(1, 21)],
               "counters_before": {"replays": 10, "captures": 3},
               "counters_after": {"replays": 410, "captures": 3}}
    assert readers.idle_share(context) == pytest.approx(50.0)
    assert readers.device_ms_per_request(context) == pytest.approx(2.5)
    assert readers.device_ops_per_request(context) == pytest.approx(1.5)
    assert readers.replays_per_request(context) == pytest.approx(100.0)
    assert readers.captures_in_window(context) == 0
    assert readers.rate_per_hour(context) == pytest.approx(7200.0)
    assert readers.ms_per_request(context) == pytest.approx(500.0)
    assert readers.request_ms_p95(context) == pytest.approx(19.05)
    assert readers.span_ms(context, "solve.verdict") == pytest.approx(3.0)
    share = readers.rb_sweep_roofline(context)
    assert share == pytest.approx(100.0 * 100 * 12 * 511 * 511 / 3.35e12 / 0.001)
    assert 0.0 < share <= 100.0


def test_a_reader_with_nothing_to_read_returns_none():
    context = {"trace": None, "window_s": 1.0, "completed": 0, "spans": Spans(),
               "records": []}
    for reader in (readers.idle_share, readers.device_ms_per_request,
                   readers.rb_sweep_roofline, readers.request_ms_p95, readers.ms_per_request):
        assert reader(context) is None
    assert readers.span_ms(context, "solve.verdict") is None
    quiet = TraceSummary([("elementwise", 0, 10)], [], 1.0, 1, {})
    assert readers.rb_sweep_roofline({"trace": quiet}) is None
    assert not math.isnan(quiet.busy_s)
