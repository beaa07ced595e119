"""What the metric readers share.  Each reader takes the run's context:
the window's records and length, the program's counters before and after
the window, the benchmark's spans, and with tracing the sub-window's
TraceSummary.  A reader that finds nothing to read returns None."""

from __future__ import annotations

from portbench import stats


def rate_per_hour(context):
    return stats.rate_per_hour(context["completed"], context["window_s"])


def ms_per_request(context):
    if not context["completed"]:
        return None
    return 1e3 * context["window_s"] / context["completed"]


def request_ms_p95(context):
    times = [r["ms"] for r in context["records"] if "ms" in r and not r.get("failed")]
    return stats.percentile(times, 95.0) if times else None


def idle_share(context):
    trace = context["trace"]
    if trace is None or trace.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def device_ms_per_request(context):
    trace = context["trace"]
    if trace is None or not trace.requests:
        return None
    return 1e3 * trace.busy_s / trace.requests


def device_ops_per_request(context):
    trace = context["trace"]
    if trace is None or not trace.requests:
        return None
    return trace.device_ops / trace.requests


def counter_change(context, name):
    return context["counters_after"][name] - context["counters_before"][name]


def replays_per_request(context):
    if not context["completed"]:
        return None
    return counter_change(context, "replays") / context["completed"]


def captures_in_window(context):
    return counter_change(context, "captures")


def rb_sweep_roofline(context):
    """The sweeps' least time over their device time in the sub-window (%):
    12 bytes a point of every launch, counted by shape, at 3.35 TB/s."""
    trace = context["trace"]
    if trace is None or trace.rb_sweep_s <= 0.0 or not trace.launches_by_shape:
        return None
    return 100.0 * stats.rb_sweep_bound_s(trace.launches_by_shape) / trace.rb_sweep_s


def span_ms(context, name):
    spans = context["spans"]
    if not spans.counts.get(name):
        return None
    return 1e3 * spans.seconds[name] / spans.counts[name]
