"""Host ms of one float64 verdict: the benchmark's span around each call."""
from functools import partial

from portbench.readers import span_ms

read = partial(span_ms, name="solve.verdict")
