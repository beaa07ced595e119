"""Ms of the program's `solve.verdict` spans (the float64 read-back, host residual and norms) per traced solve."""
from functools import partial

from portbench.program_spans import span_ms_per

read = partial(span_ms_per, name="solve.verdict", root="solve")
