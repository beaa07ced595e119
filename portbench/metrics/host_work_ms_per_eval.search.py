"""Host ms per traced evaluation inside the program's `evaluate` span but outside its loop.* spans."""
from functools import partial

from portbench.program_spans import host_work_ms_per

read = partial(host_work_ms_per, root="evaluate")
