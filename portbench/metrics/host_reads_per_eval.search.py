"""Host reads of device values (graphs.counters host_reads) per evaluation of the window."""
from portbench.program_spans import host_reads_per_request as read  # noqa: F401
