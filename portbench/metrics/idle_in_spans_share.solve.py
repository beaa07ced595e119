"""Share of the traced sub-window's device-idle time inside any of the program's spans (%)."""
from portbench.program_spans import idle_in_spans_share as read  # noqa: F401
