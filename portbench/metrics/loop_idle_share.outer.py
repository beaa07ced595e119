"""Share of the traced sub-window's device-idle time inside the program's loop.* spans (%)."""
from portbench.program_spans import loop_idle_share as read  # noqa: F401
