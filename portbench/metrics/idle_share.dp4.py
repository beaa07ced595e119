"""Share of rank 0's traced sub-window (one batch) in which no operation ran on its card (%)."""
from portbench.readers import idle_share as read  # noqa: F401
