"""Share of the traced sub-window in which no operation ran on the device (%)."""
from portbench.readers import idle_share as read  # noqa: F401
