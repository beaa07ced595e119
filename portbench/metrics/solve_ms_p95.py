"""The 95th percentile of every solve of the window, in ms (host clock)."""
from portbench.readers import request_ms_p95 as read  # noqa: F401
