"""The window over the solves completed in it, in ms (host clock)."""
from portbench.readers import ms_per_request as read  # noqa: F401
