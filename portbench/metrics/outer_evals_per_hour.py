"""Helmholtz fitness evaluations completed per hour of the window (host clock)."""
from portbench.readers import rate_per_hour as read  # noqa: F401
