"""CUDA-graph captures during the window (graphs.counters)."""
from portbench.readers import captures_in_window as read  # noqa: F401
