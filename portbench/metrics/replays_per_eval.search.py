"""CUDA-graph replays per evaluation of the window (graphs.counters)."""
from portbench.readers import replays_per_request as read  # noqa: F401
