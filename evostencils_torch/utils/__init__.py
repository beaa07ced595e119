"""The port's utilities: champions.py, logbook.py and visualization.py are
copies of evostencils_tpu's that import the port's IR; timing.py times a
cycle on the card (CUDA graph replays) or the host; profiling.py traces
with torch.profiler."""
