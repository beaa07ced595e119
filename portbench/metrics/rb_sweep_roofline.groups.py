"""The red-black sweep kernel's share of its bytes bound over the traced sub-window (%),
a batched launch counted by (members, rows, cols)."""
from portbench.readers import rb_sweep_roofline as read  # noqa: F401
