"""Device-busy ms (union of device intervals) per traced evaluation."""
from portbench.readers import device_ms_per_request as read  # noqa: F401
