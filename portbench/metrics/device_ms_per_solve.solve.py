"""Device-busy ms (union of device intervals) per traced solve."""
from portbench.readers import device_ms_per_request as read  # noqa: F401
