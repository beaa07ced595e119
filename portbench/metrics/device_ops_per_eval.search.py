"""Device operations per traced evaluation."""
from portbench.readers import device_ops_per_request as read  # noqa: F401
