"""Observability of the port: the clock (``obs.timing``) and a kernel's
device time by name (``obs.device_time``); span tracing and metrics are
not ported yet."""
from repro_torch.obs.device_time import kernel_device_ms
from repro_torch.obs.timing import monotonic, sync

__all__ = ["kernel_device_ms", "monotonic", "sync"]
