"""Observability of the port. So far only the clock (``obs.timing``); span
tracing and metrics are not ported yet."""
from repro_torch.obs.timing import monotonic, sync

__all__ = ["monotonic", "sync"]
