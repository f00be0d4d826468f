"""repro_torch.obs.timing — the port's one wall clock.

``monotonic`` is a monotonic high-resolution counter; ``sync`` blocks the
host until the device work behind a tensor is done, so a host-clock
interval around work that ends in ``sync`` measures the work and not its
enqueue (CUDA launches return before the card finishes). flcheck's OBS001
keeps every stdlib clock read inside an ``obs`` package, so the rest of
the port times through this module.
"""
from __future__ import annotations

import time as _time
from typing import Any, Callable

import torch

# flcheck: disable=OBS001 (this module IS the sanctioned clock)
monotonic: Callable[[], float] = _time.perf_counter


def _tensors(x: Any):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def sync(x: Any) -> Any:
    """Block until the device work behind ``x`` is done and return ``x``.

    ``x`` may be a tensor or a dict/list/tuple holding tensors. If any of
    them lies on a CUDA device, that device is synchronized; CPU tensors
    (and anything else) are already complete."""
    for dev in {t.device for t in _tensors(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return x

