"""repro_torch.obs.timing — the port's one wall clock.

``monotonic`` is a monotonic high-resolution counter; ``sync`` blocks the
host until the device work behind a tensor is done, so a host-clock
interval around work that ends in ``sync`` measures the work and not its
enqueue (CUDA launches return before the card finishes); ``timeit`` times
calls that way, after a warm-up. flcheck's OBS001 keeps every stdlib
clock read inside an ``obs`` package, so the rest of the port times
through this module.
"""
from __future__ import annotations

import time as _time
from typing import Any, Callable, NamedTuple, Set

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


def cuda_devices(x: Any) -> Set[torch.device]:
    """The CUDA devices of the tensors in ``x`` (a tensor or a
    dict/list/tuple holding tensors); empty when none is on a card."""
    return {t.device for t in _tensors(x) if t.is_cuda}


def sync(x: Any) -> Any:
    """Block until the device work behind ``x`` is done and return ``x``.

    ``x`` may be a tensor or a dict/list/tuple holding tensors. If any of
    them lies on a CUDA device, that device is synchronized; CPU tensors
    (and anything else) are already complete."""
    for dev in cuda_devices(x):
        torch.cuda.synchronize(dev)
    return x



class Timing(NamedTuple):
    """Result of ``timeit``: seconds per call and the (synced) last
    output."""
    seconds: float
    out: Any


def timeit(fn: Callable[..., Any], *args: Any, iters: int = 5,
           warmup: int = 1, reduce: str = "mean", **kwargs: Any) -> Timing:
    """Warm-up-aware timer (the reference's): run ``fn(*args, **kwargs)``
    ``warmup`` times, then time ``iters`` calls, each synced on its output
    (``sync``) so that asynchronous CUDA launches are not under-counted.
    ``reduce`` is ``"mean"`` (the default) or ``"min"`` (best of)."""
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    out = None
    for _ in range(warmup):
        out = sync(fn(*args, **kwargs))
    samples = []
    for _ in range(iters):
        t0 = monotonic()
        out = sync(fn(*args, **kwargs))
        samples.append(monotonic() - t0)
    if reduce == "mean":
        return Timing(sum(samples) / len(samples), out)
    if reduce == "min":
        return Timing(min(samples), out)
    raise ValueError(f"unknown reduce {reduce!r} (want 'mean' or 'min')")
