"""repro_torch.obs.device_time — a CUDA kernel's own device time, by name.

For a kernel of a few microseconds, CUDA events around back-to-back
wrapper calls time the host's enqueue (checks, allocations, the ctypes
call), not the kernel. ``kernel_device_ms`` reads ``torch.profiler``'s
device events instead and sums them by kernel name. It needs a CUDA
device and depends on nothing of the port but ``torch``, so a script may
load it from one checkout to measure the kernels of another.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch


def kernel_device_ms(fn: Callable[[], object], names: Iterable[str],
                     iters: int = 50, warmup: int = 3) -> Dict[str, float]:
    """name -> device ms per launch of the kernels whose profiler name
    holds ``::<name>``, each launched once by every call of ``fn``: summed
    by name over ``iters`` calls after ``warmup`` calls, and divided by
    the launches the profiler saw (it may drop an event). Raises
    ``RuntimeError`` unless it saw more than half of the ``iters``
    launches of each name and no more than ``iters``."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    out = {}
    for name in names:
        hit = [e for e in evs if f"::{name}" in e.key]
        seen = sum(e.count for e in hit)
        if not iters // 2 < seen <= iters:
            raise RuntimeError(f"kernel_device_ms: the profiler saw {seen} "
                               f"launches of {name} in {iters} calls")
        out[name] = sum(e.self_device_time_total for e in hit) / 1e3 / seen
    return out
