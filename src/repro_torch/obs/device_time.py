"""repro_torch.obs.device_time — a CUDA kernel's own device time, by name.

For a kernel of a few microseconds, CUDA events around back-to-back
wrapper calls time the host's enqueue (checks, allocations, the ctypes
call), not the kernel. ``kernel_device_ms`` reads ``torch.profiler``'s
device events instead and sums them by kernel name. It needs a CUDA
device and depends on nothing of the port but ``torch``, so a script may
load it from one checkout to measure the kernels of another.

The profiler may drop a kernel's events: on an H100 it has shown none of
the launches of a kernel that ran, in every one of three profiles in a
row. ``kernel_device_ms`` then raises ``LaunchesNotSeen``; a caller that
keeps a time from CUDA events beside it may record the device time as
not measured.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable

import torch

ATTEMPTS = 3     # profiles taken before a dropped count is an error


class LaunchesNotSeen(RuntimeError):
    """In every profile the profiler saw too few (or too many) launches of
    a kernel that each call launches once."""


def kernel_device_ms(fn: Callable[[], object], names: Iterable[str],
                     iters: int = 50, warmup: int = 3) -> Dict[str, float]:
    """name -> device ms per launch of the kernels whose profiler name
    holds ``::<name>``, each launched once by every call of ``fn``: summed
    by name over ``iters`` calls after ``warmup`` calls, and divided by
    the launches the profiler saw (it may drop an event). A profile that
    saw no more than half of the ``iters`` launches of a name, or more
    than ``iters``, is taken again, tracing the host as well as the
    device; after ``ATTEMPTS`` such profiles it raises
    ``LaunchesNotSeen``."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(ATTEMPTS):
        activities = ([ProfilerActivity.CUDA] if attempt == 0 else
                      [ProfilerActivity.CPU, ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        out, missed = {}, []
        for name in names:
            hit = [e for e in evs if f"::{name}" in e.key]
            seen = sum(e.count for e in hit)
            if not iters // 2 < seen <= iters:
                missed.append(f"{seen} launches of {name}")
                continue
            out[name] = (sum(e.self_device_time_total for e in hit) / 1e3
                         / seen)
        if not missed:
            return out
    raise LaunchesNotSeen(f"kernel_device_ms: in {ATTEMPTS} profiles of "
                       f"{iters} calls the profiler saw {', '.join(missed)}")
