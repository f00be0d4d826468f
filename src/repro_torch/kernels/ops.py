"""Public wrappers of the port's kernels: the dispatch points the selection
and transport code call (the counterparts of ``repro.kernels.ops``).

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. Then the device picks the engine: a tensor on
the CPU goes to the kernel's plain version (``kernels/ref.py``); a tensor
on a CUDA device launches the hand-written kernel, or raises. There is no
size threshold and no fallback: the kernels mask their ragged edges
themselves, so nothing is padded either.

Every wrapper carries a plain integer ``launches`` that it raises by one
each time it launches its kernel (one Lloyd sweep counts once, although it
is two CUDA launches). ``reset_launch_counts`` / ``launch_counts`` read and
zero them all, so a run can show that it went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import ref


def _on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one, else raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no engine for device {t.device}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kmeans_pairwise_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, D), (K, D) f32 -> (N, K) f32 squared distances."""
    _check(x, "x", torch.float32, 2, x.device)
    _check(c, "c", torch.float32, 2, x.device)
    n, d = x.shape
    k = c.shape[0]
    if c.shape[1] != d or d == 0 or k == 0:
        raise ValueError(f"x {tuple(x.shape)} and c {tuple(c.shape)} must "
                         f"share a non-zero width, with K > 0")
    if not _on_card(x, "kmeans_pairwise_dist"):
        return ref.kmeans_pairwise_dist_ref(x, c)
    from repro_torch.kernels.kmeans import launch_pairwise_dist
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    launch_pairwise_dist(x, c, out)
    kmeans_pairwise_dist.launches += 1
    return out


def kmeans_lloyd_step(x: torch.Tensor, c: torch.Tensor, lmask: torch.Tensor):
    """Fused Lloyd sweep: (N, D), (K, D), (N, K) additive mask, all f32 ->
    (assign (N,) int32, mindist (N,) f32, sums (K, D) f32, counts (K,) f32).
    """
    _check(x, "x", torch.float32, 2, x.device)
    _check(c, "c", torch.float32, 2, x.device)
    _check(lmask, "lmask", torch.float32, 2, x.device)
    n, d = x.shape
    k = c.shape[0]
    if c.shape[1] != d or d == 0 or k == 0:
        raise ValueError(f"x {tuple(x.shape)} and c {tuple(c.shape)} must "
                         f"share a non-zero width, with K > 0")
    if tuple(lmask.shape) != (n, k):
        raise ValueError(f"lmask must be {(n, k)}, got {tuple(lmask.shape)}")
    if not _on_card(x, "kmeans_lloyd_step"):
        return ref.kmeans_lloyd_ref(x, c, lmask)
    from repro_torch.kernels.kmeans import launch_lloyd
    dev = x.device
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    mindist = torch.empty((n,), dtype=torch.float32, device=dev)
    weight = torch.empty((n,), dtype=torch.int32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    launch_lloyd(x, c, lmask, assign, mindist, weight, sums, counts)
    kmeans_lloyd_step.launches += 1
    return assign, mindist, sums, counts


def quantize_affine(x: torch.Tensor, rowmask: torch.Tensor):
    """Per-tensor affine int8 of (N, D) f32 ``x`` over the rows where the
    (N,) bool ``rowmask`` is set -> (q (N, D) int8, xmin, scale), the last
    two 0-d f32 tensors. Byte-exact against ``ref.quantize_affine_ref``."""
    _check(x, "x", torch.float32, 2, x.device)
    _check(rowmask, "rowmask", torch.bool, 1, x.device)
    n, d = x.shape
    if rowmask.shape[0] != n:
        raise ValueError(f"rowmask has {rowmask.shape[0]} rows, x has {n}")
    if not _on_card(x, "quantize_affine"):
        return ref.quantize_affine_ref(x, rowmask)
    from repro_torch.kernels.quantize import (launch_quantize_affine,
                                              max_partials)
    dev = x.device
    q = torch.empty((n, d), dtype=torch.int8, device=dev)
    params = torch.empty((2,), dtype=torch.float32, device=dev)
    partials = torch.empty((2 * max_partials(),), dtype=torch.float32,
                           device=dev)
    launch_quantize_affine(x, rowmask, q, params, partials)
    quantize_affine.launches += 1
    return q, params[0], params[1]


KERNELS = (kmeans_pairwise_dist, kmeans_lloyd_step, quantize_affine)
for _fn in KERNELS:
    _fn.launches = 0


def reset_launch_counts() -> None:
    """Zero every wrapper's ``launches``."""
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    """wrapper name -> kernel launches since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNELS}
