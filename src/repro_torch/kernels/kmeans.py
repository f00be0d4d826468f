"""Launchers of the K-means CUDA kernels (``csrc/kmeans.cu``).

The port's counterparts of ``repro.kernels.kmeans``:

* ``launch_pairwise_dist`` replaces ``kmeans_pairwise_dist_kernel``: the
  (N, K) squared distances ||x||^2 + ||c||^2 - 2 x.c, with the x.c product
  computed inside the kernel.
* ``launch_lloyd`` replaces ``kmeans_lloyd_kernel``: one fused Lloyd sweep
  (biased distances with the additive mask, row argmin, mindist, masked
  per-cluster sums and counts) in two launches with no float atomics, so a
  sweep gives the same bits on every run.

These take CUDA tensors that ``kernels/ops.py`` has already checked and
allocated; they launch on PyTorch's current stream and do not synchronize.
The CUDA source is built on first use (``kernels/build.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_pairwise_dist(x: torch.Tensor, c: torch.Tensor,
                         out: torch.Tensor) -> None:
    """out[n, k] = ||x[n]||^2 + ||c[k]||^2 - 2 x[n].c[k] on the card."""
    lib = build.library("kmeans")
    n, d = x.shape
    with torch.cuda.device(x.device):
        err = lib.repro_kmeans_pairwise_dist(
            x.data_ptr(), c.data_ptr(), out.data_ptr(), n, c.shape[0], d,
            _stream(x))
    build.check_launch(lib, err, "kmeans_pairwise_dist")


def launch_lloyd(x: torch.Tensor, c: torch.Tensor, lmask: torch.Tensor,
                 assign: torch.Tensor, mindist: torch.Tensor,
                 weight: torch.Tensor, sums: torch.Tensor,
                 counts: torch.Tensor) -> None:
    """One Lloyd sweep on the card into the preallocated outputs
    (``weight`` is (N,) int32 scratch: the row's min(lmask) <= 0)."""
    lib = build.library("kmeans")
    n, d = x.shape
    with torch.cuda.device(x.device):
        err = lib.repro_kmeans_lloyd(
            x.data_ptr(), c.data_ptr(), lmask.data_ptr(), assign.data_ptr(),
            mindist.data_ptr(), weight.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), n, c.shape[0], d, _stream(x))
    build.check_launch(lib, err, "kmeans_lloyd")
