"""Launchers of the K-means CUDA kernels (``csrc/kmeans.cu``), and the row
plan they run.

The port's counterparts of ``repro.kernels.kmeans``:

* ``launch_pairwise_dist`` replaces ``kmeans_pairwise_dist_kernel``
  (``src/repro/kernels/kmeans.py:67``): the (N, K) squared distances
  ||x||^2 + ||c||^2 - 2 x.c, one launch.
* ``launch_lloyd`` replaces ``kmeans_lloyd_kernel`` (``kmeans.py:127``):
  one fused Lloyd sweep in two launches, with no float atomics, so a sweep
  gives the same bits on every run. The first (the distance core with a
  masked argmin) writes assign, mindist and each row's cluster or -1; the
  second compacts each cluster's rows in order and sums them in that order.

What bounds them on the H100 at the main path's shapes (N = 2,500, D = 200;
K = 10 and 100) is latency, not work: bytes bound a pairwise call at
0.6 us and f32 FMAs a sweep at 1.5 us, below one launch and one round
trip to memory. So the design fills every SM from the start and keeps the
whole centroid panel resident: ``plan_rows`` picks the rows of x a block
owns (the most that still give one full wave of blocks: 19 rows, 132
blocks on 132 SMs), how many centroids one shared-memory panel holds (all
of them unless they would not fit the budget: then the kernel loops over
panels) and how many columns of D it stages at once (all of them but for
very wide D), the panel's padded row stride, and how many threads share a
tile's dot products. The plan is a pure function of the shapes and the
SM count, so the CPU tests hold it; the launchers pass it to the kernel,
which checks it. ``csrc/kmeans.cu``'s header has the rest of the design.

These take CUDA tensors that ``kernels/ops.py`` has already checked and
allocated; they launch on PyTorch's current stream and do not synchronize.
The CUDA source is built on first use (``kernels/build.py``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build

# the kernel's tiling (csrc/kmeans.cu)
THREADS = 256            # threads of a distance block
TR, TC = 4, 4            # rows x centroids of a thread's tile
MAX_ROWS = 32            # rows of x a block holds at most
MAX_SPLIT = 32           # threads sharing a tile's dot products (a warp)
SMEM_MAX = 232448        # dynamic shared memory of one block (227 KB)
SMEM_PER_SM = 233472     # shared memory of an SM (228 KB)
SMEM_PER_BLOCK = 1024    # what the card reserves of it for each block
# a plan's budget: two blocks share an SM
TWO_BLOCKS = SMEM_PER_SM // 2 - SMEM_PER_BLOCK


class RowPlan(NamedTuple):
    """How the distance core covers an (N, D) x (K, D) problem."""
    rows: int      # rows of x per block; block b owns [b*rows, (b+1)*rows)
    blocks: int    # ceil(N / rows); 0 for N = 0
    panel: int     # centroids in shared memory at once
    panels: int    # ceil(K / panel): more than one is the panel loop
    width: int     # columns of D staged at once (a multiple of 4)
    chunks: int    # ceil(D / width)
    stride: int    # floats between centroid rows in shared memory
    split: int     # threads sharing one tile's dot products
    smem: int      # dynamic shared memory bytes of a block

    @property
    def kernel_args(self) -> tuple:
        """The plan as the C entry points take it."""
        return (self.rows, self.panel, self.width, self.stride, self.split,
                self.smem)


def smem_bytes(rows: int, panel: int, width: int, stride: int) -> int:
    """Dynamic shared memory of a distance block (``Layout`` in the
    kernel): two mbarriers, a 64-bit key per row and per (row, centroid
    group), the centroid panel, the x tile, the mask tile, both norms and
    a flag per row."""
    keys = -(-8 * rows * (1 + -(-panel // TC)) // 16) * 16
    return 16 + keys + 4 * (panel * stride + rows * width + rows * panel
                            + rows + panel + rows)


def _split_and_stride(rows: int, panel: int, width: int):
    """Threads per tile (a power of two: as many as the block has for
    every tile, never more than the row's float4s) and the panel's row
    stride in floats: ``width`` itself where the 8 lanes of a quarter-warp
    (8 / split tiles of neighbouring centroids x split float4s of a row)
    already read 32 different banks (split >= 8, or width / 4 = split mod
    8), so that the panel is one bulk copy; else the fewest floats above
    it, in whole float4s, that do."""
    tiles = -(-rows // TR) * -(-panel // TC)
    q = -(-width // 4)
    split = 1
    while (split * 2 * tiles <= THREADS and split * 2 <= min(MAX_SPLIT, q)):
        split *= 2
    if split >= 8:
        return split, 4 * q
    return split, 4 * (q + (split - q) % 8)


@functools.lru_cache(maxsize=512)
def plan_rows(n: int, k: int, d: int, sm_count: int) -> RowPlan:
    """The row plan of an (N, D) x (K, D) distance problem on a card of
    ``sm_count`` SMs, a block's shared memory within ``TWO_BLOCKS``.

    Rows: the most (at most 32) that still give ``sm_count`` blocks, so
    that one wave fills the card and no SM owns more rows or loads the
    panel more often than it must (19 rows, 132 blocks at N = 2,500); one
    where N cannot fill a wave (no blocks at N = 0). The rest as
    ``plan_for_rows``."""
    if n < 0 or min(k, d, sm_count) < 1:
        raise ValueError(f"plan_rows: N={n}, K={k}, D={d}, SMs={sm_count}")
    rows = MAX_ROWS
    while rows > 1 and -(-n // rows) < sm_count:
        rows -= 1
    return plan_for_rows(n, k, d, rows)


@functools.lru_cache(maxsize=512)
def plan_for_rows(n: int, k: int, d: int, rows: int) -> RowPlan:
    """The plan for ``rows`` rows a block. Panel: all K centroids, unless
    the threads' tiles or the budget cap it. Width: all of D, unless even
    a 4-centroid panel would not fit; then the kernel loops over column
    chunks too."""
    if n < 0 or min(k, d) < 1 or not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"plan_for_rows: N={n}, K={k}, D={d}, rows={rows}")
    panel = min(k, TC * (THREADS // -(-rows // TR)))
    width = 4 * -(-d // 4)
    while True:
        split, stride = _split_and_stride(rows, panel, width)
        smem = smem_bytes(rows, panel, width, stride)
        if smem <= TWO_BLOCKS:
            break
        if panel > TC:
            panel = max(TC, (panel - 1) // TC * TC)
        elif width > 4:
            width -= 4
        else:
            raise ValueError(f"plan_rows: no plan fits {TWO_BLOCKS} bytes")
    return RowPlan(rows, -(-n // rows), panel, -(-k // panel), width,
                   -(-d // width), stride, split, smem)


def plan_for(x: torch.Tensor, c: torch.Tensor) -> RowPlan:
    """``plan_rows`` of these tensors on their card."""
    n, d = x.shape
    return plan_rows(n, c.shape[0], d, sm_count(x.device.index or 0))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_pairwise_dist(x: torch.Tensor, c: torch.Tensor,
                         out: torch.Tensor) -> RowPlan:
    """out[n, k] = ||x[n]||^2 + ||c[k]||^2 - 2 x[n].c[k] on the card (N >
    0). Returns the plan it launched."""
    lib = build.library("kmeans")
    n, d = x.shape
    plan = plan_for(x, c)
    with torch.cuda.device(x.device):
        err = lib.repro_kmeans_pairwise_dist(
            x.data_ptr(), c.data_ptr(), out.data_ptr(), n, c.shape[0], d,
            *plan.kernel_args, _stream(x))
    build.check_launch(lib, err, "kmeans_pairwise_dist")
    return plan


def launch_lloyd(x: torch.Tensor, c: torch.Tensor, lmask: torch.Tensor,
                 assign: torch.Tensor, mindist: torch.Tensor,
                 member: torch.Tensor, sums: torch.Tensor,
                 counts: torch.Tensor) -> RowPlan:
    """One Lloyd sweep on the card into the preallocated outputs
    (``member`` is (N,) int32 scratch: the row's cluster, or -1 where
    min(lmask) > 0). At N = 0 only the sums pass runs, and writes zeros.
    Returns the plan it launched."""
    lib = build.library("kmeans")
    n, d = x.shape
    plan = plan_for(x, c)
    with torch.cuda.device(x.device):
        err = lib.repro_kmeans_lloyd(
            x.data_ptr(), c.data_ptr(), lmask.data_ptr(), assign.data_ptr(),
            mindist.data_ptr(), member.data_ptr(), sums.data_ptr(),
            counts.data_ptr(), n, c.shape[0], d, *plan.kernel_args,
            _stream(x))
    build.check_launch(lib, err, "kmeans_lloyd")
    return plan
