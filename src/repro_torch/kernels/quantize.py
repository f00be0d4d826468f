"""Plan and launcher of the affine-int8 CUDA kernel (``csrc/quantize.cu``).

The port's counterpart of ``repro.kernels.quantize.quantize_affine_kernel``:
masked per-tensor (min, max) over the valid rows, then
q = clip(rint((x - xmin) * (1/scale)) - 128), masked rows -128 — byte-exact
against ``ref.quantize_affine_ref``. One cooperative launch, with a
grid-wide barrier between the statistics and the codes, takes the place of
the TPU kernel's in-order two-phase grid.

The plan is made here, on the host, from the shapes alone (the row mask
stays on the card): one wave of blocks, one an SM, and whether a block's
span of the valid rows stays in shared memory between the two steps
(resident) or is read again from L2. It is sized for a mask with every
row valid; the kernel splits the rows that are valid among the same
blocks.

The cohort entry (``quantize_affine_cohort_kernel``) quantizes a stacked
(B, N, D) cohort, each client over its own valid rows, in one cooperative
launch: the axis the TPU kernel gets from ``vmap``. Its plan
(``plan_quantize_cohort``) splits the same wave among the clients.

Takes CUDA tensors that ``kernels/ops.py`` has already checked and
allocated; launches on PyTorch's current stream and does not synchronize.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build

ALIGN = 16          # a block's span is a multiple of 16 elements (one store)
MAX_INDEX = 2 ** 31 - 1                  # the kernel indexes in 32 bits


class QuantizePlan(NamedTuple):
    """One launch of ``quantize_affine_kernel``."""
    grid: int         # blocks: one a SM, all co-resident
    span: int         # elements of valid rows a block takes when all are
    smem_bytes: int   # dynamic shared memory a block stages its span in
    resident: bool    # span kept in shared memory; else re-read from L2


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def plan_quantize(n: int, d: int, sms: int, max_smem: int,
                  blocks_per_sm: Callable[[bool, int], int]) -> QuantizePlan:
    """The plan for an (n, d) payload on a card of ``sms`` SMs whose blocks
    may take ``max_smem`` bytes of dynamic shared memory;
    ``blocks_per_sm(resident, smem_bytes)`` is the occupancy query of the
    kernel at that shared memory. One block an SM (each phase of the
    kernel is short, and every warp more on an SM adds to the scalar work
    of the mask walk and to the grid barrier). Resident where the payload
    fits in that wave's shared memory, else the L2 route: the same grid
    and spans with ``smem_bytes=0, resident=False``.
    """
    total = n * d
    span = _round_up(-(-total // sms), ALIGN)
    if total + ALIGN * sms > MAX_INDEX:
        raise ValueError(f"quantize: a {n} x {d} payload has 2^31 elements "
                         f"or more; the kernel indexes in 32 bits")
    smem = 4 * span
    if smem <= max_smem and blocks_per_sm(True, smem) >= 1:
        return QuantizePlan(sms, span, smem, True)
    if blocks_per_sm(False, 0) < 1:
        raise RuntimeError("quantize: the kernel fits no block on an SM")
    return QuantizePlan(sms, span, 0, False)


class CohortPlan(NamedTuple):
    """One launch of ``quantize_affine_cohort_kernel``."""
    per_client: int   # virtual blocks a client
    grid: int         # blocks, all co-resident, one a SM at most
    span: int         # elements a virtual block takes when all are valid
    smem_bytes: int   # dynamic shared memory a block stages its span in
    resident: bool    # span kept in shared memory; else re-read from L2


def plan_quantize_cohort(b: int, n: int, d: int, sms: int, max_smem: int,
                         blocks_per_sm: Callable[[bool, int], int]
                         ) -> CohortPlan:
    """The plan for a (b, n, d) cohort (b >= 1), with the arguments of
    ``plan_quantize`` (``blocks_per_sm`` queries the cohort kernel). The
    wave of ``sms`` blocks is split evenly among the clients,
    ``sms // b`` virtual blocks each, and at least one; past the wave
    (b > sms) a block takes several virtual blocks, one client after
    another, on the L2 route. Resident where each block takes one virtual
    block and its span fits in shared memory."""
    per_client = max(1, sms // b)
    vblocks = b * per_client
    grid = min(vblocks, sms)
    span = _round_up(-(-(n * d) // per_client), ALIGN)
    if b * n * d + ALIGN * vblocks > MAX_INDEX:
        raise ValueError(f"quantize: a {b} x {n} x {d} cohort has 2^31 "
                         f"elements or more; the kernel indexes in 32 bits")
    smem = 4 * span
    if (vblocks == grid and smem <= max_smem
            and blocks_per_sm(True, smem) >= 1):
        return CohortPlan(per_client, grid, span, smem, True)
    if blocks_per_sm(False, 0) < 1:
        raise RuntimeError("quantize: the cohort kernel fits no block on "
                           "an SM")
    return CohortPlan(per_client, grid, span, 0, False)


def _query(index: int, cohort: bool):
    """(max dynamic shared memory, occupancy query) of the single or the
    cohort kernel on device ``index``."""
    lib = build.library("quantize")

    def occupancy(res: bool, smem: int) -> int:
        blocks = lib.repro_quantize_blocks_per_sm(int(res), smem, int(cohort))
        if blocks < 0:
            build.check_launch(lib, -blocks, "quantize occupancy query")
        return blocks

    max_smem = lib.repro_quantize_max_smem(int(cohort))
    if max_smem < 0:
        raise RuntimeError("quantize: the shared-memory query failed")
    return max_smem, occupancy


@functools.lru_cache(maxsize=None)
def _plan_cached(n: int, d: int, index: int) -> QuantizePlan:
    with torch.cuda.device(index):
        return plan_quantize(n, d, sm_count(index), *_query(index, False))


@functools.lru_cache(maxsize=None)
def _cohort_plan_cached(b: int, n: int, d: int, index: int) -> CohortPlan:
    with torch.cuda.device(index):
        return plan_quantize_cohort(b, n, d, sm_count(index),
                                    *_query(index, True))


def plan_for(x: torch.Tensor) -> QuantizePlan:
    """The plan of a launch on the CUDA tensor ``x`` (cached by shape and
    device)."""
    n, d = x.shape
    return _plan_cached(n, d, x.device.index or 0)


def plan_for_cohort(x: torch.Tensor) -> CohortPlan:
    """The plan of a cohort launch on the (B, N, D) CUDA tensor ``x``."""
    b, n, d = x.shape
    return _cohort_plan_cached(b, n, d, x.device.index or 0)


def launch_quantize_affine(x: torch.Tensor, rowmask: torch.Tensor,
                           q: torch.Tensor, scratch: torch.Tensor,
                           plan: QuantizePlan) -> None:
    """q (N, D) int8, 16-byte aligned; ``rowmask`` (N,) bool; ``scratch``
    f32 of 2 + 2 * plan.grid: (xmin, scale), then the blocks' partials."""
    lib = build.library("quantize")
    n, d = x.shape
    with torch.cuda.device(x.device):
        err = lib.repro_quantize_affine(
            x.data_ptr(), rowmask.data_ptr(), q.data_ptr(),
            scratch.data_ptr(), n, d, plan.grid, plan.smem_bytes,
            int(plan.resident),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "quantize_affine")


def launch_quantize_affine_cohort(x: torch.Tensor, rowmask: torch.Tensor,
                                  q: torch.Tensor, scratch: torch.Tensor,
                                  plan: CohortPlan) -> None:
    """x (B, N, D) f32, q (B, N, D) int8, 16-byte aligned; ``rowmask``
    (B, N) bool; ``scratch`` f32 of 2 * B + 2 * B * plan.per_client: each
    client's (xmin, scale), then the virtual blocks' partials."""
    lib = build.library("quantize")
    b, n, d = x.shape
    with torch.cuda.device(x.device):
        err = lib.repro_quantize_affine_cohort(
            x.data_ptr(), rowmask.data_ptr(), q.data_ptr(),
            scratch.data_ptr(), b, n, d, plan.per_client, plan.grid,
            plan.smem_bytes, int(plan.resident),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "quantize_affine_cohort")
