"""Launcher of the affine-int8 CUDA kernel (``csrc/quantize.cu``).

The port's counterpart of ``repro.kernels.quantize.quantize_affine_kernel``:
masked per-tensor (min, max) over the valid rows, then
q = clip(rint((x - xmin) * (1/scale)) - 128), masked rows -128 — byte-exact
against ``ref.quantize_affine_ref``. Two launches (statistics, quantize)
take the place of the TPU kernel's in-order two-phase grid.

Takes CUDA tensors that ``kernels/ops.py`` has already checked and
allocated; launches on PyTorch's current stream and does not synchronize.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build


@functools.lru_cache(maxsize=None)
def max_partials() -> int:
    """Blocks of the statistics launch, i.e. the (min, max) partials the
    scratch buffer must hold (read from the library once)."""
    return build.library("quantize").repro_quantize_max_parts()


def launch_quantize_affine(x: torch.Tensor, rowmask: torch.Tensor,
                           q: torch.Tensor, params: torch.Tensor,
                           partials: torch.Tensor) -> None:
    """q (N, D) int8 and params = (xmin, scale) f32 on the card;
    ``rowmask`` is (N,) bool, ``partials`` f32 scratch of 2*max_partials()."""
    lib = build.library("quantize")
    n, d = x.shape
    with torch.cuda.device(x.device):
        err = lib.repro_quantize_affine(
            x.data_ptr(), rowmask.data_ptr(), q.data_ptr(), params.data_ptr(),
            partials.data_ptr(), n, d,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch(lib, err, "quantize_affine")
