"""Launcher of the flash-decode CUDA kernel (``csrc/decode_attention.cu``).

The port's counterpart of ``repro.kernels.decode_attention.
flash_decode_kernel``: one query token (B,1,H,D) against ring-buffer
caches (B,S,KV,D) under a (B,S) validity mask. The caches are read in
their own dtype (f32 or bf16) and converted to q's in registers.

Takes CUDA tensors that ``kernels/ops.py`` has already checked and
allocated; launches on PyTorch's current stream and does not synchronize.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def max_group_width() -> int:
    """The largest (H/KV) * DMAX the kernel's registers hold, where DMAX is
    D rounded up to 32, 64, 128 or 256 (read from the library once)."""
    return build.library("decode_attention").repro_flash_decode_max_gd()


def launch_flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, valid: torch.Tensor,
                        out: torch.Tensor) -> None:
    """out (B,1,H,D) = attention of q over the valid cache slots."""
    lib = build.library("decode_attention")
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    with torch.cuda.device(q.device):
        err = lib.repro_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid.data_ptr(), out.data_ptr(), DTYPES[q.dtype],
            DTYPES[k_cache.dtype], b, s, h, kv, d, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(lib, err, "flash_decode")
