"""Launcher of the prefill attention CUDA kernel (``csrc/flash_attention.cu``).

The port's counterpart of ``repro.kernels.flash_attention.
flash_attention_kernel``: blocked GQA attention with an online softmax in
f32, causal and/or sliding-window, over q (B,S,H,D) and k/v (B,S,KV,D) in
f32 or bf16. Nothing is padded: the kernel masks keys at the true S.

Two routes, picked by ``prefill_route`` from the dtype, the head dim and
the pointers' alignment (never by trying one and falling back):

* ``"tensor_core"``: bf16, D % 16 == 0, D <= 256, 16-byte aligned data.
  wgmma on bf16 tiles that TMA brings in (a 4-D tensor map over
  (B, S, KV, D), encoded on the host through the driver entry point
  ``cuTensorMapEncodeTiled``);
* ``"cuda_core"``: everything else (f32 above all: its 2e-3 limit against
  the plain version rules TF32 out). f32 FMAs from shared memory.

Takes CUDA tensors that ``kernels/ops.py`` has already checked and
allocated; launches on PyTorch's current stream and does not synchronize.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("tensor_core", "cuda_core")
TC_MAX_HEAD_DIM = 256


def prefill_route(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The kernel route for inputs of this dtype and head dim: the
    tensor-core kernel takes bf16 with D a multiple of 16 up to 256 and
    16-byte aligned data (TMA and wgmma's 16-byte rows); the CUDA-core
    kernel takes the rest."""
    if (dtype == torch.bfloat16 and d % 16 == 0
            and 0 < d <= TC_MAX_HEAD_DIM and aligned):
        return "tensor_core"
    return "cuda_core"


def route_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """``prefill_route`` of these tensors."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    return prefill_route(q.dtype, q.shape[-1], aligned)


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, causal: bool, window: int,
                           route: str) -> None:
    """out (B,S,H,D) = attention of q over k, v on the card, by ``route``
    (the caller's ``route_for``; its out must be 16-byte aligned too)."""
    lib = build.library("flash_attention")
    b, s, h, d = q.shape
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if route == "tensor_core":
            err = lib.repro_flash_attention_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                s, h, k.shape[2], d, int(causal), window,
                1.0 / math.sqrt(d), stream)
        else:
            err = lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                DTYPES[q.dtype], b, s, h, k.shape[2], d, int(causal),
                window, 1.0 / math.sqrt(d), stream)
    build.check_launch(lib, err, f"flash_attention ({route})")
