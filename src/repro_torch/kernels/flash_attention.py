"""Launchers of the prefill attention CUDA kernel (``csrc/flash_attention.cu``)
and of its backward (``csrc/flash_attention_bwd.cu``).

The port's counterpart of ``repro.kernels.flash_attention.
flash_attention_kernel``: blocked GQA attention with an online softmax in
f32, causal and/or sliding-window, over q (B,S,H,D) and k/v (B,Sk,KV,D) in
f32 or bf16 (Sk = S but for non-causal attention without a window:
whisper's cross-attention). Nothing is padded: the kernel masks keys at
the true Sk.

Two routes, picked by ``prefill_route`` from the dtype, the head dim and
the pointers' alignment (never by trying one and falling back):

* ``"tensor_core"``: bf16, D % 16 == 0, D <= 256, 16-byte aligned data.
  wgmma on bf16 tiles that TMA brings in (a 4-D tensor map over
  (B, S, KV, D), encoded on the host through the driver entry point
  ``cuTensorMapEncodeTiled``);
* ``"cuda_core"``: everything else (f32 above all: its 2e-3 limit against
  the plain version rules TF32 out). f32 FMAs from shared memory.

Both routes write the softmax statistics on request: ``lse`` (B,H,S) f32,
each row's log-sum-exp of its scaled logits (``m + log l``, the
reference's ``(m, l)`` of ``_sdpa_chunked_raw`` folded into one number).
The backward takes them: three launches (``Dd = rowsum(dO * O)``, dK/dV by
key tile, dQ by row tile), at any Sk the forward takes, by one of two
routes that ``bwd_route`` picks the same way:

* ``"tensor_core"``: bf16, D % 16 == 0, D <= 128, at most 64 query heads a
  kv head, 16-byte aligned data. wgmma on bf16 tiles that TMA brings in
  (dK/dV and dQ stay in f32 registers up to D = 128; D = 256 would need
  twice as many as a thread has);
* ``"cuda_core"``: everything else, f32 above all. f32 FMAs.

Takes CUDA tensors that ``kernels/ops.py`` has already checked and
allocated; launches on PyTorch's current stream and does not synchronize.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = ("tensor_core", "cuda_core")
TC_MAX_HEAD_DIM = 256
TC_BWD_MAX_HEAD_DIM = 128
TC_BWD_MAX_GROUP = 64


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


def bwd_route(dtype: torch.dtype, d: int, aligned: bool = True,
              group: int = 1) -> str:
    """The backward's kernel route for inputs of this dtype and head dim,
    ``group`` query heads a kv head: the tensor-core kernels take bf16
    with D a multiple of 16 up to 128, a group of at most 64 (a Q tile
    holds whole queries of 64 folded rows) and 16-byte aligned data; the
    CUDA-core kernels take the rest."""
    if (dtype == torch.bfloat16 and d % 16 == 0
            and 0 < d <= TC_BWD_MAX_HEAD_DIM and 0 < group <= TC_BWD_MAX_GROUP
            and aligned):
        return "tensor_core"
    return "cuda_core"


def bwd_route_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, dout: torch.Tensor) -> str:
    """``bwd_route`` of these tensors (the gradients it allocates are
    aligned)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, out, dout))
    return bwd_route(q.dtype, q.shape[-1], aligned, q.shape[2] // k.shape[2])


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, causal: bool, window: int,
                           route: str,
                           lse: Optional[torch.Tensor] = None) -> None:
    """out (B,S,H,D) = attention of q over k, v (B,Sk,KV,D) on the card,
    by ``route`` (the caller's ``route_for``; its out must be 16-byte
    aligned too), and the rows' log-sum-exp into ``lse`` (B,H,S) f32 if
    given."""
    lib = build.library("flash_attention")
    b, s, h, d = q.shape
    sk = k.shape[1]
    stats = lse.data_ptr() if lse is not None else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if route == "tensor_core":
            err = lib.repro_flash_attention_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                stats, b, s, sk, h, k.shape[2], d, int(causal), window,
                1.0 / math.sqrt(d), stream)
        else:
            err = lib.repro_flash_attention(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                stats, DTYPES[q.dtype], b, s, sk, h, k.shape[2], d,
                int(causal), window, 1.0 / math.sqrt(d), stream)
    build.check_launch(lib, err, f"flash_attention ({route})")


def launch_flash_attention_bwd(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, out: torch.Tensor,
                               dout: torch.Tensor, lse: torch.Tensor,
                               dd: torch.Tensor, dq: torch.Tensor,
                               dk: torch.Tensor, dv: torch.Tensor,
                               causal: bool, window: int, route: str) -> None:
    """dq, dk, dv of the attention that gave ``out`` and ``lse``, for the
    output gradient ``dout``, on the card by ``route`` (the caller's
    ``bwd_route_for``): three launches over q's S queries and k's Sk keys;
    ``dd`` (B,H,S) f32 is their scratch."""
    lib = build.library("flash_attention_bwd")
    b, s, h, d = q.shape
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dd.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr())
    shape = (b, s, k.shape[1], h, k.shape[2], d, int(causal), window,
             1.0 / math.sqrt(d))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if route == "tensor_core":
            err = lib.repro_flash_attention_bwd_tc(*ptrs, *shape, stream)
        else:
            err = lib.repro_flash_attention_bwd(*ptrs, DTYPES[q.dtype],
                                                *shape, stream)
    build.check_launch(lib, err, f"flash_attention_bwd ({route})")
