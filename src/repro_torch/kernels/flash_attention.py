"""Launcher of the prefill attention CUDA kernel (``csrc/flash_attention.cu``).

The port's counterpart of ``repro.kernels.flash_attention.
flash_attention_kernel``: blocked GQA attention with an online softmax in
f32, causal and/or sliding-window, over q (B,S,H,D) and k/v (B,S,KV,D) in
f32 or bf16. Nothing is padded: the kernel masks keys at the true S.

Takes CUDA tensors that ``kernels/ops.py`` has already checked and
allocated; launches on PyTorch's current stream and does not synchronize.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launch_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           out: torch.Tensor, causal: bool,
                           window: int) -> None:
    """out (B,S,H,D) = attention of q over k, v on the card."""
    lib = build.library("flash_attention")
    b, s, h, d = q.shape
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            DTYPES[q.dtype], b, s, h, k.shape[2], d, int(causal), window,
            1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(lib, err, "flash_attention")
