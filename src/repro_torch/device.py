"""The device rule of the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, as the tests do). Without a CUDA device and without that
request they raise: nothing falls back to the CPU silently.
"""
from __future__ import annotations

import functools
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); otherwise the device
    asked for. On a CUDA device this also turns TF32 off for cuDNN
    convolutions and float32 matmuls (and keeps matmul precision at
    "highest"), so the port computes in full f32 like the reference, and
    pins cuDNN to deterministic algorithms without autotuning, so a run
    gives the same bits every time, as the reference's contracts ask."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the kernels'
    launch plans size their grids by it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
