"""The device rule of the port's entry points.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, as the tests do). Without a CUDA device and without that
request they raise: nothing falls back to the CPU silently.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda`` (raises without CUDA); otherwise the device
    asked for. On a CUDA device this also turns TF32 off for cuDNN
    convolutions and float32 matmuls (and keeps matmul precision at
    "highest"), so the port computes in full f32 like the reference."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device and none is available; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
