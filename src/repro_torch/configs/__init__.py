"""Configs of the port: the paper's WRN, the FL knobs, the LM training
step's knobs and the LM architectures whose path is ported.

``get_config`` knows the decoders that the LM serving path runs (copies of
``repro``'s): the dense GQA ``llama3.2-1b``, ``qwen2-0.5b``, ``gemma3-4b``
and ``phi3-medium-14b``, the mixture-of-experts ``qwen3-moe-30b-a3b``,
``deepseek-v2-236b`` (MLA attention and an MoE with shared experts) and
the attention-free ``rwkv6-3b``.
Every other architecture id of ``repro.configs.ARCHS`` raises
``NotImplementedError`` naming the ``ROADMAP.md`` Queue 1 item that ports
its layers; an id ``repro`` does not know either raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, FLConfig, ModelConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.configs.wrn_cifar import CONFIG as WRN_CONFIG, WRNConfig

# arch-id -> module name (the ported ones)
ARCHS = {
    "deepseek-v2-236b":  "deepseek_v2_236b",
    "gemma3-4b":         "gemma3_4b",
    "llama3.2-1b":       "llama3_2_1b",
    "phi3-medium-14b":   "phi3_medium_14b",
    "qwen2-0.5b":        "qwen2_0_5b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "rwkv6-3b":          "rwkv6_3b",
}

# the rest of repro's ARCHS -> what they wait for (ROADMAP.md Queue 1)
NOT_PORTED = {
    "jamba-1.5-large-398b": "Queue 1 item 13e (Mamba mixer)",
    "whisper-medium":       "Queue 1 item 13g (encoder and cross-attention)",
    "internvl2-26b":        "Queue 1 item 13g (vision-prefix embeddings)",
}


def get_config(arch_id: str) -> ModelConfig:
    """The ``ModelConfig`` of a ported architecture id."""
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id!r} is not ported to repro_torch yet: ROADMAP.md "
            f"{NOT_PORTED[arch_id]}")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; choose from "
                       f"{sorted(ARCHS)}")
    return importlib.import_module(
        f"repro_torch.configs.{ARCHS[arch_id]}").CONFIG


def get_wrn_config() -> WRNConfig:
    """The paper's WRN-40-1 (``.reduced()`` gives the WRN-10-1 test size)."""
    return WRN_CONFIG


__all__ = ["ARCHS", "FLConfig", "INPUT_SHAPES", "ModelConfig",
           "ShapeConfig", "TrainConfig", "WRNConfig", "WRN_CONFIG",
           "get_config", "get_wrn_config"]
