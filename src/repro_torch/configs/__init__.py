"""Configs of the port: the paper's WRN, the FL knobs, the LM training
step's knobs and the LM architectures (copies of ``repro``'s).

``get_config`` knows every architecture id of ``repro.configs.ARCHS``: the
dense GQA ``llama3.2-1b``, ``qwen2-0.5b``, ``gemma3-4b`` and
``phi3-medium-14b``, the mixture-of-experts ``qwen3-moe-30b-a3b``,
``deepseek-v2-236b`` (MLA attention and an MoE with shared experts), the
attention-free ``rwkv6-3b``, the Mamba / attention hybrid
``jamba-1.5-large-398b``, the encoder-decoder ``whisper-medium`` (its mel
front end stubbed: frame embeddings in) and ``internvl2-26b`` (its vision
tower stubbed: patch embeddings in, projected and put before the text).
An id ``repro`` does not know raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (INPUT_SHAPES, FLConfig, ModelConfig,
                                      ShapeConfig, TrainConfig)
from repro_torch.configs.wrn_cifar import CONFIG as WRN_CONFIG, WRNConfig

# arch-id -> module name
ARCHS = {
    "deepseek-v2-236b":     "deepseek_v2_236b",
    "gemma3-4b":            "gemma3_4b",
    "internvl2-26b":        "internvl2_26b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llama3.2-1b":          "llama3_2_1b",
    "phi3-medium-14b":      "phi3_medium_14b",
    "qwen2-0.5b":           "qwen2_0_5b",
    "qwen3-moe-30b-a3b":    "qwen3_moe_30b_a3b",
    "rwkv6-3b":             "rwkv6_3b",
    "whisper-medium":       "whisper_medium",
}


def get_config(arch_id: str) -> ModelConfig:
    """The ``ModelConfig`` of an architecture id."""
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
