"""Model registry and parameter counts of the port, from its own parameter
shapes (``LM.init`` on the ``meta`` device: no memory is allocated)."""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

from repro_torch.configs.base import ModelConfig


def make_lm(cfg: ModelConfig, force_swa: bool = False):
    from repro_torch.models.transformer import LM
    return LM(cfg, force_swa=force_swa)


def make_split_model(cfg_or_id, split_layer: Optional[int] = None):
    """(SplitLM, lm) of a config or an architecture id:
    ``transformer.make_split_lm`` at ``split_layer`` (default the config's
    ``split_layer``), as ``repro.models.make_split_model``."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import make_split_lm
    cfg = get_config(cfg_or_id) if isinstance(cfg_or_id, str) else cfg_or_id
    return make_split_lm(cfg, split_layer)


_EXPERT_KEYS = ("we_gate", "we_up", "we_down")


@functools.lru_cache(maxsize=64)
def _param_shapes(cfg: ModelConfig) -> List[Tuple[str, Tuple[int, ...]]]:
    """(path, shape) of every parameter leaf of ``LM(cfg)``."""
    shapes = make_lm(cfg).init(None, device="meta")
    out: List[Tuple[str, Tuple[int, ...]]] = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f"{path}/{i}")
        else:
            out.append((path, tuple(tree.shape)))
    walk(shapes, "")
    return out


def count_params(cfg: ModelConfig, active_only: bool = False,
                 include_embed: bool = True) -> int:
    """Parameters of ``cfg``'s LM (``active_only`` scales expert weights by
    top-k / experts; ``include_embed=False`` leaves out embedding and head),
    as ``repro.models.registry.count_params`` counts them."""
    total = 0.0
    frac = (cfg.num_experts_per_tok / cfg.num_experts) if cfg.is_moe else 1.0
    for keys, shape in _param_shapes(cfg):
        n = float(math.prod(shape)) if shape else 1.0
        if not include_embed and ("embed" in keys or "lm_head" in keys):
            continue
        if active_only and any(k in keys for k in _EXPERT_KEYS):
            n *= frac
        total += n
    return int(total)
