"""The paper's split-network abstraction (§3) over the port's parameter
dicts: a model is partitioned at layer ``j`` into a lower part W^l (generic
features, trained by FedAvg) and an upper part W^u (trained server-side on
metadata). The counterpart of ``repro.core.split.SplitModel``.

``params`` is always a flat dict name -> tensor. Names start with
``lower.`` or ``upper.``, so ``split`` is a partition by prefix and
``merge`` a dict union. The forward functions bind a dict to the module's
architecture with ``torch.func.functional_call``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.func import functional_call

from repro_torch.models.wrn import WRN, build_wrn, init_params
from repro_torch.optim.optimizers import tree_map

Params = Dict[str, torch.Tensor]
PyTree = Any


def _strip(params: Params, prefix: str) -> Params:
    n = len(prefix)
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix)}


@dataclass(frozen=True)
class SplitModel:
    """A module with ``lower`` and ``upper`` parts, driven functionally."""
    module: WRN

    def init(self, generator: torch.Generator,
             device: torch.device) -> Params:
        """Fresh parameters drawn from ``generator``."""
        return init_params(self.module, generator, device)

    def apply_lower(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """NHWC inputs -> NHWC activation maps A^[j]."""
        return functional_call(self.module.lower, _strip(params, "lower."),
                               (x,))

    def apply_upper(self, params: Params, acts: torch.Tensor) -> torch.Tensor:
        """NHWC activation maps -> logits (``params`` may hold only the
        upper part)."""
        return functional_call(self.module.upper, _strip(params, "upper."),
                               (acts,))

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """Full forward: NHWC inputs -> logits."""
        return self.apply_upper(params, self.apply_lower(params, x))

    @staticmethod
    def split(params: Params) -> Tuple[Params, Params]:
        """-> (lower, upper) views of a full parameter dict."""
        lower = {k: v for k, v in params.items() if k.startswith("lower.")}
        upper = {k: v for k, v in params.items() if k.startswith("upper.")}
        return lower, upper

    @staticmethod
    def merge(lower: Params, upper: Params) -> Params:
        """Inverse of ``split``."""
        return {**lower, **upper}

    def loss(self, params: Params, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy of the full model (f32 log-softmax)."""
        logits = self.apply(params, x)
        return F.cross_entropy(logits.float(), y.long())

    def upper_loss(self, upper: Params, acts: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
        """Per-sample cross-entropy of the upper part on activation maps."""
        logits = self.apply_upper(upper, acts)
        return F.cross_entropy(logits.float(), targets.long(),
                               reduction="none")


def make_split_wrn(cfg) -> SplitModel:
    """SplitModel view of the WRN at the paper's split point."""
    return SplitModel(build_wrn(cfg))


def tree_slice_layers(tree: PyTree, start: int, stop: int) -> PyTree:
    """Every leaf of ``tree`` sliced along axis 0, its stacked-layer axis
    (views, no copy)."""
    return tree_map(lambda x: x[start:stop], tree)
