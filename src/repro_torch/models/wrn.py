"""Wide Residual Network (Zagoruyko & Komodakis) — the paper's global model,
as an ``nn.Module`` with a ``lower`` and an ``upper`` part.

WRN-40-1: conv3x3(16) -> group1(16) -> group2(32,/2) -> group3(64,/2)
          -> norm+relu -> global avg pool -> fc(10)
The paper splits after group 1, so ``lower`` is conv_in + group1 and the
activation maps are 16 x 32 x 32 (§4.1). The counterpart of
``repro.models.wrn``; what must agree with it:

* BatchNorm uses batch statistics in train AND eval, biased variance,
  eps=1e-5 (``repro/models/wrn.py:37-40``); no running statistics.
* Convolutions pad as XLA's "SAME" does. For a 3x3 stride-2 conv on an even
  size that is 0 rows before and 1 after; PyTorch's symmetric
  ``padding=1`` would sample other pixels. ``_same_pad`` pads explicitly.
* The public layout is the reference's: inputs and activation maps are
  NHWC (selection flattens the maps in NHWC order, and the frames carry
  them); inside, the module runs NCHW/OIHW for cuDNN.

The module holds the architecture only (it is built on the ``meta``
device); weights live in a flat dict name -> tensor ("params") that
``torch.func.functional_call`` binds per call. ``params_from_jax`` /
``params_to_jax`` map to and from the reference's parameter tree (HWIO
convs, BatchNorm ``scale``/``bias``, ``fc_w`` as (in, out)).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.wrn_cifar import WRNConfig

Params = Dict[str, torch.Tensor]
BN_EPS = 1e-5


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Pad an NCHW tensor as XLA's "SAME": out = ceil(in / stride), the
    total padding split with the extra row/column after."""
    pads = []
    for size in (x.shape[3], x.shape[2]):          # F.pad order: W, then H
        out = -(-size // stride)
        total = max((out - 1) * stride + k - size, 0)
        pads += [total // 2, total - total // 2]
    if any(pads):
        x = F.pad(x, pads)
    return x


class Conv(nn.Module):
    """Bias-free kxk convolution with "SAME" padding; weight is OIHW."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.k, self.stride = k, stride
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))

    def forward(self, x):
        return F.conv2d(_same_pad(x, self.k, self.stride), self.weight,
                        stride=self.stride)


class BatchNorm(nn.Module):
    """BatchNorm over (N, H, W) with batch statistics, always."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c))
        self.bias = nn.Parameter(torch.empty(c))

    def forward(self, x):
        return F.batch_norm(x, None, None, self.weight, self.bias,
                            training=True, eps=BN_EPS)


class Block(nn.Module):
    """Pre-activation basic block (``repro.models.wrn.block_apply``)."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.bn1 = BatchNorm(cin)
        self.conv1 = Conv(cin, cout, 3, stride)
        self.bn2 = BatchNorm(cout)
        self.conv2 = Conv(cout, cout, 3, 1)
        self.shortcut = Conv(cin, cout, 1, stride) if cin != cout else None

    def forward(self, x):
        h = F.relu(self.bn1(x))
        sc = self.shortcut(h) if self.shortcut is not None else x
        h = self.conv1(h)
        h = F.relu(self.bn2(h))
        return self.conv2(h) + sc


def _group(cin: int, cout: int, n: int, stride: int) -> nn.Sequential:
    return nn.Sequential(*[Block(cin if b == 0 else cout, cout,
                                 stride if b == 0 else 1) for b in range(n)])


def _widths(cfg: WRNConfig) -> List[int]:
    return [16, 16 * cfg.widen, 32 * cfg.widen, 64 * cfg.widen]


class WRNLower(nn.Module):
    """conv_in + groups 1..split_group: NHWC images -> NHWC maps."""

    def __init__(self, cfg: WRNConfig):
        super().__init__()
        w, n = _widths(cfg), cfg.blocks_per_group
        self.conv_in = Conv(cfg.channels, w[0], 3)
        for g in range(1, cfg.split_group + 1):
            self.add_module(f"group{g}",
                            _group(w[g - 1], w[g], n, 1 if g == 1 else 2))
        self.split_group = cfg.split_group

    def forward(self, x):
        h = self.conv_in(x.permute(0, 3, 1, 2))
        for g in range(1, self.split_group + 1):
            h = getattr(self, f"group{g}")(h)
        return h.permute(0, 2, 3, 1)


class WRNUpper(nn.Module):
    """groups split_group+1..3 + norm/relu/pool + fc: NHWC maps -> logits."""

    def __init__(self, cfg: WRNConfig):
        super().__init__()
        w, n = _widths(cfg), cfg.blocks_per_group
        for g in range(cfg.split_group + 1, 4):
            self.add_module(f"group{g}", _group(w[g - 1], w[g], n, 2))
        self.bn_out = BatchNorm(w[3])
        self.fc = nn.Linear(w[3], cfg.num_classes)
        self.split_group = cfg.split_group

    def forward(self, acts):
        h = acts.permute(0, 3, 1, 2)
        for g in range(self.split_group + 1, 4):
            h = getattr(self, f"group{g}")(h)
        h = F.relu(self.bn_out(h)).mean((2, 3))
        return self.fc(h)


class WRN(nn.Module):
    """The full network; ``lower`` and ``upper`` are the paper's split."""

    def __init__(self, cfg: WRNConfig):
        super().__init__()
        self.cfg = cfg
        self.lower = WRNLower(cfg)
        self.upper = WRNUpper(cfg)

    def forward(self, x):
        return self.upper(self.lower(x))


def build_wrn(cfg: WRNConfig) -> WRN:
    """The architecture on the ``meta`` device (no weights of its own)."""
    with torch.device("meta"):
        return WRN(cfg)


def init_params(module: WRN, generator: torch.Generator,
                device: torch.device) -> Params:
    """He-normal convs, BN (1, 0), fc N(0, 1/fan_in) and zero bias, as
    ``repro.models.wrn.init_wrn`` draws them, from ``generator`` (a CPU
    generator; the numbers differ from JAX's, the distributions do not)."""
    out: Params = {}
    for name, p in module.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("fc.weight"):
            t = torch.randn(shape, generator=generator) / math.sqrt(shape[1])
        elif name.endswith("fc.bias") or (".bn" in name
                                          and name.endswith(".bias")):
            t = torch.zeros(shape)
        elif ".bn" in name:
            t = torch.ones(shape)
        else:                                       # conv OIHW
            fan_in = shape[1] * shape[2] * shape[3]
            t = torch.randn(shape, generator=generator) \
                * math.sqrt(2.0 / fan_in)
        out[name] = t.to(device)
    return out


# ---------------------------------------------------------------------------
# the reference's parameter tree
# ---------------------------------------------------------------------------
def _from_ref(path: str, a) -> torch.Tensor:
    t = torch.from_numpy(np.array(a))               # a writable copy
    if path.endswith("fc_w"):
        return t.T.contiguous()
    if t.ndim == 4:                                  # HWIO -> OIHW
        return t.permute(3, 2, 0, 1).contiguous()
    return t


def _to_ref(name: str, t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if name.endswith("fc.weight"):
        t = t.T
    elif t.ndim == 4:                                # OIHW -> HWIO
        t = t.permute(2, 3, 1, 0)
    return np.ascontiguousarray(t.numpy())


def params_from_jax(tree, split_group: int = 1,
                    device: Optional[torch.device] = None) -> Params:
    """The reference's WRN parameter tree (nested dicts/lists of arrays,
    e.g. ``jax.tree.map(np.asarray, init_wrn(cfg, key))``) -> port params.
    Groups up to ``split_group`` go under ``lower.``, the rest ``upper.``."""
    out: Params = {"lower.conv_in.weight": _from_ref("conv_in",
                                                     tree["conv_in"])}
    for g in (1, 2, 3):
        part = "lower" if g <= split_group else "upper"
        for b, blk in enumerate(tree[f"group{g}"]):
            pre = f"{part}.group{g}.{b}"
            for bn in ("bn1", "bn2"):
                out[f"{pre}.{bn}.weight"] = _from_ref(bn, blk[bn]["scale"])
                out[f"{pre}.{bn}.bias"] = _from_ref(bn, blk[bn]["bias"])
            for cv in ("conv1", "conv2", "shortcut"):
                if cv in blk:
                    out[f"{pre}.{cv}.weight"] = _from_ref(cv, blk[cv])
    out["upper.bn_out.weight"] = _from_ref("bn", tree["bn_out"]["scale"])
    out["upper.bn_out.bias"] = _from_ref("bn", tree["bn_out"]["bias"])
    out["upper.fc.weight"] = _from_ref("fc_w", tree["fc_w"])
    out["upper.fc.bias"] = _from_ref("fc_b", tree["fc_b"])
    if device is not None:
        out = {k: v.to(device) for k, v in out.items()}
    return out


def params_to_jax(params: Params) -> dict:
    """Inverse of ``params_from_jax``: port params (full, lower-only or
    upper-only) -> the reference's tree of numpy arrays (HWIO convs). Its
    ``jax.tree.leaves`` order is the weight frames' wire order."""
    tree: dict = {}
    groups: Dict[int, Dict[int, dict]] = {}
    for name, t in params.items():
        parts = name.split(".")[1:]                  # drop lower/upper
        a = _to_ref(name, t)
        if parts[0] == "conv_in":
            tree["conv_in"] = a
        elif parts[0] == "bn_out":
            tree.setdefault("bn_out", {})[
                "scale" if parts[1] == "weight" else "bias"] = a
        elif parts[0] == "fc":
            tree["fc_w" if parts[1] == "weight" else "fc_b"] = a
        else:                                        # groupG.b.layer.param
            blk = groups.setdefault(int(parts[0][5:]), {}).setdefault(
                int(parts[1]), {})
            if parts[2].startswith("bn"):
                blk.setdefault(parts[2], {})[
                    "scale" if parts[3] == "weight" else "bias"] = a
            else:
                blk[parts[2]] = a
    for g, blocks in groups.items():
        tree[f"group{g}"] = [blocks[b] for b in sorted(blocks)]
    return tree
