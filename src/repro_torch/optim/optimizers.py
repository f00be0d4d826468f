"""Plain SGD over parameter dicts and the paper's explicit L2 penalty — the
parts of ``repro.optim.optimizers`` the main path uses (``sgd`` with
momentum 0, ``apply_l2``).

The paper trains with SGD (lr 0.1) and studies L2 regularization
(Tables 6/7). An update is ``p + (-lr * g)``, the same two roundings as the
reference's ``(p + u)`` with ``u = -lr * g``.
"""
from __future__ import annotations

from typing import Dict

import torch

Params = Dict[str, torch.Tensor]


def sgd_step(params: Params, grads: Params, lr: float) -> Params:
    """One momentum-free SGD step -> new params (detached)."""
    with torch.no_grad():
        return {k: p + (-lr) * grads[k] for k, p in params.items()}


def apply_l2(loss: torch.Tensor, params: Params, l2: float) -> torch.Tensor:
    """Explicit L2 penalty added to the loss (paper Tables 6/7)."""
    if not l2:
        return loss
    sq = sum(torch.sum(torch.square(p.float())) for p in params.values())
    return loss + l2 * sq


def value_and_grad(loss_fn, params: Params, *args):
    """(loss, grads) of ``loss_fn(params, *args)`` w.r.t. every entry of
    ``params``; the returned loss is detached."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, *args)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves.keys(), grads))
