"""FedAvg (McMahan et al.) — the paper's Eq. (2) and LocalUpdate (§3.2),
over the port's parameter dicts (the counterpart of ``repro.core.fedavg``).
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from repro_torch.optim.optimizers import sgd_step, value_and_grad

Params = Dict[str, torch.Tensor]


def weight_average(client_params: Sequence[Params]) -> Params:
    """Eq. 2: W_G(t) = (1/m) sum_k W_Ck(t), the same left-to-right sum as
    the reference."""
    w = 1.0 / len(client_params)
    with torch.no_grad():
        return {k: sum(w * p[k] for p in client_params)
                for k in client_params[0]}


def local_update(params: Params, lr: float, batches_x: torch.Tensor,
                 batches_y: torch.Tensor,
                 loss_fn: Callable[[Params, torch.Tensor, torch.Tensor],
                                   torch.Tensor]):
    """§3.2 LocalUpdate: SGD steps over pre-batched local data
    ``batches_x`` (steps, bs, ...) / ``batches_y`` (steps, bs).
    Returns (params, losses (steps,))."""
    losses = []
    for bx, by in zip(batches_x, batches_y):
        loss, grads = value_and_grad(loss_fn, params, bx, by)
        params = sgd_step(params, grads, lr)
        losses.append(loss)
    return params, torch.stack(losses) if losses else torch.zeros(0)
