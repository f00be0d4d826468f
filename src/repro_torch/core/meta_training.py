"""§3.3 MetaTraining: the server trains the UPPER part of the global model on
the aggregated metadata D_M(t), starting every round from W_G^u(0). The
counterpart of ``repro.core.meta_training``; L2 regularization (paper
Tables 6/7) enters as an explicit penalty on the upper weights.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.optim.optimizers import apply_l2, sgd_step, value_and_grad

Params = Dict[str, torch.Tensor]


def meta_train(upper_init: Params,
               upper_loss: Callable[[Params, torch.Tensor, torch.Tensor],
                                    torch.Tensor],
               acts: torch.Tensor, targets: torch.Tensor,
               perms: torch.Tensor, *, batch_size: int, lr: float,
               l2: float = 0.0, valid: Optional[torch.Tensor] = None):
    """Train upper weights on metadata.

    acts:    (M, ...) selected activation maps (all clients aggregated)
    targets: (M,) labels
    perms:   (epochs, M) one shuffle order per epoch (the explicit draw)
    valid:   (M,) bool — invalid rows get zero loss weight.
    Each epoch takes ``perms[e][:steps*bs]`` in batches of
    ``bs = min(batch_size, M)``. Returns (trained_upper, losses).
    """
    m = acts.shape[0]
    bs = min(batch_size, m)
    steps = max(m // bs, 1)
    w = (torch.ones((m,), dtype=torch.float32, device=acts.device)
         if valid is None else valid.to(torch.float32))

    def weighted_loss(p, a, t, bw):
        per = upper_loss(p, a, t)                    # (bs,) per-sample loss
        loss = (per * bw).sum() / torch.clamp(bw.sum(), min=1.0)
        return apply_l2(loss, p, l2)

    params, losses = upper_init, []
    for perm in perms:
        perm = perm[:steps * bs].to(acts.device)
        for s in range(steps):
            idx = perm[s * bs:(s + 1) * bs]
            loss, g = value_and_grad(weighted_loss, params, acts[idx],
                                     targets[idx], w[idx])
            params = sgd_step(params, g, lr)
            losses.append(loss)
    return params, torch.stack(losses) if losses else torch.zeros(0)
