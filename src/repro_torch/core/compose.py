"""§3.3 ModelCompose + evaluation of M_COM(t): test accuracy of a
classifier, or next-token accuracy of an LM (3-D logits), as in
``repro.core.compose``."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.split import SplitModel

Params = Dict[str, torch.Tensor]


def compose(model: SplitModel, fedavg_params: Params,
            upper_trained: Params) -> Params:
    """M_COM(t) = [ W_G^l(t-1) ; W_S^u(t) ]."""
    lower, _ = model.split(fedavg_params)
    return model.merge(lower, upper_trained)


def evaluate(model: SplitModel, params: Params, x: torch.Tensor,
             y: torch.Tensor, batch_size: int = 200) -> float:
    """Test accuracy over ``n // bs`` full batches of ``bs = min(200, n)``
    (the reference drops the ragged tail the same way). BatchNorm uses the
    batch's statistics, so the batch size is part of the result. For an LM
    (``x`` tokens (N, T), logits (N, T, V)) a sequence scores its
    next-token accuracy, ``argmax(logits[:, :-1]) == x[:, 1:]`` averaged
    over its T - 1 positions, and ``y`` is not read."""
    n = x.shape[0]
    bs = min(batch_size, n)
    steps = n // bs
    correct = torch.zeros((), dtype=torch.float32, device=x.device)
    with torch.no_grad():
        for s in range(steps):
            bx, by = x[s * bs:(s + 1) * bs], y[s * bs:(s + 1) * bs]
            logits = model.apply(params, bx)
            if logits.ndim == 3:             # LM: next-token accuracy
                pred = torch.argmax(logits[:, :-1], -1)
                correct += (pred == bx[:, 1:]).float().mean(-1).sum()
            else:
                correct += (torch.argmax(logits, -1) == by).sum()
    return float(correct / (steps * bs))
