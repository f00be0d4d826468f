"""SGD and AdamW over parameter trees, the paper's explicit L2 penalty and
the global-norm clip: the port of ``repro.optim.optimizers``.

The paper trains with SGD (lr 0.1) and studies L2 regularization
(Tables 6/7). An update is ``p + u`` with ``u = -lr * g``, the same two
roundings as the reference's ``(p + u)``. Trees are nested dicts, lists
and tuples of tensors (the LM's parameters) or flat dicts (the WRN's);
``sgd_step`` and ``value_and_grad`` keep the WRN path's ops on flat dicts,
bit for bit.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple

import torch

Params = Dict[str, torch.Tensor]
PyTree = Any


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------
def tree_leaves(tree: PyTree) -> List[torch.Tensor]:
    """The tensors of nested dicts / lists / tuples, in order (None
    skipped)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` on every leaf of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)


def tree_unflatten(tree: PyTree, leaves) -> PyTree:
    """``tree``'s structure with its tensors replaced, in order, by
    ``leaves``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------
class Optimizer(NamedTuple):
    """A pair of functions over trees, as the reference's: ``init(params)
    -> state`` and ``update(grads, state, params, step=None) -> (updates,
    state)``; ``apply`` adds the updates."""
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple]

    def apply(self, grads, state, params, step=None):
        updates, state = self.update(grads, state, params, step)
        with torch.no_grad():
            new_params = tree_map(lambda p, u: (p + u).to(p.dtype), params,
                                  updates)
        return new_params, state


def _as_lr(lr, step):
    return lr(step) if callable(lr) else lr


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    """SGD with optional (decoupled) weight decay == the paper's L2 term;
    the state is () without momentum, else the momentum tree."""

    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def update(grads, state, params, step=None):
        lr_t = _as_lr(lr, step)
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p.to(g.dtype),
                             grads, params)
        if momentum == 0.0:
            return tree_map(lambda g: -lr_t * g, grads), ()
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -(lr_t * (momentum * m + g)), new_m,
                           grads)
        else:
            upd = tree_map(lambda m: -lr_t * m, new_m)
        return upd, new_m

    return Optimizer(init, update)


class AdamState(NamedTuple):
    """AdamW's state: the first and second moment trees and the step count
    (a 0-d int32 tensor)."""
    mu: PyTree
    nu: PyTree
    count: torch.Tensor


def adamw(lr, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW (decoupled weight decay), as the reference's: bias-corrected
    moments, ``lr`` a float or a schedule of the step (the count after
    this update unless ``step`` is given)."""

    def init(params):
        return AdamState(tree_map(torch.zeros_like, params),
                         tree_map(torch.zeros_like, params),
                         torch.zeros((), dtype=torch.int32))

    @torch.no_grad()
    def update(grads, state, params, step=None):
        count = state.count + 1
        lr_t = _as_lr(lr, count if step is None else step)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu,
                      grads)
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)

        def u(m, v, p):
            step_ = m / c1 / (torch.sqrt(v / c2) + eps)
            if weight_decay:
                step_ = step_ + weight_decay * p.to(step_.dtype)
            return -lr_t * step_

        return tree_map(u, mu, nu, params), AdamState(mu, nu, count)

    return Optimizer(init, update)


def global_norm(tree: PyTree) -> torch.Tensor:
    """The L2 norm of every leaf together, in f32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    """``grads`` scaled by min(1, max_norm / global_norm(grads))."""
    n = global_norm(grads)
    scale = torch.clamp(max_norm / (n + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads)


def sgd_step(params: Params, grads: Params, lr: float) -> Params:
    """One momentum-free SGD step over a flat dict -> new params
    (detached)."""
    with torch.no_grad():
        return {k: p + (-lr) * grads[k] for k, p in params.items()}


def apply_l2(loss: torch.Tensor, params: PyTree, l2: float) -> torch.Tensor:
    """Explicit L2 penalty added to the loss (paper Tables 6/7)."""
    if not l2:
        return loss
    sq = sum(torch.sum(torch.square(p.float())) for p in tree_leaves(params))
    return loss + l2 * sq


def value_and_grad(loss_fn, params: PyTree, *args):
    """(loss, grads) of ``loss_fn(params, *args)`` w.r.t. every tensor of
    ``params`` (a flat dict or a tree; the grads have its structure); the
    returned loss is detached."""
    leaves = tree_map(lambda v: v.detach().requires_grad_(True), params)
    loss = loss_fn(leaves, *args)
    grads = torch.autograd.grad(loss, tree_leaves(leaves))
    return loss.detach(), tree_unflatten(params, grads)
