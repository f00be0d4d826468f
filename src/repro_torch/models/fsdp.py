"""The data axis of a step: FSDP's weights over "data", and the rows of a
batch split over it. ``models/model_axis.py`` is the model axis; this is
its counterpart for "data".

A step that runs on a mesh whose "data" axis is above 1, or whose batch
rows split over ranks, enters ``over(ranks, dims, rows)``, ``ranks`` the
data axis's group:

* ``dims``: where the plan shards a second weight dim over "data" (FSDP,
  ``launch/sharding.py``: the archs above ``FSDP_THRESHOLD``), a tree
  shaped like the parameters that gives each leaf's data-split dim,
  counted from its end (so a leaf's scan-stacked or cohort-stacked views
  read the same entry), or None where the leaf is whole on every data
  rank. It is read from the leaves' DTensor placements, or from the
  specs the dry run gives with its local shards (``data_dims``), not
  guessed from shapes. The LM gathers each block's data-split leaves
  at the block's entry (``gather_block``, inside the unit that
  ``LM._run_stages`` checkpoints, so remat gathers them again in the
  backward and one block's gathered weights are alive at a time), and
  the embedding and the head where they are read (``gather_leaf``). The
  layers then see exactly the model-axis shards they see without FSDP.
* ``rows``: the group over which the batch's rows split, each rank
  holding its own share (None: every rank all of them), so statistics
  over the batch's tokens (the MoE's load-balance term) are means over
  that group (``mean``). It is the data axis's group in training; on two
  pods an inference batch splits over ("pod", "data") where it divides,
  while the weights gather over "data" alone, inside each pod.

The gradient. A data rank's loss is the mean over its rows, and the
one-rank step's is the mean over all of them: 1/d of the sum of the d
ranks' means. So every gradient is the mean over the data ranks of each
rank's: a gathered leaf's backward sums the ranks' gradients in f32,
keeps this rank's chunk (``core/collectives.py`` ``reduce_scatter_cat``)
and divides by d; the leaves whole on every data rank (norms, the router,
MLA's down-projections, Mamba's and RWKV's vectors) are averaged over the
ranks by the step (``mean_grads``). Where the ranks run the same rows (a
replicated batch, the meta steps' selected rows), the mean of equal
gradients is the gradient, counted once. ``mean`` is the forward's
counterpart: a statistic averaged over the ranks whose backward passes
the gradient through unchanged, as every rank's loss holds the same
mean.

Outside ``over`` (or with ``ranks`` None) every function here is the
plain one-rank op.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, NamedTuple, Optional

import torch

from repro_torch.core.collectives import (Ranks, all_gather_cat,
                                          all_reduce_tensor,
                                          reduce_scatter_cat)

PyTree = Any


class Layout(NamedTuple):
    """The data axis a step runs on: its ranks (None at 1), the
    parameters' data-split dims (None: no FSDP) and the group the
    batch's rows split over (None: not split)."""
    ranks: Optional[Ranks]
    dims: PyTree
    rows: Optional[Ranks]


_LAYOUT: Optional[Layout] = None


@contextmanager
def over(ranks: Optional[Ranks], dims: PyTree = None,
         rows: Optional[Ranks] = None):
    """Run the LM on the data axis ``ranks`` (None: one rank), the
    parameters' data-split ``dims`` (``data_dims``) and the batch's rows
    split over ``rows`` (None: whole on every rank)."""
    global _LAYOUT
    prev = _LAYOUT
    _LAYOUT = (None if ranks is None and rows is None
               else Layout(ranks, dims, rows))
    try:
        yield
    finally:
        _LAYOUT = prev


def active() -> Optional[Layout]:
    """The data axis the LM runs on (None outside ``over``)."""
    return _LAYOUT


def data_dims(tree: PyTree, axes) -> PyTree:
    """Each leaf's dim that "data" splits, counted from the leaf's end,
    where "data" is above 1 in ``axes`` (a ``DeviceMesh`` or its axis
    sizes): read from a DTensor's placements or a ``sharding.Placed``'s
    spec (``sharding.split_axes``); None for a leaf whole on every data
    rank and for a plain tensor."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import mesh_axis_sizes
    if not isinstance(axes, dict):
        axes = mesh_axis_sizes(axes)
    on = axes.get("data", 1) > 1

    def one(x):
        for dim, names in sh.split_axes(x).items():
            if on and "data" in names:
                return dim - sh.leaf_ndim(x)
        return None
    return sh.map_leaves(one, tree)


def dims(key: str) -> PyTree:
    """The active layout's dims under the parameters' top-level ``key``
    (None outside ``over`` or without FSDP)."""
    if _LAYOUT is None or _LAYOUT.dims is None:
        return None
    return _LAYOUT.dims.get(key)


class _GatherData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, dim):
        ctx.ranks, ctx.dim, ctx.dtype = ranks, dim, x.dtype
        if dim == 0:
            return all_gather_cat(x, ranks, 0)
        # gathered along dim 0 and viewed back: no concatenated copy beside
        # the gathered parts (a block's experts are ~10 GB a rank at
        # jamba's width), the leaf a strided view the products take as is
        return all_gather_cat(x.movedim(dim, 0).contiguous(), ranks,
                              0).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        wide = torch.promote_types(g.dtype, torch.float32)
        chunk = reduce_scatter_cat(g.to(wide), ctx.ranks, ctx.dim)
        return (chunk / ctx.ranks.size).to(ctx.dtype), None, None


def gather_leaf(x: Optional[torch.Tensor], dim: Optional[int]
                ) -> Optional[torch.Tensor]:
    """``x`` gathered over the data ranks along ``dim`` (counted from its
    end) where the layout splits it; ``x`` itself otherwise."""
    if x is None or dim is None or _LAYOUT is None:
        return x
    return _GatherData.apply(x, _LAYOUT.ranks, x.ndim + dim)


def gather_block(params: PyTree, block_dims: PyTree) -> PyTree:
    """One block's parameters (a dict of leaves, or a list of such) with
    every data-split leaf gathered over the data ranks."""
    if block_dims is None or _LAYOUT is None:
        return params
    if isinstance(params, dict):
        return {k: gather_block(v, block_dims[k]) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(gather_block(v, d)
                            for v, d in zip(params, block_dims))
    return gather_leaf(params, block_dims)


def at(tree: PyTree, *path) -> PyTree:
    """``tree[path[0]][path[1]]...``, None wherever a level is None."""
    for key in path:
        if tree is None:
            return None
        tree = tree[key]
    return tree


class _Mean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks):
        return all_reduce_tensor(x, ranks) / ranks.size

    @staticmethod
    def backward(ctx, g):
        return g, None


def mean(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the rows group where each rank holds its own
    rows (``x`` itself otherwise); the gradient passes through unchanged
    (each rank's gradient is averaged over the ranks after)."""
    if _LAYOUT is None or _LAYOUT.rows is None:
        return x
    return _Mean.apply(x, _LAYOUT.rows)


def rows_gathered(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` along dim 0, in the rows group's rank
    order (``x`` where the rows are not split); no gradient."""
    if _LAYOUT is None or _LAYOUT.rows is None:
        return x
    return all_gather_cat(x, _LAYOUT.rows, 0)


def my_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's ``n`` rows of ``x`` (every rank's rows in rank
    order)."""
    if _LAYOUT is None or _LAYOUT.rows is None:
        return x
    return x[_LAYOUT.rows.rank * n:(_LAYOUT.rows.rank + 1) * n]


def mean_grads(grads: PyTree, dims: PyTree, ranks: Ranks) -> PyTree:
    """The gradients of the leaves whole on every data rank (``dims``
    None) averaged over the data ranks; the data-split leaves' are
    already their chunk of the mean (their gather's backward)."""
    if isinstance(grads, dict):
        return {k: mean_grads(v, at(dims, k), ranks)
                for k, v in grads.items()}
    if isinstance(grads, (list, tuple)):
        return type(grads)(mean_grads(v, at(dims, i), ranks)
                           for i, v in enumerate(grads))
    if grads is None or dims is not None:
        return grads
    return all_reduce_tensor(grads, ranks) / ranks.size
