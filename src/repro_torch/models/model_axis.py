"""Tensor parallelism over a mesh's "model" axis: what the layers do when a
step runs them on each rank's shard of the weights.

A step that executes a model axis (``launch/steps.py``) holds its
parameters as DTensors on the sharding plan's placements
(``launch/sharding.py``) and runs the model on their local tensors inside
``over(ranks)``, ``ranks`` the model axis's group. There the layers read
which part of a leaf this rank holds from the leaf's local shape against
its full one (``chunk_of``): the whole leaf (replicated), or the rank's
even chunk of one dim. The kernels then see plain local tensors only.

The collectives, as Megatron's (Shoeybi et al., 2019) conjugate pairs,
each an autograd function:

* ``copy``    identity forward, the gradient summed over the ranks: at the
              entry of work that each rank does on its own part (a
              replicated input of column-parallel products; a replicated
              weight used for one rank's heads only);
* ``reduce``  the forward summed over the ranks, identity backward: the
              output of a row-parallel product (attention's ``wo``, the
              FFN's ``w_down``: ``row_product``), the MoE's f32 combine
              and the masked embedding lookup;
* ``gather``  all-gather along a dim: ``summed=False`` where what follows
              is replicated (the head's logits; the backward takes this
              rank's chunk), ``summed=True`` where each rank uses its own
              part of the result (fractional heads, Mamba's ``[u | z]``;
              the backward sums, then takes the chunk: a reduce-scatter);
* ``sum_over`` the forward summed over the ranks and the gradient summed
              too (``reduce`` then ``copy``): a partial sum that every
              rank then reads for its own part, as RWKV's ``ln_x``
              statistic over all heads.

``row_product`` is ``reduce(a @ w)`` (or ``sum_over``'s, ``shared=True``,
for Mamba's ``dbc = u @ w_x``) rounded as one rank's product is: each
rank's partial kept in f32, summed in f32, rounded once to ``a``'s dtype.
Rounding each bf16 partial and summing in bf16 takes three roundings
where one rank takes one: 2.9e-3 from one rank's product and 37% of its
bits differ, against 1.1-2.3e-4 and 0.2-0.7% (``tools/row_parallel_
rounding.py``, NVIDIA H100 80GB HBM3, 700 W).

``part`` is a rank's slice of a leaf: its shard where the plan splits
the leaf, or the slice of a replicated leaf taken through ``copy`` (so
the leaf's gradient is summed over the ranks), as Mamba's ``conv_w``,
RWKV's ``bonus`` and a head-aware plan's replicated ``wk`` are read.
``whole`` and ``mine`` go between a state split on its last dim (RWKV's
token shift in the cache) and the whole vector a rank reads.

They go through ``core/collectives.py`` rather than DTensor's own
redistributions: on one card the ranks are gloo processes, and there
DTensor's gathers of CUDA tensors killed both ranks with torch 2.11
(``tools/gloo_cuda_probe.py``), where the host-staged collectives run.

Outside ``over`` (or with no leaf sharded) every function here is the
plain one-rank op, so the one-rank path is unchanged. The vocabulary is
never gathered in training: ``next_token_nll`` is the log-softmax over a
vocabulary split over the ranks, from an all-reduced max and sum.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.collectives import (Ranks, all_gather_cat,
                                          all_reduce_tensor)

_RANKS: Optional[Ranks] = None


@contextmanager
def over(ranks: Optional[Ranks]):
    """Run the layers on the model axis ``ranks`` (None: one rank)."""
    global _RANKS
    prev, _RANKS = _RANKS, ranks
    try:
        yield
    finally:
        _RANKS = prev


def active() -> Optional[Ranks]:
    """The model axis the layers run on (None outside ``over``)."""
    return _RANKS


def chunk_of(full: int, local: int) -> Tuple[int, int]:
    """The [lo, hi) of a dim of ``full`` entries that this rank holds when
    its leaf has ``local`` of them: all of it, or its rank's even chunk."""
    ax = _RANKS
    if local == full or ax is None:
        if local != full:
            raise ValueError(f"a dim of {local} of {full} outside a model "
                             f"axis")
        return 0, full
    if local * ax.size != full:
        raise ValueError(f"a dim of {local} is no even share of {full} "
                         f"over {ax.size} ranks")
    return ax.rank * local, (ax.rank + 1) * local


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks):
        ctx.ranks = ranks
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_tensor(g, ctx.ranks), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks):
        return all_reduce_tensor(x, ranks)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks, dim, summed):
        ctx.ranks, ctx.dim, ctx.summed = ranks, dim, summed
        ctx.n = x.shape[dim]
        return all_gather_cat(x, ranks, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            g = all_reduce_tensor(g, ctx.ranks)
        return (g.narrow(ctx.dim, ctx.ranks.rank * ctx.n, ctx.n), None, None,
                None)


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks):
        ctx.ranks = ranks
        return all_reduce_tensor(x, ranks)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_tensor(g, ctx.ranks), None


def _mm_f32(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``a @ w`` of 2-D operands before its rounding: f32 (or ``a``'s
    wider dtype) with the GEMM's own f32 accumulation."""
    if a.dtype not in (torch.bfloat16, torch.float16):
        return a @ w
    if a.is_cuda:
        return torch.mm(a, w, out_dtype=torch.float32)
    return a.float() @ w.float()


class _RowProduct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, w, ranks, shared):
        ctx.ranks, ctx.shared = ranks, shared
        ctx.save_for_backward(a, w)
        y = all_reduce_tensor(_mm_f32(a.reshape(-1, a.shape[-1]), w), ranks)
        return y.to(a.dtype).view(tuple(a.shape[:-1]) + (w.shape[-1],))

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        if ctx.shared:
            g = all_reduce_tensor(g, ctx.ranks)
        g2 = g.reshape(-1, g.shape[-1])
        ga = (g2 @ w.t()).view(a.shape) if ctx.needs_input_grad[0] else None
        gw = (a.reshape(-1, a.shape[-1]).t() @ g2
              if ctx.needs_input_grad[1] else None)
        return ga, gw, None, None


def row_product(a: torch.Tensor, w: torch.Tensor,
                shared: bool = False) -> torch.Tensor:
    """``reduce(a @ w)`` (``shared``: ``sum_over(a @ w)``) of this rank's
    columns of ``a`` and rows of ``w``, summed before its one rounding;
    ``a @ w`` outside a model axis."""
    if _RANKS is None:
        return a @ w
    return _RowProduct.apply(a, w, _RANKS, shared)


def copy(x: torch.Tensor) -> torch.Tensor:
    return _Copy.apply(x, _RANKS)


def sum_over(x: torch.Tensor) -> torch.Tensor:
    return _SumOver.apply(x, _RANKS)


def reduce(x: torch.Tensor) -> torch.Tensor:
    return _Reduce.apply(x, _RANKS)


def gather(x: torch.Tensor, dim: int, summed: bool) -> torch.Tensor:
    return _Gather.apply(x, _RANKS, dim % x.ndim, summed)


def even_share(n: int, what: str) -> Tuple[int, int]:
    """This rank's even chunk [lo, hi) of ``n`` whole items (heads,
    experts, channels); ``NotImplementedError`` where they do not divide
    the axis (a fractional head a rank)."""
    if n % _RANKS.size:
        raise NotImplementedError(
            f"{n} {what} over a model axis of {_RANKS.size}: fractional "
            f"{what} a rank are planned, not executed (ROADMAP.md item 15b)")
    per = n // _RANKS.size
    return _RANKS.rank * per, (_RANKS.rank + 1) * per


def part(w: torch.Tensor, full: int, lo: int, hi: int,
         dim: int = -1) -> torch.Tensor:
    """[lo, hi) of ``w``'s dim ``dim`` of ``full`` entries, this rank's
    part: the leaf itself where the plan shards that dim into exactly
    this chunk, else (a replicated leaf) its slice through ``copy``."""
    n = w.shape[dim]
    if n == full:
        if hi - lo == full:
            return w if _RANKS is None else copy(w)
        return copy(w).narrow(dim, lo, hi - lo)
    if chunk_of(full, n) != (lo, hi):
        raise ValueError(f"a shard [{chunk_of(full, n)}) of {full} where "
                         f"this rank computes [{lo}, {hi})")
    return w


def whole(x: torch.Tensor, full: int) -> torch.Tensor:
    """``x`` gathered over the ranks along its last dim where it holds
    this rank's chunk of ``full`` (as it is where it is whole)."""
    if x.shape[-1] == full:
        return x
    chunk_of(full, x.shape[-1])
    return gather(x, -1, summed=False)


def mine(x: torch.Tensor, local: int) -> torch.Tensor:
    """This rank's chunk of ``local`` entries of ``x``'s last dim (``x``
    as it is where ``local`` is its whole width)."""
    lo, hi = chunk_of(x.shape[-1], local)
    return x[..., lo:hi]


# --------------------------------------------------------------------------
# the vocabulary: embedding rows and head columns over the ranks
# --------------------------------------------------------------------------
def embed(w: torch.Tensor, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """``w[tokens]`` of an embedding (``vocab``, d), or of this rank's rows
    of it: each rank looks up the ids in its rows, zeros elsewhere, and
    the sum over the ranks is the lookup (each id in one rank's rows, so
    the sum adds zeros: the one-rank lookup's bits)."""
    if _RANKS is None or w.shape[0] == vocab:
        return w[tokens]
    lo, hi = chunk_of(vocab, w.shape[0])
    ids = tokens.long() - lo
    inside = (ids >= 0) & (ids < hi - lo)
    rows = w[torch.where(inside, ids, 0)]
    return reduce(torch.where(inside[..., None], rows,
                              torch.zeros((), dtype=rows.dtype,
                                          device=rows.device)))


def head_logits(h: torch.Tensor, w: torch.Tensor, vocab: int
                ) -> torch.Tensor:
    """``h @ w``, the head (d, ``vocab``) or this rank's columns of it:
    each rank's logits gathered over the vocabulary."""
    if _RANKS is None or w.shape[-1] == vocab:
        return h @ w
    return gather(copy(h) @ w, -1, summed=False)


class _VocabNLL(torch.autograd.Function):
    """-log softmax at the targets, f32 logits (..., V/m) of this rank's
    vocabulary chunk; targets already offset to the chunk (outside: no
    term here). The max and the sum of exp run over the ranks."""

    @staticmethod
    def forward(ctx, logits, tgt, ranks):
        inside = (tgt >= 0) & (tgt < logits.shape[-1])
        m = all_reduce_tensor(logits.amax(-1), ranks, "max")
        s = all_reduce_tensor(torch.exp(logits - m[..., None]).sum(-1),
                              ranks)
        lse = m + torch.log(s)
        t = torch.gather(logits, -1, torch.where(inside, tgt, 0)[..., None]
                         )[..., 0]
        t = all_reduce_tensor(torch.where(inside, t, 0.0), ranks)
        ctx.save_for_backward(logits, lse, tgt, inside)
        return lse - t

    @staticmethod
    def backward(ctx, g):
        logits, lse, tgt, inside = ctx.saved_tensors
        p = torch.exp(logits - lse[..., None])
        idx = torch.where(inside, tgt, 0)[..., None]
        p.scatter_add_(-1, idx, -inside.to(p.dtype)[..., None])
        return p * g[..., None], None, None


def next_token_nll(hn: torch.Tensor, w: torch.Tensor, tokens: torch.Tensor,
                   vocab: int) -> torch.Tensor:
    """Next-token NLL (rows, T-1) of normed hidden states (rows, T, d)
    through the head ``w`` (d, ``vocab``, or this rank's columns), the
    log-softmax in f32."""
    if _RANKS is None or w.shape[-1] == vocab:
        lp = torch.log_softmax((hn @ w)[:, :-1].to(torch.float32), -1)
        return -torch.gather(lp, -1, tokens[:, 1:].long()[..., None])[..., 0]
    lo, _ = chunk_of(vocab, w.shape[-1])
    logits = (copy(hn) @ w)[:, :-1].to(torch.float32)
    return _VocabNLL.apply(logits, tokens[:, 1:].long() - lo, _RANKS)


# --------------------------------------------------------------------------
# attention heads over the ranks
# --------------------------------------------------------------------------
class HeadShare(NamedTuple):
    """This rank's part of an attention block: the columns [lo, hi) of
    the flat (heads x head dim) query dim it holds (the rows of ``wo``),
    the query heads [h0, h1) those columns touch (more than the columns
    where they split a head), the kv heads [k0, k1) those read, and
    ``kv_index``, each query head's kv head less k0 where the GQA order of
    the local heads would pair them otherwise (else None)."""
    lo: int
    hi: int
    h0: int
    h1: int
    k0: int
    k1: int
    kv_index: Optional[List[int]]


def head_share(heads: int, kv_heads: int, head_dim: int, lo: int, hi: int
               ) -> HeadShare:
    h0, h1 = lo // head_dim, -(-hi // head_dim)
    grp = heads // kv_heads
    k0, k1 = h0 // grp, (h1 - 1) // grp + 1
    nq, nk = h1 - h0, k1 - k0
    want = [(h0 + j) // grp - k0 for j in range(nq)]
    natural = nq % nk == 0 and want == [j // (nq // nk) for j in range(nq)]
    return HeadShare(lo, hi, h0, h1, k0, k1, None if natural else want)


def project(x: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor],
            full: int) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """``x @ w (+ bias)`` on the columns of a flat ``full``-wide output
    this rank holds -> (y, (lo, hi)). A replicated ``w`` (or bias) feeds
    this rank's heads only, so its gradient is summed over the ranks."""
    lo, hi = chunk_of(full, w.shape[-1])
    if hi - lo == full:
        w = copy(w)
    y = x @ w
    if bias is not None:
        y = y + (copy(bias)[lo:hi] if bias.shape[-1] == full else bias)
    return y, (lo, hi)


def take_heads(y: torch.Tensor, cols: Tuple[int, int],
               heads: Tuple[int, int], head_dim: int) -> torch.Tensor:
    """Heads [a, b) as (..., b - a, head_dim) from ``y``, this rank's
    columns ``cols`` of a flat heads x head dim output; where the columns
    do not hold them whole, ``y`` is gathered first (GSPMD's resharding)."""
    (lo, hi), (a, b) = cols, heads
    if lo <= a * head_dim and b * head_dim <= hi:
        t = y[..., a * head_dim - lo:b * head_dim - lo]
    else:
        t = gather(y, -1, summed=True)[..., a * head_dim:b * head_dim]
    return t.reshape(tuple(y.shape[:-1]) + (b - a, head_dim))
