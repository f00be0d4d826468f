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

Heads that do not divide the axis (rwkv6-3b's 40 over 16, deepseek's 128
MLA heads over 3): the plan splits a flat (heads x width) dim mid-head,
so a rank computes every head its columns touch, whole (``frac_heads``;
a boundary head on both ranks that share it), takes those heads'
columns of each leaf (``head_cols``: a shard that splits a head is
gathered) and passes on only its own columns (``frac_cols``), into
``wo``'s rows or a norm over every column.

With the sequence split (``over(ranks, seq=True)``: training's
``seq_shard_activations``, Megatron's sequence parallelism, Korthikanti
et al., 2022) the hidden states between blocks hold this rank's chunk of
the positions: ``seq_chunk`` takes it (at a run of stages' entry, and of
a block output computed whole), ``seq_whole`` gathers the positions (at
the exit), ``norm_in`` normalizes a block's input on the chunk and
gathers it for the block's work, ``row_product`` reduce-scatters a
block's output on the positions, ``exchange`` is the MoE's all-to-all
of slots to their experts' ranks and ``mean_over`` averages its
load-balance means over the ranks.

They go through ``core/collectives.py`` rather than DTensor's own
redistributions: on one card the ranks are gloo processes, and there
DTensor's gathers of CUDA tensors killed both ranks with torch 2.11
(``tools/gloo_cuda_probe.py``), where the collectives move the bytes by
device copies between the ranks' mailboxes (the same-card route).

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
                                          all_reduce_tensor, all_to_all,
                                          reduce_scatter_cat)

_RANKS: Optional[Ranks] = None
_SEQ = False


@contextmanager
def over(ranks: Optional[Ranks], seq: bool = False):
    """Run the layers on the model axis ``ranks`` (None: one rank);
    ``seq``: with the hidden states between blocks split on the sequence
    over the ranks (``seq_split``)."""
    global _RANKS, _SEQ
    prev = _RANKS, _SEQ
    _RANKS, _SEQ = ranks, seq and ranks is not None
    try:
        yield
    finally:
        _RANKS, _SEQ = prev


def active() -> Optional[Ranks]:
    """The model axis the layers run on (None outside ``over``)."""
    return _RANKS


def seq_split() -> bool:
    """Whether the hidden states between blocks hold this rank's chunk of
    the sequence (training's ``seq_shard_activations``)."""
    return _SEQ


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
    def forward(ctx, a, w, ranks, shared, scatter):
        ctx.ranks, ctx.shared, ctx.scatter = ranks, shared, scatter
        ctx.save_for_backward(a, w)
        shape = tuple(a.shape[:-1]) + (w.shape[-1],)
        y = _mm_f32(a.reshape(-1, a.shape[-1]), w)
        if scatter:                       # this rank's positions of the sum
            return reduce_scatter_cat(y.view(shape), ranks, 1).to(a.dtype)
        return all_reduce_tensor(y, ranks).to(a.dtype).view(shape)

    @staticmethod
    def backward(ctx, g):
        a, w = ctx.saved_tensors
        if ctx.scatter:
            g = all_gather_cat(g.contiguous(), ctx.ranks, 1)
        if ctx.shared:
            g = all_reduce_tensor(g, ctx.ranks)
        g2 = g.reshape(-1, g.shape[-1])
        ga = (g2 @ w.t()).view(a.shape) if ctx.needs_input_grad[0] else None
        gw = (a.reshape(-1, a.shape[-1]).t() @ g2
              if ctx.needs_input_grad[1] else None)
        return ga, gw, None, None, None


def row_product(a: torch.Tensor, w: torch.Tensor,
                shared: bool = False) -> torch.Tensor:
    """``reduce(a @ w)`` (``shared``: ``sum_over(a @ w)``) of this rank's
    columns of ``a`` and rows of ``w``, summed before its one rounding;
    ``a @ w`` outside a model axis. With the sequence split
    (``seq_split``) a block's output (not ``shared``: ``a`` (B, S, k),
    every position) is reduce-scattered on the sequence instead: this
    rank's positions of the sum (B, S/m, n), the gradient all-gathered
    back."""
    if _RANKS is None:
        return a @ w
    return _RowProduct.apply(a, w, _RANKS, shared, _SEQ and not shared)


def copy(x: torch.Tensor) -> torch.Tensor:
    return _Copy.apply(x, _RANKS)


def sum_over(x: torch.Tensor) -> torch.Tensor:
    return _SumOver.apply(x, _RANKS)


def reduce(x: torch.Tensor) -> torch.Tensor:
    return _Reduce.apply(x, _RANKS)


def gather(x: torch.Tensor, dim: int, summed: bool) -> torch.Tensor:
    return _Gather.apply(x, _RANKS, dim % x.ndim, summed)


# --------------------------------------------------------------------------
# the sequence over the ranks (Megatron's sequence parallelism, Korthikanti
# et al., 2022): training's ``seq_shard_activations``
# --------------------------------------------------------------------------
class _SeqChunk(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks):
        ctx.ranks = ranks
        per = x.shape[1] // ranks.size
        return x.narrow(1, ranks.rank * per, per).contiguous()

    @staticmethod
    def backward(ctx, g):
        return all_gather_cat(g.contiguous(), ctx.ranks, 1), None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks):
        ctx.n = ranks.size
        return all_reduce_tensor(x, ranks) / ranks.size

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def seq_chunk(x: torch.Tensor) -> torch.Tensor:
    """This rank's chunk of the positions (dim 1) of ``x``, which every
    rank holds whole and the same (its gradient the ranks' chunks'
    gathered); ``x`` itself unless the sequence is split."""
    if not _SEQ:
        return x
    if x.shape[1] % _RANKS.size:
        raise ValueError(f"{x.shape[1]} positions do not split over a "
                         f"model axis of {_RANKS.size}")
    return _SeqChunk.apply(x, _RANKS)


def seq_whole(x: torch.Tensor) -> torch.Tensor:
    """Every rank's chunk of the positions gathered (what follows runs the
    same on every rank: the gradient is this rank's chunk); ``x`` itself
    unless the sequence is split."""
    if not _SEQ:
        return x
    return gather(x, 1, summed=False)


def norm_in(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """A block's ``rms_norm(x, w)`` at its entry. With the sequence split
    the norm runs on this rank's positions (``w`` through ``copy``: each
    rank's gradient is its positions') and the result is gathered whole
    for the block's work, which then runs as it does on a model axis
    without the split, up to its row-parallel output (``row_product``
    reduce-scatters it) or ``seq_chunk``."""
    from repro_torch.models.layers import rms_norm
    if not _SEQ:
        return rms_norm(x, w, eps)
    return seq_whole(rms_norm(x, copy(w), eps))


def mean_over(x: torch.Tensor) -> torch.Tensor:
    """``x`` averaged over the ranks (each rank's gradient is its share
    of the mean's); ``x`` unless the sequence is split (every rank then
    computes it whole)."""
    if not _SEQ:
        return x
    return _MeanOver.apply(x, _RANKS)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ranks):
        ctx.ranks = ranks
        return all_to_all(x, ranks, 0)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), ctx.ranks, 0), None


def exchange(x: torch.Tensor) -> torch.Tensor:
    """``collectives.all_to_all`` on dim 0 over the model axis: rank r's
    i-th chunk to rank i, the gradient sent back the same way."""
    return _AllToAll.apply(x, _RANKS)


def frac_heads(n: int) -> Tuple[int, int]:
    """The heads [h0, h1) of ``n`` this rank computes whole: its even
    share where the axis divides them, else every head its fraction
    [r n / m, (r + 1) n / m) of them overlaps (a boundary head on both
    ranks that share it)."""
    m, r = _RANKS.size, _RANKS.rank
    return r * n // m, -(-(r + 1) * n // m)


def frac_cols(full: int, local: int) -> Tuple[int, int]:
    """The columns [lo, hi) of a flat (heads x width) dim of ``full``
    entries that this rank passes on from its ``frac_heads`` (into a
    row-parallel product, a norm over every column): its shard's where a
    leaf of ``local`` entries splits the dim, else its fraction
    [r full / m, (r + 1) full / m) rounded down; the ranks' columns
    partition the dim, and each lies in the rank's heads."""
    if local != full:
        return chunk_of(full, local)
    m, r = _RANKS.size, _RANKS.rank
    return r * full // m, (r + 1) * full // m


def head_cols(w: torch.Tensor, full: int, h0: int, h1: int, width: int,
              dim: int = -1) -> torch.Tensor:
    """Whole heads [h0, h1) of a leaf whose dim ``dim`` is a flat (heads x
    ``width``) dim of ``full`` entries: the slice of a replicated leaf
    (``part``), this rank's shard where it holds exactly those heads, else
    the shard gathered over the ranks (each boundary head's missing
    columns from the neighbour; the gradient summed over the ranks, then
    this rank's columns kept). Every rank takes the same branch: a shard
    holds whole heads on every rank or, where the heads do not divide
    the axis, on none."""
    lo, hi = h0 * width, h1 * width
    n = w.shape[dim]
    if n == full or chunk_of(full, n) == (lo, hi):
        return part(w, full, lo, hi, dim)
    return gather(w, dim, summed=True).narrow(dim, lo, hi - lo)


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
