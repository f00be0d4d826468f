"""The collectives the port runs over a ``torch.distributed`` group: an
all-gather and a summing all-reduce of a whole tree, the same two on one
tensor (``all_gather_cat`` along a dim; ``all_reduce_tensor``, a sum or a
max, out of place), a reduce-scatter (``reduce_scatter_cat``: the sum
over the group of each rank's tensor, this rank's chunk of it along a
dim, summed in rank order), and ``Ranks``, the group with this process's
place in it.

NCCL takes CUDA tensors directly. Under gloo every tensor goes through
host memory: the choice is made once, from the group's backend
(``stages_on_host``), never by catching a failure (gloo's support for
CUDA tensors varies by release, and DTensor's gathers over gloo killed
both ranks on CUDA tensors with torch 2.11: ``tools/gloo_cuda_probe.py``).
NCCL cannot put two ranks on one card, so on one card NCCL gives world
size 1 and two processes there run on gloo.

The gather moves bytes (every leaf viewed as uint8 on the wire), so any
dtype arrives bit for bit; the sum is the backend's, the same bits on
every rank.

While a count is open (the dry run's, ``launch/flop_analysis.py``) each
leaf's collective is charged to it by kind and output bytes; on ``meta``
leaves nothing is sent (the gather returns empty meta tensors of its
output's shape), so a step's collectives are counted without a process
group.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.optim.optimizers import tree_map

PyTree = Any


class Ranks(NamedTuple):
    """A process group (None: the default one), this process's rank in
    it and its size."""
    group: Optional[Any]
    rank: int
    size: int

    @classmethod
    def of(cls, group=None) -> "Ranks":
        if not dist.is_initialized():
            raise RuntimeError("collectives need the default process group: "
                               "call torch.distributed.init_process_group")
        return cls(group, dist.get_rank(group), dist.get_world_size(group))

    def share(self, n: int) -> range:
        """This rank's contiguous share of ``n`` items, which ``size``
        must divide."""
        if n % self.size:
            raise ValueError(f"{n} items do not split over {self.size} ranks")
        per = n // self.size
        return range(self.rank * per, (self.rank + 1) * per)


def stages_on_host(group=None) -> bool:
    """Whether this group's collectives go through host memory (gloo)."""
    return dist.get_backend(group) == "gloo"


# the host-staged gather and reduce-scatter move a tensor in pieces of
# this many bytes, so the host holds a few pieces a rank, not the ranks'
# whole tensors (a gathered expert leaf is ~10 GB a rank at jamba's width,
# with four ranks of one card staging at once)
HOST_PIECE = 1 << 27


def _gather_bytes(x: torch.Tensor, ranks: Ranks) -> torch.Tensor:
    """(size, *x.shape) of every rank's ``x``, in rank order."""
    wire = x.detach().contiguous().reshape(-1).view(torch.uint8)
    if stages_on_host(ranks.group):
        out = torch.empty((ranks.size, wire.numel()), dtype=torch.uint8,
                          device=x.device)
        # host pieces made once a call and written again piece by piece
        n = min(wire.numel(), HOST_PIECE)
        send = torch.empty(n, dtype=torch.uint8)
        recv = torch.empty((ranks.size, n), dtype=torch.uint8)
        for lo in range(0, wire.numel(), HOST_PIECE):
            m = min(HOST_PIECE, wire.numel() - lo)
            send[:m].copy_(wire[lo:lo + m])
            dist.all_gather(list(recv[:, :m].unbind(0)), send[:m],
                            group=ranks.group)
            out[:, lo:lo + m] = recv[:, :m]
    else:
        out = torch.empty((ranks.size, wire.numel()), dtype=torch.uint8,
                          device=x.device)
        dist.all_gather_into_tensor(out, wire, group=ranks.group)
    return out.view(x.dtype).reshape((ranks.size,) + tuple(x.shape))


def _charge(kind: str, x: torch.Tensor) -> None:
    from repro_torch.launch import flop_analysis
    flop_analysis.charge_collective(kind, x.numel() * x.element_size())


def all_gather_tree(tree: PyTree, ranks: Ranks) -> PyTree:
    """Every leaf gathered from every rank: a new leading axis of
    ``ranks.size``, in rank order (every rank's leaf of the same shape and
    dtype), bit for bit."""
    def one(x: torch.Tensor) -> torch.Tensor:
        if x.is_meta:
            out = torch.empty((ranks.size,) + tuple(x.shape), dtype=x.dtype,
                              device="meta")
            _charge("all-gather", out)
            return out
        return _gather_bytes(x, ranks)
    return tree_map(one, tree)


def all_gather_cat(x: torch.Tensor, ranks: Ranks, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (each of the same shape), concatenated along
    ``dim`` in rank order, bit for bit."""
    parts = _gather_bytes(x, ranks)
    if dim % max(x.ndim, 1) == 0:             # the rank order is dim 0's
        return parts.reshape((-1,) + tuple(x.shape[1:]))
    return torch.cat(parts.unbind(0), dim)


def reduce_scatter_cat(x: torch.Tensor, ranks: Ranks,
                       dim: int) -> torch.Tensor:
    """The sum over the ranks of each rank's ``x`` (every rank's of the
    same shape), of which this rank keeps its chunk along ``dim`` (whose
    size the group must divide), in ``x``'s dtype: the inverse of
    ``all_gather_cat``'s split. Each chunk goes to its rank alone (one
    gather a chunk), which adds the ranks' parts in rank order, so the
    sum is the same bits on every run, whatever the backend. A meta
    ``x`` is charged as a "reduce-scatter" of its bytes and sends
    nothing."""
    dim = dim % x.ndim
    n = x.shape[dim]
    if n % ranks.size:
        raise ValueError(f"a dim of {n} does not split over {ranks.size} "
                         f"ranks")
    per = n // ranks.size
    if x.is_meta:
        _charge("reduce-scatter", x)
        return x.narrow(dim, 0, per).clone()
    # pieces of HOST_PIECE bytes, through buffers made once a call (on the
    # host under gloo)
    stage = "cpu" if stages_on_host(ranks.group) else x.device
    step = HOST_PIECE // x.element_size()
    n = min(x.numel() // ranks.size, step)
    send = torch.empty(n, dtype=x.dtype, device=stage)
    recv = torch.empty((ranks.size, n), dtype=x.dtype, device=stage)
    mine = None
    for r in range(ranks.size):
        flat = x.detach().narrow(dim, r * per, per).contiguous().reshape(-1)
        if r == ranks.rank:
            mine = torch.empty_like(flat)
        for lo in range(0, flat.numel(), step):
            m = min(step, flat.numel() - lo)
            send[:m].copy_(flat[lo:lo + m])
            into = (list(recv[:, :m].unbind(0)) if r == ranks.rank
                    else None)
            dist.gather(send[:m], into, dst=_global_rank(ranks, r),
                        group=ranks.group)
            if into is not None:
                acc = into[0].to(x.device, copy=True)
                for t in into[1:]:
                    acc += t.to(x.device)
                mine[lo:lo + m] = acc
    shape = list(x.shape)
    shape[dim] = per
    return mine.view(shape)


def _global_rank(ranks: Ranks, r: int) -> int:
    """The default group's rank of rank ``r`` of ``ranks``' group."""
    if ranks.group is None:
        return r
    return dist.get_global_rank(ranks.group, r)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce_tensor(x: torch.Tensor, ranks: Ranks,
                      op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``ranks`` ("sum" or "max") into a new tensor
    (``x`` is not written), the same bits on every rank."""
    if stages_on_host(ranks.group) and x.device.type != "cpu":
        out = x.detach().cpu().contiguous()
        dist.all_reduce(out, op=_OPS[op], group=ranks.group)
        return out.to(x.device)
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=ranks.group)
    return out


def all_reduce_sum_tree(tree: PyTree, ranks: Ranks) -> PyTree:
    """Every leaf summed over the ranks, in place; returns ``tree``."""
    def one(x: torch.Tensor):
        if x.is_meta:
            _charge("all-reduce", x)
            return x
        if stages_on_host(ranks.group) and x.device.type != "cpu":
            host = x.detach().cpu()
            dist.all_reduce(host, group=ranks.group)
            x.copy_(host)
        else:
            dist.all_reduce(x, group=ranks.group)
        return x
    with torch.no_grad():
        return tree_map(one, tree)
