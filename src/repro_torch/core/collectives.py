"""The collectives the port runs over a ``torch.distributed`` group: an
all-gather and a summing all-reduce of a whole tree, the same two on one
tensor (``all_gather_cat`` along a dim; ``all_reduce_tensor``, a sum or a
max, out of place), a reduce-scatter (``reduce_scatter_cat``: the sum
over the group of each rank's tensor, this rank's chunk of it along a
dim, summed in rank order), an all-to-all (``all_to_all``: rank r's i-th
chunk along a dim goes to rank i), and ``Ranks``, the group with this
process's place in it.

Three routes, chosen once a group from what it is, never by catching a
failure:

* NCCL takes CUDA tensors directly.
* The same card (``same_card``): a gloo group whose ranks all hold their
  CUDA tensors on one card (NCCL cannot put two ranks on one card, so on
  one card NCCL gives world size 1 and the ranks run on gloo). The ranks
  find this out the first time the group moves a CUDA tensor: each sends
  its card's UUID and index over gloo (``all_gather_object``). Each rank
  then makes its "mailbox", a device buffer of two ``CARD_PIECE`` halves
  that lives as long as the process, and shares it with the others by
  CUDA IPC (``torch.multiprocessing.reductions.reduce_tensor``, the
  handles over gloo; a rank opens only the others' handles). A piece then
  moves by device copies: each rank writes it into its half of the turn,
  synchronizes its stream, meets the others at a gloo barrier and reads
  what it needs from the others' mailboxes (a sum or a max in rank
  order). The halves take turns, so the barrier of the next piece is
  also the proof that every rank has read the last one.
* Otherwise gloo moves every tensor through host memory in pieces of
  ``HOST_PIECE`` bytes (gloo's support for CUDA tensors varies by
  release, and DTensor's gathers over gloo killed both ranks on CUDA
  tensors with torch 2.11: ``tools/gloo_cuda_probe.py``). A CPU tensor
  takes this route on any gloo group.

The gathers and the all-to-all move bytes (every tensor viewed as uint8),
so any dtype arrives bit for bit, the same bits on every route. The
reduce-scatter adds the ranks' parts in rank order on every route; the
same card's all-reduce too (gloo's and NCCL's sum in their own order);
every rank gets the same bits.

Every call is tallied by kind ("all-gather", "all-reduce",
"reduce-scatter", "all-to-all") on every route, a leaf of a tree a call
(``calls``: the count and the bytes: the gathers' output, the
all-reduce's and the all-to-all's tensor, the reduce-scatter's input),
and charged to an open count (the dry run's, ``launch/flop_analysis.py``)
at the same bytes. A meta tensor sends nothing: its collective returns
an empty meta tensor of its output's shape, so a step's collectives are
counted without a process group, by a ``Ranks`` with no group that only
names this rank's place.
"""
from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, NamedTuple, Optional

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


# the host-staged collectives move a tensor in pieces of this many bytes,
# so the host holds a few pieces a rank, not the ranks' whole tensors (a
# gathered expert leaf is ~10 GB a rank at jamba's width, with four ranks
# of one card staging at once)
HOST_PIECE = 1 << 27
# a same-card mailbox holds two pieces of this many bytes: 64 MiB a rank
# a group, as four ranks of phase 18's FSDP items peak at 18.8 GB each on
# the 80 GB card (``chip_smoke.py``; ``PERF.md`` §5)
CARD_PIECE = 1 << 25


# --------------------------------------------------------------------------
# the same-card route
# --------------------------------------------------------------------------
class Mailbox:
    """A group's mailboxes on one card: this rank's buffer (2, CARD_PIECE)
    uint8, every rank's (this one's among them) in rank order, and the
    half the next piece takes."""

    def __init__(self, mine: torch.Tensor, boxes: List[torch.Tensor]):
        self.mine, self.boxes, self.turn = mine, boxes, 0

    def exchange(self, ranks: Ranks, write: Callable[[torch.Tensor], None],
                 read: Callable[[List[torch.Tensor]], None]) -> None:
        """One piece: ``write`` fills this rank's half (a uint8 tensor of
        CARD_PIECE bytes), then, once every rank has written, ``read``
        gets every rank's half in rank order."""
        half, self.turn = self.turn, self.turn ^ 1
        write(self.mine[half])
        torch.cuda.current_stream(self.mine.device).synchronize()
        dist.barrier(group=ranks.group)
        read([b[half] for b in self.boxes])


# (group, card index) -> its Mailbox, or None where the group's ranks are
# not all on that card; kept while the process lives (a rank's mailbox
# must outlive every other rank's reads of it)
_MAILBOXES: Dict[Any, Optional[Mailbox]] = {}
# what the same-card route has moved since the last reset: pieces and the
# bytes this rank wrote into its mailbox
moved = {"pieces": 0, "bytes": 0}


def _expandable() -> bool:
    conf = ",".join(os.environ.get(k, "") for k in
                    ("PYTORCH_CUDA_ALLOC_CONF", "PYTORCH_ALLOC_CONF"))
    return "expandable_segments:True" in conf.replace(" ", "")


def _shareable_empty(nbytes: int, device: torch.device) -> torch.Tensor:
    """A uint8 device buffer that CUDA IPC can share: memory from the
    allocator's expandable segments cannot be exported through the legacy
    IPC handles, so the buffer is made with them off."""
    from torch.cuda import memory
    if not _expandable():
        return torch.empty(nbytes, dtype=torch.uint8, device=device)
    memory._set_allocator_settings("expandable_segments:False")
    try:
        return torch.empty(nbytes, dtype=torch.uint8, device=device)
    finally:
        memory._set_allocator_settings("expandable_segments:True")


def _open_mailbox(device: torch.device, ranks: Ranks) -> Optional[Mailbox]:
    """The group's mailboxes on ``device`` where every rank's tensors
    are on that card (the ranks' UUIDs and indices equal), else None."""
    from torch.multiprocessing.reductions import reduce_tensor
    props = torch.cuda.get_device_properties(device)
    where = [None] * ranks.size
    dist.all_gather_object(where, (str(props.uuid), device.index),
                           group=ranks.group)
    if len(set(where)) != 1:
        return None
    mine = _shareable_empty(2 * CARD_PIECE, device).view(2, CARD_PIECE)
    rebuild, args = reduce_tensor(mine)
    handles = [None] * ranks.size
    dist.all_gather_object(handles, args, group=ranks.group)
    boxes = [mine if r == ranks.rank else rebuild(*handles[r])
             for r in range(ranks.size)]
    return Mailbox(mine, boxes)


def same_card(x: torch.Tensor, ranks: Ranks) -> Optional[Mailbox]:
    """The group's mailboxes where ``x`` lies on a card that every rank of
    this gloo group holds its tensors on (checked the first time the
    group moves a tensor of that card); None for a CPU tensor, another
    backend or ranks on other cards."""
    if x.device.type != "cuda" or not stages_on_host(ranks.group):
        return None
    key = (ranks.group if ranks.group is not None else dist.group.WORLD,
           x.device.index)
    if key not in _MAILBOXES:
        _MAILBOXES[key] = _open_mailbox(x.device, ranks)
    return _MAILBOXES[key]


def close_mailboxes() -> None:
    """Before the process group goes: each rank closes the other ranks'
    mailboxes, then meets them at each group's barrier, so that no rank
    frees its own (or exits) while another still maps it. Every rank of
    the world calls it (the groups' mailboxes were opened by all their
    ranks in one order, and close in it)."""
    opened = [(key[0], box) for key, box in _MAILBOXES.items()
              if box is not None]
    for _, box in opened:
        box.boxes = [box.mine]
    if opened:
        torch.cuda.synchronize()
    for group, _ in opened:
        dist.barrier(group=group)
    _MAILBOXES.clear()


def _count(nbytes: int) -> None:
    moved["pieces"] += 1
    moved["bytes"] += nbytes


def _pieces_on_card(box: Mailbox, ranks: Ranks, wire: torch.Tensor,
                    take: Callable[[int, int, List[torch.Tensor]], None]
                    ) -> None:
    """This rank's bytes ``wire`` (n,) through the mailboxes in pieces of
    ``CARD_PIECE``: ``take(lo, m, got)`` gets every rank's bytes [lo, lo +
    m) (views of the mailboxes) in rank order."""
    for lo in range(0, wire.numel(), CARD_PIECE):
        m = min(CARD_PIECE, wire.numel() - lo)
        box.exchange(ranks,
                     lambda buf, lo=lo, m=m: buf[:m].copy_(wire[lo:lo + m]),
                     lambda bufs, lo=lo, m=m: take(lo, m,
                                                   [b[:m] for b in bufs]))
        _count(m)


# --------------------------------------------------------------------------
# gathers
# --------------------------------------------------------------------------
def _gather_bytes(x: torch.Tensor, ranks: Ranks) -> torch.Tensor:
    """(size, *x.shape) of every rank's ``x``, in rank order."""
    if x.is_meta:
        return torch.empty((ranks.size,) + tuple(x.shape), dtype=x.dtype,
                           device="meta")
    wire = x.detach().contiguous().reshape(-1).view(torch.uint8)
    out = torch.empty((ranks.size, wire.numel()), dtype=torch.uint8,
                      device=x.device)
    box = same_card(x, ranks)
    if box is not None:
        def take(lo, m, got):
            for r, b in enumerate(got):
                out[r, lo:lo + m].copy_(b)
        _pieces_on_card(box, ranks, wire, take)
    elif stages_on_host(ranks.group):
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
        dist.all_gather_into_tensor(out, wire, group=ranks.group)
    return out.view(x.dtype).reshape((ranks.size,) + tuple(x.shape))


# collectives called since the last ``calls.clear()``: kind -> [calls,
# bytes]
calls: Dict[str, List[int]] = {}


def _charge(kind: str, x: torch.Tensor) -> None:
    """Tally one collective of ``kind`` by the bytes of ``x`` (see the
    module's docstring), and charge it to an open count."""
    from repro_torch.launch import flop_analysis
    nbytes = x.numel() * x.element_size()
    tally = calls.setdefault(kind, [0, 0])
    tally[0] += 1
    tally[1] += nbytes
    flop_analysis.charge_collective(kind, nbytes)


def all_gather_tree(tree: PyTree, ranks: Ranks) -> PyTree:
    """Every leaf gathered from every rank: a new leading axis of
    ``ranks.size``, in rank order (every rank's leaf of the same shape and
    dtype), bit for bit."""
    def one(x: torch.Tensor) -> torch.Tensor:
        out = _gather_bytes(x, ranks)
        _charge("all-gather", out)
        return out
    return tree_map(one, tree)


def all_gather_cat(x: torch.Tensor, ranks: Ranks, dim: int) -> torch.Tensor:
    """Every rank's ``x`` (each of the same shape), concatenated along
    ``dim`` in rank order, bit for bit."""
    parts = _gather_bytes(x, ranks)
    _charge("all-gather", parts)
    if dim % max(x.ndim, 1) == 0:             # the rank order is dim 0's
        return parts.reshape((-1,) + tuple(x.shape[1:]))
    return torch.cat(parts.unbind(0), dim)


# --------------------------------------------------------------------------
# a rank's chunk of every rank's tensor: reduce-scatter and all-to-all
# --------------------------------------------------------------------------
def _chunks(x: torch.Tensor, ranks: Ranks, dim: int) -> torch.Tensor:
    """``x``'s ``size`` chunks along ``dim`` (whose size the group must
    divide) as rows: (size, numel / size), contiguous."""
    n = x.shape[dim]
    if n % ranks.size:
        raise ValueError(f"a dim of {n} does not split over {ranks.size} "
                         f"ranks")
    return (x.detach().unflatten(dim, (ranks.size, n // ranks.size))
            .movedim(dim, 0).reshape(ranks.size, -1))


def _on_card(box: Mailbox, rows: torch.Tensor, ranks: Ranks,
             take: Callable[[int, int, List[torch.Tensor]], None]) -> None:
    """Each rank's ``rows`` (size, c), row i for rank i, through the
    mailboxes in pieces of c, one exchange a piece: ``take(lo, m, got)``
    gets, for each piece [lo, lo + m), views of the ``size`` parts (m,)
    that the ranks sent this rank, in rank order."""
    size, c = rows.shape
    es, me = rows.element_size(), ranks.rank
    step = max(CARD_PIECE // (es * size), 1)
    for lo in range(0, c, step):
        m = min(step, c - lo)

        def part(buf, m=m):
            return buf[:size * m * es].view(rows.dtype).view(size, m)
        box.exchange(ranks,
                     lambda buf, lo=lo, m=m: part(buf).copy_(
                         rows[:, lo:lo + m]),
                     lambda bufs, lo=lo, m=m: take(
                         lo, m, [part(b)[me] for b in bufs]))
        _count(size * m * es)


def reduce_scatter_cat(x: torch.Tensor, ranks: Ranks,
                       dim: int) -> torch.Tensor:
    """The sum over the ranks of each rank's ``x`` (every rank's of the
    same shape), of which this rank keeps its chunk along ``dim`` (whose
    size the group must divide), in ``x``'s dtype: the inverse of
    ``all_gather_cat``'s split. A rank adds the parts it gets in rank
    order, so the sum is the same bits on every run and every route. On
    the same card each piece is one exchange in which every rank sends
    each rank its chunk's part; through host memory each chunk goes to
    its rank alone (one gather a chunk a piece). A meta ``x`` is charged
    as a "reduce-scatter" of its bytes and sends nothing."""
    dim = dim % x.ndim
    n = x.shape[dim]
    if n % ranks.size:
        raise ValueError(f"a dim of {n} does not split over {ranks.size} "
                         f"ranks")
    per = n // ranks.size
    _charge("reduce-scatter", x)
    if x.is_meta:
        return x.narrow(dim, 0, per).clone()
    shape = list(x.shape)
    shape[dim] = per
    box = same_card(x, ranks)
    if box is not None:
        rows = _chunks(x, ranks, dim)
        mine = torch.empty(rows.shape[1], dtype=x.dtype, device=x.device)

        def take(lo, m, got):
            acc = mine[lo:lo + m]
            acc.copy_(got[0])
            for t in got[1:]:
                acc += t
        _on_card(box, rows, ranks, take)
        return mine.view(shape)
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
    return mine.view(shape)


def all_to_all(x: torch.Tensor, ranks: Ranks, dim: int = 0) -> torch.Tensor:
    """Rank r's i-th chunk of ``x`` along ``dim`` (whose size the group
    must divide) goes to rank i: -> the chunks this rank got, concatenated
    along ``dim`` in rank order (every rank's ``x`` of the same shape and
    dtype), bit for bit, the bytes in pieces of ``HOST_PIECE`` (through
    host memory under gloo). Its own inverse. A meta ``x`` is charged as
    an "all-to-all" of its bytes and sends nothing."""
    dim = dim % x.ndim
    _charge("all-to-all", x)
    if x.is_meta:
        return torch.empty_like(x)
    wire = _chunks(x, ranks, dim).view(torch.uint8)
    size, c = wire.shape
    out = torch.empty_like(wire)
    box = same_card(x, ranks)
    if box is not None:
        def take(lo, m, got):
            for j, t in enumerate(got):
                out[j, lo:lo + m].copy_(t)
        _on_card(box, wire, ranks, take)
    elif stages_on_host(ranks.group):
        step = max(HOST_PIECE // size, 1)
        for lo in range(0, c, step):
            m = min(step, c - lo)
            send = wire[:, lo:lo + m].to("cpu", copy=True).contiguous()
            got = torch.empty_like(send)
            dist.all_to_all_single(got, send, group=ranks.group)
            out[:, lo:lo + m].copy_(got)
    else:
        dist.all_to_all_single(out, wire, group=ranks.group)
    n = x.shape[dim]
    shape = ((size,) + tuple(x.shape[:dim]) + (n // size,)
             + tuple(x.shape[dim + 1:]))
    return out.view(x.dtype).view(shape).movedim(0, dim).flatten(dim,
                                                                 dim + 1)


def _global_rank(ranks: Ranks, r: int) -> int:
    """The default group's rank of rank ``r`` of ``ranks``' group."""
    if ranks.group is None:
        return r
    return dist.get_global_rank(ranks.group, r)


# --------------------------------------------------------------------------
# all-reduce
# --------------------------------------------------------------------------
_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _reduce_on_card(box: Mailbox, x: torch.Tensor, out: torch.Tensor,
                    ranks: Ranks, op: str) -> None:
    """``out`` (contiguous, ``x``'s shape; it may be ``x``) <- ``x``
    reduced over the ranks through the mailboxes, in rank order (a piece
    of ``CARD_PIECE`` bytes holds whole elements)."""
    dst = out.view(-1).view(torch.uint8)

    def take(lo, m, got):
        acc = dst[lo:lo + m].view(x.dtype)
        acc.copy_(got[0].view(x.dtype))
        for b in got[1:]:
            if op == "sum":
                acc += b.view(x.dtype)
            else:
                torch.maximum(acc, b.view(x.dtype), out=acc)
    _pieces_on_card(box, ranks,
                    x.detach().contiguous().reshape(-1).view(torch.uint8),
                    take)


def all_reduce_tensor(x: torch.Tensor, ranks: Ranks,
                      op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``ranks`` ("sum" or "max") into a new tensor
    (``x`` is not written), the same bits on every rank."""
    _charge("all-reduce", x)
    return _all_reduce(x, ranks, op)


def _all_reduce(x: torch.Tensor, ranks: Ranks, op: str) -> torch.Tensor:
    if x.is_meta:
        return torch.empty_like(x)
    box = same_card(x, ranks)
    if box is not None:
        out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        _reduce_on_card(box, x, out, ranks, op)
        return out
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
        _charge("all-reduce", x)
        if x.is_meta:
            return x
        box = same_card(x, ranks)
        if box is not None:
            if x.is_contiguous():
                _reduce_on_card(box, x, x, ranks, "sum")
            else:
                x.copy_(_all_reduce(x, ranks, "sum"))
        elif stages_on_host(ranks.group) and x.device.type != "cpu":
            host = x.detach().cpu()
            dist.all_reduce(host, group=ranks.group)
            x.copy_(host)
        else:
            dist.all_reduce(x, group=ranks.group)
        return x
    with torch.no_grad():
        return tree_map(one, tree)
