"""A step's FLOPs, HBM bytes, transcendentals and collectives, counted by
running it on ``meta`` tensors: the counterpart of
``repro.launch.hlo_analysis``, which reads the same numbers from a
compiled module's HLO text. The port has no HLO, so ``count`` runs the
step under a ``TorchDispatchMode`` that sees every aten op (autograd's
backward and a checkpointed layer's recompute included) and adds up:

  * flops — ``torch.utils.flop_counter``'s rules: 2 M N K for every
    matmul, the same for every convolution's products (the rule
    ``hlo_analysis._dot_flops`` and ``_conv_flops`` use); element-wise
    ops count none, as in the reference;
  * bytes — each op's input and output bytes. Views and metadata ops are
    free, like ``hlo_analysis._FREE_OPS``, and so are allocations that
    write nothing (``empty``). A gather (``index``, ``index_select``,
    ``embedding``: an embedding lookup) reads its indices and the elements
    it gathers, not the whole tensor it gathers from; an in-place scatter
    (``index_put_``, a decode step's cache write, and the like) moves its
    indices and the elements it writes, not the whole tensor it writes
    into. Eager code
    has no fusion, so the
    reference's rule of counting a fusion at its boundary only has no
    counterpart: every op here reads its inputs and writes its output;
  * transcendentals — the elements through exp, log, tanh, rsqrt, sqrt,
    pow, sigmoid, silu, gelu, sin, cos, erf and softmax;
  * collectives — bytes (the output's, as the reference counts them; a
    reduce-scatter's input) and counts by kind, charged by every
    collective of ``core/collectives.py`` while a count is open.

The hand-written kernels run no aten op the mode could see, and cannot
run on the meta device: where a wrapper of ``kernels/ops.py`` meets a
meta tensor it returns empty outputs of its kernel's shapes and charges
``kernels/cost.py``'s count of that launch (``charge_kernel``), never its
plain version (whose algorithm differs: the plain attention forms the S x
S scores). A loop whose trip count the data decides (the early-exit Lloyd
loop) runs one sweep on the meta device and bumps ``unknown_trips``
(``note_unknown_trip``): the count is then a lower bound.

The numbers are per process: one rank's share of a step that runs over
ranks, the replicated parts whole.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# allocations that write nothing
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "_local_scalar_dense"}
# in-place scatters: they touch only the elements their source holds
_SCATTER = {"index_put_", "_index_put_impl_", "index_copy_", "scatter_",
            "scatter_add_", "scatter_reduce_", "index_add_"}
# gathers: they read only the elements they return
_GATHER = {"index", "index_select", "embedding", "gather"}
_TRANSCENDENTAL = {
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log1p", "log2", "log10",
    "tanh", "tanh_", "rsqrt", "rsqrt_", "sqrt", "sqrt_", "pow", "pow_",
    "sigmoid", "sigmoid_", "silu", "silu_", "silu_backward", "gelu",
    "gelu_backward", "sin", "cos", "erf", "_softmax", "_log_softmax",
    "_log_softmax_backward_data", "softplus", "log_sigmoid_forward",
    "logit", "elu", "mish"}


@dataclass
class StepCost:
    """A counted step: ``hlo_analysis.HloCost``'s fields, with the hand
    kernels' share beside them (by wrapper name: flops, bytes and
    launches)."""
    flops: float = 0.0
    bytes: float = 0.0
    transcendentals: float = 0.0
    coll_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    coll_count: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    unknown_trips: int = 0
    kernel_flops: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    kernel_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))
    kernel_launches: Dict[str, int] = field(
        default_factory=lambda: defaultdict(int))
    op_bytes: Dict[str, float] = field(
        default_factory=lambda: defaultdict(float))

    @property
    def collective_total(self) -> float:
        """Bytes of every collective together."""
        return sum(self.coll_bytes.values())

    def as_dict(self) -> dict:
        """``HloCost.as_dict``'s keys, and the kernels' share."""
        return {"flops": self.flops, "bytes": self.bytes,
                "transcendentals": self.transcendentals,
                "collective_bytes": self.collective_total,
                "coll_bytes_by_kind": dict(self.coll_bytes),
                "coll_count_by_kind": dict(self.coll_count),
                "unknown_trip_counts": self.unknown_trips,
                "kernel_flops": dict(self.kernel_flops),
                "kernel_bytes": dict(self.kernel_bytes),
                "kernel_launches": dict(self.kernel_launches)}


def nbytes(x: Any) -> int:
    """Bytes of the tensors in ``x`` (a tensor, or dicts, lists and tuples
    holding them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(nbytes(v) for v in x)
    if isinstance(x, dict):
        return sum(nbytes(v) for v in x.values())
    return 0


def _numel(x: Any) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel()
    if isinstance(x, (list, tuple)):
        return sum(_numel(v) for v in x)
    return 0


def _is_view(func) -> bool:
    """An op whose outputs alias its inputs without writing them (a view,
    a reshape that did not copy, a detach)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


class _Counter(TorchDispatchMode):
    def __init__(self, cost: StepCost):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        if name in _FREE or _is_view(func):
            return out
        c = self.cost
        if packet in flop_registry:
            c.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if name in _SCATTER:
            # the indices and source read, the source's elements written
            src = args[-1] if isinstance(args[-1], torch.Tensor) else \
                kwargs.get("src", kwargs.get("source"))
            nb = nbytes(args[1:]) + nbytes(kwargs) + nbytes(src)
        elif name in _GATHER:
            # the indices and the gathered elements read, the output
            # written
            nb = nbytes(args[1:]) + nbytes(kwargs) + 2 * nbytes(out)
        else:
            nb = nbytes(args) + nbytes(kwargs) + nbytes(out)
        c.bytes += nb
        c.op_bytes[name] += nb
        if name in _TRANSCENDENTAL:
            c.transcendentals += _numel(out)
        return out


_OPEN: List[StepCost] = []


def is_counting() -> bool:
    """Whether a count is open (the code running is a meta run)."""
    return bool(_OPEN)


@contextlib.contextmanager
def counting() -> Iterator[StepCost]:
    """Count every aten op, kernel charge and collective run inside the
    block into the ``StepCost`` it yields."""
    cost = StepCost()
    _OPEN.append(cost)
    try:
        with _Counter(cost):
            yield cost
    finally:
        _OPEN.pop()


def charge_kernel(name: str, kc) -> None:
    """Charge one launch of the kernel wrapper ``name`` (its
    ``kernels/cost.KernelCost``) to the open count, if any."""
    if not _OPEN:
        return
    c = _OPEN[-1]
    c.flops += kc.flops
    c.bytes += kc.hbm_bytes
    c.transcendentals += kc.transcendentals
    c.kernel_flops[name] += kc.flops
    c.kernel_bytes[name] += kc.hbm_bytes
    c.kernel_launches[name] += 1


def charge_collective(kind: str, nbytes: float) -> None:
    """Charge one collective of ``kind`` ("all-gather", "all-reduce",
    "reduce-scatter", "all-to-all") of ``nbytes`` to the open count, if
    any."""
    if _OPEN:
        _OPEN[-1].coll_bytes[kind] += nbytes
        _OPEN[-1].coll_count[kind] += 1


def note_unknown_trip() -> None:
    """A loop whose trip count the data decides ran one pass: the open
    count is a lower bound."""
    if _OPEN:
        _OPEN[-1].unknown_trips += 1


def to_meta(x: Any) -> Any:
    """``x`` with every tensor replaced by an empty meta tensor of its
    shape, dtype and strides (dicts, lists and tuples walked)."""
    if isinstance(x, torch.Tensor):
        m = torch.empty_strided(tuple(x.shape), tuple(x.stride()),
                                dtype=x.dtype, device="meta")
        return m.requires_grad_(x.requires_grad) if x.is_floating_point() \
            else m
    if isinstance(x, dict):
        return {k: to_meta(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_meta(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_meta(v) for v in x)
    return x


def count(fn: Callable, *args: Any, **kwargs: Any) -> Tuple[StepCost, Any]:
    """Run ``fn`` on meta copies of its tensor arguments under a count ->
    (its ``StepCost``, its meta outputs). Nothing is allocated and nothing
    runs on a device."""
    margs, mkwargs = to_meta(args), to_meta(kwargs)
    with counting() as cost:
        out = fn(*margs, **mkwargs)
    return cost, out
