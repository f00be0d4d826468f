"""FedAvg (McMahan et al.) — the paper's Eq. (2) and LocalUpdate (§3.2),
over the port's parameters (the counterpart of ``repro.core.fedavg``):
``weight_average`` over flat dicts or trees, its stacked form
``weight_average_stacked`` with ``broadcast_to_clients``, ``RunningSum``
(Eq. 2 over a cohort axis one trained tree at a time), ``client_drift``,
``local_update_tree`` (the
reference's ``local_update``: an ``Optimizer`` and its state over a tree,
the LM path's) and, for the WRN's flat dicts, the engines below.

LocalUpdate has two engines, picked by the device of the client's data:
on the CPU the eager loop of SGD steps (``local_update``); on a CUDA
device one SGD step captured as a CUDA graph (``CapturedStep``) and
replayed once a step, the port's counterpart of the reference's one
compiled ``lax.scan`` per client. Both run the same ops on the same
inputs; only the host's part differs. The graphs belong to their caller:
a ``CapturedSteps`` holds them for one owner (an FL run, a round) and
frees them, with their memory, when the owner releases it.

Under a tracer a capture is the LocalUpdate's compile: ``CapturedSteps``
reports each new capture to the recompile sentinel as
``compile.local_update_stack`` (the reference's profiled name), and each
replayed LocalUpdate adds its FLOPs and bytes (one SGD step counted on
meta tensors, times the steps) to the open span.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.obs.profile import (CostRecord, charge_span,
                                     compile_sentinel)
from repro_torch.obs.tracer import get_tracer
from repro_torch.optim.optimizers import (Optimizer, sgd_step, tree_leaves,
                                          tree_map, value_and_grad)

Params = Dict[str, torch.Tensor]
PyTree = Any
LossFn = Callable[[Params, torch.Tensor, torch.Tensor], torch.Tensor]


def weight_average(client_params: Sequence[PyTree],
                   weights: Optional[Sequence[float]] = None) -> PyTree:
    """Eq. 2: W_G(t) = (1/m) sum_k W_Ck(t), the same left-to-right sum as
    the reference, leaf by leaf of flat dicts or trees; ``weights``
    (normalized here) weigh the clients, a 0 leaving one out."""
    m = len(client_params)
    if weights is None:
        w = [1.0 / m] * m
    else:
        tot = float(sum(weights))
        w = [float(x) / tot for x in weights]
    with torch.no_grad():
        return tree_map(lambda *xs: sum(wi * x for wi, x in zip(w, xs)),
                        *client_params)


def weight_average_stacked(stacked: PyTree, axis: int = 0) -> PyTree:
    """Eq. 2 over a stacked client axis: the mean of every leaf along
    ``axis``."""
    with torch.no_grad():
        return tree_map(lambda x: torch.mean(x, dim=axis), stacked)


def broadcast_to_clients(params: PyTree, num_clients: int) -> PyTree:
    """Every leaf with a leading client axis of ``num_clients`` (a view:
    every client reads the same storage)."""
    return tree_map(lambda x: x[None].expand((num_clients,)
                                             + tuple(x.shape)), params)


class RunningSum:
    """Eq. 2 over a cohort axis, one trained tree at a time: ``add`` sums
    a cohort's tree into one accumulator as soon as the cohort is done, so
    the caller drops the tree and the memory does not grow with the
    number of cohorts. ``all_reduce`` sums the accumulators of the ranks
    that ran the other cohorts; ``mean(count)`` is Eq. 2's average.

    With ``base`` (the round's starting weights) the sum is of the
    bf16-rounded deltas ``(new - base)`` accumulated in f32, rounded to
    bf16 once at the end, divided by the count there and added back to
    ``base`` in its dtype: the reference's ``fedavg_compress="bf16"``.
    Without it, the trees themselves are summed in their dtype."""

    def __init__(self, base: Optional[PyTree] = None):
        self.base = base
        self.total: Optional[PyTree] = None

    def add(self, tree: PyTree) -> None:
        with torch.no_grad():
            if self.base is not None:
                term = tree_map(lambda n, b: (n - b).to(torch.bfloat16)
                                .to(torch.float32), tree, self.base)
            elif self.total is None:
                term = tree_map(torch.clone, tree)
            else:
                term = tree
            if self.total is None:
                self.total = term
            else:
                tree_map(lambda acc, x: acc.add_(x), self.total, term)

    def all_reduce(self, ranks) -> None:
        """Sum the accumulators over ``ranks`` (a ``collectives.Ranks``),
        the same bits on every rank."""
        from repro_torch.core.collectives import all_reduce_sum_tree
        all_reduce_sum_tree(self.total, ranks)

    def mean(self, count: int) -> PyTree:
        """The average of ``count`` trees from the sum."""
        with torch.no_grad():
            if self.base is None:
                return tree_map(lambda s: s / count, self.total)
            return tree_map(lambda b, s: b + (s.to(torch.bfloat16)
                                              / count).to(b.dtype),
                            self.base, self.total)


def client_drift(client_params: Sequence[PyTree],
                 global_params: PyTree) -> torch.Tensor:
    """Diagnostic: the mean over clients of the L2 distance (in f32) of a
    client's weights from the global model's; it grows with non-IID
    skew."""
    def dist(cp):
        return torch.sqrt(sum(
            torch.sum((a - b).to(torch.float32) ** 2)
            for a, b in zip(tree_leaves(cp), tree_leaves(global_params))))
    with torch.no_grad():
        return torch.stack([dist(cp) for cp in client_params]).mean()


def local_update_tree(params: PyTree, opt: Optimizer, opt_state: PyTree,
                      batches: Sequence[Any],
                      loss_fn: Callable[[PyTree, Any], torch.Tensor]):
    """§3.2 LocalUpdate over a tree (the reference's ``local_update``):
    one ``opt`` step a batch of ``batches`` (a sequence, the reference's
    scanned leading axis), eagerly on the params' device. Returns
    (params, opt_state, losses (steps,))."""
    losses = []
    for batch in batches:
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = opt.apply(grads, opt_state, params)
        losses.append(loss)
    return params, opt_state, (torch.stack(losses) if losses
                               else torch.zeros(0))


def local_update(params: Params, lr: float, batches_x: torch.Tensor,
                 batches_y: torch.Tensor, loss_fn: LossFn):
    """§3.2 LocalUpdate, eagerly: SGD steps over pre-batched local data
    ``batches_x`` (steps, bs, ...) / ``batches_y`` (steps, bs).
    Returns (params, losses (steps,))."""
    losses = []
    for bx, by in zip(batches_x, batches_y):
        loss, grads = value_and_grad(loss_fn, params, bx, by)
        params = sgd_step(params, grads, lr)
        losses.append(loss)
    return params, torch.stack(losses) if losses else torch.zeros(0)


def client_update(params: Params, lr: float, x: torch.Tensor,
                  y: torch.Tensor, order: torch.Tensor, loss_fn: LossFn,
                  steps: Optional["CapturedSteps"] = None):
    """§3.2 LocalUpdate of one client: one SGD step a row of ``order``
    (steps, bs), on the batch ``x[order[i]], y[order[i]]``. On the CPU the
    eager loop; on a CUDA device the captured step, replayed once a step
    (it raises where capture fails; nothing falls back to the eager loop):
    the one ``steps`` holds for these shapes, or, with no ``steps``, one
    captured for this call and freed on return.
    Returns (params, losses (steps,))."""
    if x.device.type != "cuda":
        flat, shape = order.reshape(-1), tuple(order.shape)
        return local_update(params, lr,
                            x[flat].reshape(shape + tuple(x.shape[1:])),
                            y[flat].reshape(shape), loss_fn)
    step = (steps.get(params, lr, x, y, order, loss_fn) if steps is not None
            else CapturedStep(params, lr, x, y, order, loss_fn))
    return step.run(params, x, y, order)


def _sgd_step(loss_fn: LossFn, lr: float, params: Params, x: torch.Tensor,
              y: torch.Tensor, order: torch.Tensor, step: torch.Tensor,
              losses: torch.Tensor) -> None:
    """One SGD step of LocalUpdate, in place, all on the device: the batch
    of row ``step`` of ``order``, the loss and its gradients, the update
    as the eager loop writes it (``optimizers.sgd_step``: the same two
    roundings), the loss into ``losses[step]``, and ``step`` + 1."""
    idx = order.index_select(0, step).reshape(-1)
    loss, grads = value_and_grad(loss_fn, params, x.index_select(0, idx),
                                 y.index_select(0, idx))
    new = sgd_step(params, grads, lr)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(new[k])
        losses.index_copy_(0, step, loss.reshape(1))
        step.add_(1)


class CapturedStep:
    """One SGD step of LocalUpdate captured as a CUDA graph on static
    buffers: the client's params, data and batch order, a step counter
    and the losses live on the card, and a step is one ``replay``.

    The graph is built for the shapes of its first call (params, x, y,
    order) and a learning rate; ``run`` loads a client into the buffers
    and replays the graph once a row of ``order``. Before capture the step
    runs twice on the capture stream on scratch copies of the params
    (cuDNN and the allocator settle there). A capture that fails
    raises."""

    WARMUP = 2

    def __init__(self, params: Params, lr: float, x: torch.Tensor,
                 y: torch.Tensor, order: torch.Tensor, loss_fn: LossFn):
        dev = x.device
        self.steps = order.shape[0]
        self.loss_fn, self.lr = loss_fn, lr
        self._cost = None
        self.params = {k: v.detach().clone() for k, v in params.items()}
        self.x, self.y = x.detach().clone(), y.detach().clone()
        self.order = order.to(dev, torch.int64).clone()
        self.step = torch.zeros(1, dtype=torch.int64, device=dev)
        self.losses = torch.zeros(self.steps, dtype=torch.float32,
                                  device=dev)
        args = (self.x, self.y, self.order)
        self.graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(self.graph)
        # warm up on the stream the graph is captured on: PyTorch's one
        # capture stream for the process. cuBLAS keeps a workspace for
        # every stream it has run on until the process ends, so a new side
        # stream for each capture would leave a new workspace behind
        side = capture.capture_stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP):
                _sgd_step(loss_fn, lr, {k: v.clone() for k, v in
                                        self.params.items()}, *args,
                          torch.zeros_like(self.step),
                          torch.zeros_like(self.losses))
        torch.cuda.current_stream(dev).wait_stream(side)
        try:
            with capture:
                _sgd_step(loss_fn, lr, self.params, *args, self.step,
                          self.losses)
        except RuntimeError as e:
            raise RuntimeError("LocalUpdate: capturing the SGD step as a "
                               "CUDA graph failed") from e

    def run(self, params: Params, x: torch.Tensor, y: torch.Tensor,
            order: torch.Tensor):
        """LocalUpdate from ``params`` over ``x``, ``y`` in the batch order
        ``order`` -> (new params, losses (steps,)), fresh tensors."""
        with torch.no_grad():
            for k, p in self.params.items():
                p.copy_(params[k])
            self.x.copy_(x)
            self.y.copy_(y)
            self.order.copy_(order)
            self.step.zero_()
        for _ in range(self.steps):
            self.graph.replay()
        if get_tracer().enabled:
            charge_span(self.cost(), (self.x,))
        return ({k: v.clone() for k, v in self.params.items()},
                self.losses.clone())

    def cost(self):
        """The LocalUpdate's ``obs.profile.CostRecord``: one SGD step
        counted on meta tensors (``launch/flop_analysis.count``), times
        the steps; counted once, None where the count fails (it is
        telemetry)."""
        if self._cost is None:
            from repro_torch.launch import flop_analysis
            try:
                sc, _ = flop_analysis.count(
                    _sgd_step, self.loss_fn, self.lr, self.params, self.x,
                    self.y, self.order, self.step, self.losses)
                self._cost = CostRecord(
                    flops=sc.flops * self.steps,
                    hbm_bytes=sc.bytes * self.steps,
                    transcendentals=sc.transcendentals * self.steps)
            except Exception:
                self._cost = False
        return self._cost or None


class CapturedSteps:
    """The captured SGD steps of one owner (an FL run, a round), one for
    each set of shapes, learning rate and loss, captured on first use.
    The client loop and the cohort engine of a run share them, so their
    LocalUpdates replay the same graphs. ``release`` frees the graphs,
    their memory pools and their static buffers; the owner calls it when
    it ends, and after it the next ``get`` captures again."""

    def __init__(self):
        self._steps: Dict[tuple, CapturedStep] = {}

    def get(self, params: Params, lr: float, x: torch.Tensor,
            y: torch.Tensor, order: torch.Tensor,
            loss_fn: LossFn) -> CapturedStep:
        """The step for these shapes, learning rate and loss."""
        key = (loss_fn, float(lr), x.device, tuple(order.shape),
               tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
               tuple((k, tuple(v.shape), v.dtype) for k, v in params.items()))
        if key not in self._steps:
            self._steps[key] = CapturedStep(params, lr, x, y, order, loss_fn)
            # the sentinel: a capture is this LocalUpdate's compile
            compile_sentinel("local_update_stack",
                             f"{getattr(loss_fn, '__qualname__', '')}|"
                             f"{key[1:]}", len(self._steps))
        return self._steps[key]

    def __len__(self) -> int:
        return len(self._steps)

    def release(self) -> None:
        """Free every graph this owner captured."""
        for step in self._steps.values():
            step.graph.reset()
        self._steps.clear()
