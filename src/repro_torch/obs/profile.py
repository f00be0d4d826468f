"""repro_torch.obs.profile — cost-annotated spans and the recompile
sentinel (the counterpart of ``repro.obs.profile``).

``profiled`` wraps the port's hot entry points (the selection pipeline,
the CUDA kernel launches); the captured LocalUpdate (``core/fedavg.py``
``CapturedSteps``, the reference's ``local_update_stack``) reports
through ``compile_sentinel`` and ``charge_span``, a capture being its
compile. With a tracer active, every *new* abstract call signature
(shape and dtype per tensor, the type of any other dynamic value, repr
per static argument)

  * bumps the ``compile.<name>`` / ``compile.<name>.<sig>`` counters in
    the tracer's ``MetricsRegistry`` and records a ``compile`` event under
    the open span — the **recompile sentinel**. There is no jit in the
    port: a "compile" is a first launch at new shapes (a kernel's template
    instance and plan, a CUDA graph capture), so a new signature in a
    round after round 0 is the same bug the reference's sentinel catches;
  * attaches the call's ``flops`` / ``hbm_bytes`` (accumulated, since one
    span may cover several calls) and the card's ``peak_flops`` /
    ``peak_hbm_bw`` to the open span, from which the closing span
    computes ``utilization`` and ``hbm_utilization``.

A call's cost is a :class:`CostRecord`: a kernel launch's from
``kernels/cost.py`` (the wrapper's ``cost=``), any other function's from
running it on ``meta`` tensors under ``launch/flop_analysis.py``'s count,
the port's one FLOP/byte deriver (its counterpart of
``launch/hlo_analysis.py``).

With no tracer active (``FLConfig.observability`` off) the wrapper is the
plain call behind one attribute read — bit-identical runs, no profiling
work, the NullTracer contract.
"""
from __future__ import annotations

import hashlib
import inspect
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.obs.timing import _tensors
from repro_torch.obs.tracer import get_tracer


# --------------------------------------------------------------------------
# the one cost record
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class CostRecord:
    """Per-call cost. ``flops``/``hbm_bytes`` count every op of the call;
    a *dynamic* loop (the early-exit Lloyd loop) counts its body once and
    bumps ``unknown_trip_loops`` — the record is then a lower bound,
    flagged, never a guess."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    transcendentals: float = 0.0
    collective_bytes: float = 0.0
    unknown_trip_loops: int = 0

    def as_dict(self) -> Dict[str, float]:
        """Plain-dict form for span attrs / JSON reports."""
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "transcendentals": self.transcendentals,
                "collective_bytes": self.collective_bytes,
                "unknown_trip_loops": self.unknown_trip_loops}


def record_from_step(sc: Any) -> CostRecord:
    """``launch/flop_analysis.StepCost`` -> :class:`CostRecord` — the one
    place the counter's fields are mapped into the record the rest of the
    port consumes (the reference's ``record_from_hlo``)."""
    return CostRecord(flops=sc.flops, hbm_bytes=sc.bytes,
                      transcendentals=sc.transcendentals,
                      collective_bytes=sc.collective_total,
                      unknown_trip_loops=sc.unknown_trips)


def record_from_dryrun(rec: Dict[str, Any]) -> CostRecord:
    """Rebuild the cost record from a saved dry-run JSON
    (``launch/dryrun`` output), so a report renders from the same record
    type the live profiler attaches."""
    cost = rec.get("cost", {})
    coll = rec.get("collectives", {})
    return CostRecord(
        flops=float(cost.get("flops_expanded", cost.get("flops", 0.0))),
        hbm_bytes=float(cost.get("bytes_expanded",
                                 cost.get("bytes accessed", 0.0))),
        transcendentals=float(cost.get("transcendentals", 0.0)),
        collective_bytes=float(coll.get("total_bytes", 0.0)),
        unknown_trip_loops=int(coll.get("unknown_trip_counts", 0)))


# --------------------------------------------------------------------------
# per-backend peak table
# --------------------------------------------------------------------------
# Host-CPU peaks are order-of-magnitude estimates (a couple of AVX cores),
# the reference's own — good enough for *relative* utilization
# trajectories on a CPU run; the card's entry is the H100's data sheet via
# launch/mesh.py (single source).
_CPU_PEAKS = {"peak_flops_bf16": 2.0e11, "peak_flops_f32": 1.0e11,
              "hbm_bw": 2.0e10, "ici_bw": 0.0}


def h100_peaks() -> Dict[str, float]:
    """The H100's data-sheet peaks (``launch/mesh.py``), whatever card
    this process sees: what the dry run's roofline is reckoned against."""
    from repro_torch.launch import mesh
    return {"peak_flops_bf16": mesh.H100_PEAK_FLOPS_BF16,
            "peak_flops_f32": mesh.H100_PEAK_FLOPS_F32,
            "hbm_bw": mesh.H100_HBM_BW, "ici_bw": mesh.H100_NVLINK_BW}


def peak_table(backend: str) -> Dict[str, float]:
    """Peak FLOP/s and memory bandwidth for ``backend`` ('cuda'/'cpu').
    'cuda' is the H100's data sheet and raises, naming the card, on any
    other card: its peaks are not the H100's. The selection and
    transport kernels compute in f32, so their spans use
    ``peak_flops_f32``; bf16 attention and the LM dry-run rooflines use
    bf16."""
    if backend == "cuda":
        from repro_torch.launch.mesh import H100_NAME
        name = torch.cuda.get_device_name()
        if name != H100_NAME:
            raise ValueError(f"peak_table('cuda'): the card is {name!r}; "
                             f"the table holds {H100_NAME!r}'s peaks only")
        return h100_peaks()
    return dict(_CPU_PEAKS)


def roofline(cost: CostRecord, peaks: Dict[str, float],
             dtype: str = "f32") -> Dict[str, Any]:
    """The three roofline terms + binding resource for one cost record —
    the single roofline calculator (the dry run and the chip smoke both
    call this)."""
    peak = peaks[f"peak_flops_{dtype}"]
    compute_s = cost.flops / peak if peak else 0.0
    memory_s = cost.hbm_bytes / peaks["hbm_bw"] if peaks["hbm_bw"] else 0.0
    ici = peaks.get("ici_bw", 0.0)
    collective_s = cost.collective_bytes / ici if ici else 0.0
    bound = max((("compute", compute_s), ("memory", memory_s),
                 ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return {"compute_s": compute_s, "memory_s": memory_s,
            "collective_s": collective_s, "bound": bound}


# --------------------------------------------------------------------------
# the sentinel and the profiled wrapper
# --------------------------------------------------------------------------
def _abstract(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return f"{leaf.dtype}{tuple(leaf.shape)}"
    # a dynamic Python value: its type, not its value (jit traces it)
    return type(leaf).__name__


def _leaves(x: Any):
    if isinstance(x, dict):
        for k in sorted(x, key=str):
            yield from _leaves(x[k])
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    else:
        yield x


def _structure(x: Any) -> str:
    if isinstance(x, dict):
        return "{" + ",".join(f"{k}:{_structure(x[k])}"
                              for k in sorted(x, key=str)) + "}"
    if isinstance(x, (list, tuple)):
        return "(" + ",".join(_structure(v) for v in x) + ")"
    return "*"


def sig_hash(sig: str) -> str:
    """The short hash of a signature that names its counter."""
    return hashlib.md5(sig.encode()).hexdigest()[:10]


def compile_sentinel(name: str, sig: str, nth: int) -> None:
    """Record a "compile" of ``name`` at the new signature ``sig`` (its
    ``nth``) on the active tracer: the ``compile.<name>`` and
    ``compile.<name>.<hash>`` counters and a ``compile`` event under the
    open span. The caller counts each signature once."""
    tracer = get_tracer()
    if not tracer.enabled:
        return
    h = sig_hash(sig)
    tracer.metrics.counter(f"compile.{name}").inc()
    tracer.metrics.counter(f"compile.{name}.{h}").inc()
    tracer.event("compile", fn=name, signature=h, nth=nth)


def _peaks_for(args: tuple, kwargs: dict) -> Optional[Tuple[float, float]]:
    """(peak FLOP/s, peak bytes/s) for a call on these tensors: the card's
    where one is on a card, the CPU's otherwise; at bf16 where an input is
    bf16 or f16, at f32 otherwise. None on a card whose peaks the table
    does not hold."""
    ts = list(_tensors((args, kwargs)))
    backend = "cuda" if any(t.is_cuda for t in ts) else "cpu"
    try:
        peaks = peak_table(backend)
    except ValueError:
        return None
    half = any(t.dtype in (torch.bfloat16, torch.float16) for t in ts)
    return (peaks["peak_flops_bf16" if half else "peak_flops_f32"],
            peaks["hbm_bw"])


def charge_span(cost: Optional[CostRecord], args: Any = (),
                kwargs: Any = None) -> None:
    """Add ``cost`` to the active tracer's open span (accumulated: one span
    may cover several calls; the span computes its utilization on close),
    with the peaks of a call on ``args`` / ``kwargs``' tensors."""
    cur = get_tracer().current()
    if cur is None or cost is None:
        return
    cur.attrs["flops"] = cur.attrs.get("flops", 0.0) + cost.flops
    cur.attrs["hbm_bytes"] = cur.attrs.get("hbm_bytes", 0.0) + cost.hbm_bytes
    peaks = _peaks_for(args, kwargs or {})
    if peaks is not None:
        cur.attrs.setdefault("peak_flops", peaks[0])
        cur.attrs.setdefault("peak_hbm_bw", peaks[1])
    if cost.unknown_trip_loops:
        cur.attrs["cost_is_lower_bound"] = True


# how many profiled functions without a ``cost=`` are running: a call
# nested in one is part of that one's count and compile, as a jit call
# inlines into its caller's trace
_RUNNING = [0]


class ProfiledFunction:
    """A function plus the sentinel/cost layer. Execution always goes
    through the one underlying callable (so traced and untraced runs stay
    bit-identical); profiling is bookkeeping around it, active only under
    a live tracer.

    ``cost``, where given, maps the call's arguments to its
    ``kernels/cost.KernelCost`` or :class:`CostRecord` (a kernel launch,
    which runs no torch op the counter could see); without it the cost is
    counted by running the function on meta tensors
    (``launch/flop_analysis.count``), once a signature."""

    def __init__(self, fn: Callable, *, name: Optional[str] = None,
                 static_argnames: Tuple[str, ...] = (),
                 cost: Optional[Callable[..., Any]] = None) -> None:
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn")
        self.static_argnames = tuple(static_argnames)
        self.cost_fn = cost
        self.__doc__ = getattr(fn, "__doc__", None)
        self.__name__ = self.name
        self.__wrapped__ = fn
        self._pysig: Any = None
        self._costs: Dict[str, Optional[CostRecord]] = {}
        self._counted: set = set()

    def signature_key(self, args: tuple, kwargs: dict) -> str:
        """Abstract call signature: (shape, dtype) per tensor, the type of
        any other dynamic value, repr for statics."""
        if self._pysig is None:
            try:
                self._pysig = inspect.signature(self.fn)
            except (TypeError, ValueError):  # pragma: no cover
                self._pysig = False
        dyn, static = (args, dict(kwargs)), {}
        if self._pysig:
            try:
                bound = self._pysig.bind(*args, **kwargs)
                bound.apply_defaults()
                static = {k: v for k, v in bound.arguments.items()
                          if k in self.static_argnames}
                dyn = {k: v for k, v in bound.arguments.items()
                       if k not in self.static_argnames}
            except TypeError:
                pass
        parts = [_abstract(leaf) for leaf in _leaves(dyn)]
        parts.append(_structure(dyn))
        parts.append(repr(sorted((k, repr(v)) for k, v in static.items())))
        return "|".join(parts)

    def _derive_cost(self, sig: str, args: tuple,
                     kwargs: dict) -> Optional[CostRecord]:
        if self.cost_fn is not None:
            kc = self.cost_fn(*args, **kwargs)
            if isinstance(kc, CostRecord):
                return kc
            return CostRecord(flops=float(kc.flops),
                              hbm_bytes=float(kc.hbm_bytes),
                              transcendentals=float(kc.transcendentals))
        if sig in self._costs:
            return self._costs[sig]
        try:
            from repro_torch.launch import flop_analysis
            sc, _ = flop_analysis.count(self.fn, *args, **kwargs)
            cost = record_from_step(sc)
        except Exception:  # cost is telemetry; never fail the call for it
            cost = None
        self._costs[sig] = cost
        return cost

    def cost(self, *args: Any, **kwargs: Any) -> Optional[CostRecord]:
        """The :class:`CostRecord` of this call signature (derived and
        cached on first use; no tracer needed)."""
        return self._derive_cost(self.signature_key(args, kwargs),
                                 args, kwargs)

    def _plain(self, args: tuple, kwargs: dict) -> Any:
        if self.cost_fn is not None:
            return self.fn(*args, **kwargs)
        _RUNNING[0] += 1
        try:
            return self.fn(*args, **kwargs)
        finally:
            _RUNNING[0] -= 1

    # -- the call ----------------------------------------------------
    def __call__(self, *args: Any, **kwargs: Any) -> Any:
        tracer = get_tracer()
        if not tracer.enabled:
            return self.fn(*args, **kwargs)
        from repro_torch.launch.flop_analysis import is_counting
        if is_counting() or (self.cost_fn is None and _RUNNING[0]):
            # inside a count (its meta run), or nested in another profiled
            # function: this call is part of the outer one's cost and
            # compile
            return self.fn(*args, **kwargs)

        sig = self.signature_key(args, kwargs)
        if sig not in self._counted:
            # the sentinel: a first launch at this signature instantiates
            # and plans it, so count it where the trace can see the round
            self._counted.add(sig)
            compile_sentinel(self.name, sig, len(self._counted))
        cost = self._derive_cost(sig, args, kwargs)
        out = self._plain(args, kwargs)
        charge_span(cost, args, kwargs)
        return out


def profiled(fn: Optional[Callable] = None, *, name: Optional[str] = None,
             static_argnames: Tuple[str, ...] = (),
             cost: Optional[Callable[..., Any]] = None) -> Any:
    """Decorator/factory: the sentinel + cost layer around ``fn`` (the
    reference's ``profiled_jit`` without the jit)::

        @profiled(static_argnames=("k",))
        def kmeans(x, k, ...): ...

    or inline: ``prof = profiled(launch, name="lloyd", cost=lambda x, c,
    m: kernels.cost.kmeans_lloyd_step(...))``."""
    if fn is None:
        return lambda f: ProfiledFunction(f, name=name,
                                          static_argnames=static_argnames,
                                          cost=cost)
    return ProfiledFunction(fn, name=name, static_argnames=static_argnames,
                            cost=cost)
