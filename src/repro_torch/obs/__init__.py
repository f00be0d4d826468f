"""repro_torch.obs — observability of the port: span tracing, a metrics
registry with a byte-true CommLedger bridge, and timed blocks around the
CUDA kernels and round phases (the counterpart of ``repro.obs``), beside
the clock (``obs.timing``) and a kernel's device time by name
(``obs.device_time``).

One knob: ``FLConfig.observability`` (default off). Off, every hook in the
runtime resolves to the shared ``NULL_TRACER``/``NULL_SPAN`` singletons —
no synchronize, no allocation — so disabled runs are bit-identical to the
uninstrumented code, ledger and kernel launches included. On,
``FLSimulation`` and ``FLService`` own a ``Tracer`` whose trace serializes
as schema-versioned JSONL (``repro_torch.obs.tracer.SCHEMA``, the
reference's schema):

    sim = FLSimulation(..., cfg=replace(cfg, observability=True))
    res = sim.run(rounds=3)
    sim.tracer.write_jsonl("trace.jsonl")
    # then: python -m repro_torch.obs summarize trace.jsonl
    #       python -m repro_torch.obs export-chrome trace.jsonl out.json
    #       python -m repro_torch.obs diff a.jsonl b.jsonl

Tracing synchronizes the card at every span that syncs its output, so a
traced run's timings are not an untraced run's.

Instrumentation idiom (all no-ops when disabled)::

    with obs.timed_block("kernel.kmeans_lloyd_step", n=n, k=k) as sp:
        launch(...)
        sp.sync(out)              # synchronize only when tracing
    obs.inc("fault.retransmits")
    obs.gauge("fl.stragglers", late)
    obs.event("selection_sketch", client=3, occupancy=...)

Bench reports go through ``obs.registry.write_bench`` (a BENCH_*.json
and a fingerprinted line of ``experiments/bench_history.jsonl``), and
``python -m repro_torch.obs regress`` gates them against that history;
``obs.timing.timeit`` times calls, synced on their outputs.

Not ported yet (ROADMAP item 10b): the reference's cost model
(``obs/profile.py``) and the tracer's utilization branch, which wait for
the H100 roofline of item 15.
"""
from __future__ import annotations

from typing import Any

from repro_torch.obs.device_time import kernel_device_ms
from repro_torch.obs.metrics import (NULL_METRICS, Counter, Gauge, Histogram,
                                     MeteredLedger, MetricsRegistry,
                                     NullMetrics)
from repro_torch.obs.timing import Timing, monotonic, sync, timeit
from repro_torch.obs.tracer import (NULL_SPAN, NULL_TRACER, SCHEMA,
                                    NullTracer, Span, TraceError, Tracer,
                                    get_tracer, load_trace, span_paths,
                                    to_chrome, use_tracer)

__all__ = [
    "kernel_device_ms", "monotonic", "sync", "Timing", "timeit",
    "SCHEMA", "Tracer",
    "NullTracer", "NULL_TRACER", "Span", "NULL_SPAN", "TraceError",
    "load_trace", "span_paths", "to_chrome", "get_tracer", "use_tracer",
    "span", "timed_block", "event", "inc", "gauge", "MetricsRegistry",
    "NullMetrics", "NULL_METRICS", "Counter", "Gauge", "Histogram",
    "MeteredLedger",
]


def span(name: str, **attrs: Any):
    """Open a span on the active tracer (``NULL_SPAN`` when off). Must
    be used as a ``with`` item — flcheck OBS001 flags bare calls."""
    return get_tracer().span(name, **attrs)


# Same hook, named for the kernel/phase profiling sites: a timed block
# whose ``sp.sync(out)`` makes asynchronous device work count inside it.
timed_block = span


def event(name: str, **attrs: Any) -> None:
    """Record a point event on the active tracer."""
    get_tracer().event(name, **attrs)


def inc(name: str, value: int = 1) -> None:
    """Increment a counter on the active tracer's metrics registry."""
    get_tracer().metrics.counter(name).inc(value)


def gauge(name: str, value: float) -> None:
    """Set a gauge on the active tracer's metrics registry."""
    get_tracer().metrics.gauge(name).set(value)
