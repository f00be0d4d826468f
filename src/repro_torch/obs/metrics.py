"""repro_torch.obs.metrics — counters / gauges / histograms + the
CommLedger bridge; a copy of ``repro.obs.metrics`` over the port's ledger.

``MetricsRegistry`` is the mutable store a ``Tracer`` owns;
``NULL_METRICS`` is the inert twin every hook touches when observability
is off (shared no-op instruments, zero allocation).

``MeteredLedger`` is the bridge: a ``CommLedger`` subclass whose
``upload``/``download`` forward each charge to the tracer *after* normal
bookkeeping — the ledger stays the single byte-true source (no double
bookkeeping), the tracer only attributes the same bytes to spans and
mirrors them into counters.

``repro_torch.fl.comms`` is pure stdlib, so this module imports no torch.
"""
from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.fl.comms import CommLedger


class Counter:
    """Monotonically increasing integer-ish metric."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, value: int = 1) -> None:
        """Add ``value`` (default 1); never decremented."""
        self.value += value


class Gauge:
    """Last-write-wins instantaneous value."""
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        """Overwrite the current value (last write wins)."""
        self.value = value


class Histogram:
    """Streaming summary: count/sum/min/max (enough for latency and
    size distributions without bucket-boundary bikeshedding)."""
    __slots__ = ("count", "total", "min", "max")

    def __init__(self) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, value: float) -> None:
        """Fold one sample into count/sum/min/max."""
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def summary(self) -> Dict[str, float]:
        """count/sum (+ min/max/mean once non-empty) as a plain dict."""
        if not self.count:
            return {"count": 0, "sum": 0.0}
        return {"count": self.count, "sum": self.total, "min": self.min,
                "max": self.max, "mean": self.total / self.count}


class _NullCounter:
    __slots__ = ()
    value = 0

    def inc(self, value: int = 1) -> None:
        return None


class _NullGauge:
    __slots__ = ()
    value = 0.0

    def set(self, value: float) -> None:
        return None


class _NullHistogram:
    __slots__ = ()
    count = 0

    def observe(self, value: float) -> None:
        return None

    def summary(self) -> Dict[str, float]:
        return {"count": 0, "sum": 0.0}


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Create-on-first-use named instruments."""

    def __init__(self) -> None:
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        """The named counter, created on first use."""
        c = self.counters.get(name)
        if c is None:
            c = self.counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        """The named gauge, created on first use."""
        g = self.gauges.get(name)
        if g is None:
            g = self.gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        """The named histogram, created on first use."""
        h = self.histograms.get(name)
        if h is None:
            h = self.histograms[name] = Histogram()
        return h

    def snapshot(self) -> Dict[str, Any]:
        """Name-sorted {counters, gauges, histograms} values — the
        ``metrics.snapshot`` record in a trace file."""
        return {
            "counters": {k: c.value for k, c in sorted(self.counters.items())},
            "gauges": {k: g.value for k, g in sorted(self.gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self.histograms.items())},
        }


class NullMetrics:
    """Inert registry: every instrument is a shared no-op singleton."""
    __slots__ = ()

    def counter(self, name: str) -> _NullCounter:
        """The shared no-op counter, whatever the name."""
        return _NULL_COUNTER

    def gauge(self, name: str) -> _NullGauge:
        """The shared no-op gauge, whatever the name."""
        return _NULL_GAUGE

    def histogram(self, name: str) -> _NullHistogram:
        """The shared no-op histogram, whatever the name."""
        return _NULL_HISTOGRAM

    def snapshot(self) -> Dict[str, Any]:
        """Empty snapshot in the same shape as ``MetricsRegistry``."""
        return {"counters": {}, "gauges": {}, "histograms": {}}


NULL_METRICS = NullMetrics()


class MeteredLedger(CommLedger):
    """A ``CommLedger`` that mirrors every charge to a tracer.

    Byte totals live only in the ``CommLedger`` fields (``summary()``
    etc. are inherited unchanged); the tracer sees each charge once, for
    span attribution + metrics.  Swapped in for ``FLServer.ledger``
    before the channel is built, so every wire charge of the run flows
    through it.
    """

    def __init__(self, tracer: Any) -> None:
        super().__init__()
        self.tracer = tracer

    def upload(self, category: str, nbytes: int, frames: int = 1) -> None:
        """Normal ledger charge, then one ``on_ledger(\"up\", ...)``."""
        super().upload(category, nbytes, frames)
        self.tracer.on_ledger("up", category, nbytes, frames)

    def download(self, category: str, nbytes: int, frames: int = 1) -> None:
        """Normal ledger charge, then one ``on_ledger(\"down\", ...)``."""
        super().download(category, nbytes, frames)
        self.tracer.on_ledger("down", category, nbytes, frames)
