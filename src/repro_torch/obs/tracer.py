"""repro_torch.obs.tracer — nested span tracing for the port's FL runtime
(the counterpart of ``repro.obs.tracer``).

A ``Tracer`` records a tree of wall-clock spans (``round -> broadcast ->
client -> select -> local_update -> ...``) plus point events and a
byte-attribution table fed by the ``CommLedger`` bridge
(``repro_torch.obs.metrics.MeteredLedger``), and serializes the whole run
as schema-versioned JSONL (``SCHEMA``). The schema is the reference's: a
trace is a file format, so each package's ``load_trace`` reads the other's
traces. ``python -m repro_torch.obs`` summarizes, diffs, and exports
traces to Chrome trace-event format.

The hooks sprinkled through the runtime go through the *active tracer*
(``get_tracer``/``use_tracer``) so no call signature has to thread a
tracer argument. When no tracer is active the singleton ``NULL_TRACER``
is returned and every hook — ``span``/``event``/``inc``/``gauge``/
``Span.sync`` — is a no-op on shared singletons: no device syncs, no
allocation, which is what keeps observability-off runs bit-identical to
the uninstrumented runtime.

``Span.sync`` synchronizes the card, so a traced span covers the device
work it launched, and a traced run's timings are not an untraced run's.
Inside a CUDA graph capture a synchronize would break the capture: there
``Span.sync`` does nothing and marks the span ``captured`` (its wall
covers the capture, not device time), the counterpart of the reference
marking a span ``traced`` under jit tracing.
"""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs.metrics import NULL_METRICS, MetricsRegistry
from repro_torch.obs.timing import cuda_devices, monotonic
from repro_torch.obs.timing import sync as _device_sync

SCHEMA = "repro.obs.trace/v1"


class _NullSpan:
    """Shared no-op span: the body of every ``with obs.span(...)`` hook
    when observability is off. ``sync`` is the identity (no synchronize,
    so asynchronous launches are not perturbed)."""
    __slots__ = ()
    enabled = False
    name = ""
    duration = 0.0

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> None:
        return None

    def sync(self, x: Any) -> Any:
        return x

    def set(self, **attrs: Any) -> None:
        return None


NULL_SPAN = _NullSpan()


class Span:
    """One timed block in the trace tree.  Use as a context manager
    (flcheck OBS001 flags spans opened without ``with``)."""
    __slots__ = ("tracer", "span_id", "parent_id", "name", "attrs",
                 "t0", "t1", "bytes", "frames")
    enabled = True

    def __init__(self, tracer: "Tracer", span_id: int,
                 parent_id: Optional[int], name: str,
                 attrs: Dict[str, Any]) -> None:
        self.tracer = tracer
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs
        self.t0 = 0.0
        self.t1 = 0.0
        self.bytes: Dict[str, int] = {}
        self.frames: Dict[str, int] = {}

    def __enter__(self) -> "Span":
        self.tracer._stack.append(self)
        self.t0 = monotonic()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.t1 = monotonic()
        top = self.tracer._stack.pop()
        if top is not self:  # pragma: no cover - programming error guard
            raise RuntimeError(
                f"span stack corrupted: closed {self.name!r}, top was "
                f"{top.name!r}")
        # cost-annotated span (obs.profile attached flops + peaks): now
        # that the duration is known, derive the card's utilization — not
        # for "captured" spans, whose wall covers a CUDA graph capture,
        # not device time, and a utilization from it would be fiction
        a = self.attrs
        if "flops" in a and a.get("peak_flops") and "captured" not in a:
            dur = self.t1 - self.t0
            if dur > 0:
                a["utilization"] = a["flops"] / dur / a["peak_flops"]
                if a.get("hbm_bytes") and a.get("peak_hbm_bw"):
                    a["hbm_utilization"] = (a["hbm_bytes"] / dur
                                            / a["peak_hbm_bw"])
        self.tracer.spans.append(self)

    @property
    def duration(self) -> float:
        """Wall seconds between enter and exit (0 while still open)."""
        return self.t1 - self.t0

    def sync(self, x: Any) -> Any:
        """Block until the device work behind ``x`` is done so the span
        covers it. Inside a CUDA graph capture it does nothing and marks
        the span ``captured``: a synchronize there would break the
        capture, and the span then measured the capture, not device
        time."""
        if (x is not None and cuda_devices(x)
                and torch.cuda.is_current_stream_capturing()):
            self.attrs["captured"] = True
            return x
        return _device_sync(x)

    def set(self, **attrs: Any) -> None:
        """Attach/overwrite span attributes after entry."""
        self.attrs.update(attrs)

    def charge(self, direction: str, category: str, nbytes: int,
               frames: int) -> None:
        """Accumulate ledger bytes/frames under ``direction/category`` —
        called by ``Tracer.on_ledger`` for the innermost open span."""
        key = f"{direction}/{category}"
        self.bytes[key] = self.bytes.get(key, 0) + int(nbytes)
        self.frames[key] = self.frames.get(key, 0) + int(frames)

    def to_record(self) -> Dict[str, Any]:
        """The span's trace-file JSON record (attrs/bytes only if any)."""
        rec: Dict[str, Any] = {"type": "span", "id": self.span_id,
                               "parent": self.parent_id, "name": self.name,
                               "t0": self.t0, "t1": self.t1}
        if self.attrs:
            rec["attrs"] = self.attrs
        if self.bytes:
            rec["bytes"] = self.bytes
            rec["frames"] = self.frames
        return rec


class NullTracer:
    """The inert tracer: every hook is a no-op returning shared
    singletons.  Active whenever ``FLConfig.observability`` is off."""
    __slots__ = ()
    enabled = False
    metrics = NULL_METRICS

    def span(self, name: str, **attrs: Any) -> _NullSpan:
        """The shared no-op span (still a context manager)."""
        return NULL_SPAN

    def event(self, name: str, **attrs: Any) -> None:
        """Dropped."""
        return None

    def on_ledger(self, direction: str, category: str, nbytes: int,
                  frames: int) -> None:
        """Dropped (the ledger itself still books the bytes)."""
        return None

    def current(self) -> None:
        """Always None: no span is ever open."""
        return None


NULL_TRACER = NullTracer()


class Tracer:
    """Records spans/events/metrics for one run and serializes them."""
    enabled = True

    def __init__(self, meta: Optional[Dict[str, Any]] = None) -> None:
        self.meta = dict(meta or {})
        self.metrics = MetricsRegistry()
        self.spans: List[Span] = []          # finished, in close order
        self.events: List[Dict[str, Any]] = []
        self.unattributed: Dict[str, int] = defaultdict(int)
        self._stack: List[Span] = []
        self._next_id = 1

    # -- recording ---------------------------------------------------
    def span(self, name: str, **attrs: Any) -> Span:
        """New child span of the innermost open span (parent captured at
        creation); must be used as a ``with`` context manager."""
        sid = self._next_id
        self._next_id += 1
        parent = self._stack[-1].span_id if self._stack else None
        return Span(self, sid, parent, name, attrs)

    def event(self, name: str, **attrs: Any) -> None:
        """Record an instantaneous event under the current span."""
        parent = self._stack[-1].span_id if self._stack else None
        self.events.append({"type": "event", "name": name,
                            "ts": monotonic(), "parent": parent,
                            "attrs": attrs})

    def current(self) -> Optional[Span]:
        """The innermost open span, or None outside any span."""
        return self._stack[-1] if self._stack else None

    def on_ledger(self, direction: str, category: str, nbytes: int,
                  frames: int) -> None:
        """CommLedger bridge: attribute a byte charge to the open span
        (or the ``unattributed`` bucket, which trace-completeness checks
        require to stay empty) and mirror it into metrics counters."""
        cur = self.current()
        if cur is not None:
            cur.charge(direction, category, nbytes, frames)
        else:
            self.unattributed[f"{direction}/{category}"] += int(nbytes)
        self.metrics.counter(f"ledger.{direction}.{category}.bytes").inc(nbytes)
        self.metrics.counter(f"ledger.{direction}.{category}.frames").inc(frames)

    # -- rollups -----------------------------------------------------
    def attributed_bytes(self) -> Dict[str, int]:
        """Total bytes per ``direction/category`` summed over all spans
        (open spans included).  Completeness means this equals the
        ledger's own totals and ``unattributed`` is empty."""
        out: Dict[str, int] = defaultdict(int)
        for sp in list(self.spans) + list(self._stack):
            for key, n in sp.bytes.items():
                out[key] += n
        return dict(out)

    def child_durations(self, parent: Span) -> Dict[str, float]:
        """Wall seconds of ``parent``'s direct children, summed by span
        name — the per-phase timing dict ``SimulationResult`` carries."""
        out: Dict[str, float] = {}
        for sp in self.spans:
            if sp.parent_id == parent.span_id:
                out[sp.name] = out.get(sp.name, 0.0) + sp.duration
        return out

    # -- serialization -----------------------------------------------
    def to_records(self) -> List[Dict[str, Any]]:
        """Full trace as JSON records: header, spans (close order),
        events, then the metrics snapshot + unattributed tail."""
        header = {"type": "header", "schema": SCHEMA, "meta": self.meta}
        tail: List[Dict[str, Any]] = [
            {"type": "metrics", "snapshot": self.metrics.snapshot(),
             "unattributed": dict(self.unattributed)}]
        return ([header] + [sp.to_record() for sp in self.spans]
                + list(self.events) + tail)

    def write_jsonl(self, path: str) -> None:
        """Serialize ``to_records()`` to a JSONL trace file (the format
        ``python -m repro_torch.obs`` reads)."""
        with open(path, "w") as f:
            for rec in self.to_records():
                f.write(json.dumps(rec) + "\n")


# -- trace files (reader side; used by the CLI and tests) ------------

class TraceError(ValueError):
    """Malformed or wrong-schema trace file."""


def load_trace(path: str) -> Dict[str, Any]:
    """Parse a trace JSONL file into
    ``{"header", "spans", "events", "metrics"}``; raises ``TraceError``
    on missing/mismatched schema header or bad JSON."""
    header = None
    spans: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    metrics: Dict[str, Any] = {"snapshot": {}, "unattributed": {}}
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise TraceError(f"{path}:{i + 1}: bad JSON: {e}") from e
            kind = rec.get("type")
            if i == 0:
                if kind != "header" or rec.get("schema") != SCHEMA:
                    raise TraceError(
                        f"{path}: missing/unsupported trace header "
                        f"(want schema {SCHEMA!r}, got "
                        f"{rec.get('schema')!r})")
                header = rec
                continue
            if kind == "span":
                spans.append(rec)
            elif kind == "event":
                events.append(rec)
            elif kind == "metrics":
                metrics = rec
    if header is None:
        raise TraceError(f"{path}: empty trace file")
    return {"header": header, "spans": spans, "events": events,
            "metrics": metrics}


def span_paths(trace: Dict[str, Any]) -> Dict[str, Dict[str, int]]:
    """Collapse a loaded trace's span tree to ``name/path`` ->
    ``{count, bytes}`` — the wall-time-free structural signature ``diff``
    compares."""
    by_id = {sp["id"]: sp for sp in trace["spans"]}

    def path(sp: Dict[str, Any]) -> str:
        parts = [sp["name"]]
        pid = sp.get("parent")
        guard = 0
        while pid is not None and pid in by_id and guard < 64:
            parts.append(by_id[pid]["name"])
            pid = by_id[pid].get("parent")
            guard += 1
        return "/".join(reversed(parts))

    out: Dict[str, Dict[str, int]] = {}
    for sp in trace["spans"]:
        p = path(sp)
        slot = out.setdefault(p, {"count": 0, "bytes": 0})
        slot["count"] += 1
        slot["bytes"] += sum(sp.get("bytes", {}).values())
    return out


def to_chrome(trace: Dict[str, Any]) -> Dict[str, Any]:
    """Chrome trace-event JSON (load in chrome://tracing / Perfetto):
    spans as complete ('X') events, point events as instants ('i'),
    timestamps in microseconds relative to the first span."""
    t_base = min([sp["t0"] for sp in trace["spans"]]
                 + [ev["ts"] for ev in trace["events"]], default=0.0)
    out: List[Dict[str, Any]] = []
    for sp in trace["spans"]:
        args = dict(sp.get("attrs", {}))
        if sp.get("bytes"):
            args["bytes"] = sp["bytes"]
        out.append({"ph": "X", "name": sp["name"], "pid": 1, "tid": 1,
                    "ts": (sp["t0"] - t_base) * 1e6,
                    "dur": (sp["t1"] - sp["t0"]) * 1e6, "args": args})
    for ev in trace["events"]:
        out.append({"ph": "i", "name": ev["name"], "pid": 1, "tid": 1,
                    "ts": (ev["ts"] - t_base) * 1e6, "s": "g",
                    "args": ev.get("attrs", {})})
    return {"traceEvents": out,
            "otherData": {"schema": trace["header"]["schema"],
                          "meta": trace["header"].get("meta", {})}}


# -- active-tracer plumbing ------------------------------------------

_ACTIVE: List[Any] = [NULL_TRACER]


def get_tracer() -> Any:
    """The tracer the instrumentation hooks report to (NULL_TRACER when
    observability is off)."""
    return _ACTIVE[-1]


class use_tracer:
    """``with use_tracer(t): ...`` installs ``t`` as the active tracer
    for the dynamic extent of the block."""

    def __init__(self, tracer: Any) -> None:
        self.tracer = tracer if tracer is not None else NULL_TRACER

    def __enter__(self) -> Any:
        _ACTIVE.append(self.tracer)
        return self.tracer

    def __exit__(self, *exc: Any) -> None:
        _ACTIVE.pop()
