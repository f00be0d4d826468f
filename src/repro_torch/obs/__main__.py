"""Trace-file CLI of the port (the counterpart of ``python -m repro.obs``).

  python -m repro_torch.obs summarize TRACE.jsonl
  python -m repro_torch.obs export-chrome TRACE.jsonl OUT.json
  python -m repro_torch.obs diff A.jsonl B.jsonl

Exit codes: 0 ok / traces structurally identical; 1 diff found a
difference; 2 usage or unreadable input. The traces are the reference's
schema, so either package's CLI reads either's traces.

``diff`` compares structure, not wall time (two runs never agree on
nanoseconds): span counts and ledger bytes per span path, event counts
per name, and metrics counters — exactly the signals that must not move
when a change claims to be byte- and shape-neutral.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict

from repro_torch.obs.tracer import (TraceError, load_trace, span_paths,
                                    to_chrome)


def _load(path: str) -> Dict[str, Any]:
    try:
        return load_trace(path)
    except (OSError, TraceError) as e:
        print(f"error: {e}", file=sys.stderr)
        raise SystemExit(2)


def cmd_summarize(args: argparse.Namespace) -> int:
    """``summarize``: per-span-path count/wall/bytes table + metrics."""
    tr = _load(args.trace)
    meta = tr["header"].get("meta", {})
    print(f"schema   {tr['header']['schema']}")
    if meta:
        print(f"meta     {json.dumps(meta, sort_keys=True)}")
    print(f"spans    {len(tr['spans'])}")
    print(f"events   {len(tr['events'])}")
    paths = span_paths(tr)
    if paths:
        t_by_path = {p: 0.0 for p in paths}
        by_id = {sp["id"]: sp for sp in tr["spans"]}
        for sp in tr["spans"]:
            parts = [sp["name"]]
            pid = sp.get("parent")
            while pid in by_id:
                parts.append(by_id[pid]["name"])
                pid = by_id[pid].get("parent")
            t_by_path["/".join(reversed(parts))] += sp["t1"] - sp["t0"]
        width = max(len(p) for p in paths)
        print(f"{'span path'.ljust(width)}  count     wall_s        bytes")
        for p in sorted(paths):
            s = paths[p]
            print(f"{p.ljust(width)}  {s['count']:5d}  {t_by_path[p]:9.4f}"
                  f"  {s['bytes']:11d}")
    snap = tr["metrics"].get("snapshot", {})
    for kind in ("counters", "gauges"):
        for name, v in sorted(snap.get(kind, {}).items()):
            print(f"{kind[:-1]}  {name} = {v}")
    unattr = tr["metrics"].get("unattributed", {})
    if any(unattr.values()):
        print(f"WARNING: unattributed ledger bytes: {unattr}")
    return 0


def cmd_export_chrome(args: argparse.Namespace) -> int:
    """``export-chrome``: trace -> Chrome trace-event JSON file."""
    tr = _load(args.trace)
    doc = to_chrome(tr)
    with open(args.out, "w") as f:
        json.dump(doc, f)
    print(f"{args.out}: {len(doc['traceEvents'])} events "
          f"(open in chrome://tracing or ui.perfetto.dev)")
    return 0


def _diff_dicts(label: str, a: Dict[str, Any], b: Dict[str, Any]) -> int:
    n = 0
    for key in sorted(set(a) | set(b)):
        va, vb = a.get(key), b.get(key)
        if va != vb:
            print(f"{label} {key}: {va} != {vb}")
            n += 1
    return n


def cmd_diff(args: argparse.Namespace) -> int:
    """``diff``: structural comparison of two traces (span paths, event
    counts, counters, unattributed bytes); exit 1 on any difference."""
    ta, tb = _load(args.a), _load(args.b)
    diffs = 0
    pa, pb = span_paths(ta), span_paths(tb)
    diffs += _diff_dicts("span", pa, pb)

    def ev_counts(tr: Dict[str, Any]) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for ev in tr["events"]:
            out[ev["name"]] = out.get(ev["name"], 0) + 1
        return out

    diffs += _diff_dicts("events", ev_counts(ta), ev_counts(tb))
    diffs += _diff_dicts(
        "counter", ta["metrics"].get("snapshot", {}).get("counters", {}),
        tb["metrics"].get("snapshot", {}).get("counters", {}))
    diffs += _diff_dicts("unattributed",
                         ta["metrics"].get("unattributed", {}),
                         tb["metrics"].get("unattributed", {}))
    if diffs:
        print(f"{diffs} difference(s)")
        return 1
    print("traces structurally identical "
          f"({len(ta['spans'])} spans, {len(ta['events'])} events)")
    return 0


def main(argv=None) -> int:
    """CLI dispatcher for ``python -m repro_torch.obs`` subcommands."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("summarize", help="per-path span/byte/metric table")
    p.add_argument("trace")
    p.set_defaults(fn=cmd_summarize)
    p = sub.add_parser("export-chrome", help="Chrome trace-event JSON")
    p.add_argument("trace")
    p.add_argument("out")
    p.set_defaults(fn=cmd_export_chrome)
    p = sub.add_parser("diff", help="structural diff of two traces")
    p.add_argument("a")
    p.add_argument("b")
    p.set_defaults(fn=cmd_diff)
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        raise SystemExit(2 if e.code not in (0, None) else 0)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
