"""repro_torch.obs.registry — the benchmark run-registry and regression
gate of the port (the counterpart of ``repro.obs.registry``).

A bench report is written through :func:`write_bench`, which also appends
a fingerprinted record (flattened scalars, claims, and the torch / CUDA /
device / host / git fingerprint) to the append-only
``experiments/bench_history.jsonl`` beside it. ``python -m repro_torch.obs
regress`` then compares a current BENCH file against that trajectory with
noise-aware thresholds: per scalar, fail only outside ``median ± k·MAD``
*in the direction that is worse* for that metric, and hard-fail any
``claims`` flag that was true in every historical run and is false now.

The file names and the record schema are the reference's, so either
package's gate reads either's history lines. Pure stdlib but for the
fingerprint, which imports torch when it is called.
"""
from __future__ import annotations

import json
import os
import platform
import re
import subprocess
import time
from typing import Any, Dict, List, Optional

SCHEMA = "repro.obs.bench/v1"

_BENCH_NAME_RE = re.compile(r"^BENCH_(.+)\.json$")


def bench_name(path: str) -> Optional[str]:
    """'/x/BENCH_selection.json' -> 'selection' (None if not a BENCH file)."""
    m = _BENCH_NAME_RE.match(os.path.basename(path))
    return m.group(1) if m else None


def default_history_path(bench_path: str) -> str:
    """BENCH files live at the repo root; history lives in the sibling
    ``experiments/bench_history.jsonl``."""
    root = os.path.dirname(os.path.abspath(bench_path))
    return os.path.join(root, "experiments", "bench_history.jsonl")


# --------------------------------------------------------------------------
# record construction
# --------------------------------------------------------------------------
def flatten_scalars(obj: Any, prefix: str = "",
                    out: Optional[Dict[str, float]] = None,
                    depth: int = 8) -> Dict[str, float]:
    """Dotted-key view of every numeric leaf in a bench report (bools are
    claims, not scalars; lists are samples, not trajectory points)."""
    if out is None:
        out = {}
    if depth < 0:
        return out
    if isinstance(obj, dict):
        for k, v in obj.items():
            key = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, bool):
                continue
            if isinstance(v, (int, float)):
                out[key] = float(v)
            elif isinstance(v, dict):
                flatten_scalars(v, key, out, depth - 1)
    return out


def fingerprint() -> Dict[str, Any]:
    """Enough provenance to explain an outlier: software versions (torch
    and the CUDA it was built for), the device's name (``"cpu"`` without
    a card), the host, and the git rev that produced it."""
    info: Dict[str, Any] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "host": platform.node(),
    }
    try:
        import torch
        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        info["device"] = (torch.cuda.get_device_name(0)
                          if torch.cuda.is_available() else "cpu")
    except Exception:
        info["torch"] = info["cuda"] = info["device"] = None
    try:
        rev = subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                             capture_output=True, text=True, timeout=10,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        info["git_rev"] = rev.stdout.strip() if rev.returncode == 0 else None
    except Exception:
        info["git_rev"] = None
    return info


def history_record(name: str, report: Dict[str, Any]) -> Dict[str, Any]:
    """One ``bench_history.jsonl`` line: schema, bench name, timestamp,
    flattened scalars, boolean claims, environment fingerprint."""
    claims = report.get("claims", {})
    return {"schema": SCHEMA, "bench": name, "ts": time.time(),
            "scalars": flatten_scalars(report),
            "claims": {k: bool(v) for k, v in claims.items()},
            "fingerprint": fingerprint()}


# --------------------------------------------------------------------------
# the one writer
# --------------------------------------------------------------------------
def write_bench(bench_path: str, report: Dict[str, Any], *,
                name: Optional[str] = None,
                history_path: Optional[str] = None,
                history: bool = True) -> Dict[str, Any]:
    """Write a BENCH_*.json AND append its fingerprinted record to the
    run history (the one way a bench file is written). Returns the
    appended record."""
    if name is None:
        name = bench_name(bench_path) or os.path.basename(bench_path)
    with open(bench_path, "w") as f:
        json.dump(report, f, indent=1, sort_keys=True)
        f.write("\n")
    rec = history_record(name, report)
    if history:
        hpath = history_path or default_history_path(bench_path)
        os.makedirs(os.path.dirname(hpath) or ".", exist_ok=True)
        with open(hpath, "a") as f:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
    return rec


def load_history(path: str) -> List[Dict[str, Any]]:
    """All records from a history JSONL ([] if the file doesn't exist —
    first run bootstraps cleanly). Malformed lines raise ValueError."""
    if not os.path.exists(path):
        return []
    recs = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: malformed history line "
                                 f"({e})") from e
    return recs


# --------------------------------------------------------------------------
# noise-aware regression gate
# --------------------------------------------------------------------------
def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def scalar_direction(key: str) -> Optional[str]:
    """Which direction is *worse* for a scalar, by key convention:
    'high_bad' (times, bytes, overheads), 'low_bad' (throughputs,
    accuracies, utilizations, speedups), or None (ungated, noted only)."""
    last = key.split(".")[-1]
    if last.endswith(("_s", "_us", "_ms", "_bytes", "_overhead")) \
            or last in ("overhead_frac", "bytes_per_round", "wall"):
        return "high_bad"
    if last.endswith(("_per_sec", "_per_s", "_acc", "_accuracy",
                      "_speedup", "_agreement")) \
            or last in ("accuracy", "utilization", "speedup",
                        "records_per_sec", "selection_agreement"):
        return "low_bad"
    return None


def regress_report(name: str, report: Dict[str, Any],
                   history: List[Dict[str, Any]], *, k: float = 4.0,
                   min_history: int = 3,
                   rel_floor: float = 0.05) -> Dict[str, Any]:
    """Compare one current bench report against its trajectory.

    Per scalar with >= ``min_history`` history points: fail if the
    current value lies outside ``median ± k * scale`` on the *worse* side,
    where ``scale = max(MAD, rel_floor·|median|)`` — the MAD floor keeps a
    freakishly quiet history from flagging normal jitter.  Scalars with
    no worse-direction convention only produce notes.  Claims that were
    true in **all** history runs and are false now always fail.
    """
    recs = [r for r in history if r.get("bench") == name]
    out: Dict[str, Any] = {"bench": name, "history_points": len(recs),
                           "failures": [], "notes": [], "checked": 0}
    if not recs:
        out["notes"].append("no history for this bench yet (bootstrap run)")

    for ckey, cval in report.get("claims", {}).items():
        hist = [bool(r["claims"][ckey]) for r in recs
                if ckey in r.get("claims", {})]
        if hist and all(hist) and not cval:
            out["failures"].append(
                f"claim '{ckey}' flipped FALSE (true in all "
                f"{len(hist)} history runs)")

    cur = flatten_scalars(report)
    for key in sorted(cur):
        series = [r["scalars"][key] for r in recs
                  if key in r.get("scalars", {})
                  and isinstance(r["scalars"][key], (int, float))]
        if len(series) < min_history:
            continue
        med = _median(series)
        mad = _median([abs(x - med) for x in series])
        scale = max(mad, rel_floor * abs(med), 1e-12)
        val, direction = cur[key], scalar_direction(key)
        hi, lo = med + k * scale, med - k * scale
        out["checked"] += 1
        desc = (f"{key}: {val:.6g} vs median {med:.6g} "
                f"± {k:g}·{scale:.3g} over {len(series)} runs")
        if direction == "high_bad" and val > hi:
            out["failures"].append(f"regression (higher is worse) {desc}")
        elif direction == "low_bad" and val < lo:
            out["failures"].append(f"regression (lower is worse) {desc}")
        elif direction is None and (val > hi or val < lo):
            out["notes"].append(f"drifted (ungated) {desc}")
    return out
