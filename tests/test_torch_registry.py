"""Parity of the port's bench registry, regression gate and timer with the
reference's (``repro_torch.obs.registry``, ``python -m repro_torch.obs
regress``, ``obs.timing.timeit``), on the CPU.

The same reports and histories go through both packages: the flattened
scalars, bench names, history paths, the worse direction of each key and
the gate's verdicts must be equal, each package's history lines must gate
the other's reports alike, and ``write_bench`` must write the reference's
BENCH file, byte for byte, and a history line of its schema, with torch,
CUDA and the device's name in place of jax and its backend. The CLI's
``regress`` must exit as the reference's does (0 clean or bootstrapping,
1 a gated failure, 2 a missing or misnamed BENCH file or a malformed
history). ``timeit`` as the reference's tests hold it. Everything is
written under pytest's ``tmp_path``.
"""
import json

import pytest
import torch

from repro.obs import registry as jregistry
from repro.obs.__main__ import main as jobs_cli
from repro_torch.obs import registry
from repro_torch.obs.__main__ import main as obs_cli
from repro_torch.obs.timing import Timing, timeit


def _report(overhead=0.02, rps=1e5, ok=True):
    return {"overhead_frac": overhead, "records_per_sec": rps,
            "nested": {"traced_s": 1.0 + overhead, "round_ms": 3.5,
                       "tokens_per_s": 7.0, "deeper": {"test_acc": 0.5}},
            "pairs": [1, 2, 3], "label": "x",
            "claims": {"overhead_leq_3pct": ok}}


def _history(reg, n, overhead=0.02, rps=1e5, jitter=0.001, ok=True):
    return [reg.history_record(
        "demo", _report(overhead + jitter * ((i % 3) - 1),
                        rps * (1 + 0.01 * ((i % 3) - 1)), ok=ok))
        for i in range(n)]


def test_scalars_names_paths_and_directions_are_the_references():
    assert registry.SCHEMA == jregistry.SCHEMA
    rep = _report()
    assert registry.flatten_scalars(rep) == jregistry.flatten_scalars(rep)
    for path in ("/x/BENCH_selection.json", "BENCH_torch_comm.json",
                 "/x/results.json", "/x/BENCH_.json"):
        assert registry.bench_name(path) == jregistry.bench_name(path)
        assert (registry.default_history_path(path)
                == jregistry.default_history_path(path))
    keys = ["a.wall", "b.round_ms", "x_s", "n_bytes", "overhead_frac",
            "tok_per_s", "test_acc", "speedup", "records_per_sec", "count",
            "selection_agreement", "bytes_per_round", "x.y_us"]
    assert ([registry.scalar_direction(k) for k in keys]
            == [jregistry.scalar_direction(k) for k in keys])


def test_history_record_and_fingerprint():
    rec = registry.history_record("demo", _report())
    want = jregistry.history_record("demo", _report())
    for key in ("schema", "bench", "scalars", "claims"):
        assert rec[key] == want[key]
    fp = rec["fingerprint"]
    assert fp["torch"] == torch.__version__
    assert fp["cuda"] == torch.version.cuda
    assert fp["device"] == (torch.cuda.get_device_name(0)
                            if torch.cuda.is_available() else "cpu")
    assert "jax" not in fp and "git_rev" in fp
    assert set(want["fingerprint"]) - set(fp) == {"jax", "backend"}


def test_write_bench_writes_the_references_file_and_a_history_line(
        tmp_path):
    mine, theirs = tmp_path / "mine", tmp_path / "theirs"
    for d, reg in ((mine, registry), (theirs, jregistry)):
        d.mkdir()
        for _ in range(2):
            reg.write_bench(str(d / "BENCH_demo.json"), _report())
    assert ((mine / "BENCH_demo.json").read_bytes()
            == (theirs / "BENCH_demo.json").read_bytes())
    hist = registry.load_history(
        str(mine / "experiments" / "bench_history.jsonl"))
    assert len(hist) == 2 and hist[0]["bench"] == "demo"
    assert hist[0]["scalars"]["nested.traced_s"] == pytest.approx(1.02)
    # each package reads the other's history lines
    jhist = registry.load_history(
        str(theirs / "experiments" / "bench_history.jsonl"))
    assert [h["scalars"] for h in jregistry.load_history(
        str(mine / "experiments" / "bench_history.jsonl"))] == \
        [h["scalars"] for h in jhist]
    assert registry.load_history(str(tmp_path / "nope.jsonl")) == []
    bad = tmp_path / "h.jsonl"
    bad.write_text('{"ok": 1}\nnot json\n')
    with pytest.raises(ValueError):
        registry.load_history(str(bad))


@pytest.mark.parametrize("case", [
    dict(), dict(overhead=0.5), dict(rps=10.0), dict(ok=False),
    dict(overhead=0.0001, rps=1e9), dict(overhead=9.9, n=2),
    dict(n=0), dict(ok=False, hist_ok=False)])
def test_the_gate_gives_the_references_verdicts(case):
    """In noise, a time up, a rate down, a claim flipped, an improvement,
    too short a history, none, a claim never true; each package's history
    fed to either gate."""
    case = dict(case)
    n, hist_ok = case.pop("n", 6), case.pop("hist_ok", True)
    rep = _report(**case)
    want = jregistry.regress_report(
        "demo", rep, _history(jregistry, n, ok=hist_ok))
    for reg in (registry, jregistry):
        got = registry.regress_report("demo", rep,
                                      _history(reg, n, ok=hist_ok))
        assert got == want
    other = _history(registry, 6)
    for r in other:
        r["bench"] = "unrelated"
    assert registry.regress_report("demo", _report(overhead=9.9), other) \
        == jregistry.regress_report("demo", _report(overhead=9.9), other)


def _seed_cli(tmp_path, n=4, **kw):
    bench = tmp_path / "BENCH_demo.json"
    hpath = tmp_path / "experiments" / "bench_history.jsonl"
    hpath.parent.mkdir()
    with hpath.open("w") as f:
        for r in _history(registry, n):
            f.write(json.dumps(r) + "\n")
    bench.write_text(json.dumps(_report(**kw)))
    return str(bench), str(hpath)


@pytest.mark.parametrize("case,code", [
    ("clean", 0), ("regression", 1), ("missing_bench", 2),
    ("not_a_bench", 2), ("malformed_history", 2), ("no_history", 0)])
def test_regress_cli_exits_as_the_reference(tmp_path, capsys, case, code):
    bench, hist = _seed_cli(tmp_path,
                            **({"overhead": 5.0} if case == "regression"
                               else {}))
    if case == "missing_bench":
        bench = str(tmp_path / "BENCH_gone.json")
    elif case == "not_a_bench":
        bench = str(tmp_path / "results.json")
        (tmp_path / "results.json").write_text("{}")
    elif case == "malformed_history":
        with open(hist, "a") as f:
            f.write("not json\n")
    elif case == "no_history":
        hist = str(tmp_path / "none.jsonl")
    argv = ["regress", bench, "--history", hist]
    assert obs_cli(argv) == code
    mine = capsys.readouterr()
    assert jobs_cli(argv) == code
    theirs = capsys.readouterr()
    assert mine.out == theirs.out
    if code == 1:
        assert "FAIL" in mine.out


def test_timeit_returns_timing_and_output():
    t = timeit(lambda x: x + 1, 41, iters=3)
    assert isinstance(t, Timing)
    assert t.out == 42 and t.seconds >= 0.0
    got = timeit(lambda: torch.ones(3), iters=2, warmup=0)
    assert torch.equal(got.out, torch.ones(3))


def test_timeit_reduce_min_and_errors():
    assert timeit(lambda: 7, iters=2, reduce="min").out == 7
    with pytest.raises(ValueError):
        timeit(lambda: 0, iters=0)
    with pytest.raises(ValueError):
        timeit(lambda: 0, reduce="median")
