"""Observability of the port (``repro_torch.obs``) on the CPU, against the
reference's (``repro.obs``).

Levels:
  * exact: the metrics registry's snapshot after the same operations;
    the trace file format — each package's ``load_trace`` reads the
    other's traces, and both packages' ``span_paths`` / ``to_chrome`` agree
    on them; the CLI's exit codes (``summarize`` / ``export-chrome`` /
    ``diff``);
  * bit-identical: an ``FLSimulation`` run with ``observability=True``
    against the same run with it off (weights, ledger, accuracies), on the
    client loop and on the cohort engine under the chaos wire, with every
    ledger byte attributed to a span and the fault log mirrored into the
    trace's counters;
  * the null hooks: off, every hook is a shared singleton and
    ``Span.sync`` never synchronizes; inside a CUDA graph capture a live
    span's ``sync`` does nothing and marks the span ``captured``.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.fl.comms import CommLedger as JCommLedger
from repro_torch import obs
from repro_torch.configs import FLConfig, get_wrn_config
from repro_torch.core.split import make_split_wrn
from repro_torch.data import SyntheticImageDataset, partition_k_shards
from repro_torch.fl.comms import CommLedger
from repro_torch.fl.faults import FaultPlan
from repro_torch.fl.simulation import FLSimulation
from repro_torch.obs import __main__ as cli
from repro_torch.obs import tracer as tracer_mod
from test_torch_round import one_torch_thread  # noqa: F401

KNOBS = dict(num_clients=4, clients_per_round=4, local_batch_size=20,
             pca_components=8, clusters_per_class=3, kmeans_iters=4,
             meta_epochs=1, meta_batch_size=10, transport_codec="int8")


def _drive(o, ledger_cls):
    """The same spans, events, metrics and ledger charges on a package's
    ``obs``: returns its tracer and ledger."""
    tr = o.Tracer(meta={"run": "drive"})
    led = o.MeteredLedger(tr)
    with o.use_tracer(tr):
        led.download("weights", 100, frames=2)           # unattributed
        with o.span("round", round=0) as rsp:
            with o.span("client", client=3):
                led.upload("metadata", 40)
                o.event("selection_sketch", client=3, selected=2)
                with o.timed_block("kernel.x", n=4) as sp:
                    sp.sync(None)
            led.upload("weights", 60)
            o.inc("fault.retransmits")
            o.inc("fault.retransmits", 2)
            o.gauge("fl.quarantined", 1)
            tr.metrics.histogram("h").observe(2.0)
            tr.metrics.histogram("h").observe(5.0)
            rsp.set(drops=0)
    assert isinstance(led, ledger_cls)
    return tr, led


def test_metrics_and_attribution_equal_the_reference():
    """Level: exact — snapshot, attribution and the metered ledger."""
    tr, led = _drive(obs, CommLedger)
    jtr, jled = _drive(jobs, JCommLedger)
    assert tr.metrics.snapshot() == jtr.metrics.snapshot()
    assert tr.attributed_bytes() == jtr.attributed_bytes() == {
        "up/metadata": 40, "up/weights": 60}
    assert dict(tr.unattributed) == dict(jtr.unattributed) == {
        "down/weights": 100}
    assert led.summary() == jled.summary()
    assert [sp.name for sp in tr.spans] == [sp.name for sp in jtr.spans]
    rnd = tr.spans[-1]
    assert set(tr.child_durations(rnd)) == {"client"}
    assert obs.NULL_METRICS.snapshot() == jobs.NULL_METRICS.snapshot()


def test_traces_read_across_packages(tmp_path):
    """Level: exact — a trace of either package loads under both; both
    packages summarize it alike."""
    tr, _ = _drive(obs, CommLedger)
    jtr, _ = _drive(jobs, JCommLedger)
    port, ref = str(tmp_path / "port.jsonl"), str(tmp_path / "ref.jsonl")
    tr.write_jsonl(port)
    jtr.write_jsonl(ref)
    for path in (port, ref):
        a, b = obs.load_trace(path), jobs.load_trace(path)
        assert a == b
        assert obs.span_paths(a) == jobs.span_paths(b)
        assert obs.to_chrome(a) == jobs.to_chrome(b)
    assert obs.span_paths(obs.load_trace(port)) == \
        obs.span_paths(obs.load_trace(ref))
    assert obs.SCHEMA == jobs.SCHEMA


def test_load_trace_refuses_bad_files(tmp_path):
    bad = tmp_path / "bad.jsonl"
    for text in ("", '{"type": "header", "schema": "other/v9"}\n',
                 '{"type": "header", "schema": "repro.obs.trace/v1"}\n{'):
        bad.write_text(text)
        with pytest.raises(obs.TraceError):
            obs.load_trace(str(bad))


def test_cli_summarize_export_and_diff(tmp_path, capsys):
    tr, _ = _drive(obs, CommLedger)
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    tr.write_jsonl(a)
    with obs.use_tracer(tr):
        with obs.span("extra"):
            pass
    tr.write_jsonl(b)
    assert cli.main(["summarize", a]) == 0
    out = capsys.readouterr().out
    assert "round/client" in out and "unattributed" in out
    chrome = str(tmp_path / "c.json")
    assert cli.main(["export-chrome", a, chrome]) == 0
    with open(chrome) as f:
        assert len(json.load(f)["traceEvents"]) == 3 + 1
    assert cli.main(["diff", a, a]) == 0
    assert cli.main(["diff", a, b]) == 1
    with pytest.raises(SystemExit) as e:
        cli.main(["summarize", str(tmp_path / "missing.jsonl")])
    assert e.value.code == 2


def test_off_hooks_are_the_null_singletons(monkeypatch):
    """Off: every hook resolves to a shared no-op, and nothing
    synchronizes."""
    monkeypatch.setattr(torch.cuda, "synchronize", _no_sync)
    assert obs.get_tracer() is obs.NULL_TRACER
    sp = obs.span("x", a=1)
    assert sp is obs.NULL_SPAN and obs.timed_block("kernel.y") is sp
    t = torch.ones(2)
    with sp as inner:
        assert inner.sync(t) is t
    obs.event("e", a=1)
    obs.inc("c")
    obs.gauge("g", 2.0)
    assert obs.get_tracer().metrics.counter("c").value == 0
    assert obs.NULL_TRACER.current() is None


def _no_sync(*args, **kwargs):
    raise AssertionError("synchronized")


def test_span_sync_under_capture_marks_the_span(monkeypatch):
    """A live span's ``sync`` on a card tensor during a CUDA graph capture
    does not synchronize (that would break the capture) and marks the span
    ``captured``; outside a capture it synchronizes."""
    synced = []
    monkeypatch.setattr(tracer_mod, "cuda_devices", lambda x: {"cuda:0"})
    monkeypatch.setattr(tracer_mod, "_device_sync", synced.append)
    tr = obs.Tracer()
    t = torch.ones(2)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with obs.use_tracer(tr):
        with obs.span("local_update") as sp:
            assert sp.sync(t) is t
    assert sp.attrs == {"captured": True} and synced == []
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    with obs.use_tracer(tr):
        with obs.span("local_update") as sp:
            sp.sync(t)
    assert "captured" not in sp.attrs and synced == [t]


@pytest.fixture(scope="module")
def setting():
    cfg = get_wrn_config().reduced()
    train = SyntheticImageDataset(400, image_size=cfg.image_size, seed=0)
    test = SyntheticImageDataset(100, image_size=cfg.image_size, seed=1)
    clients = partition_k_shards(train, 4, k_classes=2,
                                 samples_per_client=40)
    return make_split_wrn(cfg), clients, test


@pytest.mark.parametrize("distributed,chaos", [(False, False), (True, True)],
                         ids=["client_loop", "cohort_engine_chaos"])
def test_simulation_tracing_changes_no_bit(setting, distributed, chaos):
    """Level: bit-identical — observability on against off; complete byte
    attribution; the fault log mirrored into counters."""
    model, clients, test = setting
    cfg = FLConfig(**KNOBS, distributed_selection=distributed,
                   transport_checksum=chaos)
    plan = FaultPlan(drop_rate=0.25, bitflip_rate=0.2,
                     duplicate_rate=0.1) if chaos else None
    runs = []
    for on in (False, True):
        sim = FLSimulation(model, clients, test,
                           dataclasses.replace(cfg, observability=on),
                           seed=0, device="cpu", fault_plan=plan,
                           fault_seed=2, quarantine_after=2)
        runs.append((sim, sim.run(rounds=2)))
    (off, roff), (on, ron) = runs
    assert not off.tracer.enabled and on.tracer.enabled
    assert roff.phase_wall_s is None
    assert {k: v.numpy().tobytes() for k, v in
            on.server.global_params.items()} == \
        {k: v.numpy().tobytes() for k, v in off.server.global_params.items()}
    assert ron.comm == roff.comm
    assert (ron.test_acc, ron.fedavg_acc, ron.metadata_counts) == \
        (roff.test_acc, roff.fedavg_acc, roff.metadata_counts)
    tr = on.tracer
    assert dict(tr.unattributed) == {}
    led = on.server.ledger
    assert tr.attributed_bytes() == {
        **{f"up/{k}": v for k, v in led.up.items()},
        **{f"down/{k}": v for k, v in led.down.items()}}
    assert len(ron.phase_wall_s) == 2
    assert set(ron.phase_wall_s[0]) == {"broadcast", "cohort", "aggregate",
                                        "eval"}
    paths = obs.span_paths({"spans": [sp.to_record() for sp in tr.spans]})
    inner = "round/cohort/" + ("select" if distributed else "client/select")
    assert paths[inner]["count"] == (2 if distributed else 8)
    # one sketch a client a round, crashed clients too (they select before
    # the upload that finds them crashed)
    assert sum(e["name"] == "selection_sketch" for e in tr.events) == 8
    counters = tr.metrics.snapshot()["counters"]
    assert counters.get("fault.retransmits", 0) == sum(ron.retransmits)
    if chaos:
        assert sum(ron.drops) + sum(ron.retransmits) > 0
        kinds = [e["name"] for e in tr.events if e["name"].startswith(
            "fault.")]
        assert kinds and all(counters[k] == kinds.count(k)
                             for k in set(kinds))
    snap = tr.metrics.snapshot()["gauges"]
    assert set(snap) == {"fl.quarantined", "fl.stragglers"}
    assert np.isfinite(ron.round_wall_s).all()
