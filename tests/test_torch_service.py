"""The async FL service of the port (``repro_torch.fl.service``) on the CPU,
at the reference's own test setting (tests/test_service.py): WRN-10-1 at
16x16, 4 clients x 40 samples of 2 classes, P = 8, 3 clusters per class.

Levels:
  * exact: the traffic schedules (``PoissonTraffic`` / ``DiurnalTraffic``
    arrivals of the port equal ``repro``'s for several seeds and ticks)
    and ``staleness_weight`` against ``repro``'s;
  * tolerance (2e-3, as tests/test_torch_round.py): a flush of the same
    buffered entries against ``repro``'s ``BufferedAggregator.flush``
    (``repro``'s params carried across, ``repro``'s meta-training draws),
    with equal staleness, |D_M| and failure streaks;
  * bit-identical: the degenerate service (``DegenerateTraffic``, buffer ==
    cohort) against the port's ``FLSimulation`` — weights, ledger,
    accuracies, drops, retransmits, corruptions and quarantine history —
    on the perfect and the chaos wire, on both engines, with the int8
    codec (the cohort engine quantizes a cohort of one per arrival);
    and observability on against off;
  * an asynchronous run (Poisson arrivals, delayed uploads, a weighted
    flush, a drained partial buffer) against ``repro``'s service on the
    same traffic, with the reference's per-tick key chain as the port's
    draws (``JaxChainDraws``) and its initial weights: equal arrivals,
    flush sizes, staleness lists, |D_M| and ledger bytes, weights within
    2e-3, and, traced on both sides, equal span paths (counts and bytes);
  * ``python -m repro_torch.launch.serve_fl --device cpu --sync-check``
    exits 0.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.configs.wrn_cifar import WRNConfig as JWRNConfig
from repro.core import rounds as jrounds
from repro.fl import service as jservice
from repro.fl import transport as JT
from repro.fl.server import FLServer as JFLServer
from repro.models import wrn as jwrn
from repro.obs import load_trace as jload_trace
from repro.obs import span_paths as jspan_paths
from repro_torch import obs
from repro_torch.configs import FLConfig, get_wrn_config
from repro_torch.core import rounds
from repro_torch.core.split import make_split_wrn
from repro_torch.data import SyntheticImageDataset, partition_k_shards
from repro_torch.fl import service
from repro_torch.fl import transport as T
from repro_torch.fl.faults import FaultPlan
from repro_torch.fl.server import FLServer
from repro_torch.fl.simulation import FLSimulation
from repro_torch.launch import serve_fl
from repro_torch.models import wrn
from test_torch_round import jax_first_centres, one_torch_thread  # noqa: F401

TOL = 2e-3
KNOBS = dict(num_clients=4, clients_per_round=4, local_batch_size=20,
             pca_components=8, clusters_per_class=3, kmeans_iters=4,
             meta_epochs=1, meta_batch_size=10)
CHAOS = dict(drop_rate=0.25, bitflip_rate=0.1, truncate_rate=0.05,
             duplicate_rate=0.1)
# an asynchronous schedule at this setting: 5 arrivals over 4 ticks, an
# upload that outlives a flush (staleness 1, so a weighted flush), and a
# partial buffer left for the drain
ASYNC = dict(rate=1.5, seed=6, delay_ticks=2)
ASYNC_TICKS = 4


@pytest.fixture(scope="module")
def setting():
    cfg = get_wrn_config().reduced()
    train = SyntheticImageDataset(400, image_size=cfg.image_size, seed=0)
    test = SyntheticImageDataset(100, image_size=cfg.image_size, seed=1)
    clients = partition_k_shards(train, 4, k_classes=2,
                                 samples_per_client=40)
    return make_split_wrn(cfg), clients, test


def _flcfg(**kw):
    return FLConfig(**{**KNOBS, **kw})


def _weights(params):
    return {k: v.numpy().tobytes() for k, v in params.items()}


def _assert_close(port, ref_tree):
    for a, b in zip(jax.tree.leaves(wrn.params_to_jax(port)),
                    jax.tree.leaves(ref_tree)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)


class _StubServer:
    """Just enough server for the traffic models."""

    def __init__(self, quarantined=()):
        self.q = set(quarantined)

    def eligible_clients(self, num_available):
        return [i for i in range(num_available) if i not in self.q]


# ---- exact: traffic and staleness weights ---------------------------------

@pytest.mark.parametrize("kind,kw,quarantined", [
    ("PoissonTraffic", dict(rate=3.0, seed=7, delay_ticks=2), ()),
    ("PoissonTraffic", dict(rate=0.5, seed=1), ()),
    ("PoissonTraffic", dict(rate=6.0, seed=3, delay_ticks=1), (0, 3)),
    ("DiurnalTraffic", dict(rate=4.0, seed=0, amplitude=1.0, period=24,
                            delay_ticks=3), ()),
    ("DiurnalTraffic", dict(rate=2.0, seed=5, period=7), (1,))])
def test_traffic_schedules_equal_the_reference(kind, kw, quarantined):
    """Level: exact — every tick's arrivals and rate."""
    port, ref = getattr(service, kind)(**kw), getattr(jservice, kind)(**kw)
    srv = _StubServer(quarantined)
    seen = 0
    for t in range(30):
        got = port.arrivals(t, srv, 8, None)
        assert got == ref.arrivals(t, srv, 8, None)
        assert port.rate_at(t) == ref.rate_at(t)
        assert not {a.client_id for a in got} & set(quarantined)
        seen += len(got)
    assert seen > 0


def test_degenerate_traffic_is_the_server_sampler(setting):
    """Level: exact — the cohort ``FLSimulation`` would sample."""
    model, clients, _ = setting
    cfg = _flcfg(clients_per_round=3)
    params = model.init(torch.Generator().manual_seed(0),
                        torch.device("cpu"))
    srv = FLServer(model, params, model.split(params)[1], cfg)
    want = srv.sample_clients(
        4, rounds.GeneratorDraws(torch.Generator().manual_seed(9)))
    got = service.DegenerateTraffic().arrivals(
        0, srv, 4, rounds.GeneratorDraws(torch.Generator().manual_seed(9)))
    assert [a.client_id for a in got] == [int(i) for i in want]
    assert all(a.delay == 0 for a in got)


def test_staleness_weights_equal_the_reference():
    """Level: exact — the discount and a flush's weights."""
    for s in range(12):
        for alpha in (0.0, 0.5, 1.0, 2.5):
            assert service.staleness_weight(s, alpha) == \
                jservice.staleness_weight(s, alpha)
    with pytest.raises(ValueError):
        service.staleness_weight(-1)
    arrived = np.array([True, True, True, False])
    port = service.BufferedAggregator(server=None, buffer_size=4)
    ref = jservice.BufferedAggregator(server=None, buffer_size=4)
    assert port._weights([0, 1, 3, 2], arrived) == \
        ref._weights([0, 1, 3, 2], arrived)
    assert port._weights([0, 0, 0], arrived[:3]) is None


# ---- tolerance: one flush against the reference's ------------------------

class _KeyDraws:
    """Meta-training permutations drawn as ``repro``'s ``meta_train`` draws
    them from ``key``."""

    def __init__(self, key):
        self.key = key

    def meta_perms(self, m, epochs):
        return torch.stack([torch.from_numpy(np.asarray(
            jax.random.permutation(ek, m)).astype(np.int64))
            for ek in jax.random.split(self.key, epochs)])


def test_a_flush_matches_the_reference(setting):
    """Level: tolerance 2e-3 — three entries of staleness 0, 1 and 2, the
    last one's update lost (weight 0), through both aggregators."""
    model, clients, _ = setting
    jm = jwrn.make_split_wrn(JWRNConfig().reduced())
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(0)
    jcps = [jax.tree.map(lambda a: a + 0.01 * rng.standard_normal(
        a.shape).astype(a.dtype), jparams) for _ in range(3)]
    jmetas, metas = [], []
    for i, c in enumerate(clients[:3]):
        acts = np.asarray(jm.apply_lower(jparams, c.data.x[:6]))
        valid = np.arange(6) % (i + 2) != 0
        jmetas.append(JT.SelectedKnowledge.decode(JT.SelectedKnowledge(
            acts, c.data.y[:6], valid, JT.get_codec("raw_f32")).encode()))
        metas.append(T.SelectedKnowledge.decode(T.SelectedKnowledge(
            torch.from_numpy(acts), c.data.y[:6], valid,
            T.get_codec("raw_f32")).encode()))
    versions, arrived = (5, 4, 3), (True, True, False)
    key = jax.random.PRNGKey(11)

    jsrv = JFLServer(jm, jparams, jm.split(jparams)[1],
                     JFLConfig(batched_selection=False, **KNOBS))
    jsrv.round_idx = 5
    jagg = jservice.BufferedAggregator(jsrv, buffer_size=3)
    params = wrn.params_from_jax(jparams)
    srv = FLServer(model, params, model.split(params)[1], _flcfg())
    srv.round_idx = 5
    agg = service.BufferedAggregator(srv, buffer_size=3)
    for i in range(3):
        assert jagg.submit(jservice.BufferEntry(
            i, jcps[i], jmetas[i], versions[i], arrived[i], 0)) == (i == 2)
        assert agg.submit(service.BufferEntry(
            i, wrn.params_from_jax(jcps[i]), metas[i], versions[i],
            arrived[i], 0)) == (i == 2)
    jrr, jstale = jagg.flush(key, 1)
    rr, stale = agg.flush(_KeyDraws(key), 1)
    assert stale == jstale == [0, 1, 2]
    assert rr.metadata_count == jrr.metadata_count > 0
    assert srv.round_idx == jsrv.round_idx == 6
    assert srv.fail_streak == jsrv.fail_streak == {2: 1}
    assert agg.pending() == jagg.pending() == 0
    _assert_close(rr.global_params, jrr.global_params)
    _assert_close(rr.composed_params, jrr.composed_params)


# ---- bit-identical: the degenerate service is the simulator ---------------

ROUNDS = 3


def _pair(setting, cfg, plan=None, tracer_on=False):
    """FLSimulation for ROUNDS rounds and the degenerate service for as
    many ticks, from one seed, faults and quarantine as the reference's
    test pairs them."""
    model, clients, test = setting
    kw = dict(seed=0, device="cpu", fault_plan=plan, fault_seed=5,
              quarantine_after=2, quarantine_cooldown=2)
    sim = FLSimulation(model, clients, test, cfg, **kw)
    sres = sim.run(rounds=ROUNDS, eval_every=1)
    svc = service.FLService(
        model, clients, test,
        dataclasses.replace(cfg, observability=tracer_on),
        traffic=service.DegenerateTraffic(),
        buffer_size=cfg.clients_per_round, **kw)
    vres = svc.run(ticks=ROUNDS, eval_every=1)
    return sim, sres, svc, vres


@pytest.mark.parametrize("distributed", [False, True],
                         ids=["client_loop", "cohort_engine"])
@pytest.mark.parametrize("wire", ["perfect", "chaos"])
def test_degenerate_service_is_the_simulator(setting, distributed, wire):
    """Level: bit-identical — weights, ledger, accuracies, |D_M|, fault
    counters and quarantine history."""
    chaos = wire == "chaos"
    cfg = _flcfg(transport_codec="int8", transport_checksum=chaos,
                 distributed_selection=distributed)
    plan = FaultPlan(**CHAOS) if chaos else None
    sim, sres, svc, vres = _pair(setting, cfg, plan)
    assert _weights(svc.server.global_params) == \
        _weights(sim.server.global_params)
    assert vres.comm == {k: v for k, v in sres.comm.items()
                         if k != "total_samples"}
    assert vres.test_acc == sres.test_acc
    assert vres.fedavg_acc == sres.fedavg_acc
    assert vres.metadata_counts == sres.metadata_counts
    assert vres.drops == sres.drops
    assert vres.retransmits == sres.retransmits
    assert vres.corruptions_detected == sres.corruptions_detected
    assert vres.quarantined == sres.quarantined
    assert svc.server.quarantined_until == sim.server.quarantined_until
    assert vres.flushes == ROUNDS and vres.mean_staleness == 0.0
    assert len(vres.tick_wall_s) == ROUNDS
    if chaos:
        assert sum(vres.drops) + sum(vres.retransmits) > 0


def test_service_tracing_changes_no_bit(setting):
    """Level: bit-identical — the degenerate service traced (chaos wire,
    cohort engine) against the untraced simulator; every ledger byte
    attributed to a span."""
    cfg = _flcfg(transport_codec="int8", transport_checksum=True,
                 distributed_selection=True)
    sim, sres, svc, vres = _pair(setting, cfg, FaultPlan(**CHAOS),
                                 tracer_on=True)
    assert svc.tracer.enabled and not sim.tracer.enabled
    assert _weights(svc.server.global_params) == \
        _weights(sim.server.global_params)
    assert vres.comm == {k: v for k, v in sres.comm.items()
                         if k != "total_samples"}
    assert vres.test_acc == sres.test_acc
    assert dict(svc.tracer.unattributed) == {}
    led = svc.server.ledger
    assert svc.tracer.attributed_bytes() == {
        **{f"up/{k}": v for k, v in led.up.items()},
        **{f"down/{k}": v for k, v in led.down.items()}}
    snap = svc.tracer.metrics.snapshot()
    assert snap["counters"].get("fault.retransmits", 0) == \
        sum(vres.retransmits)
    names = {sp.name for sp in svc.tracer.spans}
    assert {"service.tick", "service.buffer_flush", "transport",
            "local_update", "select", "aggregate", "meta_train"} <= names


# ---- against the reference's service: an asynchronous run -----------------

class JaxChainDraws:
    """The port's ``Draws``, answered with the draws ``repro``'s
    ``FLService`` takes from its key chain: per tick ``key, k_round,
    k_sample = split(key, 3)``; the arrivals' keys ``split(k_round, n)``,
    in arrival order; flush f of the tick from ``fold_in(k_round, n)``,
    folded again with f past the first."""

    def __init__(self, key):
        self.key, self.tick = key, None

    def locate(self, tick, arrivals=None, flush=0):
        if tick != self.tick:
            self.key, self.k_round, self.k_sample = jax.random.split(
                self.key, 3)
            self.tick, self.next = tick, 0
        if arrivals is not None:
            self.keys = (jax.random.split(self.k_round, arrivals)
                         if arrivals else None)
            self.k_server = jax.random.fold_in(self.k_round, arrivals)
        self.flush = flush

    def cohort(self, num_available, m):
        return np.asarray(jax.random.choice(self.k_sample, num_available,
                                            (m,), replace=False))

    def client(self, position, client, num_classes, epochs):
        k_sel, k_loc = jax.random.split(self.keys[self.next])
        self.next += 1
        first = jax_first_centres(k_sel, client.data.y, num_classes)
        perms = np.asarray(jrounds.epoch_permutations(
            k_loc, len(client.data), epochs))
        return rounds.ClientDraws(torch.from_numpy(first),
                                  torch.from_numpy(perms.astype(np.int64)))

    def meta_perms(self, m, epochs):
        key = (self.k_server if self.flush == 0
               else jax.random.fold_in(self.k_server, self.flush))
        return _KeyDraws(key).meta_perms(m, epochs)


@pytest.fixture(scope="module")
def async_pair(setting, tmp_path_factory):
    """One traced asynchronous run of each package from the reference's
    seed-0 weights and key chain, on the same traffic."""
    model, clients, test = setting
    jm = jwrn.make_split_wrn(JWRNConfig().reduced())
    jsvc = jservice.FLService(
        jm, clients, test,
        JFLConfig(batched_selection=False, observability=True, **KNOBS),
        seed=0, traffic=jservice.PoissonTraffic(**ASYNC), buffer_size=2)
    jres = jsvc.run(ticks=ASYNC_TICKS, eval_every=100, drain=True)

    svc = service.FLService(model, clients, test,
                            _flcfg(observability=True), seed=0,
                            device="cpu",
                            traffic=service.PoissonTraffic(**ASYNC),
                            buffer_size=2)
    k_init, k_chain = jax.random.split(jax.random.PRNGKey(0))
    params = wrn.params_from_jax(jax.tree.map(np.asarray, jm.init(k_init)))
    svc.server.global_params = params
    svc.server.upper_init = model.split(params)[1]
    svc.draws = JaxChainDraws(k_chain)
    res = svc.run(ticks=ASYNC_TICKS, eval_every=100, drain=True)
    out = tmp_path_factory.mktemp("traces")
    jsvc.tracer.write_jsonl(str(out / "repro.jsonl"))
    svc.tracer.write_jsonl(str(out / "port.jsonl"))
    return dict(jsvc=jsvc, jres=jres, svc=svc, res=res,
                jtrace=str(out / "repro.jsonl"),
                trace=str(out / "port.jsonl"))


def test_async_run_matches_the_reference(async_pair):
    """Level: equal schedule, staleness and ledger bytes; weights within
    2e-3."""
    res, jres = async_pair["res"], async_pair["jres"]
    assert res.arrivals_per_tick == jres.arrivals_per_tick
    assert res.flush_sizes == jres.flush_sizes
    assert res.flush_staleness == jres.flush_staleness
    assert res.metadata_counts == jres.metadata_counts
    assert res.comm == jres.comm
    assert res.flushes == jres.flushes == 3
    assert res.mean_staleness == jres.mean_staleness > 0
    assert len(res.test_acc) == len(jres.test_acc) == 1
    _assert_close(async_pair["svc"].server.global_params,
                  async_pair["jsvc"].server.global_params)
    np.testing.assert_allclose(res.client_loss, jres.client_loss,
                               rtol=TOL, atol=TOL)
    weighted = [sp.attrs["weighted"] for sp in async_pair["svc"].tracer.spans
                if sp.name == "service.buffer_flush"]
    assert weighted == [0, 1, 0]


def test_async_traces_read_across_and_have_the_reference_paths(async_pair):
    """Level: exact — each package's ``load_trace`` reads the other's
    trace, and the span paths of the port's sequential run equal the
    reference's (``batched_selection=False``): counts and bytes. No path
    differs by design on the CPU (the port's ``kernel.*`` spans open only
    where a CUDA kernel launches; the reference's only for Pallas
    selection, which is off); the events and counters are the same,
    the recompile sentinel's included: each package's ``compile.<name>``
    counts and signature counters by name, and its ``compile`` events by
    function (a signature's hash hashes each package's own spelling of
    it, so the hashes differ by design). One name differs by design and
    does not show here: the port's ``compile.local_update_stack`` counts
    each CUDA graph capture of the LocalUpdate, on either engine and only
    on the card, where the reference's counts its cohort engine's
    compiled stack."""
    port = obs.load_trace(async_pair["trace"])
    ref = jload_trace(async_pair["jtrace"])
    assert obs.span_paths(port) == jspan_paths(jload_trace(
        async_pair["trace"]))
    assert jspan_paths(ref) == obs.span_paths(obs.load_trace(
        async_pair["jtrace"]))
    assert obs.span_paths(port) == obs.span_paths(ref)
    assert port["metrics"]["unattributed"] == {}
    def counters(tr):
        """The counters with each signature counter's hash taken out:
        compile.<name>.<hash> -> compile.<name>.*, summed."""
        out = {}
        for k, v in tr["metrics"]["snapshot"]["counters"].items():
            parts = k.split(".")
            if parts[0] == "compile" and len(parts) == 3:
                k = f"compile.{parts[1]}.*"
            out[k] = out.get(k, 0) + v
        return out

    port_counters, ref_counters = counters(port), counters(ref)
    assert port_counters == ref_counters
    # the functions both wrap, and the sentinel saw each compile once
    assert port_counters["compile.select_metadata"] == 1

    def events(tr):
        return sorted((e["name"], e["attrs"].get("client"),
                       e["attrs"].get("fn")) for e in tr["events"])

    assert events(port) == events(ref)


def test_staleness_accrues_and_quarantine_leaves_the_pool(setting):
    """The async regime of the port alone: delayed uploads survive flushes
    (staleness > 0), and a client that keeps crashing is quarantined and
    stops arriving."""
    model, clients, test = setting
    svc = service.FLService(
        model, clients, test, _flcfg(transport_checksum=True), seed=0,
        device="cpu", traffic=service.PoissonTraffic(rate=3.0, seed=2,
                                                     delay_ticks=2),
        buffer_size=2, fault_plan=FaultPlan(drop_rate=1.0), fault_seed=1,
        quarantine_after=1, quarantine_cooldown=3)
    res = svc.run(ticks=5, eval_every=100, drain=True)
    assert max(res.quarantined) > 0
    assert res.flushes > 0 and res.test_acc
    assert any(s > 0 for fl in res.flush_staleness for s in fl)


def test_serve_fl_sync_check_on_the_cpu(tmp_path, capsys):
    """``serve_fl --device cpu --sync-check`` exits 0 (weights and ledger
    of the degenerate service equal the simulator's), and its ``--trace``
    loads back."""
    trace = str(tmp_path / "t.jsonl")
    assert serve_fl.main(["--device", "cpu", "--ticks", "2",
                          "--sync-check", "--trace", trace]) == 0
    out = capsys.readouterr().out
    assert "sync-check weights=OK ledger=OK" in out
    paths = obs.span_paths(obs.load_trace(trace))
    assert paths["service.tick"]["count"] == 2
