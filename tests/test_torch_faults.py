"""The fault runtime of the port (``repro_torch.fl.faults``, the deadline and
quarantine policies of ``fl/server.py``, ``fl/client.py``'s cost model) on
the CPU, against the reference's (``repro.fl.faults``, ``repro.fl.server``,
``repro.fl.client``).

Levels:
  * the same ``FaultPlan`` and seed on frames of the same lengths, with
    checksums on: the same fault log (round, client, frame, kind, attempt,
    detail), round stats, ledger summary and arrivals as the reference's
    ``FaultyChannel`` — the knowledge frames are byte-identical, the update
    frames (the port's parameter dict against the reference's tree) equal
    in length. With checksums off a silent corruption's outcome depends on
    the bytes flipped, so there only the port's own determinism (any call
    order) is asserted;
  * a zero-fault plan equals the perfect ``Channel``, ledger and bits;
  * a faulty ``FLSimulation`` draws the same faults, ledger and weights on
    the cohort engine and on the client-by-client loop;
  * deadline, quarantine and ``aggregate``'s masks equal the reference
    server's on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.configs.wrn_cifar import WRNConfig as JWRNConfig
from repro.fl import faults as jfaults
from repro.fl.client import FLClient as JFLClient
from repro.fl.comms import CommLedger as JCommLedger
from repro.fl.server import FLServer as JFLServer
from repro.fl.transport import get_codec as jget_codec
from repro.fl.transport import Channel as JChannel
from repro.models import wrn as jwrn
from repro_torch.configs import FLConfig, get_wrn_config
from repro_torch.core import rounds
from repro_torch.core.split import make_split_wrn
from repro_torch.data import SyntheticImageDataset, partition_k_shards
from repro_torch.fl import faults
from repro_torch.fl.client import FLClient
from repro_torch.fl.comms import CommLedger
from repro_torch.fl.server import FLServer
from repro_torch.fl.simulation import FLSimulation
from repro_torch.fl.transport import Channel, get_codec
from repro_torch.models import wrn
from test_torch_round import one_torch_thread  # noqa: F401

PLAN = dict(drop_rate=0.2, late_crash_rate=0.15, bitflip_rate=0.35,
            truncate_rate=0.2, duplicate_rate=0.2)


@pytest.fixture(scope="module")
def frames():
    """The same payloads for both packages: knowledge triples and a small
    WRN's weights (the port's dict and the reference's tree)."""
    r = np.random.default_rng(0)
    acts = r.normal(size=(10, 12, 4, 4, 3)).astype(np.float32)
    labels = r.integers(0, 10, (10, 12)).astype(np.int32)
    valid = r.random((10, 12)) < 0.6
    tree = jax.tree.map(np.asarray, jwrn.init_wrn(JWRNConfig().reduced(),
                                                  jax.random.PRNGKey(1)))
    return acts, labels, valid, tree, wrn.params_from_jax(tree)


def _drive(ch, acts, labels, valid, params, codec, rounds_=3, order=None):
    """Rounds of every client's knowledge and update frame -> per round
    (log, stats, arrivals)."""
    out = []
    for t in range(rounds_):
        ch.begin_round(t)
        for cid in order or range(len(acts)):
            ch.upload_knowledge(cid, acts[cid], labels[cid], valid[cid],
                                codec)
            ch.upload_update(cid, params)
        out.append(([(e.round_idx, e.client_id, e.frame, e.kind, e.attempt,
                      e.detail) for e in ch.log], ch.round_stats(),
                    [ch.update_arrived(c) for c in range(len(acts))]))
    return out


@pytest.mark.parametrize("codec", ["int8", "raw_f32"])
@pytest.mark.parametrize("seed", [0, 7])
def test_fault_log_matches_the_reference(frames, codec, seed):
    acts, labels, valid, tree, params = frames
    plan = faults.FaultPlan(**PLAN)
    led, jled = CommLedger(), JCommLedger()
    port = _drive(faults.FaultyChannel(led, plan, seed=seed, checksum=True),
                  [torch.from_numpy(a) for a in acts], labels, valid, params,
                  get_codec(codec))
    ref = _drive(jfaults.FaultyChannel(jled, jfaults.FaultPlan(**PLAN),
                                       seed=seed, checksum=True),
                 [jnp.asarray(a) for a in acts], labels, valid, tree,
                 jget_codec(codec))
    assert port == ref
    assert led.summary() == jled.summary()
    s = led.summary()
    assert s["retransmit_up"] > 0 and s["duplicate_up"] > 0
    assert any(not a for _, _, arrived in port for a in arrived)


def test_without_checksums_the_faults_do_not_follow_call_order(frames):
    acts, labels, valid, tree, params = frames
    acts = [torch.from_numpy(a) for a in acts]
    plan = faults.FaultPlan(**PLAN)
    a = faults.FaultyChannel(CommLedger(), plan, seed=3, checksum=False)
    b = faults.FaultyChannel(CommLedger(), plan, seed=3, checksum=False)
    fwd = _drive(a, acts, labels, valid, params, get_codec("int8"))
    rev = _drive(b, acts, labels, valid, params, get_codec("int8"),
                 order=list(range(len(acts)))[::-1])
    for (la, sa, ra), (lb, sb, rb) in zip(fwd, rev):
        assert sorted(la) == sorted(lb) and ra == rb
        assert sa.pop("backoff_s") == pytest.approx(sb.pop("backoff_s"))
        assert sa == sb
    assert a.ledger.summary() == b.ledger.summary()
    assert a.total_silent_corruptions == b.total_silent_corruptions > 0


def test_zero_plan_equals_the_perfect_channel(frames):
    acts, labels, valid, _, params = frames
    zero = faults.FaultyChannel(CommLedger(), faults.FaultPlan(), seed=0,
                                checksum=False)
    perfect = Channel(CommLedger())
    for ch in (zero, perfect):
        ch.begin_round(0)
    for cid in range(len(acts)):
        got = [ch.upload_knowledge(cid, torch.from_numpy(acts[cid]),
                                   labels[cid], valid[cid],
                                   get_codec("int8"))
               for ch in (zero, perfect)]
        assert [t.numpy().tobytes() for t in got[0]] == \
            [t.numpy().tobytes() for t in got[1]]
        assert zero.upload_update(cid, params) and \
            perfect.upload_update(cid, params)
        assert zero.decoded_update(cid) is None
    assert zero.ledger.summary() == perfect.ledger.summary()
    assert zero.round_stats() == perfect.round_stats()
    assert zero.log == []


def test_silent_corruption_hands_the_server_its_decode(frames):
    """Checksums off, every delivery bit-flipped: the frames that decode
    are kept as decoded, on the params' device and in their key order."""
    _, _, _, _, params = frames
    ch = faults.FaultyChannel(CommLedger(), faults.FaultPlan(bitflip_rate=1),
                              seed=1, checksum=False)
    for cid in range(8):
        ch.upload_update(cid, params)
    decoded = [ch.decoded_update(c) for c in range(8)]
    got = [d for d in decoded if d is not None]
    assert got and ch.round_stats()["silent_corruptions"] == len(got)
    for d in got:
        assert list(d) == list(params)
        assert sum(not torch.equal(d[k], params[k]) for k in params) <= 1


@pytest.fixture(scope="module")
def setting():
    cfg = get_wrn_config().reduced()
    train = SyntheticImageDataset(400, image_size=cfg.image_size, seed=0)
    test = SyntheticImageDataset(100, image_size=cfg.image_size, seed=1)
    clients = partition_k_shards(train, 4, k_classes=2, samples_per_client=60)
    return make_split_wrn(cfg), clients, test


def _flcfg(**kw):
    return FLConfig(**{**dict(num_clients=4, clients_per_round=4,
                              local_batch_size=20, pca_components=8,
                              clusters_per_class=3, kmeans_iters=4,
                              meta_epochs=1, meta_batch_size=10,
                              transport_codec="int8",
                              transport_checksum=True), **kw})


def test_engines_draw_the_same_faults(setting):
    model, clients, test = setting
    runs = []
    for knobs in (dict(), dict(distributed_selection=True),
                  dict(selection_chunk_size=3)):
        sim = FLSimulation(model, clients, test, _flcfg(**knobs), seed=0,
                           device="cpu", fault_plan=faults.FaultPlan(**PLAN),
                           fault_seed=3, quarantine_after=1,
                           quarantine_cooldown=1)
        logs = []
        begin = sim.channel.begin_round

        def begin_round(t, _begin=begin, _sim=sim, _logs=logs):
            _logs.append(sorted((e.client_id, e.frame, e.kind, e.attempt,
                                 e.detail) for e in _sim.channel.log))
            _begin(t)

        sim.channel.begin_round = begin_round
        res = sim.run(rounds=3)
        logs.append(sorted((e.client_id, e.frame, e.kind, e.attempt,
                            e.detail) for e in sim.channel.log))
        runs.append((logs, res.comm, res.drops, res.retransmits,
                     res.corruptions_detected, res.quarantined,
                     res.test_acc, res.metadata_counts,
                     {k: v.numpy().tobytes()
                      for k, v in sim.server.global_params.items()}))
    assert runs[0] == runs[1] == runs[2]
    logs, comm, drops, retrans, detected, quarantined = runs[0][:6]
    assert sum(drops) > 0 and sum(detected) > 0 and comm["retransmit_up"] > 0
    assert sum(quarantined) > 0
    assert sum(len(lg) for lg in logs) > 0


def test_zero_plan_simulation_equals_the_perfect_wire(setting):
    model, clients, test = setting
    runs = []
    for plan in (None, faults.FaultPlan()):
        sim = FLSimulation(model, clients, test, _flcfg(), seed=0,
                           device="cpu", fault_plan=plan, fault_seed=7)
        res = sim.run(rounds=2)
        runs.append((res.comm, res.test_acc, res.metadata_counts,
                     res.drops, res.retransmits,
                     {k: v.numpy().tobytes()
                      for k, v in sim.server.global_params.items()}))
    assert runs[0] == runs[1]
    assert runs[0][3] == [0, 0] and runs[0][4] == [0, 0]


def test_deadline_quarantine_and_masks_match_the_reference(setting):
    model, clients, _ = setting
    jcfg = JFLConfig(num_clients=4, clients_per_round=3)
    cfg = FLConfig(num_clients=4, clients_per_round=3)
    for deadline, times in [(None, [1.0, 9.0]), (10.0, [1.0, 2.0]),
                            (1.0, [2.0, 3.0]), (2.5, [1.0, 3.0, 2.0, 9.0])]:
        got = FLServer(None, None, None, cfg,
                       deadline=deadline).straggler_mask(times)
        want = JFLServer(None, None, None, jcfg,
                         deadline=deadline).straggler_mask(times)
        assert (got is None and want is None) or got.tolist() == \
            want.tolist()
    srv = FLServer(None, None, None, cfg, quarantine_after=2,
                   quarantine_cooldown=2)
    jsrv = JFLServer(None, None, None, jcfg, quarantine_after=2,
                     quarantine_cooldown=2)
    history = [([0, 1], [False, True]), ([0, 2], [False, False]),
               ([2, 3], [False, True]), ([0, 1], [True, False]),
               ([1, 2], [False, True])]
    for r, (ids, ok) in enumerate(history):
        for s in (srv, jsrv):
            s.round_idx = r
            s.record_arrivals(ids, ok)
        assert srv.eligible_clients(5) == jsrv.eligible_clients(5)
        assert srv.num_quarantined(5) == jsrv.num_quarantined(5)
        assert srv.fail_streak == jsrv.fail_streak
        assert srv.quarantined_until == jsrv.quarantined_until
    # sampling over the eligible clients never picks a quarantined one,
    # and with nobody quarantined it is the plain cohort draw
    srv.round_idx = 3
    draws = rounds.GeneratorDraws(torch.Generator().manual_seed(0))
    held = set(range(5)) - set(srv.eligible_clients(5))
    assert held
    for _ in range(5):
        assert not held & set(srv.sample_clients(5, draws).tolist())
    free = FLServer(None, None, None, cfg)
    a = rounds.GeneratorDraws(torch.Generator().manual_seed(4))
    b = rounds.GeneratorDraws(torch.Generator().manual_seed(4))
    assert free.sample_clients(5, a).tolist() == b.cohort(5, 3).tolist()
    # local times of the cost model
    for speed in (0.5, 2.0):
        assert FLClient(clients[0], speed).local_time(cfg, 1e9) == \
            JFLClient(clients[0], speed).local_time(jcfg, 1e9)

    # aggregate: stragglers and arrivals zero-weight the same clients; a
    # round where nothing counts keeps W_G(t-1)
    jm = jwrn.make_split_wrn(JWRNConfig().reduced())
    jparams = jm.init(jax.random.PRNGKey(0))
    params = wrn.params_from_jax(jax.tree.map(np.asarray, jparams))
    jcp = [jax.tree.map(lambda a, i=i: a + np.float32(i), jparams)
           for i in range(3)]
    cp = [{k: v + np.float32(i) for k, v in params.items()}
          for i in range(3)]
    masks = [(np.array([True, False, False]), np.array([True, True, False])),
             (None, np.array([True, False, True])),
             (np.array([False, True, False]), None),
             (None, np.array([False, False, False]))]
    for stragglers, arrived in masks:
        jres = JFLServer(jm, jparams, jm.split(jparams)[1], jcfg).aggregate(
            jcp, [None] * 3, jax.random.PRNGKey(2), stragglers=stragglers,
            arrived=arrived)
        res = FLServer(model, params, model.split(params)[1], cfg).aggregate(
            cp, [None] * 3, draws, stragglers=stragglers, arrived=arrived)
        for a, b in zip(jax.tree.leaves(wrn.params_to_jax(res.global_params)),
                        jax.tree.leaves(jres.global_params)):
            assert a.tobytes() == np.asarray(b).tobytes()
        assert res.metadata_count == jres.metadata_count == 0


def test_perfect_channel_fault_surface_is_a_no_op():
    ch, jch = Channel(CommLedger()), JChannel(JCommLedger())
    ch.begin_round(3)
    assert ch.update_arrived(5) and ch.decoded_update(5) is None
    assert ch.round_stats() == jch.round_stats()
