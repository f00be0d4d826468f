"""The cohort engine (``repro_torch.core.distributed``) on the CPU,
WRN-10-1 at 16x16, 4 non-IID clients x 80 samples, P=12.

Levels:
  * against the port's own client-by-client ``run_cohort``: bit for bit —
    ledger summary, every decoded knowledge frame, client params, losses,
    Lloyd sweeps, and the round's W_G(t) / M_COM(t) — under the int8 and
    raw f32 codecs, with ``selection_chunk_size`` 0, 1 and 3 (accepted
    and a no-op: every engine selects one client at a time), with the
    randomized PCA, on a ragged cohort too, and with the Table 2 baseline
    left on the loop;
  * against the reference's sequential ``run_round``
    (``batched_selection=False``) with its own draws (``JaxDraws``): the
    levels of tests/test_torch_round.py — ledger bytes and |D_M| equal,
    W_G(t) / M_COM(t) / losses within 2e-3. (The reference's chunked and
    sharded engines are not the oracle: their own tests are red.)
  * the owner of the captured SGD steps (``fedavg.CapturedSteps``): one
    capture a set of shapes, all freed on ``release``, which a round and
    an ``FLSimulation`` run call when they end.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.configs.wrn_cifar import WRNConfig as JWRNConfig
from repro.core import rounds as jrounds
from repro.fl.comms import CommLedger as JCommLedger
from repro.models import wrn as jwrn
from repro_torch.configs import FLConfig, get_wrn_config
from repro_torch.core import distributed as D
from repro_torch.core import fedavg as fa
from repro_torch.core import rounds
from repro_torch.core.split import make_split_wrn
from repro_torch.data import SyntheticImageDataset, partition_k_shards
from repro_torch.fl.comms import CommLedger
from repro_torch.fl.transport.channel import Channel
from repro_torch.models import wrn
from test_torch_round import JaxDraws, one_torch_thread  # noqa: F401

TOL = 2e-3
KNOBS = dict(num_clients=4, clients_per_round=4, local_epochs=1,
             local_batch_size=20, local_lr=0.05, pca_components=12,
             clusters_per_class=3, kmeans_iters=10, meta_epochs=2,
             meta_batch_size=8, meta_lr=0.05, transport_codec="int8")
CODECS = ("int8", "raw_f32")


@pytest.fixture(scope="module")
def setting():
    cfg_w = get_wrn_config().reduced()
    train = SyntheticImageDataset(500, image_size=cfg_w.image_size,
                                  modes_per_class=3, seed=4)
    clients = partition_k_shards(train, num_clients=4, k_classes=2,
                                 samples_per_client=80, seed=4)
    return make_split_wrn(cfg_w), clients


class _Recording(Channel):
    """The perfect wire, keeping every decoded knowledge triple's bytes
    by client id."""

    def __init__(self, ledger):
        super().__init__(ledger)
        self.seen = {}

    def upload_knowledge(self, client_id, *args, **kw):
        got = super().upload_knowledge(client_id, *args, **kw)
        self.seen[client_id] = [t.numpy().tobytes() for t in got]
        return got


def _round(model, clients, **knobs):
    """One round from seed 5 -> (RoundResult, ledger summary, decoded
    frames, client params, losses, sweeps)."""
    cfg = FLConfig(**{**KNOBS, **knobs})
    gen = torch.Generator().manual_seed(5)
    params = model.init(gen, torch.device("cpu"))
    draws = rounds.GeneratorDraws(gen)
    ledger = CommLedger()
    channel = _Recording(ledger)
    cparams, metas, losses, sweeps = rounds.run_cohort(
        model, params, clients, cfg, draws, channel, 10,
        client_ids=[2, 0, 3, 1])
    res = rounds.server_round(model, params, model.split(params)[1], cparams,
                              metas, cfg, draws)
    return res, ledger.summary(), channel.seen, cparams, losses, sweeps


def _bytes(params):
    return {k: v.numpy().tobytes() for k, v in params.items()}


@pytest.fixture(scope="module")
def sequential(setting):
    """The client loop's round under each codec, run once."""
    return {codec: _round(*setting, transport_codec=codec)
            for codec in CODECS}


def _same_round(got, want):
    res, led, seen, cparams, losses, sweeps = got
    sres, sled, sseen, scparams, slosses, ssweeps = want
    assert led == sled and seen == sseen
    assert losses == slosses and sweeps == ssweeps
    for a, b in zip(cparams, scparams):
        assert _bytes(a) == _bytes(b)
    assert _bytes(res.global_params) == _bytes(sres.global_params)
    assert _bytes(res.composed_params) == _bytes(sres.composed_params)
    assert res.metadata_count == sres.metadata_count


def _spy(monkeypatch):
    """Count the cohort engine's calls."""
    called = []
    engine = D.cohort_round
    monkeypatch.setattr(D, "cohort_round",
                        lambda *a, **k: called.append(1) or engine(*a, **k))
    return called


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("knobs", [
    dict(distributed_selection=True),
    dict(distributed_selection=True, selection_chunk_size=1),
    dict(distributed_selection=True, selection_chunk_size=3),
    dict(selection_chunk_size=2)])
def test_cohort_engine_bit_identical_to_the_client_loop(setting, sequential,
                                                        monkeypatch, knobs,
                                                        codec):
    model, clients = setting
    called = _spy(monkeypatch)
    got = _round(model, clients, transport_codec=codec, **knobs)
    assert bool(called) == knobs.get("distributed_selection", False)
    _same_round(got, sequential[codec])


def test_engines_bit_identical_with_the_randomized_solver(setting,
                                                          monkeypatch):
    """``pca_solver="randomized"``: the cohort engine, with every client's
    selection on the one fixed test matrix, gives the client loop's
    bits."""
    model, clients = setting
    called = _spy(monkeypatch)
    got = _round(model, clients, pca_solver="randomized",
                 distributed_selection=True)
    assert called
    want = _round(model, clients, pca_solver="randomized")
    _same_round(got, want)
    assert got[1]["up"]["metadata"] > 0


def test_ragged_cohort_runs_on_the_engine(setting, monkeypatch):
    """Clients of 80, 60, 80 and 45 samples: only the selected maps are
    stacked, so the engine takes the cohort and matches the loop."""
    model, clients = setting
    ragged = list(clients)
    for i, n in ((1, 60), (3, 45)):
        c = ragged[i]
        ragged[i] = type(c)(c.client_id, c.data.subset(np.arange(n)),
                            c.classes)
    called = _spy(monkeypatch)
    got = _round(model, ragged, distributed_selection=True)
    assert called
    _same_round(got, _round(model, ragged))


def test_baseline_without_selection_stays_on_the_loop(setting, monkeypatch):
    """The Table 2 baseline (every map uploaded) runs client by client
    whatever ``distributed_selection`` says."""
    model, clients = setting
    called = _spy(monkeypatch)
    got = _round(model, clients, use_selection=False,
                 distributed_selection=True)
    assert not called
    _same_round(got, _round(model, clients, use_selection=False))


def test_cohort_engine_holds_to_the_reference_round(setting):
    model, clients = setting
    key = jax.random.PRNGKey(3)
    k_init, k_round = jax.random.split(key)
    jm = jwrn.make_split_wrn(JWRNConfig().reduced())
    jparams = jm.init(k_init)
    jled = JCommLedger()
    jres = jrounds.run_round(jm, jparams, jm.split(jparams)[1], clients,
                             JFLConfig(batched_selection=False, **KNOBS),
                             k_round, ledger=jled, num_classes=10)
    params = wrn.params_from_jax(jax.tree.map(np.asarray, jparams))
    led = CommLedger()
    res = rounds.run_round(
        model, params, model.split(params)[1], clients,
        FLConfig(distributed_selection=True, **KNOBS),
        JaxDraws(k_round, len(clients)), ledger=led, num_classes=10)
    assert led.summary() == jled.summary()
    assert res.metadata_count == jres.metadata_count
    np.testing.assert_allclose(res.client_losses, jres.client_losses,
                               rtol=TOL, atol=TOL)
    for port, ref in [(res.global_params, jres.global_params),
                      (res.composed_params, jres.composed_params)]:
        for a, b in zip(jax.tree.leaves(wrn.params_to_jax(port)),
                        jax.tree.leaves(ref)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)


class _Step:
    """Stands in for ``fedavg.CapturedStep`` (the CPU captures nothing):
    counts captures and resets."""
    made, resets = [], []

    def __init__(self, *args):
        _Step.made.append(self)
        self.graph = self

    def reset(self):
        _Step.resets.append(self)


def test_captured_steps_capture_once_a_shape_and_release_all(monkeypatch):
    monkeypatch.setattr(fa, "CapturedStep", _Step)
    _Step.made, _Step.resets = [], []
    params = {"w": torch.zeros(3, 2)}
    x, y = torch.zeros(10, 4), torch.zeros(10, dtype=torch.int64)
    order = torch.zeros(5, 2, dtype=torch.int64)
    loss = object()
    steps = fa.CapturedSteps()
    first = steps.get(params, 0.1, x, y, order, loss)
    assert steps.get(params, 0.1, x, y, order, loss) is first
    other = steps.get(params, 0.1, x[:8], y[:8], order[:4], loss)
    assert other is not first and len(steps) == 2
    assert steps.get(params, 0.2, x, y, order, loss) is not first
    steps.release()
    assert len(steps) == 0 and len(_Step.resets) == 3
    assert steps.get(params, 0.1, x, y, order, loss) is not first


@pytest.mark.parametrize("owner", ["run_round", "FLSimulation.run"])
def test_owners_release_their_captured_steps(setting, monkeypatch, owner):
    """A round and a simulation run free their captured steps when they
    end, and hand the same owner to every client of the run."""
    from repro_torch.data import SyntheticImageDataset
    from repro_torch.fl.simulation import FLSimulation
    model, clients = setting
    released, seen = [], []
    release = fa.CapturedSteps.release
    monkeypatch.setattr(fa.CapturedSteps, "release",
                        lambda self: released.append(self) or release(self))
    update = fa.client_update
    monkeypatch.setattr(fa, "client_update", lambda *a: seen.append(a[-1])
                        or update(*a))
    cfg = FLConfig(**{**KNOBS, "distributed_selection": True})
    if owner == "run_round":
        gen = torch.Generator().manual_seed(5)
        params = model.init(gen, torch.device("cpu"))
        rounds.run_round(model, params, model.split(params)[1], clients,
                         cfg, rounds.GeneratorDraws(gen))
    else:
        test = SyntheticImageDataset(40, image_size=16, seed=1)
        FLSimulation(model, clients, test, cfg, seed=0,
                     device="cpu").run(rounds=2)
    assert len(released) == 1
    assert len(seen) == len(clients) * (1 if owner == "run_round" else 2)
    assert all(s is released[0] for s in seen)


def test_fedavg_forms_match_the_reference():
    """Eq. 2 unweighted and weighted (a 0 weight leaves a client out)
    against ``repro.core.fedavg`` on the same numbers, bit for bit."""
    from repro.core import fedavg as jfa
    from repro_torch.core import fedavg as fa
    r = np.random.default_rng(0)
    cps = [{"a": r.normal(size=(3, 4)).astype(np.float32),
            "b": r.normal(size=5).astype(np.float32)} for _ in range(3)]
    tcps = [{k: torch.from_numpy(v) for k, v in c.items()} for c in cps]
    for w in (None, [0.5, 0.0, 2.0], [1.0, 1.0, 1.0]):
        got = fa.weight_average(tcps, weights=w)
        want = jfa.weight_average(cps, weights=w)
        for k in got:
            assert got[k].numpy().tobytes() == np.asarray(want[k]).tobytes()
