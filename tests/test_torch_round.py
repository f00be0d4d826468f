"""The whole slice on the CPU: one round of the port
(``repro_torch.core.rounds.run_round``) against the reference's sequential
``repro.core.rounds.run_round`` (``batched_selection=False``), WRN-10-1 at
16x16, 2 non-IID clients x 100 samples, P=16, 4 clusters per class, the
int8 codec, with every one of the reference's draws passed in (initial
weights, first centres, LocalUpdate and meta-training permutations).

Levels: selections as in test_torch_selection (valid equal, >= 99% of the
indices equal); knowledge frames of equal length whose int8 codes differ by
at most one level (the maps themselves agree to f32 rounding), and
byte-identical when both codecs quantize the same maps; ledger bytes per
category equal; W_G(t) and M_COM(t) allclose 2e-3; test accuracy within one
sample in a hundred.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.configs.wrn_cifar import WRNConfig as JWRNConfig
from repro.core.compose import evaluate as jevaluate
from repro.core import rounds as jrounds
from repro.core.selection import select_metadata as jselect
from repro.fl import transport as JT
from repro.fl.comms import CommLedger as JCommLedger
from repro.models import wrn as jwrn
from repro_torch.configs import FLConfig, get_wrn_config
from repro_torch.core import rounds
from repro_torch.core.compose import evaluate
from repro_torch.core.selection import select_metadata
from repro_torch.core.split import make_split_wrn
from repro_torch.data import SyntheticImageDataset, partition_k_shards
from repro_torch.fl import transport as T
from repro_torch.fl.comms import CommLedger
from repro_torch.fl.simulation import FLSimulation
from repro_torch.models import wrn

TOL = 2e-3
KNOBS = dict(num_clients=2, clients_per_round=2, local_epochs=1,
             local_batch_size=25, local_lr=0.05, pca_components=16,
             clusters_per_class=4, kmeans_iters=25, meta_epochs=3,
             meta_batch_size=8, meta_lr=0.05, transport_codec="int8")


def jax_first_centres(key, labels, num_classes):
    keys = jax.random.split(key, num_classes)
    lab = jnp.asarray(labels)
    return np.asarray([int(jax.random.categorical(
        keys[c], jnp.where(lab == c, 0.0, -jnp.inf)))
        for c in range(num_classes)], np.int64)


class JaxDraws:
    """The port's ``Draws`` protocol, answered with exactly the draws the
    reference's ``run_round`` makes from ``key``."""

    def __init__(self, key, n_clients):
        self.keys = jax.random.split(key, n_clients + 1)

    def client(self, position, client, num_classes, epochs):
        k_sel, k_loc = jax.random.split(self.keys[position])
        first = jax_first_centres(k_sel, client.data.y, num_classes)
        perms = np.asarray(jrounds.epoch_permutations(
            k_loc, len(client.data), epochs))
        return rounds.ClientDraws(torch.from_numpy(first),
                                  torch.from_numpy(perms.astype(np.int64)))

    def meta_perms(self, m, epochs):
        eks = jax.random.split(self.keys[-1], epochs)
        return torch.stack([torch.from_numpy(np.asarray(
            jax.random.permutation(ek, m)).astype(np.int64)) for ek in eks])

    def cohort(self, num_available, m):
        raise NotImplementedError("run_round takes its cohort as given")


@pytest.fixture(scope="module")
def round_pair():
    cfg_w = get_wrn_config().reduced()
    train = SyntheticImageDataset(600, image_size=cfg_w.image_size,
                                  modes_per_class=3, seed=0)
    test = SyntheticImageDataset(200, image_size=cfg_w.image_size,
                                 modes_per_class=3, seed=1)
    clients = partition_k_shards(train, num_clients=2, k_classes=2,
                                 samples_per_client=100)
    key = jax.random.PRNGKey(7)
    k_init, k_round = jax.random.split(key)
    jcfg = JWRNConfig().reduced()
    jm = jwrn.make_split_wrn(jcfg)
    jparams = jm.init(k_init)
    jled = JCommLedger()
    jflcfg = JFLConfig(batched_selection=False, **KNOBS)
    jres = jrounds.run_round(jm, jparams, jm.split(jparams)[1], clients,
                             jflcfg, k_round, ledger=jled, num_classes=10)

    model = make_split_wrn(cfg_w)
    params = wrn.params_from_jax(jax.tree.map(np.asarray, jparams))
    led = CommLedger()
    flcfg = FLConfig(**KNOBS)
    res = rounds.run_round(model, params, model.split(params)[1], clients,
                           flcfg, JaxDraws(k_round, len(clients)),
                           ledger=led, num_classes=10)
    return dict(clients=clients, test=test, key=k_round, jm=jm,
                jparams=jparams, jres=jres, jled=jled, model=model,
                params=params, res=res, led=led)


def _assert_params_close(port, ref_tree):
    tree = wrn.params_to_jax(port)
    assert jax.tree.structure(tree) == jax.tree.structure(
        jax.tree.map(np.asarray, ref_tree))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(ref_tree)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=TOL, atol=TOL)


def test_round_ledger_bytes_equal(round_pair):
    s, js = round_pair["led"].summary(), round_pair["jled"].summary()
    assert s == js
    assert s["up"]["metadata"] > 0 and s["up"]["weights"] > 0
    assert round_pair["res"].metadata_count == \
        round_pair["jres"].metadata_count


def test_round_new_global_and_composed_weights(round_pair):
    res, jres = round_pair["res"], round_pair["jres"]
    _assert_params_close(res.global_params, jres.global_params)
    _assert_params_close(res.composed_params, jres.composed_params)
    np.testing.assert_allclose(res.client_losses, jres.client_losses,
                               rtol=TOL, atol=TOL)


def test_round_evaluation_accuracy(round_pair):
    p = round_pair
    x, y = p["test"].x, p["test"].y
    for port, ref in [(p["res"].composed_params, p["jres"].composed_params),
                      (p["res"].global_params, p["jres"].global_params)]:
        acc = evaluate(p["model"], port, torch.from_numpy(x),
                       torch.from_numpy(y))
        jacc = jevaluate(p["jm"], ref, x, y)
        assert abs(acc - jacc) <= 0.01, (acc, jacc)


def test_round_selections_and_int8_frames(round_pair):
    p = round_pair
    keys = jax.random.split(p["key"], len(p["clients"]) + 1)
    draws = JaxDraws(p["key"], len(p["clients"]))
    for i, c in enumerate(p["clients"]):
        k_sel, _ = jax.random.split(keys[i])
        x, y = jnp.asarray(c.data.x), jnp.asarray(c.data.y)
        jacts = p["jm"].apply_lower(p["jparams"], x)
        jsel = jselect(jacts, y, k_sel, num_classes=10,
                       clusters_per_class=KNOBS["clusters_per_class"],
                       pca_components=KNOBS["pca_components"],
                       kmeans_iters=KNOBS["kmeans_iters"])
        with torch.no_grad():
            acts = p["model"].apply_lower(p["params"],
                                          torch.from_numpy(c.data.x))
        sel = select_metadata(acts, torch.from_numpy(c.data.y),
                              draws.client(i, c, 10, 1).first_centres,
                              num_classes=10,
                              clusters_per_class=KNOBS["clusters_per_class"],
                              pca_components=KNOBS["pca_components"],
                              kmeans_iters=KNOBS["kmeans_iters"])
        np.testing.assert_array_equal(sel.valid.numpy(),
                                      np.asarray(jsel.valid))
        idx = sel.indices.numpy()
        assert (idx == np.asarray(jsel.indices)).mean() >= 0.99
        # the int8 SelectedKnowledge frames of the two clients' uploads
        ylab = c.data.y[idx]
        port = T.SelectedKnowledge(acts[sel.indices], ylab, sel.valid,
                                   T.get_codec("int8")).encode()
        jidx = np.asarray(jsel.indices)
        ref = JT.SelectedKnowledge(jacts[jidx], c.data.y[jidx], jsel.valid,
                                   JT.get_codec("int8")).encode()
        assert len(port) == len(ref)
        pq = np.frombuffer(port, np.int8).astype(int)
        rq = np.frombuffer(ref, np.int8).astype(int)
        body = slice(len(port) - int(sel.valid.sum()) * acts[0].numel(),
                     None)
        assert np.abs(pq[body] - rq[body]).max() <= 1
        # the same maps through both codecs: byte-identical frames
        same = T.SelectedKnowledge(torch.from_numpy(np.asarray(jacts[jidx])),
                                   c.data.y[jidx], np.asarray(jsel.valid),
                                   T.get_codec("int8")).encode()
        assert same == ref


def test_simulation_runs_on_cpu_when_asked():
    cfg_w = get_wrn_config().reduced()
    train = SyntheticImageDataset(300, image_size=cfg_w.image_size, seed=2)
    test = SyntheticImageDataset(100, image_size=cfg_w.image_size, seed=3)
    clients = partition_k_shards(train, num_clients=3, k_classes=2,
                                 samples_per_client=60)
    flcfg = FLConfig(**{**KNOBS, "num_clients": 3, "clients_per_round": 2})
    sim = FLSimulation(make_split_wrn(cfg_w), clients, test, flcfg, seed=1,
                       device="cpu")
    res = sim.run(rounds=2)
    assert len(res.test_acc) == len(res.fedavg_acc) == 2
    assert len(res.round_wall_s) == 2 and res.wall_time > 0
    assert all(0 < m <= 2 * 2 * 4 for m in res.metadata_counts)
    assert res.cohort_samples == [120, 120]
    frames = res.comm["down_frames"]["weights"]
    assert frames == 4 and res.comm["up_frames"]["metadata"] == 4
    assert all(torch.isfinite(v).all()
               for v in sim.server.global_params.values())
