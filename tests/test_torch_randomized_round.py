"""One round with ``pca_solver="randomized"`` on the CPU: the port's
``run_round`` (client loop) against the reference's sequential
``run_round`` (``batched_selection=False``), WRN-10-1 at 16x16, 2 non-IID
clients x 100 samples, P=16, 4 clusters per class, the int8 codec, with
every one of the reference's draws passed in (``JaxDraws``: initial
weights, first centres, the PCA's test matrix ``PRNGKey(0x9CA)``,
LocalUpdate and meta-training permutations).

Levels (those of tests/test_torch_round.py): ledger bytes per category
and |D_M| equal; each client's ``valid`` equal and >= 99% of its indices
equal; W_G(t), M_COM(t) and the client losses within 2e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.configs.wrn_cifar import WRNConfig as JWRNConfig
from repro.core import rounds as jrounds
from repro.core.selection import select_metadata as jselect
from repro.fl.comms import CommLedger as JCommLedger
from repro.models import wrn as jwrn
from repro_torch.configs import FLConfig, get_wrn_config
from repro_torch.core import rounds
from repro_torch.core.split import make_split_wrn
from repro_torch.data import SyntheticImageDataset, partition_k_shards
from repro_torch.fl.comms import CommLedger
from repro_torch.models import wrn
from test_torch_round import (KNOBS, TOL, JaxDraws,  # noqa: F401
                              _assert_params_close, one_torch_thread)

RKNOBS = dict(KNOBS, pca_solver="randomized")


@pytest.fixture(scope="module")
def randomized_pair():
    cfg_w = get_wrn_config().reduced()
    train = SyntheticImageDataset(600, image_size=cfg_w.image_size,
                                  modes_per_class=3, seed=0)
    clients = partition_k_shards(train, num_clients=2, k_classes=2,
                                 samples_per_client=100)
    k_init, k_round = jax.random.split(jax.random.PRNGKey(9))
    jm = jwrn.make_split_wrn(JWRNConfig().reduced())
    jparams = jm.init(k_init)
    jled = JCommLedger()
    jres = jrounds.run_round(jm, jparams, jm.split(jparams)[1], clients,
                             JFLConfig(batched_selection=False, **RKNOBS),
                             k_round, ledger=jled, num_classes=10)
    model = make_split_wrn(cfg_w)
    params = wrn.params_from_jax(jax.tree.map(np.asarray, jparams))
    led = CommLedger()
    res = rounds.run_round(model, params, model.split(params)[1], clients,
                           FLConfig(**RKNOBS),
                           JaxDraws(k_round, len(clients)), ledger=led,
                           num_classes=10)
    return dict(clients=clients, key=k_round, jm=jm, jparams=jparams,
                jres=jres, jled=jled, model=model, params=params, res=res,
                led=led)


def test_randomized_round_ledger_and_metadata_count(randomized_pair):
    p = randomized_pair
    assert p["led"].summary() == p["jled"].summary()
    assert p["res"].metadata_count == p["jres"].metadata_count > 0


def test_randomized_round_weights(randomized_pair):
    res, jres = randomized_pair["res"], randomized_pair["jres"]
    _assert_params_close(res.global_params, jres.global_params)
    _assert_params_close(res.composed_params, jres.composed_params)
    np.testing.assert_allclose(res.client_losses, jres.client_losses,
                               rtol=TOL, atol=TOL)


def test_randomized_round_selections(randomized_pair):
    p = randomized_pair
    keys = jax.random.split(p["key"], len(p["clients"]) + 1)
    draws = JaxDraws(p["key"], len(p["clients"]))
    cfg = FLConfig(**RKNOBS)
    for i, c in enumerate(p["clients"]):
        k_sel, _ = jax.random.split(keys[i])
        jacts = p["jm"].apply_lower(p["jparams"], jnp.asarray(c.data.x))
        want = jselect(jacts, jnp.asarray(c.data.y), k_sel, num_classes=10,
                       clusters_per_class=KNOBS["clusters_per_class"],
                       pca_components=KNOBS["pca_components"],
                       kmeans_iters=KNOBS["kmeans_iters"],
                       pca_solver="randomized")
        (maps, ys, valid), sweeps = rounds.extract_select(
            p["model"], p["params"], torch.from_numpy(c.data.x),
            torch.from_numpy(c.data.y), draws.client(i, c, 10, 1), cfg, 10)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(want.valid))
        assert sweeps == int(want.lloyd_iters)
        # the selected maps are the reference's rows (>= 99% of the slots)
        wmaps = np.asarray(jacts)[np.asarray(want.indices)]
        same = [np.allclose(a, b, rtol=TOL, atol=TOL)
                for a, b in zip(maps.numpy(), wmaps)]
        assert np.mean(same) >= 0.99
