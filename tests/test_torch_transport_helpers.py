"""The transport's module-level helpers (``repro_torch.fl.transport``
``broadcast_weights``, ``upload_update``, ``upload_knowledge``,
``upload_knowledge_batched``, ``knowledge_codec``) against the reference's
(``repro.fl.transport.channel``), for the raw_f32, f16 and int8 codecs.

Level: byte-exact. The ledger each helper charges (bytes and frames by
category), the byte counts the helpers return, the frames a config's
codec encodes, and every decoded triple, int8 included. Weight frames
carry the reference's WRN tree (``models.wrn.params_to_jax``); the
round's knowledge upload goes through ``knowledge_codec``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import FLConfig as JFLConfig
from repro.configs.wrn_cifar import WRNConfig as JWRNConfig
from repro.fl.comms import CommLedger as JCommLedger
from repro.fl import transport as JT
from repro.models import wrn as jwrn
from repro_torch.configs import FLConfig
from repro_torch.fl import transport as T
from repro_torch.fl.comms import CommLedger
from repro_torch.models import wrn

CODECS = ["raw_f32", "f16", "int8"]


def _cohort(seed, b=3, ck=10, shape=(4, 4, 3)):
    r = np.random.default_rng(seed)
    acts = r.normal(size=(b, ck) + shape).astype(np.float32)
    labels = r.integers(0, 10, (b, ck)).astype(np.int32)
    valid = r.random((b, ck)) < 0.6
    valid[:, 0] = True
    valid[-1] = False                       # a client with nothing valid
    return acts, labels, valid


def _same_triples(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
            assert a.tobytes() == np.asarray(b).tobytes()
            assert a.shape == np.asarray(b).shape


@pytest.fixture(scope="module")
def wrn_tree():
    return jax.tree.map(np.asarray, jwrn.init_wrn(JWRNConfig().reduced(),
                                                  jax.random.PRNGKey(2)))


@pytest.mark.parametrize("codec", CODECS)
def test_knowledge_helpers_byte_exact(codec):
    acts, labels, valid = _cohort(7)
    cfg, jcfg = (FLConfig(transport_codec=codec),
                 JFLConfig(transport_codec=codec))
    led, jled = CommLedger(), JCommLedger()
    one = T.upload_knowledge(led, torch.from_numpy(acts[0]),
                             torch.from_numpy(labels[0]),
                             torch.from_numpy(valid[0]),
                             T.knowledge_codec(cfg))
    jone = JT.upload_knowledge(jled, jnp.asarray(acts[0]),
                               jnp.asarray(labels[0]), jnp.asarray(valid[0]),
                               JT.knowledge_codec(jcfg))
    _same_triples([one], [jone])
    many = T.upload_knowledge_batched(led, torch.from_numpy(acts),
                                      torch.from_numpy(labels),
                                      torch.from_numpy(valid),
                                      T.knowledge_codec(cfg))
    jmany = JT.upload_knowledge_batched(jled, jnp.asarray(acts),
                                        jnp.asarray(labels),
                                        jnp.asarray(valid),
                                        JT.knowledge_codec(jcfg))
    _same_triples(many, jmany)
    assert led.summary() == jled.summary()
    assert led.up_frames["metadata"] == 1 + acts.shape[0]
    # the frames a config's codec encodes, byte for byte
    for i in range(acts.shape[0]):
        frame = T.SelectedKnowledge(
            torch.from_numpy(acts[i]), torch.from_numpy(labels[i]),
            torch.from_numpy(valid[i]), T.knowledge_codec(cfg)).encode()
        assert frame == JT.SelectedKnowledge(
            jnp.asarray(acts[i]), jnp.asarray(labels[i]),
            jnp.asarray(valid[i]), JT.knowledge_codec(jcfg)).encode()


def test_weight_helpers_byte_exact(wrn_tree):
    params = wrn.params_from_jax(wrn_tree)
    led, jled = CommLedger(), JCommLedger()
    got = (T.broadcast_weights(led, params, 5), T.upload_update(led, params),
           T.upload_update(led, params))
    want = (JT.broadcast_weights(jled, wrn_tree, 5),
            JT.upload_update(jled, wrn_tree), JT.upload_update(jled, wrn_tree))
    assert got == want
    assert led.summary() == jled.summary()
    assert got[1] == len(JT.UpperUpdate(
        jax.tree.map(jnp.asarray, wrn_tree)).encode())


def test_the_round_encodes_with_knowledge_codec(monkeypatch):
    """``rounds.client_round`` takes its codec from ``knowledge_codec``, as
    the reference's does."""
    from repro_torch.configs import get_wrn_config
    from repro_torch.core import rounds
    from repro_torch.core.split import make_split_wrn
    from repro_torch.data import SyntheticImageDataset, partition_k_shards

    asked = []

    def spy(cfg):
        asked.append(cfg.transport_codec)
        return T.get_codec(cfg.transport_codec)

    monkeypatch.setattr(rounds, "knowledge_codec", spy)
    wcfg = get_wrn_config().reduced()
    ds = SyntheticImageDataset(40, image_size=wcfg.image_size)
    client = partition_k_shards(ds, num_clients=1, samples_per_client=20)[0]
    model = make_split_wrn(wcfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, torch.device("cpu"))
    cfg = FLConfig(num_clients=1, local_batch_size=10, pca_components=4,
                   clusters_per_class=2, kmeans_iters=2,
                   transport_codec="f16")
    draws = rounds.GeneratorDraws(gen).client(0, client, 10, 1)
    rounds.client_round(model, params, client, cfg, draws,
                        T.Channel(CommLedger()), 10)
    assert asked == ["f16"]
