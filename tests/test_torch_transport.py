"""Byte identity of the port's wire frames (``repro_torch.fl.transport``)
with the reference's (``repro.fl.transport``), in both directions.

For every codec (raw_f32, f16, int8) and both frame kinds (weights,
SelectedKnowledge), with and without the CRC32 trailer: the port's encode
equals the reference's byte for byte, a port frame decodes under the
reference's decoder and the reverse, and ``pytree_frame_nbytes`` equals
``len(encode())``. Weight frames carry the reference's tree (HWIO convs, in
``jax.tree.leaves`` order) from ``models.wrn.params_to_jax``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.wrn_cifar import WRNConfig as JWRNConfig
from repro.fl.comms import CommLedger as JCommLedger
from repro.fl import transport as JT
from repro.models import wrn as jwrn
from repro_torch.fl import transport as T
from repro_torch.fl.comms import CommLedger
from repro_torch.models import wrn

CODECS = ["raw_f32", "f16", "int8"]


def _knowledge(seed, ck=12, shape=(4, 4, 3), all_invalid=False):
    r = np.random.default_rng(seed)
    acts = r.normal(size=(ck,) + shape).astype(np.float32)
    labels = r.integers(0, 10, ck).astype(np.int32)
    valid = r.random(ck) < 0.6
    valid[0] = True
    if all_invalid:
        valid[:] = False
    return acts, labels, valid


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("codec", CODECS)
def test_knowledge_frames_byte_identical_both_ways(codec, checksum):
    for seed, bad in [(0, False), (1, False), (2, True)]:
        acts, labels, valid = _knowledge(seed, all_invalid=bad)
        port = T.SelectedKnowledge(torch.from_numpy(acts),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(valid),
                                   T.get_codec(codec)).encode(checksum)
        ref = JT.SelectedKnowledge(jnp.asarray(acts), jnp.asarray(labels),
                                   jnp.asarray(valid),
                                   JT.get_codec(codec)).encode(checksum)
        assert port == ref
        # reference frame -> port decoder, port frame -> reference decoder
        pa, pl, pv = T.SelectedKnowledge.decode(ref)
        ra, rl, rv = JT.SelectedKnowledge.decode(port)
        assert pa.numpy().tobytes() == np.asarray(ra).tobytes()
        assert pl.numpy().tobytes() == np.asarray(rl).tobytes()
        assert pv.numpy().tolist() == np.asarray(rv).tolist()
        assert pa.shape[0] == int(valid.sum())
        if codec == "raw_f32":
            np.testing.assert_array_equal(pa.numpy(), acts[valid])


def test_int8_codec_encode_decode_match_reference():
    acts, labels, valid = _knowledge(3, ck=20, shape=(8, 8, 2))
    codec = T.get_codec("int8")
    flat = torch.from_numpy(acts).reshape(20, -1)
    payload, params = codec.encode(flat, valid)
    assert (payload, params) == JT.get_codec("int8").encode(
        flat.numpy(), valid)
    rows = codec.decode(payload, int(valid.sum()), flat.shape[1], params)
    want = JT.get_codec("int8").decode(payload, int(valid.sum()),
                                       flat.shape[1], params)
    assert rows.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def wrn_tree():
    tree = jax.tree.map(np.asarray, jwrn.init_wrn(JWRNConfig().reduced(),
                                                  jax.random.PRNGKey(1)))
    return tree


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("kind", ["broadcast", "update"])
def test_weight_frames_byte_identical_both_ways(wrn_tree, kind, checksum):
    params = wrn.params_from_jax(wrn_tree)
    port_cls = T.WeightBroadcast if kind == "broadcast" else T.UpperUpdate
    ref_cls = JT.WeightBroadcast if kind == "broadcast" else JT.UpperUpdate
    ptree = jax.tree.map(torch.from_numpy, wrn.params_to_jax(params))
    port = port_cls(ptree).encode(checksum)
    ref = ref_cls(jax.tree.map(jnp.asarray, wrn_tree)).encode(checksum)
    assert port == ref
    assert len(port) == T.pytree_frame_nbytes(ptree, checksum) \
        == T.pytree_frame_nbytes(params, checksum) \
        == JT.pytree_frame_nbytes(wrn_tree, checksum)
    # port frame -> reference decoder
    leaves = ref_cls.decode(port)
    for a, b in zip(leaves, jax.tree.leaves(wrn_tree)):
        assert np.asarray(a).tobytes() == b.tobytes()
    # reference frame -> port decoder -> port params
    back = wrn.params_from_jax(T.unflatten_like(wrn_tree,
                                                port_cls.decode(ref)))
    assert set(back) == set(params)
    for k in params:
        assert torch.equal(back[k], params[k]), k


def test_every_wire_dtype_round_trips_both_ways():
    r = np.random.default_rng(4)
    f = r.normal(size=(3, 5)).astype(np.float32)
    ref_tree = {"a": f, "b": f.astype(np.float16),
                "c": f.astype(ml_dtypes.bfloat16),
                "d": (f * 10).astype(np.int8), "e": np.arange(7, dtype=np.uint8),
                "f": np.arange(4, dtype=np.int32).reshape(2, 2),
                "g": np.arange(3, dtype=np.int64),
                "h": np.arange(5, dtype=np.uint32), "i": f > 0,
                "j": np.float32(2.5)}
    port_tree = {"a": torch.from_numpy(f),
                 "b": torch.from_numpy(f.astype(np.float16)),
                 "c": torch.from_numpy(f).to(torch.bfloat16),
                 "d": torch.from_numpy((f * 10).astype(np.int8)),
                 "e": torch.arange(7, dtype=torch.uint8),
                 "f": torch.arange(4, dtype=torch.int32).reshape(2, 2),
                 "g": torch.arange(3, dtype=torch.int64),
                 "h": torch.from_numpy(np.arange(5, dtype=np.uint32)),
                 "i": torch.from_numpy(f > 0),
                 "j": torch.tensor(2.5, dtype=torch.float32)}
    port = T.WeightBroadcast(port_tree).encode(checksum=True)
    ref = JT.WeightBroadcast(ref_tree).encode(checksum=True)
    assert port == ref
    assert T.pytree_frame_nbytes(port_tree, True) == len(port)
    back = T.unflatten_like(port_tree, T.WeightBroadcast.decode(ref))
    for k, t in port_tree.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k


def test_channel_charges_exact_frame_bytes(wrn_tree):
    params = wrn.params_from_jax(wrn_tree)
    acts, labels, valid = _knowledge(5)
    for codec in CODECS:
        led = CommLedger()
        ch = T.Channel(led, checksum=True)
        got = ch.upload_knowledge(0, torch.from_numpy(acts),
                                  torch.from_numpy(labels),
                                  torch.from_numpy(valid), T.get_codec(codec))
        ch.upload_update(0, params)
        ch.broadcast_weights(params, 3)
        jled = JCommLedger()
        jch = JT.Channel(jled, checksum=True)
        jch.upload_knowledge(0, jnp.asarray(acts), jnp.asarray(labels),
                             jnp.asarray(valid), JT.get_codec(codec))
        jch.upload_update(0, wrn_tree)
        jch.broadcast_weights(wrn_tree, 3)
        assert led.summary() == jled.summary()
        assert got[0].shape[0] == int(valid.sum())


@pytest.mark.parametrize("mangle,err", [
    (lambda w: w[:5], T.TruncatedFrame),
    (lambda w: b"XXXX" + w[4:], T.BadMagic),
    (lambda w: w[:4] + b"\x09" + w[5:], T.BadVersion),
    (lambda w: w[:-1] + bytes([w[-1] ^ 1]), T.ChecksumMismatch),
    (lambda w: w + b"\x00", T.LengthMismatch),
])
def test_decode_raises_typed_frame_errors(mangle, err):
    acts, labels, valid = _knowledge(6)
    wire = T.SelectedKnowledge(torch.from_numpy(acts), labels, valid,
                               T.get_codec("int8")).encode(checksum=True)
    with pytest.raises(err):
        T.SelectedKnowledge.decode(mangle(wire))
    with pytest.raises(T.WrongMessageType):
        T.WeightBroadcast.decode(wire)
