"""The int8 quantize's cohort axis on the CPU: the port's
``quantize_affine_batched`` (its plain version,
``ref.quantize_affine_batched_ref``, on CPU tensors) and its batched
knowledge upload (``Channel.upload_knowledge_batched``) against the
reference's ``prequantize_cohort`` (the jnp oracle and the Pallas kernel
in interpret mode, both under ``vmap``) and against the port's own
per-client path.

Level: byte-exact, per client — codes and (xmin, scale) — for mixed masks,
a client with every row masked, NaN / +inf / -inf in a valid row, a zero
minimum of both signs, and -0.0 only in a masked row; and every wire frame
of the batched upload byte-equal to the reference's batched frames and to
the port's per-client frames. The CUDA kernel is held against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import transport as JT
from repro.fl.comms import CommLedger as JCommLedger
from repro.fl.transport import channel as jchannel
from repro_torch.fl import transport as T
from repro_torch.fl.comms import CommLedger
from repro_torch.fl.transport import messages
from repro_torch.kernels import ops, ref


def _cohort(case, b=4, n=12, d=40, seed=0):
    """(x (B, N, D) f32, mask (B, N) bool) numpy: client 0 random at ~70%
    valid, client 1 every row masked, client 2 the ``case`` payload,
    client 3 one valid row."""
    r = np.random.default_rng(seed)
    x = (r.normal(size=(b, n, d)) * 3 + 1).astype(np.float32)
    m = r.random((b, n)) < 0.7
    m[1] = False
    m[3] = False
    m[3, n // 2] = True
    m[2] = True
    m[2, 1] = False
    if case in ("signed_zero", "masked_neg_zero"):
        x[2] = np.abs(x[2])
        x[2, 0, 0] = x[2, n - 1, d - 1] = 0.0
        x[2, 1 if case == "masked_neg_zero" else 2, 3] = -0.0
    elif case in ("nan", "pos_inf", "neg_inf"):
        x[2, 2, 3] = {"nan": np.nan, "pos_inf": np.inf,
                      "neg_inf": -np.inf}[case]
    return x, m


CASES = ["mixed", "nan", "pos_inf", "neg_inf", "signed_zero",
         "masked_neg_zero"]


def _port(x, m):
    q, xmin, scale = ops.quantize_affine_batched(torch.from_numpy(x),
                                                 torch.from_numpy(m))
    return ([q[i].numpy().tobytes() for i in range(len(x))],
            [np.float32(v).tobytes() for v in xmin.numpy()],
            [np.float32(v).tobytes() for v in scale.numpy()])


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_batched_quantize_matches_reference_prequantize_cohort(case,
                                                               use_pallas):
    """Per client, codes and (xmin, scale) equal, bit for bit, to the
    reference's vmapped quantize (jnp oracle, or the Pallas kernel in
    interpret mode)."""
    x, m = _cohort(case)
    pres = jchannel.prequantize_cohort(JT.get_codec("int8",
                                                    use_pallas=use_pallas),
                                       jnp.asarray(x), jnp.asarray(m))
    codes, xmins, scales = _port(x, m)
    for i, z in enumerate(pres):
        assert codes[i] == np.asarray(z.q).tobytes(), i
        assert xmins[i] == np.float32(z.xmin).tobytes(), i
        assert scales[i] == np.float32(z.scale).tobytes(), i
    assert xmins[1] == np.float32(0).tobytes()                 # all masked
    assert scales[1] == np.float32(1).tobytes()


@pytest.mark.parametrize("case", CASES)
def test_batched_quantize_equals_one_call_per_client(case):
    """The cohort wrapper gives each client exactly what one
    ``quantize_affine`` call on its own payload gives, and counts no
    launch on the CPU."""
    x, m = _cohort(case, b=4, n=7, d=9, seed=2)
    ops.reset_launch_counts()
    codes, xmins, scales = _port(x, m)
    for i in range(len(x)):
        q, xmin, scale = ops.quantize_affine(torch.from_numpy(x[i]),
                                             torch.from_numpy(m[i]))
        assert codes[i] == q.numpy().tobytes()
        assert xmins[i] == np.float32(xmin).tobytes()
        assert scales[i] == np.float32(scale).tobytes()
    assert ops.launch_counts()["quantize_affine_batched"] == 0


def test_batched_quantize_checks_its_inputs():
    x = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError):
        ops.quantize_affine_batched(x, torch.ones(2, 4, dtype=torch.bool))
    with pytest.raises(TypeError):
        ops.quantize_affine_batched(x.double(),
                                    torch.ones(2, 3, dtype=torch.bool))
    with pytest.raises(ValueError):
        ops.quantize_affine_batched(x[0], torch.ones(3, dtype=torch.bool))
    q, xmin, scale = ref.quantize_affine_batched_ref(
        torch.zeros(0, 3, 4), torch.zeros(0, 3, dtype=torch.bool))
    assert q.shape == (0, 3, 4) and xmin.shape == scale.shape == (0,)


def _record(monkeypatch, cls):
    """Record every SelectedKnowledge frame ``cls.decode`` is handed."""
    wires, orig = [], cls.decode

    def decode(wire):
        wires.append(wire)
        return orig(wire)

    monkeypatch.setattr(cls, "decode", decode)
    return wires


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("codec", ["int8", "raw_f32"])
def test_batched_upload_frames_equal_reference_and_per_client(
        monkeypatch, codec, checksum):
    """The frames of ``upload_knowledge_batched`` equal the reference's
    batched frames and the port's per-client ``upload_knowledge`` frames,
    byte for byte; the decoded triples and the ledgers agree."""
    x, m = _cohort("mixed", b=4, n=12, d=48, seed=5)
    acts = x.reshape(4, 12, 4, 4, 3)
    labels = np.random.default_rng(6).integers(0, 10, (4, 12)).astype(
        np.int32)
    pwires = _record(monkeypatch, messages.SelectedKnowledge)
    jwires = _record(monkeypatch, JT.SelectedKnowledge)

    led = CommLedger()
    batched = T.Channel(led, checksum).upload_knowledge_batched(
        [3, 1, 4, 2], torch.from_numpy(acts), torch.from_numpy(labels),
        torch.from_numpy(m), T.get_codec(codec))
    got = list(pwires)
    pled = CommLedger()
    single = [T.Channel(pled, checksum).upload_knowledge(
        i, torch.from_numpy(acts[i]), torch.from_numpy(labels[i]),
        torch.from_numpy(m[i]), T.get_codec(codec)) for i in range(4)]
    jled = JCommLedger()
    JT.Channel(jled, checksum).upload_knowledge_batched(
        [3, 1, 4, 2], jnp.asarray(acts), jnp.asarray(labels), jnp.asarray(m),
        JT.get_codec(codec))
    assert got == pwires[4:] == jwires and len(got) == 4
    assert led.summary() == pled.summary() == jled.summary()
    for a, b in zip(batched, single):
        for u, v in zip(a, b):
            assert u.numpy().tobytes() == v.numpy().tobytes()


def test_prequantized_payload_must_match_the_mask():
    codec = T.get_codec("int8")
    pre = T.Quantized(np.zeros((2, 4), np.int8), 0.0, 1.0)
    with pytest.raises(ValueError):
        codec.encode(None, np.array([True, False, False]), pre=pre)
    payload, params = codec.encode(None, np.array([True, False, True]),
                                   pre=pre)
    assert payload == bytes(8) and len(params) == 8
