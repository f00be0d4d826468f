"""Parity of the port's attention cores with the reference's, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``:
  * the plain kernel versions (``kernels/ref.py``
    ``flash_attention_ref`` / ``flash_decode_ref``) on the parameter sets of
    ``tests/test_kernels.py``'s attention sweeps;
  * the port's wrappers (``kernels.ops``, which on CPU tensors run the plain
    versions) against the Pallas kernels in interpret mode via
    ``repro.kernels.ops``, at S <= 256 only (interpret mode is slow);
  * the model-level cores ``sdpa_full``, ``sdpa_chunked`` and
    ``sdpa_decode`` against ``repro.models.layers``'.
Levels: 2e-3 at f32, 2e-2 at bf16 (``tests/test_kernels.py:156``). The
CUDA kernels are held against the same plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import layers as jL
from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

# the reference's functions, each compiled once per shape (eager JAX would
# compile every op of them separately)
_STATIC = ("causal", "window", "chunk", "block_q", "block_k", "block_s")
J = {name: jax.jit(fn, static_argnames=[a for a in _STATIC
                                        if a in fn.__code__.co_varnames])
     for name, fn in [("attn_ref", jref.flash_attention_ref),
                      ("decode_ref", jref.flash_decode_ref),
                      ("sdpa_full", jL.sdpa_full),
                      ("sdpa_chunked", jL._sdpa_chunked_raw),
                      ("sdpa_decode", jL.sdpa_decode)]}

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return 2e-2 if name == "bf16" else 2e-3


def _draw(seed, shape, name):
    """numpy normal draws, rounded to the dtype, as (torch, jax) twins."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    tdt, jdt = DTYPES[name]
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)
    return xt, xj


def _close(got, want, tol):
    if isinstance(want, torch.Tensor):
        want = want.to(torch.float32).numpy()
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _qkv(b, s, h, kv, d, name, seed=0):
    return (_draw(seed, (b, s, h, d), name), _draw(seed + 1, (b, s, kv, d),
                                                   name),
            _draw(seed + 2, (b, s, kv, d), name))


# tests/test_kernels.py:141-148
FLASH_CASES = [
    (2, 256, 8, 4, 64, True, 0, "f32"),
    (1, 256, 4, 4, 128, True, 64, "f32"),
    (2, 128, 8, 2, 32, False, 0, "f32"),
    (1, 512, 8, 8, 64, True, 128, "f32"),
    (2, 256, 4, 1, 64, True, 0, "bf16"),
    (1, 384, 6, 2, 96, True, 0, "f32"),
]
# tests/test_kernels.py:175-180
DECODE_CASES = [
    (2, 512, 8, 4, 64, 256, "f32"),
    (1, 300, 4, 2, 128, 300, "f32"),
    (4, 1024, 8, 8, 64, 17, "f32"),
    (2, 256, 16, 2, 64, 128, "bf16"),
]


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,name", FLASH_CASES)
def test_flash_attention_ref_matches_reference(b, s, h, kv, d, causal,
                                               window, name):
    (qt, qj), (kt, kj), (vt, vj) = _qkv(b, s, h, kv, d, name)
    got = ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    want = J["attn_ref"](qj, kj, vj, causal=causal, window=window)
    assert got.dtype == DTYPES[name][0] and got.shape == (b, s, h, d)
    _close(got, want, _tol(name))


@pytest.mark.parametrize("b,s,h,kv,d,fill,name", DECODE_CASES)
def test_flash_decode_ref_matches_reference(b, s, h, kv, d, fill, name):
    (qt, qj), (kt, kj), (vt, vj) = (_draw(0, (b, 1, h, d), name),
                                    _draw(1, (b, s, kv, d), name),
                                    _draw(2, (b, s, kv, d), name))
    valid = np.broadcast_to(np.arange(s)[None, :] < fill, (b, s)).copy()
    got = ref.flash_decode_ref(qt, kt, vt, torch.from_numpy(valid))
    want = J["decode_ref"](qj, kj, vj, jnp.asarray(valid))
    _close(got, want, _tol(name))


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,name",
                         [c for c in FLASH_CASES if c[1] <= 256])
def test_flash_attention_wrapper_matches_pallas_interpret(
        b, s, h, kv, d, causal, window, name):
    (qt, qj), (kt, kj), (vt, vj) = _qkv(b, s, h, kv, d, name, seed=3)
    before = ops.flash_attention.launches
    got = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert ops.flash_attention.launches == before       # CPU: no launch
    want = jops.flash_attention(qj, kj, vj, causal=causal, window=window,
                                block_q=128, block_k=128)
    _close(got, want, _tol(name))


@pytest.mark.parametrize("b,s,h,kv,d,fill,name",
                         [c for c in DECODE_CASES if c[1] <= 256]
                         + [(3, 200, 4, 1, 32, 77, "f32")])
def test_flash_decode_wrapper_matches_pallas_interpret(b, s, h, kv, d, fill,
                                                       name):
    (qt, qj), (kt, kj), (vt, vj) = (_draw(5, (b, 1, h, d), name),
                                    _draw(6, (b, s, kv, d), name),
                                    _draw(7, (b, s, kv, d), name))
    valid = np.random.default_rng(8).random((b, s)) < 0.5
    valid[:, :fill] = True
    got = ops.flash_decode(qt, kt, vt, torch.from_numpy(valid))
    want = jops.flash_decode(qj, kj, vj, jnp.asarray(valid), block_s=128)
    _close(got, want, _tol(name))


def test_flash_attention_ref_masks_the_true_length():
    """Non-causal at S = 1000 (not a multiple of any block): the port's
    wrapper equals the reference's oracle. (``repro.kernels.ops`` pads S
    and lets the padded keys into the softmax here; ROADMAP.md Queue 3.)"""
    (qt, qj), (kt, kj), (vt, vj) = _qkv(1, 1000, 4, 2, 32, "f32", seed=11)
    got = ops.flash_attention(qt, kt, vt, causal=False)
    want = J["attn_ref"](qj, kj, vj, causal=False)
    _close(got, want, 2e-3)


@pytest.mark.parametrize("sq,h,kv,d,causal,window,name", [
    (64, 4, 2, 32, True, 0, "f32"), (100, 8, 2, 16, True, 8, "f32"),
    (50, 4, 4, 32, False, 0, "f32"), (64, 4, 1, 32, True, 16, "bf16")])
def test_sdpa_full_matches_reference(sq, h, kv, d, causal, window, name):
    (qt, qj), (kt, kj), (vt, vj) = _qkv(2, sq, h, kv, d, name, seed=13)
    got = L.sdpa_full(qt, kt, vt, causal=causal, window=window)
    want = J["sdpa_full"](qj, kj, vj, causal=causal, window=window)
    _close(got, want, _tol(name))


@pytest.mark.parametrize("sq,chunk,window,causal,name", [
    (300, 128, 0, True, "f32"), (257, 64, 40, True, "f32"),
    (200, 64, 0, False, "f32"), (256, 128, 0, True, "bf16")])
def test_sdpa_chunked_matches_reference(sq, chunk, window, causal, name):
    (qt, qj), (kt, kj), (vt, vj) = _qkv(1, sq, 4, 2, 32, name, seed=17)
    got = L.sdpa_chunked(qt, kt, vt, causal=causal, window=window,
                         chunk=chunk)
    want = J["sdpa_chunked"](qj, kj, vj, causal=causal, window=window,
                                chunk=chunk)
    _close(got, want, _tol(name))
    # and the chunked form equals the direct one (same cores, two shapes)
    _close(got, L.sdpa_full(qt, kt, vt, causal=causal, window=window),
           _tol(name))


@pytest.mark.parametrize("s,h,kv,d,name", [(48, 4, 2, 32, "f32"),
                                           (40, 8, 1, 16, "bf16")])
def test_sdpa_decode_matches_reference(s, h, kv, d, name):
    (qt, qj), (kt, kj), (vt, vj) = (_draw(21, (3, 1, h, d), name),
                                    _draw(22, (3, s, kv, d), name),
                                    _draw(23, (3, s, kv, d), name))
    valid = np.arange(s)[None, :] <= np.array([[0], [s // 2], [s - 1]])
    got = L.sdpa_decode(qt, kt, vt, torch.from_numpy(valid))
    want = J["sdpa_decode"](qj, kj, vj, jnp.asarray(valid))
    _close(got, want, _tol(name))


def test_decode_reads_an_f32_cache_as_bf16_q_dtype():
    """A cache in another dtype than q is read as q's dtype, as the
    reference model's ``cache.astype(q.dtype)``."""
    (qt, _), (kt, _), (vt, _) = (_draw(31, (2, 1, 4, 32), "bf16"),
                                 _draw(32, (2, 64, 2, 32), "f32"),
                                 _draw(33, (2, 64, 2, 32), "f32"))
    valid = torch.ones(2, 64, dtype=torch.bool)
    got = ops.flash_decode(qt, kt, vt, valid)
    want = ref.flash_decode_ref(qt, kt.to(torch.bfloat16),
                                vt.to(torch.bfloat16), valid)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


def test_all_invalid_slots_give_uniform_weights_as_the_reference():
    (qt, qj), (kt, kj), (vt, vj) = (_draw(41, (1, 1, 2, 16), "f32"),
                                    _draw(42, (1, 20, 1, 16), "f32"),
                                    _draw(43, (1, 20, 1, 16), "f32"))
    valid = np.zeros((1, 20), bool)
    got = ops.flash_decode(qt, kt, vt, torch.from_numpy(valid))
    want = J["decode_ref"](qj, kj, vj, jnp.asarray(valid))
    _close(got, want, 2e-3)
    _close(got[0, 0, 0], vt[0, :, 0].mean(0), 2e-3)


@pytest.mark.parametrize("case", ["dtype", "rank", "kv_heads", "head_dim",
                                  "contiguous", "window", "mixed"])
def test_flash_attention_wrapper_refuses_what_the_kernel_does_not_take(case):
    q, k, v = (torch.zeros(1, 8, 4, 16), torch.zeros(1, 8, 2, 16),
               torch.zeros(1, 8, 2, 16))
    kw = {}
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "rank":
        q = q[0]
    elif case == "kv_heads":
        k, v = torch.zeros(1, 8, 3, 16), torch.zeros(1, 8, 3, 16)
    elif case == "head_dim":
        q, k, v = (torch.zeros(1, 8, 4, 300), torch.zeros(1, 8, 2, 300),
                   torch.zeros(1, 8, 2, 300))
    elif case == "contiguous":
        q = torch.zeros(1, 4, 8, 16).transpose(1, 2)
    elif case == "window":
        kw = {"window": -1}
    elif case == "mixed":
        k = k.to(torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        ops.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("case", ["q_len", "valid_shape", "valid_dtype",
                                  "cache_shape", "cache_mixed"])
def test_flash_decode_wrapper_refuses_what_the_kernel_does_not_take(case):
    q, kc, vc = (torch.zeros(2, 1, 4, 16), torch.zeros(2, 10, 2, 16),
                 torch.zeros(2, 10, 2, 16))
    valid = torch.ones(2, 10, dtype=torch.bool)
    if case == "q_len":
        q = torch.zeros(2, 2, 4, 16)
    elif case == "valid_shape":
        valid = torch.ones(2, 9, dtype=torch.bool)
    elif case == "valid_dtype":
        valid = valid.int()
    elif case == "cache_shape":
        vc = torch.zeros(2, 11, 2, 16)
    elif case == "cache_mixed":
        vc = vc.to(torch.bfloat16)
    with pytest.raises((TypeError, ValueError)):
        ops.flash_decode(q, kc, vc, valid)


def test_bf16_twins_are_the_same_numbers():
    """The inputs above are rounded once, to the same bf16 values in both
    packages (``ml_dtypes`` is JAX's bf16)."""
    t, j = _draw(0, (4, 5), "bf16")
    assert np.array_equal(t.to(torch.float32).numpy(),
                          np.asarray(j).astype(ml_dtypes.bfloat16)
                          .astype(np.float32))
