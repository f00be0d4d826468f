"""Parity of the port's kernel plain versions (``repro_torch.kernels``)
with the reference's (``repro.kernels``), on the CPU.

The same numpy inputs go through ``repro.kernels.ref`` (and, for one case
each, through the Pallas kernels in interpret mode via ``repro.kernels.ops``)
and through ``repro_torch.kernels.ops``, which on CPU tensors runs the plain
PyTorch versions. Levels:
  * pairwise distance: rtol/atol 2e-3;
  * Lloyd: ``assign`` exact on tie-free draws, ``sums``/``mindist``
    rtol 1e-5 / atol 1e-4 (as tests/test_kernels.py), counts exact;
  * quantize: byte-exact, (xmin, scale) exact, incl. the all-masked and
    constant cases and NaN / +inf / -inf payloads.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref

BIG = 1e30


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _lmask(n, k, seed, num_classes=0, masked_rows=0, empty_clusters=0):
    r = np.random.default_rng(seed)
    if num_classes > 0:
        labels = r.integers(0, num_classes, n)
        lm = np.where(labels[:, None] == (np.arange(k) % num_classes)[None],
                      0.0, BIG)
    else:
        lm = np.zeros((n, k))
    if masked_rows:
        lm[r.choice(n, masked_rows, replace=False)] = BIG
    if empty_clusters:
        lm[:, r.choice(k, empty_clusters, replace=False)] = BIG
    return lm.astype(np.float32)


@pytest.mark.parametrize("n,d,k", [(1, 1, 1), (37, 5, 3), (100, 37, 7),
                                   (300, 200, 10), (129, 65, 65)])
def test_pairwise_dist_matches_reference(n, d, k):
    x, c = _x(n, n, d), _x(k + 1, k, d)
    got = ops.kmeans_pairwise_dist(torch.from_numpy(x), torch.from_numpy(c))
    want = np.asarray(jref.kmeans_pairwise_dist_ref(jnp.asarray(x),
                                                    jnp.asarray(c)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("n,d,k,classes,masked,empty", [
    (64, 16, 4, 0, 0, 0), (300, 33, 20, 4, 0, 0), (257, 200, 100, 10, 9, 0),
    (100, 7, 13, 0, 5, 3), (70, 3, 66, 2, 3, 4)])
def test_lloyd_matches_reference(n, d, k, classes, masked, empty):
    x, c = _x(2 * n, n, d), _x(3 * k, k, d)
    lm = _lmask(n, k, n + k, classes, masked, empty)
    got = ops.kmeans_lloyd_step(torch.from_numpy(x), torch.from_numpy(c),
                                torch.from_numpy(lm))
    want = jref.kmeans_lloyd_ref(jnp.asarray(x), jnp.asarray(c),
                                 jnp.asarray(lm))
    a, md, s, cnt = (t.numpy() for t in got)
    wa, wmd, ws, wcnt = (np.asarray(t) for t in want)
    assert a.dtype == np.int32
    np.testing.assert_array_equal(a, wa)
    np.testing.assert_allclose(md, wmd, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s, ws, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(cnt, wcnt)
    if empty:
        assert (cnt[lm.min(0) > 0] == 0).all()
    if masked:
        rows = lm.min(1) > 0
        assert cnt.sum() == n - rows.sum()


def test_lloyd_lowest_index_wins_ties():
    x = np.zeros((4, 2), np.float32)
    c = np.zeros((3, 2), np.float32)
    lm = np.zeros((4, 3), np.float32)
    lm[1, 0] = BIG                      # row 1: tie between slots 1 and 2
    a, _, _, cnt = ops.kmeans_lloyd_step(torch.from_numpy(x),
                                         torch.from_numpy(c),
                                         torch.from_numpy(lm))
    wa = np.asarray(jref.kmeans_lloyd_ref(jnp.asarray(x), jnp.asarray(c),
                                          jnp.asarray(lm))[0])
    np.testing.assert_array_equal(a.numpy(), [0, 1, 0, 0])
    np.testing.assert_array_equal(a.numpy(), wa)
    np.testing.assert_array_equal(cnt.numpy(), [3, 1, 0])


def test_lloyd_matches_pallas_interpret_kernel():
    n, d, k = 130, 24, 20
    x, c = _x(5, n, d), _x(6, k, d)
    lm = _lmask(n, k, 7, num_classes=4, masked_rows=3)
    got = ops.kmeans_lloyd_step(torch.from_numpy(x), torch.from_numpy(c),
                                torch.from_numpy(lm))
    want = jops.kmeans_lloyd_step(jnp.asarray(x), jnp.asarray(c),
                                  jnp.asarray(lm))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


def _quant_case(case, n, d, seed):
    r = np.random.default_rng(seed)
    x = (r.normal(size=(n, d)) * 3 + 1).astype(np.float32)
    m = r.random(n) < 0.7
    if case == "all_masked":
        m[:] = False
    elif case == "constant":
        x[:] = np.float32(-0.731)
    elif case == "half_levels":
        # values on exact half steps of the scale: rounding ties to even
        x = (np.arange(n * d, dtype=np.float32).reshape(n, d) % 511) * 0.5
        m[:] = True
    elif case == "one_row":
        m[:] = False
        m[n // 2] = True
    elif case in ("signed_zero", "masked_neg_zero"):
        # the valid rows' minimum is a zero: with both signs among the
        # valid rows (-0.0 after +0.0 in row order), or -0.0 only in a
        # masked row, where it must not reach the statistics
        x = np.abs(x)
        m[:] = True
        m[1] = False
        x[0, 0] = x[n - 1, d - 1] = 0.0
        x[1 if case == "masked_neg_zero" else 2, 3] = -0.0
    elif case in NON_FINITE:
        # one non-finite value in a valid row (or, for masked_nan, in a
        # masked row, where it must not reach the statistics)
        m[:] = True
        m[1] = False
        x[1 if case == "masked_nan" else 2, 3] = NON_FINITE[case]
    return x, m


NON_FINITE = {"nan": np.nan, "pos_inf": np.inf, "neg_inf": -np.inf,
              "masked_nan": np.nan}


@pytest.mark.parametrize("case,n,d", [
    ("random", 100, 1024), ("random", 37, 61), ("all_masked", 20, 9),
    ("constant", 16, 33), ("half_levels", 8, 130), ("one_row", 11, 50),
    ("random", 1, 1), ("nan", 6, 10), ("pos_inf", 6, 10),
    ("neg_inf", 37, 61), ("masked_nan", 6, 10), ("signed_zero", 6, 10),
    ("signed_zero", 37, 61), ("masked_neg_zero", 6, 10)])
def test_quantize_byte_exact(case, n, d):
    x, m = _quant_case(case, n, d, n * d)
    q, xmin, scale = ops.quantize_affine(torch.from_numpy(x),
                                         torch.from_numpy(m))
    wq, wxmin, wscale = jref.quantize_affine_ref(jnp.asarray(x),
                                                 jnp.asarray(m))
    assert q.dtype == torch.int8
    assert q.numpy().tobytes() == np.asarray(wq).tobytes()
    assert np.float32(xmin).tobytes() == np.float32(wxmin).tobytes()
    assert np.float32(scale).tobytes() == np.float32(wscale).tobytes()
    if case == "all_masked":
        assert float(xmin) == 0.0 and float(scale) == 1.0
        assert (q.numpy() == -128).all()
    if case == "constant":
        assert float(scale) == 1.0
        xhat = ref.dequantize_affine_ref(q, xmin, scale).numpy()
        assert (xhat[m] == np.float32(-0.731)).all()
    if case == "nan":           # NaN min/max: the empty selection's params
        assert float(xmin) == 0.0 and float(scale) == 1.0
        assert q[2, 3] == 0     # a code computed from NaN is 0
    if case in ("signed_zero", "masked_neg_zero"):
        assert bool(torch.signbit(xmin)) == (case == "signed_zero")
    if case == "masked_nan":    # the masked row's NaN reaches nothing
        fin, fm = x.copy(), m.copy()
        fin[1, 3] = 0.0
        fq, fxmin, fscale = ops.quantize_affine(torch.from_numpy(fin),
                                                torch.from_numpy(fm))
        assert float(xmin) == float(fxmin) and float(scale) == float(fscale)
        assert q.numpy().tobytes() == fq.numpy().tobytes()


@pytest.mark.parametrize("case", ["random", "nan", "signed_zero"])
def test_quantize_matches_pallas_interpret_kernel(case):
    x, m = _quant_case(case, 70, 300, 11)
    q, xmin, scale = ops.quantize_affine(torch.from_numpy(x),
                                         torch.from_numpy(m))
    wq, wxmin, wscale = jops.quantize_affine(jnp.asarray(x), jnp.asarray(m))
    assert q.numpy().tobytes() == np.asarray(wq).tobytes()
    assert np.float32(xmin).tobytes() == np.float32(wxmin).tobytes()
    assert np.float32(scale).tobytes() == np.float32(wscale).tobytes()


def test_dequantize_matches_reference():
    x, m = _quant_case("random", 30, 40, 3)
    q, xmin, scale = ops.quantize_affine(torch.from_numpy(x),
                                         torch.from_numpy(m))
    got = ref.dequantize_affine_ref(q, xmin, scale).numpy()
    want = np.asarray(jref.dequantize_affine_ref(
        jnp.asarray(q.numpy()), float(xmin), float(scale)))
    assert got.tobytes() == want.tobytes()
    assert np.abs(got[m] - x[m]).max() <= float(scale) / 2 + 1e-6


def test_wrappers_check_their_inputs_and_count_only_launches():
    x = torch.zeros(8, 4)
    c = torch.zeros(3, 4)
    ops.reset_launch_counts()
    ops.kmeans_pairwise_dist(x, c)
    ops.kmeans_lloyd_step(x, c, torch.zeros(8, 3))
    ops.quantize_affine(x, torch.ones(8, dtype=torch.bool))
    ops.quantize_affine_batched(x[None], torch.ones(1, 8, dtype=torch.bool))
    q, kv = torch.zeros(1, 5, 4, 8), torch.zeros(1, 5, 2, 8)
    out, lse = ops.flash_attention(q, kv, kv, return_stats=True)
    ops.flash_attention_bwd(q, kv, kv, out, out, lse)
    ops.flash_decode(q[:, :1], kv, kv, torch.ones(1, 5, dtype=torch.bool))
    ops.flash_decode(q[:, :1], kv, kv, torch.ones(1, 5, dtype=torch.bool),
                     stats=True)
    assert ops.launch_counts() == {"kmeans_pairwise_dist": 0,
                                   "kmeans_lloyd_step": 0,
                                   "quantize_affine": 0,
                                   "quantize_affine_batched": 0,
                                   "flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "flash_decode": 0,
                                   "flash_decode_stats": 0}
    with pytest.raises(TypeError):
        ops.kmeans_pairwise_dist(x.double(), c.double())
    with pytest.raises(ValueError):
        ops.kmeans_pairwise_dist(x, torch.zeros(3, 5))
    with pytest.raises(ValueError):
        ops.kmeans_lloyd_step(x, c, torch.zeros(8, 4))
    with pytest.raises(ValueError):
        ops.kmeans_pairwise_dist(torch.zeros(4, 8).T, c)
    with pytest.raises(TypeError):
        ops.quantize_affine(x, torch.ones(8))
    with pytest.raises(ValueError):
        ops.quantize_affine(x, torch.ones(7, dtype=torch.bool))
