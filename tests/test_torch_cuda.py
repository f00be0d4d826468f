"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test takes the ``card`` fixture, which skips it where
``torch.cuda.is_available()`` is false (as on a CPU-only machine). On a
machine with a GPU:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Levels as in chip_smoke.py: quantize byte-exact; Lloyd bit-identical from
run to run, ``assign`` equal except at near-ties, sums/mindist/distances
within 2e-3; the attention kernels within 2e-3 (f32) and 2e-2 (bf16) of
their plain versions on the same inputs (``tests/test_kernels.py:156``).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda
TOL = 2e-3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(got, want):
    if got.numel() == 0:                # N = 0: nothing to differ
        assert got.shape == want.shape
        return 0.0
    return float(((got - want).abs() / (1.0 + want.abs())).max())


def _misaligned(g, rows, cols, card):
    """A contiguous (rows, cols) f32 tensor whose data starts 4 bytes past
    a 16-byte boundary (no bulk copies: the kernel takes 4-byte ones)."""
    buf = torch.randn(rows * cols + 1, generator=g).to(card)
    t = buf[1:].view(rows, cols)
    assert t.data_ptr() % 16 == 4 and t.is_contiguous()
    return t


# the main path's shapes, ragged ones, then the redesign's edges (the row
# plan, kernels/kmeans.py plan_rows, is checked for each): one row past
# whole blocks (2113 = 132 x 16 + 1), K x D past the resident budget (the
# panel loop), D wide enough for column chunks too, K = 1, and N = 0
# (nothing to launch)
@pytest.mark.parametrize("n,d,k,panels,chunks", [
    (2500, 200, 10, 1, 1), (2500, 200, 100, 1, 1), (1, 1, 1, 1, 1),
    (130, 65, 67, 1, 1), (1037, 61, 7, 1, 1), (3, 200, 10, 1, 1),
    (5, 200, 10, 1, 1), (2113, 200, 100, 1, 1), (1000, 256, 300, 4, 1),
    (100, 16384, 10, 3, 3), (500, 200, 1, 1, 1), (0, 200, 10, 1, 1)])
def test_pairwise_dist_kernel(card, n, d, k, panels, chunks):
    from repro_torch.kernels.kmeans import plan_for
    g = torch.Generator().manual_seed(n + d + k)
    x = torch.randn(n, d, generator=g).to(card)
    c = torch.randn(k, d, generator=g).to(card)
    plan = plan_for(x, c)
    assert (plan.panels, plan.chunks) == (panels, chunks)
    before = ops.kmeans_pairwise_dist.launches
    got = ops.kmeans_pairwise_dist(x, c)
    assert ops.kmeans_pairwise_dist.launches == before + (n > 0)
    assert _rel(got, ref.kmeans_pairwise_dist_ref(x, c)) <= TOL


@pytest.mark.parametrize("n,d,k", [(1037, 61, 7), (130, 63, 100),
                                   (2500, 198, 10)])
def test_pairwise_dist_kernel_unaligned(card, n, d, k):
    """D % 4 != 0 and bases off 16 bytes: the 4-byte copy route."""
    g = torch.Generator().manual_seed(n + d)
    x, c = _misaligned(g, n, d, card), _misaligned(g, k, d, card)
    got = ops.kmeans_pairwise_dist(x, c)
    assert _rel(got, ref.kmeans_pairwise_dist_ref(x, c)) <= TOL


# the kernels take any plan that passes their check: N below a block's
# rows (3 < 16), one row past a block (17 = 16 + 1), and at N = 2,500 the
# 157 blocks of 16 rows, 313 of 8 and 79 of 32
@pytest.mark.parametrize("n,rows", [(3, 16), (17, 16), (2500, 16),
                                    (2500, 8), (2500, 32)])
def test_kmeans_kernels_at_other_row_plans(card, n, rows):
    from repro_torch.kernels import build
    from repro_torch.kernels.kmeans import plan_for_rows
    lib = build.library("kmeans")
    x, c, lm = _lloyd_inputs(card, n, 200, 10, 10, 3, (3, 7))
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(n, 10, device=card)
    assert lib.repro_kmeans_pairwise_dist(
        x.data_ptr(), c[:10].data_ptr(), out.data_ptr(), n, 10, 200,
        *plan_for_rows(n, 10, 200, rows).kernel_args, stream) == 0
    assert _rel(out, ref.kmeans_pairwise_dist_ref(x, c[:10])) <= TOL
    a = torch.empty(n, dtype=torch.int32, device=card)
    md, mem = torch.empty(n, device=card), torch.empty_like(a)
    s, cnt = torch.empty(100, 200, device=card), torch.empty(100, device=card)
    assert lib.repro_kmeans_lloyd(
        x.data_ptr(), c.data_ptr(), lm.data_ptr(), a.data_ptr(),
        md.data_ptr(), mem.data_ptr(), s.data_ptr(), cnt.data_ptr(), n, 100,
        200, *plan_for_rows(n, 100, 200, rows).kernel_args, stream) == 0
    ra, rmd, _, _ = ref.kmeans_lloyd_ref(x, c, lm)
    dist = ref.kmeans_pairwise_dist_ref(x, c) + lm
    diff = torch.nonzero(a != ra)[:, 0]
    if len(diff):
        assert _rel(dist[diff, a[diff].long()],
                    dist[diff, ra[diff].long()]) <= TOL
    assert _rel(md, rmd) <= TOL
    want_s, want_cnt = _ascending_sums(x, a, lm)
    assert s.cpu().numpy().tobytes() == want_s.tobytes()
    assert cnt.cpu().numpy().tobytes() == want_cnt.tobytes()


def _lloyd_inputs(card, n, d, classes, kk, masked, present, unaligned=False):
    g = torch.Generator().manual_seed(n)
    if unaligned:
        x = _misaligned(g, n, d, card)
        c = _misaligned(g, classes * kk, d, card)
    else:
        x = torch.randn(n, d, generator=g).to(card)
        c = torch.randn(classes * kk, d, generator=g).to(card)
    present = torch.tensor(list(present))
    labels = present[torch.randint(len(present), (n,), generator=g)]
    slot = torch.arange(classes * kk) // kk
    lm = torch.where(labels[:, None] == slot[None], 0.0, ref.BIG).float()
    lm[torch.randperm(n, generator=g)[:masked]] = ref.BIG
    return x, c, lm.to(card)


# the main path's shapes (all classes; a k_classes=2 client, 80 slots
# empty), ragged ones, then the redesign's edges: N below one block's rows
# and one past whole blocks, K x D past the resident budget (the panel
# loop), K = 1, every row masked, D % 4 != 0 off 16-byte bases, and N = 0
# (the sums pass alone: zero sums and counts)
@pytest.mark.parametrize("n,d,classes,kk,masked,present,unaligned", [
    (2500, 200, 10, 10, 0, range(10), False),
    (2500, 200, 10, 10, 0, (3, 7), False),
    (777, 45, 7, 10, 20, range(7), False),
    (70, 3, 2, 33, 5, range(2), False),
    (3, 200, 10, 10, 0, (3, 7), False),
    (5, 200, 10, 10, 0, (3, 7), False),
    (2113, 200, 10, 10, 0, (3, 7), False),
    (1000, 256, 10, 30, 0, range(10), False),
    (500, 200, 1, 1, 0, range(1), False),
    (300, 200, 10, 10, 300, (3, 7), False),
    (1037, 61, 10, 10, 7, (3, 7), True),
    (0, 200, 10, 10, 0, (3, 7), False)])
def test_lloyd_kernel(card, n, d, classes, kk, masked, present, unaligned):
    x, c, lm = _lloyd_inputs(card, n, d, classes, kk, masked, present,
                             unaligned)
    out = ops.kmeans_lloyd_step(x, c, lm)
    again = ops.kmeans_lloyd_step(x, c, lm)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    a, md, s, cnt = out
    ra, rmd, rs, rcnt = ref.kmeans_lloyd_ref(x, c, lm)
    dist = ref.kmeans_pairwise_dist_ref(x, c) + lm
    diff = torch.nonzero(a != ra)[:, 0]
    if len(diff):
        assert _rel(dist[diff, a[diff].long()],
                    dist[diff, ra[diff].long()]) <= TOL
    assert _rel(md, rmd) <= TOL
    w = (torch.amin(lm, 1) <= 0).float()
    oh = torch.nn.functional.one_hot(a.long(), classes * kk).float() \
        * w[:, None]
    assert torch.equal(cnt, oh.sum(0))
    assert _rel(s, oh.T @ x) <= TOL


def _ascending_sums(x, assign, lm):
    """Each cluster's sum of its weighted rows, added one row at a time in
    ascending row order from 0, in f32 on the CPU; and the counts."""
    xs, a = x.cpu().numpy(), assign.cpu().numpy()
    w = (torch.amin(lm, 1) <= 0).cpu().numpy()
    sums = np.zeros((lm.shape[1], xs.shape[1]), np.float32)
    counts = np.zeros(lm.shape[1], np.float32)
    for r in np.nonzero(w)[0]:
        sums[a[r]] += xs[r]
        counts[a[r]] += 1
    return sums, counts


@pytest.mark.parametrize("n,d,classes,kk,present", [
    (2500, 200, 10, 10, (3, 7)), (2500, 200, 10, 10, range(10)),
    (1000, 256, 10, 30, range(10))])
def test_lloyd_sums_are_the_ascending_row_sum_bit_for_bit(
        card, n, d, classes, kk, present):
    """Two sweeps give the same bits, and their sums and counts are the
    sequential f32 sum over each cluster's rows in ascending order, taken
    on the CPU from the kernel's own assign."""
    x, c, lm = _lloyd_inputs(card, n, d, classes, kk, 10, present)
    a, md, s, cnt = ops.kmeans_lloyd_step(x, c, lm)
    a2, md2, s2, cnt2 = ops.kmeans_lloyd_step(x, c, lm)
    assert all(torch.equal(u, v) for u, v in
               [(a, a2), (md, md2), (s, s2), (cnt, cnt2)])
    want_s, want_cnt = _ascending_sums(x, a, lm)
    assert s.cpu().numpy().tobytes() == want_s.tobytes()
    assert cnt.cpu().numpy().tobytes() == want_cnt.tobytes()


@pytest.mark.parametrize("n,d,case", [(100, 16384, "slots"),
                                      (37, 1001, "ragged"),
                                      (64, 300, "all_masked"),
                                      (50, 77, "constant")])
def test_quantize_kernel_byte_exact(card, n, d, case):
    r = np.random.default_rng(n)
    x = torch.from_numpy(r.normal(size=(n, d)).astype(np.float32))
    m = torch.from_numpy(r.random(n) < 0.8)
    if case == "all_masked":
        m[:] = False
    if case == "constant":
        x[:] = 0.37
    q, xmin, scale = ops.quantize_affine(x.to(card), m.to(card))
    cq, cxmin, cscale = ref.quantize_affine_ref(x, m)
    assert q.cpu().numpy().tobytes() == cq.numpy().tobytes()
    assert float(xmin) == float(cxmin) and float(scale) == float(cscale)


ATT_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}


def _att_close(got, want, dtype):
    tol = ATT_TOL[dtype]
    got, want = got.float(), want.float()
    assert bool(((got - want).abs() <= tol + tol * want.abs()).all()), \
        float((got - want).abs().max())


def _rand(g, shape, dtype, card):
    return torch.randn(shape, generator=g).to(dtype).to(card)


# chip_smoke.py phase 2b: llama3.2-1b's heads (causal, S=1024, both
# dtypes), a ragged non-causal S, a window, MQA, gemma3's D=256 layer
# shape; then the tensor-core route's edges: S below one key tile, G = 7
# (qwen2-0.5b's 14 heads over 2) at an S that is no multiple of BK, D=128
# and D=256 with a window, and head dims that fill part of a 64-column
# panel (96) or less than one (32); bf16 at D=72 takes the CUDA-core route
@pytest.mark.parametrize("b,s,h,kv,d,causal,window,dtype", [
    (1, 1024, 32, 8, 64, True, 0, torch.bfloat16),
    (1, 1024, 32, 8, 64, True, 0, torch.float32),
    (2, 1000, 8, 2, 64, False, 0, torch.float32),
    (1, 777, 8, 2, 64, True, 128, torch.bfloat16),
    (2, 512, 8, 1, 64, True, 0, torch.bfloat16),
    (1, 2048, 8, 4, 256, True, 1024, torch.bfloat16),
    (1, 300, 6, 2, 96, False, 64, torch.float32),
    (1, 50, 32, 8, 64, True, 0, torch.bfloat16),
    (1, 1000, 14, 2, 64, True, 0, torch.bfloat16),
    (1, 1000, 14, 2, 64, True, 0, torch.float32),
    (1, 1500, 8, 2, 128, True, 256, torch.bfloat16),
    (1, 700, 4, 2, 256, False, 300, torch.bfloat16),
    (2, 300, 4, 2, 96, False, 0, torch.bfloat16),
    (1, 200, 4, 4, 32, True, 0, torch.bfloat16),
    (1, 300, 4, 2, 72, True, 0, torch.bfloat16)])
def test_flash_attention_kernel(card, b, s, h, kv, d, causal, window, dtype):
    from repro_torch.kernels.flash_attention import prefill_route
    g = torch.Generator().manual_seed(s + h + d)
    q = _rand(g, (b, s, h, d), dtype, card)
    k = _rand(g, (b, s, kv, d), dtype, card)
    v = _rand(g, (b, s, kv, d), dtype, card)
    before = ops.flash_attention.launches
    route = prefill_route(dtype, d)
    by_route = ops.flash_attention.launches_by_route[route]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert ops.flash_attention.launches_by_route[route] == by_route + 1
    assert got.dtype == dtype and got.shape == q.shape
    _att_close(got, ref.flash_attention_ref(q, k, v, causal=causal,
                                            window=window), dtype)


def _decode_inputs(card, b, s, h, kv, d, fill, dtype, cache_dtype):
    g = torch.Generator().manual_seed(s + h + d)
    q = _rand(g, (b, 1, h, d), dtype, card)
    kc = _rand(g, (b, s, kv, d), cache_dtype, card)
    vc = _rand(g, (b, s, kv, d), cache_dtype, card)
    if fill is None:                   # a scattered ring: half the slots
        valid = torch.rand((b, s), generator=g) < 0.5
    else:
        valid = (torch.arange(s) < fill).expand(b, s).contiguous()
    return q, kc, vc, valid.to(card)


# chip_smoke.py phase 2b: a 32k cache with 40 valid slots, a ragged S, G=1,
# MQA at D=256 with a bf16 cache under f32 q, scattered valid slots in an
# f32 cache under bf16 q; then the split design's edges: one split (one
# block tile), two splits, many splits (B=1 at S=32768, both caches), G=7
# (qwen2-0.5b) at a ragged S, S below one tile, a head dim whose rows are
# no whole number of 16-byte chunks (element-wise loads)
@pytest.mark.parametrize("b,s,h,kv,d,fill,dtype,cache_dtype", [
    (2, 32768, 32, 8, 64, 40, torch.bfloat16, torch.bfloat16),
    (3, 300, 32, 8, 64, 300, torch.float32, torch.float32),
    (2, 1000, 8, 8, 128, 513, torch.bfloat16, torch.bfloat16),
    (2, 256, 4, 1, 256, 100, torch.float32, torch.bfloat16),
    (2, 130, 8, 2, 64, None, torch.bfloat16, torch.float32),
    (32, 64, 32, 8, 64, 47, torch.bfloat16, torch.bfloat16),
    (4, 128, 32, 8, 64, 100, torch.bfloat16, torch.bfloat16),
    (1, 32768, 32, 8, 64, 30000, torch.bfloat16, torch.bfloat16),
    (1, 32768, 32, 8, 64, None, torch.float32, torch.float32),
    (2, 5000, 14, 2, 64, 4321, torch.bfloat16, torch.bfloat16),
    (3, 17, 14, 2, 64, 9, torch.float32, torch.bfloat16),
    (2, 300, 8, 2, 36, 200, torch.bfloat16, torch.bfloat16)])
def test_flash_decode_kernel(card, b, s, h, kv, d, fill, dtype, cache_dtype):
    from repro_torch.kernels.decode_attention import plan_for
    q, kc, vc, valid = _decode_inputs(card, b, s, h, kv, d, fill, dtype,
                                      cache_dtype)
    before = ops.flash_decode.launches
    got = ops.flash_decode(q, kc, vc, valid)
    torch.cuda.synchronize()
    assert ops.flash_decode.launches == before + 1
    assert ops.flash_decode.last_splits == plan_for(q, kc)[0]
    _att_close(got, ref.flash_decode_ref(q, kc, vc, valid), dtype)


@pytest.mark.parametrize("b,s,splits", [(32, 64, 1), (4, 128, 2),
                                        (1, 32768, None)])
def test_flash_decode_split_counts_and_bits_repeat(card, b, s, splits):
    """One, two and many splits; the same inputs give the same bits twice
    (the splits are merged in order, without atomics)."""
    q, kc, vc, valid = _decode_inputs(card, b, s, 32, 8, 64, s - 3,
                                      torch.bfloat16, torch.bfloat16)
    got = ops.flash_decode(q, kc, vc, valid)
    ran = ops.flash_decode.last_splits
    again = ops.flash_decode(q, kc, vc, valid)
    torch.cuda.synchronize()
    assert ran == splits if splits else ran > 8
    assert torch.equal(got, again)


def test_attention_kernels_refuse_tensors_that_need_grad(card):
    q = torch.randn(1, 64, 4, 32, device=card, requires_grad=True)
    k = torch.randn(1, 64, 2, 32, device=card)
    before = ops.flash_attention.launches, ops.flash_decode.launches
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q, k, k)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_decode(q[:, :1], k, k,
                         torch.ones(1, 64, dtype=torch.bool, device=card))
    assert (ops.flash_attention.launches, ops.flash_decode.launches) == before
