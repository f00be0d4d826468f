"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test takes the ``card`` fixture, which skips it where
``torch.cuda.is_available()`` is false (as on a CPU-only machine). On a
machine with a GPU:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Levels as in chip_smoke.py: quantize byte-exact (non-finite payloads
included) against the plain version on the card and on the CPU; two FL
runs of two rounds bit-identical; Lloyd bit-identical from
run to run, ``assign`` equal except at near-ties, sums/mindist/distances
within 2e-3; the attention kernels (the forward, its statistics and the
backward) within 2e-3 (f32) and 2e-2 (bf16) of their plain versions on
the same inputs (``tests/test_kernels.py:156``), the prefill kernel and the backward also
at a key length unlike S (whisper's cross-attention) on both routes; a
train step's bits repeat; jamba's Mamba layer and whisper's reduced LM
(encoder, self and cross launches) within 2e-3 of the CPU, and a train
round of whisper's and internvl2's reduced LMs with their extras.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.optim.optimizers import tree_leaves

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


NON_FINITE = {"nan": np.nan, "pos_inf": np.inf, "neg_inf": -np.inf,
              "masked_nan": np.nan}


def _quant_payload(case, n, d, card):
    """(x, mask) on the card for one quantize case: 80% of the rows valid
    unless the case says otherwise; ``odd`` lies 4 bytes off 16."""
    r = np.random.default_rng(n + d)
    x = torch.from_numpy(r.normal(size=(n, d)).astype(np.float32))
    m = torch.from_numpy(r.random(n) < 0.8)
    if case == "all_masked":
        m[:] = False
    elif case == "constant":
        x[:] = 0.37
    elif case == "main_path":            # 2 of 10 classes: 20 of 100 slots
        m[:] = False
        m[torch.from_numpy(r.permutation(n)[:20])] = True
    elif case in ("signed_zero", "masked_neg_zero"):
        # the minimum is a zero: +0.0 in rows 0 and n-1 and -0.0 in row 2
        # (a zero of each sign, in different blocks), or -0.0 only in the
        # masked row 1
        x = x.abs()
        m[:] = True
        m[1] = False
        x[0, 0] = x[n - 1, d - 1] = 0.0
        x[1 if case == "masked_neg_zero" else 2, 3] = -0.0
    elif case in NON_FINITE:
        m[:] = True
        m[1] = False
        x[1 if case == "masked_nan" else 2, 3] = float(NON_FINITE[case])
    x = x.to(card)
    if case == "odd":
        buf = torch.empty(n * d + 1, device=card)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(n, d)
        assert x.data_ptr() % 16 == 4
    return x, m.to(card)


# the main path's slots at phase 5's mask and at its own (20 of 100),
# ragged, every row masked, constant, NaN / +inf / -inf in a valid row and
# NaN in a masked one, a zero minimum of both signs and -0.0 only in a
# masked row, a payload past the resident budget (the L2 route),
# D % 4 != 0 off a 16-byte base, N = 1, more rows than one step of the
# kernel's mask walk (256), and the empty payloads N = 0 and D = 0
@pytest.mark.parametrize("n,d,case,resident", [
    (100, 16384, "slots", True), (100, 16384, "main_path", True),
    (37, 1001, "ragged", True), (64, 300, "all_masked", True),
    (50, 77, "constant", True), (100, 16384, "nan", True),
    (100, 16384, "pos_inf", True), (37, 1001, "neg_inf", True),
    (100, 16384, "masked_nan", True), (100, 16384, "signed_zero", True),
    (37, 1001, "signed_zero", True), (100, 16384, "masked_neg_zero", True),
    (2000, 16384, "slots", False),
    (37, 1001, "odd", True), (1, 1, "slots", True),
    (1, 16384, "slots", True), (1037, 61, "ragged", True),
    (0, 16384, "slots", True), (5, 0, "slots", True)])
def test_quantize_kernel_byte_exact(card, n, d, case, resident):
    """Codes and (xmin, scale) equal, bit for bit, to the plain version on
    the card and on the CPU; one launch a call, on the planned route."""
    x, m = _quant_payload(case, n, d, card)
    before = ops.quantize_affine.launches
    q, xmin, scale = ops.quantize_affine(x, m)
    assert ops.quantize_affine.launches == before + 1
    assert ops.quantize_affine.last_plan.resident == resident
    if case in ("signed_zero", "masked_neg_zero"):
        assert bool(torch.signbit(xmin)) == (case == "signed_zero")
    want = [ref.quantize_affine_ref(x, m),
            ref.quantize_affine_ref(x.cpu(), m.cpu())]
    for wq, wxmin, wscale in want:
        assert q.cpu().numpy().tobytes() == wq.cpu().numpy().tobytes()
        assert xmin.cpu().numpy().tobytes() == wxmin.cpu().numpy().tobytes()
        assert (scale.cpu().numpy().tobytes()
                == wscale.cpu().numpy().tobytes())


@pytest.mark.parametrize("case", ["slots", "main_path", "odd"])
def test_quantize_kernel_routes_agree(card, case):
    """The resident and the L2 route give the same bytes at one shape."""
    from repro_torch.kernels.quantize import launch_quantize_affine, plan_for
    x, m = _quant_payload(case, 100, 16384 if case != "odd" else 1001, card)
    out = []
    resident = plan_for(x)
    assert resident.resident
    for plan in (resident, resident._replace(smem_bytes=0, resident=False)):
        q = torch.empty(x.shape, dtype=torch.int8, device=card)
        scratch = torch.empty(2 + 2 * plan.grid, device=card)
        launch_quantize_affine(x, m, q, scratch, plan)
        out.append((q.cpu().numpy().tobytes(),
                    scratch[:2].cpu().numpy().tobytes()))
    wq, wxmin, wscale = ref.quantize_affine_ref(x.cpu(), m.cpu())
    assert out[0] == out[1] == (wq.numpy().tobytes(), torch.stack(
        [wxmin, wscale]).numpy().tobytes())


def _fl_run_twice(card):
    """Two fresh FLSimulations of two rounds of the small WRN-10-1 from one
    seed, in one process: (global weights, ledger, selections, accuracies,
    metadata counts, Lloyd sweeps) of each."""
    from repro_torch.configs import FLConfig, get_wrn_config
    from repro_torch.core.split import make_split_wrn
    from repro_torch.data import SyntheticImageDataset, partition_k_shards
    from repro_torch.fl.simulation import FLSimulation
    cfg = get_wrn_config().reduced()
    ds = SyntheticImageDataset(400, image_size=cfg.image_size,
                               modes_per_class=3, seed=3)
    test = SyntheticImageDataset(100, image_size=cfg.image_size, seed=4)
    clients = partition_k_shards(ds, num_clients=2, k_classes=2,
                                 samples_per_client=100, seed=3)
    fl = FLConfig(num_clients=2, clients_per_round=2, local_batch_size=25,
                  pca_components=16, clusters_per_class=4, kmeans_iters=10,
                  meta_epochs=2, meta_batch_size=8, transport_codec="int8")
    runs = []
    for _ in range(2):
        sim = FLSimulation(make_split_wrn(cfg), clients, test, fl, seed=0,
                           device=card)
        picked, upload = [], sim.channel.upload_knowledge

        def record(*args, _upload=upload, _picked=picked):
            got = _upload(*args)
            _picked.append([t.numpy().tobytes() for t in got])
            return got

        sim.channel.upload_knowledge = record
        res = sim.run(rounds=2)
        runs.append(({k: v.cpu().numpy().tobytes()
                      for k, v in sim.server.global_params.items()},
                     res.comm, picked, res.test_acc, res.fedavg_acc,
                     res.metadata_counts, res.lloyd_iters))
    return runs


def test_fl_rounds_are_bit_reproducible_on_the_card(card):
    """Weights, ledger bytes, the decoded selections, accuracies and Lloyd
    sweeps of two runs of two rounds are equal, bit for bit."""
    first, second = _fl_run_twice(card)
    for name, a, b in zip(("weights", "ledger", "selections", "M_COM",
                           "FedAvg", "|D_M|", "Lloyd sweeps"),
                          first, second):
        assert a == b, f"{name} differ between two runs"


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
# panel (96) or less than one (32); bf16 at D=72 takes the CUDA-core route;
# MLA's D=192 (one kv head a query head) on both routes
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
    (1, 300, 4, 2, 72, True, 0, torch.bfloat16),
    (1, 700, 8, 8, 192, True, 0, torch.bfloat16),
    (1, 300, 4, 4, 192, True, 0, torch.float32)])
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
# no whole number of 16-byte chunks (element-wise loads), MLA's D=192 at
# G=1 (the DMAX 256, GMAX 2 instance)
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
    (2, 300, 8, 2, 36, 200, torch.bfloat16, torch.bfloat16),
    (4, 1000, 16, 16, 192, 513, torch.bfloat16, torch.bfloat16)])
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
    """Only the decode kernel refuses a tensor that needs a gradient (the
    reference never differentiates decode); the prefill kernel under
    autograd runs its forward with statistics, and its backward."""
    q = torch.randn(1, 64, 4, 32, device=card, requires_grad=True)
    k = torch.randn(1, 64, 2, 32, device=card)
    before = (ops.flash_attention.launches, ops.flash_attention_bwd.launches,
              ops.flash_decode.launches)
    out = ops.flash_attention(q, k, k)
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_decode(q[:, :1], k, k,
                         torch.ones(1, 64, dtype=torch.bool, device=card))
    assert (ops.flash_attention.launches, ops.flash_attention_bwd.launches,
            ops.flash_decode.launches) == (before[0] + 1, before[1] + 1,
                                           before[2])


# the backward at chip_smoke.py phase 2b's shapes: llama3.2-1b's heads
# causal at S=1024 in both dtypes, ragged non-causal S=1000, a window of
# 128, MQA, qwen2-0.5b's G=7, gemma3's D=256 with window 1024, S below one
# tile, D=96, D=32; then phi3's D=128 with a window, G=7 non-causal with a
# window, bf16 D=96 (the tensor cores, D padded to 128), G=64 (one query a
# row tile) and bf16 D=72 (the CUDA cores in bf16)
BWD_CASES = [
    (1, 1024, 32, 8, 64, True, 0, torch.bfloat16),
    (1, 1024, 32, 8, 64, True, 0, torch.float32),
    (2, 1000, 8, 2, 64, False, 0, torch.float32),
    (1, 1024, 32, 8, 64, True, 128, torch.bfloat16),
    (2, 512, 8, 1, 64, True, 0, torch.bfloat16),
    (1, 1000, 14, 2, 64, True, 0, torch.bfloat16),
    (1, 2048, 8, 4, 256, True, 1024, torch.bfloat16),
    (1, 50, 32, 8, 64, True, 0, torch.bfloat16),
    (2, 300, 4, 2, 96, False, 0, torch.float32),
    (1, 200, 4, 4, 32, True, 0, torch.bfloat16),
    (1, 1500, 8, 2, 128, True, 256, torch.bfloat16),
    (2, 777, 14, 2, 64, False, 200, torch.bfloat16),
    (1, 300, 4, 2, 96, True, 0, torch.bfloat16),
    (1, 130, 64, 1, 64, True, 0, torch.bfloat16),
    (1, 300, 4, 2, 72, True, 0, torch.bfloat16)]


def _bwd_inputs(card, b, s, h, kv, d, dtype):
    g = torch.Generator().manual_seed(7 * s + h + d)
    return (_rand(g, (b, s, h, d), dtype, card),
            _rand(g, (b, s, kv, d), dtype, card),
            _rand(g, (b, s, kv, d), dtype, card),
            _rand(g, (b, s, h, d), dtype, card))


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,dtype", BWD_CASES[:8] + [
    (1, 300, 4, 2, 72, True, 0, torch.bfloat16)])
def test_flash_attention_stats_on_both_routes(card, b, s, h, kv, d, causal,
                                              window, dtype):
    """The statistics (lse = m + log l, (B,H,S) f32) of the route the dtype
    and D pick, against the plain version's; asking for them changes no
    bit of the output."""
    from repro_torch.kernels.flash_attention import prefill_route
    q, k, v, _ = _bwd_inputs(card, b, s, h, kv, d, dtype)
    route = prefill_route(dtype, d)
    before = ops.flash_attention.launches_by_route[route]
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   return_stats=True)
    plain = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches_by_route[route] == before + 2
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    assert torch.equal(out, plain)
    _, want = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      return_stats=True)
    _att_close(lse, want, dtype)


@pytest.mark.parametrize("b,s,h,kv,d,causal,window,dtype", BWD_CASES)
def test_flash_attention_bwd_kernel(card, b, s, h, kv, d, causal, window,
                                    dtype):
    """dq, dk, dv of the backward kernels against the plain version fed
    the same q, k, v, out, dout and statistics (the kernel forward's);
    one count a call, on the route ``bwd_route`` names; the same bits on a
    second call."""
    from repro_torch.kernels.flash_attention import bwd_route
    q, k, v, dout = _bwd_inputs(card, b, s, h, kv, d, dtype)
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   return_stats=True)
    route = bwd_route(dtype, d, True, h // kv)
    before = ops.flash_attention_bwd.launches
    by_route = ops.flash_attention_bwd.launches_by_route[route]
    got = ops.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                  window=window)
    again = ops.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                    window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention_bwd.launches == before + 2
    assert ops.flash_attention_bwd.launches_by_route[route] == by_route + 2
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                       torch.ones_like(lse), causal=causal,
                                       window=window)
    for x, y, z in zip(got, again, want):
        assert x.dtype == dtype and x.shape == z.shape
        assert torch.equal(x, y)
        _att_close(x, z, dtype)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 9)])
def test_flash_attention_grad_matches_autograd_of_the_plain_version(
        card, causal, window):
    """Under autograd, ops.flash_attention (forward kernel with statistics,
    backward kernels) against autograd through the plain version, f32."""
    g = torch.Generator().manual_seed(3)
    q, k, v = (_rand(g, (2, 77, 6, 32), torch.float32, card),
               _rand(g, (2, 77, 2, 32), torch.float32, card),
               _rand(g, (2, 77, 2, 32), torch.float32, card))
    dout = _rand(g, (2, 77, 6, 32), torch.float32, card)
    grads = []
    for fn in (ops.flash_attention, ref.flash_attention_ref):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*leaves, causal=causal, window=window)
        grads.append(torch.autograd.grad(out, leaves, dout))
    for x, y in zip(*grads):
        _att_close(x, y, torch.float32)


def test_train_step_bits_repeat_on_the_card(card):
    """One federated round of a 4-layer reduced llama3.2-1b (G=2, bf16,
    remat, split FL) twice from the same state: the same bits; the
    cohorts leave with the same weights."""
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import tree_map
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              num_layers=4)
    step, lm = make_train_step(cfg, TrainConfig(microbatch=2,
                                                meta_clusters=2))
    p0 = lm.init(torch.Generator().manual_seed(0), device=card)
    cp = tree_map(lambda t: t[None].expand((2,) + tuple(t.shape)), p0)
    toks = torch.randint(cfg.vocab_size, (2, 2, 1, 4, 64),
                         generator=torch.Generator().manual_seed(1)).to(card)
    runs = [step(cp, (), {"tokens": toks}, [0, 3]) for _ in range(2)]
    (a, _, ma), (b, _, mb) = runs
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y) and torch.equal(x[0], x[1])
    assert {k: float(v) for k, v in ma.items()} == \
        {k: float(v) for k, v in mb.items()}



def _cohort_payload(case, b, n, d, card):
    """(x (B, N, D), mask (B, N)) on the card: client i is
    ``_quant_payload``'s ``case`` payload times i + 1 (so the clients'
    statistics differ); in ``mixed`` client 1 has every row masked and
    client 2 a NaN in a valid row; ``odd`` lies 4 bytes off 16."""
    xs, ms = [], []
    for i in range(b):
        c = case if case != "mixed" else {1: "all_masked",
                                          2: "nan"}.get(i, "ragged")
        x, m = _quant_payload("ragged" if c == "odd" else c, n, d, card)
        xs.append(x * (i + 1))
        ms.append(m)
    x = torch.stack(xs)
    if case == "odd":
        buf = torch.empty(x.numel() + 1, device=card)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(b, n, d)
        assert x.data_ptr() % 16 == 4
    return x, torch.stack(ms)


# the main path's cohort (4 x 100 x 16384, 20 of 100 rows valid each),
# mixed masks (a client all masked, one with NaN), a zero minimum of both
# signs, one client, a client per SM, more clients than SMs at a small D
# (the L2 route), D % 4 != 0 off a 16-byte base, and empty payloads
@pytest.mark.parametrize("b,n,d,case,resident", [
    (4, 100, 16384, "main_path", True), (4, 100, 16384, "mixed", True),
    (3, 37, 1001, "signed_zero", True), (1, 100, 16384, "slots", True),
    (132, 20, 300, "ragged", True), (200, 37, 61, "ragged", False),
    (3, 37, 1001, "odd", True), (2, 0, 64, "slots", True),
    (3, 5, 0, "slots", True)])
def test_quantize_cohort_kernel_byte_exact(card, b, n, d, case, resident):
    """Each client's codes and (xmin, scale) equal, bit for bit, the plain
    version's on the card and on the CPU (and one ``quantize_affine`` call
    per client); one launch a call, on the planned route."""
    x, m = _cohort_payload(case, b, n, d, card)
    before = ops.quantize_affine_batched.launches
    q, xmin, scale = ops.quantize_affine_batched(x, m)
    assert ops.quantize_affine_batched.launches == before + 1
    assert ops.quantize_affine_batched.last_plan.resident == resident
    got = (q.cpu().numpy().tobytes(), xmin.cpu().numpy().tobytes(),
           scale.cpu().numpy().tobytes())
    for wq, wxmin, wscale in [ref.quantize_affine_batched_ref(x, m),
                              ref.quantize_affine_batched_ref(x.cpu(),
                                                              m.cpu())]:
        assert got == (wq.cpu().numpy().tobytes(),
                       wxmin.cpu().numpy().tobytes(),
                       wscale.cpu().numpy().tobytes())
    if b <= 4:
        for i in range(b):
            one = ops.quantize_affine(x[i].contiguous(), m[i])
            assert [t.cpu().numpy().tobytes() for t in one] == [
                t.cpu().numpy().tobytes() for t in (q[i], xmin[i], scale[i])]


def _small_fl(card, **knobs):
    from repro_torch.configs import FLConfig, get_wrn_config
    from repro_torch.core.split import make_split_wrn
    from repro_torch.data import SyntheticImageDataset, partition_k_shards
    cfg = get_wrn_config().reduced()
    ds = SyntheticImageDataset(400, image_size=cfg.image_size,
                               modes_per_class=3, seed=3)
    test = SyntheticImageDataset(100, image_size=cfg.image_size, seed=4)
    clients = partition_k_shards(ds, num_clients=3, k_classes=2,
                                 samples_per_client=100, seed=3)
    fl = FLConfig(num_clients=3, clients_per_round=3, local_batch_size=25,
                  pca_components=16, clusters_per_class=4, kmeans_iters=10,
                  meta_epochs=2, meta_batch_size=8, transport_codec="int8",
                  **knobs)
    return make_split_wrn(cfg), clients, test, fl


def test_cohort_engine_bit_identical_on_the_card(card):
    """Two rounds of the small WRN-10-1 on the card, with and without a
    fault plan: the cohort engine gives the sequential loop's weights,
    ledger, decoded selections, accuracies and fault log, bit for bit, and
    uploads through one batched quantize launch a round."""
    from repro_torch.fl.faults import FaultPlan
    from repro_torch.fl.simulation import FLSimulation
    plan = FaultPlan(drop_rate=0.2, late_crash_rate=0.1, bitflip_rate=0.3,
                     truncate_rate=0.2, duplicate_rate=0.2)
    for fault_plan in (None, plan):
        runs = []
        for distributed in (False, True):
            model, clients, test, fl = _small_fl(
                card, distributed_selection=distributed,
                transport_checksum=fault_plan is not None)
            sim = FLSimulation(model, clients, test, fl, seed=0, device=card,
                               fault_plan=fault_plan, fault_seed=3)
            picked, upload = {}, sim.channel.upload_knowledge

            def record(cid, *args, _upload=upload, _picked=picked, **kw):
                got = _upload(cid, *args, **kw)
                _picked[cid] = (None if got is None else
                                [t.numpy().tobytes() for t in got])
                return got

            sim.channel.upload_knowledge = record
            log, begin = [], sim.channel.begin_round

            def begin_round(t, _begin=begin, _ch=sim.channel, _log=log):
                _log.extend(getattr(_ch, "log", []))
                _begin(t)

            sim.channel.begin_round = begin_round
            ops.reset_launch_counts()
            res = sim.run(rounds=2)
            counts = ops.launch_counts()
            log = sorted((e.round_idx, e.client_id, e.frame, e.kind,
                          e.attempt) for e in log + getattr(sim.channel,
                                                            "log", []))
            runs.append(({k: v.cpu().numpy().tobytes()
                          for k, v in sim.server.global_params.items()},
                         res.comm, picked, res.test_acc, res.fedavg_acc,
                         res.lloyd_iters, res.drops, log))
            # one quantize a knowledge upload on the client loop (none for
            # a client that crashed before uploading), one a round on the
            # cohort engine
            uploads = 6 - sum(e[3] == "crash_before_upload" for e in log)
            assert counts["quantize_affine_batched"] == (2 if distributed
                                                         else 0)
            assert counts["quantize_affine"] == (0 if distributed
                                                 else uploads)
        for what, a, b in zip(("weights", "ledger", "selections", "M_COM",
                               "FedAvg", "Lloyd sweeps", "drops", "faults"),
                              *runs):
            assert a == b, f"{what} differ between the engines"


def test_captured_local_update_matches_the_eager_cpu_step(card):
    """The captured SGD step on the card against the eager loop on the
    CPU, from the same params and batches: within 2e-3."""
    from repro_torch.core import fedavg as fa
    from repro_torch.core.rounds import local_order
    model, clients, _, fl = _small_fl(card)
    gen = torch.Generator().manual_seed(1)
    params = model.init(gen, torch.device("cpu"))
    x = torch.from_numpy(clients[0].data.x)
    y = torch.from_numpy(clients[0].data.y)
    perms = torch.randperm(x.shape[0], generator=gen)[None]
    order = local_order(x.shape[0], perms, fl)
    want, wloss = fa.client_update(params, fl.local_lr, x, y, order,
                                   model.loss)
    got, loss = fa.client_update({k: v.to(card) for k, v in params.items()},
                                 fl.local_lr, x.to(card), y.to(card),
                                 order.to(card), model.loss)
    again, loss2 = fa.client_update(
        {k: v.to(card) for k, v in params.items()}, fl.local_lr, x.to(card),
        y.to(card), order.to(card), model.loss)
    for k in want:
        assert _rel(got[k].cpu(), want[k]) <= TOL, k
        assert torch.equal(got[k], again[k]), k
    assert _rel(loss.cpu(), wloss) <= TOL and torch.equal(loss, loss2)


def test_traced_captured_local_update_syncs_outside_the_capture(card):
    """A LocalUpdate captured and replayed under an active tracer: the
    ``local_update`` span syncs after the replays, never inside the
    capture, and the bits equal an untraced LocalUpdate's. A span opened
    inside a capture skips its sync (a synchronize there would break the
    capture) and is marked ``captured``."""
    from repro_torch import obs
    from repro_torch.core import fedavg as fa
    from repro_torch.core import rounds
    model, clients, _, fl = _small_fl(card)
    gen = torch.Generator().manual_seed(1)
    params = model.init(gen, card)
    x, y = rounds.client_arrays(clients[0], card)
    draws = rounds.GeneratorDraws(gen).client(0, clients[0], 10, 1)
    tr = obs.Tracer()
    steps = fa.CapturedSteps()
    try:
        with obs.use_tracer(tr):
            with obs.span("local_update") as lsp:
                traced, tloss = rounds.update_client(model, params, x, y,
                                                     draws, fl, steps)
                lsp.sync(traced)
        assert len(steps) == 1
        untraced, loss = rounds.update_client(model, params, x, y, draws,
                                              fl, steps)
    finally:
        steps.release()
    assert "captured" not in lsp.attrs and lsp.duration > 0
    assert tloss == loss
    for k in traced:
        assert torch.equal(traced[k], untraced[k]), k
    graph, buf = torch.cuda.CUDAGraph(), torch.zeros(4, device=card)
    with obs.use_tracer(tr):
        with torch.cuda.graph(graph):
            with obs.span("inside") as sp:
                buf.add_(1)
                sp.sync(buf)
    graph.replay()
    torch.cuda.synchronize()
    assert sp.attrs == {"captured": True}
    assert torch.equal(buf, torch.ones(4, device=card))
    graph.reset()


@pytest.mark.parametrize("distributed", [False, True],
                         ids=["client_loop", "cohort_engine"])
def test_degenerate_service_is_the_simulator_on_the_card(card, distributed):
    """The degenerate async service (``DegenerateTraffic``, buffer ==
    cohort) against ``FLSimulation`` on the card, two ticks against two
    rounds: weights, ledger, accuracies and K-means launches bit for bit;
    on the cohort engine the service quantizes a cohort of one a
    client."""
    from repro_torch.fl.service import DegenerateTraffic, FLService
    from repro_torch.fl.simulation import FLSimulation
    model, clients, test, fl = _small_fl(card,
                                         distributed_selection=distributed)
    ops.reset_launch_counts()
    sim = FLSimulation(model, clients, test, fl, seed=0, device=card)
    sres = sim.run(rounds=2)
    sim_counts = ops.launch_counts()
    ops.reset_launch_counts()
    svc = FLService(model, clients, test, fl, seed=0, device=card,
                    traffic=DegenerateTraffic(), buffer_size=3)
    vres = svc.run(ticks=2)
    counts = ops.launch_counts()
    assert {k: v.cpu().numpy().tobytes()
            for k, v in svc.server.global_params.items()} == \
        {k: v.cpu().numpy().tobytes()
         for k, v in sim.server.global_params.items()}
    assert vres.comm == {k: v for k, v in sres.comm.items()
                         if k != "total_samples"}
    assert (vres.test_acc, vres.fedavg_acc) == (sres.test_acc,
                                                sres.fedavg_acc)
    assert vres.mean_staleness == 0.0
    for name in ("kmeans_pairwise_dist", "kmeans_lloyd_step"):
        assert counts[name] == sim_counts[name] > 0, name
    assert counts["quantize_affine"] == sim_counts["quantize_affine"] == \
        (0 if distributed else 6)
    assert counts["quantize_affine_batched"] == (6 if distributed else 0)
    assert sim_counts["quantize_affine_batched"] == (2 if distributed else 0)


def _maps(seed, n=600, classes=6):
    from repro_torch.data.datasets import SyntheticActivationMaps
    ds = SyntheticActivationMaps(num_samples=n, map_shape=(8, 8, 4),
                                 num_classes=classes, rank=24, noise=0.01,
                                 seed=seed, structure_seed=seed)
    y = torch.from_numpy(ds.y.astype(np.int64))
    first = torch.stack([torch.nonzero(y == c)[0, 0]
                         for c in range(classes)])
    return torch.from_numpy(ds.x.astype(np.float32)), y, first


def _slot_centres(feats, labels, first, kk, iters):
    """The CPU run's slot centres: its fused per-class K-means, or its
    all-rows one when ``labels`` is None."""
    from repro_torch.core import selection as sel
    if labels is None:
        return sel.kmeans(feats, kk, int(first), iters).centroids
    classes = len(first)
    c0 = torch.cat([sel.kmeans_init(feats, kk, int(first[c]), labels == c)
                    for c in range(classes)])
    slot = torch.arange(classes * kk) // kk
    lm = torch.where(labels[:, None] == slot[None], 0.0, ref.BIG).float()
    return sel.lloyd_iterate(feats, c0, lm, iters)[0]


@pytest.mark.parametrize("path", ["randomized", "all_rows", "seed_oracle"])
def test_selection_paths_on_the_card_match_the_cpu(card, path):
    """The randomized PCA (one test matrix on both devices), the all-rows
    path with no labels, and the seed oracle on the card against the same
    call on the CPU: ``valid`` equal, >= 99% of the indices equal, each
    mismatch a near-tie (squared distances to the CPU run's slot centre
    within 1e-3 relative); both K-means kernels launched."""
    from repro_torch.core import selection as sel
    x, y, first = _maps(7)
    kk, iters = 5, 25
    labels = None if path == "all_rows" else y
    kw = dict(num_classes=6, clusters_per_class=kk, pca_components=32,
              kmeans_iters=iters)
    if path == "all_rows":
        first = first[0]
        kw.update(clusters_per_class=20, per_class=False)
        kk = 20
    fn = (sel.select_metadata_reference if path == "seed_oracle"
          else sel.select_metadata)
    if path == "randomized":
        kw["pca_solver"] = "randomized"
    want = fn(x, labels, first, **kw)
    ops.reset_launch_counts()
    got = fn(x.to(card), None if labels is None else labels.to(card), first,
             **kw)
    counts = ops.launch_counts()
    assert counts["kmeans_pairwise_dist"] > 0
    # the seed oracle's sweeps are plain one-hot products
    assert (counts["kmeans_lloyd_step"] > 0) == (path != "seed_oracle")
    assert torch.equal(got.valid.cpu(), want.valid)
    idx, widx = got.indices.cpu(), want.indices
    assert float((idx == widx).float().mean()) >= 0.99
    bad = torch.nonzero(idx != widx)[:, 0]
    if len(bad):
        f = want.features
        c = _slot_centres(f, labels, first, kk, iters)
        da = ((f[idx[bad]] - c[bad]) ** 2).sum(1)
        db = ((f[widx[bad]] - c[bad]) ** 2).sum(1)
        assert bool(((da - db).abs() <= 1e-3 * (1 + da)).all()), (da, db)


@pytest.mark.parametrize("solver", ["exact", "randomized"])
def test_batched_selection_is_the_loop_on_the_card(card, solver):
    """``select_metadata_batched`` over 3 stacked clients on the card gives
    each client's ``select_metadata`` bits."""
    from repro_torch.core import selection as sel
    cohort = [_maps(20 + i, n=400) for i in range(3)]
    acts = torch.stack([m[0] for m in cohort]).to(card)
    labels = torch.stack([m[1] for m in cohort]).to(card)
    first = torch.stack([m[2] for m in cohort])
    kw = dict(num_classes=6, clusters_per_class=5, pca_components=24,
              kmeans_iters=25, pca_solver=solver)
    got = sel.select_metadata_batched(acts, labels, first, **kw)
    for i in range(3):
        one = sel.select_metadata(acts[i], labels[i], first[i], **kw)
        assert torch.equal(got.indices[i], one.indices)
        assert torch.equal(got.valid[i], one.valid)
        assert torch.equal(got.features[i], one.features)
        assert got.lloyd_iters[i] == one.lloyd_iters


def test_checkpoint_round_trip_of_card_tensors(card, tmp_path):
    """Card tensors of f32, bf16, int64 and bool saved and restored onto
    the card: bit-equal, dtypes and devices kept."""
    from repro_torch import checkpoint as ckpt
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(64, 32, generator=g).to(card),
            "layers": [torch.randn(8, generator=g).to(torch.bfloat16)
                       .to(card),
                       torch.arange(10, device=card),
                       torch.tensor([True, False], device=card)]}
    ckpt.CheckpointManager(str(tmp_path)).save(1, tree)
    target = {"w": torch.zeros_like(tree["w"]),
              "layers": [torch.zeros_like(t) for t in tree["layers"]]}
    got, meta = ckpt.restore_checkpoint(str(tmp_path), target)
    assert meta["step"] == 1
    for a, b in zip([got["w"]] + got["layers"],
                    [tree["w"]] + tree["layers"]):
        assert a.device == b.device and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_default_test_matrix_is_one_copy_a_card(card):
    """The randomized PCA's default test matrix on the card holds the CPU
    draw's values, and "cuda" and the current card's index share one
    cached copy."""
    from repro_torch.core import selection as sel
    om = sel.default_test_matrix(64, 20, card)
    here = torch.device("cuda", torch.cuda.current_device())
    assert sel.default_test_matrix(64, 20, here) is om
    assert sel.default_test_matrix(64, 20, "cuda") is om
    assert torch.equal(om.cpu(), sel.default_test_matrix(64, 20))


def test_moe_layer_on_the_card_matches_the_cpu_and_itself(card):
    """One MoE layer (32 experts, top 4, 600 tokens in groups of 128, one
    shared expert) in f32: routing, slots and drops equal to the CPU run's
    (a near-tie at a relative gap of 1e-3 excepted), y and aux within
    2e-3, and a second card run the same bits (no atomics)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(
        get_config("qwen3-moe-30b-a3b").reduced(), d_model=256, d_ff=128,
        num_experts=32, num_experts_per_tok=4, num_shared_experts=1)
    g = torch.Generator().manual_seed(0)
    p = L.moe_init(L.ParamInit(g, "cpu"), cfg)
    x = torch.randn(2, 300, cfg.d_model, generator=g)
    pc = {k: v.to(card) for k, v in p.items()}
    y, aux = L.moe_apply(pc, x.to(card), cfg=cfg, group_size=128)
    y2, aux2 = L.moe_apply(pc, x.to(card), cfg=cfg, group_size=128)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    want, want_aux = L.moe_apply(p, x, cfg=cfg, group_size=128)

    def route(pp, xx):
        xn = L.rms_norm(xx, pp["norm"], cfg.norm_eps).reshape(-1,
                                                              cfg.d_model)
        return L.moe_route(pp, xn, cfg=cfg, group_size=128)

    r, rc = route(pc, x.to(card)), route(p, x)
    apart = (r.topi.cpu() != rc.topi)
    for t, j in torch.nonzero(apart).tolist():
        a, b = rc.probs[t, r.topi[t, j].item()], rc.probs[t, rc.topi[t, j]]
        assert abs(a - b) <= 1e-3 * max(abs(a), abs(b))
    # slots and drops differ only in a group that routed apart; y is held
    # on the tokens routed alike, which are nearly all of them
    group = torch.arange(rc.topi.shape[0]) // rc.group_len
    moved = set(group[apart.any(1)].tolist())
    slots_apart = ((r.pos.cpu() != rc.pos) | (r.keep.cpu() != rc.keep)).any(1)
    assert set(group[slots_apart].tolist()) <= moved
    alike = (~apart & (r.keep.cpu() == rc.keep)).all(1)
    assert int(alike.sum()) >= 0.95 * len(alike)
    m = len(alike)
    assert _rel(y.cpu().reshape(-1, cfg.d_model)[:m][alike],
                want.reshape(-1, cfg.d_model)[:m][alike]) <= TOL
    assert abs(float(aux) - float(want_aux)) <= TOL


def test_lean_init_and_moe_decode_on_the_card(card):
    """``LM.init(gen, dtype=bf16)`` on the card gives the bits of the f32
    init cast (the same per-slice draws), and a reduced qwen3-moe's prefill
    and 6 decode steps in f32 match the CPU's from the same parameters
    (decode batch 3: cap 1, so choices drop) within 2e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM, cast_params, tree_map
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    lm = LM(cfg)
    lean = lm.init(torch.Generator(device=card).manual_seed(1),
                   dtype=torch.bfloat16)
    cast = cast_params(lm.init(torch.Generator(device=card).manual_seed(1)),
                       torch.bfloat16)
    for a, b in zip(tree_leaves(lean), tree_leaves(cast), strict=True):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
    p_cpu = lm.init(torch.Generator().manual_seed(2))
    p_card = tree_map(lambda t: t.to(card), p_cpu)
    toks = torch.randint(cfg.vocab_size, (3, 40),
                         generator=torch.Generator().manual_seed(3))
    got, _, aux = lm.apply(p_card, toks.to(card))
    want, _, want_aux = lm.apply(p_cpu, toks)
    assert _rel(got.cpu(), want) <= TOL
    assert abs(float(aux) - float(want_aux)) <= TOL
    caches = [lm.init_cache(3, 8, dtype=torch.float32, device=d)
              for d in (card, "cpu")]
    with torch.no_grad():
        for i in range(6):
            a, caches[0], _ = lm.apply(p_card, toks[:, i:i + 1].to(card),
                                       mode="decode", cache=caches[0])
            b, caches[1], _ = lm.apply(p_cpu, toks[:, i:i + 1],
                                       mode="decode", cache=caches[1])
            assert _rel(a.cpu(), b) <= TOL


def _mla_cfg():
    """A narrow MLA at deepseek-v2's head dims (dn 128, dr 64, dv 128):
    the attention kernels see D 192."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(
        get_config("deepseek-v2-236b").reduced(), d_model=256, num_heads=4,
        kv_lora_rank=64, q_lora_rank=32, qk_nope_head_dim=128,
        qk_rope_head_dim=64, v_head_dim=128, head_dim=192)


def test_mla_layer_on_the_card_matches_the_cpu(card):
    """One MLA layer in f32: prefill of 300 tokens (the prefill kernel,
    CUDA-core route at D 192) and 6 decode steps at batch 2 on an 8-slot
    ring (the decode kernel over the rebuilt heads, and the absorbed
    einsums), card against CPU within 2e-3; in bf16 the prefill runs on
    the tensor cores."""
    from repro_torch.models import layers as L
    cfg = _mla_cfg()
    g = torch.Generator().manual_seed(0)
    p = L.mla_init(L.ParamInit(g), cfg)
    pc = {k: v.to(card) for k, v in p.items()}
    x = torch.randn(2, 300, cfg.d_model, generator=g)
    launches = ops.flash_attention.launches_by_route["cuda_core"]
    got, _ = L.mla_apply(pc, x.to(card), cfg=cfg, mode="full")
    assert ops.flash_attention.launches_by_route["cuda_core"] == \
        launches + 1
    want, _ = L.mla_apply(p, x, cfg=cfg, mode="full")
    assert _rel(got.cpu(), want) <= TOL
    tc = ops.flash_attention.launches_by_route["tensor_core"]
    got16, _ = L.mla_apply({k: v.bfloat16() for k, v in pc.items()},
                           x.to(card).bfloat16(), cfg=cfg, mode="full")
    assert ops.flash_attention.launches_by_route["tensor_core"] == tc + 1
    assert bool(torch.isfinite(got16).all())
    for absorbed in (False, True):
        caches = [L.mla_cache_init(cfg, 2, 8, torch.float32, d)
                  for d in (card, "cpu")]
        before = ops.flash_decode.launches
        with torch.no_grad():
            for i in range(6):
                pos = torch.tensor([i, i + 3], dtype=torch.int32)
                a, _ = L.mla_apply(pc, x[:, i:i + 1].to(card), cfg=cfg,
                                   mode="decode", cache=caches[0],
                                   pos=pos.to(card), absorbed=absorbed)
                b, _ = L.mla_apply(p, x[:, i:i + 1], cfg=cfg, mode="decode",
                                   cache=caches[1], pos=pos,
                                   absorbed=absorbed)
                assert _rel(a.cpu(), b) <= TOL
        assert ops.flash_decode.launches == before + (0 if absorbed else 6)


def test_rwkv_block_on_the_card_matches_the_cpu(card):
    """rwkv6-3b's reduced LM in f32: prefill logits of 128 tokens and 6
    decode steps (the stacked state written in place) card against CPU
    within 2e-3, with no attention kernel launched."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import LM, tree_map
    cfg = get_config("rwkv6-3b").reduced()
    lm = LM(cfg)
    p_cpu = lm.init(torch.Generator().manual_seed(4))
    p_card = tree_map(lambda t: t.to(card), p_cpu)
    toks = torch.randint(cfg.vocab_size, (2, 128),
                         generator=torch.Generator().manual_seed(5))
    before = dict(ops.launch_counts())
    got, _, _ = lm.apply(p_card, toks.to(card))
    want, _, _ = lm.apply(p_cpu, toks)
    assert _rel(got.cpu(), want) <= TOL
    caches = [lm.init_cache(2, 1, device=d) for d in (card, "cpu")]
    with torch.no_grad():
        for i in range(6):
            a, caches[0], _ = lm.apply(p_card, toks[:, i:i + 1].to(card),
                                       mode="decode", cache=caches[0])
            b, caches[1], _ = lm.apply(p_cpu, toks[:, i:i + 1],
                                       mode="decode", cache=caches[1])
            assert _rel(a.cpu(), b) <= TOL
    assert ops.launch_counts() == before


# whisper's cross-attention: S decoder queries over Sk encoder keys,
# non-causal, on both routes: one query, Sk ragged, S below and above Sk
# (its 1,500 frames), Sk below one key tile at D=128 and G=4, f32 on the
# CUDA cores at D=64 and D=96
@pytest.mark.parametrize("b,s,sk,h,kv,d,dtype", [
    (2, 1, 16, 4, 4, 64, torch.bfloat16),
    (2, 12, 100, 16, 16, 64, torch.bfloat16),
    (1, 300, 1500, 16, 16, 64, torch.bfloat16),
    (1, 2000, 1500, 16, 16, 64, torch.bfloat16),
    (2, 40, 7, 8, 2, 128, torch.bfloat16),
    (1, 300, 1500, 16, 16, 64, torch.float32),
    (2, 77, 50, 8, 2, 96, torch.float32)])
def test_flash_attention_kernel_with_a_key_length_unlike_s(card, b, s, sk,
                                                           h, kv, d, dtype):
    from repro_torch.kernels.flash_attention import prefill_route
    g = torch.Generator().manual_seed(s + sk + d)
    q = _rand(g, (b, s, h, d), dtype, card)
    k = _rand(g, (b, sk, kv, d), dtype, card)
    v = _rand(g, (b, sk, kv, d), dtype, card)
    route = prefill_route(dtype, d)
    ops.reset_launch_counts()
    got, lse = ops.flash_attention(q, k, v, causal=False, return_stats=True)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches_by_route[route] == 1
    assert ops.flash_attention.launches_by_lengths == {f"{s}x{sk}": 1}
    want, wlse = ref.flash_attention_ref(q, k, v, causal=False,
                                         return_stats=True)
    _att_close(got, want, dtype)
    assert float((lse - wlse).abs().max()) <= ATT_TOL[dtype]
    # the decode kernel over a fully valid memory: the first query's rows
    valid = torch.ones(b, sk, dtype=torch.bool, device=card)
    one = ops.flash_decode(q[:, :1].contiguous(), k, v, valid)
    _att_close(one, want[:, :1], dtype)
    assert ops.flash_decode.launches_by_lengths == {f"1x{sk}": 1}


# the backward at a key length Sk unlike S (chip_smoke.py phase 2b's
# cases): whisper's cross layer in both dtypes, S above Sk, Sk below one
# key tile, Sk no tile multiple with GQA at D=128, D=96 in f32; then
# whisper's encoder layer (S = Sk, non-causal) in bf16
@pytest.mark.parametrize("b,s,sk,h,kv,d,dtype", [
    (2, 300, 1500, 16, 16, 64, torch.bfloat16),
    (2, 300, 1500, 16, 16, 64, torch.float32),
    (1, 2000, 1500, 16, 16, 64, torch.bfloat16),
    (2, 130, 7, 8, 2, 64, torch.bfloat16),
    (2, 333, 1000, 16, 4, 128, torch.bfloat16),
    (2, 77, 50, 8, 2, 96, torch.float32),
    (2, 1500, 1500, 16, 16, 64, torch.bfloat16)])
def test_flash_attention_bwd_kernel_with_a_key_length_unlike_s(
        card, b, s, sk, h, kv, d, dtype):
    """dq (B,S,H,D), dk, dv (B,Sk,KV,D) of the backward kernels against the
    plain version on the same inputs and statistics; one count a call on
    the route ``bwd_route`` names, counted under ``"<S>x<Sk>"``; the same
    bits on a second call; a causal or windowed call raises."""
    from repro_torch.kernels.flash_attention import bwd_route
    g = torch.Generator().manual_seed(3 * s + sk + d)
    q = _rand(g, (b, s, h, d), dtype, card)
    k = _rand(g, (b, sk, kv, d), dtype, card)
    v = _rand(g, (b, sk, kv, d), dtype, card)
    dout = _rand(g, (b, s, h, d), dtype, card)
    out, lse = ops.flash_attention(q, k, v, causal=False, return_stats=True)
    route = bwd_route(dtype, d, True, h // kv)
    ops.reset_launch_counts()
    got = ops.flash_attention_bwd(q, k, v, out, dout, lse, causal=False)
    again = ops.flash_attention_bwd(q, k, v, out, dout, lse, causal=False)
    torch.cuda.synchronize()
    assert ops.flash_attention_bwd.launches_by_route[route] == 2
    assert ops.flash_attention_bwd.launches_by_lengths == {f"{s}x{sk}": 2}
    want = ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                       torch.ones_like(lse), causal=False)
    for x, y, z in zip(got, again, want):
        assert x.dtype == dtype and x.shape == z.shape
        assert torch.equal(x, y)
        _att_close(x, z, dtype)
    if sk != s:
        for mask in ({"causal": True}, {"causal": False, "window": 8}):
            with pytest.raises(ValueError, match="causal=False"):
                ops.flash_attention_bwd(q, k, v, out, dout, lse, **mask)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-26b"])
def test_train_step_with_the_extras_on_the_card_matches_the_cpu(card, arch):
    """One round of the reduced arch with its extra (enc_frames or
    prefix_embeds), f32, split FL on, card against CPU within 2e-3, each
    leaf's update within 2e-3 of the CPU's update's norm (the backward at
    Sk unlike S on the CUDA cores for whisper's cross layers); selections
    equal."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.transformer import tree_map
    cfg = get_config(arch).reduced()
    step, lm = make_train_step(cfg, TrainConfig(dtype="float32",
                                                microbatch=4,
                                                meta_clusters=4))
    p_cpu = lm.init(torch.Generator().manual_seed(4))
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(cfg.vocab_size, (2, 2, 1, 4, 24), generator=g)
    key, n = (("enc_frames", cfg.encoder_seq_len) if cfg.is_encoder_decoder
              else ("prefix_embeds", cfg.num_prefix_tokens))
    extra = torch.randn(2, 2, 1, 4, n, cfg.d_model, generator=g)
    ops.reset_launch_counts()
    runs = []
    for dev in ("cpu", card):
        p = tree_map(lambda t: t.to(dev), p_cpu)
        cp = tree_map(lambda t: t[None].expand((2,) + tuple(t.shape)), p)
        new, _, m = step(cp, (), {"tokens": toks.to(dev),
                                  key: extra.to(dev)}, [1, 2])
        runs.append((tree_leaves(new), {k: float(v) for k, v in m.items()}))
    (lc, mc), (lg, mg) = runs
    assert mg["selected"] == mc["selected"]
    for name in mc:
        assert abs(mg[name] - mc[name]) <= TOL * (1 + abs(mc[name]))
    for x, y, old in zip(lg, lc, tree_leaves(p_cpu)):
        assert _rel(x.cpu(), y) <= TOL
        # the update itself, against the CPU's update's own size: every
        # leaf moves (the encoder's through the cross-attention's gradient)
        size = float((y - old).norm())
        assert size > 0
        assert float((x.cpu() - y).norm()) <= TOL * size
    assert ops.flash_attention_bwd.launches > 0
    if cfg.is_encoder_decoder:
        assert f"24x{cfg.encoder_seq_len}" in \
            ops.flash_attention_bwd.launches_by_lengths


def test_mamba_and_whisper_on_the_card_match_the_cpu(card):
    """jamba's reduced Mamba layer in f32 (a 300-token prefill, 6 decode
    steps writing the state in place) and whisper's reduced LM in f32 (the
    encoder's non-causal launches, the decoder's causal and cross ones,
    then 6 decode steps: self and cross decode launches), card against
    CPU within 2e-3."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import LM, tree_map
    jcfg = get_config("jamba-1.5-large-398b").reduced()
    g = torch.Generator().manual_seed(8)
    p = L.mamba_init(L.ParamInit(g), jcfg)
    pc = {k: v.to(card) for k, v in p.items()}
    x = torch.randn(2, 300, jcfg.d_model, generator=g)
    got, _ = L.mamba_apply(pc, x.to(card), cfg=jcfg, mode="full")
    want, _ = L.mamba_apply(p, x, cfg=jcfg, mode="full")
    assert _rel(got.cpu(), want) <= TOL
    caches = [L.mamba_cache_init(jcfg, 2, device=d) for d in (card, "cpu")]
    with torch.no_grad():
        for i in range(6):
            a, _ = L.mamba_apply(pc, x[:, i:i + 1].to(card), cfg=jcfg,
                                 mode="decode", cache=caches[0])
            b, _ = L.mamba_apply(p, x[:, i:i + 1], cfg=jcfg, mode="decode",
                                 cache=caches[1])
            assert _rel(a.cpu(), b) <= TOL
    assert _rel(caches[0]["ssm"].cpu(), caches[1]["ssm"]) <= TOL

    cfg = get_config("whisper-medium").reduced()
    lm = LM(cfg)
    p_cpu = lm.init(torch.Generator().manual_seed(9))
    p_card = tree_map(lambda t: t.to(card), p_cpu)
    toks = torch.randint(cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(10))
    frames = torch.randn(2, cfg.encoder_seq_len, cfg.d_model,
                         generator=torch.Generator().manual_seed(11))
    before = ops.flash_attention.launches
    with torch.no_grad():
        got, _, _ = lm.apply(p_card, toks.to(card),
                             enc_frames=frames.to(card))
    # the encoder's layers, then each decoder layer's self and cross
    assert ops.flash_attention.launches == before + cfg.encoder_layers \
        + 2 * cfg.num_layers
    want, _, _ = lm.apply(p_cpu, toks, enc_frames=frames)
    assert _rel(got.cpu(), want) <= TOL
    caches = [lm.init_cache(2, 8, dtype=torch.float32, device=d)
              for d in (card, "cpu")]
    with torch.no_grad():
        caches[0]["enc_out"] = lm.encode(p_card, frames.to(card))
        caches[1]["enc_out"] = lm.encode(p_cpu, frames)
        before = ops.flash_decode.launches
        for i in range(6):
            a, caches[0], _ = lm.apply(p_card, toks[:, i:i + 1].to(card),
                                       mode="decode", cache=caches[0])
            b, caches[1], _ = lm.apply(p_cpu, toks[:, i:i + 1],
                                       mode="decode", cache=caches[1])
            assert _rel(a.cpu(), b) <= TOL
    assert ops.flash_decode.launches == before + 6 * 2 * cfg.num_layers
