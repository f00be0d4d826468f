"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test takes the ``card`` fixture, which skips it where
``torch.cuda.is_available()`` is false (as on a CPU-only machine). On a
machine with a GPU:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Levels as in chip_smoke.py: quantize byte-exact; Lloyd bit-identical from
run to run, ``assign`` equal except at near-ties, sums/mindist/distances
within 2e-3.
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
    return float(((got - want).abs() / (1.0 + want.abs())).max())


@pytest.mark.parametrize("n,d,k", [(2500, 200, 10), (2500, 200, 100),
                                   (1, 1, 1), (130, 65, 67), (1037, 61, 7)])
def test_pairwise_dist_kernel(card, n, d, k):
    g = torch.Generator().manual_seed(n + d + k)
    x = torch.randn(n, d, generator=g).to(card)
    c = torch.randn(k, d, generator=g).to(card)
    before = ops.kmeans_pairwise_dist.launches
    got = ops.kmeans_pairwise_dist(x, c)
    assert ops.kmeans_pairwise_dist.launches == before + 1
    assert _rel(got, ref.kmeans_pairwise_dist_ref(x, c)) <= TOL


@pytest.mark.parametrize("n,d,classes,kk,masked,present", [
    (2500, 200, 10, 10, 0, range(10)),
    (2500, 200, 10, 10, 0, (3, 7)),     # a k_classes=2 client: 80 slots empty
    (777, 45, 7, 10, 20, range(7)), (70, 3, 2, 33, 5, range(2))])
def test_lloyd_kernel(card, n, d, classes, kk, masked, present):
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, d, generator=g).to(card)
    c = torch.randn(classes * kk, d, generator=g).to(card)
    present = torch.tensor(list(present))
    labels = present[torch.randint(len(present), (n,), generator=g)]
    slot = torch.arange(classes * kk) // kk
    lm = torch.where(labels[:, None] == slot[None], 0.0, ref.BIG).float()
    lm[torch.randperm(n, generator=g)[:masked]] = ref.BIG
    lm = lm.to(card)
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
