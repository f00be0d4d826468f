"""The host-side row plan of the port's K-means kernels, on the CPU.

``kmeans.plan_rows`` decides how the distance core of
``csrc/kmeans.cu`` covers an (N, D) x (K, D) problem: the rows of x a
block owns, the centroids one shared-memory panel holds, the columns of D
staged at once, the panel's row stride and the threads that share a tile.
These tests hold, at shapes from one row to 100,000 and from one column to
16,384, that

* every row is covered exactly once, in order, and every (row, centroid)
  pair has exactly one owning thread in the kernel's thread mapping;
* a block's shared memory stays within 227 KB (and lets two blocks share
  an SM at the main path's shapes);
* the grid fills at least one wave of 132 SMs where N allows it;
* the panel loop is taken when K x D exceeds the budget;
* N = 0 plans no blocks;
* the module imports, and the wrappers run their plain versions, without
  CUDA.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import kmeans as km
from repro_torch.kernels import ops, ref

H100_SMS = 132
NS = [1, 15, 16, 17, 2500, 100000]
KS = [1, 10, 100, 1000]
DS = [1, 61, 200, 16384]


def _owners(plan):
    """(row in block, centroid in panel) -> owning threads, as the kernel
    maps its THREADS threads (csrc/kmeans.cu dist_core: ``split``
    consecutive threads share a tile of TR rows x TC centroids, the
    centroids strided by the number of centroid groups)."""
    ncg = -(-plan.panel // km.TC)
    owners = {}
    for tid in range(km.THREADS):
        sub, grp = tid % plan.split, tid // plan.split
        if sub or grp >= -(-plan.rows // km.TR) * ncg:
            continue
        rg, cg = divmod(grp, ncg)
        for i in range(km.TR):
            for j in range(km.TC):
                r, cc = rg * km.TR + i, cg + j * ncg
                if r < plan.rows and cc < plan.panel:
                    owners.setdefault((r, cc), []).append(tid)
    return owners


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_row_plan_covers_every_row_once_in_order(n, k):
    for d in DS:
        p = km.plan_rows(n, k, d, H100_SMS)
        assert p.blocks == -(-n // p.rows)
        spans = [(b * p.rows, min(n, (b + 1) * p.rows))
                 for b in range(p.blocks)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(lo < hi for lo, hi in spans)                  # none empty
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))  # in order
        assert 1 <= p.rows <= km.MAX_ROWS
        # the panels and the column chunks cover K and D the same way
        assert p.panels == -(-k // p.panel) and 1 <= p.panel <= k
        assert p.chunks == -(-d // p.width) and p.width % 4 == 0
        assert p.width <= 4 * -(-d // 4)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n", NS)
def test_row_plan_fits_shared_memory_and_fills_the_card(n, k):
    for d in DS:
        p = km.plan_rows(n, k, d, H100_SMS)
        assert p.smem == km.smem_bytes(p.rows, p.panel, p.width, p.stride)
        assert p.smem <= km.TWO_BLOCKS <= km.SMEM_MAX == 227 * 1024
        if n >= H100_SMS:                    # N allows a full wave
            assert p.blocks >= H100_SMS
            # and no fewer rows a block than that needs
            assert p.rows == km.MAX_ROWS or -(-n // (p.rows + 1)) < H100_SMS
        else:                                # the most blocks it can have
            assert p.rows == 1
        # every tile has its threads, and the panel's row stride keeps a
        # quarter-warp's float4 reads on 32 different banks
        tiles = -(-p.rows // km.TR) * -(-p.panel // km.TC)
        assert tiles * p.split <= km.THREADS
        assert p.split & (p.split - 1) == 0 and p.split <= km.MAX_SPLIT
        assert p.stride >= p.width and p.stride % 4 == 0
        assert p.split >= 8 or (p.stride // 4) % 8 == p.split


@pytest.mark.parametrize("n,k,d", [(2500, 100, 200), (2500, 10, 200),
                                   (17, 1000, 61), (100000, 1, 16384),
                                   (15, 10, 1), (1000, 300, 256)])
def test_every_distance_has_one_owning_thread(n, k, d):
    p = km.plan_rows(n, k, d, H100_SMS)
    owners = _owners(p)
    assert len(owners) == p.rows * p.panel
    assert all(len(t) == 1 for t in owners.values())


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("k,d", [(1000, 16384), (1000, 200), (100, 16384),
                                 (300, 256), (10, 200), (100, 200), (1, 1)])
def test_panel_loop_when_the_centroids_exceed_the_budget(n, k, d):
    p = km.plan_rows(n, k, d, H100_SMS)
    split, stride = km._split_and_stride(p.rows, k, 4 * -(-d // 4))
    whole = km.smem_bytes(p.rows, k, 4 * -(-d // 4), stride)
    if whole > km.TWO_BLOCKS:
        assert p.panels > 1
    if p.panels == 1:                       # resident: all of K, all of D
        assert p.panel == k and p.chunks == 1 and whole <= km.TWO_BLOCKS


def test_row_plan_at_the_main_path_shapes():
    # a farthest-point-init step: 19 rows a block, one wave of 132 blocks
    init = km.plan_rows(2500, 10, 200, H100_SMS)
    assert (init.rows, init.blocks, init.panels, init.chunks) == (19, 132, 1,
                                                                  1)
    # a Lloyd sweep: the 100 x 200 panel resident, two blocks an SM
    sweep = km.plan_rows(2500, 100, 200, H100_SMS)
    assert (sweep.rows, sweep.blocks, sweep.panel, sweep.panels) == (
        19, 132, 100, 1)
    assert 2 * (sweep.smem + km.SMEM_PER_BLOCK) <= km.SMEM_PER_SM
    # the card case of the panel loop: K x D past the budget
    assert km.plan_rows(1000, 300, 256, H100_SMS).panels > 1


def test_row_plan_refuses_empty_centroids_and_widths():
    for args in [(-1, 10, 200, 132), (10, 0, 200, 132), (10, 10, 0, 132),
                 (10, 10, 200, 0)]:
        with pytest.raises(ValueError):
            km.plan_rows(*args)
    for rows in (0, km.MAX_ROWS + 1):
        with pytest.raises(ValueError):
            km.plan_for_rows(10, 10, 200, rows)


@pytest.mark.parametrize("k,d", [(10, 200), (100, 200), (1000, 256)])
def test_row_plan_at_n_zero_has_no_blocks(k, d):
    # a Lloyd sweep of no rows still runs its sums pass (zero sums)
    p = km.plan_rows(0, k, d, H100_SMS)
    assert p.blocks == 0 and p.rows == 1
    assert p == km.plan_for_rows(0, k, d, 1)
    assert p.smem <= km.TWO_BLOCKS and 1 <= p.panel <= k


@pytest.mark.parametrize("n,rows", [(3, 16), (17, 16), (2500, 8),
                                    (2500, 32)])
def test_plans_for_other_row_counts_hold_the_same_rules(n, rows):
    # the card tests run these plans, which the planner would not pick
    for k, d in [(10, 200), (100, 200), (300, 256)]:
        p = km.plan_for_rows(n, k, d, rows)
        assert p.rows == rows and p.blocks == -(-n // rows)
        assert p.smem <= km.TWO_BLOCKS
        tiles = -(-rows // km.TR) * -(-p.panel // km.TC)
        assert tiles * p.split <= km.THREADS
        owners = _owners(p)
        assert len(owners) == rows * p.panel
        assert all(len(t) == 1 for t in owners.values())


def test_kernel_args_are_the_plans_fields_in_the_c_order():
    p = km.plan_rows(2500, 100, 200, H100_SMS)
    assert p.kernel_args == (p.rows, p.panel, p.width, p.stride, p.split,
                             p.smem)


@pytest.mark.parametrize("n,d,k", [(1, 1, 1), (17, 61, 10), (300, 200, 100)])
def test_plain_versions_run_on_cpu_tensors(n, d, k):
    r = np.random.default_rng(n + d + k)
    x = torch.from_numpy(r.normal(size=(n, d)).astype(np.float32))
    c = torch.from_numpy(r.normal(size=(k, d)).astype(np.float32))
    lm = torch.from_numpy(np.where(r.random((n, k)) < 0.5, 0.0,
                                   ref.BIG).astype(np.float32))
    before = ops.launch_counts()
    dist = ops.kmeans_pairwise_dist(x, c)
    assert torch.equal(dist, ref.kmeans_pairwise_dist_ref(x, c))
    out = ops.kmeans_lloyd_step(x, c, lm)
    for got, want in zip(out, ref.kmeans_lloyd_ref(x, c, lm)):
        assert torch.equal(got, want)
    assert ops.launch_counts() == before     # the CPU launches no kernel
