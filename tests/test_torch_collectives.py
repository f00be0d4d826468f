"""``core/collectives.py`` on CPU gloo worlds of 2 and 3 processes
(``tests/torch_model_axis_worker.py``'s "collectives" case over the model
axis of a 1 x 2 and a 1 x 3 mesh): ``all_to_all`` along every dim of
f32, bf16 and int32 tensors is, bit for bit, each rank's chunk of every
rank's tensor as a gather gives them, its own inverse;
``reduce_scatter_cat`` is the rank-order sum of the gathered tensors'
chunks; a CPU gloo group keeps the host route (no same-card mailbox
opened, no byte moved on it). On a meta tensor the all-to-all is charged
to an open count by kind and bytes and sends nothing. The same-card
route's piece logic (the halves taking turns, each collective's reads
and rank-order sums) runs here over mailboxes mapped from files, in
pieces of 96 bytes, against the host route, bit for bit; its CUDA IPC
needs one card and the ranks' processes on it (``chip_smoke.py`` phase
16c).
"""
import numpy as np
import pytest
import torch

import torch_model_axis_families as F
from repro_torch.core import collectives as C
from repro_torch.launch import flop_analysis
from test_torch_round import one_torch_thread  # noqa: F401
from torch_once import once

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "int32": torch.int32}
SHAPE = (6, 12, 18)                 # every dim splits over 2 and 3 ranks


def _inputs(world, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.normal(size=(world,) + SHAPE) * 100).to(DTYPES[dtype])


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return once(tmp_path_factory, "collectives_worlds",
                lambda: _worlds(tmp_path_factory))


def _worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("collectives")
    jobs = {w: {("collectives", d): dict(kind="collectives", mesh=(1, w),
                                         x=_inputs(w, d, w))
                for d in DTYPES} for w in (2, 3)}
    for w, job in jobs.items():
        for d in ("f32", "bf16"):
            boxes = tmp / f"boxes_{w}_{d}"
            boxes.mkdir()
            job[("mailbox", d)] = dict(kind="mailbox", mesh=(1, w),
                                       x=_inputs(w, d, w + 10),
                                       dir=str(boxes), piece=96)
    return F.join({w: F._spawn(tmp, w, job) for w, job in jobs.items()})


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("world", [2, 3])
def test_all_to_all_sends_each_rank_its_chunk(worlds, world, dtype):
    x = _inputs(world, dtype, world)
    for r in range(world):
        got, _ = worlds[(world, r)][("collectives", dtype)]
        assert torch.equal(got["every"], x)
        for dim in range(x.ndim - 1):
            want = torch.cat([x[j].chunk(world, dim)[r]
                              for j in range(world)], dim)
            assert torch.equal(got[("all_to_all", dim)], want)


@pytest.mark.parametrize("world", [2, 3])
def test_reduce_scatter_sums_in_rank_order(worlds, world):
    x = _inputs(world, "f32", world)
    total = x[0].clone()
    for t in x[1:]:
        total += t
    for r in range(world):
        got, _ = worlds[(world, r)][("collectives", "f32")]
        for dim in range(x.ndim - 1):
            assert torch.equal(got[("reduce_scatter", dim)],
                               total.chunk(world, dim)[r])


@pytest.mark.parametrize("world", [2, 3])
def test_a_cpu_gloo_group_keeps_the_gloo_route(worlds, world):
    for r in range(world):
        for dtype in DTYPES:
            got, _ = worlds[(world, r)][("collectives", dtype)]
            assert got["route"] is None and got["mailboxes"] == 0
            assert got["moved"] == {"pieces": 0, "bytes": 0}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("world", [2, 3])
def test_the_same_card_pieces_match_the_host_route(worlds, world, dtype):
    """Every collective through the mailboxes (pieces of 96 bytes) gives
    the host route's bits, but the all-reduce's sum: the mailboxes' is
    the rank-order sum of the gathered tensors (gloo's own order is
    another over 3 ranks)."""
    x = _inputs(world, dtype, world + 10)
    total = x[0].clone()
    for t in x[1:]:
        total += t
    for r in range(world):
        got, _ = worlds[(world, r)][("mailbox", dtype)]
        for name, (card, host) in got.items():
            if name not in ("sum", "sum_tree"):
                assert torch.equal(card, host), name
        assert torch.equal(got["sum"][0], total)
        assert torch.equal(got["sum_tree"][0], total)
        assert torch.equal(got["max"][0], x.amax(0))


def test_a_meta_all_to_all_is_charged_not_sent():
    x = torch.empty((8, 4, 3), dtype=torch.bfloat16, device="meta")
    ranks = C.Ranks(None, 0, 4)               # no process group needed
    with flop_analysis.counting() as sc:
        out = C.all_to_all(x, ranks, 1)
    assert out.is_meta and out.shape == x.shape and out.dtype == x.dtype
    assert sc.coll_bytes["all-to-all"] == 8 * 4 * 3 * 2
    assert sc.coll_count["all-to-all"] == 1
