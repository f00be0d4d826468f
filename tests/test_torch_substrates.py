"""Parity of the port's substrates with the reference's, on the CPU.

``repro_torch.optim`` (the schedules, ``adamw``, ``global_norm``,
``clip_by_global_norm``), ``core.fedavg.client_drift``,
``core.split.tree_slice_layers`` and ``data.pipeline`` (``batched_epoch``,
``BatchIterator``) against ``repro``'s on the same numpy inputs, and the
cases of ``tests/test_substrates.py`` that hold the reference's optimizer
and data pipeline, run on the port. The schedules on a grid of steps
(1e-6 relative: the two round a step's division at other points);
``adamw`` over 10 steps of numpy gradients, with and without weight
decay and a schedule (2e-6); the norms, the clip, the drift and the slices
within 1e-6 or equal. The pipeline is fed ``repro``'s permutations (the
reference draws them from ``np.random.default_rng(seed + epoch)``) and its
fill of a small client, and must give the same batches; its own draws
come from a ``torch.Generator``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.fedavg import client_drift as jclient_drift
from repro.core.split import tree_slice_layers as jtree_slice_layers
from repro.data import BatchIterator as JBatchIterator
from repro.data import SyntheticImageDataset as JSyntheticImageDataset
from repro.data.pipeline import batched_epoch as jbatched_epoch
from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import constant as jconstant
from repro.optim import cosine_decay as jcosine_decay
from repro.optim import global_norm as jglobal_norm
from repro.optim import step_decay as jstep_decay
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.core.fedavg import client_drift
from repro_torch.core.split import tree_slice_layers
from repro_torch.data import BatchIterator, SyntheticImageDataset
from repro_torch.data.pipeline import batched_epoch
from repro_torch.optim import (adamw, apply_l2, clip_by_global_norm,
                               constant, cosine_decay, global_norm, sgd,
                               step_decay, tree_leaves, tree_map,
                               warmup_cosine)
from test_torch_round import one_torch_thread  # noqa: F401

SCHEDULES = {
    "constant": (constant, jconstant, (0.1,)),
    "cosine_decay": (cosine_decay, jcosine_decay, (1.0, 100)),
    "cosine_decay_alpha": (cosine_decay, jcosine_decay, (0.3, 37, 0.1)),
    "warmup_cosine": (warmup_cosine, jwarmup_cosine, (1.0, 10, 110)),
    "warmup_cosine_alpha": (warmup_cosine, jwarmup_cosine,
                            (0.5, 7, 50, 0.05)),
    "step_decay": (step_decay, jstep_decay, (1.0, [10, 20], 0.1)),
}
STEPS = [0, 1, 3, 5, 7, 9, 10, 11, 15, 19, 20, 25, 36, 37, 50, 99, 100,
         110, 200]


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_the_reference_on_a_grid_of_steps(name):
    mine, theirs, args = SCHEDULES[name]
    f, jf = mine(*args), theirs(*args)
    for step in STEPS:
        got = f(step)
        assert got.dtype == torch.float32 and got.ndim == 0
        np.testing.assert_allclose(float(got), float(jf(step)), rtol=1e-6,
                                   atol=1e-7)
    # an optimizer's count (a 0-d int tensor) is a step too
    np.testing.assert_allclose(float(f(torch.tensor(15, dtype=torch.int32))),
                               float(jf(15)), rtol=1e-6, atol=1e-7)


def _tree(rng):
    return {"b": rng.normal(size=(5,)).astype(np.float32),
            "layers": [{"w": rng.normal(size=(3, 4, 2)).astype(np.float32)},
                       {"w": rng.normal(size=(3, 6)).astype(np.float32)}]}


def _torch(tree):
    return tree_map(torch.from_numpy, tree)


def _np_leaves(tree):
    return [x.numpy() for x in tree_leaves(tree)]


@pytest.mark.parametrize("wd,sched", [(0.0, False), (0.01, False),
                                      (0.01, True)])
def test_adamw_matches_the_reference_over_10_steps(wd, sched):
    rng = np.random.default_rng(1)
    p0, grads = _tree(rng), [_tree(rng) for _ in range(10)]
    lr = (warmup_cosine(0.1, 3, 10), jwarmup_cosine(0.1, 3, 10)) if sched \
        else (0.05, 0.05)
    opt, jopt = adamw(lr[0], weight_decay=wd), jadamw(lr[1], weight_decay=wd)
    p, jp = _torch(p0), jax.tree.map(jnp.asarray, p0)
    s, js = opt.init(p), jopt.init(jp)
    for g in grads:
        p, s = opt.apply(_torch(g), s, p)
        jp, js = jopt.apply(jax.tree.map(jnp.asarray, g), js, jp)
    assert int(s.count) == int(js.count) == 10
    for mine, theirs in ((p, jp), (s.mu, js.mu), (s.nu, js.nu)):
        for a, b in zip(_np_leaves(mine), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2e-6,
                                       atol=2e-6)


def test_global_norm_and_clip_match_the_reference():
    rng = np.random.default_rng(2)
    tree = _tree(rng)
    jtree = jax.tree.map(jnp.asarray, tree)
    np.testing.assert_allclose(float(global_norm(_torch(tree))),
                               float(jglobal_norm(jtree)), rtol=1e-6)
    for max_norm in (0.5, 1e3):                 # clipped, left as it is
        got = clip_by_global_norm(_torch(tree), max_norm)
        for a, b in zip(_np_leaves(got), jax.tree.leaves(jclip(jtree,
                                                              max_norm))):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def test_client_drift_and_tree_slice_layers_match_the_reference():
    rng = np.random.default_rng(3)
    glob = _tree(rng)
    clients = [_tree(rng) for _ in range(3)]
    np.testing.assert_allclose(
        float(client_drift([_torch(c) for c in clients], _torch(glob))),
        float(jclient_drift([jax.tree.map(jnp.asarray, c) for c in clients],
                            jax.tree.map(jnp.asarray, glob))), rtol=1e-6)
    stacked = {"layers": [rng.normal(size=(6, 4)).astype(np.float32),
                          rng.normal(size=(6, 2, 3)).astype(np.float32)]}
    for start, stop in ((0, 6), (2, 5), (5, 6)):
        got = tree_slice_layers(_torch(stacked), start, stop)
        want = jtree_slice_layers(jax.tree.map(jnp.asarray, stacked), start,
                                  stop)
        for a, b in zip(_np_leaves(got), jax.tree.leaves(want)):
            assert np.array_equal(a, np.asarray(b))


def _ref_orders(n, seed):
    """The reference's permutation of each epoch."""
    return lambda epoch: np.random.default_rng(seed + epoch).permutation(n)


@pytest.mark.parametrize("n,batch,drop", [(55, 10, True), (55, 10, False),
                                          (40, 8, True), (7, 10, False)])
def test_batched_epoch_fed_the_references_order_gives_its_batches(
        n, batch, drop):
    ds, jds = (SyntheticImageDataset(n, image_size=8, seed=0),
               JSyntheticImageDataset(n, image_size=8, seed=0))
    order = np.random.default_rng(4).permutation(n)
    got = list(batched_epoch(ds, batch, drop_remainder=drop, order=order))
    want = list(jbatched_epoch(jds, batch, seed=4, drop_remainder=drop))
    assert len(got) == len(want)
    for (x, y), (jx, jy) in zip(got, want):
        assert np.array_equal(x, jx) and np.array_equal(y, jy)


@pytest.mark.parametrize("n,batch,seed", [(55, 10, 0), (23, 4, 5),
                                          (6, 10, 2)])
def test_batch_iterator_fed_the_references_draws_gives_its_batches(
        n, batch, seed):
    """Over 3 epochs; a client of 6 rows is first filled to a batch with
    the reference's draw (with replacement)."""
    ds, jds = (SyntheticImageDataset(n, image_size=8, seed=1),
               JSyntheticImageDataset(n, image_size=8, seed=1))
    fill = (np.random.default_rng(seed).choice(n, batch, replace=True)
            if n < batch else None)
    it = BatchIterator(ds, batch, seed=seed,
                       orders=_ref_orders(max(n, batch), seed), fill=fill)
    jit_ = JBatchIterator(jds, batch, seed=seed)
    steps = 3 * max(max(n, batch) // batch, 1)
    for _ in range(steps):
        (x, y), (jx, jy) = next(it), next(jit_)
        assert np.array_equal(x, jx) and np.array_equal(y, jy)
    assert it.epoch == jit_.epoch


def test_the_pipelines_own_draws_come_from_a_generator():
    """Without draws passed in: every row once an epoch, the same batches
    from the same seed, other batches from another."""
    ds = SyntheticImageDataset(40, image_size=8, seed=0)
    rows = lambda it, k: np.concatenate([next(it)[1] for _ in range(k)])
    a, b, c = (BatchIterator(ds, 8, seed=s) for s in (3, 3, 4))
    ya, yb, yc = rows(a, 5), rows(b, 5), rows(c, 5)
    assert np.array_equal(ya, yb) and not np.array_equal(ya, yc)
    assert sorted(ya) == sorted(ds.y)
    small = BatchIterator(SyntheticImageDataset(3, image_size=8), 8)
    assert next(small)[0].shape == (8, 8, 8, 3)


# the reference's optimizer and data cases (tests/test_substrates.py), run
# on the port
def _quad():
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(1.0)}

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2
    return params, loss


def _grad(loss, p):
    leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
    g = torch.autograd.grad(loss(leaves), tree_leaves(leaves))
    return dict(zip(leaves.keys(), g))


def _run(opt, n):
    p, loss = _quad()
    s = opt.init(p)
    for _ in range(n):
        p, s = opt.apply(_grad(loss, p), s, p)
    return float(loss(p))


def test_sgd_converges_quadratic():
    assert _run(sgd(0.1), 100) < 1e-6


def test_sgd_momentum_faster_than_plain():
    assert _run(sgd(0.05, momentum=0.9), 15) < _run(sgd(0.05), 15)


def test_adamw_converges():
    assert _run(adamw(0.1), 200) < 1e-4


def test_weight_decay_shrinks():
    p = {"w": torch.ones(4)}
    opt = sgd(0.1, weight_decay=0.5)
    p, _ = opt.apply({"w": torch.zeros(4)}, opt.init(p), p)
    assert float(p["w"][0]) == pytest.approx(0.95)


def test_l2_penalty_value():
    got = apply_l2(torch.tensor(1.0), {"w": torch.ones(4)}, 0.001)
    assert float(got) == pytest.approx(1.004)


def test_clip_global_norm():
    c = clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    assert float(global_norm(c)) == pytest.approx(1.0, rel=1e-5)


def test_schedules():
    assert float(constant(0.1)(100)) == pytest.approx(0.1)
    cd = cosine_decay(1.0, 100)
    assert float(cd(0)) == pytest.approx(1.0)
    assert float(cd(100)) == pytest.approx(0.0, abs=1e-6)
    assert float(warmup_cosine(1.0, 10, 110)(5)) == pytest.approx(0.5)
    sd = step_decay(1.0, [10, 20], 0.1)
    assert float(sd(15)) == pytest.approx(0.1)
    assert float(sd(25)) == pytest.approx(0.01)


def test_batch_iterator_epochs():
    it = BatchIterator(SyntheticImageDataset(55, image_size=8, seed=0), 10,
                       seed=0)
    seen = [next(it) for _ in range(7)]     # crosses an epoch boundary
    assert all(b[0].shape == (10, 8, 8, 3) for b in seen)
    assert it.epoch >= 1
