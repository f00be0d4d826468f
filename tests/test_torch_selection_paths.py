"""Parity of the port's other selection entries with
``repro.core.selection``, on the CPU at a few hundred rows: ``kmeans`` and
``representatives`` (the empty-cluster contract included), the
``per_class=False`` path (all rows clustered together, no labels needed),
``select_metadata_batched``, the seed path ``select_metadata_reference``
and ``selected_fraction``.

The reference's draws are computed here and passed in: a first centre is
``jax.random.categorical`` over the valid rows, under the client key
itself for the all-rows path and under ``split(key, C)`` per class.

Levels: index-exact (assignments, cluster sizes, Lloyd sweeps, selected
indices and ``valid`` equal; centroids and distances within 1e-4). The
reference's jnp init keeps a running min where the port takes the min
over a full distance tile: the same in exact arithmetic, and the rows
picked are equal here. ``select_metadata_batched`` equals the port's own
per-client loop bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro_torch.core import selection as sel
from repro_torch.data.datasets import SyntheticActivationMaps
from test_torch_selection import jax_first_centres
from test_torch_round import one_torch_thread  # noqa: F401


def _maps(seed, n=300, classes=10):
    ds = SyntheticActivationMaps(num_samples=n, map_shape=(8, 8, 4),
                                 num_classes=classes, rank=24, noise=0.01,
                                 seed=seed, structure_seed=seed)
    return ds.x.astype(np.float32), ds.y


def _first(key, valid):
    """The reference's first centre of an all-rows K-means."""
    return int(jax.random.categorical(
        key, jnp.where(jnp.asarray(valid), 0.0, -jnp.inf)))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("seed,n,k,masked", [(0, 300, 8, False),
                                             (1, 400, 12, True)])
def test_kmeans_matches_reference(seed, n, k, masked):
    acts, _ = _maps(seed, n=n)
    feats = np.array(jsel._fit_features(jnp.asarray(acts), 16, "exact"))
    valid = (np.random.default_rng(seed).random(n) < 0.8 if masked
             else np.ones(n, bool))
    mask = valid if masked else None
    key = jax.random.PRNGKey(seed)
    want = jsel.kmeans(jnp.asarray(feats), k, key, 25,
                       mask=None if mask is None else jnp.asarray(mask))
    first = _first(key, valid)
    c0 = np.asarray(jsel.kmeans_init(
        jnp.asarray(feats), k, key,
        None if mask is None else jnp.asarray(mask)))
    got_c0 = sel.kmeans_init(_t(feats), k, first, _t(valid))
    np.testing.assert_array_equal(got_c0.numpy(), c0)
    got = sel.kmeans(_t(feats), k, first, 25,
                     None if mask is None else _t(mask))
    assert got.iters == int(want.iters)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_array_equal(got.cluster_sizes.numpy(),
                                  np.asarray(want.cluster_sizes))
    np.testing.assert_allclose(got.centroids.numpy(),
                               np.asarray(want.centroids), rtol=1e-4,
                               atol=1e-4)
    wd = np.asarray(want.distances)
    np.testing.assert_allclose(got.distances.numpy()[valid], wd[valid],
                               rtol=1e-4, atol=1e-6 * float(wd.max()))


def _empty_cases():
    # 3 distinct points, 6 clusters: empty clusters guaranteed
    x = np.repeat(np.array([[0., 0.], [10., 0.], [0., 10.]], np.float32), 4,
                  axis=0)
    yield "duplicates", x, None
    x = np.random.default_rng(0).normal(size=(30, 3)).astype(np.float32)
    yield "four_valid_rows", x, np.array([True] * 4 + [False] * 26)
    x = np.random.default_rng(1).normal(size=(200, 6)).astype(np.float32)
    yield "populated", x, None


@pytest.mark.parametrize("name,x,mask", list(_empty_cases()),
                         ids=[c[0] for c in _empty_cases()])
def test_representatives_match_reference(name, x, mask):
    """On the reference's own K-means state, the port's representatives
    are the reference's, empty clusters included (the valid row nearest
    the empty cluster's centre)."""
    k = 6
    jmask = None if mask is None else jnp.asarray(mask)
    km = jsel.kmeans(jnp.asarray(x), k, jax.random.PRNGKey(0), 5,
                     mask=jmask)
    want = np.asarray(jsel.representatives(jnp.asarray(x), km, mask=jmask))
    port_km = sel.KMeansState(_t(km.centroids), _t(km.assignment),
                              _t(km.distances), _t(km.cluster_sizes),
                              int(km.iters))
    got = sel.representatives(_t(x), port_km,
                              None if mask is None else _t(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    sizes = np.asarray(km.cluster_sizes)
    if name != "populated":
        assert (sizes == 0).any()
    if mask is not None:
        assert mask[got].all()             # every index a valid row
    d = ((x[:, None] - np.asarray(km.centroids)[None]) ** 2).sum(-1)
    if mask is not None:
        d[~mask] = np.inf
    for j, r in enumerate(got):
        if sizes[j] == 0:
            assert d[:, j].argmin() == r


@pytest.mark.parametrize("with_labels", [False, True])
def test_all_rows_path_matches_reference(with_labels):
    """``per_class=False`` (or no labels): one K-means over every row, its
    first centre drawn under the client key itself."""
    acts, labels = _maps(2, n=320)
    key = jax.random.PRNGKey(12)
    kw = dict(clusters_per_class=8, pca_components=16, kmeans_iters=25)
    want = jsel.select_metadata(jnp.asarray(acts), None, key,
                                per_class=False, **kw)
    first = _first(key, np.ones(len(acts), bool))
    got = sel.select_metadata(_t(acts), _t(labels) if with_labels else None,
                              torch.tensor(first), per_class=False, **kw)
    assert got.indices.shape == (8,)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.lloyd_iters == int(want.lloyd_iters)
    frac = sel.selected_fraction(got, len(acts))
    assert float(frac) == pytest.approx(
        float(jsel.selected_fraction(want, len(acts))))


def _cohort(b=3, n=240, classes=4):
    maps = [_maps(10 + i, n=n, classes=classes) for i in range(b)]
    return (np.stack([a for a, _ in maps]), np.stack([y for _, y in maps]))


@pytest.mark.parametrize("per_class", [True, False])
def test_batched_equals_loop_and_matches_reference(per_class):
    acts, labels = _cohort()
    b, n = labels.shape
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    kw = dict(num_classes=4, clusters_per_class=5, pca_components=16,
              kmeans_iters=10)
    if per_class:
        first = np.stack([jax_first_centres(keys[i], labels[i], 4)
                          for i in range(b)])
        jlabels, tlabels = jnp.asarray(labels), _t(labels)
    else:
        first = np.array([_first(keys[i], np.ones(n, bool))
                          for i in range(b)])
        jlabels, tlabels = None, None
    want = jsel.select_metadata_batched(jnp.asarray(acts), jlabels, keys,
                                        per_class=per_class, **kw)
    got = sel.select_metadata_batched(_t(acts), tlabels, _t(first),
                                      per_class=per_class, **kw)
    assert got.indices.shape == tuple(np.asarray(want.indices).shape)
    assert got.features.shape == (b, n, 16)
    for i in range(b):
        one = sel.select_metadata(_t(acts[i]),
                                  None if tlabels is None else tlabels[i],
                                  _t(first[i]), per_class=per_class, **kw)
        assert torch.equal(got.indices[i], one.indices)
        assert torch.equal(got.valid[i], one.valid)
        assert torch.equal(got.features[i], one.features)
        assert got.lloyd_iters[i] == one.lloyd_iters
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.lloyd_iters == [int(v) for v in np.asarray(want.lloyd_iters)]


@pytest.mark.parametrize("per_class", [True, False])
def test_seed_path_matches_reference(per_class):
    acts, labels = _maps(4, n=360, classes=6)
    key = jax.random.PRNGKey(4)
    kw = dict(num_classes=6, clusters_per_class=5, pca_components=16,
              kmeans_iters=10)
    want = jsel.select_metadata_reference(
        jnp.asarray(acts), jnp.asarray(labels) if per_class else None, key,
        per_class=per_class, **kw)
    if per_class:
        first = torch.from_numpy(jax_first_centres(key, labels, 6))
    else:
        first = torch.tensor(_first(key, np.ones(len(acts), bool)))
    got = sel.select_metadata_reference(
        _t(acts), _t(labels) if per_class else None, first,
        per_class=per_class, **kw)
    np.testing.assert_array_equal(got.indices.numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.lloyd_iters == int(want.lloyd_iters) == 10
    # the fused engine is the seed path on these maps
    fused = sel.select_metadata(_t(acts), _t(labels) if per_class else None,
                                first, per_class=per_class, **kw)
    assert torch.equal(fused.indices, got.indices)
    assert torch.equal(fused.valid, got.valid)
