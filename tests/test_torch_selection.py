"""Parity of the port's §3.1 selection (``repro_torch.core.selection``) with
``repro.core.selection.select_metadata`` (its per-class jnp path) on the
CPU, on ``SyntheticActivationMaps`` of a few hundred rows.

The reference's draws (each class's first centre, from
``jax.random.categorical`` under the selection key) are computed here and
passed in. Levels: ``valid`` equal; indices equal on >= 99% of the slots
(the agreement metric of benchmarks/selection_bench.py), and every
mismatch a near-tie (the two rows' squared distances to the slot's centre
within 1e-3 relative). PCA features agree up to sign, so they are compared
through their pairwise distances (rtol 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro_torch.core import selection as sel
from repro_torch.data.datasets import SyntheticActivationMaps
from repro_torch.kernels.ref import BIG


def jax_first_centres(key, labels, num_classes):
    """The first centre per class exactly as repro's select_metadata draws
    it (``selection.py:261``, under ``jax.random.split(key, C)``)."""
    keys = jax.random.split(key, num_classes)
    lab = jnp.asarray(labels)
    return np.asarray([int(jax.random.categorical(
        keys[c], jnp.where(lab == c, 0.0, -jnp.inf)))
        for c in range(num_classes)], np.int64)


def _data(seed, n=300, shape=(8, 8, 4), drop_classes=(), noise=0.01):
    ds = SyntheticActivationMaps(num_samples=n, map_shape=shape, rank=24,
                                 noise=noise, seed=seed, structure_seed=seed)
    keep = ~np.isin(ds.y, drop_classes)
    return ds.x[keep], ds.y[keep]


def _port_centres(acts, labels, first, c_cls, kk, p, iters):
    feats = sel.fit_features(torch.from_numpy(acts), p)
    lab = torch.from_numpy(labels)
    c0 = torch.cat([sel.kmeans_init(feats, kk, int(first[c]), lab == c)
                    for c in range(c_cls)])
    slot = torch.arange(c_cls * kk) // kk
    lm = torch.where(lab[:, None] == slot[None], 0.0, BIG).float()
    c, _, _ = sel.lloyd_iterate(feats, c0, lm, iters)
    return feats, c


# A few rows per slot at least: a 2-row cluster's centre is equidistant
# from both rows, an exact tie that rounding breaks either way. Where P
# reaches N-1 the noise floor must stay well above f32 eigh's error, or
# the trailing components are rounding noise in both packages.
CASES = [  # seed, rows, num_classes, clusters, P, iters, dropped, noise
    (0, 400, 10, 4, 32, 25, (), 0.01),
    (1, 1000, 10, 10, 64, 25, (), 0.01),
    (2, 400, 6, 5, 16, 3, (2,), 0.01),    # absent class + cap exit
    (3, 150, 10, 2, 200, 25, (), 0.5),    # P capped at N-1
]


@pytest.mark.parametrize("seed,n,classes,kk,p,iters,drop,noise", CASES)
def test_select_metadata_matches_reference(seed, n, classes, kk, p, iters,
                                           drop, noise):
    acts, labels = _data(seed, n=n, drop_classes=drop, noise=noise)
    key = jax.random.PRNGKey(100 + seed)
    want = jsel.select_metadata(jnp.asarray(acts), jnp.asarray(labels), key,
                                num_classes=classes, clusters_per_class=kk,
                                pca_components=p, kmeans_iters=iters)
    first = jax_first_centres(key, labels, classes)
    got = sel.select_metadata(torch.from_numpy(acts),
                              torch.from_numpy(labels),
                              torch.from_numpy(first), num_classes=classes,
                              clusters_per_class=kk, pca_components=p,
                              kmeans_iters=iters)
    widx, wvalid = np.asarray(want.indices), np.asarray(want.valid)
    idx, valid = got.indices.numpy(), got.valid.numpy()
    np.testing.assert_array_equal(valid, wvalid)
    agree = float((idx == widx).mean())
    assert agree >= 0.99, agree
    bad = np.nonzero(idx != widx)[0]
    if len(bad):
        feats, c = _port_centres(acts, labels, first, classes, kk, p, iters)
        da = ((feats[idx[bad]] - c[bad]) ** 2).sum(1)
        db = ((feats[widx[bad]] - c[bad]) ** 2).sum(1)
        assert torch.all((da - db).abs() <= 1e-3 * (1 + da)), (da, db)
    for c_abs in drop:                      # an absent class: empty slots
        assert not valid[c_abs * kk:(c_abs + 1) * kk].any()
    # selected rows carry their slot's class
    slot_cls = np.arange(classes * kk) // kk
    assert (labels[idx[valid]] == slot_cls[valid]).all()


def test_features_match_reference_up_to_rotation():
    acts, _ = _data(4, n=200)
    want = np.asarray(jsel._fit_features(jnp.asarray(acts), 16, "exact"))
    got = sel.fit_features(torch.from_numpy(acts), 16).numpy()
    assert got.shape == want.shape == (200, 16)
    dg = ((got[:, None] - got[None]) ** 2).sum(-1)
    dw = ((want[:, None] - want[None]) ** 2).sum(-1)
    np.testing.assert_allclose(dg, dw, rtol=1e-3, atol=1e-3 * dw.max())
    # each component equals the reference's up to its sign
    for i in range(4):
        s = np.sign(got[:, i] @ want[:, i])
        np.testing.assert_allclose(got[:, i] * s, want[:, i], rtol=1e-3,
                                   atol=1e-3 * np.abs(want[:, i]).max())


def test_kmeans_init_picks_reference_rows():
    acts, labels = _data(5, n=250)
    feats = np.asarray(jsel._fit_features(jnp.asarray(acts), 24, "exact"))
    for c in (0, 3):
        m = labels == c
        key = jax.random.PRNGKey(c)
        want = np.asarray(jsel.kmeans_init(jnp.asarray(feats), 6, key,
                                           mask=jnp.asarray(m),
                                           use_pallas=False))
        first = int(jax.random.categorical(
            key, jnp.where(jnp.asarray(m), 0.0, -jnp.inf)))
        got = sel.kmeans_init(torch.from_numpy(feats.copy()), 6, first,
                              torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, want)


def test_lloyd_iterate_matches_reference():
    acts, labels = _data(6, n=260)
    feats = np.asarray(jsel._fit_features(jnp.asarray(acts), 20, "exact"))
    r = np.random.default_rng(0)
    c0 = feats[r.choice(len(feats), 30, replace=False)]
    slot = np.arange(30) // 3
    lm = np.where(labels[:, None] == slot[None], 0.0, BIG).astype(np.float32)
    feats = feats.copy()
    for iters in (0, 2, 25):
        wc, (wa, wmd, _, wcnt), wit = jsel._lloyd_iterate(
            jnp.asarray(feats), jnp.asarray(c0), jnp.asarray(lm), iters,
            False)
        c, (a, md, _, cnt), it = sel.lloyd_iterate(
            torch.from_numpy(feats), torch.from_numpy(c0),
            torch.from_numpy(lm), iters)
        assert it == int(wit)
        np.testing.assert_array_equal(a.numpy(), np.asarray(wa))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(wcnt))
        np.testing.assert_allclose(c.numpy(), np.asarray(wc), rtol=1e-4,
                                   atol=1e-4)
        # ||x||^2 + ||c||^2 - 2 x.c cancels: the error scales with ||x||^2
        np.testing.assert_allclose(md.numpy(), np.asarray(wmd), rtol=1e-4,
                                   atol=1e-6 * float(np.abs(wmd).max()))
