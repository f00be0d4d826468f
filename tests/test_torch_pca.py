"""Parity of the port's PCA (``repro_torch.core.selection``: ``pca_fit``,
``pca_fit_transform``, ``pca_transform``, ``fit_features``) and of its
randomized selection with ``repro.core.selection``, on the CPU at a few
hundred rows of ``SyntheticActivationMaps``.

The randomized solver is fed the reference's test matrix
(``jax.random.normal(PRNGKey(0x9CA), (d, l))``, which the reference uses
for every call) as ``omega``. Levels:
  * eigenvalues within rtol 1e-3; features equal up to each column's sign
    (QR's and eigh's signs differ between LAPACK and XLA), so compared
    through their pairwise distances (rtol 1e-3), and the leading
    components one by one up to sign;
  * selections: ``valid`` equal and every index equal or a near-tie (the
    two rows' squared distances to the port's slot centre within 1e-3
    relative), at >= 8 rows per slot (ROADMAP Queue 3's exact ties);
  * the exact path keeps its bits: ``fit_features`` equals the formula it
    had before the randomized solver came, bit for bit.
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
from test_torch_selection import jax_first_centres
from test_torch_round import one_torch_thread  # noqa: F401

TOL = 1e-3


def jax_omega(d, l):
    """The reference's fixed test matrix, as a torch tensor."""
    return torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(0x9CA), (d, l), jnp.float32)))


def _maps(seed, n=300, classes=10, rank=24, noise=0.01):
    ds = SyntheticActivationMaps(num_samples=n, map_shape=(8, 8, 4),
                                 num_classes=classes, rank=rank,
                                 noise=noise, seed=seed, structure_seed=seed)
    return ds.x.astype(np.float32), ds.y


def _dists(f):
    f = np.asarray(f, np.float64)
    return ((f[:, None] - f[None]) ** 2).sum(-1)


def _assert_same_features(got, want):
    dg, dw = _dists(got), _dists(want)
    np.testing.assert_allclose(dg, dw, rtol=TOL, atol=TOL * dw.max())


def _assert_same_components(got, want, leading=4):
    got, want = np.asarray(got), np.asarray(want)
    for i in range(leading):
        s = np.sign(got[i] @ want[i])
        np.testing.assert_allclose(got[i] * s, want[i], rtol=TOL,
                                   atol=TOL * np.abs(want[i]).max())


@pytest.mark.parametrize("masked", [False, True])
def test_randomized_pca_fit_matches_reference(masked):
    acts, _ = _maps(0)
    x = acts.reshape(len(acts), -1)
    mask = None
    if masked:
        mask = np.random.default_rng(0).random(len(x)) < 0.7
    p = 16
    want = jsel.pca_fit(jnp.asarray(x), p,
                        None if mask is None else jnp.asarray(mask),
                        solver="randomized")
    got = sel.pca_fit(torch.from_numpy(x), p,
                      None if mask is None else torch.from_numpy(mask),
                      solver="randomized", omega=jax_omega(x.shape[1], 48))
    np.testing.assert_allclose(got.explained.numpy(),
                               np.asarray(want.explained), rtol=TOL)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               rtol=1e-5, atol=1e-5)
    _assert_same_components(got.components, want.components)
    rows = slice(None) if mask is None else mask
    _assert_same_features(
        sel.pca_transform(got, torch.from_numpy(x)).numpy()[rows],
        np.asarray(jsel.pca_transform(want, jnp.asarray(x)))[rows])


def test_randomized_pca_fit_transform_matches_reference():
    acts, _ = _maps(1, n=400)
    x = acts.reshape(len(acts), -1)
    want_state, want = jsel.pca_fit_transform(jnp.asarray(x), 24,
                                              solver="randomized")
    got_state, got = sel.pca_fit_transform(
        torch.from_numpy(x), 24, solver="randomized",
        omega=jax_omega(x.shape[1], 56))
    assert got.shape == (400, 24)
    np.testing.assert_allclose(got_state.explained.numpy(),
                               np.asarray(want_state.explained), rtol=TOL)
    _assert_same_features(got.numpy(), np.asarray(want))
    # the shortcut (b @ evecs) is the projection up to rounding
    _assert_same_features(got.numpy(),
                          sel.pca_transform(got_state,
                                            torch.from_numpy(x)).numpy())
    # fit_features: the selection's entry, N-1 and D caps included
    want_f = np.asarray(jsel._fit_features(jnp.asarray(acts), 24,
                                           "randomized"))
    got_f = sel.fit_features(torch.from_numpy(acts), 24, "randomized",
                             jax_omega(x.shape[1], 56))
    assert got_f.is_contiguous()
    _assert_same_features(got_f.numpy(), want_f)


@pytest.mark.parametrize("n", [120, 400])   # Gram trick; covariance
def test_masked_exact_pca_fit_and_transform(n):
    rng = np.random.default_rng(n)
    d = 256 if n < 256 else 64
    z = rng.normal(size=(n, 8)) * (3.0 * 0.7 ** np.arange(8))
    x = (z @ rng.normal(size=(8, d)) + 0.01 * rng.normal(size=(n, d))
         ).astype(np.float32)
    mask = rng.random(n) < 0.8
    want = jsel.pca_fit(jnp.asarray(x), 6, jnp.asarray(mask))
    got = sel.pca_fit(torch.from_numpy(x), 6, torch.from_numpy(mask))
    np.testing.assert_allclose(got.explained.numpy(),
                               np.asarray(want.explained), rtol=TOL)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean),
                               rtol=1e-5, atol=1e-5)
    _assert_same_components(got.components, want.components)
    _assert_same_features(
        sel.pca_transform(got, torch.from_numpy(x)).numpy()[mask],
        np.asarray(jsel.pca_transform(want, jnp.asarray(x)))[mask])


def test_exact_fit_features_keeps_its_bits():
    """The exact path is the formula it had before the randomized solver
    and the row mask came: centred on the plain mean, the Gram matrix's
    eigh, then (x - mean) @ comps.T."""
    acts, _ = _maps(2, n=260)
    flat = torch.from_numpy(acts).reshape(260, -1)
    cnt = 260.0
    mean = flat.sum(0) / cnt
    _, comps = sel._pca_exact(flat - mean, cnt, 32)
    before = ((flat - mean) @ comps.T).contiguous()
    assert torch.equal(sel.fit_features(torch.from_numpy(acts), 32), before)


def test_unknown_solver_and_bad_test_matrix_are_refused():
    x = torch.randn(40, 30, generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="unknown PCA solver"):
        sel.pca_fit(x, 4, solver="lanczos")
    with pytest.raises(ValueError, match="unknown PCA solver"):
        sel.pca_fit_transform(x, 4, solver="lanczos")
    with pytest.raises(ValueError, match="omega"):
        sel.pca_fit(x, 4, solver="randomized", omega=torch.zeros(30, 35))


def test_default_test_matrix_is_the_ports_fixed_draw():
    om = sel.default_test_matrix(64, 20)
    g = torch.Generator().manual_seed(sel.OMEGA_SEED)
    assert torch.equal(om, torch.randn((64, 20), generator=g))
    assert sel.default_test_matrix(64, 20, torch.device("cpu")) is om
    assert sel.sketch_width(300, 256, 16) == 48
    assert sel.sketch_width(30, 256, 16) == 30
    # the default is what a call without omega uses
    x = torch.randn(50, 64, generator=torch.Generator().manual_seed(1))
    a = sel.pca_fit(x, 8, solver="randomized")
    b = sel.pca_fit(x, 8, solver="randomized",
                    omega=sel.default_test_matrix(64, 40))
    assert torch.equal(a.components, b.components)
    # a (d, l, device) callable is asked for the sketch width's matrix
    asked = []
    c = sel.pca_fit(x, 8, solver="randomized",
                    omega=lambda d, l, dev: asked.append((d, l, dev))
                    or sel.default_test_matrix(d, l, dev))
    assert asked == [(64, 40, x.device)]
    assert torch.equal(a.components, c.components)


def _near_ties(acts, labels, first, got, widx, classes, kk, p, iters,
               omega):
    """Every index where the port and the reference differ is a near-tie
    against the port's own slot centre."""
    idx = got.indices.numpy()
    bad = np.nonzero(idx != widx)[0]
    if not len(bad):
        return
    feats = got.features
    lab = torch.from_numpy(labels)
    c0 = torch.cat([sel.kmeans_init(feats, kk, int(first[c]), lab == c)
                    for c in range(classes)])
    slot = torch.arange(classes * kk) // kk
    lm = torch.where(lab[:, None] == slot[None], 0.0, BIG).float()
    c, _, _ = sel.lloyd_iterate(feats, c0, lm, iters)
    da = ((feats[idx[bad]] - c[bad]) ** 2).sum(1)
    db = ((feats[widx[bad]] - c[bad]) ** 2).sum(1)
    assert torch.all((da - db).abs() <= TOL * (1 + da)), (bad, da, db)


RANDOMIZED_CASES = [  # seed, rows, classes, clusters, P  (>= 8 rows a slot)
    (0, 400, 10, 4, 32),
    (1, 1000, 10, 10, 64),
    (2, 600, 6, 5, 16),
]


@pytest.mark.parametrize("seed,n,classes,kk,p", RANDOMIZED_CASES)
def test_randomized_selection_matches_reference(seed, n, classes, kk, p):
    acts, labels = _maps(seed, n=n, classes=classes)
    key = jax.random.PRNGKey(100 + seed)
    want = jsel.select_metadata(jnp.asarray(acts), jnp.asarray(labels), key,
                                num_classes=classes, clusters_per_class=kk,
                                pca_components=p, kmeans_iters=25,
                                pca_solver="randomized")
    first = jax_first_centres(key, labels, classes)
    om = jax_omega(256, sel.sketch_width(n, 256, p))
    got = sel.select_metadata(torch.from_numpy(acts),
                              torch.from_numpy(labels),
                              torch.from_numpy(first), num_classes=classes,
                              clusters_per_class=kk, pca_components=p,
                              kmeans_iters=25, pca_solver="randomized",
                              omega=om)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.lloyd_iters == int(want.lloyd_iters)
    _near_ties(acts, labels, first, got, np.asarray(want.indices), classes,
               kk, p, 25, om)


def structured_maps(seed, n=400):
    """``tests/test_selection.py``'s ``structured_acts``: low-rank maps
    with a decaying spectrum, 4 classes of 3 modes."""
    ds = SyntheticActivationMaps(n, (8, 8, 4), num_classes=4,
                                 modes_per_class=3, rank=48,
                                 spectrum_decay=0.9, seed=seed,
                                 structure_seed=seed)
    return ds.x.astype(np.float32), ds.y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_randomized_selection_equals_seed_path_on_structured_maps(seed):
    """The port's mirror of ``tests/test_selection.py:266-278``: on
    decaying-spectrum maps the range finder spans the exact PCA's
    subspace, and K-means is rotation-invariant within it, so the
    randomized selection is the seed path's (``select_metadata_reference``,
    exact PCA) index for index, or a near-tie."""
    acts, labels = structured_maps(seed)
    key = jax.random.PRNGKey(seed)
    first = torch.from_numpy(jax_first_centres(key, labels, 4))
    kw = dict(num_classes=4, clusters_per_class=5, pca_components=16,
              kmeans_iters=10)
    a = sel.select_metadata(torch.from_numpy(acts), torch.from_numpy(labels),
                            first, pca_solver="randomized", **kw)
    b = sel.select_metadata_reference(torch.from_numpy(acts),
                                      torch.from_numpy(labels), first, **kw)
    assert torch.equal(a.valid, b.valid)
    _near_ties(acts, labels, first.numpy(), a, b.indices.numpy(), 4, 5, 16,
               10, None)
