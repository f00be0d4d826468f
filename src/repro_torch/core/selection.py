"""The paper's §3.1: clustered data (metadata) selection, the counterpart
of ``repro.core.selection``.

Pipeline (per client k):
  activation maps A_k^[j]  --flatten (NHWC order)-->  (N, D)
  PCA to ``pca_components`` features                   (N, P)
    exact (the Gram matrix's eigh) or randomized (Halko's range finder
    with one power iteration, QR-orthonormalized)
  per class (``per_class=True``, the paper): farthest-point init per
    class, then ONE label-masked K-means over
    ``num_classes * clusters_per_class`` slots (a row only sees its own
    class's slots through an additive BIG mask); representative = the row
    nearest its slot's centre, from the last sweep; an empty slot gets the
    admissible row nearest its centre, valid=False
  all rows together (``per_class=False`` or no labels, the LM path):
    ``kmeans`` over ``clusters_per_class`` clusters, then
    ``representatives``

``select_metadata_batched`` runs a stacked cohort client by client, so its
result is the per-client loop's bit for bit. ``select_metadata_reference``
is the seed path (exact PCA, every sweep, one-hot sums, per-class runs),
kept as the identity oracle.

The device of the tensors picks the engine (``kernels/ops.py``): the
hand-written CUDA kernels on a CUDA device, their plain versions on the CPU.
PCA's products, QR and eigh are cuBLAS/cuSOLVER through torch, as the
reference computes them in plain XLA. Every random draw comes in as an
argument: ``first`` holds the first centre of each class (the reference
draws it with ``jax.random.categorical``), and ``omega`` the randomized
PCA's Gaussian test matrix, or a ``(d, l, device)`` callable that makes
it once the sketch width l is known (default: the port's own fixed draw,
``default_test_matrix``; the reference's is fixed too, from
``PRNGKey(0x9CA)``).

``select_metadata``, ``select_metadata_batched``,
``select_metadata_reference`` and ``kmeans`` are ``obs.profile.profiled``
entries, as the reference's are ``profiled_jit`` ones: under a tracer each
new signature counts as a compile and the call's count of FLOPs and bytes
goes on the open span. On ``meta`` tensors (the dry run's count,
``launch/flop_analysis.py``) nothing can be read from the data: the first
centres are taken as row 0 and the Lloyd loop runs one sweep and marks
the count a lower bound, as the reference's cost model counts a dynamic
``while`` once.
"""
from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import BIG
from repro_torch.obs.profile import profiled


OMEGA_SEED = 0x9CA        # the seed of the port's fixed test matrix
OVERSAMPLE = 32           # the range finder's extra sketch columns

# the randomized PCA's test matrix: a (d, l) tensor, a (d, l, device)
# callable, or None for ``default_test_matrix``
Omega = Union[torch.Tensor, Callable[..., torch.Tensor], None]


class Selection(NamedTuple):
    indices: torch.Tensor      # (num_classes*K,) int64 rows of the client
    valid: torch.Tensor        # (num_classes*K,) bool — slot non-empty
    features: torch.Tensor     # (N, P) the PCA features (diagnostics)
    lloyd_iters: Union[int, List[int]]   # Lloyd sweeps run (one per
    #   client from select_metadata_batched)


class PCAState(NamedTuple):
    mean: torch.Tensor         # (D,)
    components: torch.Tensor   # (P, D) rows = principal axes
    explained: torch.Tensor    # (P,) eigenvalues, descending


class KMeansState(NamedTuple):
    centroids: torch.Tensor    # (K, P)
    assignment: torch.Tensor   # (N,) cluster of each row
    distances: torch.Tensor    # (N,) squared distance to own centroid
    cluster_sizes: torch.Tensor  # (K,)
    iters: int                 # Lloyd sweeps run


def _pca_exact(xc: torch.Tensor, cnt: float, p: int):
    """Exact top-p eigenpairs: Gram trick when N <= D, else covariance."""
    n, d = xc.shape
    if n <= d:
        g = (xc @ xc.T) / cnt                        # (N, N) Gram
        evals, evecs = torch.linalg.eigh(g)          # ascending
        evals = torch.flip(evals, (0,))[:p]
        evecs = torch.flip(evecs, (1,))[:, :p]
        safe = torch.sqrt(torch.clamp(evals * cnt, min=1e-12))
        comps = ((xc.T @ evecs) / safe).T            # (P, D) unit-norm rows
    else:
        cov = (xc.T @ xc) / cnt                      # (D, D)
        evals, evecs = torch.linalg.eigh(cov)
        evals = torch.flip(evals, (0,))[:p]
        comps = torch.flip(evecs, (1,))[:, :p].T
    return evals, comps


def feature_count(n: int, d: int, pca_components: int) -> int:
    """P, the features a client's (N, D) maps are cut to: at most
    ``pca_components``, N-1 and D."""
    return min(pca_components, n - 1 if n > 1 else 1, d)


def sketch_width(n: int, d: int, p: int,
                 oversample: int = OVERSAMPLE) -> int:
    """Columns l of the randomized PCA's test matrix for (N, D) rows and
    ``p`` components."""
    return min(p + oversample, n, d)


def default_test_matrix(d: int, l: int, device="cpu") -> torch.Tensor:
    """The port's fixed Gaussian test matrix Ω, (d, l) f32 ~ N(0, 1): drawn
    on the CPU from a generator seeded ``OMEGA_SEED`` and moved to
    ``device``, so a run on the card and one on the CPU share it. Cached
    by (d, l, device), one copy a card ("cuda" is the current card);
    callers must not write to it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _test_matrix(int(d), int(l), device)


@functools.lru_cache(maxsize=4)
def _test_matrix(d: int, l: int, device: torch.device) -> torch.Tensor:
    g = torch.Generator().manual_seed(OMEGA_SEED)
    return torch.randn((d, l), generator=g, dtype=torch.float32).to(device)


def _pca_randomized(xc: torch.Tensor, cnt: float, p: int, omega: Omega,
                    oversample: int, power_iters: int):
    """Randomized range finder (Halko et al.) for the top-p subspace of the
    covariance: products of (N, D) by l = p + oversample columns in place
    of the eigh of an (N, N) Gram matrix. Orthonormalized by QR (a
    Cholesky-QR squares the sketch's condition number and loses the tail
    directions in f32). Returns (evals, comps (P, D), b = xc @ q (N, l),
    the small basis's evecs (l, P))."""
    n, d = xc.shape
    l = sketch_width(n, d, p, oversample)
    if omega is None:
        omega = default_test_matrix
    if callable(omega):
        omega = omega(d, l, xc.device)
    if tuple(omega.shape) != (d, l) or omega.dtype != xc.dtype \
            or omega.device != xc.device:
        raise ValueError(f"omega must be ({d}, {l}) {xc.dtype} on "
                         f"{xc.device}, got {tuple(omega.shape)} "
                         f"{omega.dtype} on {omega.device}")
    q = xc.T @ (xc @ omega) / cnt
    for _ in range(power_iters):
        q, _ = torch.linalg.qr(q)
        q = xc.T @ (xc @ q) / cnt
    q, _ = torch.linalg.qr(q)                        # (D, l) orthonormal
    b = xc @ q                                       # (N, l)
    small = (b.T @ b) / cnt                          # (l, l) = Q^T C Q
    evals, evecs = torch.linalg.eigh(small)
    evals = torch.flip(evals, (0,))[:p]
    evecs = torch.flip(evecs, (1,))[:, :p]
    comps = (q @ evecs).T                            # (P, D)
    return evals, comps, b, evecs


def pca_fit(x: torch.Tensor, num_components: int,
            mask: Optional[torch.Tensor] = None, *, solver: str = "exact",
            omega: Omega = None,
            oversample: int = OVERSAMPLE, power_iters: int = 1) -> PCAState:
    """PCA of the (N, D) rows of ``x``; ``mask`` (N,) marks the valid rows
    (the others get zero weight). ``solver`` "exact" takes the Gram trick
    when N <= D, else the covariance; "randomized" the range finder with
    test matrix ``omega`` (see ``Omega``)."""
    if mask is None:
        cnt = float(max(x.shape[0], 1))
        mean = x.sum(0) / cnt
        xc = x - mean
    else:
        w = mask.to(x.dtype)[:, None]
        cnt = max(float(w.sum()), 1.0)
        mean = (x * w).sum(0) / cnt
        xc = (x - mean) * w
    if solver == "exact":
        evals, comps = _pca_exact(xc, cnt, num_components)
    elif solver == "randomized":
        evals, comps, _, _ = _pca_randomized(xc, cnt, num_components, omega,
                                             oversample, power_iters)
    else:
        raise ValueError(f"unknown PCA solver: {solver!r}")
    return PCAState(mean, comps.to(x.dtype), evals.to(x.dtype))


def pca_fit_transform(x: torch.Tensor, num_components: int, *,
                      solver: str = "exact", omega: Omega = None,
                      oversample: int = OVERSAMPLE, power_iters: int = 1):
    """Fit and project -> (PCAState, (N, P) features). The randomized
    solver centres on the mean of all rows and takes its features from the
    sketch (``b @ evecs``), saving a read of x; it is not fit-then-
    transform, and the two differ by rounding."""
    if solver != "randomized":
        state = pca_fit(x, num_components, solver=solver)
        return state, pca_transform(state, x)
    n = x.shape[0]
    mean = x.mean(0)
    xc = x - mean
    evals, comps, b, evecs = _pca_randomized(xc, float(n), num_components,
                                             omega, oversample, power_iters)
    state = PCAState(mean, comps.to(x.dtype), evals.to(x.dtype))
    return state, b @ evecs


def pca_transform(state: PCAState, x: torch.Tensor) -> torch.Tensor:
    """Project the (N, D) rows of ``x`` onto the fitted components."""
    return (x - state.mean) @ state.components.T


def fit_features(acts: torch.Tensor, pca_components: int,
                 solver: str = "exact", omega: Omega = None) -> torch.Tensor:
    """(N, ...) maps -> (N, P) contiguous PCA features, P =
    min(pca_components, N-1, D) (``repro.core.selection._fit_features``);
    ``omega`` is the randomized solver's test matrix (see ``Omega``)."""
    n = acts.shape[0]
    flat = acts.reshape(n, -1).to(torch.float32)
    p = feature_count(n, flat.shape[1], pca_components)
    _, feats = pca_fit_transform(flat, p, solver=solver, omega=omega)
    return feats.contiguous()


def kmeans_init(x: torch.Tensor, k: int, first: int,
                valid: torch.Tensor) -> torch.Tensor:
    """Farthest-point init of ``k`` centres among the ``valid`` rows,
    starting from row ``first``: each step evaluates the full (N, k)
    distance tile (``ops.kmeans_pairwise_dist``) against the centres so
    far, masks the centres not chosen yet, and adds the row farthest from
    its nearest centre (lowest index on ties)."""
    c = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    c[0] = x[first]
    cols = torch.arange(k, device=x.device)
    for i in range(1, k):
        d = ops.kmeans_pairwise_dist(x, c)           # (N, k)
        d = torch.where((cols < i)[None, :], d, BIG)
        dmin = torch.where(valid, torch.amin(d, dim=1), -BIG)
        if x.is_meta:          # a meta index cannot be read on the host
            c[i] = x.index_select(0, torch.argmax(dmin)[None])[0]
        else:
            c[i] = x[torch.argmax(dmin)]
    return c


def _first_row(first) -> int:
    """A first-centre row (an int or a 0-d tensor); on a meta tensor,
    whose value cannot be read, row 0."""
    if isinstance(first, torch.Tensor) and first.is_meta:
        return 0
    return int(first)


def _first_rows(first, n: int) -> List[int]:
    """The ``n`` first-centre rows of ``first`` (a tensor or a sequence);
    on a meta tensor, row 0 each."""
    if isinstance(first, torch.Tensor) and first.is_meta:
        return [0] * n
    return [int(f) for f in first.tolist()]


def lloyd_iterate(x: torch.Tensor, c0: torch.Tensor, lmask: torch.Tensor,
                  iters: int) -> Tuple[torch.Tensor, tuple, int]:
    """Lloyd sweeps until the centroids reach their fixed point
    (``new_c == c`` bit for bit) or the ``iters`` cap. Returns
    (centroids, (assign, mindist, sums, counts), sweeps); the statistics
    are those of the returned centroids: on a fixed-point exit the last
    sweep's, on a cap exit (or iters == 0) one more sweep's."""
    c, stats, done, i = c0, None, False, 0
    while i < iters and not done:
        stats = ops.kmeans_lloyd_step(x, c, lmask)
        _, _, sums, counts = stats
        newc = sums / torch.clamp(counts, min=1.0)[:, None]
        # empty clusters keep their centre (classic Lloyd behaviour)
        newc = torch.where(counts[:, None] > 0, newc, c)
        if x.is_meta:
            # the fixed point is in the data: count one sweep, flagged
            from repro_torch.launch.flop_analysis import note_unknown_trip
            note_unknown_trip()
            done = True
        else:
            done = bool(torch.equal(newc, c))
        c, i = newc, i + 1
    if not done:
        stats = ops.kmeans_lloyd_step(x, c, lmask)
    return c, stats, i


@profiled(static_argnames=("k", "iters"))
def kmeans(x: torch.Tensor, k: int, first: int, iters: int = 25,
           mask: Optional[torch.Tensor] = None) -> KMeansState:
    """K-means of the (N, P) rows of ``x`` (the ``mask`` rows, default
    all) into ``k`` clusters: farthest-point init from row ``first``, then
    Lloyd sweeps to the fixed point or the ``iters`` cap."""
    n = x.shape[0]
    valid = (torch.ones((n,), dtype=torch.bool, device=x.device)
             if mask is None else mask.to(torch.bool))
    lmask = torch.where(valid, 0.0, BIG).to(x.dtype)[:, None].expand(
        n, k).contiguous()
    c0 = kmeans_init(x, k, _first_row(first), valid)
    c, (assign, own, _, sizes), sweeps = lloyd_iterate(x, c0, lmask, iters)
    return KMeansState(c, assign, own, sizes, sweeps)


def representatives(x: torch.Tensor, km: KMeansState,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The paper's representative of each cluster: the valid row nearest
    its centre -> (K,) int64 rows of ``x``. An empty cluster
    (``cluster_sizes <= 0``) gets the valid row nearest its centre among
    all rows (consumers mask it through ``cluster_sizes > 0``); with no
    valid row at all every index is 0."""
    n, k = x.shape[0], km.centroids.shape[0]
    valid = (torch.ones((n,), dtype=torch.bool, device=x.device)
             if mask is None else mask.to(torch.bool))
    d = ops.kmeans_pairwise_dist(x, km.centroids)            # (N, K)
    dvalid = torch.where(valid[:, None], d, BIG)
    same = km.assignment.long()[:, None] == torch.arange(
        k, device=x.device)[None, :]
    dsame = torch.where(same, dvalid, BIG)
    empty = km.cluster_sizes <= 0
    return torch.where(empty, torch.argmin(dvalid, dim=0),
                       torch.argmin(dsame, dim=0))


_SELECT_STATICS = ("num_classes", "clusters_per_class", "pca_components",
                   "kmeans_iters", "per_class", "pca_solver")


@profiled(static_argnames=_SELECT_STATICS)
def select_metadata(acts: torch.Tensor, labels: Optional[torch.Tensor],
                    first, *, num_classes: int = 10,
                    clusters_per_class: int = 10, pca_components: int = 200,
                    kmeans_iters: int = 25, per_class: bool = True,
                    pca_solver: str = "exact",
                    omega: Omega = None) -> Selection:
    """acts: (N, ...) maps at the split layer (flattened NHWC), labels (N,)
    int or None. Per class: ``first`` (num_classes,) holds each class's
    first centre (a row index; for a class with no rows any index, its
    slots come back empty). ``per_class=False`` or no labels: all rows are
    clustered together into ``clusters_per_class`` clusters and ``first``
    is one row index. ``omega``: the randomized solver's test matrix (see
``Omega``)."""
    feats = fit_features(acts, pca_components, pca_solver, omega)
    if not per_class or labels is None:
        km = kmeans(feats, clusters_per_class, _first_row(first),
                    kmeans_iters)
        idx = representatives(feats, km)
        return Selection(idx, km.cluster_sizes > 0, feats, km.iters)

    kk = clusters_per_class
    ck = num_classes * kk
    labels = labels.to(feats.device)
    first = _first_rows(first, num_classes)
    c0 = torch.cat([kmeans_init(feats, kk, first[c], labels == c)
                    for c in range(num_classes)])           # (CK, P)

    slot_class = torch.arange(ck, device=feats.device) // kk
    admissible = labels[:, None] == slot_class[None, :]      # (N, CK)
    lmask = torch.where(admissible, 0.0, BIG).to(torch.float32)
    c, (assign, own, _, sizes), sweeps = lloyd_iterate(feats, c0, lmask,
                                                       kmeans_iters)

    # representatives from the same sweep: per-slot argmin of own distance
    slots = torch.arange(ck, device=feats.device)
    same = assign.long()[:, None] == slots[None, :]
    w = torch.amin(lmask, dim=1) <= 0.0
    drep = torch.where(same & w[:, None], own[:, None], BIG)
    idx = torch.argmin(drep, dim=0)
    # empty-slot contract: the admissible row nearest the slot's centre
    dfull = torch.where(lmask <= 0.0, ops.kmeans_pairwise_dist(feats, c), BIG)
    empty = sizes <= 0
    idx = torch.where(empty, torch.argmin(dfull, dim=0), idx)
    return Selection(idx, sizes > 0, feats, sweeps)


@profiled(static_argnames=_SELECT_STATICS)
def select_metadata_batched(acts: torch.Tensor,
                            labels: Optional[torch.Tensor],
                            first: torch.Tensor, **knobs) -> Selection:
    """``select_metadata`` of each client of a stacked cohort: acts
    (B, N, ...), labels (B, N) or None, ``first`` each client's own draws
    ((B, num_classes) per class, else (B,)); ``knobs`` are
    ``select_metadata``'s keywords and apply to every client. The outputs
    carry a leading client axis and ``lloyd_iters`` is a list. The
    reference ``vmap``s; the port runs the clients one after another, so
    the result is the per-client loop's bit for bit."""
    sels = [select_metadata(acts[i], None if labels is None else labels[i],
                            first[i], **knobs)
            for i in range(acts.shape[0])]
    return Selection(torch.stack([s.indices for s in sels]),
                     torch.stack([s.valid for s in sels]),
                     torch.stack([s.features for s in sels]),
                     [s.lloyd_iters for s in sels])


def _seed_kmeans(x: torch.Tensor, k: int, first: int, iters: int,
                 valid: torch.Tensor) -> KMeansState:
    """The seed's K-means: every one of ``iters`` sweeps over the full
    distance matrix, sums and counts through a one-hot product, then one
    more distance pass for the final assignment."""
    c = kmeans_init(x, k, first, valid)

    def assign_rows(c):
        d = torch.where(valid[:, None], ops.kmeans_pairwise_dist(x, c), BIG)
        return d, torch.argmin(d, dim=1)

    for _ in range(iters):
        _, assign = assign_rows(c)
        onehot = (torch.nn.functional.one_hot(assign, k).to(x.dtype)
                  * valid[:, None])
        counts = onehot.sum(0)
        newc = (onehot.T @ x) / torch.clamp(counts, min=1.0)[:, None]
        c = torch.where(counts[:, None] > 0, newc, c)
    d, assign = assign_rows(c)
    own = torch.gather(d, 1, assign[:, None])[:, 0]
    sizes = (torch.nn.functional.one_hot(assign, k).to(x.dtype)
             * valid[:, None]).sum(0)
    return KMeansState(c, assign, own, sizes, iters)


@profiled(static_argnames=_SELECT_STATICS[:-1])
def select_metadata_reference(acts: torch.Tensor,
                              labels: Optional[torch.Tensor], first, *,
                              num_classes: int = 10,
                              clusters_per_class: int = 10,
                              pca_components: int = 200,
                              kmeans_iters: int = 25,
                              per_class: bool = True) -> Selection:
    """The seed path, kept as the identity oracle: exact ``pca_fit`` +
    ``pca_transform``, independent K-means runs (one per class when
    ``per_class``) that run all ``kmeans_iters`` sweeps, each with its own
    ``representatives``. Same arguments as ``select_metadata``."""
    n = acts.shape[0]
    flat = acts.reshape(n, -1).to(torch.float32)
    p = feature_count(n, flat.shape[1], pca_components)
    feats = pca_transform(pca_fit(flat, p), flat).contiguous()
    if not per_class or labels is None:
        km = _seed_kmeans(feats, clusters_per_class,
                          _first_row(first),
                          kmeans_iters, torch.ones(
                              (n,), dtype=torch.bool, device=feats.device))
        return Selection(representatives(feats, km), km.cluster_sizes > 0,
                         feats, kmeans_iters)
    labels = labels.to(feats.device)
    first = _first_rows(first, num_classes)
    idxs, valids = [], []
    for c in range(num_classes):
        m = labels == c
        km = _seed_kmeans(feats, clusters_per_class, first[c], kmeans_iters,
                          m)
        idxs.append(representatives(feats, km, mask=m))
        valids.append(km.cluster_sizes > 0)
    return Selection(torch.cat(idxs), torch.cat(valids), feats, kmeans_iters)


def selected_fraction(sel: Selection, n_total: int) -> torch.Tensor:
    """The paper's headline metric: |D_M_k| / |D_k| (~0.8% in the paper)."""
    return sel.valid.sum() / n_total
