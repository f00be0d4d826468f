"""The paper's §3.1: clustered data (metadata) selection, per class.

Pipeline (per client k), the counterpart of the per-class path of
``repro.core.selection.select_metadata``:
  activation maps A_k^[j]  --flatten (NHWC order)-->  (N, D)
  exact PCA to ``pca_components`` features             (N, P)
  farthest-point init per class, then ONE label-masked K-means over
    ``num_classes * clusters_per_class`` slots (a row only sees its own
    class's slots through an additive BIG mask)
  representative = the row nearest its slot's centre, from the last sweep
  empty slots: the admissible row nearest the slot's centre, valid=False

The device of the tensors picks the engine (``kernels/ops.py``): the
hand-written CUDA kernels on a CUDA device, their plain versions on the CPU.
Every random draw comes in as an argument: ``first`` holds each class's
first centre (the reference draws it with ``jax.random.categorical``).
The reference's ``per_class=False`` path, ``select_metadata_batched`` and
the randomized PCA are not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import BIG


class Selection(NamedTuple):
    indices: torch.Tensor      # (num_classes*K,) int64 rows of the client
    valid: torch.Tensor        # (num_classes*K,) bool — slot non-empty
    features: torch.Tensor     # (N, P) the PCA features (diagnostics)
    lloyd_iters: int           # Lloyd sweeps run


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


def fit_features(acts: torch.Tensor, pca_components: int) -> torch.Tensor:
    """(N, ...) maps -> (N, P) exact-PCA features, P = min(pca_components,
    N-1, D) (``repro.core.selection._fit_features`` with solver "exact")."""
    n = acts.shape[0]
    flat = acts.reshape(n, -1).to(torch.float32)
    p = min(pca_components, n - 1 if n > 1 else 1, flat.shape[1])
    cnt = float(max(n, 1))
    mean = flat.sum(0) / cnt
    xc = flat - mean
    _, comps = _pca_exact(xc, cnt, p)
    return ((flat - mean) @ comps.T).contiguous()


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
        c[i] = x[torch.argmax(dmin)]
    return c


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
        done = bool(torch.equal(newc, c))
        c, i = newc, i + 1
    if not done:
        stats = ops.kmeans_lloyd_step(x, c, lmask)
    return c, stats, i


def select_metadata(acts: torch.Tensor, labels: torch.Tensor,
                    first: torch.Tensor, *, num_classes: int = 10,
                    clusters_per_class: int = 10, pca_components: int = 200,
                    kmeans_iters: int = 25) -> Selection:
    """acts: (N, ...) maps at the split layer (flattened NHWC), labels (N,)
    int, first: (num_classes,) each class's first centre (a row index; for
    a class with no rows any index, its slots come back empty)."""
    feats = fit_features(acts, pca_components)
    kk = clusters_per_class
    ck = num_classes * kk
    labels = labels.to(feats.device)
    first = [int(f) for f in first.tolist()]
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
