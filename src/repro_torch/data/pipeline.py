"""Batching pipeline: shuffled epochs, drop-remainder batching and an
endless iterator over them: the port of ``repro.data.pipeline``.

The reference draws each epoch's permutation from ``np.random.
default_rng(seed + epoch)``. Here the draws come from a ``torch.Generator``
seeded the same way, or are passed in (``order``, ``orders``, ``fill``),
so that a test can feed the reference's own permutations and get its
batches.
"""
from __future__ import annotations

from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.data.datasets import Dataset

# epoch -> that epoch's permutation of the dataset's rows
Orders = Callable[[int], Sequence[int]]


def permutation(n: int, seed: int) -> np.ndarray:
    """A permutation of range(n) from a ``torch.Generator`` seeded with
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.randperm(n, generator=gen).numpy()


def batched_epoch(ds: Dataset, batch_size: int, seed: int = 0,
                  drop_remainder: bool = True,
                  order: Optional[Sequence[int]] = None
                  ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch of (x, y) batches in the order ``order`` (default:
    ``permutation(len(ds), seed)``); with ``drop_remainder`` the last
    partial batch is dropped."""
    order = np.asarray(permutation(len(ds), seed) if order is None
                       else order)
    n = (len(ds) // batch_size * batch_size) if drop_remainder else len(ds)
    for s in range(0, max(n, batch_size if not drop_remainder else 0),
                   batch_size):
        idx = order[s:s + batch_size]
        if len(idx) == 0:
            break
        yield ds.x[idx], ds.y[idx]


class BatchIterator:
    """Endless epoch-shuffled batches; tracks epoch and step for a
    checkpoint's resume. A client with fewer rows than a batch is first
    filled up to one batch, sampled with replacement (``fill``: those
    row indices; default from a generator seeded with ``seed``). Epoch e
    runs in the order ``orders(e)`` (default: ``permutation(len, seed +
    e)``)."""

    def __init__(self, ds: Dataset, batch_size: int, seed: int = 0,
                 orders: Optional[Orders] = None,
                 fill: Optional[Sequence[int]] = None):
        if len(ds) < batch_size:
            if fill is None:
                gen = torch.Generator().manual_seed(seed)
                fill = torch.randint(len(ds), (batch_size,),
                                     generator=gen).numpy()
            ds = ds.subset(np.asarray(fill))
        self.ds, self.batch_size, self.seed = ds, batch_size, seed
        self.orders = orders or (
            lambda epoch: permutation(len(self.ds), self.seed + epoch))
        self.epoch, self._iter = 0, None

    def __iter__(self):
        return self

    def _epoch(self):
        return batched_epoch(self.ds, self.batch_size,
                             order=self.orders(self.epoch))

    def __next__(self):
        if self._iter is None:
            self._iter = self._epoch()
        try:
            return next(self._iter)
        except StopIteration:
            self.epoch += 1
            self._iter = self._epoch()
            return next(self._iter)
