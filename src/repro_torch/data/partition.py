"""Non-IID client partitioners (a numpy-only copy of ``repro.data.partition``).

The paper (§4.1): 20 clients, each holding 2500 images drawn from just TWO
random classes of CIFAR-10 — that is ``partition_k_shards(k_classes=2)``.
``partition_dirichlet`` is the standard alternative (label skew via Dir(alpha)).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from repro_torch.data.datasets import Dataset


@dataclass
class ClientData:
    client_id: int
    data: Dataset
    classes: np.ndarray    # classes present on this client


def partition_k_shards(ds: Dataset, num_clients: int, k_classes: int = 2,
                       samples_per_client: int = 0, seed: int = 0
                       ) -> List[ClientData]:
    """Each client receives ``samples_per_client`` samples from ``k_classes``
    randomly chosen classes (paper: 20 clients x 2500 images x 2 classes)."""
    rng = np.random.default_rng(seed)
    by_class = {c: list(rng.permutation(np.where(ds.y == c)[0]))
                for c in range(ds.num_classes)}
    present = np.unique(ds.y)          # tiny datasets may miss some classes
    clients = []
    for cid in range(num_clients):
        classes = rng.choice(present, size=min(k_classes, len(present)),
                             replace=False)
        want = samples_per_client or (len(ds) // num_clients)
        per_class = want // k_classes
        idx = []
        for c in classes:
            pool = by_class[int(c)]
            take = pool[:per_class]
            # recycle indices if a class pool runs dry (paper samples "randomly")
            if len(take) < per_class:
                src = np.where(ds.y == c)[0]   # non-empty: c drawn from present
                extra = rng.choice(src, per_class - len(take), replace=True)
                take = take + list(extra)
            by_class[int(c)] = pool[per_class:]
            idx.extend(take)
        idx = np.asarray(idx, np.int64)
        clients.append(ClientData(cid, ds.subset(idx), np.sort(classes)))
    return clients


def partition_dirichlet(ds: Dataset, num_clients: int, alpha: float = 0.5,
                        seed: int = 0) -> List[ClientData]:
    rng = np.random.default_rng(seed)
    idx_by_client = [[] for _ in range(num_clients)]
    for c in range(ds.num_classes):
        idx = rng.permutation(np.where(ds.y == c)[0])
        props = rng.dirichlet(np.full(num_clients, alpha))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for cid, part in enumerate(np.split(idx, cuts)):
            idx_by_client[cid].extend(part)
    out = []
    for cid, idx in enumerate(idx_by_client):
        idx = np.asarray(idx, np.int64)
        sub = ds.subset(idx) if len(idx) else Dataset(
            ds.x[:0], ds.y[:0], ds.num_classes)
        out.append(ClientData(cid, sub, np.unique(sub.y)))
    return out
