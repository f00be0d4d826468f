"""Algorithm 1 (paper): one global round of Split Training with Metadata
Selection, client by client. The counterpart of the sequential path of
``repro.core.rounds`` (``client_round``, ``server_round``, ``run_cohort``
and ``run_round`` with ``batched_selection=False``); the stacked, chunked
and sharded engines of ``repro.core.distributed`` are not ported yet.

    for each client k:
        M_Ck loads W_G(t-1)
        D_Mk(t)  <- Extract&Selection(D_k, W_G^l(t-1))          # §3.1
        W_Ck(t)  <- LocalUpdate(D_k, W_G(t-1))                  # §3.2
    server:
        D_M(t)   <- U_k D_Mk(t)
        W_S^u(t) <- MetaTraining(D_M(t), W_G^u(0))              # §3.3
        M_COM(t) <- ModelCompose(W_G^l(t-1), W_S^u(t))
        W_G(t)   <- WeightAverage(W_Ck(t))                      # Eq. 2

Randomness is explicit. A ``Draws`` object supplies every draw the round
needs — each class's first K-means centre, the LocalUpdate and the
meta-training permutations, the cohort — and the core functions take them
as tensors. ``GeneratorDraws`` draws them from a ``torch.Generator``; the
parity tests pass an object that reproduces the reference's JAX draws.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core import fedavg as fa
from repro_torch.core import meta_training as mt
from repro_torch.core.compose import compose
from repro_torch.core.selection import select_metadata
from repro_torch.core.split import SplitModel
from repro_torch.data.partition import ClientData
from repro_torch.fl.comms import CommLedger
from repro_torch.fl.transport.channel import Channel
from repro_torch.fl.transport.codecs import get_codec

Params = Dict[str, torch.Tensor]


@dataclass
class ClientDraws:
    """One client's random draws for one round."""
    first_centres: torch.Tensor    # (num_classes,) int64 row indices
    local_perms: torch.Tensor      # (local_epochs, n) int64 shuffle orders


class Draws(Protocol):
    """The source of every random draw of a round."""

    def client(self, position: int, client: ClientData, num_classes: int,
               epochs: int) -> ClientDraws: ...

    def meta_perms(self, m: int, epochs: int) -> torch.Tensor: ...

    def cohort(self, num_available: int, m: int) -> np.ndarray: ...


class GeneratorDraws:
    """``Draws`` from one CPU ``torch.Generator``: the first centre of a
    class is a uniform row of that class (row 0 for a class the client
    lacks — its slots come back empty either way), permutations are
    ``randperm`` and the cohort is a ``randperm`` prefix."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def _randperm(self, n: int) -> torch.Tensor:
        return torch.randperm(n, generator=self.generator)

    def client(self, position, client, num_classes, epochs):
        """Draws of the client at cohort ``position``."""
        y = torch.as_tensor(client.data.y)
        first = torch.zeros(num_classes, dtype=torch.int64)
        for c in range(num_classes):
            rows = torch.nonzero(y == c)[:, 0]
            if len(rows):
                pick = torch.randint(len(rows), (1,), generator=self.generator)
                first[c] = rows[pick[0]]
        n = len(client.data)
        perms = torch.stack([self._randperm(n) for _ in range(epochs)])
        return ClientDraws(first, perms)

    def meta_perms(self, m, epochs):
        """(epochs, m) shuffle orders for MetaTraining."""
        return torch.stack([self._randperm(m) for _ in range(epochs)])

    def cohort(self, num_available, m):
        """``m`` distinct client ids out of ``num_available``."""
        return self._randperm(num_available)[:m].numpy()


@dataclass
class RoundResult:
    global_params: Params            # W_G(t)
    composed_params: Params          # M_COM(t)
    upper_trained: Params            # W_S^u(t)
    metadata_count: int              # |D_M(t)|
    total_samples: int               # sum_k |D_k|
    client_losses: List[float] = field(default_factory=list)
    meta_losses: Optional[torch.Tensor] = None


def _device(params: Params) -> torch.device:
    return next(iter(params.values())).device


def local_batches(x: torch.Tensor, y: torch.Tensor, perms: torch.Tensor,
                  cfg: FLConfig):
    """Shuffle + batch one client's data for LocalUpdate: (steps, bs, ...)
    with ``perms[e]`` as the order of epoch ``e``."""
    n = x.shape[0]
    bs = min(cfg.local_batch_size, n)
    steps_per_epoch = max(n // bs, 1)
    perm = perms[:, :steps_per_epoch * bs].reshape(-1).to(x.device)
    bx = x[perm].reshape((-1, bs) + tuple(x.shape[1:]))
    by = y[perm].reshape(-1, bs)
    return bx, by


def client_round(model: SplitModel, params: Params, client: ClientData,
                 cfg: FLConfig, draws: ClientDraws, channel: Channel,
                 num_classes: int, client_id: int = 0):
    """Client k's work: Extract&Selection + LocalUpdate. Both uploads go
    through ``channel``, which charges their exact frame bytes; the
    metadata returned is what the server DECODES (valid rows only,
    dequantized under a lossy codec). Returns
    (new_params, metadata, mean local loss, Lloyd sweeps or None)."""
    dev = _device(params)
    x = torch.as_tensor(client.data.x, device=dev)
    y = torch.as_tensor(client.data.y, device=dev)
    codec = get_codec(cfg.transport_codec)
    sweeps = None
    with torch.no_grad():
        acts = model.apply_lower(params, x)                  # A_k^[j]
    if cfg.use_selection:
        sel = select_metadata(acts, y, draws.first_centres,
                              num_classes=num_classes,
                              clusters_per_class=cfg.clusters_per_class,
                              pca_components=cfg.pca_components,
                              kmeans_iters=cfg.kmeans_iters)
        triple = (acts[sel.indices], y[sel.indices], sel.valid)
        sweeps = sel.lloyd_iters
    else:
        # Table 2 baseline: ALL activation maps are uploaded
        triple = (acts, y, torch.ones(x.shape[0], dtype=torch.bool,
                                      device=dev))
    del acts
    metadata = channel.upload_knowledge(client_id, *triple, codec)

    bx, by = local_batches(x, y, draws.local_perms, cfg)
    new_params, losses = fa.local_update(params, cfg.local_lr, bx, by,
                                         model.loss)
    channel.upload_update(client_id, new_params)
    return new_params, metadata, float(losses.mean()), sweeps


def server_round(model: SplitModel, prev_global: Params, upper_init: Params,
                 client_params: List[Params], metadatas: List[tuple],
                 cfg: FLConfig, draws: Draws) -> RoundResult:
    """Server's work: aggregate the DECODED metadata (valid rows only, so a
    client may contribute none), MetaTraining from W_G^u(0), ModelCompose,
    Eq. 2 over the cohort's updates."""
    dev = _device(prev_global)
    acts = torch.cat([m[0] for m in metadatas], 0).to(dev)
    ys = torch.cat([m[1] for m in metadatas], 0).to(dev)
    valid = torch.cat([m[2] for m in metadatas], 0).to(dev)
    if acts.shape[0] == 0:                   # nothing selected anywhere
        upper, meta_losses = upper_init, torch.zeros(0)
    else:
        perms = draws.meta_perms(acts.shape[0], cfg.meta_epochs)
        upper, meta_losses = mt.meta_train(
            upper_init, model.upper_loss, acts, ys, perms,
            batch_size=cfg.meta_batch_size, lr=cfg.meta_lr, l2=cfg.meta_l2,
            valid=valid)
    return RoundResult(global_params=fa.weight_average(client_params),
                       composed_params=compose(model, prev_global, upper),
                       upper_trained=upper, metadata_count=int(valid.sum()),
                       total_samples=0, meta_losses=meta_losses)


def run_cohort(model: SplitModel, params: Params, clients: List[ClientData],
               cfg: FLConfig, draws: Draws, channel: Channel,
               num_classes: int, client_ids: Optional[List[int]] = None):
    """The client side of one round, client by client. Returns per-client
    lists (params, metadata, loss, Lloyd sweeps)."""
    if client_ids is None:
        client_ids = list(range(len(clients)))
    out = ([], [], [], [])
    for pos, (c, cid) in enumerate(zip(clients, client_ids)):
        cd = draws.client(pos, c, num_classes, cfg.local_epochs)
        for acc, v in zip(out, client_round(model, params, c, cfg, cd,
                                            channel, num_classes,
                                            client_id=int(cid))):
            acc.append(v)
    return out


def run_round(model: SplitModel, global_params: Params, upper_init: Params,
              clients: List[ClientData], cfg: FLConfig, draws: Draws,
              ledger: Optional[CommLedger] = None,
              num_classes: int = 10) -> RoundResult:
    """One round over ``clients`` (no broadcast charge, as the reference's
    ``run_round``); the ledger gets every upload's exact bytes."""
    ledger = ledger if ledger is not None else CommLedger()
    channel = Channel(ledger, checksum=cfg.transport_checksum)
    cparams, metas, losses, _ = run_cohort(
        model, global_params, clients, cfg, draws, channel, num_classes)
    res = server_round(model, global_params, upper_init, cparams, metas, cfg,
                       draws)
    res.client_losses = losses
    res.total_samples = sum(len(c.data) for c in clients)
    return res
