"""Algorithm 1 (paper): one global round of Split Training with Metadata
Selection, at simulator granularity. The counterpart of
``repro.core.rounds``. ``run_cohort`` runs the client side on the cohort
engine (``repro_torch.core.distributed``: every client's selection, then
one batched knowledge upload, then every client's LocalUpdate) when
``cfg.distributed_selection`` is set, else client by client; both give
the same bits on the same draws. Both select one client at a time, so
``cfg.selection_chunk_size`` has nothing to choose (see ``configs/base``).

    for each client k:
        M_Ck loads W_G(t-1)
        D_Mk(t)  <- Extract&Selection(D_k, W_G^l(t-1))          # §3.1
        W_Ck(t)  <- LocalUpdate(D_k, W_G(t-1))                  # §3.2
    server:
        D_M(t)   <- U_k D_Mk(t)
        W_S^u(t) <- MetaTraining(D_M(t), W_G^u(0))              # §3.3
        M_COM(t) <- ModelCompose(W_G^l(t-1), W_S^u(t))
        W_G(t)   <- WeightAverage(W_Ck(t))                      # Eq. 2

Given a ``mesh``, the cohort engine splits the clients over its "data"
axis (``core/distributed.py``) and the round's bits stay the one-device
engine's.

Randomness is explicit. A ``Draws`` object supplies every draw the round
needs — each class's first K-means centre, the randomized PCA's test
matrix, the LocalUpdate and the meta-training permutations, the cohort —
and the core functions take them as tensors. ``GeneratorDraws`` draws
them from a ``torch.Generator``; the parity tests pass an object that
reproduces the reference's JAX draws.

The round reports through ``repro_torch.obs`` (no-ops unless a tracer is
active): ``client`` / ``select`` / ``local_update`` spans per client, a
``meta_train`` span on the server, and a ``selection_sketch`` event per
client, at the reference's sites.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import FLConfig
from repro_torch.core import fedavg as fa
from repro_torch.core import meta_training as mt
from repro_torch.core.compose import compose
from repro_torch.core.selection import default_test_matrix, select_metadata
from repro_torch.core.split import SplitModel
from repro_torch.data.partition import ClientData
from repro_torch.fl.comms import CommLedger
from repro_torch.fl.transport.channel import Channel, knowledge_codec

Params = Dict[str, torch.Tensor]


@dataclass
class ClientDraws:
    """One client's random draws for one round."""
    first_centres: torch.Tensor    # (num_classes,) int64 row indices
    local_perms: torch.Tensor      # (local_epochs, n) int64 shuffle orders
    # (d, l, device) -> the randomized PCA's (d, l) f32 test matrix
    pca_test_matrix: Callable[..., torch.Tensor] = default_test_matrix


class Draws(Protocol):
    """The source of every random draw of a round."""

    def client(self, position: int, client: ClientData, num_classes: int,
               epochs: int) -> ClientDraws: ...

    def meta_perms(self, m: int, epochs: int) -> torch.Tensor: ...

    def cohort(self, num_available: int, m: int) -> np.ndarray: ...

    def pca_test_matrix(self, d: int, l: int,
                        device="cpu") -> torch.Tensor:
        """The randomized PCA's (d, l) f32 test matrix on ``device``: one
        fixed matrix for every client and round, as the reference's. A
        ``client`` draw carries this method as its ``pca_test_matrix``."""

    def locate(self, tick: int, arrivals: Optional[int] = None,
               flush: int = 0) -> None:
        """Where the async service (``fl/service/loop.py``) stands, told
        before the draws it takes there: the start of ``tick``
        (``arrivals`` None), then the tick's ``arrivals`` once drawn
        (each arrival's ``client`` draws follow, in arrival order), then
        before each flush its index ``flush`` within the tick (its
        ``meta_perms`` follow). Draws taken in call order ignore it; draws
        that follow the reference's per-tick key chain need it."""


class GeneratorDraws:
    """``Draws`` from one CPU ``torch.Generator``: the first centre of a
    class is a uniform row of that class (row 0 for a class the client
    lacks — its slots come back empty either way), permutations are
    ``randperm``, the cohort is a ``randperm`` prefix, and the PCA's test
    matrix is the port's fixed draw (``default_test_matrix``)."""

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
        return ClientDraws(first, perms, self.pca_test_matrix)

    def meta_perms(self, m, epochs):
        """(epochs, m) shuffle orders for MetaTraining."""
        return torch.stack([self._randperm(m) for _ in range(epochs)])

    def cohort(self, num_available, m):
        """``m`` distinct client ids out of ``num_available``."""
        return self._randperm(num_available)[:m].numpy()

    def pca_test_matrix(self, d, l, device="cpu"):
        """The port's fixed test matrix (not drawn from the generator)."""
        return default_test_matrix(d, l, device)

    def locate(self, tick, arrivals=None, flush=0):
        """Ignored: one generator, drawn in call order."""


class RecordingDraws:
    """``Draws`` that hand out ``inner``'s and keep a host copy of each
    client's draws and of the meta-training orders, so ``replay()`` can
    give the same round again (to the ranks of a mesh in other processes,
    say). The cohort is not drawn: a recorded round takes it as given."""

    def __init__(self, inner):
        self.inner, self.clients, self.meta = inner, {}, None

    def client(self, position, client, num_classes, epochs):
        got = self.inner.client(position, client, num_classes, epochs)
        self.clients[position] = ClientDraws(got.first_centres.cpu(),
                                             got.local_perms.cpu())
        return got

    def meta_perms(self, m, epochs):
        perms = self.inner.meta_perms(m, epochs)
        self.meta = ((m, epochs), perms.cpu())
        return perms

    def cohort(self, num_available, m):
        raise NotImplementedError("a recorded round takes its cohort as "
                                  "given")

    def replay(self) -> "ReplayDraws":
        """The draws recorded so far, to be handed out again. A replay
        holds no generator: its clients' PCA test matrix is
        ``default_test_matrix`` (``GeneratorDraws``'s; the exact PCA
        solver reads none)."""
        return ReplayDraws(dict(self.clients), self.meta)


class ReplayDraws:
    """A round's draws handed out again: each client position's
    ``ClientDraws`` and the meta-training orders (``((m, epochs),
    perms)``), as ``RecordingDraws`` took them; a ``meta_perms`` call of
    other sizes raises. Plain tensors, so it pickles."""

    def __init__(self, clients: Dict[int, ClientDraws], meta):
        self.clients, self.meta = clients, meta

    def client(self, position, client, num_classes, epochs):
        return self.clients[position]

    def meta_perms(self, m, epochs):
        if (m, epochs) != self.meta[0]:
            raise ValueError(f"meta_perms({m}, {epochs}): recorded "
                             f"{self.meta[0]}")
        return self.meta[1]

    def cohort(self, num_available, m):
        raise NotImplementedError("a replayed round takes its cohort as "
                                  "given")


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


def local_order(n: int, perms: torch.Tensor, cfg: FLConfig) -> torch.Tensor:
    """LocalUpdate's batches as rows of sample indices, (steps, bs): epoch
    ``e`` takes ``perms[e]``, cut to whole batches."""
    bs = min(cfg.local_batch_size, n)
    steps_per_epoch = max(n // bs, 1)
    return perms[:, :steps_per_epoch * bs].reshape(-1, bs)


def local_batches(x: torch.Tensor, y: torch.Tensor, perms: torch.Tensor,
                  cfg: FLConfig):
    """Shuffle + batch one client's data for LocalUpdate: (steps, bs, ...)
    with ``perms[e]`` as the order of epoch ``e``."""
    order = local_order(x.shape[0], perms, cfg).to(x.device)
    perm = order.reshape(-1)
    bx = x[perm].reshape(tuple(order.shape) + tuple(x.shape[1:]))
    by = y[perm].reshape(order.shape)
    return bx, by


def client_arrays(client: ClientData, device: torch.device):
    """One client's data on ``device`` -> (x, y)."""
    return (torch.as_tensor(client.data.x, device=device),
            torch.as_tensor(client.data.y, device=device))


def extract_select(model: SplitModel, params: Params, x: torch.Tensor,
                   y: torch.Tensor, draws: ClientDraws, cfg: FLConfig,
                   num_classes: int):
    """Extract&Selection (§3.1) of one client: its lower forward, then the
    selection over its own maps (BatchNorm normalizes with the batch's own
    statistics, so a forward never mixes two clients). Returns
    ((maps, labels, valid) to upload, Lloyd sweeps); the Table 2 baseline
    (``use_selection=False``) uploads every map, with no sweeps (None)."""
    with torch.no_grad():
        acts = model.apply_lower(params, x)                      # A_k^[j]
    if not cfg.use_selection:
        return (acts, y, torch.ones(x.shape[0], dtype=torch.bool,
                                    device=x.device)), None
    sel = select_metadata(acts, y, draws.first_centres,
                          num_classes=num_classes,
                          clusters_per_class=cfg.clusters_per_class,
                          pca_components=cfg.pca_components,
                          kmeans_iters=cfg.kmeans_iters,
                          pca_solver=cfg.pca_solver,
                          omega=draws.pca_test_matrix)
    return (acts[sel.indices], y[sel.indices], sel.valid), sel.lloyd_iters


def emit_selection_sketch(valid, num_classes: int, clusters_per_class: int,
                          client_id: int, n_k: int) -> None:
    """Persist one client's selection sketch into the trace: the class x
    cluster occupancy bitmap (which §3.1 slots produced a representative)
    plus the selected fraction |D_Mk|/|D_k|. Emitted BEFORE the transport
    encode — the wire compacts the bitmap to the valid rows, so this is
    the only place the (CK,) slot structure still exists. The event nests
    under the open ``select`` span, so the round is its ancestry."""
    if isinstance(valid, torch.Tensor):
        valid = valid.cpu().numpy()
    v = np.asarray(valid).astype(bool).reshape(-1)
    if v.size != num_classes * clusters_per_class:
        return   # Table-2 baseline ships a per-sample mask, not slots
    obs.event("selection_sketch", client=int(client_id),
              occupancy=v.reshape(num_classes,
                                  clusters_per_class).astype(int).tolist(),
              selected=int(v.sum()),
              selected_fraction=float(v.sum() / max(n_k, 1)))


def update_client(model: SplitModel, params: Params, x: torch.Tensor,
                  y: torch.Tensor, draws: ClientDraws, cfg: FLConfig,
                  steps: Optional[fa.CapturedSteps] = None):
    """LocalUpdate (§3.2) of one client from W_G(t-1) in its batch order
    -> (params, mean loss). On the card the SGD step is the one ``steps``
    holds (see ``fedavg.client_update``); the caller sends the update
    frame."""
    order = local_order(x.shape[0], draws.local_perms, cfg).to(x.device)
    new_params, losses = fa.client_update(params, cfg.local_lr, x, y, order,
                                          model.loss, steps)
    return new_params, float(losses.mean())


def client_round(model: SplitModel, params: Params, client: ClientData,
                 cfg: FLConfig, draws: ClientDraws, channel: Channel,
                 num_classes: int, client_id: int = 0,
                 steps: Optional[fa.CapturedSteps] = None):
    """Client k's work: Extract&Selection + LocalUpdate. Both uploads go
    through ``channel``, which charges their exact frame bytes; the
    metadata returned is what the server DECODES (valid rows only,
    dequantized under a lossy codec), or None where a faulty channel lost
    the frame. ``client_id`` is the client's global index, on which a
    faulty channel keys its draws. Returns
    (new_params, metadata, mean local loss, Lloyd sweeps or None)."""
    x, y = client_arrays(client, _device(params))
    with obs.span("client", client=int(client_id)) as csp:
        with obs.span("select") as ssp:
            triple, sweeps = extract_select(model, params, x, y, draws, cfg,
                                            num_classes)
            if ssp.enabled and cfg.use_selection:
                emit_selection_sketch(triple[2], num_classes,
                                      cfg.clusters_per_class, client_id,
                                      x.shape[0])
            metadata = ssp.sync(channel.upload_knowledge(
                client_id, *triple, knowledge_codec(cfg)))
            del triple
            if ssp.enabled and metadata is not None:
                n_sel = int(metadata[2].sum())
                ssp.set(selected=n_sel,
                        selected_fraction=n_sel / max(x.shape[0], 1))
                if sweeps is not None:
                    ssp.set(lloyd_iters=int(sweeps))
        with obs.span("local_update") as lsp:
            new_params, loss = update_client(model, params, x, y, draws,
                                             cfg, steps)
            lsp.sync(new_params)
            if lsp.enabled:
                lsp.set(steps=int(local_order(
                    x.shape[0], draws.local_perms, cfg).shape[0]))
        channel.upload_update(client_id, new_params)
        if csp.enabled:
            csp.set(samples=int(x.shape[0]))
    return new_params, metadata, loss, sweeps


def server_round(model: SplitModel, prev_global: Params, upper_init: Params,
                 client_params: List[Params], metadatas: List[Optional[tuple]],
                 cfg: FLConfig, draws: Draws,
                 fedavg_weights: Optional[List[float]] = None) -> RoundResult:
    """Server's work: aggregate the DECODED metadata (valid rows only, so a
    client may contribute none; a None entry is a frame that never
    survived the wire), MetaTraining from W_G^u(0), ModelCompose, Eq. 2
    over the cohort's updates. ``fedavg_weights`` weigh Eq. 2 (a 0 leaves
    a client out: a straggler, or an update that never arrived); a round
    where no update counts keeps W_G(t-1)."""
    dev = _device(prev_global)
    arrived = [m for m in metadatas if m is not None]
    nmeta, acts = 0, None
    if arrived:
        acts = torch.cat([m[0] for m in arrived], 0).to(dev)
        ys = torch.cat([m[1] for m in arrived], 0).to(dev)
        valid = torch.cat([m[2] for m in arrived], 0).to(dev)
        nmeta = int(valid.sum())
    if acts is None or acts.shape[0] == 0:     # nothing selected anywhere
        upper, meta_losses = upper_init, torch.zeros(0)
    else:
        perms = draws.meta_perms(acts.shape[0], cfg.meta_epochs)
        with obs.span("meta_train", rows=int(acts.shape[0])) as msp:
            upper, meta_losses = mt.meta_train(
                upper_init, model.upper_loss, acts, ys, perms,
                batch_size=cfg.meta_batch_size, lr=cfg.meta_lr,
                l2=cfg.meta_l2, valid=valid)
            msp.sync(upper)
    if not client_params or (fedavg_weights is not None
                             and not any(fedavg_weights)):
        new_global = prev_global
    else:
        new_global = fa.weight_average(client_params, weights=fedavg_weights)
    return RoundResult(global_params=new_global,
                       composed_params=compose(model, prev_global, upper),
                       upper_trained=upper, metadata_count=nmeta,
                       total_samples=0, meta_losses=meta_losses)


def run_cohort(model: SplitModel, params: Params, clients: List[ClientData],
               cfg: FLConfig, draws: Draws, channel: Channel,
               num_classes: int, client_ids: Optional[List[int]] = None,
               steps: Optional[fa.CapturedSteps] = None, mesh=None):
    """The client side of one round for a whole cohort, with the engine
    dispatch in one place (``run_round`` and ``FLSimulation`` share it):
    the cohort engine when ``cfg.distributed_selection`` is set (and the
    round selects), else the client-by-client loop. Every client's draws
    are taken first, in cohort order, whatever the engine. ``client_ids``
    are the members' global indices (default: cohort position), on which
    a faulty channel keys its fates; ``steps`` holds the captured SGD
    steps on the card; ``mesh`` (a ``DeviceMesh`` whose "data" axis is
    wider than 1) splits the cohort engine's clients over its ranks, and
    the client loop takes none. Returns per-client lists (params, metadata
    or None, loss, Lloyd sweeps)."""
    from repro_torch.core import distributed as D
    if client_ids is None:
        client_ids = list(range(len(clients)))
    engine = cfg.distributed_selection and cfg.use_selection
    if D.data_axis_size(mesh) > 1 and not engine:
        raise ValueError("a mesh splits the cohort engine's clients: it "
                         "needs distributed_selection=True and "
                         "use_selection=True")
    cds = [draws.client(pos, c, num_classes, cfg.local_epochs)
           for pos, c in enumerate(clients)]
    if engine:
        return D.cohort_round(model, params, clients, cfg, cds, channel,
                              num_classes, client_ids=client_ids,
                              steps=steps, mesh=mesh)
    out = ([], [], [], [])
    for c, cid, cd in zip(clients, client_ids, cds):
        for acc, v in zip(out, client_round(
                model, params, c, cfg, cd, channel, num_classes,
                client_id=int(cid), steps=steps)):
            acc.append(v)
    return out


def run_round(model: SplitModel, global_params: Params, upper_init: Params,
              clients: List[ClientData], cfg: FLConfig, draws: Draws,
              ledger: Optional[CommLedger] = None,
              num_classes: int = 10, mesh=None) -> RoundResult:
    """One round over ``clients`` (no broadcast charge, as the reference's
    ``run_round``); the ledger gets every upload's exact bytes. The round
    owns its captured SGD steps and frees them at its end. ``mesh`` as
    ``run_cohort``'s: every rank calls with the same arguments and returns
    the same round."""
    ledger = ledger if ledger is not None else CommLedger()
    channel = Channel(ledger, checksum=cfg.transport_checksum)
    steps = fa.CapturedSteps()
    try:
        cparams, metas, losses, _ = run_cohort(
            model, global_params, clients, cfg, draws, channel, num_classes,
            steps=steps, mesh=mesh)
    finally:
        steps.release()
    res = server_round(model, global_params, upper_init, cparams, metas, cfg,
                       draws)
    res.client_losses = losses
    res.total_samples = sum(len(c.data) for c in clients)
    return res
