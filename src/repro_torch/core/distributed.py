"""The cohort engine: the client side of a round over the whole cohort on
one device — the port's counterpart of ``repro.core.distributed``.

``cohort_round`` runs every client's Extract&Selection, then ONE batched
upload of the cohort's selected knowledge (one int8 quantize launch for
the cohort, ``Channel.upload_knowledge_batched``), then every client's
LocalUpdate, then every client's update frame — under the reference's
``select`` / ``transport`` / ``local_update`` / ``transport`` spans. Each
client's forward, selection and update run client by client, on the same
ops, draws and captured SGD step as the client-by-client loop of
``core/rounds.py``: the port's BatchNorm normalizes with the batch's own
statistics, so one forward over a flattened (B·N) stack would mix the
clients' statistics (the reference's ``vmap`` keeps them apart), and
``torch.func.vmap`` over the client axis would re-batch the convolution
gradients into other reduction orders. So the engine's results are
bit-identical to the loop's, on the CPU and on the card. Only the selected
maps are stacked, so a ragged cohort (clients of different sizes) runs
here too.

With a ``mesh`` (a ``DeviceMesh`` over the world with a "data" axis wider
than 1: ``selection_mesh``, or the smoke and production meshes), rank r
takes a contiguous share of the client axis, padded to a multiple of the
axis with copies of client 0 as the reference pads
(``_pad_clients``), and runs the same one-client-at-a-time selection and
captured LocalUpdate on it. The selections and updates are all-gathered
to every rank in client order (``core/collectives.py``, bytes on the
wire), the pad dropped; the upload, the ledger and FedAvg then run in
client order on every rank. So a round over any number of ranks gives the
bits of this engine on one device.

The reference's client-chunk streaming (``auto_chunk_size``,
``cohort_inputs_fit``) bounds the footprint of a batched forward over a
chunk of clients, which this engine never builds: it stays a no-op here
(``FLConfig.selection_chunk_size`` is accepted and chooses nothing).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.configs.base import FLConfig
from repro_torch.core import fedavg as fa
from repro_torch.core import rounds as R
from repro_torch.core.collectives import Ranks, all_gather_tree
from repro_torch.core.selection import Selection, select_metadata_batched
from repro_torch.core.split import SplitModel
from repro_torch.data.partition import ClientData
from repro_torch.fl.transport.channel import Channel, knowledge_codec
from repro_torch.optim.optimizers import tree_map


def selection_mesh(num_devices: int = 0, device_type: str = "cuda"):
    """A 1-D "data" mesh over every rank of the world (the reference's
    over the host's devices); ``num_devices``, where given, must be the
    world size."""
    from repro_torch.launch.mesh import mesh_over_world
    n = num_devices or torch.distributed.get_world_size()
    return mesh_over_world((n,), ("data",), device_type)


def data_axis_size(mesh) -> int:
    """The mesh's "data" axis (1 without a mesh)."""
    if mesh is None:
        return 1
    from repro_torch.launch.mesh import mesh_axis_sizes
    return mesh_axis_sizes(mesh).get("data", 1)


def _pad_clients(items: Sequence, ndev: int):
    """The client axis padded to a multiple of ``ndev`` with copies of
    client 0 (their outputs are dropped: selections and updates are
    client-independent). -> (padded list, unpad: the first len(items)
    entries of a list)."""
    b = len(items)
    padded = list(items) + [items[0]] * ((-b) % ndev)
    return padded, lambda xs: xs[:b]


def _share(items: Sequence, mesh):
    """-> (this rank's share of the client axis, gather). Over a "data"
    axis wider than 1 the axis is padded (``_pad_clients``), the rank takes
    its contiguous share, and ``gather`` turns a tree of the share's
    outputs (stacked on a leading axis) into the whole cohort's, in client
    order, the pad dropped. Without a mesh, or on an axis of 1, the share
    is every client and ``gather`` returns the tree as it is."""
    if data_axis_size(mesh) <= 1:
        return list(items), lambda tree: tree
    ranks = Ranks.of(mesh.get_group("data"))
    padded, unpad = _pad_clients(items, ranks.size)

    def gather(tree):
        return tree_map(
            lambda x: unpad(x.reshape((-1,) + tuple(x.shape[2:]))),
            all_gather_tree(tree, ranks))
    return [padded[i] for i in ranks.share(len(padded))], gather


def _select_stack(model: SplitModel, params: R.Params, clients, draws,
                  cfg: FLConfig, num_classes: int, mesh):
    """Extract&Selection of the cohort, one client at a time
    (``rounds.extract_select``), over the mesh's "data" axis where given:
    each rank selects for its share. -> every client's (sel_acts, sel_ys,
    valid) stacked in client order, and its Lloyd sweeps."""
    dev = next(iter(params.values())).device
    mine, gather = _share(list(zip(clients, draws)), mesh)
    picked = [R.extract_select(model, params, *R.client_arrays(c, dev), d,
                               cfg, num_classes) for c, d in mine]
    local = tuple(torch.stack(t) for t in zip(*(p[0] for p in picked)))
    sweeps = torch.tensor([p[1] for p in picked], dtype=torch.int64,
                          device=dev)
    (sel_acts, sel_ys, valid), sweeps = gather((local, sweeps))
    return sel_acts, sel_ys, valid, sweeps.tolist()


def select_metadata_sharded(acts: torch.Tensor,
                            labels: Optional[torch.Tensor],
                            first: torch.Tensor, mesh, **knobs) -> Selection:
    """``select_metadata`` of each client of a stacked cohort over the
    mesh's "data" axis: acts (B, N, ...), labels (B, N) or None, ``first``
    each client's draws (as ``select_metadata_batched``); each rank
    selects for its share, and every rank returns the whole cohort's
    ``Selection`` (leading client axis, ``lloyd_iters`` a list), bit for
    bit ``select_metadata_batched``'s."""
    mine, gather = _share(list(range(acts.shape[0])), mesh)
    idx = torch.tensor(mine, dtype=torch.int64, device=acts.device)
    sel = select_metadata_batched(
        acts[idx], None if labels is None else labels[idx],
        first[idx.to(first.device)], **knobs)
    sweeps = torch.tensor(sel.lloyd_iters, dtype=torch.int64,
                          device=acts.device)
    indices, valid, features, sweeps = gather(
        (sel.indices, sel.valid, sel.features, sweeps))
    return Selection(indices, valid, features, sweeps.tolist())


def local_update_cohort(model: SplitModel, params: R.Params, clients,
                        draws, cfg: FLConfig,
                        steps: Optional[fa.CapturedSteps] = None, mesh=None):
    """LocalUpdate (§3.2) of every client of the cohort from W_G(t-1), one
    client at a time (``rounds.update_client``) -> (per-client params,
    losses). With a mesh whose "data" axis is wider than 1, each rank
    updates its share of the (padded) cohort and every rank gets every
    client's params, all-gathered bit for bit in client order."""
    dev = next(iter(params.values())).device
    mine, gather = _share(list(zip(clients, draws)), mesh)
    out = [R.update_client(model, params, *R.client_arrays(c, dev), d, cfg,
                           steps) for c, d in mine]
    stacked, losses = gather(
        ({k: torch.stack([p[k] for p, _ in out]) for k in params},
         torch.tensor([loss for _, loss in out], dtype=torch.float64,
                      device=dev)))
    return ([{k: v[i] for k, v in stacked.items()}
             for i in range(len(clients))], losses.tolist())


def cohort_round(model: SplitModel, params: R.Params,
                 clients: List[ClientData], cfg: FLConfig,
                 draws: Sequence[R.ClientDraws], channel: Channel,
                 num_classes: int, *,
                 client_ids: Optional[List[int]] = None,
                 steps: Optional[fa.CapturedSteps] = None, mesh=None):
    """Everything the cohort's clients do in one round: each client's
    Extract&Selection, one batched knowledge upload through ``channel``,
    then each client's LocalUpdate and update frame under its GLOBAL
    ``client_ids`` (a faulty channel keys its fates on them, so the same
    faults land on either engine). ``draws`` are the clients' draws in
    cohort order; ``steps`` holds the captured SGD steps on the card;
    ``mesh`` splits the selections and updates over its "data" axis (see
    the module's docstring), every rank calling with the same arguments.
    Returns per-client lists (params, metadata or None, loss, Lloyd
    sweeps), interchangeable with ``rounds.run_cohort``'s client-by-client
    loop, ledger bytes included."""
    if not cfg.use_selection:
        raise ValueError("cohort_round runs the selection path only; the "
                         "Table-2 baseline (use_selection=False) runs "
                         "through the client-by-client loop")
    if client_ids is None:
        client_ids = list(range(len(clients)))
    b = len(clients)
    with obs.span("select", clients=b) as ssp:
        sel_acts, sel_ys, valid, sweeps = _select_stack(
            model, params, clients, draws, cfg, num_classes, mesh)
        ssp.sync(valid)
        if ssp.enabled:
            vnp = valid.cpu().numpy()
            ssp.set(selected=int(vnp.sum()), lloyd_iters=sweeps)
            for i, cid in enumerate(client_ids):
                R.emit_selection_sketch(vnp[i], num_classes,
                                        cfg.clusters_per_class, int(cid),
                                        len(clients[i].data))
    with obs.span("transport", clients=b) as tsp:
        metadatas = tsp.sync(channel.upload_knowledge_batched(
            client_ids, sel_acts, sel_ys, valid,
            knowledge_codec(cfg)))
    del sel_acts, sel_ys, valid
    with obs.span("local_update", clients=b) as lsp:
        cparams, losses = local_update_cohort(model, params, clients, draws,
                                              cfg, steps, mesh)
        lsp.sync(cparams)
    with obs.span("transport", clients=b):
        for cid, p in zip(client_ids, cparams):
            channel.upload_update(int(cid), p)
    return cparams, metadatas, losses, sweeps


def run_round_distributed(model: SplitModel, global_params: R.Params,
                          upper_init: R.Params, clients: List[ClientData],
                          cfg: FLConfig, draws: R.Draws, ledger=None,
                          num_classes: int = 10, mesh=None) -> R.RoundResult:
    """Algorithm 1 with the client side on this engine (over ``mesh``'s
    "data" axis where given) and ``rounds.server_round``: ``rounds.
    run_round`` with ``distributed_selection`` on, the same bits."""
    return R.run_round(model, global_params, upper_init, clients,
                       dataclasses.replace(cfg, distributed_selection=True),
                       draws, ledger=ledger, num_classes=num_classes,
                       mesh=mesh)
