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

Not ported: ``selection_mesh``, ``data_axis_size``, ``_pad_clients``,
``_select_stack_sharded`` and ``select_metadata_sharded``, which matter
only with more than one device, and the reference's client-chunk
streaming (``auto_chunk_size``, ``cohort_inputs_fit``), which bounds a
batched forward's footprint that this engine never builds (ROADMAP Queue
1 item 15).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from repro_torch import obs
from repro_torch.configs.base import FLConfig
from repro_torch.core import fedavg as fa
from repro_torch.core import rounds as R
from repro_torch.core.split import SplitModel
from repro_torch.data.partition import ClientData
from repro_torch.fl.transport.channel import Channel
from repro_torch.fl.transport.codecs import get_codec


def cohort_round(model: SplitModel, params: R.Params,
                 clients: List[ClientData], cfg: FLConfig,
                 draws: Sequence[R.ClientDraws], channel: Channel,
                 num_classes: int, *,
                 client_ids: Optional[List[int]] = None,
                 steps: Optional[fa.CapturedSteps] = None):
    """Everything the cohort's clients do in one round: each client's
    Extract&Selection, one batched knowledge upload through ``channel``,
    then each client's LocalUpdate and update frame under its GLOBAL
    ``client_ids`` (a faulty channel keys its fates on them, so the same
    faults land on either engine). ``draws`` are the clients' draws in
    cohort order; ``steps`` holds the captured SGD steps on the card.
    Returns per-client lists (params, metadata or None, loss, Lloyd
    sweeps), interchangeable with ``rounds.run_cohort``'s client-by-client
    loop, ledger bytes included."""
    if not cfg.use_selection:
        raise ValueError("cohort_round runs the selection path only; the "
                         "Table-2 baseline (use_selection=False) runs "
                         "through the client-by-client loop")
    if client_ids is None:
        client_ids = list(range(len(clients)))
    dev = next(iter(params.values())).device
    b = len(clients)
    data = [R.client_arrays(c, dev) for c in clients]
    with obs.span("select", clients=b) as ssp:
        picked = [R.extract_select(model, params, x, y, d, cfg, num_classes)
                  for (x, y), d in zip(data, draws)]
        sel_acts, sel_ys, valid = (torch.stack(t)
                                   for t in zip(*(p[0] for p in picked)))
        ssp.sync(valid)
        if ssp.enabled:
            vnp = valid.cpu().numpy()
            ssp.set(selected=int(vnp.sum()),
                    lloyd_iters=[p[1] for p in picked])
            for i, cid in enumerate(client_ids):
                R.emit_selection_sketch(vnp[i], num_classes,
                                        cfg.clusters_per_class, int(cid),
                                        data[i][0].shape[0])
    with obs.span("transport", clients=b) as tsp:
        metadatas = tsp.sync(channel.upload_knowledge_batched(
            client_ids, sel_acts, sel_ys, valid,
            get_codec(cfg.transport_codec)))
    del sel_acts, sel_ys, valid
    cparams, losses = [], []
    with obs.span("local_update", clients=b) as lsp:
        for (x, y), d in zip(data, draws):
            p, loss = R.update_client(model, params, x, y, d, cfg, steps)
            cparams.append(p)
            losses.append(loss)
        lsp.sync(cparams)
    with obs.span("transport", clients=b):
        for cid, p in zip(client_ids, cparams):
            channel.upload_update(int(cid), p)
    return cparams, metadatas, losses, [p[1] for p in picked]
