"""The paper's technique generalized to a language model, on the port: the
twin of ``examples/federated_lm.py``. Split a reduced llama3.2-1b at layer
j, run FedAvg on the lower part, select representative hidden states by
PCA + K-means, and meta-train the upper part on them, with the same core
library the WRN path uses.

  PYTHONPATH=src python -m repro_torch.launch.federated_lm [--device cpu] [--rounds 3]

Per round and client: LocalUpdate (``local_update_tree``, SGD lr 0.05,
batches of 16), then selection on the mean-pooled split-layer hidden
states of the round's global weights (6 clusters, P = 16, 10 Lloyd
sweeps); the server meta-trains the upper part from ``upper0`` on the
selected sequences (5 epochs, batches of 8), averages the clients
(FedAvg), composes [new lower ; meta-trained upper] and reports the
composed model's next-token accuracy on 64 held-out sequences. The data
are the reference's (numpy); the weights are random from seed 0, and the
draws come from a ``torch.Generator`` seeded 0: each (round, client) gets
its own K-means first centre (a shared one would correlate the clients'
selections), each round its own meta-training order. Runs on ``cuda``
unless ``--device cpu`` is given, and fails without a CUDA device
otherwise.
"""
from __future__ import annotations

import argparse
from typing import List

import torch

from repro_torch.configs import get_config
from repro_torch.core import fedavg as fa
from repro_torch.core.meta_training import meta_train
from repro_torch.core.selection import select_metadata
from repro_torch.data import SyntheticTokenDataset, partition_k_shards
from repro_torch.device import resolve_device
from repro_torch.models.transformer import make_split_lm
from repro_torch.optim import sgd

BATCH, CLUSTERS, PCA, LLOYD = 16, 6, 16, 10
META_EPOCHS, META_BATCH, LR = 5, 8, 0.05


def main(argv=None) -> List[dict]:
    """Run the rounds; returns one dict a round (selected, frac,
    meta_loss, acc)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("llama3.2-1b").reduced()
    model, lm = make_split_lm(cfg)
    print(f"LM: {cfg.name} (reduced), split at layer {model.split_layer} "
          f"of {cfg.num_layers}")

    # non-IID clients: per-class bigram token processes
    ds = SyntheticTokenDataset(512, seq_len=32, vocab_size=cfg.vocab_size,
                               num_classes=6)
    clients = partition_k_shards(ds, 4, k_classes=2, samples_per_client=96)

    gen = torch.Generator().manual_seed(0)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    _, upper0 = model.split(params)
    opt = sgd(LR)
    test = torch.as_tensor(ds.x[:64], device=dev)
    n_total = sum(len(c.data) for c in clients)

    def loss(p_, b):
        return model.loss(p_, (b,))

    out = []
    for rnd in range(args.rounds):
        client_params, metadatas = [], []
        for c in clients:
            toks = torch.as_tensor(c.data.x, device=dev)
            # LocalUpdate (§3.2)
            steps = len(toks) // BATCH
            batches = toks[:steps * BATCH].reshape(steps, BATCH, -1)
            p, _, _ = fa.local_update_tree(params, opt, opt.init(params),
                                           batches, loss)
            client_params.append(p)
            # Extract&Selection (§3.1) on mean-pooled split-layer hiddens
            with torch.no_grad():
                acts = model.apply_lower(params, toks)       # (N, T, d)
            first = int(torch.randint(len(toks), (1,), generator=gen))
            sel = select_metadata(acts.mean(1), None, first,
                                  per_class=False,
                                  clusters_per_class=CLUSTERS,
                                  pca_components=PCA, kmeans_iters=LLOYD)
            metadatas.append((acts[sel.indices], toks[sel.indices],
                              sel.valid))
        # server: aggregate metadata, MetaTraining (§3.3)
        acts = torch.cat([m[0] for m in metadatas])
        toks = torch.cat([m[1] for m in metadatas])
        valid = torch.cat([m[2] for m in metadatas])
        perms = torch.stack([torch.randperm(len(acts), generator=gen)
                             for _ in range(META_EPOCHS)])
        upper, meta_losses = meta_train(upper0, model.upper_loss, acts, toks,
                                        perms, batch_size=META_BATCH, lr=LR,
                                        valid=valid)
        # compose + FedAvg
        new_global = fa.weight_average(client_params)
        composed = model.merge(model.split(new_global)[0], upper)
        # next-token accuracy of the composed model on held-out data
        with torch.no_grad():
            logits = model.apply(composed, test)
        acc = float((torch.argmax(logits[:, :-1], -1) == test[:, 1:])
                    .float().mean())
        selected = int(valid.sum())
        frac = selected / n_total
        print(f"round {rnd}: selected {selected} seqs "
              f"({frac:.1%} of client data), meta loss "
              f"{float(meta_losses[-1]):.3f}, composed next-token acc "
              f"{acc:.3f}")
        out.append({"selected": selected, "frac": frac,
                    "meta_loss": float(meta_losses[-1]), "acc": acc})
        params = new_global
    print("done — the same §3 pipeline, attention-free of the backbone type")
    return out


if __name__ == "__main__":
    main()
