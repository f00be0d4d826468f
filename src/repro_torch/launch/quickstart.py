"""Quickstart of the port: the paper's split-FL with clustered data
selection, end to end — the twin of ``examples/quickstart.py``.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]
      [--codec {raw_f32,f16,int8}]

Runs on the CUDA device unless ``--device cpu`` is given (and fails if
there is none). Same data, model size and FL knobs as the reference's
quickstart: a WRN-10-1 at 16x16, 4 non-IID clients of 250 samples from 2
classes each, 3 rounds, the raw_f32 codec (the FLConfig default);
``--codec`` picks another wire codec.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import FLConfig, get_wrn_config
from repro_torch.core.split import make_split_wrn
from repro_torch.data import SyntheticImageDataset, partition_k_shards
from repro_torch.fl.simulation import FLSimulation


def parse_args(argv=None) -> argparse.Namespace:
    """The quickstart's command line."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    ap.add_argument("--codec", default="raw_f32",
                    choices=("raw_f32", "f16", "int8"),
                    help="wire codec of the knowledge upload")
    return ap.parse_args(argv)


def make_simulation(args: argparse.Namespace) -> FLSimulation:
    """The reference quickstart's model, clients and FL knobs, on
    ``args.device`` with ``args.codec`` on the wire."""
    cfg = get_wrn_config().reduced()
    model = make_split_wrn(cfg)
    print(f"model: {cfg.name}, split after group {cfg.split_group}")
    train = SyntheticImageDataset(2000, image_size=cfg.image_size,
                                  modes_per_class=3, seed=0)
    test = SyntheticImageDataset(400, image_size=cfg.image_size,
                                 modes_per_class=3, seed=1)
    clients = partition_k_shards(train, num_clients=4, k_classes=2,
                                 samples_per_client=250)
    print(f"clients: {len(clients)}, classes per client: "
          f"{[c.classes.tolist() for c in clients]}")
    flcfg = FLConfig(num_clients=4, clients_per_round=4, local_epochs=1,
                     local_batch_size=50, local_lr=0.05,
                     pca_components=24, clusters_per_class=4,
                     meta_epochs=40, meta_batch_size=8, meta_lr=0.05,
                     transport_codec=args.codec)
    return FLSimulation(model, clients, test, flcfg, seed=0,
                        device=args.device)


def main(argv=None):
    sim = make_simulation(parse_args(argv))
    print(f"device: {sim.device}")
    res = sim.run(rounds=3, eval_every=1, verbose=True)
    frac = res.metadata_counts[-1] / res.comm["total_samples"]
    print(f"\nselected metadata fraction: {frac:.2%}  (paper: ~0.8%)")
    print(f"metadata upload: {res.comm['up']['metadata']/1e6:.2f} MB; "
          f"weight upload: {res.comm['up']['weights']/1e6:.2f} MB")
    print(f"final composed-model accuracy: {res.test_acc[-1]:.2%}; "
          f"FedAvg global model: {res.fedavg_acc[-1]:.2%}")
    return res


if __name__ == "__main__":
    main()
