"""End-to-end driver of the port: the paper's experiment grid at a
configurable scale — the twin of ``examples/paper_repro.py``. Every round
is a full federated round over all clients.

  # reduced scale on the CPU:
  PYTHONPATH=src python -m repro_torch.launch.paper_repro --device cpu \\
      --rounds 30 --clients 5

  # the paper's setting on the card:
  PYTHONPATH=src python -m repro_torch.launch.paper_repro --rounds 100 \\
      --clients 20 --samples-per-client 2500 --clusters 20 --full-wrn

The reference's flags, data, model and ``FLConfig``, and the same JSON
keys in ``--out`` (default ``experiments/paper_repro_torch.json``, so the
reference's ``experiments/paper_repro.json`` is never overwritten).
``--ckpt-dir`` saves the final W_G in the reference's tree
(``params_to_jax``) with ``repro_torch.checkpoint``, so either package
restores it. Runs on ``cuda`` unless ``--device cpu`` is given, and fails
without a CUDA device otherwise.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import FLConfig, get_wrn_config
from repro_torch.core.split import make_split_wrn
from repro_torch.data import SyntheticImageDataset, partition_k_shards
from repro_torch.fl.simulation import FLSimulation
from repro_torch.models.wrn import params_to_jax
from repro_torch.obs.timing import monotonic


def parse_args(argv=None) -> argparse.Namespace:
    """The reference driver's command line plus ``--device``."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--samples-per-client", type=int, default=400)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--meta-epochs", type=int, default=10)
    ap.add_argument("--l2", type=float, default=5e-4)
    ap.add_argument("--full-wrn", action="store_true",
                    help="WRN-40-1 at 32x32 (the paper's exact model)")
    ap.add_argument("--no-selection", action="store_true",
                    help="Table 2 baseline: upload ALL activation maps")
    ap.add_argument("--out", default="experiments/paper_repro_torch.json")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; 'cpu' to run there)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the grid point ``argv`` names; returns what it writes."""
    args = parse_args(argv)
    cfg = get_wrn_config() if args.full_wrn else get_wrn_config().reduced()
    model = make_split_wrn(cfg)

    n_train = max(args.clients * args.samples_per_client, 3000)
    train = SyntheticImageDataset(n_train, image_size=cfg.image_size,
                                  modes_per_class=3, seed=0)
    test = SyntheticImageDataset(800, image_size=cfg.image_size,
                                 modes_per_class=3, seed=1)
    clients = partition_k_shards(train, args.clients, k_classes=2,
                                 samples_per_client=args.samples_per_client)

    flcfg = FLConfig(num_clients=args.clients,
                     clients_per_round=args.clients,
                     local_epochs=1, local_batch_size=50, local_lr=0.05,
                     pca_components=24, clusters_per_class=args.clusters,
                     meta_epochs=args.meta_epochs, meta_batch_size=20,
                     meta_lr=0.05, meta_l2=args.l2,
                     use_selection=not args.no_selection)

    sim = FLSimulation(model, clients, test, flcfg, seed=0,
                       device=args.device)
    t0 = monotonic()
    res = sim.run(rounds=args.rounds, eval_every=max(args.rounds // 10, 1),
                  verbose=True)
    if args.ckpt_dir:
        CheckpointManager(args.ckpt_dir).save(
            args.rounds, params_to_jax(sim.server.global_params),
            {"cfg": str(flcfg)})

    out = {
        "config": vars(args),
        "test_acc": res.test_acc,
        "fedavg_acc": res.fedavg_acc,
        "metadata_counts": res.metadata_counts,
        "selected_fraction": res.selected_fraction,
        "comm": dict(res.comm),
        "wall_time_s": monotonic() - t0,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, default=str)
    kind = ("no-selection baseline" if args.no_selection
            else "with selection")
    print(f"\nwrote {args.out}; final acc {res.test_acc[-1]:.2%} ({kind})")
    return out


if __name__ == "__main__":
    main()
