"""Federated-split LM training launcher: the port of ``repro.launch.train``.

Runs the paper's Algorithm 1 on an LM, one federated round per step (L
local steps a cohort -> FedAvg -> metadata selection -> server-side upper
training -> compose), through ``launch/steps.py`` ``make_train_step``.
On one device there is one cohort (G = 1, what the reference's smoke mesh
gives on one device); the production mesh is ``ROADMAP.md`` Queue 1 item
15. ``--smoke`` runs the reduced config.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke --steps 4 [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given (and fails if
there is none). Weights are random (seed 1), tokens uniform from a numpy
generator seeded 0, and each cohort's K-means first centre a draw from a
``torch.Generator`` seeded 0. ``--ckpt-dir`` saves the average after every
round in the reference's npz format (``repro_torch.checkpoint``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import tree_map
from repro_torch.obs.timing import monotonic

COHORTS = 1          # G on one device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--no-split-fl", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    tcfg = TrainConfig(local_steps=args.local_steps,
                       split_fl=not args.no_split_fl,
                       microbatch=min(8, args.global_batch))
    step_fn, lm = make_train_step(cfg, tcfg)
    # the reference's input_specs on a mesh of G cohorts
    cohort_batch = max(args.global_batch // COHORTS, 1)
    mb = min(tcfg.microbatch, cohort_batch)
    n_micro = max(cohort_batch // mb, 1)
    shape = (COHORTS, tcfg.local_steps, n_micro, mb, args.seq_len)

    params0 = lm.init(torch.Generator(device=dev).manual_seed(1))
    client_params = tree_map(
        lambda x: x[None].expand((COHORTS,) + tuple(x.shape)), params0)
    opt_state = ()
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    rng = np.random.default_rng(0)
    first = torch.Generator().manual_seed(0)
    for t in range(args.steps):
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, shape, np.int32)).to(dev)}
        t0 = monotonic()
        client_params, opt_state, metrics = step_fn(client_params, opt_state,
                                                    batch, first)
        metrics = {k: float(v) for k, v in metrics.items()}   # syncs
        print(f"round {t}: {metrics}  ({monotonic()-t0:.2f}s)")
        if mgr:
            mgr.save(t, tree_map(lambda x: x[0], client_params),
                     {"arch": args.arch})
    print("train: done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
