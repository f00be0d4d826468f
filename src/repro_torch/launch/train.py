"""Federated-split LM training launcher: the port of ``repro.launch.train``.

Runs the paper's Algorithm 1 on an LM, one federated round per step (L
local steps a cohort -> FedAvg -> metadata selection -> server-side upper
training -> compose), through ``launch/steps.py`` ``make_train_step`` on a
mesh: under ``--smoke`` the smoke mesh over the world (one process, or
``torchrun --nproc-per-node N``) and the reduced config, else the
production mesh, which needs 256 ranks and so raises on one card, as the
reference does without 256 devices. The cohorts G are ``fed_layout``'s on
the mesh (one process: G = 1; N ranks on the smoke mesh's "data" axis: G =
N, one cohort a rank). At N = 4 the smoke mesh is the reference's (2, 2):
two cohorts over "data", each trained tensor parallel over "model", the
weights DTensors on the train plan (``specs.step_plan``), for every
arch; an arch above ``FSDP_THRESHOLD`` (jamba, deepseek) shards its
weights over "data" there (FSDP: G = 1, each cohort's rows over "data",
each block's weights gathered at its entry, ``models/fsdp.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b --smoke --steps 4 [--device cpu]
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train --smoke --device cpu
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --smoke --device cpu

Runs on the CUDA device unless ``--device cpu`` is given (and fails if
there is none). The process group comes from torchrun's environment where
it set one, else it is this one process; NCCL where every rank has a card
of its own, gloo otherwise (the CPU, or more ranks than cards). Weights
are random (seed 1), tokens uniform from a numpy generator seeded 0, and
each cohort's K-means first centre a draw from a ``torch.Generator``
seeded 0, the same on every rank. Rank 0 prints and saves: ``--ckpt-dir``
saves the average after every round in the reference's npz format
(``repro_torch.checkpoint``).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (make_production_mesh, make_smoke_mesh,
                                     mesh_axis_sizes)
from repro_torch.launch.sharding import distribute_tree, gather_tree
from repro_torch.launch.specs import fed_layout, step_plan
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import tree_map
from repro_torch.obs.timing import monotonic


def rank_device(dev: torch.device, env=None, cards=None) -> torch.device:
    """This rank's device. Under torchrun (``WORLD_SIZE`` in ``env``, by
    default the process's environment) a CUDA rank takes card
    ``LOCAL_RANK`` mod the ``cards`` (by default the visible ones);
    otherwise the device asked for, its index kept."""
    env = os.environ if env is None else env
    if dev.type != "cuda" or "WORLD_SIZE" not in env:
        return dev
    cards = torch.cuda.device_count() if cards is None else cards
    return torch.device("cuda", int(env.get("LOCAL_RANK", "0")) % cards)


def join_world(dev: torch.device) -> torch.device:
    """Start the default process group: torchrun's (its environment's
    rank, world size and address) where it set one, else a world of this
    one process. NCCL where every rank has a card of its own, else gloo.
    -> this rank's device (``rank_device``)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    dev = rank_device(dev)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    backend = ("nccl" if dev.type == "cuda"
               and world <= torch.cuda.device_count() else "gloo")
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


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

    dev = join_world(resolve_device(args.device))
    try:
        return _train(args, dev)
    finally:
        dist.destroy_process_group()


def _train(args, dev: torch.device) -> int:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
        mesh = make_smoke_mesh(device_type=dev.type)
    else:
        mesh = make_production_mesh(device_type=dev.type)
    tcfg = TrainConfig(local_steps=args.local_steps,
                       split_fl=not args.no_split_fl,
                       microbatch=min(8, args.global_batch))
    step_fn, lm = make_train_step(cfg, tcfg, mesh=mesh)
    # the reference's input_specs on a mesh of G cohorts
    axes = mesh_axis_sizes(mesh)
    g, _ = fed_layout(cfg, axes)
    cohort_batch = max(args.global_batch // g, 1)
    mb = min(tcfg.microbatch, cohort_batch)
    n_micro = max(cohort_batch // mb, 1)
    shape = (g, tcfg.local_steps, n_micro, mb, args.seq_len)
    lead = dist.get_rank() == 0

    params0 = lm.init(torch.Generator(device=dev).manual_seed(1))
    client_params = tree_map(
        lambda x: x[None].expand((g,) + tuple(x.shape)), params0)
    if axes.get("model", 1) > 1:
        # each rank its cohorts' shards of the weights
        client_params = distribute_tree(
            client_params, step_plan(cfg, axes, "train", tcfg, lm, g), mesh)
    opt_state = ()
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir and lead else None
    rng = np.random.default_rng(0)
    first = torch.Generator().manual_seed(0)
    for t in range(args.steps):
        batch = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab_size, shape, np.int32)).to(dev)}
        t0 = monotonic()
        client_params, opt_state, metrics = step_fn(client_params, opt_state,
                                                    batch, first)
        metrics = {k: float(v) for k, v in metrics.items()}   # syncs
        if lead:
            print(f"round {t}: {metrics}  ({monotonic()-t0:.2f}s)")
        if args.ckpt_dir:
            # every rank joins the gather (of the shards on a model axis)
            avg = tree_map(lambda x: x[0], gather_tree(client_params))
            if mgr:
                mgr.save(t, avg, {"arch": args.arch})
    if lead:
        print("train: done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
