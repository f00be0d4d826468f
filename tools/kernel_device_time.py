#!/usr/bin/env python3
"""Device time of the port's selection and transport kernels at the main
path's shapes, and what deterministic cuDNN costs LocalUpdate.

    python3 tools/kernel_device_time.py [--src DIR] [--src DIR] ...
    python3 tools/kernel_device_time.py --local-update

Needs one CUDA card. Each ``--src`` names a ``src`` directory that holds a
``repro_torch`` package (default: this checkout's ``src``); the runs go in
the order given, each in its own process, so two trees can be compared on
one card in turns (``--src A --src B --src B --src A``). A run builds that
tree's kernels and measures:

* the two K-means kernels at one client's shapes (N = 2,500 PCA rows of
  width 200; K = 10 centres for a farthest-point-init step; K = 100
  label-masked slots for a Lloyd sweep, the rows drawn from 2 of the 10
  classes as a client holds them);
* the int8 quantize kernel on the main path's (100, 16384) slot payload
  with 20 of the 100 rows valid (a client of 2 classes x 10 clusters)
  and with 80, and on a (1, 1) payload (the launch's fixed cost); on a
  tree that plans its quantize launch (``kernels/quantize.py``
  ``plan_for``), also each mask on each route: resident, and L2 (the
  same plan with no shared memory);

each as

* ``device_ms``: each CUDA launch's own device time per call
  (``repro_torch.obs.device_time.kernel_device_ms``, taken from this
  checkout whichever tree is measured: ``torch.profiler``, summed by
  kernel name over ``ITERS`` calls after a warm-up, divided by the
  launches it saw; a Lloyd sweep is two launches, and so is a quantize
  call of a tree before the one-launch kernel);
* ``call_ms``: the wrapper call's time (CUDA events around ``ITERS``
  back-to-back calls), which also counts the host's work between launches;

and ``sm_clock_mhz``: the SM clock the card ran at, from
``torch.cuda._sleep`` (a kernel that spins for a given number of cycles):
``short`` from the profiler's device time of each of ``ITERS`` spins of
about the K-means kernels' length, called back to back as these calls are,
``long`` from CUDA events around one spin of about a millisecond.

``--local-update`` times, in this checkout and in one process, one
client's LocalUpdate at the main path's full width (WRN-40-1 split after
group 1, 2,500 samples, 50 SGD steps of batch 50) with cuDNN's
deterministic algorithms off and on, in turns (off, on, on, off, three
times), with the median of each, and checks that every run with them on
gives the same bits.

It prints one JSON line per run and then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS, WARMUP = 200, 5
SHORT_SPIN, LONG_SPIN = 20_000, 2_000_000        # cycles
N, P, K_INIT, CLASSES, PER_CLASS = 2500, 200, 10, 10, 10
SLOTS, WIDTH, VALID_ROWS = 100, 16384, (20, 80)
LU_ROUNDS = 3                       # (off, on, on, off) rounds of LocalUpdate
LAUNCHES = {"kmeans_pairwise_dist": ("pairwise_dist_kernel",),
            "kmeans_lloyd_step": ("lloyd_assign_kernel",
                                  "lloyd_sums_kernel")}
# the quantize kernels by name: one launch, or the earlier two
QUANT_LAUNCHES = (("quantize_affine_kernel",),
                  ("minmax_kernel", "quantize_kernel"))
DEVICE_TIME = os.path.join(ROOT, "src", "repro_torch", "obs",
                           "device_time.py")


def _kernel_device_ms():
    """``kernel_device_ms`` of this checkout (it imports only torch), so
    every measured tree is timed the same way."""
    spec = importlib.util.spec_from_file_location("_device_time",
                                                  DEVICE_TIME)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.kernel_device_ms


def _events_ms(fn, iters):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def measure(src: str) -> dict:
    """One run against the ``repro_torch`` under ``src``."""
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch.kernels import build, ops
    kernel_device_ms = _kernel_device_ms()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_device_time: needs a CUDA device")
    build.load_all()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(N, P, generator=g).to(dev)
    c_init = torch.randn(K_INIT, P, generator=g).to(dev)
    c_all = torch.randn(CLASSES * PER_CLASS, P, generator=g).to(dev)
    labels = torch.tensor([3, 7])[torch.randint(2, (N,), generator=g)]
    slot = torch.arange(CLASSES * PER_CLASS) // PER_CLASS
    lm = torch.where(labels[:, None] == slot[None], 0.0, 1e30).float().to(dev)
    qx = torch.randn(SLOTS, WIDTH, generator=g).to(dev)
    qmasks = {}
    for valid in VALID_ROWS:
        qm = torch.zeros(SLOTS, dtype=torch.bool)
        qm[torch.randperm(SLOTS, generator=g)[:valid]] = True
        qmasks[valid] = qm.to(dev)
    tiny_x = torch.randn(1, 1, generator=g).to(dev)
    tiny_m = torch.ones(1, dtype=torch.bool, device=dev)
    with open(os.path.join(src, "repro_torch", "kernels", "csrc",
                           "quantize.cu")) as f:
        text = f.read()
    quant_names = next(names for names in QUANT_LAUNCHES
                       if all(re.search(rf"\b{n}\s*\(", text)
                              for n in names))
    calls = {"kmeans_pairwise_dist": (lambda: ops.kmeans_pairwise_dist(
                 x, c_init), LAUNCHES["kmeans_pairwise_dist"]),
             "kmeans_lloyd_step": (lambda: ops.kmeans_lloyd_step(
                 x, c_all, lm), LAUNCHES["kmeans_lloyd_step"]),
             "quantize_affine_1x1": (lambda: ops.quantize_affine(
                 tiny_x, tiny_m), quant_names)}
    for valid, qm in qmasks.items():
        calls[f"quantize_affine_{valid}_of_{SLOTS}_valid"] = (
            lambda qm=qm: ops.quantize_affine(qx, qm), quant_names)
    try:
        from repro_torch.kernels.quantize import (launch_quantize_affine,
                                                  plan_for)
    except ImportError:                  # a tree with no quantize plan
        plan_for = None
    if plan_for is not None:
        auto = plan_for(qx)
        plans = {"l2": auto._replace(smem_bytes=0, resident=False)}
        if auto.resident:
            plans["resident"] = auto
        for route, plan in plans.items():
            q = torch.empty(qx.shape, dtype=torch.int8, device=dev)
            scratch = torch.empty(2 + 2 * plan.grid, device=dev)
            for valid, qm in qmasks.items():
                calls[f"quantize_affine_{valid}_of_{SLOTS}_valid_{route}"] = (
                    lambda qm=qm, plan=plan, q=q, scratch=scratch:
                    launch_quantize_affine(qx, qm, q, scratch, plan),
                    quant_names)

    out = {"src": src}
    for name, (fn, names) in calls.items():
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        call_ms = _events_ms(fn, ITERS) / ITERS
        by_launch = kernel_device_ms(fn, names, ITERS, 0)
        out[name] = {"device_ms": sum(by_launch.values()),
                     "device_ms_by_launch": by_launch, "call_ms": call_ms}
    if plan_for is not None:
        out["quantize_plans"] = {route: plan._asdict()
                                 for route, plan in plans.items()}
    spin_ms = kernel_device_ms(lambda: torch.cuda._sleep(SHORT_SPIN),
                               ["spin_kernel"], ITERS)["spin_kernel"]
    out["sm_clock_mhz"] = {
        "short": SHORT_SPIN / spin_ms / 1e3,
        "long": LONG_SPIN / _events_ms(
            lambda: torch.cuda._sleep(LONG_SPIN), 1) / 1e3}
    return out


def local_update_cost() -> dict:
    """LocalUpdate's ms with cuDNN's deterministic algorithms off and on,
    in turns, in this checkout."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np
    import torch

    from repro_torch.configs import FLConfig, get_wrn_config
    from repro_torch.core import fedavg as fa
    from repro_torch.core.rounds import GeneratorDraws, local_batches
    from repro_torch.core.split import make_split_wrn
    from repro_torch.data import SyntheticImageDataset, partition_k_shards
    from repro_torch.device import resolve_device
    from repro_torch.obs.timing import monotonic
    dev = resolve_device("cuda")
    cfg = get_wrn_config()
    model = make_split_wrn(cfg)
    train = SyntheticImageDataset(50_000, image_size=cfg.image_size, seed=0)
    cl = partition_k_shards(train, num_clients=4, k_classes=2,
                            samples_per_client=2_500)[0]
    fl = FLConfig(num_clients=4, clients_per_round=4)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, dev)
    xs = torch.as_tensor(cl.data.x, device=dev)
    ys = torch.as_tensor(cl.data.y, device=dev)
    draws = GeneratorDraws(gen).client(0, cl, cfg.num_classes, 1)
    bx, by = local_batches(xs, ys, draws.local_perms, fl)

    def run(deterministic):
        torch.backends.cudnn.deterministic = deterministic
        torch.cuda.synchronize()
        t = monotonic()
        new = fa.local_update(params, fl.local_lr, bx, by, model.loss)
        torch.cuda.synchronize()
        return (monotonic() - t) * 1e3, new[0]

    run(False)                           # warm-up of both algorithm sets
    run(True)
    out = {"off_ms": [], "on_ms": []}
    bits = []
    for deterministic in (False, True, True, False) * LU_ROUNDS:
        ms, new = run(deterministic)
        out["on_ms" if deterministic else "off_ms"].append(ms)
        if deterministic:
            bits.append({k: v.cpu().numpy().tobytes()
                         for k, v in new.items()})
    out["on_bit_identical"] = all(b == bits[0] for b in bits)
    out["median_off_ms"] = float(np.median(out["off_ms"]))
    out["median_on_ms"] = float(np.median(out["on_ms"]))
    torch.backends.cudnn.deterministic = True
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append",
                    help="a src directory holding repro_torch (repeatable)")
    ap.add_argument("--local-update", action="store_true",
                    help="time LocalUpdate with deterministic cuDNN off/on")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(measure(args.one)))
        return
    if args.local_update:
        print(json.dumps({"local_update": local_update_cost()}), flush=True)
    else:
        for src in args.src or [os.path.join(ROOT, "src")]:
            run = subprocess.run([sys.executable, os.path.abspath(__file__),
                                  "--one", src], capture_output=True,
                                 text=True)
            if run.returncode != 0:
                sys.stderr.write(run.stdout + run.stderr)
                raise SystemExit(f"kernel_device_time: the run on {src} "
                                 f"failed")
            print(run.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
