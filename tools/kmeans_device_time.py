#!/usr/bin/env python3
"""Device time of the port's two K-means kernels at the main path's shapes.

    python3 tools/kmeans_device_time.py [--src DIR] [--src DIR] ...

Needs one CUDA card. Each ``--src`` names a ``src`` directory that holds a
``repro_torch`` package (default: this checkout's ``src``); the runs go in
the order given, each in its own process, so two trees can be compared on
one card in turns (``--src A --src B --src B --src A``). A run builds that
tree's kernels and measures, at one client's shapes on the main path
(N = 2,500 PCA rows of width 200; K = 10 centres for a farthest-point-init
step; K = 100 label-masked slots for a Lloyd sweep, the rows drawn from 2 of
the 10 classes as a client holds them):

* ``device_ms``: each CUDA launch's own device time per call
  (``repro_torch.obs.device_time.kernel_device_ms``, taken from this
  checkout whichever tree is measured: ``torch.profiler``, summed by
  kernel name over ``ITERS`` calls after a warm-up, divided by the
  launches it saw; a Lloyd sweep is two launches);
* ``call_ms``: the wrapper call's time (CUDA events around ``ITERS``
  back-to-back calls), which also counts the host's work between launches;
* ``sm_clock_mhz``: the SM clock the card ran at, from ``torch.cuda._sleep``
  (a kernel that spins for a given number of cycles): ``short`` from the
  profiler's device time of each of ``ITERS`` spins of about the K-means
  kernels' length, called back to back as these calls are, ``long`` from
  CUDA events around one spin of about a millisecond.

It prints one JSON line per run and then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ITERS, WARMUP = 200, 5
SHORT_SPIN, LONG_SPIN = 20_000, 2_000_000        # cycles
N, P, K_INIT, CLASSES, PER_CLASS = 2500, 200, 10, 10, 10
LAUNCHES = {"kmeans_pairwise_dist": ("pairwise_dist_kernel",),
            "kmeans_lloyd_step": ("lloyd_assign_kernel",
                                  "lloyd_sums_kernel")}
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


def measure(src: str) -> dict:
    """One run against the ``repro_torch`` under ``src``."""
    sys.path.insert(0, os.path.abspath(src))
    import torch

    from repro_torch.kernels import build, ops
    kernel_device_ms = _kernel_device_ms()
    if not torch.cuda.is_available():
        raise SystemExit("kmeans_device_time: needs a CUDA device")
    build.load_all()
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(N, P, generator=g).to(dev)
    c_init = torch.randn(K_INIT, P, generator=g).to(dev)
    c_all = torch.randn(CLASSES * PER_CLASS, P, generator=g).to(dev)
    labels = torch.tensor([3, 7])[torch.randint(2, (N,), generator=g)]
    slot = torch.arange(CLASSES * PER_CLASS) // PER_CLASS
    lm = torch.where(labels[:, None] == slot[None], 0.0, 1e30).float().to(dev)
    calls = {"kmeans_pairwise_dist": lambda: ops.kmeans_pairwise_dist(
                 x, c_init),
             "kmeans_lloyd_step": lambda: ops.kmeans_lloyd_step(x, c_all,
                                                                lm)}

    def events_ms(fn, iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    out = {"src": src}
    for name, fn in calls.items():
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        call_ms = events_ms(fn, ITERS) / ITERS
        by_launch = kernel_device_ms(fn, LAUNCHES[name], ITERS, 0)
        out[name] = {"device_ms": sum(by_launch.values()),
                     "device_ms_by_launch": by_launch, "call_ms": call_ms}
    spin_ms = kernel_device_ms(lambda: torch.cuda._sleep(SHORT_SPIN),
                               ["spin_kernel"], ITERS)["spin_kernel"]
    out["sm_clock_mhz"] = {
        "short": SHORT_SPIN / spin_ms / 1e3,
        "long": LONG_SPIN / events_ms(
            lambda: torch.cuda._sleep(LONG_SPIN), 1) / 1e3}
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", action="append",
                    help="a src directory holding repro_torch (repeatable)")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(measure(args.one)))
        return
    for src in args.src or [os.path.join(ROOT, "src")]:
        run = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", src], capture_output=True, text=True)
        if run.returncode != 0:
            sys.stderr.write(run.stdout + run.stderr)
            raise SystemExit(f"kmeans_device_time: the run on {src} failed")
        print(run.stdout.strip().splitlines()[-1], flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
