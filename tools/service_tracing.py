#!/usr/bin/env python3
"""What tracing costs the async service on the card, in runs taken in turns.

    python3 tools/service_tracing.py [--pairs 4]

Needs one CUDA card. At ``chip_smoke.py`` phase 4's full width (WRN-40-1
split after group 1, 4 clients x 2,500 samples of 2 classes, ``FLConfig``
defaults, the int8 codec, seed 0) it runs the degenerate ``FLService``
(``DegenerateTraffic``, a buffer of 4) for 2 ticks, once untraced to warm
up, then ``--pairs`` pairs in turns (off, on, on, off, ...), each run a
fresh service with ``observability`` off or on. Every traced run must give
the untraced run's weights and ledger bit for bit. It prints one JSON line:
each run's wall and tick walls by setting, the medians, the traced median
over the untraced one, and, from the last traced run, the spans it
recorded and the mean and least duration of each ``kernel.*`` span; then
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pairs", type=int, default=4)
    args = ap.parse_args(argv)

    import dataclasses

    from repro_torch.configs import FLConfig, get_wrn_config
    from repro_torch.core.split import make_split_wrn
    from repro_torch.data import SyntheticImageDataset, partition_k_shards
    from repro_torch.device import resolve_device
    from repro_torch.fl.service import DegenerateTraffic, FLService
    from repro_torch.obs.timing import monotonic

    resolve_device("cuda")
    wcfg = get_wrn_config()
    model = make_split_wrn(wcfg)
    train = SyntheticImageDataset(50_000, image_size=wcfg.image_size, seed=0)
    test = SyntheticImageDataset(2_000, image_size=wcfg.image_size, seed=1)
    clients = partition_k_shards(train, num_clients=4, k_classes=2,
                                 samples_per_client=2_500)
    cfg = FLConfig(num_clients=4, clients_per_round=4, transport_codec="int8")

    def run(observability):
        svc = FLService(model, clients, test,
                        dataclasses.replace(cfg, observability=observability),
                        seed=0, traffic=DegenerateTraffic(), buffer_size=4)
        t0 = monotonic()
        res = svc.run(ticks=2)
        wall = monotonic() - t0
        bits = ({k: v.cpu().numpy().tobytes()
                 for k, v in svc.server.global_params.items()}, res.comm)
        return wall, res.tick_wall_s, bits, svc.tracer

    _, _, want, _ = run(False)
    walls = {"off": [], "on": []}
    ticks = {"off": [], "on": []}
    tracer = None
    order = []
    for _ in range(args.pairs):
        order += ["off", "on"] if len(order) % 4 == 0 else ["on", "off"]
    for setting in order:
        wall, tick, bits, tr = run(setting == "on")
        if bits != want:
            print(f"service_tracing: a {setting} run's weights or ledger "
                  f"differ from the untraced warm-up run's", file=sys.stderr)
            return 1
        walls[setting].append(wall)
        ticks[setting].append(tick)
        if tr.enabled:
            tracer = tr
    kernel = {}
    for sp in tracer.spans:
        if sp.name.startswith("kernel."):
            kernel.setdefault(sp.name, []).append(sp.duration * 1e3)
    med = {k: statistics.median(v) for k, v in walls.items()}
    print(json.dumps({
        "order": order, "wall_s": walls, "tick_wall_s": ticks,
        "median_wall_s": med, "traced_over_untraced": med["on"] / med["off"],
        "spans_per_traced_run": len(tracer.spans),
        "kernel_span_ms": {k: {"spans": len(v), "mean": statistics.mean(v),
                               "min": min(v)} for k, v in kernel.items()}}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
