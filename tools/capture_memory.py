#!/usr/bin/env python3
"""Device memory that the captured LocalUpdate leaves behind on the card.

    python3 tools/capture_memory.py

Needs one CUDA card. At the small WRN-10-1 (16x16 inputs, one client of
100 samples, batch 20), it prints one JSON line of
``torch.cuda.memory_allocated()`` in bytes, read after a synchronize:

* ``start``: before anything ran;
* ``one_off_<i>``: after each of three ``fedavg.client_update`` calls with
  no owner (each captures a graph for the call and frees it on return);
* ``owned``: after three calls through one ``fedavg.CapturedSteps``
  (``owned_graphs``: how many graphs it holds), and ``released`` after
  its ``release``;
* ``new_stream_<i>``: after a matmul on each of three fresh streams —
  what a capture that warmed up on a side stream of its own would leave,
  since cuBLAS keeps a workspace for every stream it has run on.

Then the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def main() -> None:
    import torch
    from repro_torch.configs import FLConfig, get_wrn_config
    from repro_torch.core import fedavg as fa
    from repro_torch.core.rounds import local_order
    from repro_torch.core.split import make_split_wrn
    from repro_torch.data import SyntheticImageDataset, partition_k_shards
    from repro_torch.device import resolve_device

    dev = resolve_device("cuda")

    def allocated():
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated()

    wcfg = get_wrn_config().reduced()
    model = make_split_wrn(wcfg)
    ds = SyntheticImageDataset(400, image_size=wcfg.image_size, seed=1)
    client = partition_k_shards(ds, num_clients=4, k_classes=2,
                                samples_per_client=100, seed=3)[0]
    fl = FLConfig(local_batch_size=20)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, dev)
    x = torch.as_tensor(client.data.x, device=dev)
    y = torch.as_tensor(client.data.y, device=dev)
    order = local_order(x.shape[0], torch.randperm(
        x.shape[0], generator=gen)[None], fl).to(dev)
    out = {"start": allocated()}
    for i in range(3):
        fa.client_update(params, fl.local_lr, x, y, order, model.loss)
        out[f"one_off_{i}"] = allocated()
    steps = fa.CapturedSteps()
    for _ in range(3):
        fa.client_update(params, fl.local_lr, x, y, order, model.loss, steps)
    out["owned"], out["owned_graphs"] = allocated(), len(steps)
    steps.release()
    out["released"] = allocated()
    a = torch.randn(256, 256, device=dev)
    for i in range(3):
        with torch.cuda.stream(torch.cuda.Stream(dev)):
            (a @ a).sum().item()
        out[f"new_stream_{i}"] = allocated()
    print(json.dumps(out))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
