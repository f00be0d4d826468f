"""How fast the port's host-staged collectives can move bytes between gloo
processes on one card: four processes as a 2 x 2 mesh (the FSDP items of
``chip_smoke.py`` phase 18), each "data" pair all-gathering at once, as
the steps do. For each piece size it times gloo's all-gather of host
tensors (pageable and page-locked), the card's copy to and from a
page-locked buffer, and ``core/collectives.py``'s ``all_gather_cat`` and
``reduce_scatter_cat`` of a card tensor (the staged path the steps take).
Rank 0 prints one JSON object of GB/s (bytes a rank sends, or copies, a
second) and the card's name and power limit.

    python3 tools/gloo_throughput.py            # spawns its four ranks
"""
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PIECES = (1 << 22, 1 << 24, 1 << 27, 1 << 29)
ITERS = 3


def _rate(nbytes, fn):
    """Bytes a second of ``fn`` (each call moving ``nbytes``), the mean of
    ``ITERS`` calls after one."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    torch.cuda.synchronize()
    return nbytes * ITERS / (time.perf_counter() - t0) / 1e9


def child(rank, world, init_file):
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.core.collectives import (Ranks, all_gather_cat,
                                              reduce_scatter_cat)
    from repro_torch.launch.mesh import PRODUCTION_AXES, mesh_over_world
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = mesh_over_world((2, 2), PRODUCTION_AXES, "cuda")
        data = Ranks.of(mesh.get_group("data"))
        out = {}
        for n in PIECES:
            host = torch.zeros(n, dtype=torch.uint8)
            parts = [torch.empty_like(host) for _ in range(data.size)]
            pinned = host.pin_memory()
            pparts = [p.pin_memory() for p in parts]
            card = torch.zeros(n, dtype=torch.uint8, device="cuda")
            f32 = torch.zeros(n // 4 * data.size, device="cuda")
            dist.barrier()
            row = {
                "gloo_all_gather": _rate(n, lambda: dist.all_gather(
                    parts, host, group=data.group)),
                "gloo_all_gather_pinned": _rate(n, lambda: dist.all_gather(
                    pparts, pinned, group=data.group)),
                "card_to_pinned_and_back": _rate(2 * n, lambda: (
                    pinned.copy_(card), card.copy_(pinned))),
                "all_gather_cat": _rate(n, lambda: all_gather_cat(
                    card, data, 0)),
                "reduce_scatter_cat": _rate(n, lambda: reduce_scatter_cat(
                    f32, data, 0))}
            out[f"{n >> 20} MiB"] = row
            dist.barrier()
        if rank == 0:
            print(json.dumps({"GB_per_s": out}), flush=True)
    finally:
        dist.destroy_process_group()


def main():
    init = os.path.join(tempfile.mkdtemp(), "init")
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(r), "4",
         init], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(4)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(f"rank {r} exited {p.returncode}:\n{log[-3000:]}")
            sys.exit(1)
    print(logs[0].strip().splitlines()[-1])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
