"""How fast the port's collectives move bytes between gloo processes on one
card, by route: through host memory (gloo, ``core/collectives.py``'s
host-staged pieces) and by device copies between the ranks' mailboxes
(the same-card route, CUDA IPC). Worlds of 2 and 4 processes, every rank
of the world in one group; the world of 4 runs with
``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``, as ``chip_smoke.py``
phases 17 and 18 do, so its mailboxes show that they share under it. For
each size it times, on each route, ``all_gather_cat``,
``reduce_scatter_cat``, ``all_reduce_tensor`` (sum) and ``all_to_all`` of
a card tensor of that many bytes a rank, checks that the two routes give
the same bits (the sums: the same card's against a sum in rank order of
the gathered inputs), and times gloo's own all-gather of host tensors.
Rank 0 prints one JSON object of GB/s (bytes a rank sends a second), the
torch and CUDA versions and the card's name and power limit.

    python3 tools/gloo_throughput.py            # spawns its ranks
"""
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = (1 << 22, 1 << 24, 1 << 27, 1 << 29)
ITERS = 3


def _rate(nbytes, fn):
    """Bytes a second of ``fn`` (each call moving ``nbytes``), the mean of
    ``ITERS`` calls after one, in GB/s."""
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
    from repro_torch.core import collectives as C
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        ranks = C.Ranks.of()
        on_card = C.same_card
        routes = {"gloo": lambda x, r: None, "same_card": on_card}
        gen = torch.Generator(device="cuda").manual_seed(rank)
        out, same = {}, True
        for n in SIZES:
            f32 = torch.randn(n // 4, device="cuda", generator=gen)
            host = torch.zeros(n, dtype=torch.uint8)
            parts = [torch.empty_like(host) for _ in range(world)]
            dist.barrier()
            row = {"gloo_all_gather_host": _rate(n, lambda: dist.all_gather(
                parts, host))}
            got = {}
            for name, route in routes.items():
                C.same_card = route
                ops = {"all_gather_cat": lambda: C.all_gather_cat(f32, ranks,
                                                                  0),
                       "reduce_scatter_cat": lambda: C.reduce_scatter_cat(
                           f32, ranks, 0),
                       "all_reduce_tensor": lambda: C.all_reduce_tensor(
                           f32, ranks),
                       "all_to_all": lambda: C.all_to_all(f32, ranks, 0)}
                for op, fn in ops.items():
                    got[(name, op)] = fn()
                    row[f"{name} {op}"] = _rate(n, fn)
            C.same_card = on_card
            every = got[("same_card", "all_gather_cat")].view(world, -1)
            rank_order = every[0].clone()
            for t in every[1:]:
                rank_order += t
            same &= all(torch.equal(got[("gloo", op)], got[("same_card", op)])
                        for op in ("all_gather_cat", "reduce_scatter_cat",
                                   "all_to_all"))
            same &= torch.equal(got[("same_card", "all_reduce_tensor")],
                                rank_order)
            same &= torch.equal(got[("same_card", "reduce_scatter_cat")],
                                rank_order.chunk(world)[rank])
            out[f"{n >> 20} MiB"] = row
            del got, every, rank_order
            dist.barrier()
        if rank == 0:
            print(json.dumps({"world": world, "GB_per_s": out,
                              "routes_same_bits": bool(same),
                              "alloc_conf": os.environ.get(
                                  "PYTORCH_CUDA_ALLOC_CONF", ""),
                              "mailbox_routes": {
                                  str(k[1]): v is not None
                                  for k, v in C._MAILBOXES.items()}}),
                  flush=True)
        if not same:
            sys.exit(3)
        C.close_mailboxes()
    finally:
        dist.destroy_process_group()


def _world(world, env):
    init = os.path.join(tempfile.mkdtemp(), "init")
    env = {**os.environ, "GLOO_SOCKET_IFNAME": "lo", **env}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", str(r),
         str(world), init], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = [p.communicate(timeout=900)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(f"world {world} rank {r} exited {p.returncode}:\n"
                  f"{log[-3000:]}")
            sys.exit(1)
    return [ln for ln in logs[0].splitlines() if ln.startswith("{")][-1]


def main():
    import torch
    print(json.dumps({"torch": torch.__version__,
                      "cuda": torch.version.cuda}))
    print(_world(2, {}))
    print(_world(4, {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        main()
