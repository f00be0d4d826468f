"""Which collectives a gloo process group runs on CUDA tensors, raw and
through DTensor: two gloo processes on one card (NCCL cannot put two
ranks on one card), each op tried on both ranks alike. Prints one JSON
object, {op: "ok", the error's first line, or "the ranks died (exit
codes)"}.

    python3 tools/gloo_cuda_probe.py            # spawns its ranks

The ranks write each op's answer as they go; where an op kills them, a
new pair starts at the next op. The port's tensor-parallel steps
(``models/model_axis.py``) send their collectives through
``core/collectives.py``, which stages gloo's through host memory whatever
this reports; this tells what DTensor's own collectives would do there.
"""
import datetime
import json
import os
import subprocess
import sys
import tempfile

DTYPES = ("bfloat16", "float32")
RAW = ("all_reduce", "all_reduce_max", "all_gather_into_tensor",
       "all_gather", "reduce_scatter_tensor", "all_to_all_single",
       "broadcast")
DTENSOR = ("full_tensor", "redistribute_shard_to_replicate",
           "partial_to_replicate", "col_then_row_matmul")
OPS = ([f"{op}/{dt}" for dt in DTYPES for op in RAW]
       + [f"dtensor/{op}" for op in DTENSOR])


def _op(name, rank, dev):
    """A callable that runs op ``name`` on this rank."""
    import torch
    import torch.distributed as dist
    kind, tag = name.split("/")
    if kind == "dtensor":
        from torch.distributed.device_mesh import DeviceMesh
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)
        mesh = DeviceMesh("cuda", torch.arange(2), mesh_dim_names=("m",))
        a = torch.randn(8, 16, device=dev, generator=torch.Generator(
            device=dev).manual_seed(0))
        return {
            "full_tensor": lambda: DTensor.from_local(
                a, mesh, (Shard(0),)).full_tensor(),
            "redistribute_shard_to_replicate": lambda: DTensor.from_local(
                a, mesh, (Shard(0),)).redistribute(
                    mesh, (Replicate(),)).to_local(),
            "partial_to_replicate": lambda: DTensor.from_local(
                a, mesh, (Partial(),)).redistribute(
                    mesh, (Replicate(),)).to_local(),
            "col_then_row_matmul": lambda: (
                DTensor.from_local(a, mesh, (Replicate(),))
                @ DTensor.from_local(a.T[:, :8].contiguous(), mesh,
                                     (Shard(1),))
                @ DTensor.from_local(a[:8].contiguous(), mesh, (Shard(0),))
            ).full_tensor()}[tag]
    dt = getattr(torch, tag)
    x = torch.full((4, 8), float(rank + 1), dtype=dt, device=dev)
    return {
        "all_reduce": lambda: dist.all_reduce(x),
        "all_reduce_max": lambda: dist.all_reduce(x, op=dist.ReduceOp.MAX),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty((8, 8), dtype=dt, device=dev), x),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(2)], x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty((2, 8), dtype=dt, device=dev), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "broadcast": lambda: dist.broadcast(x, 0)}[kind]


def child(rank: int, init: str, start: int, path: str) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    with open(path, "a") as f:
        for name in OPS[start:]:
            try:
                _op(name, rank, dev)()
                torch.cuda.synchronize()
                got = "ok"
            except Exception as e:   # noqa: BLE001 - the probe's answer
                got = (f"{type(e).__name__}: "
                       f"{(str(e).splitlines() or [''])[0][:200]}")
            f.write(json.dumps([name, got]) + "\n")
            f.flush()
    dist.destroy_process_group()


def main() -> int:
    work = tempfile.mkdtemp(prefix="gloo_probe_")
    answers = [{}, {}]
    start, attempt = 0, 0
    while start < len(OPS):
        attempt += 1
        outs = [os.path.join(work, f"out{attempt}_{r}.jsonl")
                for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", str(r),
             os.path.join(work, f"init{attempt}"), str(start), outs[r]],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            for r in range(2)]
        for p in procs:
            try:
                p.wait(timeout=180)
            except subprocess.TimeoutExpired:
                pass
        for p in procs:
            p.kill()
            p.wait()
        for r, out in enumerate(outs):
            if os.path.exists(out):
                for line in open(out):
                    name, got = json.loads(line)
                    answers[r][name] = got
        done = min(len(a) for a in answers)
        if done < len(OPS):
            died = OPS[done]
            for a in answers:
                a.setdefault(died, "the ranks died (exit codes "
                             f"{[p.returncode for p in procs]})")
            done += 1
        start = done
    print(json.dumps({"gloo_on_cuda": answers[0],
                      "ranks_agree": answers[0] == answers[1]}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--child"]:
        child(int(sys.argv[2]), sys.argv[3], int(sys.argv[4]), sys.argv[5])
    else:
        raise SystemExit(main())
