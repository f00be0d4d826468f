"""How long reading a ``torch.profiler`` profile takes, two ways, and
whether they agree: ``key_averages()`` (a Python object for every host
and device event, and their tree) against ``chip_smoke.DeviceTotals``
(the same sums read from the profiler's raw events). It profiles the
port's MoE layer (reduced qwen3-moe-30b-a3b, 1,024 tokens, its ``moe.*``
ranges) four times, then a run of small element-wise kernels, at two
sizes; for each it prints the events, both readings' seconds, the busy
device ms both ways and the ranges' device ms both ways, and at the end
SAME if every kernel's launches and device time and every range's calls
and device time agree to 1e-3 relative (else BAD and the differences),
and the card's name and power limit.

    python3 tools/profile_reading.py            # needs a CUDA device
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

SMALL_KERNELS = (200, 20000)


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L

    dev = torch.device("cuda")
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    g = torch.Generator(device=dev).manual_seed(0)
    p = L.moe_init(L.ParamInit(g, dev), cfg)
    p["norm"] = torch.ones(cfg.d_model, device=dev)
    x = torch.randn(1, 1024, cfg.d_model, generator=g, device=dev)

    def work(n_small):
        for _ in range(4):
            L.moe_apply(p, x, cfg=cfg)
        a = torch.randn(256, 256, device=dev)
        for _ in range(n_small):
            a = a * 1.0001 + 0.5
        torch.cuda.synchronize()

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    bad = []
    for n_small in SMALL_KERNELS:
        work(10)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work(n_small)
        t0 = time.monotonic()
        totals = cs.DeviceTotals(prof)
        t_raw = time.monotonic() - t0
        t0 = time.monotonic()
        avgs = prof.key_averages()
        t_avg = time.monotonic() - t0
        old = {e.key: (e.count, e.self_device_time_total) for e in avgs
               if e.device_type == cuda and not e.key.startswith("moe.")}
        old_ranges = {e.key: (e.count, e.device_time_total) for e in avgs
                      if e.key.startswith("moe.") and e.device_type == cpu}
        print(f"{n_small} small kernels: "
              f"{len(prof.profiler.kineto_results.events())} events; "
              f"raw events {t_raw:.3f} s, key_averages {t_avg:.3f} s; busy "
              f"ms {sum(us for _, us in old.values()) / 1e3} / "
              f"{totals.busy_ms()}; ranges {old_ranges} / {totals.ranges}")
        if set(old) != set(totals.by_name):
            bad.append(f"names differ: {sorted(set(old) ^ set(totals.by_name))[:5]}")
        pairs = [(k, v, totals.by_name.get(k)) for k, v in old.items()] + [
            (k, v, totals.ranges.get(k)) for k, v in old_ranges.items()]
        for k, (c, us), new in pairs:
            if new is None or c != new[0] or abs(us - new[1]) > 1e-3 * max(us, 1):
                bad.append(f"{k}: key_averages {(c, us)}, raw {new}")
    print("BAD" if bad else "SAME", bad[:10])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
