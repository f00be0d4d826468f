#!/usr/bin/env python3
"""Device time of the port's attention backward at one training layer's
shape, beside SDPA's backward.

    python3 tools/attention_bwd_time.py

Needs one CUDA card. Builds this checkout's kernels and, at llama3.2-1b's
attention shape in ``chip_smoke.py`` phase 9a (B = 4, S = 4,096, H = 32,
KV = 8, D = 64, causal), for bf16 and for f32:

* ``bwd_device_ms``: each of the backward's three launches (``Dd``,
  dK/dV, dQ) by kernel name, its own device time per call
  (``repro_torch.obs.device_time.kernel_device_ms`` over ``ITERS`` calls
  of ``ops.flash_attention_bwd``);
* ``fwd_device_ms``: the prefill kernel with its statistics, the same
  way;
* ``sdpa_bwd_ms``: one backward of ``scaled_dot_product_attention``
  (causal, GQA) on the same inputs, CUDA events around ``ITERS`` calls (a
  yardstick: the port never calls it);
* ``max_memory_allocated`` of the run so far.

It prints one JSON line per dtype and then the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
SHAPE = (4, 4096, 32, 8, 64)            # B, S, H, KV, D
ITERS = 10
BWD = ("attn_bwd_dot_kernel", "attn_bwd_dkdv_kernel", "attn_bwd_dq_kernel")


def main() -> int:
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build, ops
    from repro_torch.obs.device_time import kernel_device_ms

    dev = resolve_device("cuda")
    build.load_all()
    b, s, h, kv, d = SHAPE
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        q, k, v, dout = randn(b, s, h, d), randn(b, s, kv, d), \
            randn(b, s, kv, d), randn(b, s, h, d)
        out, lse = ops.flash_attention(q, k, v, return_stats=True)
        bwd = kernel_device_ms(
            lambda: ops.flash_attention_bwd(q, k, v, out, dout, lse), BWD,
            iters=ITERS)
        fwd = kernel_device_ms(
            lambda: ops.flash_attention(q, k, v, return_stats=True),
            ("flash_fwd",), iters=ITERS)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = dout.transpose(1, 2)

        def sdpa_bwd():
            return torch.autograd.grad(o, (qt, kt, vt), dot,
                                       retain_graph=True)

        for _ in range(2):
            sdpa_bwd()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(ITERS):
            sdpa_bwd()
        end.record()
        torch.cuda.synchronize()
        print(json.dumps({
            "dtype": str(dtype).removeprefix("torch."), "shape": SHAPE,
            "bwd_device_ms": bwd, "fwd_device_ms": fwd,
            "sdpa_bwd_ms": start.elapsed_time(end) / ITERS,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}))
        del q, k, v, dout, out, lse, qt, kt, vt, o, dot
        torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
