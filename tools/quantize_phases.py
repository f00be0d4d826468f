#!/usr/bin/env python3
"""Where the int8 quantize kernel's time goes, phase by phase, on the card.

    python3 tools/quantize_phases.py

Needs one CUDA card and ``nvcc``. It copies
``src/repro_torch/kernels/csrc/quantize.cu`` into
``build/quantize_phases/`` with a ``%globaltimer`` stamp (behind a
``__syncthreads``) at each step boundary of ``quantize_affine_kernel``,
builds it twice (as is, and with the grid barrier taken out, which
leaves a race on the partials and shows what the barrier costs end to
end), and runs it on
the resident route at the main path's (100, 16384) slot payload with 20
and with 80 of the 100 rows valid, and on a (1, 1) payload. For each it
prints the kernel's device time (``torch.profiler``, by name, per launch),
whether the codes and params equal the plain version's, and the median
and largest time over the blocks of each phase of one launch:

  count   the first read of the row mask and the count of valid rows
  spans   each block's spans of the valid and the masked elements
  walk    the masked rows' fill, the valid span's loads and its (min, max)
  reduce  the block's (min, max) partial, written out
  barrier cooperative_groups this_grid().sync()
  params  the partials read back and reduced, (xmin, scale)
  codes   the second walk: codes of the valid span from shared memory

and ``release``: from the last block's arrival at the barrier to the first
block's leaving it. The stamps add a ``__syncthreads`` each, so phase
times are close to, not equal to, the kernel's own. It prints the card's
name and power limit last.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
OUT = os.path.join(ROOT, "build", "quantize_phases")
PHASES = ("count", "spans", "walk", "reduce", "barrier", "params", "codes")
STAMP = ('__device__ unsigned long long g_stamps[8192 * 8];\n'
         '#define STAMP(i) do { __syncthreads(); if (threadIdx.x == 0) { '
         'unsigned long long t_; asm volatile("mov.u64 %0, %%globaltimer;" '
         ': "=l"(t_)); g_stamps[blockIdx.x * 8 + (i)] = t_; } } while (0)')
READ = ('extern "C" int qp_stamps(unsigned long long* out, int n) {\n'
        '  return (int)cudaMemcpyFromSymbol(out, g_stamps,\n'
        '                                   n * sizeof(unsigned long long));\n'
        '}\n')


def instrument(src: str, barrier: bool) -> str:
    """The kernel source with STAMP(0..7) at its step boundaries."""
    lines = src.split("\n")

    def at(prefix, start=0):
        return next(i for i in range(start, len(lines))
                    if lines[i].startswith(prefix))

    k = at("quantize_affine_kernel(")
    marks = [(at("  __shared__ Scratch sh;", k) + 1, 0),
             (at("  // this block's spans", k), 1),
             (at("  // 1. the masked rows", k), 2),
             (at("  warp_minmax(mn, mx);", k), 3),
             (at("  cg::this_grid().sync();", k), 4),
             (at("  cg::this_grid().sync();", k) + 1, 5),
             (at("  // 4. the codes", k), 6),
             (at("}", at("  // 4. the codes", k)), 7)]
    for line, i in sorted(marks, reverse=True):
        lines.insert(line, f"  STAMP({i});")
    lines.insert(at("namespace {"), STAMP)
    out = "\n".join(lines) + "\n" + READ
    if not barrier:
        out = out.replace("  cg::this_grid().sync();", "")
    return out


def main() -> None:
    import numpy as np
    import torch

    from repro_torch.kernels import build, ref
    from repro_torch.kernels.quantize import plan_for
    from repro_torch.obs.device_time import kernel_device_ms
    if not torch.cuda.is_available():
        raise SystemExit("quantize_phases: needs a CUDA device")
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(build.CSRC, "quantize.cu")) as f:
        src = f.read()
    libs, procs = {}, []
    for name, barrier in (("barrier", True), ("no_barrier", False)):
        cu = os.path.join(OUT, f"quantize_{name}.cu")
        with open(cu, "w") as f:
            f.write(instrument(src, barrier))
        so = os.path.join(OUT, f"libquantize_{name}.so")
        procs.append((name, so, subprocess.Popen(
            [build._nvcc(), *build._flags("quantize"), "-o", so, cu])))
    for name, so, proc in procs:
        if proc.wait() != 0:
            raise SystemExit(f"quantize_phases: nvcc failed on {name}")
        lib = ctypes.CDLL(so)
        for fn, (args, res) in build.SIGNATURES["quantize"].items():
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = args, res
        lib.qp_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        libs[name] = lib
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    x = torch.randn(100, 16384, generator=g).to(dev)
    cases = {}
    for valid in (20, 80):
        m = torch.zeros(100, dtype=torch.bool)
        m[torch.randperm(100, generator=g)[:valid]] = True
        cases[f"{valid}_of_100_valid"] = (x, m.to(dev))
    cases["1x1"] = (torch.randn(1, 1, device=dev),
                    torch.ones(1, dtype=torch.bool, device=dev))
    stream = torch.cuda.current_stream().cuda_stream
    for name, lib in libs.items():
        for case, (xx, mm) in cases.items():
            n, d = xx.shape
            plan = plan_for(xx)
            q = torch.empty(n, d, dtype=torch.int8, device=dev)
            scratch = torch.empty(2 + 2 * plan.grid, device=dev)

            def call():
                err = lib.repro_quantize_affine(
                    xx.data_ptr(), mm.data_ptr(), q.data_ptr(),
                    scratch.data_ptr(), n, d, plan.grid, plan.smem_bytes,
                    int(plan.resident), stream)
                build.check_launch(lib, err, "quantize_phases")

            try:
                ms = kernel_device_ms(call, ["quantize_affine_kernel"], 100,
                                      5)["quantize_affine_kernel"]
            except RuntimeError as err:   # the profiler dropped the events
                ms = f"not measured: {err}"
            call()
            torch.cuda.synchronize()
            stamps = np.zeros(8192 * 8, np.uint64)
            lib.qp_stamps(stamps.ctypes.data, stamps.size)
            t = stamps[:plan.grid * 8].reshape(plan.grid, 8).astype(np.int64)
            dt = np.diff(t, axis=1) / 1e3
            wq, wxmin, wscale = ref.quantize_affine_ref(xx, mm)
            exact = (torch.equal(q, wq) and float(scratch[0]) == float(wxmin)
                     and float(scratch[1]) == float(wscale))
            print(json.dumps({
                "build": name, "case": case, "plan": plan._asdict(),
                "device_ms": ms, "exact": exact,
                "phase_median_us": dict(zip(PHASES, np.median(dt, 0)
                                            .tolist())),
                "phase_max_us": dict(zip(PHASES, dt.max(0).tolist())),
                "release_us": float(t[:, 5].min() - t[:, 4].max()) / 1e3,
                "stamped_span_us": float(t[:, 7].max() - t[:, 0].min())
                / 1e3}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
