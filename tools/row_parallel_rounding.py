"""How far a row-parallel product on a model axis of 2 lies from one
rank's, by where it rounds: ``y = a @ w`` with ``a`` (T, K) and ``w``
(K, N) in bf16, K split over two ranks, at the shapes of ``chip_smoke.py``
phase 17 (qwen3-moe-30b-a3b's attention ``wo``, its shared FFN's
``w_down``; jamba's Mamba ``w_out``). Three ways to get ``y``:

* ``one``    one rank's GEMM: f32 accumulation, one rounding to bf16;
* ``bf16``   each rank's partial rounded to bf16, summed in bf16 (three
             roundings);
* ``f32``    each rank's partial kept in f32 (``torch.mm(out_dtype=)``),
             summed in f32, rounded once (``model_axis.row_product``).

Prints one JSON object a shape: each way's relative Frobenius error
against the f64 product and ``bf16`` / ``f32`` against ``one``, the share
of elements whose bits differ from ``one``'s; whether ``torch.mm``'s
``out_dtype`` ran; then the card's name and power limit.

    python3 tools/row_parallel_rounding.py
"""
import json
import subprocess

import torch

SHAPES = {"qwen3-moe attention wo": (4096, 4096, 2048),
          "qwen3-moe FFN w_down": (4096, 6144, 2048),
          "jamba Mamba w_out": (4096, 16384, 8192)}


def rel(got, want):
    got, want = got.double(), want.double()
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is false: this needs a "
                         "GPU")
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, (t, k, n) in SHAPES.items():
        a = torch.randn(t, k, device="cuda", generator=g).bfloat16()
        w = (torch.randn(k, n, device="cuda", generator=g) * 0.02).bfloat16()
        truth = a.double() @ w.double()
        one = a @ w
        h = k // 2
        parts16 = [a[:, :h] @ w[:h], a[:, h:] @ w[h:]]
        two16 = parts16[0] + parts16[1]
        parts32 = [torch.mm(a[:, :h], w[:h], out_dtype=torch.float32),
                   torch.mm(a[:, h:], w[h:], out_dtype=torch.float32)]
        two32 = (parts32[0] + parts32[1]).to(torch.bfloat16)
        print(json.dumps({
            "shape": name, "T_K_N": [t, k, n],
            "vs_f64": {"one": rel(one, truth), "bf16": rel(two16, truth),
                       "f32": rel(two32, truth)},
            "vs_one": {"bf16": rel(two16, one), "f32": rel(two32, one)},
            "bits_differ": {
                "bf16": float((two16 != one).double().mean()),
                "f32": float((two32 != one).double().mean())},
            "mm_out_dtype": str(parts32[0].dtype)}), flush=True)
    a = torch.randn(64, 128, device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    try:
        torch.mm(a, a.t().detach(), out_dtype=torch.float32).sum().backward()
        grad = "ran"
    except Exception as e:  # noqa: BLE001 - report what the build lacks
        grad = f"{type(e).__name__}: {e}"[:200]
    print(json.dumps({"mm_out_dtype_backward": grad,
                      "torch": torch.__version__}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())


if __name__ == "__main__":
    main()
