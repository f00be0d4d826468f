"""How far the port's own one-rank f32 prefill lies from its f64 values,
on the reduced configs the CPU model-axis tests run: the largest
|f32 - f64| / (atol + rtol |f64|) over the last-position logits, at
the tests' rtol 1e-5 / atol 1e-6 (above 1: that level is below f32's own
rounding of the step, so the tests hold the ranked steps to the
one-rank steps at that level in f64). Random weights from a seed; the
CPU only.

    PYTHONPATH=src python tools/f32_noise_floor.py

Prints one JSON object, {arch: the ratio}.
"""
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.launch.steps import make_prefill_step
from repro_torch.optim.optimizers import tree_map

ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b", "deepseek-v2-236b",
         "jamba-1.5-large-398b", "rwkv6-3b")
B, S, RTOL, ATOL = 2, 24, 1e-5, 1e-6


def main():
    torch.set_num_threads(1)
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch).reduced()
        tokens = torch.from_numpy(np.random.default_rng(i).integers(
            0, cfg.vocab_size, (B, S)).astype(np.int32))
        logits = {}
        for dtype in (torch.float32, torch.float64):
            step, lm = make_prefill_step(cfg, dtype=dtype)
            params = tree_map(lambda x: x.to(dtype), lm.init(
                torch.Generator().manual_seed(i), device="cpu"))
            logits[dtype] = step(params, {"tokens": tokens}).double()
        want = logits[torch.float64]
        out[arch] = float(((logits[torch.float32] - want).abs()
                           / (ATOL + RTOL * want.abs())).max())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
