"""Batched decode serving: the port of ``repro.launch.serve``. Feeds a
batch of random prompts through decode steps (teacher-forced, as the
reference does), then decodes greedily with the ring-buffer KV cache.
``--smoke`` runs the reduced config; there is no mesh.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b --smoke --tokens 16 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-1.5-large-398b --layers 4 --batch 128 --cache-len 32768

``--layers N`` cuts the depth to N layers (and a block pattern longer
than N to its first N kinds), for a model whose weights do not fit one
card at full depth (jamba's 72 layers are 797 GB of bf16; its first 4,
mamba x 3 and attention with the MoE on layers 1 and 3, are 46 GB).

Runs on the CUDA device unless ``--device cpu`` is given (and fails if
there is none). The weights are random (seed 0), drawn in f32 and made
bf16 one layer slice at a time (``LM.init(dtype=torch.bfloat16)``: the
f32 tree is never held, so qwen3-moe-30b-a3b's 61 GB of bf16 weights fit
one 80 GB card at full width); the steps compute in bf16 as the
reference's do. On a card the last line before ``serve: done`` gives the
peak device memory of the run. An RWKV model's decode state has a fixed
size: ``--cache-len`` changes nothing for it, as in the reference (nor
for jamba's Mamba layers). Whisper's decoder cross-attends over the
cache's ``enc_out``, zeros as in the reference's serve.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step
from repro_torch.obs.timing import monotonic, sync


@dataclass
class ServeResult:
    """What one run did: the times on the host clock (each ends in a
    device synchronize), the generated token ids (batch, tokens) and, on
    a card, the peak device memory in bytes (None on the CPU)."""
    prompt_s: float
    decode_s: float
    tokens: np.ndarray
    peak_bytes: Optional[int] = None

    @property
    def tok_per_s(self) -> float:
        return self.tokens.size / max(self.decode_s, 1e-9)


def cut_depth(cfg, layers: int):
    """``cfg`` with ``layers`` layers: the block pattern cut to its first
    ``layers`` kinds where it is longer (every kind of jamba's 8-layer
    unit is in its first 4)."""
    pattern = cfg.block_pattern
    if len(pattern) > layers:
        pattern = pattern[:layers]
    return dataclasses.replace(cfg, num_layers=layers, block_pattern=pattern)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers)

    decode_fn, lm = make_decode_step(cfg)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    # the steps compute in bf16: the weights are made in bf16 (the bits of
    # the f32 draws cast), one layer slice at a time
    params = lm.init(gen, dtype=torch.bfloat16)
    # (an encoder-decoder's cache holds enc_out: zeros, the reference's)
    cache = lm.init_cache(args.batch, args.cache_len, device=dev)

    rng = np.random.default_rng(0)
    # "prefill" by teacher-forcing the prompt through decode steps (as the
    # reference; a production server uses the prefill step)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), np.int32)).to(dev)
    t0 = monotonic()
    tok = prompt[:, :1]
    for i in range(1, args.prompt_len):
        _, cache = decode_fn(params, cache, tok)
        tok = prompt[:, i:i + 1]
    sync(cache)
    t_prefill = monotonic() - t0

    out = []
    t0 = monotonic()
    for _ in range(args.tokens):
        tok, cache = decode_fn(params, cache, tok)
        out.append(tok[:, 0].cpu().numpy())
    dt = monotonic() - t0
    out = np.stack(out, 1) if out else np.zeros((args.batch, 0), np.int32)
    print(f"prompt fed in {t_prefill:.2f}s; generated {args.tokens} tokens x "
          f"batch {args.batch} in {dt:.2f}s "
          f"({args.tokens*args.batch/max(dt,1e-9):.1f} tok/s)")
    print("sample token ids:", out[0][:16].tolist())
    peak = None
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        print(f"peak device memory: {peak} B")
    print("serve: done")
    return ServeResult(prompt_s=t_prefill, decode_s=dt, tokens=out,
                       peak_bytes=peak)


if __name__ == "__main__":
    main()
