"""Batched-request serving example: the port's twin of
``examples/serve_lm.py``. The reduced config of ``--arch`` in f32 decodes
greedily from one random token per request with a ring-buffer KV cache
(sliding-window layers hold O(window) state; MLA's ring holds the latent;
RWKV holds a constant-size recurrent state, whatever ``--cache-len``
says); the first step is a warm-up outside the timed loop.

  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch gemma3-4b --tokens 24 [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch deepseek-v2-236b [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch rwkv6-3b [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch jamba-1.5-large-398b [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch whisper-medium [--device cpu]

Runs on the CUDA device unless ``--device cpu`` is given (and fails if
there is none). Jamba's Mamba layers hold a constant-size state;
whisper's decoder cross-attends over the cache's ``enc_out``, zeros as in
the reference (no encoder pass); internvl2 decodes text only (its vision
prefix enters in a prefill).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_decode_step
from repro_torch.obs.timing import monotonic


def main(argv=None) -> np.ndarray:
    """Runs the example; returns the generated ids, (batch, tokens)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()     # refuses what is not ported
    decode_fn, lm = make_decode_step(cfg, dtype=torch.float32)
    params = lm.init(torch.Generator(device=dev).manual_seed(0))
    cache = lm.init_cache(args.batch, args.cache_len, dtype=torch.float32,
                          device=dev)

    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (args.batch, 1)).astype(np.int32)).to(dev)
    # warm up (the reference's compile step)
    tok, cache = decode_fn(params, cache, tok)
    t0 = monotonic()
    out = [tok[:, 0].cpu().numpy()]
    for _ in range(args.tokens - 1):
        tok, cache = decode_fn(params, cache, tok)
        out.append(tok[:, 0].cpu().numpy())
    dt = monotonic() - t0
    gen = np.stack(out, 1)
    print(f"arch={cfg.name} (reduced) batch={args.batch} "
          f"cache={args.cache_len}")
    print(f"{args.tokens} tokens x {args.batch} reqs in {dt:.2f}s "
          f"({args.tokens * args.batch / max(dt, 1e-9):.1f} tok/s on {dev})")
    for b in range(min(args.batch, 2)):
        print(f"req{b}: {gen[b][:16].tolist()}")
    return gen


if __name__ == "__main__":
    main()
