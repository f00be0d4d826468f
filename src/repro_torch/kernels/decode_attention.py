"""Launcher of the flash-decode CUDA kernel (``csrc/decode_attention.cu``).

The port's counterpart of ``repro.kernels.decode_attention.
flash_decode_kernel``: one query token (B,1,H,D) against ring-buffer
caches (B,S,KV,D) under a (B,S) validity mask. The caches are read in
their own dtype (f32 or bf16) and converted to q's in registers.

S is split across blocks by ``plan_splits``, a pure function of the
shapes and the card's SM count (so the CPU tests can hold it): each split
is a contiguous run of whole block tiles, and a second launch merges the
splits in order (none with one split). With ``lse`` the output is f32 and
each (b, head)'s log-sum-exp of its scaled scores is written beside it:
what a caller holding one part of a ring's slots needs to merge its
output with the other parts' (``models/layers.py`` ``merge_decode``).

Takes CUDA tensors that ``kernels/ops.py`` has already checked and
allocated; launches on PyTorch's current stream and does not synchronize.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.device import sm_count
from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_G = 8                  # query heads per kv head the kernel's registers hold
# the kernel's tiling (csrc/decode_attention.cu): NW warps a block, each
# NPASS passes of 256 / DMAX slots a tile
NW, NPASS = 4, 4
RESIDENT_BLOCKS = 4        # blocks an SM holds (48 KB of bf16 ring each)
WAVES = 2                  # the plan aims at two full waves at least


def tile_slots(d: int) -> int:
    """Slots of one block tile, the unit a split is made of (DMAX is D
    rounded up to 64, 128 or 256)."""
    dmax = next(m for m in (64, 128, 256) if d <= m)
    return NW * NPASS * (256 // dmax)


def plan_splits(s: int, bkv: int, sm_count: int, d: int) -> Tuple[int, int]:
    """(splits, slots per split) for S slots over B*KV (b, kv head) rows.

    Enough blocks for ``WAVES`` full waves of ``RESIDENT_BLOCKS`` per SM,
    never more splits than block tiles of S, every split a whole number of
    tiles and none empty: split z covers [z*per, min(S, (z+1)*per))."""
    if s < 1 or bkv < 1 or sm_count < 1:
        raise ValueError(f"plan_splits: S={s}, B*KV={bkv}, SMs={sm_count}")
    t = tile_slots(d)
    tiles = -(-s // t)
    want = -(-WAVES * RESIDENT_BLOCKS * sm_count // bkv)
    per_tiles = max(1, tiles // want)      # rounds the split count up
    return -(-tiles // per_tiles), per_tiles * t


def plan_for(q: torch.Tensor, k_cache: torch.Tensor) -> Tuple[int, int]:
    """``plan_splits`` of these tensors on their card."""
    b, _, _, d = q.shape
    return plan_splits(k_cache.shape[1], b * k_cache.shape[2],
                       sm_count(q.device.index or 0), d)


def launch_flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, valid: torch.Tensor,
                        out: torch.Tensor,
                        lse: Optional[torch.Tensor] = None) -> int:
    """out (B,1,H,D) = attention of q over the valid cache slots, in q's
    dtype; with ``lse`` (B,H) f32, ``out`` f32 and the statistics written
    to ``lse``. Returns the number of splits it ran."""
    lib = build.library("decode_attention")
    b, _, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    splits, per = plan_for(q, k_cache)
    ml = acc = None
    if splits > 1:                       # the splits' (m, l) and acc
        rows = b * kv * splits * (h // kv)
        scratch = torch.empty(rows * (2 + d), dtype=torch.float32,
                              device=q.device)
        ml, acc = scratch[:2 * rows], scratch[2 * rows:]
    with torch.cuda.device(q.device):
        err = lib.repro_flash_decode(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if ml is None else ml.data_ptr(),
            None if acc is None else acc.data_ptr(), DTYPES[q.dtype],
            DTYPES[k_cache.dtype], b, s, h, kv, d, splits, per,
            1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
    build.check_launch(lib, err, "flash_decode")
    return splits
