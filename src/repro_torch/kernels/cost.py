"""The work of one launch of each kernel wrapper of ``kernels/ops.py``: the
package's one source of a launch's FLOPs, HBM bytes and transcendentals.

Each function takes the launch's shapes, dtypes and flags and returns a
``KernelCost`` (flops, hbm_bytes, transcendentals). The cost model
(``obs/profile.py``) attaches it to the launch's ``kernel.*`` span, the dry
run (``launch/dryrun.py``) charges it where a wrapper meets a ``meta``
tensor, and ``chip_smoke.py`` divides it by the card's peaks for each
kernel row's bound.

The counting rule is the least work of the function: every input read
once, every output written once; the FLOPs of the products and the
element-wise terms the kernel needs. Where the work depends on the data
(rows admissible to a K-means slot, rows valid for the int8 codec) the
caller passes the count its data holds; left out, every row counts.

Attention counts the (query, key) pairs its mask keeps. A causal mask
with no window keeps half of S x Sk in the forward (``2 B S Sk H D``, half
of the two products' ``4 B S Sk H D``) and the S (S + 1) / 2 pairs of the
lower triangle in the backward; a window keeps the pairs within it,
counted exactly. The decode kernel reads every slot of the cache, valid or
not, and so is charged for all S of them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class KernelCost(NamedTuple):
    """One launch's work."""
    flops: float
    hbm_bytes: float
    transcendentals: float


def kmeans_pairwise_dist(n: int, d: int, k: int) -> KernelCost:
    """(N, D), (K, D) f32 -> (N, K) f32 squared distances: the x.c product,
    both squared norms, and three terms an entry."""
    return KernelCost(2 * n * k * d + 2 * (n + k) * d + 3 * n * k,
                      4 * (n * d + k * d + n * k), 0)


def kmeans_lloyd_step(n: int, d: int, k: int,
                      admissible_rows: Optional[int] = None) -> KernelCost:
    """One fused Lloyd sweep over (N, D) rows, (K, D) centres and the
    (N, K) f32 mask: the distances, a masked compare and select an entry,
    and the sums over the ``admissible_rows`` rows that join a slot
    (default N). Out: assign and mindist (N,), sums (K, D), counts (K,)."""
    w = n if admissible_rows is None else admissible_rows
    return KernelCost(2 * n * k * d + 2 * (n + k) * d + 4 * n * k + w * d,
                      4 * (n * d + k * d + n * k + 2 * n + k * d + k), 0)


def quantize_affine(n: int, d: int,
                    valid_rows: Optional[int] = None) -> KernelCost:
    """Per-tensor affine int8 of (N, D) f32 over ``valid_rows`` rows
    (default N): the valid rows read, the (N,) bool mask read, every int8
    code and the (xmin, scale) pair written; seven operations a valid
    element (min, max, subtract, multiply, round, clip, offset)."""
    v = n if valid_rows is None else valid_rows
    return KernelCost(7 * v * d, 4 * v * d + n + n * d + 8, 0)


def quantize_affine_batched(b: int, n: int, d: int,
                            valid_rows: Optional[int] = None) -> KernelCost:
    """``quantize_affine`` of B clients of (N, D) in one launch;
    ``valid_rows`` is the valid rows of all B clients together (default
    B x N)."""
    v = b * n if valid_rows is None else valid_rows
    return KernelCost(7 * v * d, 4 * v * d + b * n + b * n * d + 8 * b, 0)


def _window_pairs(s: int, sk: int, causal: bool, window: int) -> int:
    """Exactly the (qi, ki) pairs of an S x Sk grid that the mask keeps:
    ki <= qi where causal, qi - ki < window where window > 0."""
    qi = np.arange(s, dtype=np.int64)
    hi = np.minimum(qi, sk - 1) if causal else np.full(s, sk - 1)
    lo = np.maximum(qi - window + 1, 0) if window > 0 else np.zeros(s)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _pairs(s: int, sk: int, causal: bool, window: int, triangle) -> float:
    if window > 0:
        return _window_pairs(s, sk, causal, window)
    if causal:
        return triangle
    return s * sk


def flash_attention(b: int, s: int, h: int, kv: int, d: int, *,
                    sk: Optional[int] = None, dtype=torch.bfloat16,
                    causal: bool = True, window: int = 0,
                    return_stats: bool = False) -> KernelCost:
    """GQA attention of q (B, S, H, D) over k, v (B, Sk, KV, D): q, k, v
    read and out written in ``dtype`` (with ``return_stats`` also the
    (B, H, S) f32 log-sum-exp); the QK^T and PV products over the kept
    pairs; one exp a kept pair and head."""
    sk = s if sk is None else sk
    e = dtype.itemsize
    pairs = _pairs(s, sk, causal, window, s * sk / 2)
    nbytes = e * (2 * b * s * h * d + 2 * b * sk * kv * d)
    if return_stats:
        nbytes += 4 * b * h * s
    return KernelCost(4 * b * h * d * pairs, nbytes, b * h * pairs)


def flash_attention_bwd(b: int, s: int, h: int, kv: int, d: int, *,
                        sk: Optional[int] = None, dtype=torch.bfloat16,
                        causal: bool = True, window: int = 0) -> KernelCost:
    """The gradients of ``flash_attention``: q, out, dout and k, v read and
    dq, dk, dv written in ``dtype``, the (B, H, S) f32 statistics read;
    five products (S, dP, dV, dK, dQ) over the kept pairs; the scores'
    exp recomputed once a kept pair and head."""
    sk = s if sk is None else sk
    e = dtype.itemsize
    pairs = _pairs(s, sk, causal, window, s * (s + 1) // 2)
    return KernelCost(10 * b * h * d * pairs,
                      e * (4 * b * s * h * d + 4 * b * sk * kv * d)
                      + 4 * b * h * s, b * h * pairs)


def flash_decode(b: int, s: int, h: int, kv: int, d: int, *,
                 dtype=torch.bfloat16, cache_dtype=None,
                 stats: bool = False) -> KernelCost:
    """One query token q (B, 1, H, D) over (B, S, KV, D) caches and the
    (B, S) bool mask: q read and out written in ``dtype`` (with ``stats``
    out in f32 and the (B, H) f32 log-sum-exp beside it, one log a row),
    both caches read in ``cache_dtype`` (default ``dtype``), the mask
    read; both products and one exp over every slot, valid or not (the
    kernel reads them all)."""
    e = dtype.itemsize
    ec = (cache_dtype or dtype).itemsize
    out = 4 * b * h * d + 4 * b * h if stats else e * b * h * d
    return KernelCost(4 * b * h * s * d,
                      e * b * h * d + out + ec * 2 * b * s * kv * d + b * s,
                      b * h * s + (b * h if stats else 0))
