"""Plain PyTorch versions of the hand-written kernels on the port's main path.

Each function computes what ``repro.kernels.ref`` computes, op for op, on
torch tensors. They are the kernels' contract: on the CPU the wrappers in
``kernels/ops.py`` run them, and ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

import math

import torch

BIG = 1e30
NEG = -1e30          # the attention mask's logit (repro's NEG)


def kmeans_pairwise_dist_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N,D),(K,D) -> (N,K) squared Euclidean distances
    ||x||^2 + ||c||^2 - 2 x.c."""
    x2 = torch.sum(x * x, -1, keepdim=True)
    c2 = torch.sum(c * c, -1)
    return x2 + c2[None, :] - 2.0 * (x @ c.T)


def kmeans_lloyd_ref(x: torch.Tensor, c: torch.Tensor, lmask: torch.Tensor):
    """One fused Lloyd sweep.

    x: (N, D), c: (K, D), lmask: (N, K) additive mask — 0 where the row may
    join the cluster, BIG where forbidden. A row with no admissible cluster
    gets zero weight in the statistics. Returns
    (assign (N,) int32, mindist (N,) f32, sums (K, D) f32, counts (K,) f32);
    ``assign`` takes the lowest index on ties, as ``jnp.argmin`` does.
    """
    k = c.shape[0]
    d = kmeans_pairwise_dist_ref(x, c) + lmask
    assign = torch.argmin(d, dim=1)
    mind = torch.gather(d, 1, assign[:, None])[:, 0]
    w = (torch.amin(lmask, dim=1) <= 0.0).to(x.dtype)
    onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype) * w[:, None]
    counts = onehot.sum(0)
    sums = onehot.T @ x
    return assign.to(torch.int32), mind, sums, counts


def affine_params_from_minmax(xmin_raw: torch.Tensor, xmax_raw: torch.Tensor):
    """(raw masked min, raw masked max) -> (xmin, scale) of the affine int8
    contract, as f32 0-d tensors. An empty selection (max < min) gives
    xmin=0, scale=1; a constant one gives scale=1. The scale is
    ``rng * f32(1/255)``, an explicit multiply, never ``rng / 255``."""
    has = xmax_raw >= xmin_raw
    zero = torch.zeros((), dtype=torch.float32, device=xmin_raw.device)
    xmin = torch.where(has, xmin_raw, zero)
    rng = torch.where(has, xmax_raw - xmin, zero)
    inv255 = torch.tensor(1.0 / 255.0, dtype=torch.float32,
                          device=xmin_raw.device)
    scale = torch.where(rng > 0, rng * inv255, torch.ones_like(rng))
    return xmin, scale


def quantize_affine_ref(x: torch.Tensor, rowmask: torch.Tensor):
    """Per-tensor affine int8 over the valid rows.

    x: (N, D) f32, rowmask: (N,) bool. min/max run over valid rows only;
    masked rows quantize to -128. Returns (q (N, D) int8, xmin, scale) with
    ``x_hat = (q + 128) * scale + xmin``. Every step is elementwise f32 or
    an exact min/max, and ``torch.round`` rounds half to even, so the
    result is byte-exact against ``repro.kernels.ref.quantize_affine_ref``.
    A zero minimum is -0.0 where a valid -0.0 is present, as XLA's min
    orders -0.0 below +0.0; ``torch.amin`` returns either zero of a tie.
    """
    valid = rowmask.to(torch.bool)[:, None]
    big = torch.tensor(BIG, dtype=torch.float32, device=x.device)
    xmin_raw = torch.amin(torch.where(valid, x, big)) if x.numel() else big
    neg_zero = (valid & (x == 0) & torch.signbit(x)).any()
    xmin_raw = torch.where(xmin_raw == 0,
                           torch.where(neg_zero, -0.0, 0.0).to(xmin_raw),
                           xmin_raw)
    xmax_raw = torch.amax(torch.where(valid, x, -big)) if x.numel() else -big
    xmin, scale = affine_params_from_minmax(xmin_raw, xmax_raw)
    inv = torch.reciprocal(scale)
    q = torch.clamp(torch.round((x - xmin) * inv) - 128.0, -128.0, 127.0)
    q = torch.where(valid, q, torch.full_like(q, -128.0)).to(torch.int8)
    return q, xmin, scale


def dequantize_affine_ref(q: torch.Tensor, xmin, scale) -> torch.Tensor:
    """Inverse of ``quantize_affine_ref``: x_hat = (q + 128) * scale + xmin
    in f32."""
    return (q.to(torch.float32) + 128.0) * scale + xmin


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0) -> torch.Tensor:
    """(B,S,H,D) x (B,S,KV,D)^2 -> (B,S,H,D); GQA via head repeat (query
    head h reads kv head h // (H/KV)). Scores in f32 scaled by 1/sqrt(D),
    masked to NEG where ``qi < ki`` (causal) or ``qi - ki >= window``
    (window > 0); softmax in f32, p cast to the input dtype before P.V."""
    b, sq, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32)
    s = s / math.sqrt(d)
    qi = torch.arange(sq, device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones((sq, k.shape[1]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= (qi - ki) < window
    s = torch.where(mask[None, None], s, NEG)
    p = torch.softmax(s, -1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)


def flash_decode_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """q:(B,1,H,D) caches:(B,S,KV,D) valid:(B,S) bool -> (B,1,H,D). The
    caches are read as q's dtype (the reference model's
    ``cache.astype(q.dtype)``). Slots where ``valid`` is false get the NEG
    logit (all false: the softmax is uniform over the S slots, as in
    repro)."""
    b, _, h, d = q.shape
    kv = k_cache.shape[2]
    k_cache, v_cache = k_cache.to(q.dtype), v_cache.to(q.dtype)
    rep = h // kv
    if rep > 1:
        k_cache = torch.repeat_interleave(k_cache, rep, dim=2)
        v_cache = torch.repeat_interleave(v_cache, rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k_cache).to(torch.float32)
    s = s / math.sqrt(d)
    s = torch.where(valid[:, None, None, :], s, NEG)
    p = torch.softmax(s, -1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v_cache)
