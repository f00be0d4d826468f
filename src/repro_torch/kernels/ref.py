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


def quantize_affine_batched_ref(x: torch.Tensor, rowmask: torch.Tensor):
    """``quantize_affine_ref`` of each client of a stacked cohort (the
    reference's ``vmap`` of it): x (B, N, D) f32, rowmask (B, N) bool ->
    (q (B, N, D) int8, xmin (B,), scale (B,)), each client's statistics
    over its own valid rows."""
    outs = [quantize_affine_ref(xb, mb) for xb, mb in zip(x, rowmask)]
    if not outs:
        return (torch.empty(x.shape, dtype=torch.int8, device=x.device),
                torch.empty(0, device=x.device),
                torch.empty(0, device=x.device))
    q, xmin, scale = zip(*outs)
    return torch.stack(q), torch.stack(xmin), torch.stack(scale)


def dequantize_affine_ref(q: torch.Tensor, xmin, scale) -> torch.Tensor:
    """Inverse of ``quantize_affine_ref``: x_hat = (q + 128) * scale + xmin
    in f32."""
    return (q.to(torch.float32) + 128.0) * scale + xmin


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        return_stats: bool = False):
    """(B,S,H,D) x (B,S,KV,D)^2 -> (B,S,H,D); GQA via head repeat (query
    head h reads kv head h // (H/KV)). Scores in f32 scaled by 1/sqrt(D),
    masked to NEG where ``qi < ki`` (causal) or ``qi - ki >= window``
    (window > 0); softmax in f32, p cast to the input dtype before P.V.
    ``return_stats``: also each row's log-sum-exp of its masked scaled
    logits, (B,H,S) f32, the statistics the CUDA kernel writes."""
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
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
    if return_stats:                 # contiguous, as the kernel writes them
        return out.contiguous(), torch.logsumexp(s, -1)
    return out


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, out: torch.Tensor,
                            dout: torch.Tensor, m: torch.Tensor,
                            l: torch.Tensor, *, causal: bool = True,
                            window: int = 0, chunk: int = 1024):
    """The attention's backward from its softmax statistics: the port of
    ``repro.models.layers._sdpa_flash_bwd``, op for op. q, out, dout
    (B,S,H,D), k, v (B,S,KV,D); ``m``, ``l`` (B,H,S) f32, the forward's
    row max of the scaled logits and the sum of ``exp(s - m)``. Returns
    (dq, dk, dv) in the inputs' dtypes.

    Key chunks of ``chunk`` (the last padded and masked) are recomputed:
    ``p = exp(s - m) / l``, ``D = rowsum(dO * O)``, ``ds = p (dP - D)
    scale``, and each chunk's GQA reps are folded onto their kv heads. The
    rounding points are the reference's deliberate ones: ``ds`` and ``p``
    are rounded to the input dtype before their products. Every product
    is taken in f32 on the inputs' values and every sum stays f32 until
    the gradients are written (the reference's bf16 einsums also round
    their outputs, s, dP and each chunk's dK/dV, to bf16; the kernel does
    not, and neither does this, its contract). The CUDA kernel's
    statistics are one number a row, ``lse = m + log l``: pass ``m=lse``
    with ``l`` all ones."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    scale = 1.0 / math.sqrt(d)
    nchunks = (sk + chunk - 1) // chunk
    pad = nchunks * chunk - sk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    f32 = torch.float32
    dtype = q.dtype
    q32, do32 = q.to(f32), dout.to(f32)
    qi = torch.arange(sq, device=q.device)[:, None]
    # D_i = rowsum(dout * out) (the softmax-jacobian diagonal term)
    dd = torch.einsum("bqhd,bqhd->bhq", do32, out.to(f32))
    li = torch.clamp(l, min=1e-30)
    dq = torch.zeros((b, sq, h, d), dtype=f32, device=q.device)
    dks, dvs = [], []
    for ci in range(nchunks):
        kr = _repeat_kv(k[:, ci * chunk:(ci + 1) * chunk], n_rep).to(f32)
        vr = _repeat_kv(v[:, ci * chunk:(ci + 1) * chunk], n_rep).to(f32)
        s = torch.einsum("bqhd,bkhd->bhqk", q32, kr) * scale
        ki = ci * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = ki < sk
        if causal:
            mask = mask & (qi >= ki)
        if window > 0:
            mask = mask & ((qi - ki) < window)
        s = torch.where(mask[None, None], s, NEG)
        p = torch.exp(s - m[..., None]) / li[..., None]         # true probs
        dp = torch.einsum("bqhd,bkhd->bhqk", do32, vr)
        ds = p * (dp - dd[..., None]) * scale
        # the rounding points: ds and p in the input dtype
        ds16, p16 = ds.to(dtype).to(f32), p.to(dtype).to(f32)
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds16, kr)
        dk_f = torch.einsum("bhqk,bqhd->bkhd", ds16, q32)      # (b,chunk,h,d)
        dv_f = torch.einsum("bhqk,bqhd->bkhd", p16, do32)
        # fold GQA reps back onto kv heads
        dks.append(dk_f.reshape(b, chunk, kv, n_rep, d).sum(3))
        dvs.append(dv_f.reshape(b, chunk, kv, n_rep, d).sum(3))
    dk = torch.cat(dks, 1)[:, :sk]
    dv = torch.cat(dvs, 1)[:, :sk]
    return dq.to(dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def flash_decode_stats_ref(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, valid: torch.Tensor):
    """``flash_decode_ref`` with its softmax statistics: (o (B,1,H,D),
    lse (B,H)), both in f32 (f64 for f64 inputs). o is normalised over
    the S slots given; lse = m + log(l) of the scaled scores, the invalid
    slots' at the NEG logit (all invalid: m = NEG, l = S, so o is the
    mean of v). The caches are read as q's dtype and p is rounded to it
    before P.V, as the kernel does; the scores and sums are wide."""
    b, _, h, d = q.shape
    wide = torch.promote_types(q.dtype, torch.float32)
    rep = h // k_cache.shape[2]
    k = k_cache.to(q.dtype).to(wide)
    v = v_cache.to(q.dtype).to(wide)
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].to(wide), k) / math.sqrt(d)
    s = torch.where(valid[:, None, :], s, NEG)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhk,bkhd->bhd", p.to(q.dtype).to(wide), v)
    return (o / l[..., None])[:, None], m + torch.log(l)
