"""Public wrappers of the port's kernels: the dispatch points the selection,
transport and attention code call (the counterparts of
``repro.kernels.ops``).

Each wrapper checks device, dtype, shape and contiguity and raises on what
its kernel does not take. Then the device picks the engine: a tensor on
the CPU goes to the kernel's plain version (``kernels/ref.py``); a tensor
on a CUDA device launches the hand-written kernel, or raises. There is no
size threshold and no fallback: the kernels mask their ragged edges
themselves, so nothing is padded either.

Every wrapper carries a plain integer ``launches`` that it raises by one
each time it launches its kernel (one Lloyd sweep counts once, although it
is two CUDA launches, and one attention backward once, although it is
three). ``reset_launch_counts`` / ``launch_counts`` read and
zero them all, so a run can show that it went through the kernels. The
two forward attention wrappers also count their launches by query and
key length (``launches_by_lengths``), which tells self-attention, an
encoder and cross-attention apart.

Each launch runs inside an ``obs.timed_block("kernel.<wrapper name>")``
that syncs the kernel's output when a tracer is active (a no-op
otherwise), so a trace holds one ``kernel.*`` span a launch. The plain
versions on the CPU open none.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch import obs
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import ROUTES


def _on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one, else raise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no engine for device {t.device}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kmeans_pairwise_dist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(N, D), (K, D) f32 -> (N, K) f32 squared distances."""
    _check(x, "x", torch.float32, 2, x.device)
    _check(c, "c", torch.float32, 2, x.device)
    n, d = x.shape
    k = c.shape[0]
    if c.shape[1] != d or d == 0 or k == 0:
        raise ValueError(f"x {tuple(x.shape)} and c {tuple(c.shape)} must "
                         f"share a non-zero width, with K > 0")
    if not _on_card(x, "kmeans_pairwise_dist"):
        return ref.kmeans_pairwise_dist_ref(x, c)
    out = torch.empty((n, k), dtype=torch.float32, device=x.device)
    if n == 0:                          # nothing to launch
        return out
    from repro_torch.kernels.kmeans import launch_pairwise_dist
    with obs.timed_block("kernel.kmeans_pairwise_dist", n=n, d=d,
                         k=k) as sp:
        kmeans_pairwise_dist.last_plan = launch_pairwise_dist(x, c, out)
        sp.sync(out)
    kmeans_pairwise_dist.launches += 1
    return out


def kmeans_lloyd_step(x: torch.Tensor, c: torch.Tensor, lmask: torch.Tensor):
    """Fused Lloyd sweep: (N, D), (K, D), (N, K) additive mask, all f32 ->
    (assign (N,) int32, mindist (N,) f32, sums (K, D) f32, counts (K,) f32).
    """
    _check(x, "x", torch.float32, 2, x.device)
    _check(c, "c", torch.float32, 2, x.device)
    _check(lmask, "lmask", torch.float32, 2, x.device)
    n, d = x.shape
    k = c.shape[0]
    if c.shape[1] != d or d == 0 or k == 0:
        raise ValueError(f"x {tuple(x.shape)} and c {tuple(c.shape)} must "
                         f"share a non-zero width, with K > 0")
    if tuple(lmask.shape) != (n, k):
        raise ValueError(f"lmask must be {(n, k)}, got {tuple(lmask.shape)}")
    if not _on_card(x, "kmeans_lloyd_step"):
        return ref.kmeans_lloyd_ref(x, c, lmask)
    from repro_torch.kernels.kmeans import launch_lloyd
    dev = x.device
    assign = torch.empty((n,), dtype=torch.int32, device=dev)
    mindist = torch.empty((n,), dtype=torch.float32, device=dev)
    member = torch.empty((n,), dtype=torch.int32, device=dev)
    sums = torch.empty((k, d), dtype=torch.float32, device=dev)
    counts = torch.empty((k,), dtype=torch.float32, device=dev)
    with obs.timed_block("kernel.kmeans_lloyd_step", n=n, d=d, k=k) as sp:
        kmeans_lloyd_step.last_plan = launch_lloyd(
            x, c, lmask, assign, mindist, member, sums, counts)
        sp.sync(counts)
    kmeans_lloyd_step.launches += 1
    return assign, mindist, sums, counts


def quantize_affine(x: torch.Tensor, rowmask: torch.Tensor):
    """Per-tensor affine int8 of (N, D) f32 ``x`` over the rows where the
    (N,) bool ``rowmask`` is set -> (q (N, D) int8, xmin, scale), the last
    two 0-d f32 tensors. Byte-exact against ``ref.quantize_affine_ref``."""
    _check(x, "x", torch.float32, 2, x.device)
    _check(rowmask, "rowmask", torch.bool, 1, x.device)
    n, d = x.shape
    if rowmask.shape[0] != n:
        raise ValueError(f"rowmask has {rowmask.shape[0]} rows, x has {n}")
    if not _on_card(x, "quantize_affine"):
        return ref.quantize_affine_ref(x, rowmask)
    from repro_torch.kernels.quantize import launch_quantize_affine, plan_for
    plan = plan_for(x)
    q = torch.empty((n, d), dtype=torch.int8, device=x.device)
    # (xmin, scale), then each block's (min, max) partial
    scratch = torch.empty((2 + 2 * plan.grid,), dtype=torch.float32,
                          device=x.device)
    with obs.timed_block("kernel.quantize_affine", n=n, d=d) as sp:
        launch_quantize_affine(x, rowmask, q, scratch, plan)
        sp.sync(scratch)
    quantize_affine.last_plan = plan
    quantize_affine.launches += 1
    return q, scratch[0], scratch[1]


def quantize_affine_batched(x: torch.Tensor, rowmask: torch.Tensor):
    """``quantize_affine`` of each client of a stacked cohort in one
    launch: (B, N, D) f32 ``x`` and (B, N) bool ``rowmask`` -> (q (B, N, D)
    int8, xmin (B,), scale (B,)), each client's statistics over its own
    valid rows. Byte-exact against ``ref.quantize_affine_batched_ref`` and
    against B calls of ``quantize_affine``."""
    _check(x, "x", torch.float32, 3, x.device)
    _check(rowmask, "rowmask", torch.bool, 2, x.device)
    b, n, d = x.shape
    if tuple(rowmask.shape) != (b, n):
        raise ValueError(f"rowmask must be {(b, n)}, got "
                         f"{tuple(rowmask.shape)}")
    if not _on_card(x, "quantize_affine_batched"):
        return ref.quantize_affine_batched_ref(x, rowmask)
    q = torch.empty((b, n, d), dtype=torch.int8, device=x.device)
    if b == 0:                          # nothing to launch
        empty = torch.empty(0, device=x.device)
        return q, empty, empty
    from repro_torch.kernels.quantize import (launch_quantize_affine_cohort,
                                              plan_for_cohort)
    plan = plan_for_cohort(x)
    # each client's (xmin, scale), then each virtual block's partial
    scratch = torch.empty((2 * b + 2 * b * plan.per_client,),
                          dtype=torch.float32, device=x.device)
    with obs.timed_block("kernel.quantize_affine_batched", b=b, n=n,
                         d=d) as sp:
        launch_quantize_affine_cohort(x, rowmask, q, scratch, plan)
        sp.sync(scratch)
    quantize_affine_batched.last_plan = plan
    quantize_affine_batched.launches += 1
    params = scratch[:2 * b].view(b, 2)
    return q, params[:, 0], params[:, 1]


ATTENTION_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256


def _check_attention(t: torch.Tensor, name: str, dtype: torch.dtype,
                     ndim: int, device: torch.device) -> None:
    if isinstance(t, torch.Tensor) and t.dtype not in ATTENTION_DTYPES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    _check(t, name, dtype, ndim, device)


def _needs_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _no_grad(what: str, *ts: torch.Tensor) -> None:
    """The decode kernel is forward only, as the reference's decode (which
    training never differentiates): a tensor that needs a gradient is
    refused, not launched."""
    if _needs_grad(*ts):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward; "
                           f"call it on tensors that do not require grad")


def _heads(h: int, kv: int, d: int, what: str) -> None:
    if kv == 0 or h % kv:
        raise ValueError(f"{what}: {h} query heads are not a multiple of "
                         f"{kv} kv heads")
    if not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} not in 1..{MAX_HEAD_DIM}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    return_stats: bool = False):
    """GQA attention of q (B,S,H,D) over k, v (B,Sk,KV,D), all f32 or all
    bf16 -> (B,S,H,D) in that dtype. ``causal`` masks qi < ki; ``window``
    > 0 masks qi - ki >= window. A key length Sk unlike S (whisper's
    cross-attention: decoder queries over encoder keys) is taken only
    without a mask (``causal=False``, ``window=0``), with or without a
    gradient. No padding and no size threshold: the kernel masks keys at
    the true Sk.

    ``return_stats``: -> (out, lse), lse (B,H,S) f32 each row's log-sum-exp
    of its scaled logits (what ``flash_attention_bwd`` takes). On CUDA
    tensors that need a gradient (and no stats asked for) the call goes
    through ``models.layers.FlashAttention``, whose forward is this kernel
    with its statistics and whose backward is ``flash_attention_bwd``."""
    _check_attention(q, "q", q.dtype, 4, q.device)
    _check(k, "k", q.dtype, 4, q.device)
    _check(v, "v", q.dtype, 4, q.device)
    b, s, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (b, sk, kv, d) or tuple(v.shape) != (b, sk, kv, d)
            or sk == 0):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must "
                         f"be {(b, 'Sk > 0', kv, d)} for q "
                         f"{tuple(q.shape)}")
    _heads(h, kv, d, "flash_attention")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if sk != s and (causal or window):
        raise ValueError(f"flash_attention: a key length {sk} unlike the "
                         f"query length {s} needs causal=False and "
                         f"window=0")
    if not _on_card(q, "flash_attention"):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       return_stats=return_stats)
    if b * kv > 65535:
        raise ValueError(f"flash_attention: B*KV = {b * kv} > 65535")
    if not return_stats and _needs_grad(q, k, v):
        # (imported here: models.layers imports this module)
        from repro_torch.models.layers import FlashAttention
        return FlashAttention.apply(q, k, v, causal, int(window), 1024)
    from repro_torch.kernels.flash_attention import (launch_flash_attention,
                                                     route_for)
    out = torch.empty_like(q)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if return_stats else None)
    route = route_for(q, k, v)
    with obs.timed_block("kernel.flash_attention", b=b, s=s, sk=sk, h=h,
                         d=d) as sp:
        launch_flash_attention(q, k, v, out, causal, int(window), route, lse)
        sp.sync(out)
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    _count_lengths(flash_attention, s, sk)
    return (out, lse) if return_stats else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        window: int = 0):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` for the
    output gradient ``dout``, from the forward's ``out`` and statistics
    ``lse`` (B,H,S) f32. q, out, dout (B,S,H,D) and k, v (B,Sk,KV,D), all
    f32 or all bf16 (Sk unlike S only with ``causal=False``, ``window=0``,
    as the forward); the gradients come back in that dtype. On the card
    three CUDA launches (counted once, once in ``launches_by_route`` under
    the route ``flash_attention.bwd_route`` picks and once in
    ``launches_by_lengths`` under ``"<S>x<Sk>"``); on the CPU the plain
    version (``ref.flash_attention_bwd_ref`` with ``m = lse``, ``l =
    1``)."""
    _check_attention(q, "q", q.dtype, 4, q.device)
    for t, name in ((k, "k"), (v, "v"), (out, "out"), (dout, "dout")):
        _check(t, name, q.dtype, 4, q.device)
    _check(lse, "lse", torch.float32, 3, q.device)
    b, s, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (b, sk, kv, d) or tuple(v.shape) != (b, sk, kv, d)
            or sk == 0 or out.shape != q.shape or dout.shape != q.shape
            or tuple(lse.shape) != (b, h, s)):
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, "
                         f"lse {tuple(lse.shape)} do not fit")
    _heads(h, kv, d, "flash_attention_bwd")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if sk != s and (causal or window):
        raise ValueError(f"flash_attention_bwd: a key length {sk} unlike "
                         f"the query length {s} needs causal=False and "
                         f"window=0")
    if not _on_card(q, "flash_attention_bwd"):
        return ref.flash_attention_bwd_ref(q, k, v, out, dout, lse,
                                           torch.ones_like(lse),
                                           causal=causal, window=window)
    if b * kv > 65535:
        raise ValueError(f"flash_attention_bwd: B*KV = {b * kv} > 65535")
    from repro_torch.kernels.flash_attention import (
        bwd_route_for, launch_flash_attention_bwd)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    dd = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    route = bwd_route_for(q, k, v, out, dout)
    with obs.timed_block("kernel.flash_attention_bwd", b=b, s=s, sk=sk,
                         h=h, d=d) as sp:
        launch_flash_attention_bwd(q, k, v, out, dout, lse, dd, dq, dk, dv,
                                   causal, int(window), route)
        sp.sync(dq)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_by_route[route] += 1
    _count_lengths(flash_attention_bwd, s, sk)
    return dq, dk, dv


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """One query token q (B,1,H,D) against ring-buffer caches (B,S,KV,D)
    under the (B,S) bool ``valid`` mask -> (B,1,H,D) in q's dtype. q and the
    caches are each f32 or bf16; the caches are read as q's dtype."""
    _check_attention(q, "q", q.dtype, 4, q.device)
    _check_attention(k_cache, "k_cache", k_cache.dtype, 4, q.device)
    _check(v_cache, "v_cache", k_cache.dtype, 4, q.device)
    _check(valid, "valid", torch.bool, 2, q.device)
    b, one, h, d = q.shape
    s, kv = k_cache.shape[1], k_cache.shape[2]
    if one != 1:
        raise ValueError(f"q must be (B, 1, H, D), got {tuple(q.shape)}")
    if (tuple(k_cache.shape) != (b, s, kv, d)
            or tuple(v_cache.shape) != (b, s, kv, d)):
        raise ValueError(f"caches {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} must be {(b, s, kv, d)}")
    if tuple(valid.shape) != (b, s):
        raise ValueError(f"valid must be {(b, s)}, got {tuple(valid.shape)}")
    _heads(h, kv, d, "flash_decode")
    if not _on_card(q, "flash_decode"):
        return ref.flash_decode_ref(q, k_cache, v_cache, valid)
    _no_grad("flash_decode", q, k_cache, v_cache)
    from repro_torch.kernels.decode_attention import (MAX_G,
                                                      launch_flash_decode)
    if h // kv > MAX_G:
        raise ValueError(f"flash_decode: {h // kv} query heads per kv head "
                         f"exceed the kernel's {MAX_G}")
    out = torch.empty_like(q)
    with obs.timed_block("kernel.flash_decode", b=b, s=s, h=h, d=d) as sp:
        flash_decode.last_splits = launch_flash_decode(q, k_cache, v_cache,
                                                       valid, out)
        sp.sync(out)
    flash_decode.launches += 1
    _count_lengths(flash_decode, 1, s)
    return out


def _count_lengths(fn, s: int, sk: int) -> None:
    """One more launch of ``fn`` at ``s`` queries over ``sk`` keys (or
    slots), in ``fn.launches_by_lengths`` under ``"<s>x<sk>"``: what tells
    a model's self-attention, encoder and cross-attention launches
    apart."""
    key = f"{s}x{sk}"
    fn.launches_by_lengths[key] = fn.launches_by_lengths.get(key, 0) + 1


KERNELS = (kmeans_pairwise_dist, kmeans_lloyd_step, quantize_affine,
           quantize_affine_batched, flash_attention, flash_attention_bwd,
           flash_decode)
flash_decode.last_splits = 0           # the split count of the last launch
# the plan (kernels/kmeans.py RowPlan, kernels/quantize.py QuantizePlan
# and CohortPlan) of the last launch
kmeans_pairwise_dist.last_plan = kmeans_lloyd_step.last_plan = None
quantize_affine.last_plan = quantize_affine_batched.last_plan = None


def reset_launch_counts() -> None:
    """Zero every wrapper's ``launches`` (and the attention's by route and
    by lengths)."""
    for fn in KERNELS:
        fn.launches = 0
    # the prefill kernel's and its backward's launches by route;
    # ``launches`` is their total
    flash_attention.launches_by_route = dict.fromkeys(ROUTES, 0)
    flash_attention_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)
    # the attention kernels' launches by query and key length
    flash_attention.launches_by_lengths = {}
    flash_attention_bwd.launches_by_lengths = {}
    flash_decode.launches_by_lengths = {}


reset_launch_counts()


def launch_counts() -> Dict[str, int]:
    """wrapper name -> kernel launches since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNELS}
