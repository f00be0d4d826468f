"""Layers of the LMs: the port of ``repro.models.layers`` (norms, RoPE,
the attention cores, the GQA attention block with whisper's
cross-attention, MLA attention, the dense FFN, the capacity-dropped top-k
MoE FFN, Mamba and RWKV6's time and channel mix).

Conventions, as in the reference:
  * params are plain dicts of tensors; a scan stage stacks each leaf along
    a leading repeat axis (``models/transformer.py``);
  * ``attn_apply(params, x, *, cfg, mode, cache, pos, window)`` returns
    ``(y, cache)``; mode ``full`` covers prefill (causal), mode ``decode``
    consumes one new token against the cache;
  * attention caches are ring buffers of ``min(window or S, S)`` slots
    holding keys after RoPE, so ring order does not matter to the softmax.

The attention cores follow the device of their inputs: on a CUDA tensor
``attn_apply`` runs the hand-written kernels (``kernels.ops.flash_attention``
for prefill and training, ``flash_decode`` for decode); on a CPU tensor it
runs the plain versions here, on the reference's branch (``sdpa_full`` up
to 2048 positions, ``sdpa_chunked`` above). Under autograd the full-mode
attention is ``FlashAttention``, the reference's recompute custom VJP
(``_sdpa_flash``): on the card the prefill kernel with its softmax
statistics forward and the backward kernels, on the CPU
``_sdpa_chunked_raw`` forward and its port of ``_sdpa_flash_bwd``; on the
CPU up to 2048 positions ``sdpa_full`` is differentiated by autograd, as
the reference does. Decode has no gradient.

The MoE (``moe_apply``) is plain torch ops on either device, as the
reference's einsums: index copies for dispatch and combine, batched GEMMs
for the experts; its ``moe.*`` profiler ranges name its parts.

MLA (``mla_apply``, deepseek-v2) keeps a latent cache of ``c_kv`` and the
shared rotary key. Prefill and the default (naive) decode rebuild per-head
keys of width dn + dr and values padded to that width, and run the same
attention cores as ``attn_apply``: on a CUDA tensor the prefill and decode
kernels, on a CPU tensor their plain versions. The absorbed decode
attends in the latent space with plain torch einsums, as the reference.

RWKV6 (``rwkv_apply``, ``rwkv_ffn_apply``) is plain torch on either
device, as the reference's jnp scan: the chunked WKV in f32 for prefill,
the recurrence for decode. Its decode state is replaced every step; the
new values are copied into the caller's cache tensors, so a stacked
cache is updated in place as the attention rings are.

Whisper's decoder cross-attention (``attn_apply(enc_out=...)``) attends
non-causally over the encoder's output, re-projected every call as the
reference does: on a CUDA tensor the prefill kernel with a key length
unlike the query length, or the decode kernel over a fully valid memory
for one query; on a CPU tensor ``sdpa_full``, the reference's core.

On a model axis (inside ``model_axis.over``, the step's tensor-parallel
run) every layer takes each rank's shard of its weights, as the sharding
plan places them: the attention runs the kernels on the heads this rank's
columns of ``wq`` and rows of ``wo`` hold (``_attn_apply_tp``), MLA on the
heads of its columns of ``w_uq``, ``w_uk`` and ``w_uv`` (the D 192
kernels on them), the FFN is column- then row-parallel, the MoE runs its
experts (expert parallelism, the route whole on every rank), Mamba its
chunk of ``d_inner`` and RWKV its heads; each sums its output over the
ranks (``model_axis``). A block whose weights are all replicated runs as
on one rank.

A decode ring split over ranks (``SeqSplit``: its sequence over "data"
at batch 1, or over "model" with the reference's ``cache_seq_shard``) is
written by the rank holding the new slot only; each rank attends over its
slots with the decode kernel's softmax statistics (``sdpa_decode_stats``)
and the ranks' outputs are merged by their log-sum-exp
(``merge_decode``). A k/v ring split on its head dim is gathered whole
for the step (``_decode_kv``). With FSDP (``models/fsdp.py``) a block's
weights arrive gathered over "data"; the MoE averages its load-balance
statistics over the data ranks' rows, or gathers rows that form no whole
group.

Mamba (``mamba_apply``, jamba's SSM mixer) is plain torch on either
device, as the reference's jnp scans: a causal depthwise convolution and
the selective scan (``_selective_scan``: chunks in order, a log-depth
scan inside each) for prefill, one step of the recurrence from the conv
and SSM states (f32 whatever the compute dtype) for decode, the new
states copied into the caller's cache as RWKV's are.
"""
from __future__ import annotations

import copy
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collectives import Ranks, all_gather_cat
from repro_torch.kernels import ops, ref
from repro_torch.models import fsdp as FS
from repro_torch.models import model_axis as MA

NEG = -1e30


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------
class ParamInit:
    """Draws parameters from a ``torch.Generator`` on its device.

    ``lead`` is a leading repeat axis (a scan stage's stacked layers): every
    leaf gets shape ``lead + shape``, and a stacked leaf is drawn one layer
    slice at a time (f32 draws from ``gen``, in layer order). ``dtype`` is
    the leaves' dtype: each slice is drawn and scaled in f32 and cast into
    the preallocated leaf, so no more than one slice is ever held in f32 and
    the bits are those of the f32 tree cast afterwards. On the ``meta``
    device (``gen`` None) only shapes are made, which is how
    ``registry.count_params`` counts."""

    def __init__(self, gen: Optional[torch.Generator],
                 device: Optional[torch.device] = None,
                 lead: Sequence[int] = (), dtype=torch.float32):
        self.gen = gen
        self.device = torch.device(device) if device is not None \
            else gen.device
        self.lead = tuple(lead)
        self.dtype = dtype

    def stacked(self, repeats: int) -> "ParamInit":
        out = copy.copy(self)
        out.lead = (repeats,)
        return out

    def normal(self, shape, scale: float) -> torch.Tensor:
        shape = tuple(shape)
        out = torch.empty(self.lead + shape, dtype=self.dtype,
                          device=self.device)
        if self.device.type == "meta":
            return out
        for r in range(math.prod(self.lead)):
            x = torch.randn(shape, generator=self.gen, device=self.gen.device)
            out.view((-1,) + shape)[r].copy_(x.mul_(scale))
        return out

    def full(self, shape, value: float) -> torch.Tensor:
        return torch.full(self.lead + tuple(shape), value, dtype=self.dtype,
                          device=self.device)


def dense_init(init: ParamInit, shape, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal weights scaled by ``scale`` (default 1/sqrt(fan_in))."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return init.normal(shape, scale)


# --------------------------------------------------------------------------
# norms & activations
# --------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """The variance in f32, then ``(x * rsqrt).astype(x.dtype) * w``, the
    reference's order of casts."""
    var = torch.mean(torch.square(x.to(torch.float32)), -1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * w


def act_fn(name: str):
    """silu, or gelu in its tanh form (``jax.nn.gelu``'s default)."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Interleaved RoPE: rotates the pairs (x[..., 2i], x[..., 2i+1]) and
    restacks them. x: (B, S, H, D); positions: (B, S) or (S,)."""
    if theta <= 0:
        return x
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, D/2)
    if ang.ndim == 2:
        ang = ang[None]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2], x[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.stack([y1, y2], -1).reshape(x.shape).to(x.dtype)


# --------------------------------------------------------------------------
# scaled-dot-product cores: the plain versions (the kernels mirror these)
# --------------------------------------------------------------------------
def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def sdpa_full(q, k, v, *, causal: bool, window: int):
    """Direct attention (small seq). q:(B,Sq,H,D) k,v:(B,Sk,KV,D)."""
    h, kv = q.shape[2], k.shape[2]
    k, v = _repeat_kv(k, h // kv), _repeat_kv(v, h // kv)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    qi = torch.arange(q.shape[1], device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= qi - ki < window
    s = torch.where(mask[None, None], s, NEG)
    p = torch.softmax(s, -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _on_kernels(t: torch.Tensor) -> bool:
    """Whether attention on ``t`` takes the kernel wrappers' route: a CUDA
    tensor launches the kernels, a meta one (the dry run's count) charges
    their cost there; a CPU tensor runs the plain versions below."""
    return t.is_cuda or t.is_meta


def sdpa_chunked(q, k, v, *, causal: bool, window: int, chunk: int = 1024):
    """Online-softmax attention over KV chunks; under autograd the
    recompute VJP of ``FlashAttention`` (the reference's ``_sdpa_flash``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, chunk)
    return _sdpa_chunked_raw(q, k, v, causal=causal, window=window,
                             chunk=chunk)


class FlashAttention(torch.autograd.Function):
    """Attention with the reference's recompute backward
    (``repro.models.layers._sdpa_flash``): the forward keeps its softmax
    statistics and the output, and the backward recomputes the scores from
    them instead of storing them. ``apply(q, k, v, causal, window, chunk)``.

    On CUDA tensors the forward is the prefill kernel with its statistics
    (``ops.flash_attention(return_stats=True)``: lse = m + log l) and the
    backward the backward kernels (``ops.flash_attention_bwd``); on CPU
    tensors the forward is ``_sdpa_chunked_raw`` with (m, l) and the
    backward ``ref.flash_attention_bwd_ref`` (the port of
    ``_sdpa_flash_bwd``) over chunks of ``chunk`` keys. Nothing in the
    forward depends on the order it runs in, so a checkpointed layer's
    recompute gives the same output and statistics."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, chunk):
        if _on_kernels(q):
            out, lse = ops.flash_attention(q, k, v, causal=causal,
                                           window=window, return_stats=True)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out, m, l = _sdpa_chunked_raw(q, k, v, causal=causal,
                                          window=window, chunk=chunk,
                                          return_stats=True)
            ctx.save_for_backward(q, k, v, out, m, l)
        ctx.causal, ctx.window, ctx.chunk = causal, window, chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        dout = dout.contiguous()
        if _on_kernels(dout):
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = ops.flash_attention_bwd(
                q, k, v, out, dout, lse, causal=ctx.causal,
                window=ctx.window)
        else:
            q, k, v, out, m, l = ctx.saved_tensors
            dq, dk, dv = ref.flash_attention_bwd_ref(
                q, k, v, out, dout, m, l, causal=ctx.causal,
                window=ctx.window, chunk=ctx.chunk)
        return dq, dk, dv, None, None, None


def _sdpa_chunked_raw(q, k, v, *, causal: bool, window: int,
                      chunk: int = 1024, return_stats: bool = False):
    """Online-softmax attention, looping over KV chunks: O(S*chunk) live
    memory. The plain counterpart of ``kernels/csrc/flash_attention.cu``.
    ``return_stats``: -> (out, m, l), the row max of the scaled logits and
    the sum of ``exp(s - m)``, (B,H,S) f32 each, as the reference."""
    b, sq, h, d = q.shape
    sk, kv = k.shape[1], k.shape[2]
    n_rep = h // kv
    scale = 1.0 / math.sqrt(d)
    nchunks = (sk + chunk - 1) // chunk
    pad = nchunks * chunk - sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qi = torch.arange(sq, device=q.device)[:, None]
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    for ci in range(nchunks):
        kcur = _repeat_kv(k[:, ci * chunk:(ci + 1) * chunk], n_rep)
        vcur = _repeat_kv(v[:, ci * chunk:(ci + 1) * chunk], n_rep)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kcur).to(torch.float32) * scale
        ki = ci * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = ki < sk
        if causal:
            mask = mask & (qi >= ki)
        if window > 0:
            mask = mask & (qi - ki < window)
        s = torch.where(mask[None, None], s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        # p in the input dtype before P.V, as the reference and the kernel
        p16 = p.to(q.dtype)
        acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p16, vcur).to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30).transpose(1, 2)[..., None]
    if return_stats:
        return out.to(q.dtype), m, l
    return out.to(q.dtype)


def _prefill_core(q, k, v, *, causal: bool, window: int, chunked: bool):
    """Prefill attention for ``attn_apply`` and ``mla_apply``: a CUDA
    tensor runs the hand-written kernel (and its backward) at any s, with
    no fallback; a CPU tensor the reference's choice, chunked past 2048
    tokens."""
    if _on_kernels(q):
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    if chunked and q.shape[1] > 2048:
        return sdpa_chunked(q, k, v, causal=causal, window=window)
    return sdpa_full(q, k, v, causal=causal, window=window)


def sdpa_decode(q, k_cache, v_cache, valid):
    """Single-token attention over a (ring-buffer) cache.
    q:(B,1,H,D) k,v:(B,S,KV,D) valid:(B,S) bool slot-filled mask; the
    caches are read as q's dtype. A CUDA tensor runs the flash-decode
    kernel (which converts the cache in registers); a CPU tensor runs the
    plain version below."""
    if _on_kernels(q):
        return ops.flash_decode(q, k_cache, v_cache, valid)
    h, kv = q.shape[2], k_cache.shape[2]
    k = _repeat_kv(k_cache.to(q.dtype), h // kv)
    v = _repeat_kv(v_cache.to(q.dtype), h // kv)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    s = torch.where(valid[:, None, None, :], s, NEG)
    p = torch.softmax(s, -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class SeqSplit(NamedTuple):
    """A decode ring whose slots are split over ranks: ``ranks`` the group
    that splits them (its rank order the slots' order), this rank's chunk
    ``index`` of ``n`` even chunks, and ``axes`` the mesh axes the group
    spans ("data", "model" or both)."""
    ranks: Ranks
    index: int
    n: int
    axes: Tuple[str, ...]


def ring_slots(local: int, seq: Optional[SeqSplit]) -> Tuple[int, int]:
    """(the first global slot this rank holds, the ring's full size) of a
    ring of which this rank holds ``local`` slots."""
    if seq is None:
        return 0, local
    return seq.index * local, local * seq.n


def ring_write(ring: torch.Tensor, new: torch.Tensor, pos: torch.Tensor,
               seq: Optional[SeqSplit]) -> None:
    """``new`` (B, ...) into slot ``pos % size`` of each row of ``ring``
    (B, S_local, ...), IN PLACE; on a split ring only the rank that holds
    the slot writes it (the others write each row's slot back as it was,
    so no row count depends on the data)."""
    b, local = ring.shape[0], ring.shape[1]
    rows = torch.arange(b, device=ring.device)
    lo, size = ring_slots(local, seq)
    slot = (pos % size).long()
    new = new.to(ring.dtype)
    if seq is None:
        ring[rows, slot] = new
        return
    mine = (slot >= lo) & (slot < lo + local)
    at = torch.clamp(slot - lo, 0, local - 1)
    keep = mine.view((b,) + (1,) * (new.ndim - 1))
    ring[rows, at] = torch.where(keep, new, ring[rows, at])


def ring_valid(local: int, pos: torch.Tensor, seq: Optional[SeqSplit],
               device) -> torch.Tensor:
    """(B, S_local) bool: which of this rank's slots are filled, from the
    global positions (slot j of a ring of ``size`` holds a key once j <=
    min(pos, size - 1))."""
    lo, size = ring_slots(local, seq)
    j = lo + torch.arange(local, device=device)
    return j[None, :] <= torch.clamp(pos, max=size - 1)[:, None]


def sdpa_decode_stats(q, k_cache, v_cache, valid):
    """``sdpa_decode`` over this rank's slots, with its softmax
    statistics -> (o (B,1,H,D) f32 normalised over these slots, lse
    (B,H) f32): the decode kernel with statistics on a CUDA tensor, its
    plain version (wide: f64 stays f64) on a CPU one."""
    if _on_kernels(q):
        return ops.flash_decode(q, k_cache, v_cache, valid, stats=True)
    return ref.flash_decode_stats_ref(q, k_cache, v_cache, valid)


def merge_decode(o: torch.Tensor, lse: torch.Tensor, ranks: Ranks,
                 dtype: torch.dtype) -> torch.Tensor:
    """The attention of the whole ring from each rank's (o, lse) over its
    slots (``sdpa_decode_stats``): gathered over ``ranks``, weighted by
    exp(lse_r - lse) with lse = logsumexp_r(lse_r) and summed in rank
    order, wide, then rounded once to ``dtype``. The weights are
    normalised by their sum, which is exp(lse_r - lse) in exact
    arithmetic and keeps the edge cases: a rank with no valid slot
    (lse_r at the NEG logit) weighs exactly 0 beside a rank with one; with
    none anywhere every rank weighs the same, so the even chunks' means
    make the uniform weights over all S slots, as one rank's decode. B H
    (D + 1) values a rank: plain torch."""
    return merge_parts(all_gather_cat(o[None].contiguous(), ranks, 0),
                       all_gather_cat(lse[None].contiguous(), ranks, 0),
                       dtype)


def merge_parts(os_: torch.Tensor, ls: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """``merge_decode``'s sum of the parts (R, B,1,H,D) and their
    statistics (R, B,H), in rank order."""
    w = torch.exp(ls - ls.amax(0))
    w = w / w.sum(0)
    out = torch.zeros_like(os_[0])
    for r in range(os_.shape[0]):
        out = out + w[r][:, None, :, None] * os_[r]
    return out.to(dtype)


def _ring_attend(q, k_cache, v_cache, valid, seq):
    """Decode attention of q over a ring's local slots: whole (``seq``
    None), or this rank's part merged with the other ranks' (``seq``)."""
    if seq is None:
        return sdpa_decode(q, k_cache, v_cache, valid)
    o, lse = sdpa_decode_stats(q, k_cache, v_cache, valid)
    return merge_decode(o, lse, seq.ranks, q.dtype)


# the bytes that decode's gathers of a cache split on the head dim moved
# into this rank (``attn_apply``'s k/v columns), since the last reset
head_dim_gather = {"bytes": 0}


def _whole_kv(t: torch.Tensor, kv: int, hd: int) -> torch.Tensor:
    """A k or v ring (B, S, KV_local, HD_local) with every kv head and
    every head-dim column: gathered over the model axis where its plan
    split the kv heads or the head dim (the price of decoding a cache
    split on the head dim, which the plan takes when the kv heads do not
    divide the axis)."""
    for dim, full in ((3, hd), (2, kv)):
        if t.shape[dim] != full:
            MA.chunk_of(full, t.shape[dim])
            t = all_gather_cat(t.contiguous(), MA.active(), dim)
            head_dim_gather["bytes"] += t.numel() * t.element_size() * (
                MA.active().size - 1) // MA.active().size
    return t


def _decode_kv(q, k, v, first, cache, pos, seq, cfg: ModelConfig,
               kv_range, kv_index=None):
    """One decode step of a GQA ring on this rank -> (o (B,1,nq,hd) of the
    query heads ``q``, the cache). ``k``, ``v`` (B,1,n,hd) are the new
    key and value of the kv heads from ``first`` (at least the cache
    shard's); the rank writes its kv heads, its head-dim columns and (a
    split ring) its slots of them. The query heads read kv heads
    [kv_range) in their order (``kv_index``, each query head's kv head
    less kv_range[0], where the GQA order would pair them otherwise),
    gathered over the model axis where the shard lacks them."""
    kv, hd = cfg.num_kv_heads, cfg.head_dim
    k_cache, v_cache = cache["k"], cache["v"]
    c0, c1 = MA.chunk_of(kv, k_cache.shape[2])
    d0, d1 = MA.chunk_of(hd, k_cache.shape[3])
    ring_write(k_cache, k[:, 0, c0 - first:c1 - first, d0:d1], pos, seq)
    ring_write(v_cache, v[:, 0, c0 - first:c1 - first, d0:d1], pos, seq)
    valid = ring_valid(k_cache.shape[1], pos, seq, q.device)
    kc, vc = k_cache, v_cache
    n0, n1 = kv_range
    if not (c0 <= n0 and n1 <= c1) or d1 - d0 != hd:
        kc, vc, c0 = _whole_kv(kc, kv, hd), _whole_kv(vc, kv, hd), 0
    kc, vc = kc[:, :, n0 - c0:n1 - c0], vc[:, :, n0 - c0:n1 - c0]
    if kv_index is not None:
        idx = torch.tensor(kv_index, device=q.device)
        kc, vc = kc.index_select(2, idx), vc.index_select(2, idx)
    o = _ring_attend(q.contiguous(), kc.contiguous(), vc.contiguous(),
                     valid, seq)
    return o, {"k": k_cache, "v": v_cache}


# --------------------------------------------------------------------------
# GQA attention block
# --------------------------------------------------------------------------
def attn_init(init: ParamInit, cfg: ModelConfig, cross: bool = False
              ) -> dict:
    """The GQA block's weights; ``cross`` adds whisper's decoder
    cross-attention (``cross_norm`` and ``cwq/cwk/cwv/cwo``)."""
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "norm": init.full((d,), 1.0),
        "wq": dense_init(init, (d, h * hd)),
        "wk": dense_init(init, (d, kv * hd)),
        "wv": dense_init(init, (d, kv * hd)),
        "wo": dense_init(init, (h * hd, d), scale=1.0 / math.sqrt(h * hd)),
    }
    if cfg.qkv_bias:
        p["bq"] = init.full((h * hd,), 0.0)
        p["bk"] = init.full((kv * hd,), 0.0)
        p["bv"] = init.full((kv * hd,), 0.0)
    if cross:
        p["cross_norm"] = init.full((d,), 1.0)
        p["cwq"] = dense_init(init, (d, h * hd))
        p["cwk"] = dense_init(init, (d, kv * hd))
        p["cwv"] = dense_init(init, (d, kv * hd))
        p["cwo"] = dense_init(init, (h * hd, d),
                              scale=1.0 / math.sqrt(h * hd))
    return p


def attn_cache_init(cfg: ModelConfig, batch: int, seq_len: int, window: int,
                    dtype=torch.bfloat16, device=None,
                    lead: Sequence[int] = ()) -> dict:
    size = min(window, seq_len) if window > 0 else seq_len
    shape = tuple(lead) + (batch, size, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_apply(p, x, *, cfg: ModelConfig, mode: str, cache=None, pos=None,
               window: int = 0, causal: bool = True, chunked: bool = True,
               enc_out=None, seq: Optional[SeqSplit] = None):
    """GQA attention. In decode mode, (cache, pos) hold/advance the KV ring.

    The new key and value are written IN PLACE at slot ``pos % size`` of
    each row of the caller's cache (the reference rebuilds the whole cache
    each step with a one-hot select; the cache that results is the same,
    without a second copy of it), and the returned cache holds the same
    tensors.

    ``enc_out`` (B, Se, d), in either mode: whisper's decoder
    cross-attention after the self-attention (``_cross_core``), its keys
    and values projected from ``enc_out`` on every call.

    ``seq``: the ring's slots are split over ranks (``SeqSplit``): the
    rank that holds slot ``pos % size`` writes it, each rank attends over
    its slots with the decode kernel's softmax statistics and the ranks'
    outputs are merged (``merge_decode``). A ring split on the head dim
    (or on kv heads other than the ones the query heads read) over the
    model axis is gathered whole for the step (``_decode_kv``)."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if MA.active() is not None and p["wq"].shape[-1] != h * hd:
        return _attn_apply_tp(p, x, cfg=cfg, mode=mode, cache=cache, pos=pos,
                              window=window, causal=causal, chunked=chunked,
                              enc_out=enc_out, seq=seq)
    xn = MA.norm_in(x, p["norm"], cfg.norm_eps)
    b, s, _ = xn.shape
    q, k, v = xn @ p["wq"], xn @ p["wk"], xn @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)

    if mode == "decode":
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
        o, cache = _decode_kv(q, k, v, 0, cache, pos, seq, cfg, (0, kv))
    else:
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = _prefill_core(q, k, v, causal=causal, window=window,
                          chunked=chunked)

    y = MA.seq_chunk(o.reshape(b, s, h * hd) @ p["wo"])

    if enc_out is not None:                    # whisper decoder cross-attn
        xn2 = MA.norm_in(x + y, p["cross_norm"], cfg.norm_eps)
        se = enc_out.shape[1]
        cq = (xn2 @ p["cwq"]).reshape(b, s, h, hd)
        ck = (enc_out @ p["cwk"]).reshape(b, se, kv, hd)
        cv = (enc_out @ p["cwv"]).reshape(b, se, kv, hd)
        co = _cross_core(cq, ck, cv)
        y = y + MA.seq_chunk(co.reshape(b, s, h * hd) @ p["cwo"])
    return y, cache


def _tp_heads(xq, xkv, p, names, cfg: ModelConfig, cache_kv=None):
    """This rank's query heads and the kv heads they read, projected from
    ``xq`` and ``xkv`` by the weights ``names`` (q, k, v and their biases)
    of ``p`` -> (share, q (B,S,h1-h0,D), k and v (B,Sk,n,D), the first of
    their n kv heads): the share's [k0, k1), and the kv heads
    ``cache_kv`` of a cache shard where given."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wq, wk, wv, bq, bk, bv = names
    q, qcols = MA.project(xq, p[wq], p.get(bq), h * hd)
    share = MA.head_share(h, kv, hd, *qcols)
    need = (share.k0, share.k1)
    if cache_kv is not None:
        need = (min(need[0], cache_kv[0]), max(need[1], cache_kv[1]))
    k, kcols = MA.project(xkv, p[wk], p.get(bk), kv * hd)
    v, vcols = MA.project(xkv, p[wv], p.get(bv), kv * hd)
    return (share, MA.take_heads(q, qcols, (share.h0, share.h1), hd),
            MA.take_heads(k, kcols, need, hd),
            MA.take_heads(v, vcols, need, hd), need[0])


def _tp_kv(t: torch.Tensor, share, first: int) -> torch.Tensor:
    """kv heads [k0, k1) of ``t`` (its heads from ``first``), in the order
    the share's query heads read them, contiguous (what the kernels
    take)."""
    t = t[:, :, share.k0 - first:share.k1 - first]
    if share.kv_index is not None:
        t = t.index_select(2, torch.tensor(share.kv_index, device=t.device))
    return t.contiguous()


def _tp_out(o: torch.Tensor, share, wo: torch.Tensor, hd: int
            ) -> torch.Tensor:
    """This rank's columns of the heads' output through its rows of
    ``wo``, summed over the ranks."""
    b, s = o.shape[:2]
    lo, hi = share.lo, share.hi
    if wo.shape[0] != hi - lo:
        raise ValueError(f"wo holds {wo.shape[0]} rows where this rank's "
                         f"query columns are {hi - lo}: the plan must "
                         f"shard wo's rows as wq's columns")
    flat = o.reshape(b, s, -1)[..., lo - share.h0 * hd:hi - share.h0 * hd]
    return MA.row_product(flat, wo)


def _attn_apply_tp(p, x, *, cfg: ModelConfig, mode: str, cache, pos,
                   window: int, causal: bool, chunked: bool, enc_out,
                   seq=None):
    """``attn_apply`` on one rank of a model axis, its weights this rank's
    shards (``model_axis``): the normed input enters by ``copy``, each
    rank computes its query heads (``model_axis.head_share``) against the
    kv heads they read, on the kernels as one rank would, and ``wo``'s
    partial products are summed. In decode the new key and value go to
    the kv heads (and head-dim columns) this rank's cache holds, which
    are gathered where the query heads read more (``_decode_kv``). Where
    the ring's slots are split over the model axis too (``seq`` over
    "model": the reference's ``cache_seq_shard``), every query head
    attends this rank's slots (q, k and v gathered whole), the ranks'
    outputs are merged, and each rank keeps its own heads' columns for
    its rows of ``wo``."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = MA.copy(MA.norm_in(x, p["norm"], cfg.norm_eps))
    b, s, _ = xn.shape
    names = ("wq", "wk", "wv", "bq", "bk", "bv")
    if mode == "decode" and seq is not None and "model" in seq.axes:
        q, (lo, hi) = MA.project(xn, p["wq"], p.get("bq"), h * hd)
        q = MA.whole(q, h * hd).reshape(b, s, h, hd)
        k = MA.whole(MA.project(xn, p["wk"], p.get("bk"), kv * hd)[0],
                     kv * hd).reshape(b, s, kv, hd)
        v = MA.whole(MA.project(xn, p["wv"], p.get("bv"), kv * hd)[0],
                     kv * hd).reshape(b, s, kv, hd)
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
        o, cache = _decode_kv(q, k, v, 0, cache, pos, seq, cfg, (0, kv))
        if p["wo"].shape[0] != hi - lo:
            raise ValueError(f"wo holds {p['wo'].shape[0]} rows where this "
                             f"rank's query columns are {hi - lo}")
        y = MA.row_product(o.reshape(b, s, h * hd)[..., lo:hi], p["wo"])
    elif mode == "decode":
        c0, c1 = MA.chunk_of(kv, cache["k"].shape[2])
        share, q, k, v, first = _tp_heads(xn, xn, p, names, cfg, (c0, c1))
        q = apply_rope(q, pos[:, None], cfg.rope_theta)
        k = apply_rope(k, pos[:, None], cfg.rope_theta)
        o, cache = _decode_kv(q, k, v, first, cache, pos, seq, cfg,
                              (share.k0, share.k1), share.kv_index)
        y = _tp_out(o, share, p["wo"], hd)
    else:
        share, q, k, v, first = _tp_heads(xn, xn, p, names, cfg)
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = _prefill_core(q.contiguous(), _tp_kv(k, share, first),
                          _tp_kv(v, share, first), causal=causal,
                          window=window, chunked=chunked)
        y = _tp_out(o, share, p["wo"], hd)

    if enc_out is not None:                    # whisper decoder cross-attn
        xn2 = MA.copy(MA.norm_in(x + y, p["cross_norm"], cfg.norm_eps))
        share, cq, ck, cv, first = _tp_heads(
            xn2, MA.copy(enc_out), p,
            ("cwq", "cwk", "cwv", "cbq", "cbk", "cbv"), cfg)
        co = _cross_core(cq.contiguous(), _tp_kv(ck, share, first),
                         _tp_kv(cv, share, first))
        y = y + _tp_out(co, share, p["cwo"], hd)
    return y, cache


def _cross_core(q, k, v):
    """Non-causal attention of q (B,S,H,D) over the encoder's k, v
    (B,Se,KV,D), the reference's ``sdpa_full(causal=False)``: on a CUDA
    tensor one query (decode) runs the decode kernel with every one of the
    Se slots valid, more run the prefill kernel at a key length Se unlike
    S (under autograd through ``FlashAttention``, whose backward is the
    backward kernels at Se); a CPU tensor runs ``sdpa_full`` under plain
    autograd, as the reference."""
    if _on_kernels(q):
        if q.shape[1] == 1:
            valid = torch.ones(k.shape[:2], dtype=torch.bool,
                               device=q.device)
            return ops.flash_decode(q, k, v, valid)
        return ops.flash_attention(q, k, v, causal=False)
    return sdpa_full(q, k, v, causal=False, window=0)


# --------------------------------------------------------------------------
# MLA attention (deepseek-v2)
# --------------------------------------------------------------------------
def mla_init(init: ParamInit, cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r, qr = cfg.kv_lora_rank, cfg.q_lora_rank
    p = {"norm": init.full((d,), 1.0)}
    if qr > 0:
        p["w_dq"] = dense_init(init, (d, qr))
        p["q_norm"] = init.full((qr,), 1.0)
        p["w_uq"] = dense_init(init, (qr, h * (dn + dr)))
    else:
        p["w_q"] = dense_init(init, (d, h * (dn + dr)))
    p["w_dkv"] = dense_init(init, (d, r))
    p["kv_norm"] = init.full((r,), 1.0)
    p["w_uk"] = dense_init(init, (r, h * dn))
    p["w_uv"] = dense_init(init, (r, h * dv))
    p["w_kr"] = dense_init(init, (d, dr))
    p["wo"] = dense_init(init, (h * dv, d), scale=1.0 / math.sqrt(h * dv))
    return p


def mla_cache_init(cfg: ModelConfig, batch: int, seq_len: int,
                   dtype=torch.bfloat16, device=None,
                   lead: Sequence[int] = ()) -> dict:
    """The latent ring: ``c_kv`` (B,S,r) and ``k_rope`` (B,S,dr) after
    RoPE, stacked under ``lead`` as ``attn_cache_init``'s."""
    lead = tuple(lead)
    return {"c_kv": torch.zeros(lead + (batch, seq_len, cfg.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros(lead + (batch, seq_len,
                                          cfg.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def _mla_heads_of(p, cfg: ModelConfig, cache) -> Optional[Tuple[int, int]]:
    """The query heads [h0, h1) this rank computes on a model axis where
    any of MLA's leaves (or its latent cache) is split
    (``model_axis.frac_heads``: whole heads, a boundary head on both ranks
    that share it where the heads do not divide the axis); None on one
    rank or where every leaf is whole."""
    if MA.active() is None:
        return None
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    wq = p["w_uq"] if "w_uq" in p else p["w_q"]
    split = (wq.shape[-1] != h * (dn + dr) or p["w_uk"].shape[-1] != h * dn
             or p["w_uv"].shape[-1] != h * dv or p["wo"].shape[0] != h * dv
             or (cache is not None
                 and cache["c_kv"].shape[-1] != cfg.kv_lora_rank))
    return MA.frac_heads(h) if split else None


def _mla_qkv(p, xn, cfg: ModelConfig, heads=None):
    """q (B,S,H,dn+dr), the latent ``c_kv`` (B,S,r) and the shared rotary
    key (B,S,dr); on a model axis (``heads`` [h0, h1)) q of those heads
    (``model_axis.head_cols``), the replicated down-projections computed
    whole on every rank and entering the rank's heads through
    ``copy``."""
    b, s, _ = xn.shape
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if "w_dq" in p:
        cq, wq = rms_norm(xn @ p["w_dq"], p["q_norm"], cfg.norm_eps), \
            p["w_uq"]
    else:
        cq, wq = xn, p["w_q"]
    c_kv = rms_norm(xn @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)  # (b,s,r)
    k_rope = xn @ p["w_kr"]                                        # (b,s,dr)
    if heads is not None:
        cq, c_kv, k_rope = MA.copy(cq), MA.copy(c_kv), MA.copy(k_rope)
        wq = MA.head_cols(wq, cfg.num_heads * (dn + dr), heads[0],
                          heads[1], dn + dr)
    q = (cq @ wq).reshape(b, s, -1, dn + dr)
    return q, c_kv, k_rope


def _mla_up(p, cfg: ModelConfig, heads=None):
    """``w_uk`` (r, H*dn) and ``w_uv`` (r, H*dv), or the columns of this
    rank's heads."""
    if heads is None:
        return p["w_uk"], p["w_uv"]
    h, (h0, h1) = cfg.num_heads, heads
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    return (MA.head_cols(p["w_uk"], h * dn, h0, h1, dn),
            MA.head_cols(p["w_uv"], h * dv, h0, h1, dv))


def _mla_heads(c_kv, k_rope, w_uk, w_uv, cfg: ModelConfig):
    """Per-head keys (B,S,H,dn+dr) rebuilt from the latent ``c_kv``
    (B,S,r) and the shared rotary key ``k_rope`` (B,S,dr), and the values
    (B,S,H,dv) zero-padded to dn + dr, so that both attention cores take
    them; H the heads of ``w_uk`` (r, H*dn) and ``w_uv`` (r, H*dv). Each
    temporary is freed once it is consumed (at deepseek's full width and
    32,768 slots a layer's keys are 6.4 GB)."""
    b, s, _ = c_kv.shape
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    h = w_uk.shape[-1] // dn
    k_nope = (c_kv @ w_uk).reshape(b, s, h, dn)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                       -1)
    del k_nope
    v = (c_kv @ w_uv).reshape(b, s, h, dv)
    v_pad = F.pad(v, (0, dn + dr - dv))
    return k_full, v_pad


def mla_apply(p, x, *, cfg: ModelConfig, mode: str, cache=None, pos=None,
              window: int = 0, absorbed: bool = False, chunked: bool = True,
              seq: Optional[SeqSplit] = None, **_):
    """MLA. ``absorbed=False`` is the naive form that rebuilds per-head K/V
    from the latent cache; ``absorbed=True`` attends in the kv_lora latent
    space (decode only, plain torch: no kernel takes its D = r + dr and
    H query heads over one latent head).

    Prefill attends over keys of width dn + dr with the values padded to
    it (sliced back to dv after): on a CUDA tensor the prefill kernel at
    any S, on a CPU tensor the reference's branch (``sdpa_chunked`` above
    2048 positions, ``sdpa_full`` up to it). Decode writes the new latent
    and rotary key IN PLACE at slot ``pos % size`` of the caller's cache,
    as ``attn_apply`` does, and the naive form runs ``sdpa_decode`` over
    the rebuilt heads: the decode kernel on a CUDA tensor, its plain
    version on the CPU. Both scale by 1/sqrt(dn + dr), the reference's.

    On a model axis (``model_axis``) each rank computes the query heads of
    its columns of ``w_uq`` (``w_q``), ``w_uk`` and ``w_uv`` and rows of
    ``wo`` (a replicated one sliced), from ``c_kv`` and ``k_rope``
    computed whole on every rank; ``wo``'s partial products are summed.
    Where the heads do not divide the axis, a rank computes every head its
    columns touch, whole (``model_axis.frac_heads``, ``head_cols``), and
    passes only its own columns into ``wo`` (``frac_cols``).
    A latent cache split on r holds this rank's chunk of every slot: the
    rank writes its chunk and gathers the ring's latent for the rebuild
    (``k_rope``, replicated, every rank writes whole).

    ``seq``: the latent ring's slots are split over ranks (``SeqSplit``,
    deepseek's long_500k over "data", or the reference's
    ``cache_seq_shard`` over "model"): the rank holding slot ``pos %
    size`` writes it, each rank rebuilds K and V of its own slots and
    runs the decode kernel with statistics (the absorbed form: its plain
    einsums with the same statistics), and the ranks' outputs are merged
    (``merge_decode``). Where the slots are split over the model axis
    that also splits the heads, every head attends this rank's slots (q
    and the up-projections gathered whole) and each rank keeps its own
    heads after the merge."""
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    heads = _mla_heads_of(p, cfg, cache if mode == "decode" else None)
    xn = MA.norm_in(x, p["norm"], cfg.norm_eps)
    b, s, _ = xn.shape
    q, c_kv, k_rope = _mla_qkv(p, xn, cfg, heads)
    hl = q.shape[2]
    w_uk, w_uv = _mla_up(p, cfg, heads)

    if mode == "decode":
        ckv_c, kr_c = cache["c_kv"], cache["k_rope"]
        if seq is not None and "model" in seq.axes and heads is not None:
            # every head attends this rank's slots: q and the up
            # projections whole, this rank's heads kept after the merge
            q = _mla_qkv(p, xn, cfg, (0, h))[0]
            w_uk, w_uv = (MA.whole(p["w_uk"], h * dn),
                          MA.whole(p["w_uv"], h * dv))
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = apply_rope(q_rope, pos[:, None], cfg.rope_theta)
        k_rope = apply_rope(k_rope[:, :, None, :], pos[:, None],
                            cfg.rope_theta)[:, :, 0]
        ring_write(ckv_c, MA.mine(c_kv[:, 0], ckv_c.shape[-1]), pos, seq)
        ring_write(kr_c, k_rope[:, 0], pos, seq)
        valid = ring_valid(ckv_c.shape[1], pos, seq, x.device)
        # the ring's whole latent (gathered where the cache is split)
        ckv = MA.whole(ckv_c, cfg.kv_lora_rank) if heads else ckv_c
        na = q.shape[2]                          # the heads attending
        if absorbed:
            scale = 1.0 / math.sqrt(dn + dr)
            ckv = ckv.to(q.dtype)
            # fold W_uk into q: attend directly in the r-dim latent space
            w_uk = w_uk.reshape(-1, na, dn)                     # (r,h,dn)
            q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
            s_lat = torch.einsum("bqhr,bkr->bhqk", q_lat, ckv)
            s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope,
                                  kr_c.to(q.dtype))
            att = (s_lat + s_rope).to(torch.float32) * scale
            att = torch.where(valid[:, None, None, :], att, NEG)
            if seq is None:
                pr = torch.softmax(att, -1).to(q.dtype)
                o_lat = torch.einsum("bhqk,bkr->bqhr", pr, ckv)
            else:
                # this rank's slots' softmax statistics, then the merge
                m = att.amax(-1)
                pr = torch.exp(att - m[..., None])
                l_ = pr.sum(-1)
                o_lat = torch.einsum("bhqk,bkr->bqhr", pr.to(q.dtype), ckv)
                o_lat = o_lat.to(torch.float32) / l_.transpose(1, 2)[
                    ..., None]
                o_lat = merge_decode(o_lat, (m + torch.log(l_))[:, :, 0],
                                     seq.ranks, q.dtype)
            w_uv = w_uv.reshape(-1, na, dv)                     # (r,h,dv)
            o = torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv)
        else:
            k_full, v_pad = _mla_heads(ckv.to(q.dtype), kr_c.to(q.dtype),
                                       w_uk, w_uv, cfg)
            q_full = torch.cat([q_nope, q_rope], -1)
            o = _ring_attend(q_full, k_full, v_pad, valid, seq)[..., :dv]
            del k_full, v_pad
        del ckv
        if na != hl:                             # this rank's heads
            o = o[:, :, heads[0]:heads[1]]
        cache = {"c_kv": ckv_c, "k_rope": kr_c}
    else:
        positions = torch.arange(s, device=x.device)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        k_rope = apply_rope(k_rope[:, :, None, :], positions,
                            cfg.rope_theta)[:, :, 0]
        k_full, v_pad = _mla_heads(c_kv, k_rope, w_uk, w_uv, cfg)
        q_full = torch.cat([q_nope, q_rope], -1)
        o = _prefill_core(q_full, k_full, v_pad, causal=True, window=window,
                          chunked=chunked)
        del k_full, v_pad
        o = o[..., :dv]
    o = o.reshape(b, s, hl * dv)
    if heads is None:
        return MA.seq_chunk(o @ p["wo"]), cache
    # this rank's columns of its heads' output, into its rows of wo
    c0, c1 = MA.frac_cols(h * dv, p["wo"].shape[0])
    wo = MA.part(p["wo"], h * dv, c0, c1, dim=0)
    return MA.row_product(o[..., c0 - heads[0] * dv:c1 - heads[0] * dv],
                          wo), cache


# --------------------------------------------------------------------------
# FFN (dense)
# --------------------------------------------------------------------------
def ffn_init(init: ParamInit, cfg: ModelConfig, d_ff: Optional[int] = None
             ) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"norm": init.full((d,), 1.0),
            "w_gate": dense_init(init, (d, f)),
            "w_up": dense_init(init, (d, f)),
            "w_down": dense_init(init, (f, d), scale=1.0 / math.sqrt(f))}


def _gated(xn, w_gate, w_up, w_down, f: int, act: str):
    """``(act(xn @ w_gate) * (xn @ w_up)) @ w_down`` of width ``f``; on a
    model axis (``model_axis``) with ``w_gate`` and ``w_up``
    column-sharded and ``w_down`` row-sharded, each rank's product summed
    over the ranks."""
    if MA.active() is not None and w_down.shape[0] != f:
        xn = MA.copy(xn)
        return MA.row_product(act_fn(act)(xn @ w_gate) * (xn @ w_up),
                              w_down)
    return MA.seq_chunk((act_fn(act)(xn @ w_gate) * (xn @ w_up)) @ w_down)


def ffn_apply(p, x, *, cfg: ModelConfig):
    """The gated FFN (tensor parallel on a model axis: ``_gated``)."""
    xn = MA.norm_in(x, p["norm"], cfg.norm_eps)
    return _gated(xn, p["w_gate"], p["w_up"], p["w_down"], cfg.d_ff,
                  cfg.act)


# --------------------------------------------------------------------------
# MoE: top-k routing into per-expert capacity slots (GShard), the port of
# the reference's einsum dispatch with index copies
# --------------------------------------------------------------------------
def moe_init(init: ParamInit, cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    p = {"norm": init.full((d,), 1.0),
         "router": dense_init(init, (d, e), scale=0.02),
         # fan-in of a stacked (e, d, f) leaf is e, as the reference's
         "we_gate": dense_init(init, (e, d, f)),
         "we_up": dense_init(init, (e, d, f)),
         "we_down": dense_init(init, (e, f, d), scale=1.0 / math.sqrt(f))}
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["ws_gate"] = dense_init(init, (d, fs))
        p["ws_up"] = dense_init(init, (d, fs))
        p["ws_down"] = dense_init(init, (fs, d), scale=1.0 / math.sqrt(fs))
    return p


class MoERoute(NamedTuple):
    """Where ``moe_apply`` sends each (token, choice) of the first
    ``groups * group_len`` tokens (m of them; the tail gets no MoE output).
    ``probs`` (m, e) f32; ``topi`` (m, k) experts by descending probability;
    ``topv`` (m, k) their renormalised weights in the compute dtype;
    ``pos`` (m, k) the pair's place in its expert's slots of its group,
    counted token-major, then by choice; ``keep`` (m, k) ``pos < cap``."""
    probs: torch.Tensor
    topi: torch.Tensor
    topv: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    cap: int
    groups: int
    group_len: int


def moe_route(p, xn: torch.Tensor, *, cfg: ModelConfig,
              capacity_factor: float = 1.25, group_size: int = 512
              ) -> MoERoute:
    """Routing of the normed tokens ``xn`` (n, d), as the reference's
    ``moe_apply``: ``g = max(n // group_size, 1)`` groups of ``n // g``
    tokens; the router product in the compute dtype, its softmax in f32;
    the top k by a stable descending sort (``jax.lax.top_k``'s order: equal
    probabilities go to the lower expert index first); ``cap =
    max(int(gs * k / e * capacity_factor), 1)``; a choice past its
    expert's ``cap`` slots is dropped."""
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    n = xn.shape[0]
    g = max(n // group_size, 1)
    gs = n // g
    m = g * gs
    probs = torch.softmax((xn[:m] @ p["router"]).to(torch.float32), -1)
    topv, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k].contiguous()
    topv = (topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
            ).to(xn.dtype)
    cap = max(int(gs * k / e * capacity_factor), 1)
    # the pair's place among its expert's pairs in the group: a running
    # count over (token, choice) of each expert's one-hot column
    ids = topi.view(g, gs * k)
    onehot = (ids[..., None] == torch.arange(e, device=xn.device)).to(
        torch.int32)
    pos = torch.cumsum(onehot, 1, dtype=torch.int32).gather(
        -1, ids[..., None])[..., 0].view(m, k).long() - 1
    return MoERoute(probs, topi, topv, pos, pos < cap, cap, g, gs)


def _slot_table(r: MoERoute, e: int, device):
    """-> (dest (m, k): each (token, choice)'s slot, by expert, then group,
    then place; src (e * groups * cap,): the token in each slot, m where
    none is). Dropped pairs all write a spare last entry, cut off."""
    m, k = r.topi.shape
    slots = e * r.groups * r.cap
    group = torch.arange(m, device=device)[:, None] // r.group_len
    dest = (r.topi * r.groups + group) * r.cap + r.pos
    token = torch.arange(m, device=device)[:, None].expand(m, k)
    src = torch.full((slots + 1,), m, dtype=torch.long,
                     device=device).scatter_(
        0, torch.where(r.keep, dest, slots).reshape(-1),
        token.reshape(-1))[:slots]
    return dest, src


def _combine(ye, at, keep, topv):
    """Each token's kept pairs' expert outputs (rows ``at`` of ``ye``),
    weighted by ``topv``, summed in choice order in f32 -> (m, d) f32; a
    pair not kept reads row 0 with weight 0 (every row is finite: an
    empty slot's is 0); choice-major, so that each choice's rows and
    weights are contiguous."""
    at = torch.where(keep, at, 0).t().contiguous()
    w = torch.where(keep, topv.to(torch.float32), 0.0).t()
    acc = torch.zeros((at.shape[1], ye.shape[-1]), dtype=torch.float32,
                      device=ye.device)
    for j in range(at.shape[0]):
        acc.addcmul_(w[j, :, None], ye.index_select(0, at[j]))
    return acc


def _load_balance(r: MoERoute, cfg: ModelConfig):
    """The load-balance term over the routed tokens' top-1 choices, its
    two means averaged over the model ranks where each routes its own
    tokens (``model_axis.mean_over``) and over the data ranks where each
    holds its own rows (``fsdp.mean``)."""
    e = cfg.num_experts
    me = FS.mean(MA.mean_over(r.probs.mean(0)))
    ce = FS.mean(MA.mean_over((r.topi[:, :1] == torch.arange(
        e, device=r.topi.device)).to(torch.float32).mean(0)))
    return cfg.router_aux_loss * e * torch.sum(me * ce)


def moe_apply(p, x, *, cfg: ModelConfig, capacity_factor: float = 1.25,
              group_size: int = 512):
    """The reference's capacity-dropped top-k MoE (``repro.models.layers.
    moe_apply``) -> (y, aux). Each (expert, group, slot) holds at most one
    token, so dispatch is a gather of token rows into the (e, g * cap, d)
    slots (empty slots read a zero row) and the expert products are batched
    GEMMs over the expert axis; combine gathers each kept (token, choice)'s
    expert output and sums the k weighted terms in choice order in f32,
    rounded once. No atomics: the same inputs give the same bits.

    On a model axis (``model_axis``) with the experts split (expert
    parallelism: ``we_*`` sharded on the expert dim), every rank computes
    the whole route from the replicated tokens (the same bits, drops and
    ``aux``), runs the products of its experts' slots only and combines
    its experts' kept terms into an f32 partial in choice order; the
    partials are summed over the ranks before the one rounding. The
    tokens and the weights ``topv`` enter the rank's work through
    ``copy``, so the router's gradient is the whole one, once. Experts
    that do not divide the axis stay replicated and every rank runs them
    all. The shared experts are column- then row-parallel (``_gated``).

    With the batch's rows split over ranks (``fsdp``: "data", or ("pod",
    "data") on two pods), the route is one rank's only where each rank's
    tokens form whole groups of ``group_size``: the load-balance term's
    two means are then averaged over those ranks (``fsdp.mean``). Where
    they do not (a decode step's few rows), the rows are gathered over
    them, every rank routes
    them all as one rank would and keeps its own (no gradient: the train
    step refuses such rows).

    With the sequence split over the model axis (``model_axis.seq_split``)
    each rank routes its own positions (``_moe_own_tokens``)."""
    if MA.seq_split():
        return _moe_own_tokens(p, x, cfg=cfg,
                               capacity_factor=capacity_factor,
                               group_size=group_size)
    b, s, d = x.shape
    e = cfg.num_experts
    lay = FS.active()
    if lay is not None and lay.rows is not None and (b * s) % group_size:
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError(
                f"the MoE's tokens over 'data': {b * s} a rank are no whole "
                f"groups of {group_size} (the one-rank route needs each "
                f"rank's tokens to form whole groups)")
        every = FS.rows_gathered(x)
        with FS.over(None):
            y, aux = moe_apply(p, every, cfg=cfg,
                               capacity_factor=capacity_factor,
                               group_size=group_size)
        return FS.my_rows(y, b), aux
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    flat = xn.reshape(-1, d)
    n = flat.shape[0]
    with torch.profiler.record_function("moe.route"):
        r = moe_route(p, flat, cfg=cfg, capacity_factor=capacity_factor,
                      group_size=group_size)
    m = r.groups * r.group_len
    # this rank's experts [e0, e1) (all of them on one rank)
    e0, e1 = (MA.chunk_of(e, p["we_gate"].shape[0])
              if MA.active() is not None else (0, e))
    spread = e1 - e0 != e
    per = r.groups * r.cap                             # slots an expert
    with torch.profiler.record_function("moe.dispatch"):
        dest, src = _slot_table(r, e, x.device)
        # the token in each slot (m: none, a zero row)
        tokens = MA.copy(flat[:m]) if spread else flat[:m]
        rows = torch.cat([tokens, flat.new_zeros(1, d)])
        xe = rows[src[e0 * per:e1 * per]].view(e1 - e0, per, d)
    with torch.profiler.record_function("moe.experts"):
        he = act_fn(cfg.act)(torch.bmm(xe, p["we_gate"])) \
            * torch.bmm(xe, p["we_up"])
        ye = torch.bmm(he, p["we_down"]).view((e1 - e0) * per, d)
    with torch.profiler.record_function("moe.combine"):
        # another rank's pair reads as a dropped one
        keep, topv = r.keep, r.topv
        if spread:
            keep = keep & (r.topi >= e0) & (r.topi < e1)
            topv = MA.copy(topv)
        acc = _combine(ye, dest - e0 * per, keep, topv)
        if spread:
            acc = MA.reduce(acc)
        y = acc.to(x.dtype)
        if m < n:
            y = torch.cat([y, y.new_zeros(n - m, d)])
    y = y.view(b, s, d)
    if cfg.num_shared_experts:
        y = y + _gated(xn, p["ws_gate"], p["ws_up"], p["ws_down"],
                       cfg.d_ff * cfg.num_shared_experts, cfg.act)
    return y, _load_balance(r, cfg)


def _moe_own_tokens(p, x, *, cfg: ModelConfig, capacity_factor: float,
                    group_size: int):
    """``moe_apply`` where ``x`` (B, S/m, d) holds this model rank's chunk
    of every row's positions (sequence parallelism): the rank normalizes
    and routes its own tokens (``moe_route``: the one-rank route only
    where a row's chunk is whole groups of ``group_size``, else
    ``ValueError``), and the slots go to the ranks that hold their
    experts by ``model_axis.exchange`` (an all-to-all): each rank runs its
    experts over every rank's slots for them, the outputs come back the
    same way, and each rank combines its own tokens' kept terms in choice
    order in f32, rounded once, as one rank does (no sum over the ranks).
    Experts that do not divide the axis stay replicated: every rank runs
    them all on its own slots. The norm, the router and replicated
    experts enter through ``copy`` (each rank's gradient is its tokens');
    the shared experts run on the positions gathered (``norm_in``'s way,
    their output reduce-scattered); the load-balance term's two means are
    averaged over the model ranks (``model_axis.mean_over``) and then, as
    on one pod, over "data"."""
    b, s, d = x.shape
    e = cfg.num_experts
    if s % group_size:
        raise ValueError(
            f"the MoE over a sequence split over 'model': {s} positions a "
            f"row a rank are no whole groups of {group_size} (the one-rank "
            f"route needs each rank's chunk of a row to form whole groups)")
    xn = rms_norm(x, MA.copy(p["norm"]), cfg.norm_eps)
    flat = xn.reshape(-1, d)
    with torch.profiler.record_function("moe.route"):
        r = moe_route({"router": MA.copy(p["router"])}, flat, cfg=cfg,
                      capacity_factor=capacity_factor, group_size=group_size)
    per = r.groups * r.cap                    # this rank's slots an expert
    e0, e1 = MA.chunk_of(e, p["we_gate"].shape[0])
    spread = e1 - e0 != e
    w_gate, w_up, w_down = ((p["we_gate"], p["we_up"], p["we_down"])
                            if spread else
                            tuple(MA.copy(p[n]) for n in
                                  ("we_gate", "we_up", "we_down")))
    with torch.profiler.record_function("moe.dispatch"):
        dest, src = _slot_table(r, e, x.device)
        xe = torch.cat([flat, flat.new_zeros(1, d)])[src].view(e, per, d)
        if spread:
            # every rank's slots of this rank's experts: (n_ranks, e/m,
            # per, d) -> expert-major
            ranks = MA.active().size
            xe = MA.exchange(xe).view(ranks, e1 - e0, per, d).transpose(
                0, 1).reshape(e1 - e0, ranks * per, d)
    with torch.profiler.record_function("moe.experts"):
        he = act_fn(cfg.act)(torch.bmm(xe, w_gate)) * torch.bmm(xe, w_up)
        ye = torch.bmm(he, w_down)
        if spread:
            ye = MA.exchange(ye.view(e1 - e0, ranks, per, d).transpose(
                0, 1).reshape(e, per, d))
        ye = ye.reshape(e * per, d)
    with torch.profiler.record_function("moe.combine"):
        y = _combine(ye, dest, r.keep, r.topv).to(x.dtype).view(b, s, d)
    if cfg.num_shared_experts:
        y = y + _gated(MA.seq_whole(xn), p["ws_gate"], p["ws_up"],
                       p["ws_down"], cfg.d_ff * cfg.num_shared_experts,
                       cfg.act)
    return y, _load_balance(r, cfg)


# --------------------------------------------------------------------------
# Mamba (jamba's SSM mixer)
# --------------------------------------------------------------------------
def mamba_init(init: ParamInit, cfg: ModelConfig) -> dict:
    d, di, st, cw = (cfg.d_model, cfg.d_inner, cfg.ssm_state_dim,
                     cfg.ssm_conv_width)
    dt_rank = max(d // 16, 1)
    a_log = torch.log(torch.arange(1, st + 1, dtype=torch.float32,
                                   device=init.device)).expand(di, st)
    return {
        "norm": init.full((d,), 1.0),
        "w_in": dense_init(init, (d, 2 * di)),
        "conv_w": dense_init(init, (cw, di), scale=1.0 / math.sqrt(cw)),
        "conv_b": init.full((di,), 0.0),
        "w_x": dense_init(init, (di, dt_rank + 2 * st)),
        "w_dt": dense_init(init, (dt_rank, di)),
        "dt_bias": init.full((di,), -4.6),           # softplus^-1(0.01)
        "A_log": init.full((di, st), 0.0).copy_(a_log),
        "D": init.full((di,), 1.0),
        "w_out": dense_init(init, (di, d), scale=1.0 / math.sqrt(di)),
    }


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None, lead: Sequence[int] = ()) -> dict:
    """The last ``conv_width - 1`` inputs of the convolution (B,cw-1,di)
    and the SSM state (B,di,state), f32 as the reference's whatever the
    cache dtype, stacked under ``lead``."""
    lead = tuple(lead)
    di, st, cw = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_conv_width
    return {"conv": torch.zeros(lead + (batch, cw - 1, di), dtype=dtype,
                                device=device),
            "ssm": torch.zeros(lead + (batch, di, st), dtype=dtype,
                               device=device)}


def _scan_doubling(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the pairs (a_t, b_t) under the
    reference's combine ((al, bl), (ar, br)) -> (al * ar, bl * ar + br):
    Hillis-Steele doubling, log2(len) steps of whole-tensor products
    (``jax.lax.associative_scan``'s counterpart; not the same tree, so the
    rounding differs in the last bits). -> (prod a, h) with h_t = a_t
    h_{t-1} + b_t from h_{-1} = 0."""
    n, step = a.shape[1], 1
    while step < n:
        al, bl = a[:, :-step], b[:, :-step]
        ar, br = a[:, step:], b[:, step:]
        a = torch.cat([a[:, :step], al * ar], 1)
        b = torch.cat([b[:, :step], bl * ar + br], 1)
        step *= 2
    return a, b


def _selective_scan(u, dt, A, B, C, D, chunk: int = 256):
    """h_t = exp(dt A) h_{t-1} + dt B_t u_t ; y_t = C_t.h_t + D u_t.
    u:(b,s,di) dt:(b,s,di) A:(di,st) B,C:(b,s,st).

    The reference's chunking (``nch = max(s // chunk, 1)`` chunks of
    ``s // nch``), which needs ``s`` to be ``nch`` whole chunks: another
    length raises ``ValueError``, as the reference's reshape does. The
    chunks run in order, the state carried from one to the next; inside
    a chunk ``_scan_doubling``. ``dA`` and ``dBu`` (b, chunk, di, st) are
    made one chunk at a time (the same numbers elementwise as the
    reference's whole-sequence tensors, which at jamba's width and 32,768
    tokens would be 34 GB each)."""
    b, s, di = u.shape
    nch = max(s // chunk, 1)
    chunk = s // nch
    if nch * chunk != s:
        raise ValueError(
            f"_selective_scan: length {s} is not {nch} chunks of {chunk} "
            f"(the reference's chunking cannot run it either)")
    # the state in exp(dt A)'s dtype, from zero, as the reference's
    h = torch.zeros((b, di, A.shape[1]),
                    dtype=torch.promote_types(dt.dtype, A.dtype),
                    device=u.device)
    ys = []
    for n in range(nch):
        sl = slice(n * chunk, (n + 1) * chunk)
        dtc = dt[:, sl, :, None]
        da = torch.exp(dtc * A)                            # (b,c,di,st)
        dbu = dtc * B[:, sl, None, :] * u[:, sl, :, None]
        aa, hh = _scan_doubling(da, dbu)
        del da, dbu
        hh = hh + aa * h[:, None]                          # inject carry
        del aa
        ys.append(torch.einsum("bcds,bcs->bcd", hh, C[:, sl]))
        h = hh[:, -1]
        del hh
    y = torch.cat(ys, 1)
    return y + u * D


def _mamba_inner(p, xn, cfg: ModelConfig):
    """-> (u, z, the leaves of the rank's channels): ``xn @ w_in`` split
    into the convolution's input u and the gate z (B,S,di), and
    ``conv_w``, ``conv_b``, ``w_x``, ``w_dt``, ``dt_bias``, ``A_log``,
    ``D`` and ``w_out``. On a model axis with ``d_inner`` split
    (``model_axis``) each rank takes its chunk [lo, hi) of the channels:
    a column split of ``w_in`` holds [u | z] by columns (at 2 ranks one
    rank all of u, the other all of z), so ``xn @ w_in`` is gathered and
    both halves' chunk taken; a replicated leaf is sliced (``part``)."""
    di = cfg.d_inner
    names = ("conv_w", "conv_b", "w_x", "w_dt", "dt_bias", "A_log", "D",
             "w_out")
    if MA.active() is None or p["w_out"].shape[0] == di:
        xz = xn @ p["w_in"]
        return (xz[..., :di], xz[..., di:]) + tuple(p[k] for k in names)
    lo, hi = MA.chunk_of(di, p["w_out"].shape[0])
    xc = MA.copy(xn)
    if p["w_in"].shape[-1] == 2 * di:
        w_in = MA.copy(p["w_in"])
        u, z = xc @ w_in[:, lo:hi], xc @ w_in[:, di + lo:di + hi]
    else:
        xz = MA.gather(xc @ p["w_in"], -1, summed=True)
        u, z = xz[..., lo:hi], xz[..., di + lo:di + hi]
    dim = {"w_x": 0, "A_log": 0, "w_out": 0}
    return (u, z) + tuple(MA.part(p[k], di, lo, hi, dim.get(k, -1))
                          for k in names)


def mamba_apply(p, x, *, cfg: ModelConfig, mode: str, cache=None, **_):
    """Mamba -> (y, cache). Prefill: the causal depthwise convolution over
    the sequence and ``_selective_scan``; the cache (if any) is returned
    as it came, as the reference does. Decode: one step from ``cache``
    (``conv``, ``ssm``), whose tensors get the new states IN PLACE
    (``copy_``: the reference returns new ones), with the reference's
    casts: the conv state read as the compute dtype, the SSM state read
    in the dtype of ``exp(dt A)`` and both stored back in theirs.

    On a model axis (``_mamba_inner``) each rank runs the convolution and
    the scan on its chunk of ``d_inner`` (its caches' chunk: ``cache_plan``
    splits them there); ``dbc = u @ w_x`` is a row-parallel partial sum
    that every rank then reads (``model_axis.row_product(shared=True)``),
    and ``w_out``'s partial products are summed."""
    st, cw = cfg.ssm_state_dim, cfg.ssm_conv_width
    dt_rank = max(cfg.d_model // 16, 1)
    xn = MA.norm_in(x, p["norm"], cfg.norm_eps)
    b, s, _ = xn.shape
    u, z, conv_w, conv_b, w_x, w_dt, dt_bias, a_log, d_skip, w_out = \
        _mamba_inner(p, xn, cfg)
    split = w_out.shape[0] != cfg.d_inner

    def project(uc):
        dbc = MA.row_product(uc, w_x, shared=True) if split else uc @ w_x
        dt = F.softplus(dbc[..., :dt_rank] @ w_dt + dt_bias)
        return dt, dbc[..., dt_rank:dt_rank + st], dbc[..., dt_rank + st:]

    if mode == "decode":
        if cache["ssm"].shape[-2] != u.shape[-1]:
            raise ValueError(f"an SSM cache of {cache['ssm'].shape[-2]} "
                             f"channels where this rank runs "
                             f"{u.shape[-1]}")
        conv_state = torch.cat([cache["conv"],
                                u.to(cache["conv"].dtype)], 1)
        uc = torch.einsum("bwd,wd->bd", conv_state.to(u.dtype),
                          conv_w) + conv_b
        uc = F.silu(uc)[:, None]                           # (b,1,di)
        dt, B, C = project(uc)
        A = -torch.exp(a_log)
        dA = torch.exp(dt[:, 0, :, None] * A)              # (b,di,st)
        h = cache["ssm"].to(dA.dtype) * dA \
            + dt[:, 0, :, None] * B[:, 0, None, :] * uc[:, 0, :, None]
        y = torch.einsum("bds,bs->bd", h, C[:, 0])[:, None] + uc * d_skip
        cache["conv"].copy_(conv_state[:, 1:])
        cache["ssm"].copy_(h)
    else:
        upad = F.pad(u, (0, 0, cw - 1, 0))
        uc = sum(upad[:, i:i + s] * conv_w[i] for i in range(cw)) + conv_b
        uc = F.silu(uc)
        dt, B, C = project(uc)
        A = -torch.exp(a_log)
        y = _selective_scan(uc, dt, A, B, C, d_skip)
    y = y * F.silu(z)
    return (MA.row_product(y, w_out) if split
            else MA.seq_chunk(y @ w_out)), cache


# --------------------------------------------------------------------------
# RWKV6 (Finch) time mix: linear attention with a data-dependent decay
# --------------------------------------------------------------------------
def rwkv_init(init: ParamInit, cfg: ModelConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    lora = max(d // 16, 32)
    return {
        "norm": init.full((d,), 1.0),
        "mu_r": init.full((d,), 0.5), "mu_k": init.full((d,), 0.5),
        "mu_v": init.full((d,), 0.5), "mu_w": init.full((d,), 0.5),
        "mu_g": init.full((d,), 0.5),
        "wr": dense_init(init, (d, h * hd)),
        "wk": dense_init(init, (d, h * hd)),
        "wv": dense_init(init, (d, h * hd)),
        "wg": dense_init(init, (d, h * hd)),
        # the data-dependent decay (Finch): w = f(x) through a LoRA
        "w_decay1": dense_init(init, (d, lora)),
        "w_decay2": dense_init(init, (lora, h * hd)),
        "decay_bias": init.full((h * hd,), -6.0),
        "bonus": init.full((h, hd), 0.0),
        "ln_x": init.full((h * hd,), 1.0),
        "wo": dense_init(init, (h * hd, d), scale=1.0 / math.sqrt(h * hd)),
    }


def rwkv_cache_init(cfg: ModelConfig, batch: int, dtype=torch.float32,
                    device=None, lead: Sequence[int] = ()) -> dict:
    """The recurrent state (B,H,hd,hd) and the token-shift input (B,d),
    f32 as the reference's, stacked under ``lead``."""
    lead = tuple(lead)
    h, hd = cfg.num_heads, cfg.head_dim
    return {"state": torch.zeros(lead + (batch, h, hd, hd), dtype=dtype,
                                 device=device),
            "x_prev": torch.zeros(lead + (batch, cfg.d_model), dtype=dtype,
                                  device=device)}


def _wkv_chunked(r, k, v, w, u, chunk: int = 64):
    """Chunked linear attention with a per-step diagonal decay, in f32.
    r, k, v, w: (B,S,H,hd), w in (0, 1); u the bonus (H,hd).
    S_t = diag(w_t) S_{t-1} + k_t v_t^T;
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T).

    The reference's chunking (``nch = max(s // chunk, 1)`` chunks of
    ``s // nch``) and its per-chunk terms. The terms that read only their
    own chunk (the intra-chunk pairs, the bonus, each chunk's state
    increment) are computed for every chunk at once; only the state
    carried from chunk to chunk runs in order, one chunk at a time."""
    b, s, h, hd = r.shape
    nch = max(s // chunk, 1)
    chunk = s // nch

    def chunks(t):                                     # (n,b,h,c,hd) f32
        return t.reshape(b, nch, chunk, h, hd).permute(1, 0, 3, 2, 4).to(
            torch.float32)

    rr, kk, vv, ww = chunks(r), chunks(k), chunks(v), chunks(w)
    logw = torch.log(torch.clamp(ww, min=1e-6))
    cum = torch.cumsum(logw, 3)        # sum of log-decays up to & incl t
    # inter-chunk: r_i sees the carried state through prod_{l<i} w_l
    r_dec = rr * torch.exp(cum - logw)
    # intra-chunk pair (i, j<i): coefficient exp(cum_{i-1} - cum_j) a dim
    k_dec = kk * torch.exp(-cum)
    att = torch.einsum("nbhcd,nbhed->nbhce", r_dec, k_dec)
    att = att * torch.tril(torch.ones((chunk, chunk), dtype=att.dtype,
                                      device=att.device), -1)
    # the bonus (diagonal): r_t . (u * k_t) v_t
    diag = torch.einsum("nbhcd,nbhcd->nbhc", rr,
                        kk * u.to(torch.float32)[None, None, :, None, :])
    o = torch.einsum("nbhce,nbhed->nbhcd", att, vv) + diag[..., None] * vv
    del att, k_dec
    # each chunk's state step: S <- diag(prod w) S + sum_j (prod_{l>j}
    # w_l) k_j v_j^T
    wall = torch.exp(cum[:, :, :, -1])                      # (n,b,h,hd)
    kv = torch.einsum("nbhcd,nbhce->nbhde",
                      kk * torch.exp(cum[:, :, :, -1:] - cum), vv)
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                        device=r.device)
    carried = []                       # the state each chunk starts from
    for n in range(nch):
        carried.append(state)
        state = state * wall[n][..., None] + kv[n]
    o = o + torch.einsum("nbhcd,nbhde->nbhce", r_dec, torch.stack(carried))
    return o.permute(1, 0, 3, 2, 4).reshape(b, s, h, hd).to(r.dtype)


_RWKV_COLS = ("wr", "wk", "wv", "wg", "w_decay2")


def _rwkv_heads_of(p, cfg: ModelConfig, cache) -> Optional[Tuple[int, int]]:
    """The heads [h0, h1) this rank runs on a model axis where any of the
    time mix's head-wide leaves is split; None on one rank or where every
    leaf is whole. Prefill and training: ``model_axis.frac_heads`` (a
    boundary head on both ranks that share it where the heads do not
    divide the axis). Decode: the heads of the cache's state, which the
    plan splits over the axis where the heads divide it and keeps whole
    (every rank runs every head, so the state has the same bits on every
    rank) where they do not."""
    if MA.active() is None:
        return None
    h = cfg.num_heads
    full = h * cfg.head_dim
    split = (any(p[k].shape[-1] != full for k in _RWKV_COLS)
             or p["wo"].shape[0] != full)
    if not split:
        return None
    if cache is None:
        return MA.frac_heads(h)
    return MA.chunk_of(h, cache["state"].shape[-3])


def _ln_x(o, w, eps: float, full: int):
    """``rms_norm(o, w)`` over ``full`` channels of which ``o`` holds this
    rank's columns (the mean square summed over the ranks, its gradient
    too)."""
    if o.shape[-1] == full:
        return rms_norm(o, w, eps)
    ss = torch.sum(torch.square(o.to(torch.float32)), -1, keepdim=True)
    var = MA.sum_over(ss) / full
    return (o * torch.rsqrt(var + eps)).to(o.dtype) * w


def rwkv_apply(p, x, *, cfg: ModelConfig, mode: str, cache=None, **_):
    """RWKV6's time mix -> (y, cache). Prefill runs ``_wkv_chunked``;
    decode one step of the recurrence from ``cache`` (``state``,
    ``x_prev``), whose tensors get the new state IN PLACE (``copy_``: the
    reference returns new ones); the caller's cache is returned.

    On a model axis (``model_axis``) each rank runs its heads
    (``_rwkv_heads_of``): its columns of ``wr``, ``wk``, ``wv``, ``wg``
    and ``w_decay2`` (``model_axis.head_cols``: gathered where a shard
    splits a head) and of ``decay_bias`` and ``bonus`` (replicated,
    sliced), the mixes of the whole normed input (which enters through
    ``copy``, the mixing coefficients and ``w_decay1`` too). Each rank
    then keeps its own columns (``frac_cols``: its rows of ``wo``):
    ``ln_x``'s mean square runs over every column of every rank
    (``_ln_x``), ``wo``'s partial products are summed; the cache's state
    holds the rank's heads (all of them where the heads do not divide the
    axis) and its token shift ``x_prev``, split on d_model, is gathered
    to be read and written back a chunk a rank."""
    h, hd = cfg.num_heads, cfg.head_dim
    full = h * hd
    heads = _rwkv_heads_of(p, cfg, cache if mode == "decode" else None)
    xn = MA.norm_in(x, p["norm"], cfg.norm_eps)
    b, s, d = xn.shape
    lo, hi = (heads[0] * hd, heads[1] * hd) if heads else (0, full)
    hl = (hi - lo) // hd

    def rep(w):                       # a replicated leaf the rank reads
        return MA.copy(w) if heads else w

    def cols(w):                      # the rank's heads' columns of a leaf
        return MA.head_cols(w, full, lo // hd, hi // hd, hd) if heads else w

    xc = rep(xn)
    if mode == "decode":
        x_prev = MA.whole(cache["x_prev"], d)[:, None].to(xn.dtype)
    else:
        x_prev = F.pad(xc, (0, 0, 1, 0))[:, :-1]

    def mix(mu):
        return xc + (x_prev - xc) * rep(p[mu])

    r = (mix("mu_r") @ cols(p["wr"])).reshape(b, s, hl, hd)
    k = (mix("mu_k") @ cols(p["wk"])).reshape(b, s, hl, hd)
    v = (mix("mu_v") @ cols(p["wv"])).reshape(b, s, hl, hd)
    g = F.silu(mix("mu_g") @ cols(p["wg"]))
    dec = torch.sigmoid(
        (torch.tanh(mix("mu_w") @ rep(p["w_decay1"])) @ cols(p["w_decay2"]))
        + cols(p["decay_bias"])).reshape(b, s, hl, hd)
    # the decay w in (exp(-0.6065), 1): the bound keeps the chunked form's
    # exp(-cumsum(log w)) inside f32's range (see _wkv_chunked)
    w = torch.exp(-0.6065 * dec)
    bonus = (MA.part(p["bonus"], h, heads[0], heads[1], 0) if heads
             else p["bonus"])

    if mode == "decode":
        if cache["state"].shape[-3] != hl:
            raise ValueError(f"an RWKV state of {cache['state'].shape[-3]} "
                             f"heads where this rank runs {hl}")
        state = cache["state"].to(torch.float32)               # (b,h,hd,hd)
        r1, k1, v1, w1 = (t[:, 0].to(torch.float32) for t in (r, k, v, w))
        kv = torch.einsum("bhd,bhe->bhde", k1, v1)
        # o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
        o = torch.einsum("bhd,bhde->bhe", r1, state
                         + bonus.to(torch.float32)[None, :, :, None] * kv)
        cache["state"].copy_(state * w1[..., None] + kv)
        cache["x_prev"].copy_(MA.mine(xn[:, -1], cache["x_prev"].shape[-1]))
        o = o[:, None].to(r.dtype)
    else:
        o = _wkv_chunked(r, k, v, w, bonus)

    o = o.reshape(b, s, hl * hd)
    if heads is None:
        o = _ln_x(o, p["ln_x"], cfg.norm_eps, full) * g
        return MA.seq_chunk(o @ p["wo"]), cache
    # this rank's own columns of its heads, into its rows of wo
    c0, c1 = MA.frac_cols(full, p["wo"].shape[0])
    own = slice(c0 - lo, c1 - lo)
    o = _ln_x(o[..., own], MA.part(p["ln_x"], full, c0, c1), cfg.norm_eps,
              full) * g[..., own]
    return MA.row_product(o, MA.part(p["wo"], full, c0, c1, 0)), cache


# --------------------------------------------------------------------------
# RWKV6 channel mix (its FFN)
# --------------------------------------------------------------------------
def rwkv_ffn_init(init: ParamInit, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {"norm": init.full((d,), 1.0),
            "mu_k": init.full((d,), 0.5), "mu_r": init.full((d,), 0.5),
            "wk": dense_init(init, (d, f)),
            "wv": dense_init(init, (f, d), scale=1.0 / math.sqrt(f)),
            "wr": dense_init(init, (d, d))}


def rwkv_ffn_apply(p, x, *, cfg: ModelConfig, x_prev=None):
    """-> (out, xn_last): xn_last is the decode-mode token-shift state.
    ``x_prev`` (B,d) is the previous token's normed input (decode), None
    for a prefill's shift.

    On a model axis (``model_axis``) with ``wk`` split by columns and
    ``wv`` by rows, each rank's key mix enters through ``copy`` and its
    partial product is summed; ``wr`` is replicated, so the receptance is
    computed whole on every rank and multiplies after the sum."""
    f = cfg.d_ff
    xn = MA.norm_in(x, p["norm"], cfg.norm_eps)
    if x_prev is None:
        xp = F.pad(xn, (0, 0, 1, 0))[:, :-1]
    else:
        xp = x_prev[:, None].to(xn.dtype)
    xk = xn + (xp - xn) * p["mu_k"]
    r = torch.sigmoid((xn + (xp - xn) * p["mu_r"]) @ p["wr"])
    if MA.active() is None or p["wv"].shape[0] == f:
        return MA.seq_chunk(r * (torch.square(F.relu(xk @ p["wk"]))
                                 @ p["wv"])), xn[:, -1]
    lo, hi = MA.chunk_of(f, p["wv"].shape[0])
    k = MA.copy(xk) @ MA.part(p["wk"], f, lo, hi)
    return (MA.seq_chunk(r) * MA.row_product(torch.square(F.relu(k)),
                                             p["wv"]), xn[:, -1])
