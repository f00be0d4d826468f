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

Mamba (``mamba_apply``, jamba's SSM mixer) is plain torch on either
device, as the reference's jnp scans: a causal depthwise convolution and
the selective scan (``_selective_scan``: chunks in order, a log-depth
scan inside each) for prefill, one step of the recurrence from the conv
and SSM states (f32 whatever the compute dtype) for decode, the new
states copied into the caller's cache as RWKV's are.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref

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
        return ParamInit(self.gen, self.device, (repeats,), self.dtype)

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
        if q.is_cuda:
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
        if dout.is_cuda:
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
    if q.is_cuda:
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
    if q.is_cuda:
        return ops.flash_decode(q, k_cache, v_cache, valid)
    h, kv = q.shape[2], k_cache.shape[2]
    k = _repeat_kv(k_cache.to(q.dtype), h // kv)
    v = _repeat_kv(v_cache.to(q.dtype), h // kv)
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * scale
    s = torch.where(valid[:, None, None, :], s, NEG)
    p = torch.softmax(s, -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


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
               enc_out=None):
    """GQA attention. In decode mode, (cache, pos) hold/advance the KV ring.

    The new key and value are written IN PLACE at slot ``pos % size`` of
    each row of the caller's cache (the reference rebuilds the whole cache
    each step with a one-hot select; the cache that results is the same,
    without a second copy of it), and the returned cache holds the same
    tensors.

    ``enc_out`` (B, Se, d), in either mode: whisper's decoder
    cross-attention after the self-attention (``_cross_core``), its keys
    and values projected from ``enc_out`` on every call."""
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
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
        k_cache, v_cache = cache["k"], cache["v"]
        size = k_cache.shape[1]
        slot = (pos % size).long()
        rows = torch.arange(b, device=x.device)
        k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, slot] = v[:, 0].to(v_cache.dtype)
        valid = (torch.arange(size, device=x.device)[None, :]
                 <= torch.clamp(pos, max=size - 1)[:, None])
        o = sdpa_decode(q, k_cache, v_cache, valid)
        cache = {"k": k_cache, "v": v_cache}
    else:
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        o = _prefill_core(q, k, v, causal=causal, window=window,
                          chunked=chunked)

    y = o.reshape(b, s, h * hd) @ p["wo"]

    if enc_out is not None:                    # whisper decoder cross-attn
        xn2 = rms_norm(x + y, p["cross_norm"], cfg.norm_eps)
        se = enc_out.shape[1]
        cq = (xn2 @ p["cwq"]).reshape(b, s, h, hd)
        ck = (enc_out @ p["cwk"]).reshape(b, se, kv, hd)
        cv = (enc_out @ p["cwv"]).reshape(b, se, kv, hd)
        co = _cross_core(cq, ck, cv)
        y = y + co.reshape(b, s, h * hd) @ p["cwo"]
    return y, cache


def _cross_core(q, k, v):
    """Non-causal attention of q (B,S,H,D) over the encoder's k, v
    (B,Se,KV,D), the reference's ``sdpa_full(causal=False)``: on a CUDA
    tensor one query (decode) runs the decode kernel with every one of the
    Se slots valid, more run the prefill kernel at a key length Se unlike
    S (under autograd through ``FlashAttention``, whose backward is the
    backward kernels at Se); a CPU tensor runs ``sdpa_full`` under plain
    autograd, as the reference."""
    if q.is_cuda:
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


def _mla_qkv(p, xn, cfg: ModelConfig):
    b, s, _ = xn.shape
    h = cfg.num_heads
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    if "w_dq" in p:
        q = rms_norm(xn @ p["w_dq"], p["q_norm"], cfg.norm_eps) @ p["w_uq"]
    else:
        q = xn @ p["w_q"]
    q = q.reshape(b, s, h, dn + dr)
    c_kv = rms_norm(xn @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)  # (b,s,r)
    k_rope = xn @ p["w_kr"]                                        # (b,s,dr)
    return q, c_kv, k_rope


def _mla_heads(c_kv, k_rope, p, cfg: ModelConfig):
    """Per-head keys (B,S,H,dn+dr) rebuilt from the latent ``c_kv``
    (B,S,r) and the shared rotary key ``k_rope`` (B,S,dr), and the values
    (B,S,H,dv) zero-padded to dn + dr, so that both attention cores take
    them. Each temporary is freed once it is consumed (at deepseek's full
    width and 32,768 slots a layer's keys are 6.4 GB)."""
    b, s, _ = c_kv.shape
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    k_nope = (c_kv @ p["w_uk"]).reshape(b, s, h, dn)
    k_full = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, dr)],
                       -1)
    del k_nope
    v = (c_kv @ p["w_uv"]).reshape(b, s, h, dv)
    v_pad = F.pad(v, (0, dn + dr - dv))
    return k_full, v_pad


def mla_apply(p, x, *, cfg: ModelConfig, mode: str, cache=None, pos=None,
              window: int = 0, absorbed: bool = False, chunked: bool = True,
              **_):
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
    version on the CPU. Both scale by 1/sqrt(dn + dr), the reference's."""
    h = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    b, s, _ = xn.shape
    q, c_kv, k_rope = _mla_qkv(p, xn, cfg)

    if mode == "decode":
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = apply_rope(q_rope, pos[:, None], cfg.rope_theta)
        k_rope = apply_rope(k_rope[:, :, None, :], pos[:, None],
                            cfg.rope_theta)[:, :, 0]
        ckv_c, kr_c = cache["c_kv"], cache["k_rope"]
        size = ckv_c.shape[1]
        slot = (pos % size).long()
        rows = torch.arange(b, device=x.device)
        ckv_c[rows, slot] = c_kv[:, 0].to(ckv_c.dtype)
        kr_c[rows, slot] = k_rope[:, 0].to(kr_c.dtype)
        valid = (torch.arange(size, device=x.device)[None, :]
                 <= torch.clamp(pos, max=size - 1)[:, None])
        if absorbed:
            scale = 1.0 / math.sqrt(dn + dr)
            ckv = ckv_c.to(q.dtype)
            # fold W_uk into q: attend directly in the r-dim latent space
            w_uk = p["w_uk"].reshape(-1, h, dn)                 # (r,h,dn)
            q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, w_uk)
            s_lat = torch.einsum("bqhr,bkr->bhqk", q_lat, ckv)
            s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope,
                                  kr_c.to(q.dtype))
            att = (s_lat + s_rope).to(torch.float32) * scale
            att = torch.where(valid[:, None, None, :], att, NEG)
            pr = torch.softmax(att, -1).to(q.dtype)
            o_lat = torch.einsum("bhqk,bkr->bqhr", pr, ckv)
            w_uv = p["w_uv"].reshape(-1, h, dv)                 # (r,h,dv)
            o = torch.einsum("bqhr,rhv->bqhv", o_lat, w_uv)
        else:
            k_full, v_pad = _mla_heads(ckv_c.to(q.dtype), kr_c.to(q.dtype),
                                       p, cfg)
            q_full = torch.cat([q_nope, q_rope], -1)
            o = sdpa_decode(q_full, k_full, v_pad, valid)[..., :dv]
            del k_full, v_pad
        cache = {"c_kv": ckv_c, "k_rope": kr_c}
    else:
        positions = torch.arange(s, device=x.device)
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
        k_rope = apply_rope(k_rope[:, :, None, :], positions,
                            cfg.rope_theta)[:, :, 0]
        k_full, v_pad = _mla_heads(c_kv, k_rope, p, cfg)
        q_full = torch.cat([q_nope, q_rope], -1)
        o = _prefill_core(q_full, k_full, v_pad, causal=True, window=window,
                          chunked=chunked)
        del k_full, v_pad
        o = o[..., :dv]
    y = o.reshape(b, s, h * dv) @ p["wo"]
    return y, cache


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


def ffn_apply(p, x, *, cfg: ModelConfig):
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    return (act_fn(cfg.act)(xn @ p["w_gate"]) * (xn @ p["w_up"])) @ p["w_down"]


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


def moe_apply(p, x, *, cfg: ModelConfig, capacity_factor: float = 1.25,
              group_size: int = 512):
    """The reference's capacity-dropped top-k MoE (``repro.models.layers.
    moe_apply``) -> (y, aux). Each (expert, group, slot) holds at most one
    token, so dispatch is a gather of token rows into the (e, g * cap, d)
    slots (empty slots read a zero row) and the expert products are batched
    GEMMs over the expert axis; combine gathers each kept (token, choice)'s
    expert output and sums the k weighted terms in choice order in f32,
    rounded once. No atomics: the same inputs give the same bits."""
    b, s, d = x.shape
    e = cfg.num_experts
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    flat = xn.reshape(-1, d)
    n = flat.shape[0]
    with torch.profiler.record_function("moe.route"):
        r = moe_route(p, flat, cfg=cfg, capacity_factor=capacity_factor,
                      group_size=group_size)
    m, k, cap = r.groups * r.group_len, r.topi.shape[1], r.cap
    slots = e * r.groups * cap
    with torch.profiler.record_function("moe.dispatch"):
        group = torch.arange(m, device=x.device)[:, None] // r.group_len
        dest = (r.topi * r.groups + group) * cap + r.pos      # (m, k)
        # the token in each slot (m: none, a zero row); dropped pairs all
        # write the spare last entry, which is cut off
        token = torch.arange(m, device=x.device)[:, None].expand(m, k)
        src = torch.full((slots + 1,), m, dtype=torch.long,
                         device=x.device).scatter_(
            0, torch.where(r.keep, dest, slots).reshape(-1),
            token.reshape(-1))[:slots]
        rows = torch.cat([flat[:m], flat.new_zeros(1, d)])
        xe = rows[src].view(e, r.groups * cap, d)
    with torch.profiler.record_function("moe.experts"):
        he = act_fn(cfg.act)(torch.bmm(xe, p["we_gate"])) \
            * torch.bmm(xe, p["we_up"])
        ye = torch.bmm(he, p["we_down"]).view(slots, d)
    with torch.profiler.record_function("moe.combine"):
        # a dropped pair reads slot 0 with weight 0 (every slot's row is
        # finite: an empty slot's is 0); choice-major, so that each
        # choice's slots and weights are contiguous
        at = torch.where(r.keep, dest, 0).t().contiguous()
        w = torch.where(r.keep, r.topv.to(torch.float32), 0.0).t()
        acc = torch.zeros((m, d), dtype=torch.float32, device=x.device)
        for j in range(k):
            acc.addcmul_(w[j, :, None], ye.index_select(0, at[j]))
        y = acc.to(x.dtype)
        if m < n:
            y = torch.cat([y, y.new_zeros(n - m, d)])
    y = y.view(b, s, d)
    if cfg.num_shared_experts:
        y = y + (act_fn(cfg.act)(xn @ p["ws_gate"]) * (xn @ p["ws_up"])
                 ) @ p["ws_down"]
    # the load-balance term (over the routed tokens, top-1 choices)
    me = r.probs.mean(0)
    ce = (r.topi[:, :1] == torch.arange(e, device=x.device)).to(
        torch.float32).mean(0)
    aux = cfg.router_aux_loss * e * torch.sum(me * ce)
    return y, aux


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


def mamba_apply(p, x, *, cfg: ModelConfig, mode: str, cache=None, **_):
    """Mamba -> (y, cache). Prefill: the causal depthwise convolution over
    the sequence and ``_selective_scan``; the cache (if any) is returned
    as it came, as the reference does. Decode: one step from ``cache``
    (``conv``, ``ssm``), whose tensors get the new states IN PLACE
    (``copy_``: the reference returns new ones), with the reference's
    casts: the conv state read as the compute dtype, the SSM state read
    in the dtype of ``exp(dt A)`` and both stored back in theirs."""
    di, st, cw = cfg.d_inner, cfg.ssm_state_dim, cfg.ssm_conv_width
    dt_rank = max(cfg.d_model // 16, 1)
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    b, s, _ = xn.shape
    xz = xn @ p["w_in"]
    u, z = xz[..., :di], xz[..., di:]

    if mode == "decode":
        conv_state = torch.cat([cache["conv"],
                                u.to(cache["conv"].dtype)], 1)
        uc = torch.einsum("bwd,wd->bd", conv_state.to(u.dtype),
                          p["conv_w"]) + p["conv_b"]
        uc = F.silu(uc)[:, None]                           # (b,1,di)
        dbc = uc @ p["w_x"]
        dt = F.softplus(dbc[..., :dt_rank] @ p["w_dt"] + p["dt_bias"])
        B = dbc[..., dt_rank:dt_rank + st]
        C = dbc[..., dt_rank + st:]
        A = -torch.exp(p["A_log"])
        dA = torch.exp(dt[:, 0, :, None] * A)              # (b,di,st)
        h = cache["ssm"].to(dA.dtype) * dA \
            + dt[:, 0, :, None] * B[:, 0, None, :] * uc[:, 0, :, None]
        y = torch.einsum("bds,bs->bd", h, C[:, 0])[:, None] + uc * p["D"]
        cache["conv"].copy_(conv_state[:, 1:])
        cache["ssm"].copy_(h)
    else:
        upad = F.pad(u, (0, 0, cw - 1, 0))
        uc = sum(upad[:, i:i + s] * p["conv_w"][i] for i in range(cw)) \
            + p["conv_b"]
        uc = F.silu(uc)
        dbc = uc @ p["w_x"]
        dt = F.softplus(dbc[..., :dt_rank] @ p["w_dt"] + p["dt_bias"])
        B = dbc[..., dt_rank:dt_rank + st]
        C = dbc[..., dt_rank + st:]
        A = -torch.exp(p["A_log"])
        y = _selective_scan(uc, dt, A, B, C, p["D"])
    y = y * F.silu(z)
    return y @ p["w_out"], cache


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


def rwkv_apply(p, x, *, cfg: ModelConfig, mode: str, cache=None, **_):
    """RWKV6's time mix -> (y, cache). Prefill runs ``_wkv_chunked``;
    decode one step of the recurrence from ``cache`` (``state``,
    ``x_prev``), whose tensors get the new state IN PLACE (``copy_``: the
    reference returns new ones); the caller's cache is returned."""
    h, hd = cfg.num_heads, cfg.head_dim
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    b, s, d = xn.shape

    if mode == "decode":
        x_prev = cache["x_prev"][:, None].to(xn.dtype)
    else:
        x_prev = F.pad(xn, (0, 0, 1, 0))[:, :-1]

    def mix(mu):
        return xn + (x_prev - xn) * mu

    r = (mix(p["mu_r"]) @ p["wr"]).reshape(b, s, h, hd)
    k = (mix(p["mu_k"]) @ p["wk"]).reshape(b, s, h, hd)
    v = (mix(p["mu_v"]) @ p["wv"]).reshape(b, s, h, hd)
    g = F.silu(mix(p["mu_g"]) @ p["wg"])
    dec = torch.sigmoid(
        (torch.tanh(mix(p["mu_w"]) @ p["w_decay1"]) @ p["w_decay2"])
        + p["decay_bias"]).reshape(b, s, h, hd)
    # the decay w in (exp(-0.6065), 1): the bound keeps the chunked form's
    # exp(-cumsum(log w)) inside f32's range (see _wkv_chunked)
    w = torch.exp(-0.6065 * dec)

    if mode == "decode":
        state = cache["state"].to(torch.float32)               # (b,h,hd,hd)
        r1, k1, v1, w1 = (t[:, 0].to(torch.float32) for t in (r, k, v, w))
        kv = torch.einsum("bhd,bhe->bhde", k1, v1)
        # o_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
        o = torch.einsum("bhd,bhde->bhe", r1, state
                         + p["bonus"].to(torch.float32)[None, :, :, None]
                         * kv)
        cache["state"].copy_(state * w1[..., None] + kv)
        cache["x_prev"].copy_(xn[:, -1])
        o = o[:, None].to(r.dtype)
    else:
        o = _wkv_chunked(r, k, v, w, p["bonus"])

    o = o.reshape(b, s, h * hd)
    o = rms_norm(o, p["ln_x"], cfg.norm_eps) * g
    return o @ p["wo"], cache


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
    for a prefill's shift."""
    xn = rms_norm(x, p["norm"], cfg.norm_eps)
    if x_prev is None:
        xp = F.pad(xn, (0, 0, 1, 0))[:, :-1]
    else:
        xp = x_prev[:, None].to(xn.dtype)
    k = (xn + (xp - xn) * p["mu_k"]) @ p["wk"]
    r = torch.sigmoid((xn + (xp - xn) * p["mu_r"]) @ p["wr"])
    return r * (torch.square(F.relu(k)) @ p["wv"]), xn[:, -1]
