"""Config-driven LM assembly: the port of ``repro.models.transformer``
(mixer ``attn``, ``attn_cross``, ``mla``, ``mamba`` or ``rwkv``; FFN
``dense``, ``moe`` or ``rwkv_ffn``; whisper's encoder and internvl2's
vision prefix).

A model is a list of STAGES, the reference's own (``layer_specs`` and
``decompose`` are copies), so that ``stage_range`` means the same in both
packages. Each stage is either
  * scan:   a repeating unit of block specs whose parameters are stacked
            over the repeats, one dict per unit position (the port loops
            over the repeats in Python and indexes the stacked leaves), or
  * unroll: explicit layers, one dict each.

``LM(remat=True)`` recomputes each repeat of a scan stage in the
backward (``torch.utils.checkpoint``, where the reference wraps the scan
body in ``jax.checkpoint``), when autograd records a full-mode forward
with no cache. ``make_split_lm`` is the paper's lower/upper view of an LM
(the reference's ``SplitModel`` of closures, as a ``SplitLM``).

``params_from_jax`` / ``params_to_jax`` map ``repro``'s LM parameter tree
(numpy arrays) to the port's and back; the two trees have the same
structure. An MoE block's load-balance term is summed over the blocks that
run (``apply``'s ``aux``), and ``LM.loss`` and ``make_split_lm``'s upper
loss add it, as the reference's. ``LM.init(gen, dtype=torch.bfloat16)``
fills each stacked leaf one layer slice at a time (the bits of the f32
tree cast afterwards), so a full-width model is made without its f32 tree.

In decode mode every block updates the caller's cache in place: the
attention and MLA rings by a slot write, RWKV's recurrent state and
token-shift inputs (``state``, ``x_prev``, ``ffn_x_prev``) and Mamba's
conv and SSM states (``conv``, ``ssm``), replaced every step, by a
``copy_`` into the cache's tensors. So a scan stage's stacked cache, read
a layer at a time through views, is current after the step.

An encoder-decoder (whisper) has encoder stages (``enc_stages``,
non-causal attention and a dense FFN) that ``LM.encode`` runs over the
stubbed frame embeddings, and decoder blocks whose ``attn_cross`` mixer
attends over the encoder's output: in full mode ``apply(enc_frames=...)``
encodes first, in decode mode the output is the cache's ``enc_out``.
Its decoder adds sinusoidal positions to the token embeddings. A vision
LM (internvl2) projects ``prefix_embeds`` with ``proj`` and puts them
before the text, in full mode only, as the reference does.

On a model axis (``model_axis.over``: each rank holds its shard of the
leaves) the embedding's rows and the head's columns split the
vocabulary: the lookup is masked to this rank's rows and summed over the
ranks, ``apply``'s logits are gathered over them, and ``loss`` takes the
log-softmax over the split vocabulary (``model_axis.next_token_nll``)
without gathering the logits. With the sequence split as well
(training's ``seq_shard_activations``) the hidden states hold a rank's
chunk of the positions from a run of stages' entry to its exit, where
they are gathered, so the embedding, the head and a stage range's
hidden states are what they are without the split.

With FSDP (``models/fsdp.py``) each block's data-split leaves are
gathered at the block's entry (inside the unit a remat checkpoints), the
embedding, the head and the projector where they are read. ``apply``'s
``rings`` give each attention or latent ring's ``layers.SeqSplit`` where
the decode step splits its slots over ranks.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import fsdp as FS
from repro_torch.models import layers as L
from repro_torch.models import model_axis as MA
from repro_torch.optim.optimizers import tree_map

PyTree = Any


# --------------------------------------------------------------------------
# block specs & stage decomposition (copies of the reference's)
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class BlockSpec:
    mixer: str                  # attn | mla | mamba | rwkv | attn_cross
    ffn: str                    # dense | moe | rwkv_ffn
    window: int = 0             # static sliding window (0 = full)
    causal: bool = True


@dataclass(frozen=True)
class Stage:
    kind: str                   # scan | unroll
    unit: Tuple[BlockSpec, ...]
    repeats: int


def layer_specs(cfg: ModelConfig, force_swa: bool = False,
                decoder: bool = True) -> List[BlockSpec]:
    """Per-layer block specs for the decoder stack (or encoder if decoder=False)."""
    if not decoder:  # whisper encoder: bidirectional attention + dense FFN
        return [BlockSpec("attn", "dense", 0, causal=False)] * cfg.encoder_layers
    kinds = cfg.layer_kinds()
    windows = cfg.window_sizes(0, force_swa)
    specs, ai = [], 0
    for i, kind in enumerate(kinds):
        if kind == "rwkv":
            mixer, w = "rwkv", 0
        elif kind == "mamba":
            mixer, w = "mamba", 0
        else:
            mixer = "mla" if cfg.attention_kind == "mla" else "attn"
            if cfg.is_encoder_decoder:
                mixer = "attn_cross"
            w = windows[ai]
            ai += 1
        if kind == "rwkv":
            ffn = "rwkv_ffn"
        elif cfg.is_moe and i >= cfg.first_dense_layers \
                and (i % cfg.moe_layer_period == cfg.moe_layer_period - 1
                     or cfg.moe_layer_period == 1):
            ffn = "moe"
        else:
            ffn = "dense"
        specs.append(BlockSpec(mixer, ffn, w))
    return specs


def decompose(specs: List[BlockSpec], boundary: Optional[int] = None
              ) -> List[Stage]:
    """Group per-layer specs into scan/unroll stages. ``boundary`` forces a
    stage break at layer index j (the paper's split point)."""
    if boundary is not None and 0 < boundary < len(specs):
        return decompose(specs[:boundary]) + decompose(specs[boundary:])
    n = len(specs)
    if n == 0:
        return []
    best = None  # (scanned_layers, prefix, period, repeats)
    for prefix in range(0, min(3, n)):
        for p in range(1, min(9, n - prefix + 1)):
            reps = (n - prefix) // p
            if reps < 2:
                continue
            body = specs[prefix:prefix + reps * p]
            if all(body[i] == body[i % p] for i in range(len(body))):
                score = reps * p
                if best is None or score > best[0] or (
                        score == best[0] and p < best[2]):
                    best = (score, prefix, p, reps)
    if best is None:
        return [Stage("unroll", tuple(specs), 1)]
    _, prefix, p, reps = best
    stages = []
    if prefix:
        stages.append(Stage("unroll", tuple(specs[:prefix]), 1))
    stages.append(Stage("scan", tuple(specs[prefix:prefix + p]), reps))
    rest = specs[prefix + reps * p:]
    if rest:
        stages.append(Stage("unroll", tuple(rest), 1))
    return stages


def stage_layers(st: Stage) -> int:
    return len(st.unit) * st.repeats


# --------------------------------------------------------------------------
# trees
# --------------------------------------------------------------------------
def cast_params(params: PyTree, dtype: torch.dtype) -> PyTree:
    """Every f32 leaf cast to ``dtype`` (others, and leaves already in
    ``dtype``, are returned as they are, without a copy)."""
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.dtype == torch.float32 else x, params)


# --------------------------------------------------------------------------
# per-block init/apply/cache dispatch: mixer attn | attn_cross | mla |
# mamba | rwkv, ffn dense | moe | rwkv_ffn
# --------------------------------------------------------------------------
def _block_init(init: L.ParamInit, cfg: ModelConfig, spec: BlockSpec
                ) -> PyTree:
    if spec.ffn == "dense":              # the FFN's draws come first
        ffn = L.ffn_init(init, cfg)
    elif spec.ffn == "moe":
        ffn = L.moe_init(init, cfg)
    else:
        ffn = L.rwkv_ffn_init(init, cfg)
    if spec.mixer in ("attn", "attn_cross"):
        mixer = L.attn_init(init, cfg, cross=spec.mixer == "attn_cross")
    elif spec.mixer == "mla":
        mixer = L.mla_init(init, cfg)
    elif spec.mixer == "mamba":
        mixer = L.mamba_init(init, cfg)
    else:
        mixer = L.rwkv_init(init, cfg)
    return {"mixer": mixer, "ffn": ffn}


def _block_cache(cfg: ModelConfig, spec: BlockSpec, batch: int, seq_len: int,
                 dtype, device, lead=()) -> PyTree:
    """A block's decode cache: the attention ring (``window`` slots at
    most), MLA's latent ring, or RWKV's or Mamba's f32 states (whatever
    ``dtype`` and ``seq_len`` say, as the reference's)."""
    if spec.mixer == "mamba":
        return {"mixer": L.mamba_cache_init(cfg, batch, device=device,
                                            lead=lead)}
    if spec.mixer == "mla":
        return {"mixer": L.mla_cache_init(cfg, batch, seq_len, dtype,
                                          device, lead)}
    if spec.mixer == "rwkv":
        return {"mixer": L.rwkv_cache_init(cfg, batch, device=device,
                                           lead=lead),
                "ffn_x_prev": torch.zeros(tuple(lead) + (batch,
                                                         cfg.d_model),
                                          dtype=torch.float32,
                                          device=device)}
    return {"mixer": L.attn_cache_init(cfg, batch, seq_len, spec.window,
                                       dtype, device, lead)}


def _block_apply(params, x, spec: BlockSpec, cfg: ModelConfig, mode: str,
                 cache, pos, enc_out=None, dims=None, seq=None):
    """-> (x, cache, aux): aux is the MoE's load-balance term, None for
    another FFN (the reference adds a zero). ``enc_out`` is read by an
    ``attn_cross`` mixer only. On a model axis every rank computes the
    whole route, so ``aux`` is each rank's whole term, added once.
    ``dims``: the block's data-split dims (FSDP: its leaves gathered over
    "data" first, ``fsdp.gather_block``); ``seq``: the ``layers.SeqSplit``
    of an attention or latent ring whose slots are split over ranks."""
    params = FS.gather_block(params, dims)
    kw = dict(cfg=cfg, mode=mode, cache=(cache or {}).get("mixer"), pos=pos,
              window=spec.window)
    if spec.mixer in ("attn", "attn_cross"):
        y, mc = L.attn_apply(params["mixer"], x, causal=spec.causal,
                             enc_out=enc_out if spec.mixer == "attn_cross"
                             else None, seq=seq, **kw)
    elif spec.mixer == "mla":
        y, mc = L.mla_apply(params["mixer"], x, absorbed=cfg.mla_absorbed,
                            seq=seq, **kw)
    elif spec.mixer == "mamba":
        y, mc = L.mamba_apply(params["mixer"], x, **kw)
    else:
        y, mc = L.rwkv_apply(params["mixer"], x, **kw)
    x = x + y
    aux = None
    new_cache = {"mixer": mc} if mc is not None else {}
    if spec.ffn == "moe":
        y, aux = L.moe_apply(params["ffn"], x, cfg=cfg)
        x = x + y
    elif spec.ffn == "dense":
        x = x + L.ffn_apply(params["ffn"], x, cfg=cfg)
    else:
        xp = (cache or {}).get("ffn_x_prev") if mode == "decode" else None
        # on a model axis the cache may hold this rank's chunk of d_model:
        # the mix reads it whole, the rank writes its chunk back
        y, xn_last = L.rwkv_ffn_apply(
            params["ffn"], x, cfg=cfg,
            x_prev=None if xp is None else MA.whole(xp, cfg.d_model))
        x = x + y
        if mode == "decode":        # in place, as the mixer's state
            new_cache["ffn_x_prev"] = xp.copy_(MA.mine(xn_last,
                                                       xp.shape[-1]))
    return x, new_cache, aux


def _add(total, aux):
    return total if aux is None else total + aux


def _layer(tree: PyTree, r: int) -> PyTree:
    """Layer ``r`` of a scan stage's stacked tree (views, no copies)."""
    return tree_map(lambda t: t[r], tree)


def _layers(tree: PyTree, repeats: int) -> List[PyTree]:
    """Every layer of a scan stage's stacked tree, as views from one
    ``unbind`` a leaf (whose backward stacks the layers' gradients once,
    where indexing each layer would add a full-size zero tensor a layer)."""
    if isinstance(tree, dict):
        per = {k: _layers(v, repeats) for k, v in tree.items()}
        return [{k: per[k][r] for k in tree} for r in range(repeats)]
    if isinstance(tree, (list, tuple)):
        per = [_layers(v, repeats) for v in tree]
        return [type(tree)(p[r] for p in per) for r in range(repeats)]
    return list(tree.unbind(0))


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------
def sinusoidal_pos(d: int, positions: torch.Tensor) -> torch.Tensor:
    """(..., d) f32: sin then cos of ``positions`` times d/2 frequencies
    from 1 down to 1/10000, the reference's absolute positions."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


class LM:
    """Bundles init/apply/cache for one ModelConfig (GQA or MLA attention,
    Mamba or RWKV's time mix; a dense, MoE or RWKV channel-mix FFN;
    whisper's encoder and cross-attention; a vision prefix)."""

    def __init__(self, cfg: ModelConfig, force_swa: bool = False,
                 remat: bool = False):
        self.cfg = cfg
        self.force_swa = force_swa
        # recompute each scan repeat in the backward (jax.checkpoint with
        # no policy: everything recomputed)
        self.remat = remat
        self.specs = layer_specs(cfg, force_swa)
        self.stages = decompose(self.specs)
        if cfg.is_encoder_decoder:
            self.enc_specs = layer_specs(cfg, decoder=False)
            self.enc_stages = decompose(self.enc_specs)

    # ---------------- init ----------------
    def _stage_init(self, init: L.ParamInit, stage: Stage) -> PyTree:
        if stage.kind == "unroll":
            return [_block_init(init, self.cfg, s) for s in stage.unit]
        # scan: params stacked over repeats per unit position
        stacked = init.stacked(stage.repeats)
        return [_block_init(stacked, self.cfg, s) for s in stage.unit]

    def init(self, gen: Optional[torch.Generator], device=None,
             dtype=torch.float32) -> PyTree:
        """Parameters drawn from ``gen`` (on ``gen``'s device, moved to
        ``device`` if given), in ``dtype``: the f32 draws, each stacked
        leaf one layer slice at a time, cast into leaves of ``dtype``
        (``cast_params(init(gen), dtype)``'s bits, without the f32 tree).
        ``device="meta"`` with ``gen=None`` gives the shapes alone. The
        draws differ from ``repro``'s (another generator); tests carry
        ``repro``'s parameters across with ``params_from_jax``."""
        return self.draw(L.ParamInit(gen, device, dtype=dtype))

    def draw(self, init: L.ParamInit) -> PyTree:
        """The parameter tree drawn through ``init`` (``init``'s calls in
        the order ``init`` makes them: a ``ParamInit`` subclass can place
        each leaf as it is drawn, ``specs.params_on_mesh``)."""
        cfg = self.cfg
        v, d = cfg.padded_vocab, cfg.d_model
        params: dict = {
            "embed": init.normal((v, d), 1.0 / math.sqrt(d)),
            "final_norm": init.full((d,), 1.0),
            "stages": [self._stage_init(init, st) for st in self.stages],
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(init, (d, v))
        if cfg.is_encoder_decoder:
            params["enc_stages"] = [self._stage_init(init, st)
                                    for st in self.enc_stages]
            params["enc_norm"] = init.full((d,), 1.0)
        if cfg.frontend == "vision_stub":
            # projector from the (stubbed) vision embeddings into d_model
            params["proj"] = L.dense_init(init, (d, d))
        return params

    # ---------------- cache ----------------
    def init_cache(self, batch: int, seq_len: int, dtype=torch.bfloat16,
                   device=None) -> PyTree:
        def stage_cache(st: Stage):
            if st.kind == "unroll":
                return [_block_cache(self.cfg, s, batch, seq_len, dtype,
                                     device) for s in st.unit]
            return [_block_cache(self.cfg, s, batch, seq_len, dtype, device,
                                 (st.repeats,)) for s in st.unit]
        cache = {"stages": [stage_cache(st) for st in self.stages],
                 "pos": torch.zeros((batch,), dtype=torch.int32,
                                    device=device)}
        if self.cfg.is_encoder_decoder:
            # the encoder's output the decoder's cross-attention reads
            # (zeros until the caller writes an ``encode`` into it)
            cache["enc_out"] = torch.zeros(
                (batch, self.cfg.encoder_seq_len, self.cfg.d_model),
                dtype=dtype, device=device)
        return cache

    # ---------------- apply ----------------
    def _run_stages(self, stages, stage_params, x, mode, cache_stages, pos,
                    enc_out=None, dims=None, rings=None):
        """-> (x, the blocks' aux summed in layer order (f32), caches).
        ``dims`` (FSDP) and ``rings`` (a ring split over ranks) are the
        stages' data-split dims and ``layers.SeqSplit``s, a list a stage of
        a list a unit position (None: none). With the sequence split over
        the model axis (``model_axis.seq_split``, training) the hidden
        states between blocks hold this rank's chunk of the positions:
        ``x`` is split at the entry and gathered whole at the exit."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_caches = []
        x = MA.seq_chunk(x)
        for si, (st, sp) in enumerate(zip(stages, stage_params)):
            scache = cache_stages[si] if cache_stages is not None else None
            sdims, srings = FS.at(dims, si), FS.at(rings, si)
            if st.kind == "unroll":
                ncs = []
                for li, spec in enumerate(st.unit):
                    c = scache[li] if scache is not None else None
                    x, nc, a = _block_apply(sp[li], x, spec, self.cfg, mode,
                                            c, pos, enc_out,
                                            FS.at(sdims, li),
                                            FS.at(srings, li))
                    aux = _add(aux, a)
                    ncs.append(nc)
                new_caches.append(ncs)
            elif scache is None:
                unit = functools.partial(self._unit_apply, st.unit, mode,
                                         pos, enc_out, sdims)
                remat = (self.remat and mode == "full"
                         and torch.is_grad_enabled())
                for lp in _layers(sp, st.repeats):
                    x, a = (checkpoint(unit, x, lp, use_reentrant=False)
                            if remat else unit(x, lp))
                    aux = _add(aux, a)
                new_caches.append(None)
            else:
                for r in range(st.repeats):
                    for ui, spec in enumerate(st.unit):
                        x, _, a = _block_apply(_layer(sp[ui], r), x, spec,
                                               self.cfg, mode,
                                               _layer(scache[ui], r), pos,
                                               enc_out, FS.at(sdims, ui),
                                               FS.at(srings, ui))
                        aux = _add(aux, a)
                # the stacked caches were written in place, layer by
                # layer, through the views (rings and states alike)
                new_caches.append(scache)
        return MA.seq_whole(x), aux, new_caches

    def _unit_apply(self, unit, mode, pos, enc_out, dims, x, lp):
        """One repeat of a scan stage (its unit's blocks) without a cache:
        the body the reference's scan runs (and ``jax.checkpoint``s) ->
        (x, the unit's aux summed (f32)); each block's data-split leaves
        gathered at its entry, inside the checkpointed body."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for ui, spec in enumerate(unit):
            x, _, a = _block_apply(lp[ui], x, spec, self.cfg, mode, None,
                                   pos, enc_out, FS.at(dims, ui))
            aux = _add(aux, a)
        return x, aux

    def encode(self, params, frames):
        """Whisper's encoder over stubbed frame embeddings (B, Se, d):
        sinusoidal positions added, the encoder stages (non-causal) in
        full mode, ``enc_norm``."""
        pos = torch.arange(frames.shape[1], device=frames.device)
        h = frames + sinusoidal_pos(self.cfg.d_model, pos)[None].to(
            frames.dtype)
        h, _, _ = self._run_stages(self.enc_stages, params["enc_stages"], h,
                                   "full", None, None,
                                   dims=FS.dims("enc_stages"))
        return L.rms_norm(h, params["enc_norm"], self.cfg.norm_eps)

    def embed_tokens(self, params, tokens):
        w = FS.gather_leaf(params["embed"], FS.dims("embed"))
        return MA.embed(w, tokens, self.cfg.padded_vocab) \
            * math.sqrt(self.cfg.d_model)

    def head(self, params, h):
        """The head's weight (d, vocab, or this rank's columns of it) in
        ``h``'s dtype: the tied embedding's transpose, or ``lm_head``
        (gathered over "data" where FSDP splits it)."""
        if self.cfg.tie_embeddings:
            w = FS.gather_leaf(params["embed"], FS.dims("embed")).T
        else:
            w = FS.gather_leaf(params["lm_head"], FS.dims("lm_head"))
        return w.to(h.dtype)

    def apply(self, params, tokens, *, mode: str = "full", cache=None,
              prefix_embeds=None, enc_frames=None,
              return_hidden: bool = False,
              stage_range: Optional[Tuple[int, int]] = None,
              hidden_in=None, dtype=torch.float32, rings=None):
        """Forward. mode: full (prefill) | decode (1 token + cache).
        stage_range selects a sub-interval of stages; hidden_in feeds
        activations at a stage boundary. Returns (logits or hidden, cache,
        aux), aux the MoE blocks' load-balance terms of the stages run,
        summed (a 0-d f32 zero with no MoE block); in decode mode the
        caller's cache is updated in place.

        An encoder-decoder needs ``enc_frames`` (B, Se, d) in full mode
        (encoded first, in ``dtype``) and reads the cache's ``enc_out``
        (cast to ``dtype``) in decode mode. ``prefix_embeds`` (B, P, d),
        full mode only: projected by ``proj`` and put before the text's
        embeddings, so the output has P + T positions.

        Mixed precision: every f32 leaf is cast to ``dtype`` first, as the
        reference does on each call. A tree already cast with
        ``cast_params(params, dtype)`` passes through without a copy, and
        gives the same numbers: cast once per serving run, not per step."""
        cfg = self.cfg
        if mode not in ("full", "decode"):
            raise ValueError(f"mode must be 'full' or 'decode', got {mode!r}")
        if dtype != torch.float32:
            params = cast_params(params, dtype)
        enc_out = None
        if cfg.is_encoder_decoder:
            if mode == "decode":
                enc_out = cache["enc_out"].to(dtype)
            else:
                if enc_frames is None:
                    raise ValueError(f"{cfg.name}: full mode needs "
                                     f"enc_frames (B, Se, d)")
                enc_out = self.encode(params, enc_frames.to(dtype))
        # whisper's decoder: absolute positions in place of RoPE
        sinusoidal = cfg.rope_theta == 0 and cfg.is_encoder_decoder
        n_stages = len(self.stages)
        lo, hi = stage_range if stage_range is not None else (0, n_stages)

        if hidden_in is not None:
            h = hidden_in
            pos = cache["pos"] if cache is not None else None
        elif mode == "decode":
            pos = cache["pos"]
            h = self.embed_tokens(params, tokens).to(dtype)
            if sinusoidal:
                h = h + sinusoidal_pos(cfg.d_model, pos[:, None]).to(dtype)
        else:
            pos = None
            h = self.embed_tokens(params, tokens).to(dtype)
            if sinusoidal:
                h = h + sinusoidal_pos(cfg.d_model, torch.arange(
                    tokens.shape[1], device=h.device))[None].to(dtype)
            if prefix_embeds is not None:    # VLM: prepend the patches
                proj = FS.gather_leaf(params["proj"], FS.dims("proj"))
                pe = prefix_embeds.to(dtype) @ proj.to(dtype)
                h = torch.cat([pe, h], 1)

        cache_stages = cache["stages"][lo:hi] if cache is not None else None
        stage_dims = FS.dims("stages")
        h, aux, new_stage_caches = self._run_stages(
            self.stages[lo:hi], params["stages"][lo:hi], h, mode,
            cache_stages, pos, enc_out,
            stage_dims[lo:hi] if stage_dims is not None else None,
            rings[lo:hi] if rings is not None else None)

        new_cache = None
        if cache is not None:
            new_cache = dict(cache)
            new_cache["stages"] = (cache["stages"][:lo] + new_stage_caches
                                   + cache["stages"][hi:])
            if hi == n_stages:
                new_cache["pos"] = cache["pos"] + 1
        if hi < n_stages or return_hidden:
            return h, new_cache, aux

        h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
        logits = MA.head_logits(h, self.head(params, h), cfg.padded_vocab)
        return logits, new_cache, aux

    # ---------------- losses ----------------
    def loss(self, params, batch, dtype=torch.float32):
        """Next-token CE, differentiable (the f32 log-softmax of the
        logits, as the reference). batch = tokens, (tokens, labels unused)
        or a dict with "tokens" and, as the model takes them, the
        reference's extras "prefix_embeds" (B, P, d) and "enc_frames" (B,
        Se, d) (any other key raises ``ValueError``). With a prefix the
        predictions for the text start after its ``num_prefix_tokens``
        positions."""
        tokens, extras = unpack_batch(batch)
        if MA.active() is not None:
            # the log-softmax over the vocabulary split over the ranks
            h, _, aux = self.apply(params, tokens, mode="full", dtype=dtype,
                                   return_hidden=True, **extras)
            if extras.get("prefix_embeds") is not None:
                h = h[:, self.cfg.num_prefix_tokens:]
            hn = L.rms_norm(h, params["final_norm"].to(h.dtype),
                            self.cfg.norm_eps)
            return MA.next_token_nll(hn, self.head(params, hn), tokens,
                                     self.cfg.padded_vocab).mean() + aux
        logits, _, aux = self.apply(params, tokens, mode="full", dtype=dtype,
                                    **extras)
        if extras.get("prefix_embeds") is not None:
            logits = logits[:, self.cfg.num_prefix_tokens:]
        lp = torch.log_softmax(logits[:, :-1].to(torch.float32), -1)
        tgt = tokens[:, 1:].long()
        nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
        return nll.mean() + aux     # the MoE blocks' load-balance term


EXTRAS = ("prefix_embeds", "enc_frames")


def unpack_batch(batch) -> Tuple[Any, dict]:
    """(tokens, extras) of a batch as ``LM.loss`` takes it (the reference's
    ``LM._unpack``): a dict gives its "tokens" and whichever of ``EXTRAS``
    it holds, and refuses any other key; a tuple or list its first item; a
    tensor itself."""
    if isinstance(batch, dict):
        unknown = sorted(set(batch) - {"tokens", *EXTRAS})
        if unknown:
            raise ValueError(f"batch keys {unknown}: an LM batch holds "
                             f"'tokens' and {list(EXTRAS)}")
        return batch["tokens"], {k: batch[k] for k in EXTRAS if k in batch}
    if isinstance(batch, (tuple, list)):
        return batch[0], {}
    return batch, {}


# --------------------------------------------------------------------------
# the paper's split view over an LM
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class SplitLM:
    """The paper's lower/upper view of a decoder LM, with the fields of the
    reference's ``SplitModel`` (``make_split_lm``): ``init(gen, device)``,
    ``apply(params, tokens) -> logits``, ``apply_lower(params, tokens) ->
    hidden states at the split``, ``apply_upper(params, acts) -> logits``,
    ``split(params) -> (lower, upper)``, ``merge(lower, upper) -> params``,
    ``loss(params, batch)`` (next-token CE) and ``upper_loss(upper, acts,
    targets) -> (N,)`` per-sample CE of the upper part."""
    config: ModelConfig
    split_layer: int
    init: Callable
    apply: Callable
    apply_lower: Callable
    apply_upper: Callable
    split: Callable
    merge: Callable
    loss: Callable
    upper_loss: Callable


def split_stages(cfg: ModelConfig, j: int) -> Tuple[List[Stage], int]:
    """The stage list with a break at layer ``j`` and the index of the
    first upper stage (j rounded up to a stage boundary, as the
    reference)."""
    stages = decompose(layer_specs(cfg), boundary=j)
    acc = 0
    for si, st in enumerate(stages):
        if acc >= j:
            return stages, si
        acc += stage_layers(st)
    return stages, len(stages) - 1


def make_split_lm(cfg: ModelConfig, split_layer: Optional[int] = None,
                  dtype=torch.float32):
    """(SplitLM, lm) for a decoder LM: lower = embed + stages[:b], upper =
    stages[b:] + final norm + head (``embed_head``, the tied embedding, or
    ``lm_head``). The split layer is rounded to a stage-unit boundary (the
    paper also splits at a group boundary)."""
    j = split_layer if split_layer is not None else cfg.split_layer
    lm = LM(cfg)
    lm.stages, boundary_stage = split_stages(cfg, j)
    n_stages = len(lm.stages)

    def split(params):
        lower = {"embed": params["embed"],
                 "stages": params["stages"][:boundary_stage]}
        if "proj" in params:
            lower["proj"] = params["proj"]
        upper = {"stages": params["stages"][boundary_stage:],
                 "final_norm": params["final_norm"]}
        if "lm_head" in params:
            upper["lm_head"] = params["lm_head"]
        if cfg.tie_embeddings:
            upper["embed_head"] = params["embed"]
        return lower, upper

    def merge(lower, upper):
        p = {"embed": lower["embed"],
             "stages": list(lower["stages"]) + list(upper["stages"]),
             "final_norm": upper["final_norm"]}
        if "lm_head" in upper:
            p["lm_head"] = upper["lm_head"]
        if "proj" in lower:
            p["proj"] = lower["proj"]
        return p

    def apply_lower(params_full, tokens):
        h, _, _ = lm.apply(params_full, tokens, mode="full",
                           stage_range=(0, boundary_stage), dtype=dtype)
        return h

    def apply_upper_from(upper, acts):
        # a params view the LM understands
        p = {"stages": [None] * boundary_stage + list(upper["stages"]),
             "final_norm": upper["final_norm"],
             "embed": upper.get("embed_head")}
        if "lm_head" in upper:
            p["lm_head"] = upper["lm_head"]
        h, _, aux = lm.apply(p, None, mode="full", hidden_in=acts,
                             stage_range=(boundary_stage, n_stages),
                             dtype=dtype)
        return h, aux

    def apply_upper(params_full, acts):
        _, upper = split(params_full)
        logits, _ = apply_upper_from(upper, acts)
        return logits

    def full_apply(params, tokens):
        logits, _, _ = lm.apply(params, tokens, mode="full", dtype=dtype)
        return logits

    def loss(params, batch):
        return lm.loss(params, batch, dtype=dtype)

    def upper_loss(upper, acts, targets):
        logits, aux = apply_upper_from(upper, acts)
        lp = torch.log_softmax(logits[:, :-1].to(torch.float32), -1)
        nll = -torch.gather(lp, -1, targets[:, 1:].long()[..., None])[..., 0]
        return nll.mean(-1) + aux             # per-sample

    return SplitLM(config=cfg, split_layer=j, init=lm.init,
                   apply=full_apply, apply_lower=apply_lower,
                   apply_upper=apply_upper, split=split, merge=merge,
                   loss=loss, upper_loss=upper_loss), lm


# --------------------------------------------------------------------------
# the reference's parameter tree
# --------------------------------------------------------------------------
def params_from_jax(tree: PyTree, cfg: ModelConfig, device=None,
                    lm: Optional[LM] = None) -> PyTree:
    """``repro``'s LM parameters (``jax.tree.map(np.asarray, params)``) ->
    the port's tree of torch tensors, the same structure: scan stages as a
    list (per unit position) of dicts stacked over the repeats, unroll
    stages as a list of dicts. Shapes are checked against the port's own
    ``LM(cfg)``, or ``lm``'s stages where given (a tree split at the
    paper's layer, ``make_train_step``'s); any difference raises
    ``ValueError``."""
    want = (lm or LM(cfg)).init(None, device="meta")
    got = tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    if device is not None:
        got = tree_map(lambda t: t.to(device), got)
    _same_shapes(got, want)
    return got


def params_to_jax(params: PyTree, cfg: ModelConfig,
                  lm: Optional[LM] = None) -> PyTree:
    """The port's f32 parameters -> ``repro``'s tree of numpy arrays (the
    inverse of ``params_from_jax``, bit for bit; ``lm`` as there)."""
    _same_shapes(params, (lm or LM(cfg)).init(None, device="meta"))
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def _same_shapes(got: PyTree, want: PyTree, path: str = "") -> None:
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise ValueError(f"params{path}: expected the keys "
                             f"{sorted(want)}")
        for k in want:
            _same_shapes(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"params{path}: expected a list of {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _same_shapes(g, w, f"{path}/{i}")
    elif tuple(got.shape) != tuple(want.shape):
        raise ValueError(f"params{path}: shape {tuple(got.shape)} != "
                         f"{tuple(want.shape)}")
