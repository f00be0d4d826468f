"""Inference steps of the LM serving path: the port of
``repro.launch.steps``' ``make_prefill_step`` and ``make_decode_step``.

prefill_step — causal forward over the prompt, last-position logits only;
               the KV cache is not filled (as in the reference).
decode_step  — one token against the (ring-buffer) cache, greedy argmax;
               the cache is updated in place and returned.

Both compute in ``dtype`` (bf16 by default, as the reference) and run
without autograd. ``make_train_step`` waits for the training slice
(``ROADMAP.md`` Queue 1 item 13b).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import LM


def make_prefill_step(cfg: ModelConfig, force_swa: bool = False,
                      dtype=torch.bfloat16):
    """-> (prefill_step(params, batch) -> (B, 1, padded_vocab) logits, lm);
    ``batch`` is a dict with "tokens" (B, S)."""
    lm = LM(cfg, force_swa=force_swa)

    @torch.no_grad()
    def prefill_step(params, batch):
        h_all, _, _ = lm.apply(params, batch["tokens"], mode="full",
                               return_hidden=True, dtype=dtype)
        # last-position logits only (vocab projection on one position)
        # as the reference: the norm weight and the head come from the
        # tree as given (f32 master weights give f32 last-position logits)
        h = L.rms_norm(h_all[:, -1:], params["final_norm"], cfg.norm_eps)
        if cfg.tie_embeddings:
            return h @ params["embed"].T.to(h.dtype)
        return h @ params["lm_head"].to(h.dtype)

    return prefill_step, lm


def make_decode_step(cfg: ModelConfig, force_swa: bool = False,
                     dtype=torch.bfloat16):
    """-> (decode_step(params, cache, tokens (B, 1)) -> (next (B, 1) int32,
    cache), lm)."""
    lm = LM(cfg, force_swa=force_swa)

    @torch.no_grad()
    def decode_step(params, cache, tokens):
        logits, new_cache, _ = lm.apply(params, tokens, mode="decode",
                                        cache=cache, dtype=dtype)
        next_tok = torch.argmax(logits[:, -1], -1).to(torch.int32)[:, None]
        return next_tok, new_cache

    return decode_step, lm
